"""A plain uni-STARK zk prover, written from the protocol (Plonky3's
uni-stark over a two-adic FRI PCS, as the configuration states it) in
straight-line torch, blocked only for memory.  It returns the proof's bytes.

The protocol, with n trace rows, blowup 2^b, the trace domain H = <g_n>:

1. zk trace: T'(x) = T(x) + (x^n - 1) R(x), R of degree < n drawn from the
   "trace" stream; T' is committed as a polynomial of 2n coefficients.
2. A commitment of polynomials p of h coefficients is a hiding Merkle tree
   over the rows of r(y) = p(31 y) at y = g_H^bitrev(i), H = 2^b h (the
   "plain frame"): each leaf hashes a row's canonical values, then 4 salts
   from the "salts" stream (one sample of (H, 4) a matrix); matrices of one
   height share the tree's leaves, side by side.
3. Transcript: observe log n, the trace root, the public values; alpha;
   the quotient Q = sum_k alpha^k C_k / Z_H over the coset 31 <g_(n d)>
   (d chunks), split into chunks i on 31 g^i <g_n>, committed; observe the
   root; zeta.
4. Open: a random codeword round (4 columns of 2n coefficients from the
   "codewords" stream, committed), the openings at zeta (and zeta g_n for
   the trace) observed, alpha; per height the reduced opening
   sum alpha^k (r(y) - r(z / 31)) / (y - z / 31) (the random round's
   r(y) alpha^k), FRI folding by 2 with one commitment a level, the final
   constant, 16-bit proof of work, and the queries' Merkle openings.

The AIR's constraints come from its own ``eval`` through ``QuotientBuilder``.
"""

from __future__ import annotations

import io
import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import field as F
from . import keccak, threefry
from .field import GEN, P, Ext

SALTS = 4  # salt elements a leaf
RANDOM_COLUMNS = 4  # random FRI codewords


# -- the transcript ----------------------------------------------------------------
class Transcript:
    """Keccak-256 hash challenger over bytes, read as BabyBear: observations
    append to the input and clear the output; a sample refills an empty
    output with the input's hash (which becomes the input too) and takes
    bytes from its end; a u32 sample is 4 bytes, little endian, masked to
    31 bits, drawn again while not below p."""

    def __init__(self):
        self.input = bytearray()
        self.output = bytearray()

    def observe(self, data: bytes) -> None:
        self.output.clear()
        self.input.extend(data)

    def u32s(self, values) -> None:
        for v in values:
            self.observe(int(v).to_bytes(4, "little"))

    def digest(self, d: Sequence[int]) -> None:
        for w in d:
            self.observe((int(w) & keccak.M64).to_bytes(8, "little"))

    def _byte(self) -> int:
        if not self.output:
            h = keccak.keccak256(bytes(self.input))
            self.input, self.output = bytearray(h), bytearray(h)
        return self.output.pop()

    def sample(self) -> int:
        while True:
            v = int.from_bytes(bytes(self._byte() for _ in range(4)), "little") & 0x7FFFFFFF
            if v < P:
                return v

    def ext(self) -> Ext:
        return tuple(self.sample() for _ in range(4))

    def bits(self, n: int) -> int:
        return self.sample() & ((1 << n) - 1)

    def grind(self, bits: int, device) -> int:
        """The least witness w whose observation makes the next ``bits``-bit
        sample 0; it stays observed, its sample taken."""
        w = _least_witness(bytes(self.input), bits, device)
        self.u32s([w])
        if self.bits(bits) != 0:
            raise RuntimeError("the proof of work's witness fails its check")
        return w


def _least_witness(prefix: bytes, bits: int, device, batch: int = 1 << 18) -> int:
    """Keccak-256 of prefix || w (4 bytes, little endian) for w = 0, 1, ...
    in batches on ``device``; a witness passes when the first u32 sample of
    its digest below p has its low ``bits`` bits 0.  The host transcript
    confirms the least that passes."""
    data_len = len(prefix) + 4
    padded = (data_len // 136 + 1) * 136
    full = (len(prefix) // 136) * 136  # whole blocks before the witness's
    state = [0] * 25
    for off in range(0, full, 136):
        for i in range(17):
            state[i] ^= int.from_bytes(prefix[off + 8 * i : off + 8 * i + 8], "little")
        state = keccak.permute(state)
    tail = bytearray(prefix[full:]) + b"\x00" * 4 + b"\x00" * (padded - data_len)
    tail[data_len - full] ^= 0x01
    tail[-1] ^= 0x80
    wpos = len(prefix) - full
    start = 0
    while start < P:
        w = torch.arange(start, min(P, start + batch), dtype=torch.int64, device=device)
        blocks = torch.tensor(list(tail), dtype=torch.int64, device=device).repeat(int(w.numel()), 1)
        for j in range(4):
            blocks[:, wpos + j] = (w >> (8 * j)) & 0xFF
        st = torch.tensor([keccak._signed(v) for v in state], dtype=torch.int64, device=device)[:, None]
        st = st.repeat(1, int(w.numel()))
        for off in range(0, len(tail), 136):
            lanes = torch.zeros((17, int(w.numel())), dtype=torch.int64, device=device)
            for b in range(8):
                lanes |= blocks[:, off + b : off + 136 : 8].T << (8 * b)
            st[:17] ^= lanes
            st = keccak.permute_t(st)
        # the digest's bytes from the end, 4 at a time: lanes 3, 2, 1, 0
        ok = torch.zeros_like(w, dtype=torch.bool)
        undecided = torch.ones_like(ok)
        for word in range(8):
            lane = st[3 - word // 2]
            half = (lane >> 32) if word % 2 == 0 else lane
            v = ((half >> 24) & 0xFF) | (((half >> 16) & 0xFF) << 8) | (((half >> 8) & 0xFF) << 16) | ((half & 0x7F) << 24)
            below = v < P
            ok |= undecided & below & ((v & ((1 << bits) - 1)) == 0)
            undecided &= ~below
        hit = torch.nonzero(ok | undecided)
        for h in hit[:, 0].tolist():
            cand = start + h
            t = Transcript()
            t.input = bytearray(prefix)
            t.u32s([cand])
            if t.bits(bits) == 0:
                return cand
        start += batch
    raise RuntimeError("no proof-of-work witness")


# -- Merkle trees ----------------------------------------------------------------
class Tree:
    """A Merkle tree over the rows of same-height matrices (canonical int64,
    rows in committed order), each followed by its salts when ``salts``."""

    def __init__(self, mats: List[torch.Tensor], salts: List[Tuple[threefry.Key, int]] = None):
        self.mats = mats
        self.salt_keys = salts  # per matrix: (key, cols) of its salt sample
        h = int(mats[0].shape[0])
        digests = torch.empty((h, 4), dtype=torch.int64, device=mats[0].device)
        step = keccak.ROW_BLOCK
        for r0 in range(0, h, step):
            rows = torch.arange(r0, min(h, r0 + step), dtype=torch.int64, device=mats[0].device)
            digests[r0 : r0 + step] = keccak.hash_rows(self._leaf_rows(rows))
        self.layers = [digests]
        while int(self.layers[-1].shape[0]) > 1:
            d = self.layers[-1]
            self.layers.append(keccak.compress(d[0::2], d[1::2]))
        self.root = [int(v) & keccak.M64 for v in self.layers[-1][0].tolist()]

    def _leaf_rows(self, rows: torch.Tensor) -> torch.Tensor:
        parts = []
        for k, m in enumerate(self.mats):
            parts.append(m[rows])
            if self.salt_keys is not None:
                key, cols = self.salt_keys[k]
                parts.append(threefry.rows_of(key, cols, rows))
        return torch.cat(parts, dim=1)

    def open(self, indices: Sequence[int]) -> list:
        """Per index: (the row of each matrix, their salt rows or None, the
        sibling digests leaf first), gathered for all indices at once."""
        dev = self.mats[0].device
        idx = torch.tensor(list(indices), dtype=torch.int64, device=dev)
        vals = [m[idx].tolist() for m in self.mats]
        salts = None
        if self.salt_keys is not None:
            salts = [threefry.rows_of(key, cols, idx).tolist() for key, cols in self.salt_keys]
        sibs = [layer[(idx >> l) ^ 1].tolist() for l, layer in enumerate(self.layers[:-1])]
        return [([v[q] for v in vals], None if salts is None else [t[q] for t in salts],
                 [[w & keccak.M64 for w in layer[q]] for layer in sibs]) for q in range(len(indices))]


# -- the constraints ----------------------------------------------------------------
class QuotientBuilder:
    """Evaluates an AIR's constraints over the points of the quotient
    domain, every value a base-field tensor: ``main_row(0)`` the current
    rows, ``main_row(1)`` the next, the selectors of the trace domain, and
    the alpha-folded sum sum_k alpha^k C_k in ``acc`` (k in eval order)."""

    def __init__(self, local, nxt, sels, public_values, alpha: Ext):
        self._rows = (local, nxt)
        self.is_first_row, self.is_last_row, self.is_transition = sels
        self._pis = public_values
        self._alpha = alpha
        self._apow = (1, 0, 0, 0)
        self.acc = None

    def main_row(self, offset: int):
        return self._rows[offset]

    def public_value(self, i: int):
        return self._pis[i]

    def when_first_row(self):
        return _When(self, self.is_first_row)

    def when_last_row(self):
        return _When(self, self.is_last_row)

    def when_transition(self):
        return _When(self, self.is_transition)

    def assert_zero(self, x: torch.Tensor) -> None:
        term = torch.stack([x % P * c % P for c in self._apow], dim=-1)
        self.acc = term if self.acc is None else (self.acc + term) % P
        self._apow = F.e_mul(self._apow, self._alpha)

    def assert_eq(self, a, b) -> None:
        self.assert_zero(a - b)


class _When:
    def __init__(self, b: QuotientBuilder, sel: torch.Tensor):
        self._b, self._sel = b, sel

    def assert_zero(self, x) -> None:
        self._b.assert_zero(self._sel * (x % P) % P)

    def assert_eq(self, a, b) -> None:
        self.assert_zero(a - b)


class _Deg:
    """A value's degree as a multiple of n, for ``DegreeBuilder``."""

    def __init__(self, d: int):
        self.d = d

    def _lift(self, o):
        return o if isinstance(o, _Deg) else _Deg(0)

    def __add__(self, o):
        return _Deg(max(self.d, self._lift(o).d))

    __radd__ = __sub__ = __rsub__ = __add__

    def __mod__(self, p):
        return self

    def __mul__(self, o):
        return _Deg(self.d + self._lift(o).d)

    __rmul__ = __mul__


class DegreeBuilder(QuotientBuilder):
    """The same ``eval`` over degrees: a zk trace column has degree 2n, the
    first- and last-row selectors n, the transition selector 0 (x - g^-1,
    of degree 1); ``max_degree`` is the largest constraint's multiple of n."""

    def __init__(self, width: int, num_public_values: int):
        col = [_Deg(2) for _ in range(width)]
        super().__init__(col, col, (_Deg(1), _Deg(1), _Deg(0)), [_Deg(0)] * num_public_values, (1, 0, 0, 0))
        self.max_degree = 0

    def assert_zero(self, x) -> None:
        self.max_degree = max(self.max_degree, x.d)


def log_quotient_chunks(air, num_public_values: int) -> int:
    """log2 of the quotient's chunks: the constraint degree d (at least 2)
    less one, rounded up to a power of two."""
    b = DegreeBuilder(air.width, num_public_values)
    air.eval(b)
    return (max(b.max_degree, 2) - 2).bit_length()


# -- the prover -----------------------------------------------------------------
def _lde(coeffs: torch.Tensor, log_blowup: int) -> torch.Tensor:
    """The plain-frame codeword of polynomials given by coefficients (h, w)
    (of p; r(y) = p(31 y)), in committed (bit-reversed) row order."""
    h, w = (int(s) for s in coeffs.shape)
    big = h << log_blowup
    r = torch.zeros((big, w), dtype=torch.int64, device=coeffs.device)
    r[:h] = _plain_coeffs(coeffs)
    return F.dft(r)[F.bitrev(big.bit_length() - 1, coeffs.device)]


def _plain_coeffs(coeffs: torch.Tensor) -> torch.Tensor:
    """The coefficients of r(y) = p(31 y) from p's."""
    return coeffs * F.powers(GEN, int(coeffs.shape[0]), coeffs.device)[:, None] % P


def _point_over_gen(z: Ext) -> Ext:
    return F.e_scale(z, F.inv(GEN))


def prove(fri: dict, air, trace: np.ndarray, public_values: Sequence[int], rng_seed: int, device) -> bytes:
    device = torch.device(device)
    blowup = int(fri["log_blowup"])
    n, width = trace.shape
    log_n = n.bit_length() - 1
    pis = [int(v) % P for v in public_values]
    log_d = log_quotient_chunks(air, len(pis))
    d = 1 << log_d

    # 1. the zk trace: coefficients of T' (2n of them)
    t = torch.from_numpy(np.ascontiguousarray(trace, dtype=np.uint32).astype(np.int64)).to(device) % P
    c = F.dft(t, inverse=True)
    rnd = threefry.matrix(threefry.sample_key(rng_seed, "trace", 0), n, width, device)
    trace_coeffs = torch.cat([(c - rnd) % P, rnd], dim=0)
    del t, c, rnd
    salt_calls = iter(range(1 << 30))

    def salts() -> Tuple[threefry.Key, int]:
        """The next matrix's salt sample: the stream's next call, 4 columns."""
        return threefry.sample_key(rng_seed, "salts", next(salt_calls)), SALTS

    trace_cw = _lde(trace_coeffs, blowup)  # (2n 2^b, w)
    trace_tree = Tree([trace_cw], [salts()])

    tr = Transcript()
    tr.u32s([log_n])
    tr.digest(trace_tree.root)
    tr.u32s(pis)
    alpha = tr.ext()

    # 2. the quotient over 31 <g_(n d)>: the trace's LDE there (rows of its
    # natural-order codeword on 31 <g_(2n 2^b)>), the next row g_n on
    qn = n * d
    log_big = (2 * n << blowup).bit_length() - 1
    natural = torch.empty_like(trace_cw)
    natural[F.bitrev(log_big, device)] = trace_cw
    on_q = natural[:: (2 * n << blowup) // qn]
    del natural
    nxt = on_q.roll(-(qn // n), dims=0)
    xs = F.powers(F.two_adic_gen(log_n + log_d), qn, device) * GEN % P
    zh = (F.t_pow(xs, n) - 1) % P
    last = F.inv(F.two_adic_gen(log_n))
    sels = (zh * F.t_inv((xs - 1) % P) % P, zh * F.t_inv((xs - last) % P) % P, (xs - last) % P)
    b = QuotientBuilder([on_q[:, j] for j in range(width)], [nxt[:, j] for j in range(width)], sels,
                        [torch.tensor(v, dtype=torch.int64, device=device) for v in pis], alpha)
    air.eval(b)
    quotient = F.t_escale(b.acc, F.t_inv(zh))  # (qn, 4)
    del b, on_q, nxt, xs, zh, sels

    chunk_coeffs = []  # p_i with p_i(s_i x) interpolating chunk i on <g_n>, then scaled to p_i's own coefficients
    for i in range(d):
        s_i = GEN * pow(F.two_adic_gen(log_n + log_d), i, P) % P
        ci = F.dft(quotient[i::d].contiguous(), inverse=True)
        chunk_coeffs.append(ci * F.powers(F.inv(s_i), n, device)[:, None] % P)
    del quotient
    chunk_cws = [_lde(ci, blowup) for ci in chunk_coeffs]
    quotient_tree = Tree(chunk_cws, [salts() for _ in chunk_cws])
    tr.digest(quotient_tree.root)
    zeta = tr.ext()
    zeta_next = F.e_scale(zeta, F.two_adic_gen(log_n))

    # 3. the random round: 4 columns of 2n coefficients
    rand_coeffs = threefry.matrix(threefry.sample_key(rng_seed, "codewords", 0), 2 * n, RANDOM_COLUMNS, device)
    rand_cw = _lde(rand_coeffs, blowup)
    rand_tree = Tree([rand_cw], [salts()])
    tr.digest(rand_tree.root)

    # 4. the openings: each committed r at z / 31
    trace_plain = _plain_coeffs(trace_coeffs)
    opened_trace = [F.t_eval(trace_plain, _point_over_gen(z)) for z in (zeta, zeta_next)]
    opened_chunks = [F.t_eval(_plain_coeffs(ci), _point_over_gen(zeta)) for ci in chunk_coeffs]
    del trace_plain, trace_coeffs, chunk_coeffs, rand_coeffs
    for vals in opened_trace + opened_chunks:
        for v in vals:
            tr.u32s(v)
    fri_alpha = tr.ext()

    # 5. reduced openings per height: (matrix, its points and opened values) in
    # commit order, alpha^k running on per height
    jobs = [(trace_cw, list(zip((zeta, zeta_next), opened_trace)))]
    jobs += [(cw, [(zeta, vals)]) for cw, vals in zip(chunk_cws, opened_chunks)]
    jobs += [(rand_cw, [])]
    reduced = {}
    ctr = {}
    for cw, points in jobs:
        h, w = (int(s) for s in cw.shape)
        log_h = h.bit_length() - 1
        acc = reduced.get(log_h, torch.zeros((h, 4), dtype=torch.int64, device=device))
        ys = F.powers(F.two_adic_gen(log_h), h, device)[F.bitrev(log_h, device)]
        for z, vals in points or [(None, None)]:  # the random round has no points
            k0 = ctr.get(log_h, 0)
            ctr[log_h] = k0 + w
            apows = [F.e_pow(fri_alpha, k0 + j) for j in range(w)]
            dot = torch.zeros((h, 4), dtype=torch.int64, device=device)
            for j, a in enumerate(apows):  # sum_j alpha^(k0 + j) r_j(y)
                dot = (dot + cw[:, j, None] * torch.tensor(a, device=device)) % P
            if z is None:
                acc = (acc + dot) % P
                continue
            s = (0, 0, 0, 0)
            for a, v in zip(apows, vals):  # the same sum at the point
                s = F.e_add(s, F.e_mul(a, v))
            zy = _point_over_gen(z)
            den = torch.stack([(ys - zy[0]) % P] + [torch.full_like(ys, (P - c) % P) for c in zy[1:]], -1)
            acc = (acc + F.t_emul((dot - torch.tensor(s, device=device)) % P, F.t_einv(den))) % P
            del dot, den
        reduced[log_h] = acc

    # 6. FRI: commit a level as pairs of rows, fold by 2, add the next height's reduced opening
    log_max = max(reduced)
    log_min = blowup + int(fri["log_final_poly_len"])
    cur = reduced[log_max]
    level_trees = []
    log_h = log_max
    inv2 = F.inv(2)
    while log_h > log_min:
        tree = Tree([cur.reshape(-1, 8)])
        level_trees.append(tree)
        tr.digest(tree.root)
        beta = tr.ext()
        h = 1 << log_h
        y_inv = F.powers(F.inv(F.two_adic_gen(log_h)), h, device)[F.bitrev(log_h, device)[0::2]]
        e, o = cur[0::2], cur[1::2]
        half_diff = F.t_escale((e - o) % P, y_inv * inv2 % P)
        cur = ((e + o) * inv2 % P + F.t_emul(half_diff, beta)) % P
        log_h -= 1
        if log_h in reduced:
            cur = (cur + reduced[log_h]) % P
    final = F.dft(cur[F.bitrev(log_h, device)], inverse=True)
    n_final = 1 << int(fri["log_final_poly_len"])
    if bool((final[n_final:] != 0).any()):
        raise RuntimeError("the FRI final polynomial's degree is too high")
    final_poly = [tuple(int(v) for v in row) for row in final[:n_final].tolist()]
    for cf in final_poly:
        tr.u32s(cf)
    pow_witness = tr.grind(int(fri["proof_of_work_bits"]), device)
    indices = [tr.bits(log_max) for _ in range(int(fri["num_queries"]))]

    # 7. the bytes
    out = _Writer()
    out.u32(log_n)
    out.u32(log_d)
    out.digest(trace_tree.root)
    out.digest(quotient_tree.root)
    out.u32(width)
    for vals in opened_trace:
        for v in vals:
            out.u32s(v)
    out.u32(d)
    for vals in opened_chunks:
        out.u32(len(vals))
        for v in vals:
            out.u32s(v)
    out.u32(1)
    out.digest(rand_tree.root)
    out.u32(len(level_trees))
    for t in level_trees:
        out.digest(t.root)
    out.u32(len(final_poly))
    for cf in final_poly:
        out.u32s(cf)
    out.u32(pow_witness)
    rounds = [trace_tree, quotient_tree, rand_tree]
    round_openings = [t.open([i >> (log_max - (len(t.layers) - 1)) for i in indices]) for t in rounds]
    level_openings = [t.open([i >> (k + 1) for i in indices]) for k, t in enumerate(level_trees)]
    out.u32(len(indices))
    for q in range(len(indices)):
        out.u32(len(rounds))
        for op in round_openings:
            out.opening(*op[q])
        out.u32(len(level_trees))
        for op in level_openings:
            out.opening(*op[q])
    return out.bytes()


class _Writer:
    """The proof's format: u32 field values and lengths, u64 digest words,
    little endian; a digest is its length then its words."""

    def __init__(self):
        self.b = io.BytesIO()

    def u32(self, v: int) -> None:
        self.b.write(struct.pack("<I", int(v)))

    def u32s(self, vs) -> None:
        for v in vs:
            self.u32(v)

    def digest(self, d) -> None:
        self.u32(len(d))
        for w in d:
            self.b.write(struct.pack("<Q", int(w)))

    def rows(self, rows) -> None:
        self.u32(len(rows))
        for row in rows:
            self.u32(len(row))
            self.u32s(row)

    def opening(self, vals, salts, path) -> None:
        """A query's opening of one tree: each matrix's row, a flag and each
        salt row when the tree hides, the sibling digests."""
        self.rows(vals)
        self.u32(0 if salts is None else 1)
        if salts is not None:
            self.rows(salts)
        self.u32(len(path))
        for dg in path:
            self.digest(dg)

    def bytes(self) -> bytes:
        return self.b.getvalue()
