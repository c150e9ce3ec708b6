"""Keccak-f[1600] permutation AIR (counterpart of ``tpu_stark/air/keccak_air.py``;
BASELINE config 4: 2^20 rows x 3,608 bit columns).

One trace row per Keccak round; 24 consecutive rows prove one permutation.
Bits are field elements in {0, 1}; xor algebra: a xor b = a + b - 2ab.

Columns (24 + 1600 + 320 + 1600 + 64 = 3608):

  f[24]          round step flags (one-hot, rotating)
  a[25][64]      state bits at round input, lane (x + 5y), bit z
  c[5][64]       theta parity witness per column x
  ap[25][64]     A' = a xor d (post-theta state, pre-rho/pi)
  chi00[64]      chi output of lane (0, 0) (pre-iota witness)

Constraints (degree <= 4, the transitions gated by the flags): flags one-hot
and rotating, every bit boolean, theta parity, the A' definition, chi00's
definition, and the round transition (chi of the rho/pi relabeling of A',
iota on lane 0).  The first row of each permutation carries an
unconstrained fresh input.

The constraint sequence is cut into 48 ``Partition``s, each with its exact
column footprint, so the streamed wide prover (``prover/wide.py``) extends
only the columns a partition reads.  ``generate_trace`` runs the Keccak
rounds on the host, vectorized over permutations, and unpacks the bits on
``device``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..hash.keccak import ROT, ROUND_CONSTANTS
from .air import AirBuilder, BaseAir

NUM_ROUNDS = 24
LANES = 25
Z = 64

F_OFF = 0
A_OFF = NUM_ROUNDS
C_OFF = A_OFF + LANES * Z
AP_OFF = C_OFF + 5 * Z
CHI00_OFF = AP_OFF + LANES * Z
COLS = CHI00_OFF + Z

# rho/pi: B[dst] = rot(ap[src]); dst lane (x2 + 5*y2) with x2 = y, y2 = (2x+3y)%5
_PI_SRC = np.zeros(LANES, dtype=np.int64)
_PI_ROT = np.zeros(LANES, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _dst = _y + 5 * ((2 * _x + 3 * _y) % 5)
        _PI_SRC[_dst] = _x + 5 * _y
        _PI_ROT[_dst] = ROT[_x + 5 * _y]


def _a_col(lane: int, z: int) -> int:
    return A_OFF + lane * Z + z


def _c_col(x: int, z: int) -> int:
    return C_OFF + x * Z + z


def _ap_col(lane: int, z: int) -> int:
    return AP_OFF + lane * Z + z


_A_IDX = np.array([_a_col(l, z) for l in range(LANES) for z in range(Z)])
_AP_IDX = np.array([_ap_col(l, z) for l in range(LANES) for z in range(Z)])
_C_IDX = np.array([_c_col(x, z) for x in range(5) for z in range(Z)])
_CHI00_IDX = np.array([CHI00_OFF + z for z in range(Z)])


def _chi_operand_idx(k: int) -> np.ndarray:
    """ap column feeding chi operand B[x+k] at each dst (lane, z)."""
    out = []
    for dst in range(LANES):
        src_dst = (dst // 5) * 5 + (dst % 5 + k) % 5
        src = int(_PI_SRC[src_dst])
        rot = int(_PI_ROT[src_dst])
        out.extend(_ap_col(src, (z - rot) % Z) for z in range(Z))
    return np.array(out)


_CHI_B0 = _chi_operand_idx(0)
_CHI_B1 = _chi_operand_idx(1)
_CHI_B2 = _chi_operand_idx(2)


def _xor2(u, v):
    return u + v - 2 * u * v


class Partition:
    """One slice of the AIR's constraint sequence with its column footprint.

    ``KeccakAir.eval`` is the concatenation of the partitions' ``eval`` in
    order, so the prover (whole or one partition at a time) and the verifier
    replay the same constraint order.  ``local_cols`` / ``next_cols`` are the
    exact global columns the partition reads on the current and next row."""

    def __init__(self, name, local_cols, next_cols, eval_fn):
        self.name = name
        self.local_cols = np.asarray(local_cols, dtype=np.int64)
        self.next_cols = np.asarray(next_cols, dtype=np.int64)
        assert len(set(self.local_cols.tolist())) == len(self.local_cols)
        assert len(set(self.next_cols.tolist())) == len(self.next_cols)
        self.eval = eval_fn


def _p_flags(b: AirBuilder) -> None:
    local = b.main_row(0)
    nxt = b.main_row(1)
    f = local[F_OFF : F_OFF + NUM_ROUNDS]
    first = b.when_first_row()
    first.assert_eq(f[0], 1)
    for r in range(1, NUM_ROUNDS):
        first.assert_zero(f[r])
    for r in range(NUM_ROUNDS):
        b.assert_zero(f[r] * (f[r] - 1))
    tot = f[0]
    for r in range(1, NUM_ROUNDS):
        tot = tot + f[r]
    b.assert_eq(tot, 1)
    trans = b.when_transition()
    nf = nxt[F_OFF : F_OFF + NUM_ROUNDS]
    for r in range(NUM_ROUNDS):
        trans.assert_eq(nf[r], f[(r - 1) % NUM_ROUNDS])


def _p_bool(idx):
    def fn(b: AirBuilder) -> None:
        v = b.main_cols(0, idx)
        b.assert_zero(v * (v - 1))

    return fn


def _p_theta(x: int):
    a_rows = [np.array([_a_col(x + 5 * y, z) for z in range(Z)]) for y in range(5)]
    c_row = np.array([_c_col(x, z) for z in range(Z)])

    def fn(b: AirBuilder) -> None:
        s = b.main_cols(0, a_rows[0])
        for y in range(1, 5):
            s = s + b.main_cols(0, a_rows[y])
        diff = s - b.main_cols(0, c_row)
        b.assert_zero(diff * (diff - 2) * (diff - 4))

    return fn, np.concatenate(a_rows + [c_row])


def _p_apdef(x: int):
    lanes = [x + 5 * y for y in range(5)]
    a_idx = np.array([_a_col(l, z) for l in lanes for z in range(Z)])
    ap_idx = np.array([_ap_col(l, z) for l in lanes for z in range(Z)])
    d_left = np.array([_c_col((x - 1) % 5, z) for z in range(Z)])
    d_right = np.array([_c_col((x + 1) % 5, (z - 1) % Z) for z in range(Z)])
    tile = np.tile(np.arange(Z), 5)

    def fn(b: AirBuilder) -> None:
        d = _xor2(b.main_cols(0, d_left), b.main_cols(0, d_right))  # (64,)
        d_full = d.take(tile)  # (320,) lane-major over this x's 5 lanes
        b.assert_eq(b.main_cols(0, ap_idx), _xor2(b.main_cols(0, a_idx), d_full))

    return fn, np.concatenate([a_idx, ap_idx, d_left, d_right])


def _chi_at(b: AirBuilder, dst: int):
    """chi output vector (64,) for destination lane ``dst`` from A'."""
    sl = slice(dst * Z, (dst + 1) * Z)
    b0 = b.main_cols(0, _CHI_B0[sl])
    b1 = b.main_cols(0, _CHI_B1[sl])
    b2 = b.main_cols(0, _CHI_B2[sl])
    t = (1 - b1) * b2
    return b0 + t - 2 * b0 * t


def _p_chi00def(b: AirBuilder) -> None:
    b.assert_eq(b.main_cols(0, _CHI00_IDX), _chi_at(b, 0))


def _p_iota(b: AirBuilder) -> None:
    local = b.main_row(0)
    nxt = b.main_row(1)
    f = local[F_OFF : F_OFF + NUM_ROUNDS]
    gate = b.when_transition().when(1 - f[NUM_ROUNDS - 1])
    for z in range(Z):
        rc = None
        for r in range(NUM_ROUNDS):
            if (ROUND_CONSTANTS[r] >> z) & 1:
                rc = f[r] if rc is None else rc + f[r]
        out00 = local[CHI00_OFF + z]
        if rc is None:
            gate.assert_eq(nxt[_a_col(0, z)], out00)
        else:
            gate.assert_eq(nxt[_a_col(0, z)], _xor2(out00, rc))


def _p_trans(dst: int):
    next_idx = np.array([_a_col(dst, z) for z in range(Z)])

    def fn(b: AirBuilder) -> None:
        f_last = b.main_row(0)[F_OFF + NUM_ROUNDS - 1]
        gate = b.when_transition().when(1 - f_last)
        gate.assert_eq(b.main_cols(1, next_idx), _chi_at(b, dst))

    sl = slice(dst * Z, (dst + 1) * Z)
    local = np.concatenate([[F_OFF + NUM_ROUNDS - 1], _CHI_B0[sl], _CHI_B1[sl], _CHI_B2[sl]])
    return fn, local, next_idx


def _build_partitions() -> List[Partition]:
    f_idx = np.arange(F_OFF, F_OFF + NUM_ROUNDS)
    parts = [Partition("flags", f_idx, f_idx, _p_flags)]
    for g in range(5):  # booleanity of a, 5 consecutive lanes per partition
        idx = _A_IDX[g * 5 * Z : (g + 1) * 5 * Z]
        parts.append(Partition(f"bool_a{g}", idx, [], _p_bool(idx)))
    for g in range(5):
        idx = _AP_IDX[g * 5 * Z : (g + 1) * 5 * Z]
        parts.append(Partition(f"bool_ap{g}", idx, [], _p_bool(idx)))
    idx = np.concatenate([_C_IDX, _CHI00_IDX])
    parts.append(Partition("bool_c_chi", idx, [], _p_bool(idx)))
    for x in range(5):
        fn, cols = _p_theta(x)
        parts.append(Partition(f"theta{x}", cols, [], fn))
    for x in range(5):
        fn, cols = _p_apdef(x)
        parts.append(Partition(f"apdef{x}", cols, [], fn))
    chi_cols = np.concatenate([_CHI_B0[:Z], _CHI_B1[:Z], _CHI_B2[:Z], _CHI00_IDX])
    parts.append(Partition("chi00def", chi_cols, [], _p_chi00def))
    parts.append(
        Partition(
            "iota",
            np.concatenate([f_idx, _CHI00_IDX]),
            np.array([_a_col(0, z) for z in range(Z)]),
            _p_iota,
        )
    )
    for dst in range(1, LANES):
        fn, local, nxt = _p_trans(dst)
        parts.append(Partition(f"trans{dst}", local, nxt, fn))
    return parts


_PARTITIONS: List[Partition] = _build_partitions()


class KeccakAir(BaseAir):
    width = COLS

    def partitions(self) -> List[Partition]:
        return _PARTITIONS

    def eval(self, b: AirBuilder) -> None:
        for part in _PARTITIONS:
            part.eval(b)


# ---------------------------------------------------------------------------
# Trace generation
# ---------------------------------------------------------------------------
# Per row, the u64 words whose bits fill columns A_OFF.. in order: the 25
# state lanes, the 5 theta parities, the 25 post-theta lanes, chi00.
_WORDS = LANES + 5 + LANES + 1
_UNPACK_ROWS = 1 << 15  # rows per on-device bit unpack (bounds the int64 temporary)


def _round_words(n_perms: int, seed: int) -> np.ndarray:
    """(n_perms * 24, _WORDS) u64 words of every round row, permutation
    major: one vectorized numpy Keccak round for all permutations at once."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 1 << 64, size=(n_perms, LANES), dtype=np.uint64)
    words = np.empty((n_perms, NUM_ROUNDS, _WORDS), dtype=np.uint64)
    rot = _PI_ROT.astype(np.uint64)
    for r in range(NUM_ROUNDS):
        c = states[:, 0:5] ^ states[:, 5:10] ^ states[:, 10:15] ^ states[:, 15:20] ^ states[:, 20:25]
        c1 = c[:, [(x + 1) % 5 for x in range(5)]]
        d = c[:, [(x - 1) % 5 for x in range(5)]] ^ ((c1 << np.uint64(1)) | (c1 >> np.uint64(63)))
        ap = states ^ d[:, [l % 5 for l in range(LANES)]]
        src = ap[:, _PI_SRC]
        bmat = (src << rot) | (src >> ((Z - rot) % Z))
        words[:, r, :LANES] = states
        words[:, r, LANES : LANES + 5] = c
        words[:, r, LANES + 5 : 2 * LANES + 5] = ap
        words[:, r, -1] = bmat[:, 0] ^ (~bmat[:, 1] & bmat[:, 2])
        # advance every window one round (chi + iota on all lanes)
        out = np.empty_like(bmat)
        for i in range(LANES):
            out[:, i] = bmat[:, i] ^ (
                ~bmat[:, (i // 5) * 5 + (i + 1) % 5] & bmat[:, (i // 5) * 5 + (i + 2) % 5]
            )
        out[:, 0] ^= np.uint64(ROUND_CONSTANTS[r])
        states = out
    return words.reshape(n_perms * NUM_ROUNDS, _WORDS)


def generate_trace(num_perms: int, seed: int = 0, dtype=torch.uint8, device="cuda") -> torch.Tensor:
    """(next_pow2(num_perms * 24), COLS) trace of random permutations on
    ``device`` (the card unless the caller passes another device), values in
    {0, 1} of ``dtype``: the same values as the JAX package's
    ``generate_trace(num_perms, seed)``.  24 does not divide 2^k, so the final
    permutation window is cut short, which the AIR permits.

    The rounds run on the host as u64 words, vectorized over permutations;
    the words go to the device and are unpacked into bit columns there, in
    row blocks."""
    device = torch.device(device)
    n_rows = 1 << (int(np.ceil(np.log2(max(num_perms * NUM_ROUNDS, 2)))))
    n_perms = (n_rows + NUM_ROUNDS - 1) // NUM_ROUNDS
    words = _round_words(n_perms, seed)[:n_rows]
    trace = torch.empty((n_rows, COLS), dtype=dtype, device=device)
    rows = torch.arange(n_rows, device=device)
    trace[:, F_OFF : F_OFF + NUM_ROUNDS] = (
        (rows % NUM_ROUNDS)[:, None] == torch.arange(NUM_ROUNDS, device=device)[None, :]
    ).to(dtype)
    zbits = torch.arange(Z, dtype=torch.int64, device=device)
    for r0 in range(0, n_rows, _UNPACK_ROWS):
        w = torch.from_numpy(words[r0 : r0 + _UNPACK_ROWS].view(np.int64)).to(device)
        bits = (w[:, :, None] >> zbits) & 1  # arithmetic shift: bit 63 still lands in & 1
        trace[r0 : r0 + _UNPACK_ROWS, A_OFF:] = bits.reshape(w.shape[0], -1).to(dtype)
    return trace
