"""Streamed prover for very wide traces (counterpart of
``tpu_stark/prover/wide.py``): keccak-air at 2^20 rows x 3,608 bit columns,
BASELINE config 4 (Poseidon2 stack, zk off) and the reference's own stack
(Keccak trees, zk on, the device rng).

The dense prover cannot hold this trace: its committed LDE alone is
2^21 x 3608 x 4 B = 30.3 GB (twice that in zk), and its int64 field
products several times that.  Here:

* the trace stays on the device as its compact integer type (uint8 bits:
  3.78 GB at 2^20 x 3608);
* the committed LDE is never materialized: column chunks go through
  iNTT -> plain-frame scale -> zero-pad -> NTT (kernel K2) and into a
  carried-state sponge absorb that holds one state per LDE row across
  chunks: Poseidon2 (kernel K4, ``P2RowStream``, on a bit-reversed copy)
  or Keccak (K1's absorb, ``hash.sponge.KeccakRowStream``, which reads the
  natural-order Monty chunk through the bit reversal and converts each
  word to its canonical u32 as it reads it); a hiding commit absorbs the
  salts after the rows and keeps their lazy draw.  The Merkle tree is then
  built on the leaf digests, with the same root as the dense commit;
* zk: the committed polynomial is T'(x) = T(x) + Z_H(x) R(x) of degree
  < 2n, its coefficients [q - r ; r] (the dense prover's), with R drawn per
  column chunk from the device rng (``fold_in(key("trace"), chunk)``), so
  every pass over any columns regenerates the same values and the (n, w)
  randomizer is never held.  With one chunk it is the dense prover's draw;
* the quotient runs one AIR partition at a time (``keccak_air.Partition``),
  over only that partition's columns, and one row block at a time: block k
  of quotient coset j holds the points shift_j * g^(k + r*t); one fold
  (kernel K8) reads the partition's coefficients once for all r blocks of
  a coset;
* the open phase recomputes chunk LDEs when it needs them: the out-of-domain
  evaluations, the reduced openings and the query rows
  (``commit/pcs.py`` dispatches on ``eval_at_points`` / ``reduced_contrib``).

On a mesh (``create_config(mesh=make_row_mesh())``) every rank holds the
compact trace whole and runs the same steps: its block of each chunk's LDE
(``ShardedWideSource``: the whole iNTT on K2, its randomizer rows, the
exchange-stage NTT of ``dist/ntt.py``), its leaves and subtree under
``ShardedMmcs``, a share of the quotient's partitions summed over the
ranks, and the open phase on its rows.  GSPMD does this for the JAX
package's same code; here each consumer of the source is rank-aware.

Proofs are byte-identical to the JAX package's, and to the dense prover's
wherever both fit (zk: with one column chunk), on a mesh too.  Not ported:
the JAX package's per-partition-class program cache and 64-column panel
padding, which exist only to bound XLA compiles.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..air import quotient_kernel
from ..air.air import BaseAir
from ..commit import open_kernel
from ..commit.pcs import PcsProverData
from ..commit.poseidon2_mmcs import Poseidon2Mmcs
from ..compat.device_rng import DeviceRng, _sample_monty, fold_in
from ..dist import ntt as dntt
from ..dist.comm import block
from ..dist.merkle import draw_rows
from ..dist.pcs import _min_sharded_log_h
from ..fields import babybear as bb
from ..fields import extension as ext4
from ..fields import ref_field as rf
from ..fri.domains import TwoAdicCoset
from ..hash import poseidon2_kernel
from ..hash.poseidon2_kernel import OUT, RATE, WIDTH
from ..hash.sponge import KeccakRowStream
from ..matrix import log2_strict, reverse_matrix_index_bits
from .proof import Proof
from .prove import constraint_inputs, get_log_quotient_degree, open_and_assemble, phase_timer

PANEL_BUDGET = 1 << 30  # bytes of int32 panel columns live in one quotient block
MIN_BLOCK_LOG = 13  # quotient row blocks are never cut below 2^13 rows
_MAX_BLOCKS = 32


def default_col_chunk(lde_h: int) -> int:
    """Columns per chunk: one chunk's (lde_h, chunk) LDE holds at most 2^28
    elements (1 GiB as int32, 2 GiB as the int64 products around it); 128
    columns at 2^21 LDE rows."""
    return max(RATE, min(512, ((1 << 28) // lde_h) // RATE * RATE))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class WideMatrixSource:
    """A committed matrix too large to materialize: bit-reversed LDE column
    chunks are recomputed on demand from the device-resident trace.

    It stands in for a committed matrix in the PCS: ``shape`` is the LDE
    shape, ``src[rows]`` gathers full LDE rows (the query openings),
    ``eval_at_points`` and ``reduced_contrib`` stream the open phase's
    column reductions.  ``col_chunk`` (a multiple of 8) does not change the
    proof, except in zk, where each chunk draws its own randomizer.

    zk (``zk_seed`` given): the committed polynomial is the randomized
    T' = T + Z_H R of ``n_committed`` = 2n coefficients, on the natural
    domain of size 2n; chunk c's randomizer columns are
    ``_sample_monty(fold_in(key, c), n, wc)`` under the folded key of
    ``DeviceRng(zk_seed, "trace")``."""

    def __init__(
        self,
        trace: torch.Tensor,  # (n, w) canonical values in a compact integer type (uint8 bits)
        dft,
        log_blowup: int,
        domain: TwoAdicCoset,
        col_chunk: Optional[int] = None,
        zk_seed: Optional[int] = None,
    ):
        self.n, self.w = int(trace.shape[0]), int(trace.shape[1])
        if self.n != domain.size:
            raise ValueError(f"trace height {self.n} is not the domain size {domain.size}")
        self.log_n = domain.log_n
        self.log_blowup = log_blowup
        self.zk = zk_seed is not None
        self.n_committed = 2 * self.n if self.zk else self.n
        self.lde_h = self.n_committed << log_blowup
        self.dft = dft
        self.device = dft.device
        self.domain = domain
        self.col_chunk = col_chunk or default_col_chunk(self.lde_h)
        if self.col_chunk % RATE:
            raise ValueError(f"col_chunk {self.col_chunk} is not a multiple of {RATE}")
        self.trace = trace.to(self.device)
        if self.zk:
            if domain.shift != 1:
                raise ValueError("the zk wide source commits on the natural domain (shift 1)")
            self._zk_key = DeviceRng(zk_seed, "trace", self.device)._key
        # relabeling scale onto the plain frame (as pcs.commit): canonical powers
        sigma = (bb.GENERATOR * rf.finv(domain.shift)) % bb.P
        self._sigma_pows = bb.powers(sigma, self.n_committed, self.device)
        # the LDE rows this process holds: all of them, unless a mesh holds
        # the source in rank blocks (ShardedWideSource)
        self.mesh, self.row0, self.block_h = None, 0, self.lde_h

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.lde_h, self.w)

    def chunks(self):
        for off in range(0, self.w, self.col_chunk):
            yield off, min(self.col_chunk, self.w - off)

    # -- per-chunk pipeline --------------------------------------------------
    def monty_cols(self, cols) -> torch.Tensor:
        """(n, k) Monty values of the given global columns."""
        return bb.from_u32(self.trace[:, torch.as_tensor(np.asarray(cols), device=self.device)])

    def _rand_chunk(self, chunk_idx: int, wc: int, sel=None) -> torch.Tensor:
        """(n, wc) Monty randomizer columns of chunk ``chunk_idx`` (only its
        local columns ``sel`` when given: the same values)."""
        return _sample_monty(fold_in(self._zk_key, chunk_idx), self.n, wc, self.device, sel)

    def _rand_cols(self, cols) -> torch.Tensor:
        """(n, k) randomizer values of arbitrary global columns, repeats
        allowed: each distinct column drawn once, from its chunk's stream."""
        uniq, inverse = np.unique(np.asarray(cols, dtype=np.int64), return_inverse=True)
        out = torch.empty((self.n, len(uniq)), dtype=bb.I32, device=self.device)
        chunk_of = uniq // self.col_chunk
        for c in np.unique(chunk_of):
            pos = np.nonzero(chunk_of == c)[0]
            off = int(c) * self.col_chunk
            out[:, torch.as_tensor(pos, device=self.device)] = self._rand_chunk(
                int(c), min(self.col_chunk, self.w - off), uniq[pos] - off)
        return out[:, torch.as_tensor(inverse.reshape(-1), device=self.device)]

    def _randomize(self, q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """[q - r ; r]: the 2n coefficients of T' = T + Z_H R."""
        return torch.cat([bb.sub(q, r), r], dim=0)

    def tf_coeffs_chunk(self, off: int, wc: int) -> torch.Tensor:
        """(n_committed, wc) trace-frame committed coefficients of the
        columns [off, off + wc), ``off`` a chunk boundary."""
        q = self.dft.idft_batch(bb.from_u32(self.trace[:, off : off + wc]))
        if not self.zk:
            return q
        return self._randomize(q, self._rand_chunk(off // self.col_chunk, wc))

    def quotient_coeffs_cols(self, cols) -> torch.Tensor:
        """(n_committed, k) trace-frame committed coefficients of arbitrary
        columns (the streamed quotient evaluates them on the quotient
        cosets), in chunks."""
        cols = np.asarray(cols)
        out = torch.empty((self.n_committed, len(cols)), dtype=bb.I32, device=self.device)
        for c0 in range(0, len(cols), self.col_chunk):
            part = cols[c0 : c0 + self.col_chunk]
            q = self.dft.idft_batch(self.monty_cols(part))
            out[:, c0 : c0 + len(part)] = self._randomize(q, self._rand_cols(part)) if self.zk else q
        return out

    def coeff_chunk(self, off: int, wc: int) -> torch.Tensor:
        """(n_committed, wc) plain-frame coefficients (the dense commit's r_small)."""
        return bb.mul_canonical(self.tf_coeffs_chunk(off, wc), self._sigma_pows[:, None])

    def lde_chunk(self, off: int, wc: int) -> torch.Tensor:
        """(lde_h, wc) natural-order committed codeword columns."""
        r_pad = torch.zeros((self.lde_h, wc), dtype=bb.I32, device=self.device)
        r_pad[: self.n_committed] = self.coeff_chunk(off, wc)
        return self.dft.dft_batch(r_pad)

    def lde_br_chunk(self, off: int, wc: int) -> torch.Tensor:
        """(lde_h, wc) bit-reversed committed codeword columns."""
        return reverse_matrix_index_bits(self.lde_chunk(off, wc))

    def _open_chunk(self, off: int, wc: int) -> Tuple[torch.Tensor, bool]:
        """The columns [off, off + wc) of the codeword as the reduced
        opening and the Keccak commit read them, and whether in natural row
        order (K9 and K1's absorb read through the bit reversal: no
        reversed copy)."""
        return self.lde_chunk(off, wc), True

    # -- PCS hooks -------------------------------------------------------------
    def __getitem__(self, rows) -> torch.Tensor:
        """Full LDE rows at the given bit-reversed indices (or a slice of
        them), all at once."""
        if isinstance(rows, slice):
            rows = torch.arange(self.block_h, device=self.device)[rows]
        rows = torch.as_tensor(rows, device=self.device)
        return torch.cat([self.lde_br_chunk(off, wc)[rows] for off, wc in self.chunks()], dim=1)

    def eval_at_points(self, points) -> List[torch.Tensor]:
        """A (w, 4) Monty tensor per plain-frame point: every column's
        polynomial there (the dense open's ``_eval_points``), in one pass
        over the chunks, each chunk's coefficients computed once and read
        once for all the points (K10)."""
        out = torch.empty((len(points), self.w, 4), dtype=bb.I32, device=self.device)
        for off, wc in self.chunks():
            open_kernel.eval_at_points(self.coeff_chunk(off, wc), points, 0, out[:, off : off + wc].zero_())
        return list(out)

    def reduced_contrib(self, acc, apows, points, log_h: int, row0: int, scales=None) -> torch.Tensor:
        """Add sum_p sum_col alpha_p^k (y_col(x) - y_col(z_p)) / (x - z_p)
        into ``acc``, the rows this process holds (``points``, ``apows`` and
        ``scales`` as for ``open_kernel.reduced_opening``: one table, point
        p's sum scaled by scales[p]; no point: the column sum alone).  The
        column combination is summed chunk by chunk (K9 without a point),
        once for all the points, then divided by every (x - z_p) in one
        launch (K9 on the ext sum): exact field arithmetic, the dense
        reduced opening's bits."""
        if not points:
            for off, wc in self.chunks():
                mat, natural = self._open_chunk(off, wc)
                open_kernel.reduced_opening(acc, [mat], apows[off : off + wc], log_h, row0, (), natural)
            return acc
        combined = torch.zeros_like(acc)
        for off, wc in self.chunks():
            mat, natural = self._open_chunk(off, wc)
            open_kernel.reduced_opening(combined, [mat], apows[off : off + wc], log_h, row0, (), natural)
            del mat
        return open_kernel.reduced_opening(acc, [], apows[:0], log_h, row0, points, ext_in=combined, scales=scales)


class ShardedWideSource(WideMatrixSource):
    """A ``WideMatrixSource`` on a row mesh (the JAX package's
    ``_tf_coeffs_mesh`` and mesh ``lde_br_chunk``): every rank holds the
    compact trace whole and its block of each chunk's LDE, ``block_h`` =
    lde_h / ranks rows from ``row0``.  Per chunk:

    * the iNTT runs whole on the rank (K2, no collective);
    * zk: rank d draws the rows [d * m, (d + 1) * m) of the chunk's
      randomizer, m = n / ranks, never its whole (n, wc) stream, and the
      rows that the ranks' LDE blocks read under [q - r ; r] travel in one
      all-to-all (``dist.ntt.move_rows``);
    * the rank builds its block of the zero-padded plain-frame coefficients
      locally (rows past n_committed are zero), and ``dist.ntt.dft_br``
      (K2's local stages, the exchange stages) gives its block of the
      bit-reversed codeword, the rows of the single-device ``lde_br_chunk``.

    The point sums dot the coefficient rows the rank drew with z^i and
    all-reduce mod p once; ``reduced_contrib`` and the row reads (by
    block-local index) work on the rank's block.  Every method that reads
    LDE rows is collective: every rank calls it."""

    def __init__(self, trace, dft, log_blowup: int, domain: TwoAdicCoset, mesh, col_chunk: Optional[int] = None,
                 zk_seed: Optional[int] = None):
        super().__init__(trace, dft, log_blowup, domain, col_chunk=col_chunk, zk_seed=zk_seed)
        self.mesh = mesh
        self.row0, self.block_h = block(mesh, self.lde_h)
        self._m = self.n // mesh.size  # the randomizer rows of a chunk that each rank draws
        self.rand_rows = 0  # the most rows of a chunk's randomizer that one draw took

    def _rand_rows(self, chunk_idx: int, wc: int, r0: int, rows: int) -> torch.Tensor:
        """Rows [r0, r0 + rows) of chunk ``chunk_idx``'s (n, wc) randomizer."""
        self.rand_rows = max(self.rand_rows, rows)
        return _sample_monty(fold_in(self._zk_key, chunk_idx), rows, wc, self.device, row0=r0)

    def _block_rows(self, j: int) -> List[Tuple[int, int]]:
        """(first row, rows) of the coefficient rows under rank j's LDE
        block: its rows of q (- r), and in zk its rows of r (as rows of r)."""
        r0, n = j * self.block_h, self.n
        out = [(r0, max(0, min(r0 + self.block_h, n) - r0))]
        if self.zk:
            a = max(r0, n)
            out.append((a - n, max(0, min(r0 + self.block_h, 2 * n) - a)))
        return out

    def lde_br_chunk(self, off: int, wc: int) -> torch.Tensor:
        """(block_h, wc): the rank's rows of the bit-reversed committed
        codeword columns [off, off + wc)."""
        q = self.dft.idft_batch(bb.from_u32(self.trace[:, off : off + wc]))
        spans = self._block_rows(self.mesh.rank)
        (a, k) = spans[0]
        pad = torch.zeros((self.block_h, wc), dtype=bb.I32, device=self.device)
        live = k
        if self.zk:
            m = self._m
            mine = self._rand_rows(off // self.col_chunk, wc, self.mesh.rank * m, m)
            r_lo, r_hi = dntt.move_rows(self.mesh, lambda j: [(j * m, m)], [mine], self._block_rows, "randomizer")
            pad[:k] = bb.sub(q[a : a + k], r_lo)
            a2, k2 = spans[1]
            if k2:
                at = self.n + a2 - self.row0
                pad[at : at + k2] = r_hi
                live = at + k2
        else:
            pad[:k] = q[a : a + k]
        del q
        pad[:live] = bb.mul_canonical(pad[:live], self._sigma_pows[self.row0 : self.row0 + live, None])
        return dntt.dft_br(self.mesh, pad, log2_strict(self.lde_h))

    def _open_chunk(self, off: int, wc: int) -> Tuple[torch.Tensor, bool]:
        return self.lde_br_chunk(off, wc), False  # the rank's block, bit-reversed

    def eval_at_points(self, points) -> List[torch.Tensor]:
        """A (w, 4) Monty tensor per plain-frame point: the rank sums the
        coefficient rows it draws (rows [d * m, (d + 1) * m) of q - r, and
        of r at n + d * m) against z^i (K10, both ranges into one sum), then
        one all-reduce mod p sums the ranks' values for every chunk and
        point."""
        m = self._m
        s = self.mesh.rank * m
        starts = [s, self.n + s] if self.zk else [s]
        local = torch.zeros((len(points), self.w, 4), dtype=bb.I32, device=self.device)
        for off, wc in self.chunks():
            q = self.dft.idft_batch(bb.from_u32(self.trace[:, off : off + wc]))[s : s + m]
            held = [q]
            if self.zk:
                r = self._rand_rows(off // self.col_chunk, wc, s, m)
                held = [bb.sub(q, r), r]
            for h, st in zip(held, starts):
                open_kernel.eval_at_points(bb.mul_canonical(h, self._sigma_pows[st : st + m, None]), points, st,
                                           local[:, off : off + wc])
        return list(self.mesh.all_reduce_mod_p(local, "point_sums"))


def wide_source(trace, pcs, domain: TwoAdicCoset, col_chunk: Optional[int] = None,
                zk_seed: Optional[int] = None) -> WideMatrixSource:
    """The streamed source for ``pcs``: on a mesh, rank blocks from the
    height at which the JAX package shards its transforms (n >= ranks^2,
    ``dist.pcs._min_sharded_log_h``); below it, and without a mesh, the
    single-device source (a mesh commits it whole)."""
    mesh = getattr(pcs, "mesh", None)
    args = (trace, pcs.dft, pcs.fri.log_blowup, domain)
    if mesh is not None and domain.log_n >= _min_sharded_log_h(mesh):
        return ShardedWideSource(*args, mesh, col_chunk=col_chunk, zk_seed=zk_seed)
    return WideMatrixSource(*args, col_chunk=col_chunk, zk_seed=zk_seed)


# ---------------------------------------------------------------------------
# Streamed commit
# ---------------------------------------------------------------------------
class P2RowStream:
    """Carry-state Poseidon2 sponge over column chunks of (N, k) Monty rows:
    whole rate-8 blocks go to K4 (``poseidon2_kernel.absorb_rows``), and
    the columns of a block that straddles a chunk boundary wait for the next
    chunk, so only the row's final block can be partial (``finalize``)."""

    def __init__(self, n_rows: int, device):
        self._state = torch.empty((n_rows, WIDTH), dtype=bb.I32, device=device)
        self._first = True
        self._pend: Optional[torch.Tensor] = None  # (n, < RATE) Monty columns

    def _absorb(self, mat: torch.Tensor) -> None:
        poseidon2_kernel.absorb_rows(self._state, mat, first=self._first)
        self._first = False

    def absorb_cols(self, mat_monty: torch.Tensor) -> None:
        if self._pend is not None:
            mat_monty = torch.cat([self._pend, mat_monty], dim=1)
            self._pend = None
        k = int(mat_monty.shape[1])
        full = (k // RATE) * RATE
        if full:
            self._absorb(mat_monty[:, :full])
        if k > full:
            self._pend = mat_monty[:, full:].contiguous()

    def finalize(self) -> torch.Tensor:
        """(N, 8) Monty leaf digests."""
        if self._pend is not None:
            self._absorb(self._pend)
            self._pend = None
        if self._first:
            raise ValueError("empty sponge input")
        return self._state[:, :OUT].contiguous()


def commit_wide(pcs, domain: TwoAdicCoset, source: WideMatrixSource) -> Tuple[tuple, PcsProverData]:
    """Streamed ``pcs.commit([(domain, evals)])`` for one wide matrix: the
    same Merkle root, no materialized LDE, on either stack, hiding included
    (the salts, drawn as the dense commit draws them and kept as their
    ``LazyMatrix`` on a counter-based rng, absorbed after the row values,
    as the dense leaves hash them).  Chunks run one after another (a device
    sync each), so one chunk's LDE is alive at a time.  On a mesh a
    ``ShardedWideSource`` absorbs its rows and salts and builds its subtree
    (``ShardedMmcs.commit_digest_blocks``); a single-device source is
    committed whole on every rank."""
    mmcs = pcs.val_mmcs
    inner = getattr(mmcs, "inner", mmcs)  # a mesh's ShardedMmcs wraps the stack's MMCS
    if mmcs.hiding and pcs.zk_layout != "tpu":
        raise ValueError("a hiding streamed commit needs zk_layout='tpu' (the p3 layout appends dense "
                         "random columns: use the dense prover)")
    salt_mat = salt_store = None
    if mmcs.hiding:
        salt_mat, salt_store = draw_rows(inner._rng, source.lde_h, inner.SALT_ELEMS, source.row0, source.block_h,
                                         source.device)
    keccak = not isinstance(inner, Poseidon2Mmcs)
    stream = (KeccakRowStream if keccak else P2RowStream)(source.block_h, source.device)
    for off, wc in source.chunks():
        if keccak:  # K1 reads the codeword as K2 leaves it, hashing canonical u32 words in the tree's order
            stream.absorb_monty(*source._open_chunk(off, wc))
        else:  # rows hash as their Monty values
            stream.absorb_cols(source.lde_br_chunk(off, wc))
        _sync(source.device)
    if salt_mat is not None:  # in the tree's order
        stream.absorb_monty(salt_mat, False) if keccak else stream.absorb_cols(salt_mat)
    del salt_mat
    if source.mesh is not None:
        root, data = mmcs.commit_digest_blocks(source, stream.finalize(), source.lde_h, salt_store)
    else:
        root, data = mmcs.commit_digests(source, stream.finalize(), salt_store)
    return root, PcsProverData(data, [source], [domain], [source.w])


# ---------------------------------------------------------------------------
# Partitioned, row-blocked quotient
# ---------------------------------------------------------------------------
def block_count(n: int, u: int, use_next: bool, panel_budget: int, min_block_log: int) -> int:
    """Row blocks r (a power of two, at most 32): each size-n quotient coset
    is cut into r strided sub-cosets so that the live int32 panels that K2
    and K7 take, (n/r, u) once, or three times when the partition reads
    next rows (current, next and block 0 for the wrap), fit
    ``panel_budget`` bytes; a block keeps at least 2^min_block_log rows.
    The coset's r folded panels, (n, u) in all, are live beside them."""
    live = 3 if use_next else 1
    r = 1
    while r < _MAX_BLOCKS and (n // r) > (1 << min_block_log) and (n // r) * u * 4 * live > panel_budget:
        r <<= 1
    return r


def _coset_panels(dft, tf: torch.Tensor, log_m: int, shift: int, r: int):
    """Yield, block by block, the coefficient columns ``tf`` evaluated on
    the r row blocks of the coset shift * <g> (g of order r 2^log_m), block
    k the points shift g^k * <g_m>: one fold of all r blocks from one read
    of ``tf`` (K8, ``quotient_kernel.panel_fold``), then one NTT (K2) a
    block as it is asked for."""
    raw = quotient_kernel.panel_fold(tf, log_m, shift, r)
    for k in range(r):
        yield dft.dft_batch(raw[k])


def partition_share(air: BaseAir, mesh) -> List[int]:
    """The partitions that this rank of ``mesh`` evaluates in the streamed
    quotient: in turn, the widest panel first, each goes to the rank with
    the fewest panel columns so far (ties to the lower rank)."""
    sizes = [len(quotient_kernel.panel_cols(part)[0]) for part in air.partitions()]
    load = [0] * mesh.size
    mine = []
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(mesh.size), key=lambda r: (load[r], r))
        load[r] += sizes[i]
        if r == mesh.rank:
            mine.append(i)
    return sorted(mine)


def quotient_chunks_streamed(
    air: BaseAir,
    source: WideMatrixSource,
    trace_domain: TwoAdicCoset,
    log_qd: int,
    alpha_pows: torch.Tensor,
    pis: Sequence[torch.Tensor],
    panel_budget: int = PANEL_BUDGET,
    min_block_log: int = MIN_BLOCK_LOG,
    mesh=None,
) -> Tuple[List[TwoAdicCoset], List[torch.Tensor]]:
    """Quotient chunk values, one (n, 4) ext matrix per quotient coset: the
    dense quotient pass's values split ``[j::qd]``.  Each partition's
    coefficients are computed once; then each coset j is cut into r row
    blocks (``block_count``), one fold for all of them (``_coset_panels``),
    and for each block k its columns are evaluated on the points
    shift_j * g^(k + r*t), the next rows are block k+1's (the last block's
    are block 0's, shifted by one row), the selectors are the coset's own
    at those rows, and the alpha-folded constraints add into rows k::r of
    the coset's accumulator.

    On a ``mesh`` each rank evaluates its ``partition_share`` over the
    whole height (its trace is whole: no collective), and one all-reduce
    mod p of the accumulators gives every rank the whole chunks (field
    addition is exact and commutative: the single-device values)."""
    dev = source.device
    n = source.n
    log_n = trace_domain.log_n
    qd = 1 << log_qd
    chunk_domains = trace_domain.create_disjoint_domain(n * qd).split_domains(qd)
    selectors = [trace_domain.selectors_on_coset_device(cd, dev) for cd in chunk_domains]
    pis = (torch.stack([torch.as_tensor(p, device=dev).reshape(()) for p in pis]).to(torch.int32) if len(pis)
           else torch.zeros((0,), dtype=torch.int32, device=dev))
    progs = quotient_kernel.programs(air, int(pis.shape[0]))
    accs = [ext4.zero((n,), dev) for _ in range(qd)]
    share = set(range(len(progs))) if mesh is None else set(partition_share(air, mesh))
    for p_idx, prog in enumerate(progs):
        if p_idx not in share:
            continue
        use_next = len(prog.next_cols) > 0
        r = block_count(n, len(prog.cols), use_next, panel_budget, min_block_log)
        log_m = log_n - log2_strict(r)
        tf = source.quotient_coeffs_cols(prog.cols)
        alpha_slice = alpha_pows[prog.offset : prog.offset + prog.count]
        for j, cd in enumerate(chunk_domains):
            panels = _coset_panels(source.dft, tf, log_m, cd.shift, r)
            # row t of block k is the coset's row k + r t: its next row is
            # block k+1's row t, or for the last block block 0's row t + 1
            first = cur = next(panels)
            for k in range(r):
                nxt = next(panels) if use_next and k + 1 < r else None
                if use_next:
                    nxt_panel, nshift = (first, 1) if nxt is None else (nxt, 0)
                else:
                    nxt_panel, nshift, first = cur, 0, None
                quotient_kernel.eval_fold(prog, cur, nxt_panel, nshift, selectors[j], k, r, pis, alpha_slice,
                                          accs[j], k, r, add=True, invz=False)
                del nxt_panel
                cur = nxt  # without next rows None: K7's panel goes before the next block's NTT
                if not use_next and k + 1 < r:
                    cur = next(panels)
            del first, cur, panels
        del tf
    if mesh is not None and mesh.size > 1:
        accs = list(mesh.all_reduce_mod_p(torch.stack(accs), "quotient_sums"))
    chunks = [ext4.mul_base(accs[j], selectors[j]["inv_zeroifier"]) for j in range(qd)]
    return chunk_domains, chunks


# ---------------------------------------------------------------------------
# The streamed prove
# ---------------------------------------------------------------------------
def prove_wide(
    config,
    air: BaseAir,
    trace: torch.Tensor,  # (n, width) canonical values, e.g. uint8 bits
    public_values: Sequence[int],
    col_chunk: Optional[int] = None,
    panel_budget: int = PANEL_BUDGET,
    min_block_log: int = MIN_BLOCK_LOG,
    timings: Optional[Dict[str, float]] = None,
) -> Proof:
    """Prove ``air`` over a trace too wide for the dense prover, on
    ``config.device``, with the transcript of ``prove.prove``, on either
    stack, zk or not: the proof equals the JAX package's, and the dense
    prover's where both fit, and verifies with ``verify``.  Needs
    ``air.partitions()``, and in zk the device rng (the randomizer is
    regenerated per column chunk).  If ``timings`` is a dict, the device is
    synchronized at each phase boundary and the phase wall times (s) are
    stored in it: trace_lde (the trace upload), trace_commit, quotient,
    quotient_commit, open.

    On a mesh (``create_config(mesh=...)``) every rank runs this with the
    whole trace: the trace's LDE lives in rank blocks
    (``ShardedWideSource``), the quotient is shared out by partition, and
    every rank ends with the single-device proof."""
    if air.partitions() is None:
        raise ValueError("the wide prover needs air.partitions() (see air.keccak_air.Partition)")
    if config.zk and config.zk_rng != "device":
        raise ValueError(
            f"the zk wide prover draws its trace randomizer per column chunk from the device rng; "
            f"zk_rng={config.zk_rng!r} would materialize the (n, w) randomizer"
        )
    pcs = config.pcs
    dev = config.device
    challenger = config.challenger()
    mark = phase_timer(timings, dev)

    n, width = int(trace.shape[0]), int(trace.shape[1])
    if width != air.width:
        raise ValueError(f"trace width {width} is not the AIR width {air.width}")
    log_n = log2_strict(n)
    log_qd = get_log_quotient_degree(air, len(public_values), config.zk)

    trace_domain = pcs.natural_domain_for_degree(n)
    source = wide_source(trace, pcs, trace_domain, col_chunk=col_chunk, zk_seed=config.rng_seed if config.zk else None)
    mark("trace_lde")
    committed_domain = pcs.natural_domain_for_degree(source.n_committed)
    trace_commit, trace_data = commit_wide(pcs, committed_domain, source)
    mark("trace_commit")

    challenger.observe_u32(log_n)
    challenger.observe_commitment(trace_commit)
    challenger.observe_u32s([int(p) % bb.P for p in public_values])
    alpha = challenger.sample_ext()

    alpha_pows_dev, pis_dev = constraint_inputs(air, public_values, alpha, dev)
    chunk_domains, chunks = quotient_chunks_streamed(
        air, source, trace_domain, log_qd, alpha_pows_dev,
        [pis_dev[i] for i in range(len(public_values))], panel_budget, min_block_log, getattr(pcs, "mesh", None),
    )
    mark("quotient")
    quotient_commit, quotient_data = pcs.commit(list(zip(chunk_domains, chunks)))
    del chunks
    mark("quotient_commit")
    proof = open_and_assemble(
        pcs, challenger, trace_domain, (trace_commit, quotient_commit), trace_data, quotient_data, log_n, log_qd
    )
    mark("open")
    return proof
