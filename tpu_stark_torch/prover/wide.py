"""Streamed prover for very wide traces (counterpart of
``tpu_stark/prover/wide.py``; BASELINE config 4: keccak-air at 2^20 rows x
3,608 bit columns on the Poseidon2 stack, zk off).

The dense prover cannot hold this trace: its committed LDE alone is
2^21 x 3608 x 4 B = 30.3 GB, and its int64 field products several times
that.  Here:

* the trace stays on the device as its compact integer type (uint8 bits:
  3.78 GB at 2^20 x 3608);
* the committed LDE is never materialized: column chunks go through
  iNTT -> plain-frame scale -> zero-pad -> NTT -> bit-reversal (kernel K2)
  and into a carry-state sponge absorb (kernel K4) that holds one (lde_h, 16)
  Poseidon2 state across chunks; the Merkle tree is then built on the leaf
  digests (kernel K3), with the same root as the dense commit;
* the quotient runs one AIR partition at a time (``keccak_air.Partition``),
  over only that partition's columns, and one row block at a time: block k
  of quotient coset j holds the points shift_j * g^(k + r*t);
* the open phase recomputes chunk LDEs when it needs them: the out-of-domain
  evaluations, the reduced openings and the query rows
  (``commit/pcs.py`` dispatches on ``eval_at_point`` / ``reduced_contrib``).

Proofs are byte-identical to the dense prover's and the JAX package's.
Not ported: the zk wide prover (its per-chunk trace randomizer, ROADMAP
queue item 9), the Keccak-stack streamed commit
(``KeccakRowStream``), hiding streamed commits, the sharded mesh path, and
the JAX package's per-partition-class program cache and 64-column panel
padding, which exist only to bound XLA compiles.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..air.air import AirBuilder, BaseAir, SymbolicAirBuilder
from ..air.builders import QuotientBuilder
from ..air.values import DevVal
from ..commit.pcs import (
    PcsProverData, _block_plan, _combine_columns, _eval_at_point, _opened_sum, _over_y_minus_z,
)
from ..commit.poseidon2_mmcs import Poseidon2Mmcs
from ..fields import babybear as bb
from ..fields import extension as ext4
from ..fields import ref_field as rf
from ..fri.domains import TwoAdicCoset
from ..hash import poseidon2_kernel
from ..hash.poseidon2_kernel import OUT, RATE, WIDTH
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
    ``eval_at_point`` and ``reduced_contrib`` stream the open phase's
    column reductions.  ``col_chunk`` (a multiple of 8) does not change the
    proof."""

    def __init__(
        self,
        trace: torch.Tensor,  # (n, w) canonical values in a compact integer type (uint8 bits)
        dft,
        log_blowup: int,
        domain: TwoAdicCoset,
        col_chunk: Optional[int] = None,
        zk_seed: Optional[int] = None,
    ):
        if zk_seed is not None:
            raise NotImplementedError(
                "the zk wide source's per-chunk trace randomizer is not ported yet (ROADMAP queue item 9)"
            )
        self.n, self.w = int(trace.shape[0]), int(trace.shape[1])
        if self.n != domain.size:
            raise ValueError(f"trace height {self.n} is not the domain size {domain.size}")
        self.log_n = domain.log_n
        self.log_blowup = log_blowup
        self.lde_h = self.n << log_blowup
        self.dft = dft
        self.device = dft.device
        self.domain = domain
        self.col_chunk = col_chunk or default_col_chunk(self.lde_h)
        if self.col_chunk % RATE:
            raise ValueError(f"col_chunk {self.col_chunk} is not a multiple of {RATE}")
        self.trace = trace.to(self.device)
        # relabeling scale onto the plain frame (as pcs.commit): canonical powers
        sigma = (bb.GENERATOR * rf.finv(domain.shift)) % bb.P
        self._sigma_pows = bb.powers(sigma, self.n, self.device)

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

    def tf_coeffs_chunk(self, off: int, wc: int) -> torch.Tensor:
        """(n, wc) trace-frame coefficients of the columns [off, off + wc)."""
        return self.dft.idft_batch(bb.from_u32(self.trace[:, off : off + wc]))

    def quotient_coeffs_cols(self, cols) -> torch.Tensor:
        """(n, k) trace-frame coefficients of arbitrary columns (the streamed
        quotient evaluates them on the quotient cosets), in chunks."""
        cols = np.asarray(cols)
        out = torch.empty((self.n, len(cols)), dtype=bb.I32, device=self.device)
        for c0 in range(0, len(cols), self.col_chunk):
            part = cols[c0 : c0 + self.col_chunk]
            out[:, c0 : c0 + len(part)] = self.dft.idft_batch(self.monty_cols(part))
        return out

    def coeff_chunk(self, off: int, wc: int) -> torch.Tensor:
        """(n, wc) plain-frame coefficients (the dense commit's r_small)."""
        return bb.mul_canonical(self.tf_coeffs_chunk(off, wc), self._sigma_pows[:, None])

    def lde_br_chunk(self, off: int, wc: int) -> torch.Tensor:
        """(lde_h, wc) bit-reversed committed codeword columns."""
        r_pad = torch.zeros((self.lde_h, wc), dtype=bb.I32, device=self.device)
        r_pad[: self.n] = self.coeff_chunk(off, wc)
        return reverse_matrix_index_bits(self.dft.dft_batch(r_pad))

    # -- PCS hooks -------------------------------------------------------------
    def __getitem__(self, rows) -> torch.Tensor:
        """Full LDE rows at the given bit-reversed indices, all at once."""
        rows = torch.as_tensor(rows, device=self.device)
        return torch.cat([self.lde_br_chunk(off, wc)[rows] for off, wc in self.chunks()], dim=1)

    def eval_at_point(self, z_y) -> torch.Tensor:
        """(w, 4) Monty: every column's polynomial at the plain-frame point
        ``z_y`` (the dense open's ``_eval_at_point``, chunk by chunk)."""
        zpow = ext4.powers_device(z_y, self.n, self.device)
        return torch.cat(
            [_eval_at_point(self.coeff_chunk(off, wc), zpow) for off, wc in self.chunks()], dim=0
        )

    def reduced_contrib(self, apows, p_z, z_dev, y_br) -> torch.Tensor:
        """sum_col alpha^k (y_col(x) - y_col(z)) / (x - z): the column
        combination is summed chunk by chunk, then divided by (x - z) once
        (exact field arithmetic: the dense ``_reduced_quotient``'s bits)."""
        combined = None
        for off, wc in self.chunks():
            c = _combine_columns(self.lde_br_chunk(off, wc), apows[off : off + wc])
            combined = c if combined is None else ext4.add(combined, c)
        s = _opened_sum(apows, p_z)
        rows = _block_plan(self.lde_h, self.col_chunk)[0]
        out = torch.empty((self.lde_h, 4), dtype=bb.I32, device=self.device)
        for r0 in range(0, self.lde_h, rows):
            out[r0 : r0 + rows] = _over_y_minus_z(combined[r0 : r0 + rows], s, z_dev, y_br[r0 : r0 + rows])
        return out


# ---------------------------------------------------------------------------
# Streamed commit (Poseidon2 MMCS)
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
    same Merkle root, no materialized LDE.  Chunks run one after another
    (a device sync each), so one chunk's LDE is alive at a time."""
    mmcs = pcs.val_mmcs
    if not isinstance(mmcs, Poseidon2Mmcs):
        raise NotImplementedError(
            "the streamed commit on the Keccak MMCS (KeccakRowStream) is not ported yet; "
            "use hash='poseidon2'"
        )
    if mmcs.hiding:
        raise NotImplementedError("a hiding streamed commit (salts after the rows) is not ported yet")
    stream = P2RowStream(source.lde_h, source.device)
    for off, wc in source.chunks():
        stream.absorb_cols(source.lde_br_chunk(off, wc))
        _sync(source.device)
    root, data = mmcs.commit_digests(source, stream.finalize())
    return root, PcsProverData(data, [source], [domain], [source.w])


# ---------------------------------------------------------------------------
# Partitioned, row-blocked quotient
# ---------------------------------------------------------------------------
class _PartitionBuilder(QuotientBuilder):
    """QuotientBuilder over a sparse column view: a partition's eval reads
    global column indices, and only its declared columns exist (any other
    column is ``None`` in ``main_row`` and a ``KeyError`` in ``main_cols``)."""

    def __init__(self, local, nxt, local_cols, next_cols, selectors, pis):
        self._mats = [local, nxt]
        self._pos = [
            {int(c): i for i, c in enumerate(local_cols)},
            {int(c): i for i, c in enumerate(next_cols)},
        ]
        width = 1 + max([int(c) for c in local_cols] + [int(c) for c in next_cols])
        rows = []
        for mat, pos in zip(self._mats, self._pos):
            row = [None] * width
            for c, i in pos.items():
                row[c] = DevVal(mat[:, i])
            rows.append(row)
        # QuotientBuilder.__init__ would take every column; set its state here
        AirBuilder.__init__(
            self,
            main_rows=rows,
            is_first_row=DevVal(selectors["is_first_row"]),
            is_last_row=DevVal(selectors["is_last_row"]),
            is_transition=DevVal(selectors["is_transition"]),
            public_values=list(pis),
        )
        self._constraints = []

    def main_cols(self, offset: int, indices):
        pos, mat = self._pos[offset], self._mats[offset]
        idx = torch.as_tensor([pos[int(c)] for c in np.asarray(indices)], device=mat.device)
        return DevVal(mat[:, idx])


def partition_counts(air: BaseAir, num_pis: int) -> List[int]:
    """Constraints emitted per partition (their alpha-power offsets)."""
    counts = []
    for part in air.partitions():
        b = SymbolicAirBuilder(air.width, num_pis)
        part.eval(b)
        counts.append(b.constraint_count)
    return counts


def _panel_cols(part) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The partition's columns (local, then the next-row ones not local)
    and the positions of its local and next columns among them."""
    cols = [int(c) for c in part.local_cols]
    pos = {c: i for i, c in enumerate(cols)}
    for c in part.next_cols:
        if int(c) not in pos:
            pos[int(c)] = len(cols)
            cols.append(int(c))
    local = np.array([pos[int(c)] for c in part.local_cols], dtype=np.int64)
    nxt = np.array([pos[int(c)] for c in part.next_cols], dtype=np.int64)
    return np.array(cols, dtype=np.int64), local, nxt


def block_count(n: int, u: int, use_next: bool, panel_budget: int, min_block_log: int) -> int:
    """Row blocks r (a power of two, at most 32): each size-n quotient coset
    is cut into r strided sub-cosets so that the live int32 panels, (n/r, u)
    once, or three times when the partition reads next rows (current, next
    and block 0 for the wrap), fit ``panel_budget`` bytes; a block keeps at
    least 2^min_block_log rows."""
    live = 3 if use_next else 1
    r = 1
    while r < _MAX_BLOCKS and (n // r) > (1 << min_block_log) and (n // r) * u * 4 * live > panel_budget:
        r <<= 1
    return r


def _panel_on_coset(dft, tf: torch.Tensor, log_m: int, shift: int) -> torch.Tensor:
    """Evaluate the (n, u) coefficient columns on the size-2^log_m coset
    shift * <g_m>: x^m = shift^m there, so the n coefficients fold to m with
    powers of shift^m, then scale by shift^i and one NTT."""
    m = 1 << log_m
    fold = tf[:m]
    s_m = pow(shift, m, bb.P)
    w = s_m
    for q in range(1, int(tf.shape[0]) // m):
        fold = bb.add(fold, bb.mul_canonical(tf[q * m : (q + 1) * m], w))
        w = w * s_m % bb.P
    return dft.dft_batch(bb.mul_canonical(fold, bb.powers(shift, m, tf.device)[:, None]))


def quotient_chunks_streamed(
    air: BaseAir,
    source: WideMatrixSource,
    trace_domain: TwoAdicCoset,
    log_qd: int,
    alpha_pows: torch.Tensor,
    pis: Sequence[torch.Tensor],
    panel_budget: int = PANEL_BUDGET,
    min_block_log: int = MIN_BLOCK_LOG,
) -> Tuple[List[TwoAdicCoset], List[torch.Tensor]]:
    """Quotient chunk values, one (n, 4) ext matrix per quotient coset: the
    dense quotient pass's values split ``[j::qd]``.  Each partition's
    coefficients are computed once; then for each coset j and row block k
    (r blocks, ``block_count``), its columns are evaluated on the points
    shift_j * g^(k + r*t), the next rows are block k+1's (the last block's
    are block 0's, shifted by one row), the selectors are the coset's own
    at those rows, and the alpha-folded constraints add into rows k::r of
    the coset's accumulator."""
    dev = source.device
    n = source.n
    log_n = trace_domain.log_n
    g = bb.two_adic_generator(log_n)
    qd = 1 << log_qd
    chunk_domains = trace_domain.create_disjoint_domain(n * qd).split_domains(qd)
    selectors = [trace_domain.selectors_on_coset_device(cd, dev) for cd in chunk_domains]
    pis = [DevVal(p) for p in pis]
    counts = partition_counts(air, len(pis))
    offs = np.concatenate([[0], np.cumsum(counts)])
    accs = [ext4.zero((n,), dev) for _ in range(qd)]
    for p_idx, part in enumerate(air.partitions()):
        cols, local_pos, next_pos = _panel_cols(part)
        local_pos = torch.as_tensor(local_pos, device=dev)
        next_pos = torch.as_tensor(next_pos, device=dev)
        use_next = len(part.next_cols) > 0
        r = block_count(n, len(cols), use_next, panel_budget, min_block_log)
        log_m = log_n - log2_strict(r)
        tf = source.quotient_coeffs_cols(cols)
        alpha_slice = alpha_pows[int(offs[p_idx]) : int(offs[p_idx + 1])]
        for j, cd in enumerate(chunk_domains):
            shifts = [cd.shift * pow(g, k, bb.P) % bb.P for k in range(r)]
            acc = accs[j].view(1 << log_m, r, 4)
            cur = _panel_on_coset(source.dft, tf, log_m, shifts[0])
            # the last block's next rows are block 0's, one row on
            wrap = torch.roll(cur[:, next_pos], -1, dims=0)
            for k in range(r):
                nxt = None
                if use_next and k + 1 < r:
                    nxt = _panel_on_coset(source.dft, tf, log_m, shifts[k + 1])
                next_mat = wrap if nxt is None else nxt[:, next_pos]
                sel = {name: v[k::r] for name, v in selectors[j].items()}
                b = _PartitionBuilder(cur[:, local_pos], next_mat, part.local_cols, part.next_cols, sel, pis)
                part.eval(b)
                acc[:, k, :] = ext4.add(acc[:, k, :], b.folded_constraints(alpha_slice))
                del b, next_mat, cur
                if nxt is None and k + 1 < r:
                    nxt = _panel_on_coset(source.dft, tf, log_m, shifts[k + 1])
                cur = nxt
            del wrap
        del tf
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
    ``config.device``, with the transcript of ``prove.prove``: the proof is
    byte-identical to the dense prover's and verifies with ``verify``.
    Needs ``air.partitions()``, the Poseidon2 stack and zk off.  If
    ``timings`` is a dict, the device is synchronized at each phase boundary
    and the phase wall times (s) are stored in it: trace_lde (the trace
    upload), trace_commit, quotient, quotient_commit, open."""
    if air.partitions() is None:
        raise ValueError("the wide prover needs air.partitions() (see air.keccak_air.Partition)")
    if config.zk:
        raise NotImplementedError(
            "the zk wide prover (its streamed trace randomizer) is not ported yet (ROADMAP queue item 9)"
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
    source = WideMatrixSource(trace, pcs.dft, pcs.fri.log_blowup, trace_domain, col_chunk=col_chunk)
    mark("trace_lde")
    trace_commit, trace_data = commit_wide(pcs, trace_domain, source)
    mark("trace_commit")

    challenger.observe_u32(log_n)
    challenger.observe_commitment(trace_commit)
    challenger.observe_u32s([int(p) % bb.P for p in public_values])
    alpha = challenger.sample_ext()

    alpha_pows_dev, pis_dev = constraint_inputs(air, public_values, alpha, dev)
    chunk_domains, chunks = quotient_chunks_streamed(
        air, source, trace_domain, log_qd, alpha_pows_dev,
        [pis_dev[i] for i in range(len(public_values))], panel_budget, min_block_log,
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
