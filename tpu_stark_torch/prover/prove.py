"""uni-stark prove (counterpart of ``tpu_stark/prover/prove.py``).

Transcript (mirrored by verify.py):

1. observe log_degree (u32)
2. observe trace commitment; observe public values
3. alpha  = sample_ext           (constraint folding challenge)
4. observe quotient-chunks commitment
5. zeta   = sample_ext           (out-of-domain point); zeta' = g * zeta
6. pcs.open: [hiding: observe random-codeword commitment], observe opened
   values, FRI alpha/betas/final-poly/PoW/queries

zk mode: the committed trace is T'(x) = T(x) + Z_H(x)*R(x) with R of degree
< n from the zk rng stream; Merkle leaves are salted and 4 random codewords
mask the FRI batch.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..air import quotient_kernel
from ..air.air import BaseAir, SymbolicAirBuilder, get_symbolic_info
from ..fields import babybear as bb
from ..fields import ref_field as rf
from ..fri.domains import TwoAdicCoset
from ..matrix import log2_strict
from .config import StarkConfig, make_zk_rng
from .proof import Commitments, OpenedValues, Proof


def _quotient_values(
    air: BaseAir,
    trace_on_q: torch.Tensor,
    pis: torch.Tensor,
    alpha_pows: torch.Tensor,
    log_n: int,
    log_m: int,
    main_next: Optional[torch.Tensor] = None,
    row0: int = 0,
) -> torch.Tensor:
    """The quotient pass over the quotient domain: selectors, constraint
    eval, alpha folding, zeroifier division, on K7 (``quotient_kernel.
    eval_fold``; its plain version on the CPU), one launch for an AIR
    without partitions, one a partition (its columns gathered) for one with
    them.  ``trace_on_q`` is every row of the domain, whose next rows are
    ``step`` rows on, or the rows [row0, row0 + len) with their next rows
    ``main_next`` (a mesh rank's block, ``dist/sharded.py``)."""
    trace_domain = TwoAdicCoset(log_n, 1)
    quotient_domain = trace_domain.create_disjoint_domain(1 << log_m)
    rows = int(trace_on_q.shape[0])
    if main_next is None:
        main_next, nshift = trace_on_q, (1 << log_m) >> log_n
    else:
        nshift = 0
    selectors = trace_domain.selectors_on_coset_device(quotient_domain, trace_on_q.device, row0, rows)
    out = torch.empty((rows, 4), dtype=bb.I32, device=trace_on_q.device)
    progs = quotient_kernel.programs(air, int(pis.shape[0]))
    whole = air.partitions() is None
    for i, prog in enumerate(progs):
        if whole:
            cur, nxt = trace_on_q, main_next
        else:
            cols = torch.as_tensor(prog.cols, device=trace_on_q.device)
            cur = trace_on_q.index_select(1, cols)
            nxt = cur if main_next is trace_on_q else main_next.index_select(1, cols)
        quotient_kernel.eval_fold(
            prog, cur, nxt, nshift, selectors, 0, 1, pis, alpha_pows[prog.offset : prog.offset + prog.count],
            out, 0, 1, add=i > 0, invz=i == len(progs) - 1)
    return out


def get_log_quotient_degree(air: BaseAir, num_public_values: int, zk: bool) -> int:
    """Quotient chunk-count exponent: chunks = next_pow2(max(d, 2) - 1),
    with trace variables counting double when the zk trace has degree 2n."""
    b = SymbolicAirBuilder(air.width, num_public_values, trace_degree_multiple=2 if zk else 1)
    air.eval(b)
    d = max(b.max_degree, 2)
    return max(0, math.ceil(math.log2(d - 1)))


def phase_timer(timings: Optional[Dict[str, float]], dev: torch.device):
    """``mark(phase)``: if ``timings`` is a dict, synchronize ``dev`` and
    store the wall time (s) since the previous mark under ``phase``."""
    t_last = [time.perf_counter()]

    def mark(phase: str) -> None:
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings[phase] = now - t_last[0]
            t_last[0] = now

    return mark


def constraint_inputs(air: BaseAir, public_values: Sequence[int], alpha, dev):
    """(alpha^0..alpha^(C-1) as a (C, 4) Monty tensor, the public values as a
    (k,) Monty tensor) on ``dev``, C = the AIR's constraint count."""
    num_constraints, _ = get_symbolic_info(air, len(public_values))
    apows = [(1, 0, 0, 0)]
    for _ in range(num_constraints - 1):
        apows.append(rf.emul(apows[-1], alpha))
    alpha_pows_dev = bb.to_tensor(bb.np_to_monty(np.array(apows, dtype=np.uint64)), dev)
    pis_dev = bb.to_tensor(
        bb.np_to_monty(np.array([int(p) % bb.P for p in public_values], dtype=np.uint64)), dev
    )
    return alpha_pows_dev, pis_dev


def open_and_assemble(pcs, challenger, trace_domain, commits, trace_data, quotient_data,
                      log_n: int, log_qd: int) -> Proof:
    """Transcript steps 4-6: observe the quotient commitment, sample zeta,
    open the trace at zeta and zeta' and the quotient chunks at zeta, and
    assemble the proof."""
    trace_commit, quotient_commit = commits
    qd = 1 << log_qd
    challenger.observe_commitment(quotient_commit)
    zeta = challenger.sample_ext()
    zeta_next = trace_domain.next_point_ext(zeta)
    opened, fri_proof = pcs.open(
        [
            (trace_data, [[zeta, zeta_next]]),
            (quotient_data, [[zeta]] * qd),
        ],
        challenger,
    )
    return Proof(
        commitments=Commitments(trace_commit, quotient_commit),
        opened_values=OpenedValues(
            [tuple(v) for v in opened[0][0][0]],
            [tuple(v) for v in opened[0][0][1]],
            [[tuple(v) for v in opened[1][i][0]] for i in range(qd)],
        ),
        opening_proof=fri_proof,
        degree_bits=log_n,
        log_quotient_degree=log_qd,
    )


def prove(
    config: StarkConfig,
    air: BaseAir,
    trace: np.ndarray,  # (n, width) canonical uint32
    public_values: Sequence[int],
    timings: Optional[Dict[str, float]] = None,
) -> Proof:
    """Prove ``air`` over ``trace``.  If ``timings`` is a dict, the device
    is synchronized at each phase boundary and the phase wall times (s) are
    stored in it: trace_lde, trace_commit, quotient, quotient_commit, open."""
    pcs = config.pcs
    dft = pcs.dft
    dev = config.device
    challenger = config.challenger()
    mark = phase_timer(timings, dev)

    n, width = trace.shape
    assert width == air.width
    log_n = log2_strict(n)
    log_qd = get_log_quotient_degree(air, len(public_values), config.zk)
    qd = 1 << log_qd

    trace_domain = pcs.natural_domain_for_degree(n)
    # upload the u32 rows as they are; reduce and convert to Monty on the device
    rows = torch.from_numpy(np.ascontiguousarray(trace, dtype=np.uint32).view(np.int32)).to(dev)
    trace_dev = bb.from_u32((rows.to(torch.int64) & 0xFFFFFFFF) % bb.P)
    del rows

    # -- 1. commit (possibly randomized) trace -----------------------------
    if config.zk:
        rng = make_zk_rng(config.zk_rng, config.rng_seed, "trace", dev)
        r = bb.to_tensor(rng.sample_babybear_matrix_monty(n, width), dev)
        coeffs = dft.idft_batch(trace_dev)
        coeffs2 = torch.cat([bb.sub(coeffs, r), r], dim=0)  # (2n, w)
        committed_domain = pcs.natural_domain_for_degree(2 * n)
        committed_evals = dft.dft_batch(coeffs2)
        del r, coeffs, coeffs2, trace_dev
    else:
        committed_domain = trace_domain
        committed_evals = trace_dev
    mark("trace_lde")
    # commit takes the list over: the evals go before their transforms
    trace_items = [(committed_domain, committed_evals)]
    del committed_evals
    trace_commit, trace_data = pcs.commit(trace_items)
    mark("trace_commit")

    challenger.observe_u32(log_n)
    challenger.observe_commitment(trace_commit)
    challenger.observe_u32s([int(p) % bb.P for p in public_values])
    alpha = challenger.sample_ext()

    # -- 2. quotient over the disjoint coset -------------------------------
    quotient_domain = trace_domain.create_disjoint_domain(n * qd)
    trace_on_q = pcs.get_evaluations_on_domain(trace_data, 0, quotient_domain)
    # p3 zk layout: the committed trace carries appended random columns;
    # constraints read only the AIR columns
    trace_on_q = trace_on_q[:, :width]
    alpha_pows_dev, pis_dev = constraint_inputs(air, public_values, alpha, dev)
    mesh = getattr(pcs, "mesh", None)
    if mesh is None:
        quotient_vals = _quotient_values(air, trace_on_q, pis_dev, alpha_pows_dev, log_n, log_n + log_qd)
    else:
        # the rank's block of the quotient domain; its block of chunk i is
        # quotient_vals[i::qd] (the block height is a multiple of qd)
        from ..dist.sharded import sharded_quotient

        quotient_vals = sharded_quotient(mesh, air, trace_on_q, pis_dev, alpha_pows_dev, log_n, log_n + log_qd)
    del trace_on_q
    mark("quotient")

    chunk_domains = quotient_domain.split_domains(qd)
    chunk_items = [(d, quotient_vals[i::qd]) for i, d in enumerate(chunk_domains)]  # (n, 4) base mats
    del quotient_vals
    quotient_commit, quotient_data = pcs.commit(chunk_items)
    mark("quotient_commit")

    # -- 3. open at zeta ---------------------------------------------------
    proof = open_and_assemble(
        pcs, challenger, trace_domain, (trace_commit, quotient_commit), trace_data, quotient_data, log_n, log_qd
    )
    mark("open")
    return proof
