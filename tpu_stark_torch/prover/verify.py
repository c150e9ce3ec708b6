"""uni-stark verify — the host-side mirror of prove.py's transcript
(counterpart of ``tpu_stark/prover/verify.py``):

1. replay the Fiat-Shamir transcript to recover alpha, zeta;
2. recompute the folded constraints at zeta with the VerifierBuilder and
   check ``C(zeta) / Z_H(zeta) == sum_i zps_i(zeta) * chunk_i(zeta)``;
3. hand the opened values and commitments to the FRI PCS verifier.
"""

from __future__ import annotations

from typing import Sequence

from ..air.air import BaseAir
from ..air.builders import VerifierBuilder
from ..fields import babybear as bb
from ..fields import ref_field as rf
from .config import StarkConfig
from .proof import Proof
from .prove import get_log_quotient_degree


class VerificationError(Exception):
    pass


def verify(
    config: StarkConfig,
    air: BaseAir,
    proof: Proof,
    public_values: Sequence[int],
) -> bool:
    pcs = config.pcs
    challenger = config.challenger()

    log_n = proof.degree_bits
    n = 1 << log_n
    log_qd = get_log_quotient_degree(air, len(public_values), config.zk)
    if log_qd != proof.log_quotient_degree:
        return False
    qd = 1 << log_qd
    width = air.width
    # p3 zk layout: every hiding commit appended num_random_codewords random
    # columns (pcs.zk_layout, docs/so_evidence.md §3) — opened rows are wider
    # and the extra columns participate only in the FRI reduced opening.
    extra = (
        pcs.num_random_codewords
        if config.zk and getattr(pcs, "zk_layout", "tpu") == "p3"
        else 0
    )
    if (
        len(proof.opened_values.trace_local) != width + extra
        or len(proof.opened_values.trace_next) != width + extra
        or len(proof.opened_values.quotient_chunks) != qd
        or any(len(c) != 4 + extra for c in proof.opened_values.quotient_chunks)
    ):
        return False

    trace_domain = pcs.natural_domain_for_degree(n)
    committed_domain = (
        pcs.natural_domain_for_degree(2 * n) if config.zk else trace_domain
    )
    quotient_domain = trace_domain.create_disjoint_domain(n * qd)
    chunk_domains = quotient_domain.split_domains(qd)

    challenger.observe_u32(log_n)
    challenger.observe_commitment(proof.commitments.trace)
    challenger.observe_u32s([int(p) % bb.P for p in public_values])
    alpha = challenger.sample_ext()
    challenger.observe_commitment(proof.commitments.quotient_chunks)
    zeta = challenger.sample_ext()
    zeta_next = trace_domain.next_point_ext(zeta)

    # -- constraint check at zeta ------------------------------------------
    sels = trace_domain.selectors_at_point_ext(zeta)
    builder = VerifierBuilder(
        opened_local=proof.opened_values.trace_local[:width],
        opened_next=proof.opened_values.trace_next[:width],
        selectors=sels,
        public_values=public_values,
        alpha=alpha,
    )
    air.eval(builder)
    lhs = rf.emul(builder.folded_constraints(), sels["inv_zeroifier"])

    # recombine quotient chunks: Q(zeta) = sum_i zps_i(zeta) * chunk_i(zeta)
    x_basis = (0, 1, 0, 0)
    rhs = (0, 0, 0, 0)
    for i, chunk in enumerate(proof.opened_values.quotient_chunks):
        zps = (1, 0, 0, 0)
        for j, other in enumerate(chunk_domains):
            if j == i:
                continue
            zj = other.vanishing_poly_at_point_ext(zeta)
            at_first = other.vanishing_poly_at_point_ext(
                (chunk_domains[i].first_point(), 0, 0, 0)
            )
            zps = rf.emul(zps, rf.emul(zj, rf.einv(at_first)))
        chunk_val = (0, 0, 0, 0)
        basis = (1, 0, 0, 0)
        for coeff in chunk[:4]:  # p3 layout: trailing cols are random
            chunk_val = rf.eadd(chunk_val, rf.emul(basis, tuple(coeff)))
            basis = rf.emul(basis, x_basis)
        rhs = rf.eadd(rhs, rf.emul(zps, chunk_val))
    if lhs != rhs:
        return False

    # -- PCS verification --------------------------------------------------
    rounds = [
        (
            proof.commitments.trace,
            [
                (
                    committed_domain,
                    [
                        (zeta, [tuple(v) for v in proof.opened_values.trace_local]),
                        (zeta_next, [tuple(v) for v in proof.opened_values.trace_next]),
                    ],
                )
            ],
        ),
        (
            proof.commitments.quotient_chunks,
            [
                (chunk_domains[i], [(zeta, [tuple(v) for v in proof.opened_values.quotient_chunks[i]])])
                for i in range(qd)
            ],
        ),
    ]
    return pcs.verify(rounds, proof.opening_proof, challenger)
