"""TwoAdicFriPcs — the FRI polynomial commitment scheme, with optional
hiding (counterpart of ``tpu_stark/commit/pcs.py``).

* ``commit``: per matrix, interpret the evals on their domain as a
  polynomial, low-degree extend by ``2^log_blowup`` onto the generator coset
  and commit the bit-reversed rows in a (hiding) Keccak Merkle tree.  The
  p3 zk layout first appends ``num_random_codewords`` random columns.
  The MMCS is either stack: the Keccak ``MerkleTreeMmcs`` or the field-native
  ``Poseidon2Mmcs``; the challenger is the matching Keccak ``Challenger`` or
  ``DuplexChallenger`` (duck-typed: observe, sample_ext, sample_bits, grind).
* ``open``: observe the out-of-domain values, sample alpha, combine every
  (matrix, point, column) quotient ``(p(x) - p(z)) / (x - z)`` into one
  reduced codeword per height, run the arity-2 FRI fold chain with one
  commit per level, grind, and answer the queries with Merkle openings.
* hiding (``num_random_codewords > 0``): a commitment of random codewords is
  mixed into the batch.

Frame convention: every committed codeword is relabeled onto the plain
subgroup (rows of height H live at y = g_H^bitrev(i)); out-of-domain points
map to ``zeta / GENERATOR``.

The LDEs run on kernel K2 and the trees on kernel K1 or K3; the reduced openings,
the folds and the point evaluations are plain torch on the device (kernel
candidates for later work).  The transcript and the verifier are host code.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compat.smallrng import SmallRng
from ..fields import babybear as bb
from ..fields import extension as ext4
from ..fields import ref_field as rf
from ..fri.config import FriParameters
from ..fri.domains import ExtPoint, TwoAdicCoset
from ..matrix import bit_reversal_perm, bit_reversal_perm_device, log2_strict, reverse_matrix_index_bits
from ..ntt.dft import Dft
from .merkle import BatchOpening, Digest, MerkleTreeMmcs


# ---------------------------------------------------------------------------
# Proof structures
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CommitPhaseStep:
    opening: BatchOpening  # the (pair) row of the folded codeword + path


@dataclasses.dataclass
class QueryProof:
    input_openings: List[BatchOpening]  # one per commit round
    commit_phase_openings: List[CommitPhaseStep]


@dataclasses.dataclass
class FriProof:
    commit_phase_commits: List[Digest]
    query_proofs: List[QueryProof]
    final_poly: List[ExtPoint]
    pow_witness: int
    random_commit: Optional[Digest] = None


@dataclasses.dataclass
class PcsProverData:
    merkle: object  # merkle.ProverData
    r_coeffs: List[torch.Tensor]  # per matrix: plain-frame coeffs (h, w)
    domains: List[TwoAdicCoset]
    widths: List[int]


OpenedValues = List[List[List[List[ExtPoint]]]]  # [round][matrix][point][column]

# The column reductions of the open phase run over (rows, cols) blocks of
# the matrix: at most _COL_CHUNK columns, and as many rows as keep one
# (rows, cols, 4) int64 intermediate within _ELEM_BUDGET elements (256 MiB),
# at any height and width.  Sums across blocks reduce mod p.
_COL_CHUNK = 64
_ELEM_BUDGET = 1 << 25


def _block_plan(h: int, w: int) -> Tuple[int, int]:
    """(rows, cols) per block of an (h, w) column reduction."""
    cols = max(1, min(w, _COL_CHUNK))
    rows = max(1, min(h, _ELEM_BUDGET // (4 * cols)))
    return rows, cols


# ---------------------------------------------------------------------------
# Device helpers (plain torch)
# ---------------------------------------------------------------------------
def _eval_at_point(r_coeffs: torch.Tensor, zpow: torch.Tensor) -> torch.Tensor:
    """r(z) for every column: (H, w) base coeffs x (H, 4) ext powers ->
    (w, 4) Monty.  Products reduce mod p before the int64 row sum of a
    block (below 2^63 for any block of fewer than 2^32 rows)."""
    h, w = r_coeffs.shape
    rows, cols = _block_plan(h, w)
    out = torch.empty((w, 4), dtype=bb.I32, device=r_coeffs.device)
    for c0 in range(0, w, cols):
        acc = torch.zeros((min(cols, w - c0), 4), dtype=torch.int64, device=r_coeffs.device)
        for r0 in range(0, h, rows):
            prod = bb.mul(r_coeffs[r0 : r0 + rows, c0 : c0 + cols, None], zpow[r0 : r0 + rows, None, :])
            acc = (acc + prod.to(torch.int64).sum(dim=0)) % bb.P
        out[c0 : c0 + cols] = acc.to(bb.I32)
    return out


def _combine_columns(mat_br: torch.Tensor, apows: torch.Tensor) -> torch.Tensor:
    """sum_col apows[col] * mat[:, col]: (H, w) x (w, 4) -> (H, 4) ext.  A
    row block sums its column chunks' reduced values in int64 (below w * p)
    and reduces once."""
    h, w = mat_br.shape
    rows, cols = _block_plan(h, w)
    out = torch.empty((h, 4), dtype=bb.I32, device=mat_br.device)
    for r0 in range(0, h, rows):
        acc = torch.zeros((min(rows, h - r0), 4), dtype=torch.int64, device=mat_br.device)
        for c0 in range(0, w, cols):
            prod = ext4.mul_base(apows[None, c0 : c0 + cols, :], mat_br[r0 : r0 + rows, c0 : c0 + cols])
            acc += prod.to(torch.int64).sum(dim=1)
        out[r0 : r0 + rows] = (acc % bb.P).to(bb.I32)
    return out


def _opened_sum(apows: torch.Tensor, p_z: torch.Tensor) -> torch.Tensor:
    """sum_col alpha^k y_col(z): (4,) Monty."""
    return bb.sum_mod(ext4.mul(apows, p_z), axis=0)


def _over_y_minus_z(combined, opened_sum, z_dev, y_br) -> torch.Tensor:
    """(combined - opened_sum) / (y - z) over one row block; ``combined`` is
    ``_combine_columns`` of the block's codeword rows."""
    diff = ext4.sub(combined, opened_sum[None, :])
    y_minus_z = ext4.sub(ext4.from_base(y_br), z_dev[None, :])
    return ext4.mul(diff, ext4.inv(y_minus_z))


def _reduced_quotient(mat_br, apows, p_z, z_dev, y_br) -> torch.Tensor:
    """(sum_col alpha^k (y_col(x) - y_col(z))) / (y - z) over the codeword,
    one row block at a time."""
    s = _opened_sum(apows, p_z)
    h, w = mat_br.shape
    rows, _ = _block_plan(h, w)
    out = torch.empty((h, 4), dtype=bb.I32, device=mat_br.device)
    for r0 in range(0, h, rows):
        block = _combine_columns(mat_br[r0 : r0 + rows], apows)
        out[r0 : r0 + rows] = _over_y_minus_z(block, s, z_dev, y_br[r0 : r0 + rows])
    return out


def _plain_points_br(log_h: int, device) -> torch.Tensor:
    """Monty g_H^bitrev(i) for i < 2^log_h."""
    pts = bb.powers(bb.two_adic_generator(log_h), 1 << log_h, device)
    return bb.from_u32(pts[bit_reversal_perm_device(log_h, device)])


def _plain_point_at(log_h: int, index: int) -> int:
    g = bb.two_adic_generator(log_h)
    rev = int(bit_reversal_perm(log_h)[index])
    return pow(g, rev, bb.P)


def _alpha_pows_np(alpha: ExtPoint, offset: int, w: int) -> np.ndarray:
    """(w, 4) canonical int64 [alpha^offset, ..., alpha^(offset+w-1)]."""
    rows = []
    cur = rf.epow(alpha, offset)
    for _ in range(w):
        rows.append(cur)
        cur = rf.emul(cur, alpha)
    return np.array(rows, dtype=np.int64).reshape(w, 4)


def _alpha_pows_dev(alpha: ExtPoint, offset: int, w: int, device) -> torch.Tensor:
    """(w, 4) Monty [alpha^offset, ..., alpha^(offset+w-1)]."""
    return bb.to_tensor(bb.np_to_monty(_alpha_pows_np(alpha, offset, w)), device)


def _dot_ext(apows: np.ndarray, vals: np.ndarray) -> ExtPoint:
    """sum_k apows[k] * vals[k] on the host: (w, 4) canonical ext powers
    times (w,) base values or (w, 4) ext values below 2^32.  Exact in int64:
    every product of two values below 2^32 and p is reduced mod p before a
    sum of fewer than 2^32 terms."""
    p = bb.P
    if vals.ndim == 1:
        terms = (apows * vals[:, None]) % p
    else:
        def m(i, j):
            return (apows[:, i] * vals[:, j]) % p

        w11 = ext4.W
        terms = np.stack([
            m(0, 0) + w11 * ((m(1, 3) + m(2, 2) + m(3, 1)) % p),
            m(0, 1) + m(1, 0) + w11 * ((m(2, 3) + m(3, 2)) % p),
            m(0, 2) + m(1, 1) + m(2, 0) + w11 * m(3, 3),
            m(0, 3) + m(1, 2) + m(2, 1) + m(3, 0),
        ], axis=1) % p
    return tuple(int(c) for c in terms.sum(axis=0) % p)


def _fold_inv2y(log_h: int, device) -> torch.Tensor:
    """Canonical 1/(2*y_j), y_j = g_lh^bitrev_{lh-1}(j), for j < 2^(lh-1):
    1/y = (g^-1)^e, so the table is a gathered power table."""
    g_inv = pow(bb.two_adic_generator(log_h), bb.P - 2, bb.P)
    h2 = 1 << (log_h - 1)
    pows = bb.powers(g_inv, h2, device)[bit_reversal_perm_device(log_h - 1, device)]
    return pows * ((bb.P + 1) // 2) % bb.P


def _fold_codeword(cw: torch.Tensor, beta_dev: torch.Tensor, log_h: int) -> torch.Tensor:
    """One arity-2 FRI fold in the bit-reversed plain frame:
    (e + o)/2 + beta * (e - o)/(2y); (H, 4) -> (H/2, 4)."""
    e, o = cw[0::2], cw[1::2]
    half_sum = bb.mul_canonical(ext4.add(e, o), (bb.P + 1) // 2)
    half_diff = bb.mul_canonical(ext4.sub(e, o), _fold_inv2y(log_h, cw.device)[:, None])
    return ext4.add(half_sum, ext4.mul(beta_dev[None, :], half_diff))


# ---------------------------------------------------------------------------
# The PCS
# ---------------------------------------------------------------------------
class TwoAdicFriPcs:
    def __init__(
        self,
        dft: Dft,
        fri_params: FriParameters,
        val_mmcs: Optional[MerkleTreeMmcs] = None,
        challenge_mmcs: Optional[MerkleTreeMmcs] = None,
        num_random_codewords: int = 0,
        rng: Optional[SmallRng] = None,
        zk_layout: str = "tpu",
    ):
        self.dft = dft
        self.device = dft.device
        self.fri = fri_params
        self.val_mmcs = val_mmcs if val_mmcs is not None else MerkleTreeMmcs()
        self.challenge_mmcs = challenge_mmcs if challenge_mmcs is not None else MerkleTreeMmcs()
        self.num_random_codewords = num_random_codewords
        self.rng = rng if rng is not None else SmallRng.seed_from_u64(1)
        # "tpu": random codewords only as a separate round at open time;
        # "p3": also num_random_codewords random COLUMNS appended to every
        # hiding commit (p3_fri::hiding_pcs::add_random_cols)
        if zk_layout not in ("tpu", "p3"):
            raise ValueError(f"unknown zk_layout {zk_layout!r}")
        self.zk_layout = zk_layout

    def natural_domain_for_degree(self, degree: int) -> TwoAdicCoset:
        return TwoAdicCoset(log2_strict(degree), 1)

    # -- commit ------------------------------------------------------------
    def commit(
        self,
        domains_and_evals: Sequence[Tuple[TwoAdicCoset, torch.Tensor]],
        _randomize: bool = True,
    ) -> Tuple[Digest, PcsProverData]:
        """Commit bit-reversed coset LDEs of the given evaluation matrices
        (Monty, natural row order on their domain).  Matrices on the same
        domain size share one (h, sum of widths) transform."""
        items = list(domains_and_evals)
        if _randomize and self.num_random_codewords > 0 and self.zk_layout == "p3":
            items = [
                (
                    d,
                    torch.cat(
                        [
                            e,
                            bb.to_tensor(
                                self.rng.sample_babybear_matrix_monty(
                                    int(e.shape[0]), self.num_random_codewords
                                ),
                                e.device,
                            ),
                        ],
                        dim=1,
                    ),
                )
                for d, e in items
            ]
        ldes_br: List[Optional[torch.Tensor]] = [None] * len(items)
        r_coeffs: List[Optional[torch.Tensor]] = [None] * len(items)
        domains = [d for d, _ in items]
        widths = [int(e.shape[1]) for _, e in items]
        groups: Dict[int, List[int]] = {}
        for k, (domain, evals) in enumerate(items):
            assert int(evals.shape[0]) == domain.size, "evals height mismatch"
            groups.setdefault(domain.log_n, []).append(k)
        for log_n, ks in groups.items():
            h = 1 << log_n
            lde_h = h << self.fri.log_blowup
            wide = torch.cat([items[k][1] for k in ks], dim=1)
            q_coeffs = self.dft.idft_batch(wide)
            # committed codeword = q on (GEN/shift)*K relabeled to the plain
            # frame: r(y) = q(sigma * y), a per-column coefficient scale
            sig = torch.cat(
                [
                    bb.powers(bb.GENERATOR * rf.finv(items[k][0].shift) % bb.P, h, wide.device)[
                        :, None
                    ].expand(h, widths[k])
                    for k in ks
                ],
                dim=1,
            )
            r_small = bb.mul_canonical(q_coeffs, sig)
            del q_coeffs, sig, wide
            r_pad = torch.zeros((lde_h, r_small.shape[1]), dtype=bb.I32, device=r_small.device)
            r_pad[:h] = r_small
            codeword_br = reverse_matrix_index_bits(self.dft.dft_batch(r_pad))
            del r_pad
            off = 0
            for k in ks:
                w = widths[k]
                ldes_br[k] = codeword_br[:, off : off + w].contiguous()
                r_coeffs[k] = r_small[:, off : off + w].contiguous()
                off += w
        root, merkle_data = self.val_mmcs.commit(ldes_br)
        return root, PcsProverData(merkle_data, r_coeffs, domains, widths)

    def get_evaluations_on_domain(
        self, data: PcsProverData, idx: int, domain: TwoAdicCoset
    ) -> torch.Tensor:
        """Natural-order evals of committed polynomial idx on ``domain`` (a
        sub-coset of the committed LDE coset)."""
        own = data.domains[idx]
        lde_h = own.size << self.fri.log_blowup
        assert domain.size <= lde_h
        expected_shift = (own.shift * bb.GENERATOR) % bb.P
        if domain.shift != expected_shift:
            raise ValueError(f"domain shift {domain.shift} not the LDE coset {expected_shift}")
        stride = lde_h // domain.size
        mat = data.merkle.matrices[idx]
        rows = bit_reversal_perm_device(log2_strict(lde_h), mat.device)[::stride]
        return mat[rows]

    # -- open --------------------------------------------------------------
    def open(
        self,
        rounds: Sequence[Tuple[PcsProverData, List[List[ExtPoint]]]],
        challenger,
    ) -> Tuple[OpenedValues, FriProof]:
        fri = self.fri
        dev = self.device
        rounds = list(rounds)

        # Hiding: a round of random codewords (no opening points).
        random_commit = None
        if self.num_random_codewords > 0:
            max_h = max(int(m.shape[0]) for data, _ in rounds for m in data.merkle.matrices)
            n_max = max_h >> fri.log_blowup
            rand_coeffs = bb.to_tensor(
                self.rng.sample_babybear_matrix_monty(n_max, self.num_random_codewords), dev
            )
            random_commit, r_data = self.commit(
                [(TwoAdicCoset(log2_strict(n_max), 1), self.dft.dft_batch(rand_coeffs))],
                _randomize=False,
            )
            challenger.observe_commitment(random_commit)
            rounds.append((r_data, [[]]))

        # 1. Out-of-domain values at z_y = zeta / GENERATOR, observed in order.
        gen_inv = rf.finv(bb.GENERATOR)
        opened_dev: List[List[List[torch.Tensor]]] = []
        for data, points in rounds:
            rd = []
            for m_idx, mat_points in enumerate(points):
                rc = data.r_coeffs[m_idx]
                if hasattr(rc, "eval_at_point"):  # a streamed wide matrix
                    rd.append([rc.eval_at_point(rf.escale(z, gen_inv)) for z in mat_points])
                    continue
                rd.append([
                    _eval_at_point(rc, ext4.powers_device(rf.escale(z, gen_inv), int(rc.shape[0]), dev))
                    for z in mat_points
                ])
            opened_dev.append(rd)
        opened_values: OpenedValues = [
            [[[tuple(int(c) for c in row) for row in bb.to_numpy(bb.to_u32(v))] for v in md] for md in rd]
            for rd in opened_dev
        ]
        for rv in opened_values:
            for mv in rv:
                for pv in mv:
                    for val in pv:
                        challenger.observe_u32s(val)
        alpha = challenger.sample_ext()

        # 2. Reduced openings per log-height.  Consecutive jobs of one height
        # at one point merge into one call over concatenated columns (never a
        # streamed wide matrix, which reduces itself chunk by chunk); alpha
        # powers run per height in job order, the verifier's alpha_ctr walk.
        jobs_by_height: Dict[int, list] = {}
        for (data, points), r_opened in zip(rounds, opened_dev):
            for m_idx, mat_points in enumerate(points):
                mat_br = data.merkle.matrices[m_idx]
                w = int(mat_br.shape[1])
                hjobs = jobs_by_height.setdefault(log2_strict(int(mat_br.shape[0])), [])
                if not mat_points:  # random codewords: mixed in directly
                    hjobs.append((None, mat_br, None, w))
                for p_idx, zeta in enumerate(mat_points):
                    hjobs.append((rf.escale(zeta, gen_inv), mat_br, r_opened[m_idx][p_idx], w))

        ro: Dict[int, torch.Tensor] = {}
        for log_h, hjobs in jobs_by_height.items():
            y_br = _plain_points_br(log_h, dev)
            ro[log_h] = ext4.zero((1 << log_h,), dev)
            groups: List[list] = []
            for job in hjobs:
                streamed = hasattr(job[1], "reduced_contrib") or (
                    groups and hasattr(groups[-1][-1][1], "reduced_contrib")
                )
                if groups and job[0] is not None and groups[-1][-1][0] == job[0] and not streamed:
                    groups[-1].append(job)
                else:
                    groups.append([job])
            off = 0
            for grp in groups:
                z_y = grp[0][0]
                w_total = sum(g[3] for g in grp)
                apows = _alpha_pows_dev(alpha, off, w_total, dev)
                mat = grp[0][1] if len(grp) == 1 else torch.cat([g[1] for g in grp], dim=1)
                if z_y is None:
                    contrib = _combine_columns(mat, apows)
                elif hasattr(mat, "reduced_contrib"):
                    contrib = mat.reduced_contrib(apows, grp[0][2], ext4.scalar(z_y, dev), y_br)
                else:
                    p_z = torch.cat([g[2] for g in grp], dim=0)
                    contrib = _reduced_quotient(mat, apows, p_z, ext4.scalar(z_y, dev), y_br)
                ro[log_h] = ext4.add(ro[log_h], contrib)
                off += w_total

        # 3. FRI commit phase: commit each level, sample beta, fold.
        log_max = max(ro)
        log_min = fri.log_blowup + fri.log_final_poly_len
        commit_phase_commits: List[Digest] = []
        commit_phase_data = []
        current = ro[log_max]
        log_h = log_max
        while log_h > log_min:
            # leaf rows are the (H/2, 8) pairs (cw[2i], cw[2i+1]) that a fold joins
            c_root, c_data = self.challenge_mmcs.commit([current.reshape(-1, 8)])
            commit_phase_commits.append(c_root)
            commit_phase_data.append(c_data)
            challenger.observe_commitment(c_root)
            beta = challenger.sample_ext()
            current = _fold_codeword(current, ext4.scalar(beta, dev), log_h)
            log_h -= 1
            if log_h in ro:
                current = ext4.add(current, ro[log_h])

        # final polynomial: un-bit-reverse, idft, keep final_poly_len coeffs
        final_np = bb.to_numpy(bb.to_u32(self.dft.idft_batch(reverse_matrix_index_bits(current))))
        n_final = 1 << fri.log_final_poly_len
        final_poly = [tuple(int(c) for c in final_np[i]) for i in range(n_final)]
        if final_np[n_final:].any():
            raise RuntimeError("FRI final polynomial degree too high")
        for coeff in final_poly:
            challenger.observe_u32s(coeff)

        # 4. Proof of work.
        pow_witness = challenger.grind(fri.proof_of_work_bits)

        # 5. Queries.
        indices = [challenger.sample_bits(log_max) for _ in range(fri.num_queries)]
        round_openings = []
        for data, _pts in rounds:
            r_max = max(int(m.shape[0]) for m in data.merkle.matrices)
            shift_bits = log_max - log2_strict(r_max)
            round_openings.append(
                self.val_mmcs.open_batch_many([i >> shift_bits for i in indices], data.merkle)
            )
        cp_level_openings = []
        idxs = list(indices)
        for c_data in commit_phase_data:
            idxs = [i >> 1 for i in idxs]
            cp_level_openings.append(self.challenge_mmcs.open_batch_many(idxs, c_data))
        query_proofs = [
            QueryProof(
                [ro_[q] for ro_ in round_openings],
                [CommitPhaseStep(lv[q]) for lv in cp_level_openings],
            )
            for q in range(fri.num_queries)
        ]
        return opened_values, FriProof(
            commit_phase_commits, query_proofs, final_poly, pow_witness, random_commit
        )

    # -- verify ------------------------------------------------------------
    def verify(
        self,
        rounds: Sequence[
            Tuple[Digest, List[Tuple[TwoAdicCoset, List[Tuple[ExtPoint, List[ExtPoint]]]]]]
        ],
        proof: FriProof,
        challenger,
    ) -> bool:
        """rounds: per commit round, (commitment, [per matrix: (domain,
        [(zeta, [value per column]), ...])]).  In hiding mode the
        random-codeword commitment travels in ``proof.random_commit``."""
        fri = self.fri
        rounds = list(rounds)
        if self.num_random_codewords > 0:
            if proof.random_commit is None:
                return False
            challenger.observe_commitment(proof.random_commit)
            max_lh = max(d.log_n + fri.log_blowup for _, mats in rounds for d, _ in mats)
            rounds.append(
                (proof.random_commit, [(TwoAdicCoset(max_lh - fri.log_blowup, 1), [])])
            )

        for _c, mats in rounds:
            for _domain, pts in mats:
                for _z, vals in pts:
                    for v in vals:
                        challenger.observe_u32s(v)
        alpha = challenger.sample_ext()

        betas = []
        for c in proof.commit_phase_commits:
            challenger.observe_commitment(c)
            betas.append(challenger.sample_ext())
        for coeff in proof.final_poly:
            challenger.observe_u32s(coeff)
        if not challenger.check_witness(fri.proof_of_work_bits, proof.pow_witness):
            return False

        log_max = max(d.log_n + fri.log_blowup for _c, mats in rounds for d, _ in mats)
        log_min = fri.log_blowup + fri.log_final_poly_len
        if len(proof.commit_phase_commits) != log_max - log_min:
            return False
        gen_inv = rf.finv(bb.GENERATOR)

        # Per (matrix, point), the alpha powers of its columns and
        # sum_col alpha^k * value_col do not depend on the query: a query's
        # reduced opening is then one dot product of its opened row with the
        # powers (numpy, exact: products reduce mod p before the sum).
        plans = []  # per round, per matrix: (log_h, [(z_y or None, apows, sum)])
        alpha_ctr: Dict[int, int] = {}
        for _c, mats in rounds:
            rplan = []
            for domain, pts in mats:
                log_h = domain.log_n + fri.log_blowup
                jobs = []
                for zeta, vals in pts or [(None, None)]:  # no points: random codewords
                    w = self.num_random_codewords if vals is None else len(vals)
                    ctr = alpha_ctr.get(log_h, 0)
                    alpha_ctr[log_h] = ctr + w
                    apows = _alpha_pows_np(alpha, ctr, w)
                    if vals is None:
                        jobs.append((None, apows, None))
                        continue
                    s = _dot_ext(apows, np.array([list(v) for v in vals], dtype=np.int64))
                    jobs.append((rf.escale(zeta, gen_inv), apows, s))
                rplan.append((log_h, jobs))
            plans.append(rplan)

        for q_idx in range(fri.num_queries):
            index = challenger.sample_bits(log_max)
            if len(proof.query_proofs) <= q_idx:
                return False
            qp = proof.query_proofs[q_idx]
            ro: Dict[int, ExtPoint] = {}
            if len(qp.input_openings) != len(rounds):
                return False
            for (commitment, mats), opening, rplan in zip(rounds, qp.input_openings, plans):
                if len(opening.opened_values) != len(mats):
                    return False
                dims = [
                    (domain.size << fri.log_blowup, len(v))
                    for (domain, _pts), v in zip(mats, opening.opened_values)
                ]
                r_max = max(h for h, _ in dims)
                reduced_index = index >> (log_max - log2_strict(r_max))
                if not self.val_mmcs.verify_batch(commitment, dims, reduced_index, opening):
                    return False
                for (log_h, jobs), row in zip(rplan, opening.opened_values):
                    y = _plain_point_at(log_h, index >> (log_max - log_h))
                    row = np.asarray(row, dtype=np.int64)
                    acc = ro.get(log_h, (0, 0, 0, 0))
                    for z_y, apows, s in jobs:
                        if row.shape != (len(apows),):
                            return False
                        dot = _dot_ext(apows, row)
                        if z_y is None:
                            acc = rf.eadd(acc, dot)
                            continue
                        denom_inv = rf.einv(rf.esub(rf.efrom_base(y), z_y))
                        acc = rf.eadd(acc, rf.emul(rf.esub(dot, s), denom_inv))
                    ro[log_h] = acc

            # walk the fold chain
            value = ro.get(log_max, (0, 0, 0, 0))
            idx = index
            log_h = log_max
            if len(qp.commit_phase_openings) != len(betas):
                return False
            for step_i, (step, beta) in enumerate(zip(qp.commit_phase_openings, betas)):
                row = step.opening.opened_values[0]  # (8,) flattened pair
                if len(row) != 8:
                    return False
                e = tuple(int(v) for v in row[0:4])
                o = tuple(int(v) for v in row[4:8])
                if (e if idx & 1 == 0 else o) != tuple(value):
                    return False
                if not self.challenge_mmcs.verify_batch(
                    proof.commit_phase_commits[step_i],
                    [(1 << (log_h - 1), 8)],
                    idx >> 1,
                    step.opening,
                ):
                    return False
                y_pair = _plain_point_at(log_h, idx & ~1)
                inv2 = rf.finv(2)
                half_sum = rf.escale(rf.eadd(e, o), inv2)
                half_diff = rf.escale(rf.esub(e, o), (inv2 * rf.finv(y_pair)) % bb.P)
                value = rf.eadd(half_sum, rf.emul(beta, half_diff))
                idx >>= 1
                log_h -= 1
                if log_h in ro and log_h >= log_min:
                    value = rf.eadd(value, ro[log_h])

            # final check: value == final_poly(y_final)
            y_final = _plain_point_at(log_h, idx)
            acc = (0, 0, 0, 0)
            ypow = 1
            for coeff in proof.final_poly:
                acc = rf.eadd(acc, rf.escale(tuple(coeff), ypow))
                ypow = (ypow * y_final) % bb.P
            if tuple(value) != acc:
                return False
        return True
