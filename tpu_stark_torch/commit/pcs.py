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
* low-memory mode (``commit/lowmem.py``): a codeword whose LDE height is at
  or above ``lowmem_log`` is released once its tree is built; every later
  reader recomputes it from the stored coefficients (``_LazyLde``), once a
  reader.

Frame convention: every committed codeword is relabeled onto the plain
subgroup (rows of height H live at y = g_H^bitrev(i)); out-of-domain points
map to ``zeta / GENERATOR``.

The LDEs run on kernel K2 and the trees on kernel K1 or K3; the open phase's
arithmetic on K9-K11 (``commit/open_kernel.py``): the point evaluations
(K10), the reduced openings (K9) and the FRI folds (K11).  The transcript
and the verifier are host code.
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
from ..matrix import bit_reversal_perm_device, log2_strict, reverse_bits_device, reverse_matrix_index_bits
from ..ntt.dft import Dft
from . import lowmem, open_kernel
from .merkle import BatchOpening, Digest, MerkleTreeMmcs
from .open_kernel import _bit_reverse


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

def _plain_point_at(log_h: int, index: int) -> int:
    """g_H^bitrev(index): one point of the bit-reversed plain frame."""
    return pow(bb.two_adic_generator(log_h), _bit_reverse(index, log_h), bb.P)


def _alpha_pows_np(alpha: ExtPoint, offset: int, w: int) -> np.ndarray:
    """(w, 4) canonical int64 [alpha^offset, ..., alpha^(offset+w-1)]."""
    rows = []
    cur = rf.epow(alpha, offset)
    for _ in range(w):
        rows.append(cur)
        cur = rf.emul(cur, alpha)
    return np.array(rows, dtype=np.int64).reshape(w, 4)


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


class _LazyLde:
    """Stand-in for a released committed codeword: its h-row plain-frame
    coefficients, from which each reader recomputes the (lde_h, w) LDE
    with one transform (K2, or K5 on the narrow route) of the zero-padded
    coefficients.  A kernel failure propagates."""

    def __init__(self, r_small: torch.Tensor, lde_h: int, dft: Dft):
        self._rc = r_small
        self._dft = dft
        self.shape = (lde_h, int(r_small.shape[1]))

    @staticmethod
    def codeword(mats: Sequence["_LazyLde"]) -> torch.Tensor:
        """The natural-order codewords of released matrices of one LDE
        height, side by side, recomputed in one transform."""
        rc = mats[0]._rc if len(mats) == 1 else torch.cat([m._rc for m in mats], dim=1)
        r_pad = torch.zeros((mats[0].shape[0], int(rc.shape[1])), dtype=bb.I32, device=rc.device)
        r_pad[: rc.shape[0]] = rc
        del rc
        return mats[0]._dft.dft_batch(r_pad)

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` of the bit-reversed codeword."""
        return self.codeword([self])[reverse_bits_device(idx, log2_strict(self.shape[0]))]

    def evals_strided(self, stride: int) -> torch.Tensor:
        """Every ``stride``-th row of the natural-order codeword."""
        return self.codeword([self])[::stride].contiguous()


def _group_operands(mats: Sequence) -> Tuple[List[torch.Tensor], bool]:
    """K9's operands for one height's group of matrices and whether they
    are read in natural row order: the committed (bit-reversed) codewords
    as they are, side by side; released ones recomputed together into one
    natural-order codeword, which K9 reads through the bit reversal."""
    if isinstance(mats[0], _LazyLde):
        return [_LazyLde.codeword(mats)], True
    return list(mats), False


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
        *,
        lowmem_log: int = lowmem.LOWMEM_LOG,
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
        # codewords at least this tall are released after their commit (0: never)
        self.lowmem_rows = lowmem.lowmem_rows(lowmem_log)

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
        domain size share one (h, sum of widths) transform.  A list
        argument is taken over: each group's evals leave it before the
        group's transforms, so that the caller's list does not keep them."""
        items = domains_and_evals if isinstance(domains_and_evals, list) else list(domains_and_evals)
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
            wide = items[ks[0]][1] if len(ks) == 1 else torch.cat([items[k][1] for k in ks], dim=1)
            for k in ks:
                items[k] = (domains[k], None)
            q_coeffs = self.dft.idft_batch(wide)
            del wide
            # committed codeword = q on (GEN/shift)*K relabeled to the plain
            # frame: r(y) = q(sigma * y), a per-column coefficient scale
            sig = torch.cat(
                [
                    bb.powers(bb.GENERATOR * rf.finv(domains[k].shift) % bb.P, h, q_coeffs.device)[
                        :, None
                    ].expand(h, widths[k])
                    for k in ks
                ],
                dim=1,
            )
            r_small = bb.mul_canonical(q_coeffs, sig)
            del q_coeffs, sig
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
            # the split columns of a group of several matrices are copies
            del codeword_br, r_small
        root, merkle_data = self.val_mmcs.commit(ldes_br)
        del ldes_br
        for k, domain in enumerate(domains):
            lde_h = domain.size << self.fri.log_blowup
            if lowmem.engaged(self.lowmem_rows, lde_h):
                merkle_data.matrices[k] = _LazyLde(r_coeffs[k], lde_h, self.dft)
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
        if isinstance(mat, _LazyLde):
            return mat.evals_strided(stride)
        rows = bit_reversal_perm_device(log2_strict(lde_h), mat.device)[::stride]
        return mat[rows]

    # -- the row-dependent steps of ``open`` (a sharded PCS overrides them) --
    def _lde_heights(self, data: PcsProverData) -> List[int]:
        """The committed (LDE) height of each matrix of a commit."""
        return [d.size << self.fri.log_blowup for d in data.domains]

    def _eval_points(self, data: PcsProverData, m_idx: int, zs: Sequence[ExtPoint]) -> List[torch.Tensor]:
        """The committed polynomial m_idx at each point (plain frame): (w, 4)
        Monty each (K10)."""
        rc = data.r_coeffs[m_idx]
        if hasattr(rc, "eval_at_points"):  # a streamed wide matrix: one pass over its chunks
            return rc.eval_at_points(list(zs))
        return list(open_kernel.eval_at_points(rc, zs))

    def _row_range(self, log_h: int) -> Tuple[int, int]:
        """(first row, rows) of the height-2^log_h reduced openings and FRI
        levels that this process holds."""
        return 0, 1 << log_h

    def _own_rows(self, mat, log_h: int):
        """The rows of a committed matrix of height 2^log_h that enter this
        process's reduced openings."""
        return mat

    def _commit_level(self, current: torch.Tensor, log_h: int):
        """Commit one FRI level: its leaf rows are the (H/2, 8) pairs
        (cw[2i], cw[2i+1]) that a fold joins."""
        return self.challenge_mmcs.commit([current.reshape(-1, 8)])

    def _fold(self, current: torch.Tensor, beta: ExtPoint, log_h: int, nxt: Optional[torch.Tensor]) -> torch.Tensor:
        """One FRI fold of the held rows of level log_h (K11), plus ``nxt``,
        the height-2^(log_h - 1) reduced opening's held rows, when given."""
        return open_kernel.fri_fold(current, beta, log_h, add=nxt)

    def _whole(self, current: torch.Tensor, log_h: int) -> torch.Tensor:
        """The whole height-2^log_h FRI level."""
        return current

    def _reduce_group(self, acc: torch.Tensor, grp: list, alpha: ExtPoint, off: int, log_h: int,
                      row0: int) -> int:
        """Add one group's reduced opening into ``acc`` (K9, one read of its
        matrices for all of its points); returns the next alpha offset.  The
        group's (matrix, point) jobs take the powers from ``off`` in order:
        matrix i at point p from off + P (w_0 + ... + w_(i-1)) + p w_i.  A
        lone matrix passes its first point's powers and scales alpha^(p w);
        a group of several at two points, a plane a point.  The opened sums
        are the host's dot products with the opened values, as the verifier
        forms them."""
        zs = grp[0][0]
        npts = len(zs)
        widths = [g[3] for g in grp]
        total = sum(widths)
        if npts == 0 or len(grp) == 1:
            apows_np = _alpha_pows_np(alpha, off, total)
            apows = bb.to_tensor(bb.np_to_monty(apows_np), self.device)
            scales = [rf.epow(alpha, p * total) for p in range(npts)] if npts > 1 else None
            points = [(z, rf.emul(scales[p] if scales else (1, 0, 0, 0),
                                  _dot_ext(apows_np, np.array([v for g in grp for v in g[2][p]], dtype=np.int64))))
                      for p, z in enumerate(zs)]
        else:
            planes = np.zeros((npts, total, 4), dtype=np.int64)
            col, start = 0, off
            for w in widths:
                for p in range(npts):
                    planes[p, col : col + w] = _alpha_pows_np(alpha, start + p * w, w)
                col, start = col + w, start + npts * w
            apows = bb.to_tensor(bb.np_to_monty(planes if npts > 1 else planes[0]), self.device)
            scales = None
            points = [(z, _dot_ext(planes[p], np.array([v for g in grp for v in g[2][p]], dtype=np.int64)))
                      for p, z in enumerate(zs)]
        if hasattr(grp[0][1], "reduced_contrib"):
            grp[0][1].reduced_contrib(acc, apows, points, log_h, row0, scales)
        else:
            # a group's released codewords are recomputed once, together
            mats, natural = _group_operands([g[1] for g in grp])
            open_kernel.reduced_opening(acc, mats, apows, log_h, row0, points, natural, scales=scales)
            del mats
        return off + total * max(1, npts)

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
            max_h = max(h for data, _ in rounds for h in self._lde_heights(data))
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
            opened_dev.append([
                self._eval_points(data, m_idx, [rf.escale(z, gen_inv) for z in mat_points])
                for m_idx, mat_points in enumerate(points)
            ])
        opened_values: OpenedValues = [
            [[[tuple(int(c) for c in row) for row in bb.np_from_monty(bb.to_numpy(v))] for v in md] for md in rd]
            for rd in opened_dev
        ]
        del opened_dev
        for rv in opened_values:
            for mv in rv:
                for pv in mv:
                    for val in pv:
                        challenger.observe_u32s(val)
        alpha = challenger.sample_ext()

        # 2. Reduced openings per log-height.  Consecutive matrices of one
        # height opened at the same points form a group that K9 reads once
        # for all of its points (never a streamed wide matrix, which reduces
        # itself chunk by chunk, nor released codewords beside committed
        # ones); alpha powers run per height, per (matrix, point) in job
        # order: the verifier's alpha_ctr walk.
        jobs_by_height: Dict[int, list] = {}
        for (data, points), r_opened in zip(rounds, opened_values):
            for m_idx, mat_points in enumerate(points):
                log_h = log2_strict(self._lde_heights(data)[m_idx])
                mat_br = self._own_rows(data.merkle.matrices[m_idx], log_h)
                zs = tuple(rf.escale(zeta, gen_inv) for zeta in mat_points)
                jobs_by_height.setdefault(log_h, []).append((zs, mat_br, r_opened[m_idx], int(mat_br.shape[1])))

        ro: Dict[int, torch.Tensor] = {}
        for log_h, hjobs in jobs_by_height.items():
            row0, rows = self._row_range(log_h)
            ro[log_h] = acc = ext4.zero((rows,), dev)
            groups: List[list] = []
            for job in hjobs:
                last = groups[-1][-1] if groups else None
                if (last is not None and last[0] == job[0] and not hasattr(job[1], "reduced_contrib")
                        and not hasattr(last[1], "reduced_contrib")
                        and isinstance(job[1], _LazyLde) == isinstance(last[1], _LazyLde)):
                    groups[-1].append(job)
                else:
                    groups.append([job])
            off = 0
            for grp in groups:
                off = self._reduce_group(acc, grp, alpha, off, log_h, row0)

        # 3. FRI commit phase: commit each level, sample beta, fold (adding
        # the next height's reduced opening in the same pass).
        log_max = max(ro)
        log_min = fri.log_blowup + fri.log_final_poly_len
        commit_phase_commits: List[Digest] = []
        commit_phase_data = []
        current = ro[log_max]
        log_h = log_max
        while log_h > log_min:
            c_root, c_data = self._commit_level(current, log_h)
            commit_phase_commits.append(c_root)
            commit_phase_data.append(c_data)
            challenger.observe_commitment(c_root)
            beta = challenger.sample_ext()
            current = self._fold(current, beta, log_h, ro.get(log_h - 1))
            log_h -= 1

        # final polynomial: un-bit-reverse, idft, keep final_poly_len coeffs
        current = self._whole(current, log_h)
        final_np = bb.np_from_monty(bb.to_numpy(self.dft.idft_batch(reverse_matrix_index_bits(current))))
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
            r_max = max(self._lde_heights(data))
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
