"""The sharded PCS: the multi-rank prover path (counterpart of
``tpu_stark/dist/pcs.py``).

``ShardedPcs`` is a ``TwoAdicFriPcs`` whose big matrices stay in
contiguous row blocks, one a rank, and are never gathered whole:

* **commit** (``dist/ntt.py``): per domain height, the bit-reversed frame
  of the evals (free for a matrix every rank holds whole, one all-to-all
  for a rank block), the sharded iNTT, the coset scale, the zero pad and
  the sharded DIF NTT, whose output is the rank's block of the committed
  frame; the tree is ``ShardedMmcs``'s (local subtree, gathered subroots),
  one tree for all the heights, as on one device.
  ``commit`` tells a replicated matrix (height = domain size) from a rank
  block (height = domain size / n); with one rank the two coincide.
* **get_evaluations_on_domain**: in the bit-reversed frame the stride-s
  subsample of the natural frame is the prefix of length H / s, so the
  quotient-domain evaluations are a reshard of the prefix and one
  bit-reversal reshard; the rank gets its block.
* **open**: the base class's steps, with the row-dependent ones on the
  rank's rows: the point evaluations sum the rank's coefficient rows and
  all-reduce mod p, the reduced openings and FRI folds run on the rank's
  block of each height (fold pairs (2i, 2i + 1) are adjacent in the
  bit-reversed frame), a level with fewer than 2 rows a rank is gathered
  (JAX's ``merkle.gather_if_tiny``), and the openings come from the owner
  ranks.  The transcript, query sampling and grind are host work that every
  rank repeats, so every rank ends with the same proof.

Transforms of fewer than n^2 rows (the bit-reversal reshard's limit) run
replicated on every rank, as JAX runs them single-device.  So do the
``Dft`` facade's transforms that ``prove`` and the PCS call directly (the
trace and its zk randomizer, the random codewords, the final polynomial):
every rank holds those matrices whole, in and out, so the facade is the
single-device ``Dft`` on the rank's device, with its ``narrow`` route.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..commit import open_kernel
from ..commit.pcs import PcsProverData, TwoAdicFriPcs
from ..fields import babybear as bb
from ..fields import ref_field as rf
from ..fri.domains import ExtPoint, TwoAdicCoset
from ..matrix import log2_strict, reverse_bits_device, reverse_matrix_index_bits
from ..ntt.dft import Dft
from . import ntt as dntt
from .comm import RowMesh, block
from .merkle import ShardedMmcs, ShardedProverData, draw_rows


def _min_sharded_log_h(mesh: RowMesh) -> int:
    """Smallest transform the mesh path runs: the bit-reversal reshard
    needs H >= n^2 (every block holds every residue mod n)."""
    return 2 * mesh.log_size


def _br_block(mesh: RowMesh, mat: torch.Tensor) -> torch.Tensor:
    """The rank's block of the bit-reversed frame of a matrix it holds whole."""
    log_h = log2_strict(int(mat.shape[0]))
    r0, rows = block(mesh, 1 << log_h)
    return mat[reverse_bits_device(torch.arange(r0, r0 + rows, dtype=torch.int64, device=mat.device), log_h)]


class ShardedPcs(TwoAdicFriPcs):
    """``TwoAdicFriPcs`` over a row mesh; see the module docstring.  Its
    MMCS are wrapped in ``ShardedMmcs``; the low-memory levers stay off."""

    def __init__(self, mesh: RowMesh, dft: Dft, fri_params, val_mmcs, challenge_mmcs, *args, **kwargs):
        if kwargs.get("lowmem_log", 0):
            raise ValueError("the low-memory levers do not engage on a mesh")
        kwargs["lowmem_log"] = 0
        super().__init__(dft, fri_params, ShardedMmcs(val_mmcs, mesh), ShardedMmcs(challenge_mmcs, mesh),
                         *args, **kwargs)
        self.mesh = mesh

    # -- commit -----------------------------------------------------------------
    def _is_block(self, domain: TwoAdicCoset, evals: torch.Tensor) -> bool:
        h = int(evals.shape[0])
        if h == domain.size:
            return False
        if h << self.mesh.log_size != domain.size:
            raise ValueError(f"evals of {h} rows are neither the domain ({domain.size}) nor a rank's block of it")
        return True

    def _random_cols(self, domain: TwoAdicCoset, evals: torch.Tensor) -> torch.Tensor:
        """The p3 layout's random columns for the rows of ``evals``, drawn for
        the whole domain height."""
        k = self.num_random_codewords
        if self._is_block(domain, evals):
            r0, rows = block(self.mesh, domain.size)
            return draw_rows(self.rng, domain.size, k, r0, rows, evals.device)[0]
        return bb.to_tensor(self.rng.sample_babybear_matrix_monty(domain.size, k), evals.device)

    def commit(self, domains_and_evals: Sequence[Tuple[TwoAdicCoset, torch.Tensor]], _randomize: bool = True):
        mesh = self.mesh
        items = domains_and_evals if isinstance(domains_and_evals, list) else list(domains_and_evals)
        if _randomize and self.num_random_codewords > 0 and self.zk_layout == "p3":
            items = [(d, torch.cat([e, self._random_cols(d, e)], dim=1)) for d, e in items]
        if any(d.log_n < _min_sharded_log_h(mesh) for d, _ in items):
            # small heights: every rank commits the whole matrices
            whole = [(d, mesh.all_gather(e, "small_gather") if self._is_block(d, e) else e) for d, e in items]
            items.clear()
            return super().commit(whole, _randomize=False)
        domains = [d for d, _ in items]
        widths = [int(e.shape[1]) for _, e in items]
        ldes_br: List[torch.Tensor] = [None] * len(items)
        r_coeffs: List[torch.Tensor] = [None] * len(items)
        groups: Dict[int, List[int]] = {}
        for k, d in enumerate(domains):
            groups.setdefault(d.log_n, []).append(k)
        # each height's matrices share one transform, as on one device; the
        # tree then takes the mixed heights, the shorter ones injected
        for log_h, ks in groups.items():
            # every matrix's block of the bit-reversed frame, side by side
            br = []
            for k in ks:
                d, e = items[k]
                items[k] = (d, None)
                br.append(dntt.bitrev_reshard(mesh, e, log_h) if self._is_block(d, e) else _br_block(mesh, e))
                del e
            wide = br[0] if len(br) == 1 else torch.cat(br, dim=1)
            del br
            q_coeffs = dntt.idft_from_br(mesh, wide, log_h)
            del wide
            # committed codeword = q on (GEN/shift)*K relabeled to the plain
            # frame: r(y) = q(sigma * y), a per-column coefficient scale
            rows = int(q_coeffs.shape[0])
            sig = torch.cat([
                dntt.row_powers(mesh, log_h, bb.GENERATOR * rf.finv(domains[k].shift) % bb.P, q_coeffs.device)[:, None]
                .expand(rows, widths[k]) for k in ks], dim=1)
            r_small = bb.mul_canonical(q_coeffs, sig)
            del q_coeffs, sig
            padded = dntt.pad_rows(mesh, r_small, log_h, self.fri.log_blowup)
            codeword_br = dntt.dft_br(mesh, padded, log_h + self.fri.log_blowup)
            del padded
            off = 0
            for k in ks:
                w = widths[k]
                ldes_br[k] = codeword_br[:, off : off + w].contiguous()
                r_coeffs[k] = r_small[:, off : off + w].contiguous()
                off += w
            del codeword_br, r_small
        items.clear()
        root, merkle_data = self.val_mmcs.commit_blocks(ldes_br, [d.size << self.fri.log_blowup for d in domains])
        return root, PcsProverData(merkle_data, r_coeffs, domains, widths)

    def get_evaluations_on_domain(self, data: PcsProverData, idx: int, domain: TwoAdicCoset) -> torch.Tensor:
        """The rank's block of the natural-order evals of committed
        polynomial idx on ``domain`` (a sub-coset of the LDE coset)."""
        mesh = self.mesh
        r0, rows = block(mesh, domain.size)
        if not isinstance(data.merkle, ShardedProverData):
            return super().get_evaluations_on_domain(data, idx, domain)[r0 : r0 + rows]
        own = data.domains[idx]
        lde_h = own.size << self.fri.log_blowup
        if domain.size > lde_h or domain.shift != (own.shift * bb.GENERATOR) % bb.P:
            raise ValueError(f"domain {domain} is not a sub-coset of the LDE coset")
        # natural[i] = codeword[stride * i] = codeword_br[bitrev_m(i)] for the
        # length-m prefix of the bit-reversed frame
        prefix = dntt.reshard_rows(mesh, data.merkle.matrices[idx], lde_h, domain.size, "prefix")
        if domain.log_n >= _min_sharded_log_h(mesh):
            return dntt.bitrev_reshard(mesh, prefix, domain.log_n)
        return reverse_matrix_index_bits(mesh.all_gather(prefix, "small_gather"))[r0 : r0 + rows]

    # -- the row-dependent steps of open ------------------------------------------
    def _eval_points(self, data: PcsProverData, m_idx: int, zs: Sequence[ExtPoint]) -> List[torch.Tensor]:
        rc = data.r_coeffs[m_idx]
        domain = data.domains[m_idx]
        # a streamed wide matrix sums its own coefficient rows (all-reducing
        # them when it is held in rank blocks)
        if not zs or hasattr(rc, "eval_at_points") or not self._is_block(domain, rc):
            return super()._eval_points(data, m_idx, zs)
        # the rank's coefficient rows [r0, r0 + rows) against z^(r0 + t)
        # (K10), reduced on the rank, then summed mod p over the ranks
        r0, _rows = block(self.mesh, domain.size)
        return list(self.mesh.all_reduce_mod_p(open_kernel.eval_at_points(rc, zs, r0), "point_sums"))

    def _sharded_height(self, log_h: int) -> bool:
        """Whether a height-2^log_h reduced opening or FRI level is held in
        rank blocks (at least 2 rows a rank) or whole."""
        return (1 << log_h) >= 2 * self.mesh.size

    def _row_range(self, log_h: int) -> Tuple[int, int]:
        if self._sharded_height(log_h):
            return block(self.mesh, 1 << log_h)
        return 0, 1 << log_h

    def _own_rows(self, mat, log_h: int):
        if getattr(mat, "mesh", None) is not None:  # a streamed source in rank blocks: its rows already
            return mat
        r0, rows = self._row_range(log_h)
        if int(mat.shape[0]) == rows:
            return mat
        if int(mat.shape[0]) != 1 << log_h:
            raise ValueError(f"a block of {mat.shape[0]} rows of a height-2^{log_h} matrix held whole")
        return mat[r0 : r0 + rows]

    def _commit_level(self, current: torch.Tensor, log_h: int):
        if self._sharded_height(log_h):
            return self.challenge_mmcs.commit_blocks([current.reshape(-1, 8)], [1 << (log_h - 1)])
        return super()._commit_level(current, log_h)

    def _fold(self, current: torch.Tensor, beta, log_h: int, nxt) -> torch.Tensor:
        """K11 on the rank's rows; where the next level is held whole, the
        rank adds its rows of ``nxt`` (held whole) before the gather."""
        r0, rows = self._row_range(log_h)
        gather = self._sharded_height(log_h) and not self._sharded_height(log_h - 1)
        if gather and nxt is not None:
            nxt = nxt[r0 >> 1 : (r0 + rows) >> 1]
        folded = open_kernel.fri_fold(current, beta, log_h, r0, nxt)
        return self.mesh.all_gather(folded, "fri_gather") if gather else folded

    def _whole(self, current: torch.Tensor, log_h: int) -> torch.Tensor:
        if self._sharded_height(log_h):
            return self.mesh.all_gather(current, "fri_gather")
        return current
