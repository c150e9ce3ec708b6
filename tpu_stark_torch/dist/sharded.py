"""The column-sharded LDE commit and the row-sharded quotient
(counterpart of ``tpu_stark/dist/sharded.py``).

* ``sharded_lde_commit``: each rank holds a block of the trace's columns
  (the reference's per-column data parallelism promoted to the mesh).  It
  extends its columns on kernel K2 (no communication: columns are
  independent), bit-reverses the rows into commit order, and one
  all-to-all turns the column blocks into row blocks; each rank hashes its
  leaves and subtree (K1), the subtree roots are all-gathered and every
  rank builds the top of the tree.
* ``sharded_quotient``: the quotient pass on the rank's block of the
  quotient domain, with the selectors of its global rows and the next
  rank's first ``step`` rows as the halo of its next-row access (wrapping
  from the last rank to rank 0), where JAX lets GSPMD place that
  collective.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..commit.merkle import Digest, MerkleTreeMmcs
from ..fields import babybear as bb
from ..matrix import reverse_matrix_index_bits
from ..ntt import radix2
from ..prover.prove import _quotient_values
from .comm import RowMesh, block
from .merkle import ShardedMmcs


def sharded_lde_commit(mesh: RowMesh, trace_cols: torch.Tensor, log_blowup: int,
                       mmcs=None) -> Tuple[torch.Tensor, Digest]:
    """(this rank's row block of the bit-reversed LDE, the Merkle root) from
    this rank's block of the trace's columns (every rank the same width).
    The coset is GENERATOR * <g'>; the tree is ``mmcs`` (a Keccak
    ``MerkleTreeMmcs`` by default)."""
    lde_br = reverse_matrix_index_bits(radix2.coset_lde_batch(trace_cols, log_blowup, bb.GENERATOR))
    h_lde = int(lde_br.shape[0])
    rows = h_lde // mesh.size
    parts = [lde_br[j * rows : (j + 1) * rows] for j in range(mesh.size)]
    got = mesh.all_to_all_rows(parts, [rows] * mesh.size, "columns_to_rows")
    row_block = torch.cat(got, dim=1)
    root, _ = ShardedMmcs(mmcs if mmcs is not None else MerkleTreeMmcs(lowmem_log=0), mesh).commit_blocks(
        [row_block], [h_lde])
    return row_block, root


def sharded_prove_step(mesh: RowMesh, trace_cols: torch.Tensor, log_blowup: int = 2) -> Tuple[Digest, int]:
    """The multi-rank step of the dry run: trace columns in, (the root, the
    sum mod p of every element of the LDE) out."""
    row_block, root = sharded_lde_commit(mesh, trace_cols, log_blowup)
    col_sums = mesh.all_reduce_mod_p(bb.sum_mod(row_block, 0), "checksum")
    return root, int(bb.to_u32(bb.sum_mod(col_sums, 0)))


def sharded_quotient(mesh: RowMesh, air, trace_block: torch.Tensor, pis: torch.Tensor, alpha_pows: torch.Tensor,
                     log_n: int, log_m: int) -> torch.Tensor:
    """The rank's block of the quotient values over the quotient domain of
    2^log_m points, from its block of the trace's evaluations there."""
    step = (1 << log_m) >> log_n
    r0, rows = block(mesh, 1 << log_m)
    if int(trace_block.shape[0]) != rows or rows < step:
        raise ValueError(f"a quotient block of {trace_block.shape[0]} rows: want {rows} >= {step} (n >= ranks)")
    halo = mesh.next_halo(trace_block[:step])
    main_next = torch.cat([trace_block[step:], halo], dim=0)
    return _quotient_values(air, trace_block, pis, alpha_pows, log_n, log_m, main_next=main_next, row0=r0)
