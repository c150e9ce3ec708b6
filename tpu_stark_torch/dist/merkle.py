"""The Merkle commit and openings of a row-sharded matrix, over either of
the port's MMCS (``commit.merkle.MerkleTreeMmcs``, ``commit.poseidon2_mmcs.
Poseidon2Mmcs``).

JAX has no such class: GSPMD runs its tree programs on the sharded arrays.
Here each rank holds a contiguous block of 2^k rows, which is a complete
subtree:

* **commit**: the rank builds its leaf layer and subtree with the inner
  MMCS's ``leaf_layer`` / ``compress_layers`` (kernels K1 or K3), the
  subtree roots are all-gathered, and every rank builds the top log2(n)
  levels.  A hiding commit draws each matrix's salts for the rank's global
  rows: a counter-based rng (``DeviceRng``) draws only those rows
  (``sample_lazy(h, 4).block``, bit-exact), the host ``SmallRng`` draws the
  whole stream on every rank and slices it, so that every rank's rng state
  stays equal.  A commit of several heights is one tree, as on one device:
  a shorter matrix's rank block is injected into the rank's subtree at the
  layer of its height.  ``commit_digest_blocks`` takes the rank's leaf
  digests ready-made (the streamed wide commit).
* **openings**: the owner rank of a query opens its rows, salts and local
  path through the inner MMCS; the top path comes from the replicated top
  levels; one all-reduce hands every opening to every rank.  A streamed
  row block recomputes its rows with collectives, so every rank reads the
  rows it owns first, none included.

A replicated matrix (``commit``) takes the inner MMCS's own path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..commit.merkle import BatchOpening, Digest, MerkleTreeMmcs, ProverData, build_layers, build_layers_from_digests
from ..fields import babybear as bb
from .comm import RowMesh, block


def draw_rows(rng, h: int, cols: int, r0: int, rows: int, device):
    """Rows [r0, r0 + rows) of the rng's next (h, cols) Monty sample, with
    the rng advanced as by the whole sample: (the rows, what a commit keeps
    of them for its openings).  A counter-based rng draws only those rows
    and keeps their ``LazyMatrix``; the host rng draws the whole sample and
    keeps the rows."""
    if hasattr(rng, "sample_lazy"):
        lazy = rng.sample_lazy(h, cols).block(r0, rows)
        return lazy.materialize(), lazy
    vals = bb.to_tensor(rng.sample_babybear_matrix_monty(h, cols)[r0 : r0 + rows], device)
    return vals, vals


class _ReadRows:
    """Rows of a committed row block read ahead of its openings, standing in
    for it in the inner MMCS (which gathers them through ``rows``)."""

    def __init__(self, idx: torch.Tensor, vals: torch.Tensor, shape):
        order = torch.argsort(idx)
        self._idx, self._vals = idx[order], vals[order]
        self.shape = shape

    def rows(self, idx) -> torch.Tensor:
        idx = torch.as_tensor(idx, dtype=torch.int64, device=self._idx.device)
        return self._vals[torch.searchsorted(self._idx, idx)]


def _read_ahead(local: ProverData, rows_idx: List[int], rows: int) -> ProverData:
    """``local`` with each streamed row block (a matrix with a ``mesh``,
    ``prover.wide.ShardedWideSource``) replaced by its rows ``rows_idx``
    read now: such a read recomputes the block with collectives, so every
    rank makes it, the ranks that own no query too (with no rows)."""
    if not any(getattr(m, "mesh", None) is not None for m in local.matrices):
        return local
    idx = torch.as_tensor(rows_idx, dtype=torch.int64, device=local.layers[0].device)
    mats = [_ReadRows(idx, m[idx], (rows, int(m.shape[1]))) if getattr(m, "mesh", None) is not None else m
            for m in local.matrices]
    return dataclasses.replace(local, matrices=mats)


@dataclasses.dataclass
class ShardedProverData:
    """The rank's part of a sharded commit: its blocks, salts and subtree
    (``local``, a ``ProverData`` of the inner MMCS), the replicated top
    levels (subtree roots first), and the global height."""

    local: ProverData
    top: List[torch.Tensor]
    root: Digest
    height: int
    row0: int

    @property
    def matrices(self) -> list:
        return self.local.matrices


class ShardedMmcs:
    """A row-sharded MMCS over ``inner``; see the module docstring."""

    def __init__(self, inner: MerkleTreeMmcs, mesh: RowMesh):
        if inner.lowmem_rows:
            raise ValueError("the low-memory levers do not engage on a mesh")
        self.inner = inner
        self.mesh = mesh
        self.largest_whole = 0  # the most rows of a matrix this rank committed whole

    @property
    def hiding(self) -> bool:
        return self.inner.hiding

    def commit(self, matrices: Sequence[torch.Tensor]) -> Tuple[Digest, ProverData]:
        """A replicated commit: every rank builds the whole tree."""
        matrices = list(matrices)
        self.largest_whole = max([self.largest_whole] + [int(m.shape[0]) for m in matrices])
        return self.inner.commit(matrices)

    def commit_digests(self, matrix, digests: torch.Tensor, salts=None) -> Tuple[Digest, ProverData]:
        """A replicated streamed commit (``MerkleTreeMmcs.commit_digests``):
        every rank builds the whole tree."""
        self.largest_whole = max(self.largest_whole, int(digests.shape[0]))
        return self.inner.commit_digests(matrix, digests, salts)

    def commit_blocks(self, blocks: Sequence[torch.Tensor],
                      heights: Sequence[int]) -> Tuple[Digest, ShardedProverData]:
        """Commit matrices of global heights ``heights`` (at least n rows
        each) of which this rank holds the row blocks ``blocks``: one tree,
        a shorter matrix injected at the layer of its height.  The rank's
        block of the tallest is a complete subtree, and the layer at a
        shorter height holds exactly the rank's rows of that matrix, so each
        rank builds its subtree with the injections, as ``build_layers``
        does on one device."""
        inner, mesh = self.inner, self.mesh
        blocks, heights = list(blocks), [int(h) for h in heights]
        if len(blocks) != len(heights):
            raise ValueError(f"{len(blocks)} blocks for {len(heights)} heights")
        for b, h in zip(blocks, heights):
            if h < mesh.size or int(b.shape[0]) != block(mesh, h)[1]:
                raise ValueError(f"a block of {b.shape[0]} rows is not a rank's block of {h} rows")
        salts = None
        if inner.hiding:
            salts = [draw_rows(inner._rng, h, inner.SALT_ELEMS, *block(mesh, h), b.device)[0]
                     for b, h in zip(blocks, heights)]
        return self._commit_layers(build_layers(inner, blocks, salts), blocks, salts, max(heights))

    def commit_digest_blocks(self, matrix, digests: torch.Tensor, height: int,
                             salts=None) -> Tuple[Digest, ShardedProverData]:
        """Commit one matrix of global height ``height`` whose leaf digests
        of this rank's rows are already computed (the streamed wide commit
        on a mesh): the rank's subtree, the gathered subroots and the top.
        ``matrix`` reads the rank's rows by block-local index; a hiding MMCS
        takes the salts of those rows that the leaves absorbed."""
        if self.inner.hiding != (salts is not None):
            raise ValueError("a hiding commit needs the salts its leaves absorbed, and only a hiding one")
        if int(digests.shape[0]) != block(self.mesh, height)[1]:
            raise ValueError(f"{digests.shape[0]} leaf digests are not a rank's block of {height} rows")
        layers = build_layers_from_digests(self.inner, digests, int(digests.shape[0]))
        return self._commit_layers(layers, [matrix], None if salts is None else [salts], height)

    def _commit_layers(self, layers, matrices, salts, height: int) -> Tuple[Digest, ShardedProverData]:
        """The rank's subtree ``layers`` under the gathered subroots and the
        replicated top levels."""
        inner, mesh = self.inner, self.mesh
        top = [mesh.all_gather(layers[-1], "subroots")]
        if mesh.size > 1:
            top += inner.compress_layers(top[0], mesh.log_size)
        root = inner._root(top)
        local = ProverData(matrices, salts, layers, inner._root(layers))
        return root, ShardedProverData(local, top, root, height, block(mesh, height)[0])

    def open_batch(self, index: int, data) -> BatchOpening:
        return self.open_batch_many([index], data)[0]

    def open_batch_many(self, indices: Sequence[int], data) -> List[BatchOpening]:
        """Every query's opening on every rank: the owner opens its rows,
        salts and subtree path, the top path is read from the replicated
        top levels, and one all-reduce shares the owners' openings."""
        if not isinstance(data, ShardedProverData):
            return self.inner.open_batch_many(indices, data)
        inner, mesh = self.inner, self.mesh
        rows = data.height >> mesh.log_size
        idx = [int(i) for i in indices]
        widths = [int(m.shape[1]) for m in data.local.matrices]
        n_salt = inner.SALT_ELEMS if data.local.salts is not None else 0
        words = 2 * len(data.root)  # a digest word as two 32-bit halves
        sub_log = rows.bit_length() - 1
        width = sum(widths) + n_salt * len(widths) + sub_log * words
        buf = np.zeros((len(idx), width), dtype=np.int64)
        owned = [q for q, i in enumerate(idx) if data.row0 <= i < data.row0 + rows]
        local = _read_ahead(data.local, [idx[q] - data.row0 for q in owned], rows)
        if owned:
            local = inner.open_batch_many([idx[q] - data.row0 for q in owned], local)
            for q, op in zip(owned, local):
                vals = list(op.opened_values) + (list(op.opened_salts) if op.opened_salts is not None else [])
                digests = np.array([w for dg in op.proof for w in dg], dtype=np.uint64)
                buf[q] = np.concatenate([np.concatenate(vals).astype(np.int64) if vals else np.zeros(0, np.int64),
                                         (digests & 0xFFFFFFFF).astype(np.int64),
                                         (digests >> np.uint64(32)).astype(np.int64)])
        shared = mesh.all_reduce_sum(torch.from_numpy(buf).to(mesh.device), "openings").cpu().numpy()
        top = [bb.to_numpy(inner.fetch_digests(t, torch.arange(int(t.shape[0]), device=t.device))) for t in data.top]
        out = []
        n_dig = sub_log * len(data.root)
        for q, i in enumerate(idx):
            row = shared[q]
            pos, opened = 0, []
            for w in widths:
                opened.append(row[pos : pos + w].astype(np.uint32))
                pos += w
            salts = None
            if n_salt:
                salts = []
                for _ in widths:
                    salts.append(row[pos : pos + n_salt].astype(np.uint32))
                    pos += n_salt
            lo = row[pos : pos + n_dig].astype(np.uint64)
            hi = row[pos + n_dig : pos + 2 * n_dig].astype(np.uint64)
            flat = [int(v) for v in (lo | (hi << np.uint64(32)))]
            k = len(data.root)
            proof = [tuple(flat[j * k : (j + 1) * k]) for j in range(sub_log)]
            owner = i // rows
            proof += [inner.host_digest(top[l][(owner >> l) ^ 1]) for l in range(mesh.log_size)]
            out.append(BatchOpening(opened, salts, proof))
        return out

    def verify_batch(self, *args, **kwargs) -> bool:
        return self.inner.verify_batch(*args, **kwargs)
