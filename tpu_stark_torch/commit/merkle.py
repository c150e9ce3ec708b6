"""Merkle-tree MMCS (mixed matrix commitment scheme) with optional hiding
(counterpart of ``tpu_stark/commit/merkle.py``).

* leaf hasher  = SerializingHasher(PaddingFreeSponge<KeccakF, 25, 17, 4>)
* compressor   = CompressionFunctionFromHasher<_, 2, 4>
* hiding       = a per-row salt of SALT_ELEMS = 4 BabyBear elements drawn
                 from the instance's SmallRng and hashed after the row values

Matrices of several power-of-two heights share one tree: the tallest form
the leaf layer, shorter ones are injected at the layer of their height
(digest = compress(compress(left, right), hash(injected rows))).  Rows hash
in canonical u32 form.  The leaf layer is one launch of kernel K1 on the
device, and each run of compress layers up to the next injection height a
few launches of its tree kernel (``keccak_kernel.compress_levels``); all
layers stay on the device, and openings gather the few rows and siblings
they need in one transfer.  Verification is host code.

Low-memory mode (``commit/lowmem.py``): at or above the instance's
threshold height a hiding commit on a counter-based rng keeps its salts as
their draw, and a single-height tree releases its leaf-most layers after
the root; the openings then rebuild the missing levels from the 2^K-row
blocks around the queries.  The Poseidon2 tree has neither lever, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compat.smallrng import SmallRng
from ..fields import babybear as bb
from ..hash import keccak_kernel, sponge
from ..matrix import log2_strict
from . import lowmem

Digest = Tuple[int, ...]  # 4 u64 words (Keccak) or 8 canonical elements (Poseidon2)

_CONVERT_ELEMS = 1 << 25  # elements a leaf layer converts to canonical form at a time


@dataclasses.dataclass
class ProverData:
    """Committed matrices (Monty, device), salts, and the digest layers on
    the device, leaf layer first: (N_l, 4, 2) int32 Keccak words, or
    (N_l, 8) Monty elements in the Poseidon2 tree.  A salt matrix may be
    kept as the ``LazyMatrix`` of its draw (``compat.device_rng``), and a
    matrix as a stand-in that recomputes it (``pcs._LazyLde``): the
    openings draw their rows through ``rows(idx)``.  When
    ``dropped_layers`` is K > 0 the K leaf-most layers were released and
    ``layers[0]`` is the level-K layer."""

    matrices: List
    salts: Optional[List]
    layers: List[torch.Tensor]
    root: Digest
    dropped_layers: int = 0


@dataclasses.dataclass
class BatchOpening:
    """Opened rows (canonical u32, host) per matrix + salt rows + path."""

    opened_values: List[np.ndarray]
    opened_salts: Optional[List[np.ndarray]]
    proof: List[Digest]  # sibling digests, leaf layer first


def _digest_words(row: np.ndarray) -> Digest:
    """(4, 2) u32 [lo, hi] -> 4 u64 words."""
    return tuple(int(row[j, 0]) | (int(row[j, 1]) << 32) for j in range(4))


def _gather_rows(m, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` of a committed matrix or salt: a stand-in that
    recomputes its values (``rows``) draws only those."""
    return m.rows(rows) if hasattr(m, "rows") else m[rows]


def build_layers(
    mmcs: "MerkleTreeMmcs",
    matrices: Sequence[torch.Tensor],
    salts: Optional[Sequence[torch.Tensor]],
) -> List[torch.Tensor]:
    """Digest layers, leaves first, with per-height injection, on the hash
    stack of ``mmcs``."""
    groups: Dict[int, List[torch.Tensor]] = {}
    for h in sorted({int(m.shape[0]) for m in matrices}, reverse=True):
        mats = []
        for k, m in enumerate(matrices):
            if int(m.shape[0]) == h:
                mats.append(m)
                if salts is not None:
                    mats.append(salts[k])
        groups[h] = mats
    h = max(groups)
    return build_layers_from_digests(mmcs, mmcs.leaf_layer(groups.pop(h)), h, groups)


def build_layers_from_digests(
    mmcs: "MerkleTreeMmcs",
    digests: torch.Tensor,
    max_h: int,
    groups: Optional[Dict[int, List[torch.Tensor]]] = None,
) -> List[torch.Tensor]:
    """The compress layers above a ready leaf-digest layer of height
    ``max_h``, with the matrices of ``groups`` injected at their heights:
    shared by the dense commit and the streamed wide commit."""
    groups = groups or {}
    h = max_h
    layers = [digests]
    while h > 1:
        nxt = max((g for g in groups if g < h), default=1)  # the next injection height, or the root
        run = mmcs.compress_layers(layers[-1], (h // nxt).bit_length() - 1)
        h = nxt
        if h in groups:
            run[-1] = mmcs.compress(run[-1], mmcs.leaf_layer(groups[h]))
        layers.extend(run)
    return layers


class MerkleTreeMmcs:
    """Keccak Merkle MMCS.  In hiding mode the instance owns a ``SmallRng``
    whose state persists across commits (p3 ``MerkleTreeHidingMmcs``).

    The tree logic is generic over the hash stack: a subclass replaces the
    static methods of the first block (``Poseidon2Mmcs``).

    ``lowmem_log`` sets the height from which ``commit`` pulls the
    low-memory levers (``commit/lowmem.py``; 0 switches them off)."""

    SALT_ELEMS = 4
    DENSE_LOWMEM = True  # a dense commit may keep lazy salts and drop leaf layers

    # -- hash stack: Keccak over canonical u32 rows --------------------------
    @staticmethod
    def leaf_layer(mats: Sequence[torch.Tensor]) -> torch.Tensor:
        """One K1 launch over the rows of the matrices side by side, in
        canonical form (converted in row blocks: the conversion's int64
        temporaries of a whole 2^26-row leaf layer would dwarf the tree)."""
        mats = list(mats)
        n = int(mats[0].shape[0])
        rows = torch.empty((n, sum(int(m.shape[1]) for m in mats)), dtype=torch.int32, device=mats[0].device)
        step = max(1, _CONVERT_ELEMS // max(1, int(rows.shape[1])))
        for r0 in range(0, n, step):
            rows[r0 : r0 + step] = bb.to_u32(torch.cat([m[r0 : r0 + step] for m in mats], dim=1))
        return sponge.hash_field_rows_batched(rows)

    @staticmethod
    def compress_layers(digests: torch.Tensor, levels: int) -> List[torch.Tensor]:
        """The ``levels`` layers above a layer (a run between injection
        heights), row i of each the compress of rows 2i, 2i + 1 below, in
        a few launches of K1's tree kernel."""
        return keccak_kernel.compress_levels(digests, levels)

    compress = staticmethod(sponge.compress_digests_batched)

    @staticmethod
    def fetch_digests(layer: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Digests ``rows`` of a device layer, in the form ``host_digest`` reads."""
        return layer[rows]

    host_digest = staticmethod(_digest_words)
    hash_row_host = staticmethod(sponge.hash_field_row)
    compress_host = staticmethod(sponge.compress_digests)

    # -- tree ----------------------------------------------------------------
    def __init__(self, hiding: bool = False, rng: Optional[SmallRng] = None,
                 rng_seed: int = 1, *, lowmem_log: int = lowmem.LOWMEM_LOG):
        self.hiding = hiding
        self._rng = rng if rng is not None else SmallRng.seed_from_u64(rng_seed)
        self.lowmem_rows = lowmem.lowmem_rows(lowmem_log)

    def commit(self, matrices: Sequence[torch.Tensor]) -> Tuple[Digest, ProverData]:
        matrices = list(matrices)
        assert matrices, "empty commit"
        heights = [int(m.shape[0]) for m in matrices]
        for h in heights:
            log2_strict(h)
        lm = self.lowmem_rows if self.DENSE_LOWMEM else 0
        salts: Optional[List[torch.Tensor]] = None
        kept: Optional[List] = None
        if self.hiding:
            salts, kept = [], []
            for m, h in zip(matrices, heights):
                if lowmem.engaged(lm, h) and hasattr(self._rng, "sample_lazy"):
                    # lazy salts: hash a transient draw, keep only the draw
                    draw = self._rng.sample_lazy(h, self.SALT_ELEMS)
                    salts.append(draw.materialize())
                    kept.append(draw)
                else:
                    salts.append(bb.to_tensor(self._rng.sample_babybear_matrix_monty(h, self.SALT_ELEMS), m.device))
                    kept.append(salts[-1])
        layers = build_layers(self, matrices, salts)
        del salts
        root = self._root(layers)
        drop = 0
        if len(set(heights)) == 1 and lowmem.engaged(lm, heights[0]):
            # a single-height tree releases its leaf-most layers (with
            # injected heights a block's rebuild would span several
            # matrices' layers); the layers kept are copied out of the tree
            # kernel's shared buffer so that the released ones free it
            drop = min(lowmem.DROP_LAYERS, len(layers) - 1)
            layers = [layer.clone() for layer in layers[drop:]] if drop else layers
        return root, ProverData(matrices, kept, layers, root, drop)

    def commit_digests(self, matrix, digests: torch.Tensor, salts=None) -> Tuple[Digest, ProverData]:
        """Commit one matrix whose leaf-digest layer is already computed
        (the streamed wide commit); ``matrix`` needs only ``shape`` and row
        gathers (``matrix[rows]``) for the openings.  A hiding MMCS takes
        the salts (a dense matrix or its ``LazyMatrix``) that the leaf
        digests absorbed after the rows, and keeps them for the openings."""
        if self.hiding != (salts is not None):
            raise ValueError("a hiding commit needs the salts its leaves absorbed, and only a hiding one")
        h = int(digests.shape[0])
        log2_strict(h)
        layers = build_layers_from_digests(self, digests, h)
        root = self._root(layers)
        return root, ProverData([matrix], None if salts is None else [salts], layers, root)

    def _root(self, layers: List[torch.Tensor]) -> Digest:
        top = self.fetch_digests(layers[-1], torch.zeros(1, dtype=torch.int64, device=layers[-1].device))
        return self.host_digest(bb.to_numpy(top)[0])

    def open_batch(self, index: int, data: ProverData) -> BatchOpening:
        """Open one query index (p3's ``open_batch``): the rows of every
        matrix at it, their salts, and the sibling path."""
        return self.open_batch_many([index], data)[0]

    def open_batch_many(self, indices: Sequence[int], data: ProverData) -> List[BatchOpening]:
        """Open many query indices with one device-to-host transfer.  A
        tree with K dropped layers gathers the 2^K-aligned block of leaf
        rows around every query, once per matrix and salt, and rebuilds
        the K missing levels of those blocks with the tree's own leaf and
        compress layers; the opened rows are sliced out of the blocks."""
        max_h = max(int(m.shape[0]) for m in data.matrices)
        log_max = log2_strict(max_h)
        idx = np.asarray(list(indices), dtype=np.int64)
        dev = data.layers[0].device
        K = data.dropped_layers
        fetch: List[torch.Tensor] = []
        if K:
            blocks = np.unique(idx >> K)
            # a power-of-two count of blocks for the tree kernel: the first
            # block repeated, its copies' digests never read
            padded = np.concatenate([blocks, np.full((1 << (len(blocks) - 1).bit_length()) - len(blocks), blocks[0])])
            rows = torch.from_numpy(((padded[:, None] << K) + np.arange(1 << K)).ravel()).to(dev)
            parts = []
            for k, m in enumerate(data.matrices):
                parts.append(_gather_rows(m, rows))
                if data.salts is not None:
                    parts.append(_gather_rows(data.salts[k], rows))
            fetch.extend(bb.to_u32(p) for p in parts)
            level = self.leaf_layer(parts)
            del parts
            for layer in [level] + self.compress_layers(level, K - 1):
                fetch.append(self.fetch_digests(layer, torch.arange(int(layer.shape[0]), device=dev)))
            row_pos = (np.searchsorted(blocks, idx >> K) << K) + (idx & ((1 << K) - 1))
        else:
            for k, m in enumerate(data.matrices):
                rows = torch.from_numpy(idx >> (log_max - log2_strict(int(m.shape[0])))).to(dev)
                fetch.append(bb.to_u32(_gather_rows(m, rows)))
                if data.salts is not None:
                    fetch.append(bb.to_u32(_gather_rows(data.salts[k], rows)))
            row_pos = np.arange(len(idx))
        for l in range(K, log_max):
            fetch.append(self.fetch_digests(data.layers[l - K], torch.from_numpy((idx >> l) ^ 1).to(dev)))
        flat = bb.to_numpy(torch.cat([t.reshape(-1) for t in fetch]))
        host, pos = [], 0
        for t in fetch:
            host.append(flat[pos : pos + t.numel()].reshape(tuple(t.shape)))
            pos += t.numel()
        step = 2 if data.salts is not None else 1  # host: each matrix's rows, then its salt rows
        n_rows = len(data.matrices) * step
        out = []
        for q in range(len(idx)):
            r = int(row_pos[q])
            opened = [np.array(host[j][r]) for j in range(0, n_rows, step)]
            salts = None if data.salts is None else [np.array(host[j][r]) for j in range(1, n_rows, 2)]
            # a rebuilt level l holds 2^(K - l) digests a block; the sibling
            # of the query's node is at (r >> l) ^ 1
            proof = [self.host_digest(host[n_rows + l][(r >> l) ^ 1]) for l in range(K)]
            proof += [self.host_digest(host[n_rows + l][q]) for l in range(K, log_max)]
            out.append(BatchOpening(opened, salts, proof))
        return out

    def verify_batch(
        self,
        commitment: Digest,
        dimensions: Sequence[Tuple[int, int]],  # (height, width) per matrix
        index: int,
        opening: BatchOpening,
    ) -> bool:
        max_h = max(h for h, _ in dimensions)
        log_max = log2_strict(max_h)
        if len(opening.proof) != log_max:
            return False

        def rows_at(height: int) -> List[int]:
            vals: List[int] = []
            for k, (h, _w) in enumerate(dimensions):
                if h == height:
                    vals.extend(int(v) for v in opening.opened_values[k])
                    if opening.opened_salts is not None:
                        vals.extend(int(v) for v in opening.opened_salts[k])
            return vals

        node = self.hash_row_host(rows_at(max_h))
        idx = index
        h = max_h
        for sib in opening.proof:
            left, right = (node, sib) if idx & 1 == 0 else (sib, node)
            node = self.compress_host(left, right)
            idx >>= 1
            h >>= 1
            inj = rows_at(h)
            if inj:
                node = self.compress_host(node, self.hash_row_host(inj))
        return tuple(node) == tuple(commitment)
