"""Merkle-tree MMCS (mixed matrix commitment scheme) with optional hiding
(counterpart of ``tpu_stark/commit/merkle.py``).

* leaf hasher  = SerializingHasher(PaddingFreeSponge<KeccakF, 25, 17, 4>)
* compressor   = CompressionFunctionFromHasher<_, 2, 4>
* hiding       = a per-row salt of SALT_ELEMS = 4 BabyBear elements drawn
                 from the instance's SmallRng and hashed after the row values

Matrices of several power-of-two heights share one tree: the tallest form
the leaf layer, shorter ones are injected at the layer of their height
(digest = compress(compress(left, right), hash(injected rows))).  Rows hash
in canonical u32 form.  Every layer is one launch of kernel K1 on the
device, and all layers stay there; openings gather the few rows and
siblings they need in one transfer.  Verification is host code.
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

Digest = Tuple[int, ...]  # 4 u64 words (Keccak) or 8 canonical elements (Poseidon2)


@dataclasses.dataclass
class ProverData:
    """Committed matrices (Monty, device), salts, and all digest layers on
    the device, leaf layer first: (N_l, 4, 2) int32 Keccak words, or
    (N_l, 8) Monty elements in the Poseidon2 tree."""

    matrices: List[torch.Tensor]
    salts: Optional[List[torch.Tensor]]
    layers: List[torch.Tensor]
    root: Digest


@dataclasses.dataclass
class BatchOpening:
    """Opened rows (canonical u32, host) per matrix + salt rows + path."""

    opened_values: List[np.ndarray]
    opened_salts: Optional[List[np.ndarray]]
    proof: List[Digest]  # sibling digests, leaf layer first


def _digest_words(row: np.ndarray) -> Digest:
    """(4, 2) u32 [lo, hi] -> 4 u64 words."""
    return tuple(int(row[j, 0]) | (int(row[j, 1]) << 32) for j in range(4))


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
        h >>= 1
        digests = mmcs.compress_layer(digests)
        if h in groups:
            digests = mmcs.compress(digests, mmcs.leaf_layer(groups[h]))
        layers.append(digests)
    return layers


class MerkleTreeMmcs:
    """Keccak Merkle MMCS.  In hiding mode the instance owns a ``SmallRng``
    whose state persists across commits (p3 ``MerkleTreeHidingMmcs``).

    The tree logic is generic over the hash stack: a subclass replaces the
    static methods of the first block (``Poseidon2Mmcs``)."""

    SALT_ELEMS = 4

    # -- hash stack: Keccak over canonical u32 rows --------------------------
    @staticmethod
    def leaf_layer(mats: Sequence[torch.Tensor]) -> torch.Tensor:
        return sponge.hash_field_rows_batched(bb.to_u32(torch.cat(list(mats), dim=1)))

    @staticmethod
    def compress_layer(digests: torch.Tensor) -> torch.Tensor:
        """Compress neighbouring digests: rows 2i, 2i+1 of a contiguous
        (N, 4, 2) layer are exactly the (N/2, 16) u32 rows left || right."""
        return keccak_kernel.hash_rows(digests.reshape(-1, 16))

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
                 rng_seed: int = 1):
        self.hiding = hiding
        self._rng = rng if rng is not None else SmallRng.seed_from_u64(rng_seed)

    def commit(self, matrices: Sequence[torch.Tensor]) -> Tuple[Digest, ProverData]:
        matrices = list(matrices)
        assert matrices, "empty commit"
        for m in matrices:
            log2_strict(int(m.shape[0]))
        salts: Optional[List[torch.Tensor]] = None
        if self.hiding:
            salts = [
                bb.to_tensor(
                    self._rng.sample_babybear_matrix_monty(int(m.shape[0]), self.SALT_ELEMS),
                    m.device,
                )
                for m in matrices
            ]
        layers = build_layers(self, matrices, salts)
        root = self._root(layers)
        return root, ProverData(matrices, salts, layers, root)

    def commit_digests(self, matrix, digests: torch.Tensor) -> Tuple[Digest, ProverData]:
        """Commit one matrix whose leaf-digest layer is already computed
        (the streamed wide commit); ``matrix`` needs only ``shape`` and row
        gathers (``matrix[rows]``) for the openings.  Not hiding."""
        if self.hiding:
            raise NotImplementedError("a hiding commit from ready leaf digests (salts absorbed after the rows)")
        h = int(digests.shape[0])
        log2_strict(h)
        layers = build_layers_from_digests(self, digests, h)
        root = self._root(layers)
        return root, ProverData([matrix], None, layers, root)

    def _root(self, layers: List[torch.Tensor]) -> Digest:
        top = self.fetch_digests(layers[-1], torch.zeros(1, dtype=torch.int64, device=layers[-1].device))
        return self.host_digest(bb.to_numpy(top)[0])

    def open_batch_many(self, indices: Sequence[int], data: ProverData) -> List[BatchOpening]:
        """Open many query indices with one device-to-host transfer."""
        max_h = max(int(m.shape[0]) for m in data.matrices)
        log_max = log2_strict(max_h)
        idx = np.asarray(list(indices), dtype=np.int64)
        dev = data.layers[0].device
        fetch: List[torch.Tensor] = []
        for k, m in enumerate(data.matrices):
            rows = torch.from_numpy(idx >> (log_max - log2_strict(int(m.shape[0])))).to(dev)
            fetch.append(bb.to_u32(m[rows]))
            if data.salts is not None:
                fetch.append(bb.to_u32(data.salts[k][rows]))
        for l in range(log_max):
            fetch.append(self.fetch_digests(data.layers[l], torch.from_numpy((idx >> l) ^ 1).to(dev)))
        flat = bb.to_numpy(torch.cat([t.reshape(-1) for t in fetch]))
        host, pos = [], 0
        for t in fetch:
            host.append(flat[pos : pos + t.numel()].reshape(tuple(t.shape)))
            pos += t.numel()
        n_rows = len(data.matrices) * (2 if data.salts is not None else 1)
        out = []
        for q in range(len(idx)):
            opened, salts = [], ([] if data.salts is not None else None)
            pos = 0
            for _ in data.matrices:
                opened.append(np.array(host[pos][q]))
                pos += 1
                if salts is not None:
                    salts.append(np.array(host[pos][q]))
                    pos += 1
            proof = [self.host_digest(host[n_rows + l][q]) for l in range(log_max)]
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
