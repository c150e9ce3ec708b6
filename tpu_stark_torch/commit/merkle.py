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

Digest = Tuple[int, int, int, int]  # 4 u64 words


@dataclasses.dataclass
class ProverData:
    """Committed matrices (Monty, device), salts, and all digest layers
    ((N_l, 4, 2) int32 on the device, leaf layer first)."""

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
    return tuple(int(row[j, 0]) | (int(row[j, 1]) << 32) for j in range(4))  # type: ignore[return-value]


def _leaf_layer(mats: Sequence[torch.Tensor]) -> torch.Tensor:
    return sponge.hash_field_rows_batched(bb.to_u32(torch.cat(list(mats), dim=1)))


def _compress_layer(digests: torch.Tensor) -> torch.Tensor:
    """Compress neighbouring digests: rows 2i, 2i+1 of a contiguous (N, 4, 2)
    layer are exactly the (N/2, 16) u32 rows left || right."""
    return keccak_kernel.hash_rows(digests.reshape(-1, 16))


def build_layers(
    matrices: Sequence[torch.Tensor], salts: Optional[Sequence[torch.Tensor]]
) -> List[torch.Tensor]:
    """Digest layers, leaves first, with per-height injection."""
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
    digests = _leaf_layer(groups[h])
    layers = [digests]
    while h > 1:
        h >>= 1
        digests = _compress_layer(digests)
        if h in groups:
            digests = sponge.compress_digests_batched(digests, _leaf_layer(groups[h]))
        layers.append(digests)
    return layers


class MerkleTreeMmcs:
    """Keccak Merkle MMCS.  In hiding mode the instance owns a ``SmallRng``
    whose state persists across commits (p3 ``MerkleTreeHidingMmcs``)."""

    SALT_ELEMS = 4

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
        layers = build_layers(matrices, salts)
        root = _digest_words(bb.to_numpy(layers[-1][0]))
        return root, ProverData(matrices, salts, layers, root)

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
            fetch.append(data.layers[l][torch.from_numpy((idx >> l) ^ 1).to(dev)])
        host = [bb.to_numpy(t) for t in fetch]
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
            proof = [_digest_words(host[n_rows + l][q]) for l in range(log_max)]
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

        node = sponge.hash_field_row(rows_at(max_h))
        idx = index
        h = max_h
        for sib in opening.proof:
            left, right = (node, sib) if idx & 1 == 0 else (sib, node)
            node = sponge.compress_digests(left, right)
            idx >>= 1
            h >>= 1
            inj = rows_at(h)
            if inj:
                node = sponge.compress_digests(node, sponge.hash_field_row(inj))
        return tuple(node) == tuple(commitment)
