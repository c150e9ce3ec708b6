"""Sponge / serializing-hasher / compression constructions over Keccak-f
(counterpart of ``tpu_stark/hash/sponge.py``).

* ``PaddingFreeSponge<KeccakF, 25, 17, 4>``: absorb u64 items in rate-17
  chunks by overwriting the first state lanes, permute after every chunk
  (including the final partial one), squeeze the first 4 lanes.
* ``SerializingHasher``: canonical u32 field values packed little-endian in
  pairs into u64 items (odd tail zero-padded high).
* ``CompressionFunctionFromHasher<_, 2, 4>``: hash of left || right.

Host functions (Python ints) serve the transcript and the verifier; the
batched functions run the Merkle layers on kernel K1 (``keccak_kernel``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from tpu_stark.compat.native import sponge_u64_native

from . import keccak, keccak_kernel

WIDTH = 25
RATE = 17
OUT = 4


def sponge_hash_u64s(items: Sequence[int]) -> Tuple[int, int, int, int]:
    """PaddingFreeSponge over u64 items (C helper when built)."""
    items = list(items)
    if not items:
        return (0, 0, 0, 0)
    native = sponge_u64_native(items)
    if native is not None:
        return native
    state = [0] * WIDTH
    for off in range(0, len(items), RATE):
        for i, v in enumerate(items[off : off + RATE]):
            state[i] = v & keccak.U64
        state = keccak.keccak_f(state)
    return tuple(state[:OUT])  # type: ignore[return-value]


def pack_u32s_to_u64s(values_u32: Sequence[int]) -> List[int]:
    out = []
    vals = list(values_u32)
    for i in range(0, len(vals), 2):
        lo = vals[i] & 0xFFFFFFFF
        hi = (vals[i + 1] & 0xFFFFFFFF) if i + 1 < len(vals) else 0
        out.append(lo | (hi << 32))
    return out


def hash_field_row(values_u32: Sequence[int]) -> Tuple[int, int, int, int]:
    return sponge_hash_u64s(pack_u32s_to_u64s(values_u32))


def compress_digests(left: Sequence[int], right: Sequence[int]) -> Tuple[int, int, int, int]:
    return sponge_hash_u64s(list(left) + list(right))


def hash_field_rows_batched(mat_u32: torch.Tensor) -> torch.Tensor:
    """Hash each row of an (N, k) canonical-u32 int32 matrix -> (N, 4, 2)."""
    return keccak_kernel.hash_rows(mat_u32)


def compress_digests_batched(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Compress (N, 4, 2) digest arrays pairwise -> (N, 4, 2)."""
    n = int(left.shape[0])
    return keccak_kernel.hash_rows(left.reshape(n, 8), right.reshape(n, 8))
