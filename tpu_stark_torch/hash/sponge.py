"""Sponge / serializing-hasher / compression constructions over Keccak-f
(counterpart of ``tpu_stark/hash/sponge.py``).

* ``PaddingFreeSponge<KeccakF, 25, 17, 4>``: absorb u64 items in rate-17
  chunks by overwriting the first state lanes, permute after every chunk
  (including the final partial one), squeeze the first 4 lanes.
* ``SerializingHasher``: canonical u32 field values packed little-endian in
  pairs into u64 items (odd tail zero-padded high).
* ``CompressionFunctionFromHasher<_, 2, 4>``: hash of left || right.

Host functions (Python ints) serve the transcript and the verifier; the
batched functions run the Merkle layers on kernel K1 (``keccak_kernel``),
and ``KeccakRowStream`` hashes rows that arrive in column chunks (the
streamed wide commit) on K1's carried-state absorb.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..compat.native import sponge_u64_native

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


class KeccakRowStream:
    """SerializingHasher(PaddingFreeSponge) over the rows of an (N, k)
    canonical-u32 matrix that arrives in column chunks (counterpart of
    ``tpu_stark/hash/sponge.py::KeccakRowStream``).  Whole 34-word rate
    blocks go to ``keccak_kernel.absorb_rows`` as they complete, and fewer
    than 34 trailing words (a block, or a u32 pair, that straddles a chunk
    boundary) wait as pending columns, read beside the next chunk without a
    concatenated copy of it; ``finalize`` absorbs the last partial block.
    The digests equal ``hash_field_rows_batched`` of the whole rows."""

    def __init__(self, n_rows: int, device):
        # lane-major (50, N) int32 (keccak_kernel's state layout)
        self._state = torch.zeros((2 * WIDTH, n_rows), dtype=torch.int32, device=device)
        self._first = True
        self._pend: Optional[torch.Tensor] = None  # (N, < 34) words

    def absorb_cols(self, mat_u32: torch.Tensor) -> None:
        p = 0 if self._pend is None else int(self._pend.shape[1])
        k = int(mat_u32.shape[1])
        blocks = (p + k) // keccak_kernel.BLOCK_WORDS
        take = blocks * keccak_kernel.BLOCK_WORDS - p
        if blocks == 0:  # no block completes: the words wait
            self._pend = mat_u32 if self._pend is None else torch.cat([self._pend, mat_u32], dim=1)
            return
        keccak_kernel.absorb_rows(self._state, mat_u32[:, :take], first=self._first, pend=self._pend)
        self._first = False
        self._pend = mat_u32[:, take:].contiguous() if take < k else None

    def finalize(self) -> torch.Tensor:
        """(N, 4, 2) digests."""
        out = keccak_kernel.finalize_rows(self._state, self._pend, first=self._first)
        self._pend = None
        return out