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
    matrix that arrives in column chunks (counterpart of
    ``tpu_stark/hash/sponge.py::KeccakRowStream``).  Each chunk goes to one
    launch of ``keccak_kernel.absorb_rows``, which absorbs the whole 34-word
    rate blocks of the pending words and the chunk and writes the words
    after them (fewer than 34: a block, or a u32 pair, that straddles a
    chunk boundary) as the next pending words, canonical and in the tree's
    order.  A chunk that completes no block waits, unread, for the next
    launch; ``finalize`` absorbs the last partial block.  The digests equal
    ``hash_field_rows_batched`` of the whole canonical rows in the tree's
    order."""

    def __init__(self, n_rows: int, device):
        # lane-major (50, N) int32 (keccak_kernel's state layout)
        self._state = torch.zeros((2 * WIDTH, n_rows), dtype=torch.int32, device=device)
        self._first = True
        self._pend: Optional[torch.Tensor] = None  # (N, < 34) canonical words
        self._tail: Optional[Tuple[torch.Tensor, bool, bool]] = None  # a chunk that completes no block

    def absorb_cols(self, mat_u32: torch.Tensor) -> None:
        """Canonical u32 columns, rows in the tree's order (JAX's meaning)."""
        self._absorb(mat_u32, False, False)

    def absorb_monty(self, mat: torch.Tensor, natural: bool) -> None:
        """Columns of Montgomery forms: a codeword chunk as K2 leaves it
        (``natural``: the tree's row r is its row bitrev(r)) or rows already
        in the tree's order (a rank block, the salts).  The kernel converts
        and reorders them as it reads them: no copy."""
        self._absorb(mat, True, natural)

    def _absorb(self, mat: torch.Tensor, monty: bool, natural: bool) -> None:
        if self._tail is not None:  # two chunks in a row complete no block: the first joins the pending words
            self._pend = keccak_kernel.absorb_rows(self._state, self._tail[0], self._first, self._pend,
                                                   *self._tail[1:])
            self._tail = None
        p = 0 if self._pend is None else int(self._pend.shape[1])
        if p + int(mat.shape[1]) < keccak_kernel.BLOCK_WORDS:
            self._tail = (mat, monty, natural)
            return
        self._pend = keccak_kernel.absorb_rows(self._state, mat, self._first, self._pend, monty, natural)
        self._first = False

    def finalize(self) -> torch.Tensor:
        """(N, 4, 2) digests."""
        mat, monty, natural = self._tail or (None, False, False)
        out = keccak_kernel.finalize_rows(self._state, self._pend, self._first, mat, monty, natural)
        self._pend = self._tail = None
        return out
