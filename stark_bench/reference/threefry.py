"""The zk randomness, written from its definition: Threefry-2x32 with 20
rounds (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC
2011), keyed and drawn as ``jax.random`` does with partitionable Threefry:

* a seed s is the key (s >> 32, s mod 2^32); fold_in(k, d) is
  threefry(k, (0, d)); split(k) is (threefry(k, (0, 0)), threefry(k, (0, 1)));
* the 32-bit draw at the row-major flat index i of a sample is the xor of
  the two words of threefry(k, (i >> 32, i mod 2^32)).

A stream ``(seed, tag)`` has the key fold_in(key(seed mod 2^32), crc32(tag))
and its c-th sample call the key fold_in(stream key, c).  An element of a
sample is the Montgomery form (hi 2^32 + lo) mod p, hi drawn under split's
first key and lo under its second; its value is that form times 2^-32.
Plain torch over int64 lanes masked to 32 bits."""

from __future__ import annotations

import zlib
from typing import Tuple

import torch

from .field import P, R_INV

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
DRAW_ELEMS = 1 << 24  # elements a draw computes at once

Key = Tuple[int, int]


def threefry(key: Key, x0, x1):
    """Threefry-2x32 of the counter pairs (x0, x1): Python ints or int64
    tensors of u32 values."""
    ks = (key[0] & M32, key[1] & M32, (key[0] ^ key[1] ^ PARITY) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def fold_in(k: Key, d: int) -> Key:
    return threefry(k, 0, d & M32)


def stream_key(seed: int, tag: str) -> Key:
    return fold_in((0, seed & M32), zlib.crc32(tag.encode()))


def sample_key(seed: int, tag: str, call: int) -> Key:
    """The key of the stream's ``call``-th sample."""
    return fold_in(stream_key(seed, tag), call)


def values_at(k: Key, flat: torch.Tensor) -> torch.Tensor:
    """The field values (canonical int64) of the sample under ``k`` at the
    flat indices ``flat``, in blocks of ``DRAW_ELEMS``."""
    k_hi, k_lo = threefry(k, 0, 0), threefry(k, 0, 1)
    flat = flat.reshape(-1)
    out = torch.empty_like(flat)
    for i0 in range(0, int(flat.numel()), DRAW_ELEMS):
        i = flat[i0 : i0 + DRAW_ELEMS]
        hi = _draw(k_hi, i)
        lo = _draw(k_lo, i)
        out[i0 : i0 + DRAW_ELEMS] = (hi * ((1 << 32) % P) + lo) % P * R_INV % P
    return out


def _draw(k: Key, i: torch.Tensor) -> torch.Tensor:
    b0, b1 = threefry(k, i >> 32, i & M32)
    return b0 ^ b1


def matrix(k: Key, rows: int, cols: int, device) -> torch.Tensor:
    """The whole (rows, cols) sample under ``k``."""
    flat = torch.arange(rows * cols, dtype=torch.int64, device=device)
    return values_at(k, flat).view(rows, cols)


def rows_of(k: Key, cols: int, rows: torch.Tensor) -> torch.Tensor:
    """The rows ``rows`` of a sample of ``cols`` columns under ``k``."""
    flat = rows[:, None] * cols + torch.arange(cols, dtype=torch.int64, device=rows.device)
    return values_at(k, flat).view(-1, cols)
