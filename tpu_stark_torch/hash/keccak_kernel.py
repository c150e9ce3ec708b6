"""K1: the batched Keccak sponge (Merkle leaf and compress layers).

``hash_rows(a, b)`` computes PaddingFreeSponge<Keccak-f[1600], 25, 17, 4>
over each row of ``a`` (N, ka) followed by the same row of ``b`` (N, kb),
as the JAX package's ``sponge.hash_field_rows_batched`` does over one
concatenated (N, ka + kb) u32 matrix: u32 pairs form little-endian u64
items, each rate-17 chunk overwrites the front of the state, and the
permutation runs after every chunk.  Out: (N, 4, 2) int32 = 4 u64 words as
[lo, hi] (the same bits as JAX's uint32 digests).

Replaces ``tpu_stark/hash/pallas_keccak.py::_sponge_kernel`` (wrappers
``hash_field_rows`` and ``compress_digests``).  On the H100 the kernel
(``csrc/keccak_sponge.cu``) is integer-ALU bound: one thread per row holds
the 25 lanes as native 64-bit registers and runs 24 fully unrolled rounds per
chunk.  It takes any N (no tile padding, which the Pallas kernel needed) and
any width, and compress reads left and right directly, with no concatenated
copy.

``hash_rows_plain`` is the plain torch version: int64 lanes, vectorized
over rows.  The wrapper runs it only for CPU tensors; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from .keccak import ROT, ROUND_CONSTANTS

RATE = 17
WIDTH = 25
OUT = 4

# rho + pi as a gather: destination lane j takes source lane _SRC[j],
# rotated left by _ROTJ[j]
_SRC = np.zeros(25, dtype=np.int64)
_ROTJ = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _j = _y + 5 * ((2 * _x + 3 * _y) % 5)
        _SRC[_j] = _x + 5 * _y
        _ROTJ[_j] = ROT[_x + 5 * _y]
_RC_SIGNED = [rc - (1 << 64) if rc >= 1 << 63 else rc for rc in ROUND_CONSTANTS]


_X_MINUS_1 = [4, 0, 1, 2, 3]
_X_PLUS_1 = [1, 2, 3, 4, 0]
_X_PLUS_2 = [2, 3, 4, 0, 1]


def keccak_f_plain(a: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] over an (N, 25) int64 lane tensor (lane x + 5y).
    Rotations shift left and mask the arithmetic right shift back to a
    logical one."""
    dev = a.device
    src = torch.from_numpy(_SRC).to(dev)
    rot = torch.from_numpy(_ROTJ).to(dev)
    rs = rot.clamp(min=1)
    mask = torch.tensor([(1 << int(r)) - 1 for r in rs], device=dev)
    xm1, xp1, xp2 = (torch.tensor(i, device=dev) for i in (_X_MINUS_1, _X_PLUS_1, _X_PLUS_2))
    n = a.shape[0]
    for rc in _RC_SIGNED:
        g = a.view(n, 5, 5)  # [y][x]
        c = g[:, 0] ^ g[:, 1] ^ g[:, 2] ^ g[:, 3] ^ g[:, 4]
        cp = c[:, xp1]
        d = c[:, xm1] ^ ((cp << 1) | ((cp >> 63) & 1))
        b = (g ^ d[:, None, :]).view(n, 25)[:, src]
        b = torch.where(rot == 0, b, (b << rs) | ((b >> (64 - rs)) & mask)).view(n, 5, 5)
        a = (b ^ (~b[:, :, xp1] & b[:, :, xp2])).view(n, 25)
        a[:, 0] ^= rc
    return a


def _items(row_u32: torch.Tensor) -> torch.Tensor:
    """(N, k) int32 u32 bits -> (N, ceil(k/2)) int64 items lo | hi << 32."""
    n, k = row_u32.shape
    if k % 2:
        row_u32 = torch.cat(
            [row_u32, torch.zeros((n, 1), dtype=torch.int32, device=row_u32.device)], 1
        )
    pairs = row_u32.to(torch.int64).view(n, -1, 2)
    return (pairs[..., 1] << 32) | (pairs[..., 0] & 0xFFFFFFFF)


def _digest_words(st: torch.Tensor) -> torch.Tensor:
    """(N, >=4) int64 lanes -> (N, 4, 2) int32 [lo, hi] of the first 4."""
    w = st[:, :OUT]
    lo = ((w & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    hi = w >> 32
    return torch.stack([lo, hi], dim=-1).to(torch.int32)


def hash_rows_plain(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    rows = a if b is None else torch.cat([a, b], dim=1)
    if rows.shape[1] == 0:
        raise ValueError("empty sponge input")
    items = _items(rows)
    n, n_items = items.shape
    st = torch.zeros((n, WIDTH), dtype=torch.int64, device=rows.device)
    for off in range(0, n_items, RATE):
        chunk = items[:, off : off + RATE]
        st[:, : chunk.shape[1]] = chunk
        st = keccak_f_plain(st)
    return _digest_words(st)


def hash_rows(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, ka) [+ (N, kb)] int32 rows -> (N, 4, 2) int32 digests."""
    if a.device.type == "cpu":
        return hash_rows_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"keccak sponge: unsupported device {a.device}")
    n, ka = a.shape
    kb = 0 if b is None else int(b.shape[1])
    if a.dtype != torch.int32 or (b is not None and b.dtype != torch.int32):
        raise TypeError("keccak sponge takes int32 (u32-bit) rows")
    if b is not None and (b.device != a.device or b.shape[0] != n):
        raise ValueError("keccak sponge: left and right rows disagree")
    if ka + kb == 0:
        raise ValueError("empty sponge input")
    a = a.contiguous()
    b = None if b is None else b.contiguous()
    out = torch.empty((n, OUT, 2), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    so = kernels.lib()
    kernels.KECCAK_SPONGE.launches += 1
    kernels.check(
        so.ts_keccak_rows(
            a.data_ptr(), ka, None if b is None else b.data_ptr(), kb, n,
            out.data_ptr(), kernels.stream_handle(a.device),
        ),
        "keccak sponge",
    )
    return out
