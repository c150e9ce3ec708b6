"""Keccak-f[1600] and Keccak-256 on the host (counterpart of the host part
of ``tpu_stark/hash/keccak.py``).

Keccak-256 here is the original Keccak padding (0x01), as in tiny-keccak /
p3, not NIST SHA3 (0x06).  The bulk implementation is the jax-free C helper
``tpu_stark.compat.native``; the Python code is its oracle and fallback.
The batched device permutation lives in ``keccak_kernel.py``.
"""

from __future__ import annotations

from typing import List, Sequence

from tpu_stark.compat.native import keccak256_native

U64 = (1 << 64) - 1

ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offset for lane (x, y) at flat index x + 5*y.
ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rotl64(v: int, r: int) -> int:
    r %= 64
    return ((v << r) | (v >> (64 - r))) & U64


def keccak_f(state: Sequence[int], n_rounds: int = 24) -> List[int]:
    """One Keccak-f[1600] permutation over 25 u64 lanes (flat x + 5y);
    ``n_rounds`` < 24 only as a test oracle."""
    a = list(state)
    for rc in ROUND_CONSTANTS[:n_rounds]:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(a[x + 5 * y], ROT[x + 5 * y])
        a = [
            b[i] ^ ((~b[(i // 5) * 5 + (i + 1) % 5]) & U64 & b[(i // 5) * 5 + (i + 2) % 5])
            for i in range(25)
        ]
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (0x01 padding), rate 136 bytes, 32-byte digest."""
    native = keccak256_native(data)
    if native is not None:
        return native
    return _keccak256_py(data)


def _keccak256_py(data: bytes) -> bytes:
    rate = 136
    state = [0] * 25
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))
