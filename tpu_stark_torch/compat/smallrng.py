"""Bit-exact reimplementation of rand 0.9's ``SmallRng`` (64-bit platforms:
Xoshiro256++ with SplitMix64 ``seed_from_u64``); counterpart of
``tpu_stark/compat/smallrng.py``, with bulk sampling through the jax-free C
helper ``tpu_stark.compat.native``.

The reference seeds ``SmallRng::seed_from_u64(1)`` for all hiding randomness —
Merkle leaf salts and the HidingPcs random codewords.  Proof parity demands
the identical stream, so this follows the published
xoshiro256plusplus / splitmix64 reference algorithms exactly.

BabyBear sampling follows p3-monty-31's ``StandardUniform``: draw
``next_u32() >> 1`` (31 bits), reject until < p, interpret the accepted value
as the **Montgomery residue** directly.
"""

from __future__ import annotations

from typing import List

import numpy as np

from tpu_stark.compat import native

from ..fields import babybear as bb

_U64 = (1 << 64) - 1


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _U64


class SmallRng:
    """Xoshiro256++ matching rand 0.9 SmallRng on 64-bit targets."""

    def __init__(self, state: List[int]):
        assert len(state) == 4
        self.s = [x & _U64 for x in state]

    @classmethod
    def seed_from_u64(cls, seed: int) -> "SmallRng":
        # SplitMix64 expansion (rand's xoshiro256plusplus::seed_from_u64).
        state = []
        x = seed & _U64
        for _ in range(4):
            x = (x + 0x9E3779B97F4A7C15) & _U64
            z = x
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
            state.append(z ^ (z >> 31))
        return cls(state)

    def next_u64(self) -> int:
        s = self.s
        result = (_rotl((s[0] + s[3]) & _U64, 23) + s[0]) & _U64
        t = (s[1] << 17) & _U64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = _rotl(s[3], 45)
        return result

    def next_u32(self) -> int:
        # rand's Xoshiro256PlusPlus::next_u32 takes the HIGH word.
        return self.next_u64() >> 32

    # -- field sampling (p3 StandardUniform for MontyField31) --------------
    def sample_babybear_monty(self) -> int:
        while True:
            v = self.next_u32() >> 1
            if v < bb.P:
                return v

    def sample_babybear_matrix_monty(self, rows: int, cols: int) -> np.ndarray:
        """Row-major (rows, cols) Monty-form uint32 salt/codeword matrix.

        Uses the native C sampler when available (bit-identical stream; the
        python loop is the fallback and the differential oracle)."""
        n = rows * cols
        out = self._native_fill(n)
        if out is None:
            out = np.empty(n, dtype=np.uint32)
            for i in range(n):
                out[i] = self.sample_babybear_monty()
        return out.reshape(rows, cols)

    def _native_fill(self, n: int):
        import ctypes

        lib = native.get_lib()
        if lib is None:
            return None
        state = (ctypes.c_uint64 * 4)(*self.s)
        out = np.empty(n, dtype=np.uint32)
        lib.ts_xoshiro_fill_babybear(
            state, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n
        )
        self.s = [int(state[i]) for i in range(4)]
        return out
