"""Counter-based zk hiding randomness on the device (counterpart of
``tpu_stark/compat/device_rng.py``): salts, random codewords and the trace
randomizer, made where they are used, with no host round trip.

The stream is JAX's Threefry-2x32 as ``jax.random`` runs it with
``jax_threefry_partitionable`` on, reproduced bit for bit in plain torch
(int64 lanes masked to 32 bits), so the port's default-config proofs equal
the JAX package's:

* ``key(seed)`` is the pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``, the output pair being
  the new key;
* ``split(k)`` gives ``threefry2x32(k, (0, 0))`` and ``threefry2x32(k, (0, 1))``;
* ``bits(k, shape)`` hashes the row-major flat index i as the pair
  ``(i >> 32, i & 0xFFFFFFFF)`` and returns the xor of the two output words.

``DeviceRng(seed, stream)`` folds in ``crc32(stream)`` (when ``stream`` is
not empty) and then one call counter per sample, as JAX does.  A sample is
the Monty value ``(hi * 2^32 + lo) mod p`` of two 32-bit draws.  Threefry
is XLA, not Pallas, in the JAX package: here it is plain torch elementwise
work on the sample's device.
"""

from __future__ import annotations

import zlib
from typing import Tuple

import torch

from ..fields import babybear as bb

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TWO32_MOD_P = (1 << 32) % bb.P

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under ``key``.
    ``x0`` and ``x1`` are u32 values as Python ints or int64 tensors;
    returns the two output words in the same form."""
    ks = (key[0] & _M32, key[1] & _M32, (key[0] ^ key[1] ^ _PARITY) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> Key:
    return (seed >> 32) & _M32, seed & _M32


def fold_in(k: Key, data: int) -> Key:
    return threefry2x32(k, 0, data & _M32)


def split(k: Key) -> Tuple[Key, Key]:
    return threefry2x32(k, 0, 0), threefry2x32(k, 0, 1)


def random_bits(k: Key, rows: int, cols: int, device) -> torch.Tensor:
    """``jax.random.bits(k, (rows, cols), uint32)`` as int64 u32 values."""
    i = torch.arange(rows * cols, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k, i >> 32, i & _M32)
    return (b0 ^ b1).view(rows, cols)


def _sample_monty(k: Key, rows: int, cols: int, device) -> torch.Tensor:
    """(rows, cols) int32 Monty residues (hi * 2^32 + lo) mod p, from two
    draws under the two halves of ``split(k)``."""
    k_hi, k_lo = split(k)
    hi = random_bits(k_hi, rows, cols, device)
    lo = random_bits(k_lo, rows, cols, device)
    return ((hi * _TWO32_MOD_P + lo) % bb.P).to(torch.int32)


class DeviceRng:
    """A call counter over a fixed Threefry key: one ``fold_in`` per sample
    call, as the persistent host rng advances across commits."""

    def __init__(self, seed: int, stream: str = "", device="cuda"):
        self.device = torch.device(device)
        self._key = key(seed & _M32)
        if stream:
            # domain separation between the salt, codeword and trace streams
            self._key = fold_in(self._key, zlib.crc32(stream.encode()))
        self._counter = 0

    @classmethod
    def from_state(cls, key_words: Key, counter: int, device="cuda") -> "DeviceRng":
        """The stream whose (folded) key is ``key_words`` and whose next
        sample call is number ``counter``."""
        rng = cls(0, "", device)
        rng._key = (int(key_words[0]) & _M32, int(key_words[1]) & _M32)
        rng._counter = int(counter)
        return rng

    def sample_babybear_matrix_monty(self, rows: int, cols: int) -> torch.Tensor:
        k = fold_in(self._key, self._counter)
        self._counter += 1
        return _sample_monty(k, rows, cols, self.device)
