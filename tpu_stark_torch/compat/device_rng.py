"""Counter-based zk hiding randomness on the device (counterpart of
``tpu_stark/compat/device_rng.py``): salts, random codewords and the trace
randomizer, made where they are used, with no host round trip.

The stream is JAX's Threefry-2x32 as ``jax.random`` runs it with
``jax_threefry_partitionable`` on, reproduced bit for bit, so the port's
default-config proofs equal the JAX package's:

* ``key(seed)`` is the pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``, the output pair being
  the new key;
* ``split(k)`` gives ``threefry2x32(k, (0, 0))`` and ``threefry2x32(k, (0, 1))``;
* ``bits(k, shape)`` hashes the row-major flat index i as the pair
  ``(i >> 32, i & 0xFFFFFFFF)`` and returns the xor of the two output words.

``DeviceRng(seed, stream)`` folds in ``crc32(stream)`` (when ``stream`` is
not empty) and then one call counter per sample, as JAX does.
``sample_lazy`` advances the counter but returns a ``LazyMatrix``, the
sample's key and shape, which regenerates the same values on demand, the
whole matrix or only some of its rows (a hiding commit keeps it instead of
the salts, and its openings draw the opened rows alone).  A sample is
the Monty value ``(hi * 2^32 + lo) mod p`` of two 32-bit draws.

The key arithmetic (``key``, ``fold_in``, ``split``) is Python-int work on
the host.  A sample on the card is one launch of kernel K6
(``csrc/threefry.cu``, ``_monty_kernel``), which computes each element
from its flat index in registers; the JAX package runs the same function
as an XLA program (its ``_sample_monty``), no Pallas kernel.  On the CPU a
sample is the plain version: ``threefry2x32`` on int64 lanes masked to 32
bits (``_monty_at``), in row blocks of ``_DRAW_ELEMS`` elements.
``random_bits`` is the plain draw alone, for the tests.
"""

from __future__ import annotations

import zlib
from typing import Tuple

import torch

from .. import kernels
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


def _flat_index(rows: int, cols: int, sel, device) -> torch.Tensor:
    """Row-major flat indices of the (rows, cols) matrix's columns ``sel``
    (all of them when ``sel`` is None), as a (rows, len(sel)) int64 tensor."""
    if sel is None:
        return torch.arange(rows * cols, dtype=torch.int64, device=device).view(rows, cols)
    sel = torch.as_tensor(sel, dtype=torch.int64, device=device)
    return torch.arange(rows, dtype=torch.int64, device=device)[:, None] * cols + sel[None, :]


def _bits_at(k: Key, i: torch.Tensor) -> torch.Tensor:
    """The u32 values (int64) that ``jax.random.bits`` draws under ``k`` at
    the flat indices ``i``: each value hashes its own index."""
    b0, b1 = threefry2x32(k, i >> 32, i & _M32)
    return b0 ^ b1


def random_bits(k: Key, rows: int, cols: int, device, sel=None) -> torch.Tensor:
    """``jax.random.bits(k, (rows, cols), uint32)`` as int64 u32 values, or
    only its columns ``sel``: each value hashes its own flat index, so a
    column costs the same whether the others are drawn or not."""
    return _bits_at(k, _flat_index(rows, cols, sel, device))


def _monty_at(k: Key, i: torch.Tensor) -> torch.Tensor:
    """int32 Monty residues (hi * 2^32 + lo) mod p at the flat indices
    ``i``, from two draws under the two halves of ``split(k)``."""
    k_hi, k_lo = split(k)
    return ((_bits_at(k_hi, i) * _TWO32_MOD_P + _bits_at(k_lo, i)) % bb.P).to(torch.int32)


# a plain draw runs in row blocks of at most this many elements: the plain
# Threefry holds about eight int64 temporaries of a block's size at once
_DRAW_ELEMS = 1 << 24


def _monty_kernel(k: Key, rows: int, cols: int, device, sel=None, row0: int = 0, row_idx=None) -> torch.Tensor:
    """K6: the (rows, len(sel) or cols) int32 Monty values of the sample
    under ``k`` of ``cols`` columns at its rows [row0, row0 + rows) (or the
    rows row0 + ``row_idx``, repeats allowed) and its columns ``sel`` (or
    all), in one launch on the CUDA ``device``.  A failed build or launch
    raises."""
    so = kernels.lib()  # builds the library (or raises) before any CUDA allocation
    device = torch.device(device)
    k_hi, k_lo = split(k)
    sel_t = None if sel is None else torch.as_tensor(sel, dtype=torch.int64).to(device).contiguous()
    idx_t = None if row_idx is None else torch.as_tensor(row_idx, dtype=torch.int64).to(device).contiguous()
    n_rows = rows if idx_t is None else int(idx_t.shape[0])
    n_out = cols if sel_t is None else int(sel_t.shape[0])
    out = torch.empty((n_rows, n_out), dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out
    kernels.THREEFRY_MONTY.launches += 1
    kernels.check(
        so.ts_threefry_monty(
            k_hi[0], k_hi[1], k_lo[0], k_lo[1], cols, None if sel_t is None else sel_t.data_ptr(), n_out, row0,
            None if idx_t is None else idx_t.data_ptr(), n_rows, out.data_ptr(), kernels.stream_handle(device),
        ),
        "threefry monty",
    )
    return out


def _on_card(device) -> bool:
    """Whether a sample on ``device`` runs K6 (CUDA) or the plain version
    (the CPU); any other device raises."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device rng: unsupported device {device}")
    return kind == "cuda"


def _sample_monty(k: Key, rows: int, cols: int, device, sel=None, row0: int = 0) -> torch.Tensor:
    """(rows, cols) int32 Monty residues of the sample under ``k``; only the
    columns ``sel`` of that matrix when given; the rows [row0, row0 + rows)
    of a taller sample of ``cols`` columns when ``row0`` is given.  K6 on
    the card, the plain version on the CPU."""
    if _on_card(device):
        return _monty_kernel(k, rows, cols, device, sel=sel, row0=row0)
    idx = _flat_index(1, cols, sel, device)  # the first row's flat indices
    out = torch.empty((rows, int(idx.shape[1])), dtype=torch.int32, device=device)
    step = max(1, _DRAW_ELEMS // max(1, int(idx.shape[1])))
    for r0 in range(0, rows, step):
        r = torch.arange(row0 + r0, row0 + min(rows, r0 + step), dtype=torch.int64, device=device)
        out[r0 : r0 + step] = _monty_at(k, r[:, None] * cols + idx)
    return out


class LazyMatrix:
    """One sample call's key and shape: ``materialize()`` regenerates the
    sample's values, bit for bit, wherever and whenever they are needed.
    ``row0``: the matrix is the rows [row0, row0 + rows) of the sample (a
    mesh rank's block, ``block``)."""

    def __init__(self, k: Key, rows: int, cols: int, device, row0: int = 0):
        self._key = k
        self.shape = (rows, cols)
        self.device = torch.device(device)
        self.row0 = row0

    def materialize(self) -> torch.Tensor:
        return _sample_monty(self._key, *self.shape, self.device, row0=self.row0)

    def block(self, r0: int, rows: int) -> "LazyMatrix":
        """Rows [r0, r0 + rows) of this matrix, still deferred."""
        return LazyMatrix(self._key, rows, self.shape[1], self.device, self.row0 + r0)

    def rows(self, idx) -> torch.Tensor:
        """``materialize()[idx]``, bit for bit, drawing only those rows:
        (len(idx), cols) for any int64 row indices, repeats included."""
        cols = self.shape[1]
        if _on_card(self.device):
            return _monty_kernel(self._key, 0, cols, self.device, row0=self.row0, row_idx=idx)
        idx = torch.as_tensor(idx, dtype=torch.int64, device=self.device) + self.row0
        col_idx = torch.arange(cols, dtype=torch.int64, device=self.device)
        out = torch.empty((int(idx.shape[0]), cols), dtype=torch.int32, device=self.device)
        step = max(1, _DRAW_ELEMS // max(1, cols))  # row blocks, as in a whole draw
        for r0 in range(0, int(idx.shape[0]), step):
            out[r0 : r0 + step] = _monty_at(self._key, idx[r0 : r0 + step, None] * cols + col_idx)
        return out


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
        return self.sample_lazy(rows, cols).materialize()

    def sample_lazy(self, rows: int, cols: int) -> LazyMatrix:
        """Advance the counter as a sample does, and defer the values."""
        k = fold_in(self._key, self._counter)
        self._counter += 1
        return LazyMatrix(k, rows, cols, self.device)
