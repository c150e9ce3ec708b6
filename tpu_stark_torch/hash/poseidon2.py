"""Poseidon2 permutation over BabyBear, widths 16 and 24 (counterpart of
``tpu_stark/hash/poseidon2.py``, re-homed without jax).

Instance (the p3 / HorizenLabs shape):

* S-box x^7.
* External rounds R_F = 8 (4 before and 4 after the internal ones), each
  ``rc + sbox`` on every lane then the MDS M_E = circ(2*M4, M4, ..., M4),
  M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by the paper's add chain;
  M_E also runs once before the first round.
* Internal rounds R_P (13 for t=16, 21 for t=24): ``rc + sbox`` on lane 0,
  then M_I(x) = sum(x) + diag_i * x_i.
* Round constants from the Grain LFSR of the Poseidon reference scripts.

``permute_host`` (canonical Python ints) is the transcript's and the
verifier's permutation, through the port's C host helper for width 16.
``permute_plain`` is the batched plain torch version over (..., width)
Monty int32 tensors: the same round order as the JAX package's
``permute_batched``.  Every internal-diagonal entry is multiplied as a full
Montgomery product by its Monty constant, which gives the same bits as the
JAX package's shift-and-add multipliers.  Kernel K3 (``poseidon2_kernel``)
runs the same permutation on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import numpy as np
import torch

from ..compat.native import p2_permute16_native

from ..fields import babybear as bb

ROUNDS_F = 8


def rounds_p(width: int) -> int:
    return {16: 13, 24: 21}[width]


# ---------------------------------------------------------------------------
# Grain LFSR round constants (Poseidon reference algorithm).
# ---------------------------------------------------------------------------
def _grain_bits(field: int, sbox: int, n: int, t: int, r_f: int, r_p: int):
    bits: List[int] = []

    def push(val: int, width: int):
        for i in reversed(range(width)):
            bits.append((val >> i) & 1)

    push(field, 2)
    push(sbox, 4)
    push(n, 12)
    push(t, 12)
    push(r_f, 10)
    push(r_p, 10)
    bits.extend([1] * 30)
    state = bits[:]

    def step() -> int:
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        step()
    while True:
        if step() == 1:
            yield step()
        else:
            step()


@functools.lru_cache(maxsize=None)
def round_constants(width: int) -> tuple:
    """(external: (8, width), internal: (R_P,)) canonical ints."""
    gen = _grain_bits(1, 0, 31, width, ROUNDS_F, rounds_p(width))

    def next_elem() -> int:
        while True:
            v = 0
            for _ in range(31):
                v = (v << 1) | next(gen)
            if v < bb.P:
                return v

    ext = [[next_elem() for _ in range(width)] for _ in range(ROUNDS_F)]
    internal = [next_elem() for _ in range(rounds_p(width))]
    return tuple(tuple(r) for r in ext), tuple(internal)


def internal_diag(width: int) -> List[int]:
    """The internal diagonal (p3's power-of-two entries), canonical."""
    inv = lambda x: pow(x, bb.P - 2, bb.P)  # noqa: E731
    if width == 16:
        vals = [
            -2, 1, 2, inv(2), 3, 4, -inv(2), -3, -4,
            inv(1 << 8), inv(4), inv(8), inv(1 << 27),
            -inv(1 << 8), -inv(16), -inv(1 << 27),
        ]
    elif width == 24:
        vals = [
            -2, 1, 2, inv(2), 3, 4, -inv(2), -3, -4,
            inv(1 << 8), inv(4), inv(8), inv(16), inv(32), inv(64),
            inv(1 << 27), -inv(1 << 8), -inv(4), -inv(8), -inv(16),
            -inv(32), -inv(64), -inv(1 << 27), -inv(1 << 9),
        ]
    else:
        raise ValueError(f"unsupported width {width}")
    return [v % bb.P for v in vals]


@functools.lru_cache(maxsize=None)
def consts_monty(width: int):
    """(external (8, w), internal (R_P,), diag (w,)) Monty uint32 arrays."""
    ext_rc, int_rc = round_constants(width)
    return (
        bb.np_to_monty(np.array(ext_rc, dtype=np.uint32)),
        bb.np_to_monty(np.array(int_rc, dtype=np.uint32)),
        bb.np_to_monty(np.array(internal_diag(width), dtype=np.uint32)),
    )


# ---------------------------------------------------------------------------
# Host permutation (canonical ints).
# ---------------------------------------------------------------------------
def _sbox_host(x: int) -> int:
    return pow(x, 7, bb.P)


def _m4_host(b: List[int]) -> List[int]:
    x0, x1, x2, x3 = b
    t0 = (x0 + x1) % bb.P
    t1 = (x2 + x3) % bb.P
    t2 = (2 * x1 + t1) % bb.P
    t3 = (2 * x3 + t0) % bb.P
    t4 = (4 * t1 + t3) % bb.P
    t5 = (4 * t0 + t2) % bb.P
    return [(t3 + t5) % bb.P, t5, (t2 + t4) % bb.P, t4]


def _external_mds_host(state: List[int]) -> List[int]:
    blocks = [_m4_host(state[i : i + 4]) for i in range(0, len(state), 4)]
    sums = [sum(blk[j] for blk in blocks) % bb.P for j in range(4)]
    return [(blk[j] + sums[j]) % bb.P for blk in blocks for j in range(4)]


@functools.lru_cache(maxsize=None)
def native_consts16():
    """ctypes constant arrays for the C host permutation (canonical)."""
    ext_rc, int_rc = round_constants(16)
    flat = [c for row in ext_rc for c in row]
    return (
        (ctypes.c_uint32 * len(flat))(*flat),
        (ctypes.c_uint32 * len(int_rc))(*int_rc),
        (ctypes.c_uint32 * 16)(*internal_diag(16)),
    )


def permute_host(state: Sequence[int]) -> List[int]:
    """Poseidon2 over a canonical-int state; width 16 through the C helper
    when it is built (the same bits; the Python rounds are the fallback)."""
    w = len(state)
    if w == 16:
        out = p2_permute16_native(state, *native_consts16())
        if out is not None:
            return out
    ext_rc, int_rc = round_constants(w)
    diag = internal_diag(w)
    s = _external_mds_host([int(x) % bb.P for x in state])
    half = ROUNDS_F // 2
    for r in range(half):
        s = _external_mds_host([_sbox_host((x + c) % bb.P) for x, c in zip(s, ext_rc[r])])
    for r in range(rounds_p(w)):
        s[0] = _sbox_host((s[0] + int_rc[r]) % bb.P)
        tot = sum(s) % bb.P
        s = [(tot + d * x) % bb.P for x, d in zip(s, diag)]
    for r in range(half, ROUNDS_F):
        s = _external_mds_host([_sbox_host((x + c) % bb.P) for x, c in zip(s, ext_rc[r])])
    return s


# ---------------------------------------------------------------------------
# Plain batched permutation: (..., width) Monty int32 tensors.
# ---------------------------------------------------------------------------
def _sbox(x: torch.Tensor) -> torch.Tensor:
    x2 = bb.mul(x, x)
    x4 = bb.mul(x2, x2)
    return bb.mul(bb.mul(x4, x2), x)


def _dbl(x):
    return bb.add(x, x)


def external_mds_plain(s: torch.Tensor) -> torch.Tensor:
    """M_E on (..., w) Monty: the M4 add chain per block of 4 lanes, then
    each lane plus the sum of its position over all blocks."""
    shape = s.shape
    x0, x1, x2, x3 = s.reshape(shape[:-1] + (shape[-1] // 4, 4)).unbind(-1)
    t0 = bb.add(x0, x1)
    t1 = bb.add(x2, x3)
    t2 = bb.add(_dbl(x1), t1)
    t3 = bb.add(_dbl(x3), t0)
    t4 = bb.add(_dbl(_dbl(t1)), t3)
    t5 = bb.add(_dbl(_dbl(t0)), t2)
    blocks = torch.stack([bb.add(t3, t5), t5, bb.add(t2, t4), t4], dim=-1)
    sums = bb.sum_mod(blocks, axis=-2)
    return bb.add(blocks, sums.unsqueeze(-2)).reshape(shape)


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 over (..., 16|24) Monty int32 lanes, batched on the leading
    axes (int64 products)."""
    w = int(state.shape[-1])
    ext_np, int_np, diag_np = consts_monty(w)
    ext_rc = bb.to_tensor(ext_np, state.device)
    int_rc = [int(c) for c in int_np]
    diag = bb.to_tensor(diag_np, state.device)
    half = ROUNDS_F // 2
    s = external_mds_plain(state)
    for r in range(half):
        s = external_mds_plain(_sbox(bb.add(s, ext_rc[r])))
    for r in range(rounds_p(w)):
        lane0 = _sbox(bb.add(s[..., :1], int_rc[r]))
        s = torch.cat([lane0, s[..., 1:]], dim=-1)
        s = bb.add(bb.mul(s, diag), bb.sum_mod(s, axis=-1).unsqueeze(-1))
    for r in range(half, ROUNDS_F):
        s = external_mds_plain(_sbox(bb.add(s, ext_rc[r])))
    return s
