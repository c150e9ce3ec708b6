"""Batched two-adic NTTs over BabyBear (counterpart of
``tpu_stark/ntt/radix2.py``).

Layout: (h, w) int32 Monty matrices, rows = domain points in natural order
in and out, columns = independent polynomials.  The transforms run on
kernel K2 (``ntt_kernel.dft``); the inverse's h^-1 scale and the coset
scale are plain torch.

``narrow="mxu"`` routes tall narrow matrices (w <= NARROW_MAX_W, h >=
2^NARROW_MIN_LOG_H: the JAX package's gates, ``tpu_stark/backend/policy.py``
and ``radix2.py::_narrow_mode``) through the 4-step limb-matmul NTT of
``mxu_ntt`` (kernel K5) instead; every other shape stays on K2.  The
default, ``None``, is K2 everywhere.  The JAX package picks its route from
``TPU_STARK_NTT_NARROW``; the port takes it as an argument.  Its ``"vpu4"``
four-step and transposed detours are TPU lane and compiler workarounds and
have no counterpart here.
"""

from __future__ import annotations

import torch

from ..fields import babybear as bb
from ..matrix import log2_strict
from . import mxu_ntt, ntt_kernel

NARROW_ROUTES = (None, "mxu")
NARROW_MAX_W = 32
NARROW_MIN_LOG_H = 16


def _mxu(mat: torch.Tensor, narrow) -> bool:
    """Whether ``narrow`` sends this matrix to the limb-matmul NTT."""
    h, w = mat.shape
    return narrow == "mxu" and 0 < w <= NARROW_MAX_W and h >= 1 << NARROW_MIN_LOG_H


def dft_batch(mat: torch.Tensor, narrow=None) -> torch.Tensor:
    """NTT of each column: out[i] = sum_j mat[j] * g^(i*j)."""
    if _mxu(mat, narrow):
        return mxu_ntt.dft_batch(mat)
    return ntt_kernel.dft(mat, inverse=False)


def idft_batch(mat: torch.Tensor, narrow=None) -> torch.Tensor:
    """Inverse NTT: forward with g^-1 twiddles, scaled by h^-1."""
    h = int(mat.shape[0])
    if log2_strict(h) == 0:
        return mat.clone()
    if _mxu(mat, narrow):
        return mxu_ntt.idft_batch(mat)
    out = ntt_kernel.dft(mat, inverse=True)
    return bb.mul_canonical(out, pow(h, bb.P - 2, bb.P))


def _coset_scale(coeffs: torch.Tensor, shift: int) -> torch.Tensor:
    """coeffs[i] *= shift^i."""
    pows = bb.powers(shift, int(coeffs.shape[0]), coeffs.device)
    return bb.mul_canonical(coeffs, pows[:, None])


def coset_dft_batch(mat: torch.Tensor, shift: int, narrow=None) -> torch.Tensor:
    return dft_batch(_coset_scale(mat, shift), narrow)


def coset_idft_batch(mat: torch.Tensor, shift: int, narrow=None) -> torch.Tensor:
    return _coset_scale(idft_batch(mat, narrow), pow(shift, bb.P - 2, bb.P))


def coset_lde_batch(mat: torch.Tensor, added_bits: int, shift: int = 1, narrow=None) -> torch.Tensor:
    """Low-degree extend each column onto the coset shift*<g'> of size
    h << added_bits: iNTT, coset scale, zero-pad, NTT."""
    h, w = mat.shape
    padded = torch.zeros((h << added_bits, w), dtype=bb.I32, device=mat.device)
    padded[:h] = idft_batch(mat, narrow)
    return coset_dft_batch(padded, shift, narrow)


def lde_batch(mat: torch.Tensor, added_bits: int, narrow=None) -> torch.Tensor:
    return coset_lde_batch(mat, added_bits, 1, narrow)
