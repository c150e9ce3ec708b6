"""Batched two-adic NTTs over BabyBear (counterpart of
``tpu_stark/ntt/radix2.py``).

Layout: (h, w) int32 Monty matrices, rows = domain points in natural order
in and out, columns = independent polynomials.  The transforms run on
kernel K2 (``ntt_kernel.dft``); the inverse's h^-1 scale and the coset
scale are plain torch.  The JAX package's four-step detours and narrow-width
dispatch knobs are TPU compiler workarounds and have no counterpart here.
"""

from __future__ import annotations

import torch

from ..fields import babybear as bb
from ..matrix import log2_strict
from . import ntt_kernel


def dft_batch(mat: torch.Tensor) -> torch.Tensor:
    """NTT of each column: out[i] = sum_j mat[j] * g^(i*j)."""
    return ntt_kernel.dft(mat, inverse=False)


def idft_batch(mat: torch.Tensor) -> torch.Tensor:
    """Inverse NTT: forward with g^-1 twiddles, scaled by h^-1."""
    h = int(mat.shape[0])
    if log2_strict(h) == 0:
        return mat.clone()
    out = ntt_kernel.dft(mat, inverse=True)
    return bb.mul_canonical(out, pow(h, bb.P - 2, bb.P))


def _coset_scale(coeffs: torch.Tensor, shift: int) -> torch.Tensor:
    """coeffs[i] *= shift^i."""
    pows = bb.powers(shift, int(coeffs.shape[0]), coeffs.device)
    return bb.mul_canonical(coeffs, pows[:, None])


def coset_dft_batch(mat: torch.Tensor, shift: int) -> torch.Tensor:
    return dft_batch(_coset_scale(mat, shift))


def coset_idft_batch(mat: torch.Tensor, shift: int) -> torch.Tensor:
    return _coset_scale(idft_batch(mat), pow(shift, bb.P - 2, bb.P))


def coset_lde_batch(mat: torch.Tensor, added_bits: int, shift: int = 1) -> torch.Tensor:
    """Low-degree extend each column onto the coset shift*<g'> of size
    h << added_bits: iNTT, coset scale, zero-pad, NTT."""
    h, w = mat.shape
    padded = torch.zeros((h << added_bits, w), dtype=bb.I32, device=mat.device)
    padded[:h] = idft_batch(mat)
    return coset_dft_batch(padded, shift)


def lde_batch(mat: torch.Tensor, added_bits: int) -> torch.Tensor:
    return coset_lde_batch(mat, added_bits, 1)
