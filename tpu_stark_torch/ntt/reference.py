"""Naive O(n^2) DFT oracle in Python ints (counterpart of
``tpu_stark/ntt/reference.py``), an oracle for the NTT that needs no
other module of the port's arithmetic than the field's constants."""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb


def naive_dft_matrix(mat: np.ndarray, shift: int = 1) -> np.ndarray:
    """mat: (h, w) canonical uint32. out[i, c] = sum_j mat[j, c] * (shift*g^i)^j."""
    h, w = mat.shape
    g = bb.two_adic_generator(h.bit_length() - 1) if h > 1 else 1
    out = np.zeros((h, w), dtype=np.uint32)
    col = mat.astype(object)
    for i in range(h):
        x = (shift * pow(g, i, bb.P)) % bb.P
        acc = np.zeros(w, dtype=object)
        xp = 1
        for j in range(h):
            acc = (acc + col[j] * xp) % bb.P
            xp = (xp * x) % bb.P
        out[i] = acc.astype(np.uint32)
    return out
