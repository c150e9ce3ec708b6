"""Row-major matrix conventions and bit-reversal (counterpart of
``tpu_stark/matrix.py``): rows = domain points, columns = polynomials."""

from __future__ import annotations

import functools

import numpy as np
import torch


def log2_strict(n: int) -> int:
    b = n.bit_length() - 1
    if n <= 0 or (1 << b) != n:
        raise ValueError(f"size {n} is not a power of two")
    return b


@functools.lru_cache(maxsize=None)
def bit_reversal_perm(log_n: int) -> np.ndarray:
    """Permutation p with p[i] = bit-reverse of i over log_n bits."""
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def reverse_bits_device(idx: torch.Tensor, log_n: int) -> torch.Tensor:
    """The low ``log_n`` bits of each int64 index reversed."""
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def bit_reversal_perm_device(log_n: int, device) -> torch.Tensor:
    """``bit_reversal_perm`` as an int64 tensor built on ``device``."""
    return reverse_bits_device(torch.arange(1 << log_n, dtype=torch.int64, device=device), log_n)


def reverse_matrix_index_bits(mat: torch.Tensor) -> torch.Tensor:
    """Permute rows into bit-reversed order (an involution)."""
    log_h = log2_strict(int(mat.shape[0]))
    if log_h == 0:
        return mat
    return mat[bit_reversal_perm_device(log_h, mat.device)]
