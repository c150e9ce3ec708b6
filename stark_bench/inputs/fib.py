"""fib_air witnesses: (a, b) drawn from the seed and the whole trace made by
doubling, rows [L, 2L) = rows [0, L) times the step matrix's L-th power, so
2^24 rows take well under a second (a row-by-row loop takes seconds)."""

from __future__ import annotations

import numpy as np

P = 0x78000001  # BabyBear


def _fib3(k: int):
    """(F(k-1), F(k), F(k+1)) mod P, F(0) = 0, F(1) = 1."""
    a, b = 0, 1  # F(0), F(1)
    for bit in bin(k)[2:]:
        # doubling: F(2m) = F(m) (2 F(m+1) - F(m)), F(2m+1) = F(m)^2 + F(m+1)^2
        a, b = a * (2 * b - a) % P, (a * a + b * b) % P
        if bit == "1":
            a, b = b, (a + b) % P
    return (b - a) % P, a, b


def trace_rows(a: int, b: int, rows: int) -> np.ndarray:
    """(rows, 2) canonical uint32: row 0 = (a, b), row i+1 = (right, left + right)."""
    if rows < 1 or rows & (rows - 1):
        raise ValueError(f"fib: {rows} rows is not a power of two")
    out = np.empty((rows, 2), dtype=np.uint64)
    out[0] = (a % P, b % P)
    filled = 1
    while filled < rows:
        f_prev, f, f_next = (np.uint64(v) for v in _fib3(filled))
        left, right = out[:filled, 0], out[:filled, 1]
        out[filled : 2 * filled, 0] = (f_prev * left + f * right) % P
        out[filled : 2 * filled, 1] = (f * left + f_next * right) % P
        filled *= 2
    return out.astype(np.uint32)


def make(rows: int, seed: int, device=None):
    """The trace (host uint32, as ``prove`` takes it) and [a, b, x]."""
    a, b = (int(v) for v in np.random.default_rng(seed).integers(0, P, size=2))
    trace = trace_rows(a, b, rows)
    return trace, [a, b, int(trace[-1, 1])]
