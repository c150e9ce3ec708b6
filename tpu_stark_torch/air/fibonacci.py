"""FibonacciAir — the reference workload (counterpart of
``tpu_stark/air/fibonacci.py``): two columns (left, right); the first row is
pinned to public (a, b); transition left' = right, right' = left + right;
the last row pins right = x = public value 2."""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from .air import AirBuilder, BaseAir


class FibonacciAir(BaseAir):
    width = 2

    def eval(self, b: AirBuilder) -> None:
        local = b.main_row(0)
        nxt = b.main_row(1)
        a = b.public_value(0)
        bv = b.public_value(1)
        x = b.public_value(2)

        first = b.when_first_row()
        first.assert_eq(local[0], a)
        first.assert_eq(local[1], bv)

        trans = b.when_transition()
        trans.assert_eq(nxt[0], local[1])
        trans.assert_eq(nxt[1], local[0] + local[1])

        b.when_last_row().assert_eq(local[1], x)


def generate_trace_rows(a: int, b: int, n: int) -> np.ndarray:
    """(n, 2) canonical uint32 trace (fib_air.rs:266-284: row0 = (a, b),
    rows[i] = (rows[i-1].right, rows[i-1].left + rows[i-1].right))."""
    assert n & (n - 1) == 0, "trace length must be a power of two"
    rows = np.zeros((n, 2), dtype=np.uint32)
    ca, cb = a % bb.P, b % bb.P
    for i in range(n):
        rows[i, 0] = ca
        rows[i, 1] = cb
        ca, cb = cb, (ca + cb) % bb.P
    return rows


def fibonacci_value(a: int, b: int, n: int) -> int:
    """The public value x = right column of the last row."""
    ca, cb = a % bb.P, b % bb.P
    for _ in range(n - 1):
        ca, cb = cb, (ca + cb) % bb.P
    return cb
