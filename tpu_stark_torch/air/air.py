"""AIR builder protocol: one ``eval``, three passes (counterpart of
``tpu_stark/air/air.py``, the same code re-homed without jax).

The same AIR ``eval`` runs symbolically (constraint count and max degree),
vectorized over the quotient domain on the device (prover), and at the
out-of-domain point zeta on the host (verifier), by swapping the builder
(see ``values.py``).  Constraints accumulate as ``acc += alpha^k * C_k`` in
eval order, shared by prover and verifier.
"""

from __future__ import annotations

from typing import List, Sequence

from .values import SymVal


class BaseAir:
    """An AIR: fixed ``width`` columns, an ``eval(builder)`` constraint body."""

    width: int = 0

    def eval(self, builder: "AirBuilder") -> None:
        raise NotImplementedError

    def partitions(self):
        """Optional ordered column partition of the constraint sequence (see
        ``keccak_air.Partition``): the streamed wide prover evaluates the
        quotient one partition at a time over only its columns.  ``None``:
        not partitioned, the dense quotient pass is the only prover path."""
        return None


class _Filtered:
    """Constraint sub-builder under a multiplicative selector condition."""

    def __init__(self, builder: "AirBuilder", condition):
        self._b = builder
        self._cond = condition

    def assert_zero(self, x):
        self._b.assert_zero(self._cond * x)

    def assert_eq(self, a, b):
        self.assert_zero(a - b)

    def when(self, condition):
        return _Filtered(self._b, self._cond * condition)


class AirBuilder:
    """Common builder skeleton; subclasses provide the value domain by
    populating ``main`` (2 x width window), selectors, and public values."""

    def __init__(self, main_rows, is_first_row, is_last_row, is_transition,
                 public_values: Sequence):
        self._main = main_rows  # [local_row, next_row]; each a list of values
        self._is_first_row = is_first_row
        self._is_last_row = is_last_row
        self._is_transition = is_transition
        self._public_values = list(public_values)
        self.constraint_count = 0

    # -- variables ---------------------------------------------------------
    def main_row(self, offset: int) -> List:
        return self._main[offset]

    def public_value(self, i: int):
        return self._public_values[i]

    @property
    def is_first_row(self):
        return self._is_first_row

    @property
    def is_last_row(self):
        return self._is_last_row

    @property
    def is_transition(self):
        return self._is_transition

    # -- filters -----------------------------------------------------------
    def when(self, condition) -> _Filtered:
        return _Filtered(self, condition)

    def when_first_row(self) -> _Filtered:
        return _Filtered(self, self._is_first_row)

    def when_last_row(self) -> _Filtered:
        return _Filtered(self, self._is_last_row)

    def when_transition(self) -> _Filtered:
        return _Filtered(self, self._is_transition)

    # -- vector access (wide AIRs assert whole column groups at once) ------
    def main_cols(self, offset: int, indices) -> object:
        """A vector value over the given column indices of row ``offset``
        (one assert on it contributes len(indices) constraints, column order)."""
        raise NotImplementedError

    # -- constraints -------------------------------------------------------
    def assert_zero(self, x) -> None:
        self.constraint_count += getattr(x, "count", 1)
        self._accumulate(x)

    def assert_eq(self, a, b) -> None:
        self.assert_zero(a - b)

    def _accumulate(self, x) -> None:
        raise NotImplementedError


class SymbolicAirBuilder(AirBuilder):
    """Degree-tracking pass (p3 get_log_quotient_degree / get_symbolic_constraints)."""

    def __init__(self, width: int, num_public_values: int,
                 trace_degree_multiple: int = 1):
        self._t = trace_degree_multiple
        main = [
            [SymVal(trace_degree_multiple) for _ in range(width)]
            for _ in range(2)
        ]
        super().__init__(
            main_rows=main,
            is_first_row=SymVal(1),   # Z_H/(x-1): degree n-1 -> 1 multiple
            is_last_row=SymVal(1),    # Z_H/(x-g^{-1})
            is_transition=SymVal(0),  # x - g^{-1}: degree 1 -> 0 multiples
            public_values=[SymVal(0)] * num_public_values,
        )
        self.max_degree = 0

    def main_cols(self, offset: int, indices):
        return SymVal(self._t, len(indices))

    def _accumulate(self, x) -> None:
        deg = x.degree if isinstance(x, SymVal) else 0
        self.max_degree = max(self.max_degree, deg)


def get_symbolic_info(air: BaseAir, num_public_values: int):
    """(constraint_count, max_degree_multiple) from a symbolic run."""
    b = SymbolicAirBuilder(air.width, num_public_values)
    air.eval(b)
    return b.constraint_count, b.max_degree
