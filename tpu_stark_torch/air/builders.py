"""Concrete prover/verifier AIR builders (counterpart of
``tpu_stark/air/builders.py``).

* ``QuotientBuilder`` — constraints over every point of the quotient domain
  at once as base-field device vectors, alpha-folded into an extension
  accumulator (plain torch on the device); ``PartitionBuilder``, the same
  over a sparse column view (one partition of a wide AIR).
* ``VerifierBuilder`` — the same constraints at zeta on the host in
  BabyBear^4.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import extension as ext4
from ..fields import ref_field as rf
from .air import AirBuilder
from .values import DevVal, HostExtVal, HostExtVecVal


class QuotientBuilder(AirBuilder):
    """Builder over the quotient evaluation domain (device, base field).
    Constraints are collected as base vectors and alpha-folded at the end
    against a device tensor of alpha powers."""

    FOLD_CHUNK = 64  # constraint columns combined per step (bounds memory)

    def __init__(
        self,
        main_local: torch.Tensor,  # (m, w) Monty
        main_next: torch.Tensor,  # (m, w) Monty
        selectors: dict,  # base device vectors over the domain
        public_values: Sequence,  # DevVal or canonical ints
    ):
        m, w = main_local.shape
        self._mats = [main_local, main_next]
        dev = main_local.device
        super().__init__(
            main_rows=[
                [DevVal(main_local[:, c]) for c in range(w)],
                [DevVal(main_next[:, c]) for c in range(w)],
            ],
            is_first_row=DevVal(selectors["is_first_row"]),
            is_last_row=DevVal(selectors["is_last_row"]),
            is_transition=DevVal(selectors["is_transition"]),
            public_values=[
                p if isinstance(p, DevVal)
                else DevVal(torch.tensor(bb.monty_scalar(int(p)), dtype=bb.I32, device=dev))
                for p in public_values
            ],
        )
        self._constraints: List[torch.Tensor] = []

    def main_cols(self, offset: int, indices):
        mat = self._mats[offset]
        return DevVal(mat[:, torch.as_tensor(list(indices), device=mat.device)])

    def _accumulate(self, x) -> None:
        arr = x.arr
        if arr.dim() == 1:
            arr = arr[:, None]
        self._constraints.append(arr)  # (m, k)

    def folded_constraints(self, alpha_pows: torch.Tensor) -> torch.Tensor:
        """sum_i alpha^i * C_i over the domain, ext-valued (m, 4);
        alpha_pows: (num_constraints, 4) Monty tensor.  Vector entries
        consume consecutive alpha powers in column order."""
        m = int(self._constraints[0].shape[0])
        acc = ext4.zero((m,), alpha_pows.device)
        cols = torch.cat(
            [c.expand(m, c.shape[1]) for c in self._constraints], dim=1
        )
        for c0 in range(0, int(cols.shape[1]), self.FOLD_CHUNK):
            chunk = cols[:, c0 : c0 + self.FOLD_CHUNK]
            k = int(chunk.shape[1])
            prods = ext4.mul_base(alpha_pows[None, c0 : c0 + k, :], chunk)
            acc = ext4.add(acc, bb.sum_mod(prods, axis=1))
        return acc


class PartitionBuilder(QuotientBuilder):
    """QuotientBuilder over a sparse column view: a partition's eval reads
    global column indices, and only its declared columns exist (any other
    column is ``None`` in ``main_row`` and a ``KeyError`` in ``main_cols``)."""

    def __init__(self, local, nxt, local_cols, next_cols, selectors, pis):
        self._mats = [local, nxt]
        self._pos = [
            {int(c): i for i, c in enumerate(local_cols)},
            {int(c): i for i, c in enumerate(next_cols)},
        ]
        width = 1 + max([int(c) for c in local_cols] + [int(c) for c in next_cols])
        rows = []
        for mat, pos in zip(self._mats, self._pos):
            row = [None] * width
            for c, i in pos.items():
                row[c] = DevVal(mat[:, i])
            rows.append(row)
        # QuotientBuilder.__init__ would take every column; set its state here
        AirBuilder.__init__(
            self,
            main_rows=rows,
            is_first_row=DevVal(selectors["is_first_row"]),
            is_last_row=DevVal(selectors["is_last_row"]),
            is_transition=DevVal(selectors["is_transition"]),
            public_values=list(pis),
        )
        self._constraints = []

    def main_cols(self, offset: int, indices):
        pos, mat = self._pos[offset], self._mats[offset]
        idx = torch.as_tensor([pos[int(c)] for c in np.asarray(indices)], device=mat.device)
        return DevVal(mat[:, idx])


class VerifierBuilder(AirBuilder):
    """Builder at the out-of-domain point zeta (host, BabyBear^4)."""

    def __init__(
        self,
        opened_local: List[tuple],
        opened_next: List[tuple],
        selectors: dict,
        public_values: Sequence[int],
        alpha: tuple,
    ):
        self._opened = [list(opened_local), list(opened_next)]
        super().__init__(
            main_rows=[
                [HostExtVal(v) for v in opened_local],
                [HostExtVal(v) for v in opened_next],
            ],
            is_first_row=HostExtVal(selectors["is_first_row"]),
            is_last_row=HostExtVal(selectors["is_last_row"]),
            is_transition=HostExtVal(selectors["is_transition"]),
            public_values=[HostExtVal.from_base(int(p)) for p in public_values],
        )
        self._alpha = tuple(alpha)
        self._alpha_pow = (1, 0, 0, 0)
        self._acc = (0, 0, 0, 0)

    def main_cols(self, offset: int, indices):
        return HostExtVecVal([self._opened[offset][i] for i in indices])

    def _accumulate(self, x) -> None:
        vals = x.vals if isinstance(x, HostExtVecVal) else [x.c]
        for v in vals:
            self._acc = rf.eadd(self._acc, rf.emul(self._alpha_pow, v))
            self._alpha_pow = rf.emul(self._alpha_pow, self._alpha)

    def folded_constraints(self) -> tuple:
        return self._acc
