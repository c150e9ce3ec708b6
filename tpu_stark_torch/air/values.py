"""Value algebras for the three AIR evaluation modes (counterpart of
``tpu_stark/air/values.py``).

* ``SymVal``     — degree-tracking symbolic pass (degrees in multiples of n).
* ``DevVal``     — base-field int32 Monty tensors over the quotient domain
  (the vectorized prover pass).
* ``HostExtVal`` — BabyBear^4 Python tuples at the out-of-domain point zeta
  (the verifier pass; canonical ints).
* ``ExprVal``    — nodes of a hash-consed constraint DAG (``ExprGraph``),
  which ``air/quotient_kernel.py`` turns into the quotient kernel's source.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from ..fields import babybear as bb
from ..fields import ref_field as rf


@dataclasses.dataclass(frozen=True)
class SymVal:
    """Degree in multiples of the trace length n (p3 degree_multiple).
    ``count`` > 1 marks a vector value: one assert contributes ``count``
    constraints."""

    degree: int
    count: int = 1

    def _coerce(self, other) -> "SymVal":
        return other if isinstance(other, SymVal) else SymVal(0)

    def __add__(self, other):
        o = self._coerce(other)
        return SymVal(max(self.degree, o.degree), max(self.count, o.count))

    __radd__ = __add__
    __sub__ = __add__
    __rsub__ = __add__

    def __mul__(self, other):
        o = self._coerce(other)
        return SymVal(self.degree + o.degree, max(self.count, o.count))

    __rmul__ = __mul__

    def __neg__(self):
        return self

    def take(self, indices):
        return SymVal(self.degree, len(indices))


class DevVal:
    """Base-field value over the evaluation domain (int32 Monty tensor).

    ``arr`` is (m,) for a scalar constraint value or (m, k) for a vector of
    k per-column values; mixed ops broadcast the scalar across the vector."""

    def __init__(self, arr: torch.Tensor):
        self.arr = arr

    @property
    def count(self) -> int:
        return 1 if self.arr.dim() <= 1 else int(self.arr.shape[1])

    @staticmethod
    def _align(a: torch.Tensor, b: torch.Tensor):
        if a.dim() == 1 and b.dim() == 2:
            return a[:, None], b
        if a.dim() == 2 and b.dim() == 1:
            return a, b[:, None]
        return a, b

    def _coerce(self, other) -> "DevVal":
        if isinstance(other, DevVal):
            return other
        if isinstance(other, int):
            return DevVal(
                torch.tensor(bb.monty_scalar(other), dtype=bb.I32, device=self.arr.device)
            )
        raise TypeError(f"cannot mix {type(other)} into DevVal")

    def __add__(self, other):
        a, b = self._align(self.arr, self._coerce(other).arr)
        return DevVal(bb.add(a, b))

    __radd__ = __add__

    def __sub__(self, other):
        a, b = self._align(self.arr, self._coerce(other).arr)
        return DevVal(bb.sub(a, b))

    def __rsub__(self, other):
        a, b = self._align(self._coerce(other).arr, self.arr)
        return DevVal(bb.sub(a, b))

    def __mul__(self, other):
        a, b = self._align(self.arr, self._coerce(other).arr)
        return DevVal(bb.mul(a, b))

    __rmul__ = __mul__

    def __neg__(self):
        return DevVal(bb.neg(self.arr))

    def take(self, indices):
        assert self.arr.dim() == 2
        return DevVal(self.arr[:, torch.as_tensor(indices, device=self.arr.device)])


class HostExtVecVal:
    """Vector of BabyBear^4 values (verifier side of vector constraints)."""

    def __init__(self, vals):
        self.vals = [tuple(int(c) % bb.P for c in v) for v in vals]

    @property
    def count(self) -> int:
        return len(self.vals)

    def _coerce_list(self, other):
        if isinstance(other, HostExtVecVal):
            assert len(other.vals) == len(self.vals)
            return other.vals
        if isinstance(other, HostExtVal):
            return [other.c] * len(self.vals)
        if isinstance(other, int):
            c = (other % bb.P, 0, 0, 0)
            return [c] * len(self.vals)
        raise TypeError(f"cannot mix {type(other)} into HostExtVecVal")

    def __add__(self, other):
        o = self._coerce_list(other)
        return HostExtVecVal([rf.eadd(a, b) for a, b in zip(self.vals, o)])

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce_list(other)
        return HostExtVecVal([rf.esub(a, b) for a, b in zip(self.vals, o)])

    def __rsub__(self, other):
        o = self._coerce_list(other)
        return HostExtVecVal([rf.esub(b, a) for a, b in zip(self.vals, o)])

    def __mul__(self, other):
        o = self._coerce_list(other)
        return HostExtVecVal([rf.emul(a, b) for a, b in zip(self.vals, o)])

    __rmul__ = __mul__

    def __neg__(self):
        return HostExtVecVal(
            [tuple((-x) % bb.P for x in v) for v in self.vals]
        )

    def take(self, indices):
        return HostExtVecVal([self.vals[i] for i in indices])


class HostExtVal:
    """BabyBear^4 scalar (canonical-int tuple) for the verifier at zeta."""

    def __init__(self, coeffs: Tuple[int, int, int, int]):
        self.c = tuple(int(x) % bb.P for x in coeffs)

    @classmethod
    def from_base(cls, x: int) -> "HostExtVal":
        return cls((x, 0, 0, 0))

    def _coerce(self, other) -> "HostExtVal":
        if isinstance(other, HostExtVal):
            return other
        if isinstance(other, int):
            return HostExtVal.from_base(other)
        raise TypeError(f"cannot mix {type(other)} into HostExtVal")

    def __add__(self, other):
        if isinstance(other, HostExtVecVal):
            return other + self
        return HostExtVal(rf.eadd(self.c, self._coerce(other).c))

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, HostExtVecVal):
            return other.__rsub__(self)
        return HostExtVal(rf.esub(self.c, self._coerce(other).c))

    def __rsub__(self, other):
        return HostExtVal(rf.esub(self._coerce(other).c, self.c))

    def __mul__(self, other):
        if isinstance(other, HostExtVecVal):
            return other * self
        return HostExtVal(rf.emul(self.c, self._coerce(other).c))

    __rmul__ = __mul__

    def __neg__(self):
        return HostExtVal(tuple((-x) % bb.P for x in self.c))


class ExprGraph:
    """A hash-consed DAG of base-field nodes, in creation order (so every
    node's operands come before it).  Leaves: ``("col", row, pos)`` (panel
    position ``pos`` of the current row 0 or the next row 1), ``("sel",
    name)``, ``("pub", i)``, ``("const", v)`` (v canonical); operations
    ``("add" | "sub" | "mul", a, b)`` and ``("neg", a)`` on node ids.  An
    operation of two constants is folded into a constant."""

    def __init__(self):
        self.nodes: List[tuple] = []
        self._ids: Dict[tuple, int] = {}

    def node(self, key: tuple) -> int:
        i = self._ids.get(key)
        if i is None:
            i = self._ids[key] = len(self.nodes)
            self.nodes.append(key)
        return i

    def const(self, v: int) -> int:
        return self.node(("const", int(v) % bb.P))

    def op(self, name: str, *args: int) -> int:
        vals = [self.nodes[a] for a in args]
        if all(v[0] == "const" for v in vals):
            x = [v[1] for v in vals]
            if name == "add":
                return self.const(x[0] + x[1])
            if name == "sub":
                return self.const(x[0] - x[1])
            if name == "mul":
                return self.const(x[0] * x[1])
            return self.const(-x[0])
        return self.node((name, *args))


class ExprVal:
    """A value of the constraint DAG: a tuple of node ids, one for a scalar
    or one per column of a vector; a scalar operand broadcasts across a
    vector, as ``DevVal._align`` does, and an ``int`` is a constant leaf."""

    def __init__(self, graph: ExprGraph, ids: Tuple[int, ...], vector: bool = False):
        self.graph = graph
        self.ids = tuple(ids)
        self.vector = vector

    @property
    def count(self) -> int:
        return len(self.ids) if self.vector else 1

    def _coerce(self, other) -> "ExprVal":
        if isinstance(other, ExprVal):
            return other
        if isinstance(other, int):
            return ExprVal(self.graph, (self.graph.const(other),))
        raise TypeError(f"cannot mix {type(other)} into ExprVal")

    def _binary(self, name: str, a: "ExprVal", b: "ExprVal") -> "ExprVal":
        x, y = a.ids, b.ids
        if len(x) == 1 and len(y) > 1:
            x = x * len(y)
        elif len(y) == 1 and len(x) > 1:
            y = y * len(x)
        if len(x) != len(y):
            raise ValueError(f"vector lengths {len(x)} and {len(y)} differ")
        return ExprVal(self.graph, tuple(self.graph.op(name, i, j) for i, j in zip(x, y)), a.vector or b.vector)

    def __add__(self, other):
        return self._binary("add", self, self._coerce(other))

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary("sub", self, self._coerce(other))

    def __rsub__(self, other):
        return self._binary("sub", self._coerce(other), self)

    def __mul__(self, other):
        return self._binary("mul", self, self._coerce(other))

    __rmul__ = __mul__

    def __neg__(self):
        return ExprVal(self.graph, tuple(self.graph.op("neg", i) for i in self.ids), self.vector)

    def take(self, indices):
        assert self.vector
        return ExprVal(self.graph, tuple(self.ids[int(i)] for i in indices), True)
