"""Two-adic multiplicative coset domains (counterpart of
``tpu_stark/fri/domains.py``): disjoint quotient domains, domain splitting
for quotient chunks, Lagrange selectors, vanishing polynomials.  Device
methods produce base-field vectors over a coset for the prover's quotient
pass; host methods evaluate at an extension point for the verifier."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..fields import babybear as bb
from ..fields import ref_field as rf

ExtPoint = Tuple[int, int, int, int]  # canonical coefficients


def ext_from_base(x: int) -> ExtPoint:
    return (x % bb.P, 0, 0, 0)


@dataclasses.dataclass(frozen=True)
class TwoAdicCoset:
    """The coset ``shift * <g>`` with ``g = two_adic_generator(log_n)``."""

    log_n: int
    shift: int = 1

    @property
    def size(self) -> int:
        return 1 << self.log_n

    @property
    def gen(self) -> int:
        return bb.two_adic_generator(self.log_n)

    def first_point(self) -> int:
        return self.shift % bb.P

    def next_point_ext(self, zeta: ExtPoint) -> ExtPoint:
        return rf.escale(zeta, self.gen)

    def create_disjoint_domain(self, min_size: int) -> "TwoAdicCoset":
        return TwoAdicCoset(
            (min_size - 1).bit_length(), (self.shift * bb.GENERATOR) % bb.P
        )

    def split_domains(self, k: int) -> List["TwoAdicCoset"]:
        """k interleaved sub-cosets: chunk i holds shift*G^i * <G^k>."""
        assert k & (k - 1) == 0
        logk = k.bit_length() - 1
        g = self.gen
        return [
            TwoAdicCoset(self.log_n - logk, (self.shift * pow(g, i, bb.P)) % bb.P)
            for i in range(k)
        ]

    # -- host (verifier) ---------------------------------------------------
    def vanishing_poly_at_point_ext(self, zeta: ExtPoint) -> ExtPoint:
        zs = rf.escale(zeta, rf.finv(self.shift))
        return rf.esub(rf.epow(zs, self.size), (1, 0, 0, 0))

    def selectors_at_point_ext(self, zeta: ExtPoint):
        z = self.vanishing_poly_at_point_ext(zeta)
        last_pt = (self.shift * rf.finv(self.gen)) % bb.P
        return {
            "is_first_row": rf.emul(z, rf.einv(rf.esub(zeta, ext_from_base(self.shift)))),
            "is_last_row": rf.emul(z, rf.einv(rf.esub(zeta, ext_from_base(last_pt)))),
            "is_transition": rf.esub(zeta, ext_from_base(last_pt)),
            "inv_zeroifier": rf.einv(z),
        }

    # -- device (prover) ---------------------------------------------------
    def points_device(self, device, start: int = 0, count: Optional[int] = None) -> torch.Tensor:
        """Natural-order points shift*g^i for i in [start, start + count)
        (every point by default), Monty int32 on ``device``."""
        count = self.size if count is None else count
        first = self.shift * pow(self.gen, start, bb.P) % bb.P
        return bb.mul_canonical(bb.powers_monty(self.gen, count, device), first)

    def selectors_on_coset_device(self, coset: "TwoAdicCoset", device, start: int = 0, count: Optional[int] = None):
        """Selectors of this domain over the points [start, start + count)
        of ``coset`` (the quotient evaluation domain; every point by
        default), as base Monty vectors."""
        assert coset.log_n >= self.log_n and coset.shift != self.shift
        xs = coset.points_device(device, start, count)
        xs_over_shift = bb.mul_canonical(xs, rf.finv(self.shift))
        zh = bb.sub(bb.pow_const(xs_over_shift, self.size), bb.MONTY_R)
        last_pt = (self.shift * rf.finv(self.gen)) % bb.P
        return {
            "is_first_row": bb.mul(zh, bb.inv(bb.sub(xs, bb.monty_scalar(self.shift)))),
            "is_last_row": bb.mul(zh, bb.inv(bb.sub(xs, bb.monty_scalar(last_pt)))),
            "is_transition": bb.sub(xs, bb.monty_scalar(last_pt)),
            "inv_zeroifier": bb.inv(zh),
        }
