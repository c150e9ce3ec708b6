"""Quartic binomial extension BabyBear^4 = F_p[X] / (X^4 - 11) on torch.

Counterpart of ``tpu_stark/fields/extension.py``: extension elements are
int32 Monty tensors with a trailing axis of length 4 (coefficients a0..a3,
little-endian in X); every op is elementwise over that axis.
"""

from __future__ import annotations

import numpy as np
import torch

from . import babybear as bb

D = 4
W = 11  # X^4 = W
FROB = pow(W, (bb.P - 1) // 4, bb.P)


def from_base(a: torch.Tensor) -> torch.Tensor:
    """Embed a base-field tensor (...,) -> (..., 4)."""
    z = torch.zeros(a.shape + (D - 1,), dtype=bb.I32, device=a.device)
    return torch.cat([a[..., None], z], dim=-1)


def scalar(coeffs, device) -> torch.Tensor:
    """Python ints (canonical) -> (4,) Monty tensor."""
    c = [bb.host_to_monty(int(x) % bb.P) for x in coeffs]
    return torch.tensor(c, dtype=bb.I32, device=device)


def zero(shape, device) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (D,), dtype=bb.I32, device=device)


def one(shape, device) -> torch.Tensor:
    z = zero(shape, device)
    z[..., 0] = bb.MONTY_R
    return z


def add(a, b):
    return bb.add(a, b)


def sub(a, b):
    return bb.sub(a, b)


def neg(a):
    return bb.neg(a)


def _wmul(x):
    """x * 11 mod p (W is canonical, so Monty stays Monty)."""
    return bb.mul_canonical(x, W)


def mul(a, b):
    """Product with X^4 = W reduction, two-level Karatsuba (9 base
    multiplies), the same formula as the JAX package: split A = AL + AH*Y
    with Y = X^2, Y^2 = W; each half is linear in X."""
    m, ad, sb = bb.mul, bb.add, bb.sub
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    b0, b1, b2, b3 = (b[..., i] for i in range(4))

    def lin_mul(u0, u1, v0, v1):
        p0 = m(u0, v0)
        p2 = m(u1, v1)
        p1 = sb(m(ad(u0, u1), ad(v0, v1)), ad(p0, p2))
        return p0, p1, p2

    p00, p01, p02 = lin_mul(a0, a1, b0, b1)
    p20, p21, p22 = lin_mul(a2, a3, b2, b3)
    q0, q1, q2 = lin_mul(ad(a0, a2), ad(a1, a3), ad(b0, b2), ad(b1, b3))
    p10 = sb(q0, ad(p00, p20))
    p11 = sb(q1, ad(p01, p21))
    p12 = sb(q2, ad(p02, p22))
    c0 = ad(p00, _wmul(ad(p12, p20)))
    c1 = ad(p01, _wmul(p21))
    c2 = ad(ad(p02, p10), _wmul(p22))
    c3 = p11
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), dim=-1)


def mul_base(a, b):
    """Ext (..., 4) times base (...,): coefficientwise."""
    return bb.mul(a, b[..., None])


def frobenius(a, j: int = 1):
    """a -> a^(p^j): coefficient i picks up f^(i*j)."""
    twists = np.array(
        [pow(FROB, (i * j) % 4, bb.P) for i in range(4)], dtype=np.int64
    )
    return bb.mul_canonical(a, torch.from_numpy(twists).to(a.device))


def inv(a):
    """Inverse via the norm: b = product of the 3 conjugates, N = (a*b)[0]
    in F_p, a^-1 = b / N.  inv(0) = 0."""
    b = mul(frobenius(a, 1), mul(frobenius(a, 2), frobenius(a, 3)))
    norm = mul(a, b)[..., 0]
    return mul_base(b, bb.inv(norm))


def powers_device(z_canonical, n: int, device) -> torch.Tensor:
    """(n, 4) Monty tensor [1, z, z^2, ...] of an ext point given as a
    canonical coefficient tuple, by doubling."""
    out = one((1,), device)
    step = scalar(tuple(int(c) % bb.P for c in z_canonical), device)
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, step[None, :])], dim=0)
        step = mul(step, step)
    return out[:n]
