"""BabyBear prime field (p = 2^31 - 2^27 + 1) on torch tensors.

Counterpart of ``tpu_stark/fields/babybear.py``.  Device tensors hold field
elements in **Montgomery form** (``x * 2^32 mod p``) as ``torch.int32``,
always reduced to ``[0, p)``: the same bits as the JAX package's ``uint32``
lanes.  ``to_u32`` / ``from_u32`` convert to and from the canonical residue.

Arithmetic: add, sub and neg stay in int32 (every intermediate lies in
(-p, p)); products widen to int64, where every product of two residues is
below 2^62.  The Montgomery product is ``a*b*R^-1 mod p``, computed as two
exact remainders.  The JAX package's 16-bit-limb product exists because the
TPU VPU has no 64-bit multiply and is not ported.

Scalar arguments may be Python ints (Monty form unless a function says
canonical); they broadcast against tensors.
"""

from __future__ import annotations

import numpy as np
import torch

P = 0x78000001  # 2^31 - 2^27 + 1
MU = 0x88000001  # P^{-1} mod 2^32
TWO_ADICITY = 27  # p - 1 = 2^27 * 15
GENERATOR = 31
MONTY_R = (1 << 32) % P  # Montgomery form of 1
MONTY_R2 = (1 << 64) % P
R_INV = pow(1 << 32, P - 2, P)  # 2^-32 mod p
ROOT_27 = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)

I32 = torch.int32
I64 = torch.int64


# ---------------------------------------------------------------------------
# Host (python int / numpy) helpers: twiddle precompute and test oracles.
# ---------------------------------------------------------------------------
def host_to_monty(x: int) -> int:
    return (x << 32) % P


def np_powers(base_canonical: int, n: int) -> np.ndarray:
    """[1, w, ..., w^(n-1)] canonical uint32, by doubling."""
    out = np.array([1], dtype=np.uint64)
    w = base_canonical % P
    while len(out) < n:
        step = pow(w, len(out), P)
        out = np.concatenate([out, (out * step) % P])
    return out[:n].astype(np.uint32)


def np_to_monty(x: np.ndarray) -> np.ndarray:
    return ((x.astype(np.uint64) << 32) % P).astype(np.uint32)


def np_from_monty(x: np.ndarray) -> np.ndarray:
    return ((x.astype(np.uint64) * R_INV) % P).astype(np.uint32)


def np_shoup(w_canonical: np.ndarray) -> np.ndarray:
    """Shoup precomputation floor(w * 2^32 / P) for canonical constants."""
    return ((w_canonical.astype(np.uint64) << 32) // P).astype(np.uint32)


def two_adic_generator(bits: int) -> int:
    """Canonical generator of the order-2^bits subgroup."""
    assert 0 <= bits <= TWO_ADICITY
    return pow(ROOT_27, 1 << (TWO_ADICITY - bits), P)


def monty_scalar(x: int) -> int:
    """Python int -> Monty form (a Python int, broadcastable)."""
    return host_to_monty(x % P)


def to_tensor(x_np: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy residues -> int32 tensor on ``device`` (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(x_np).astype(np.int32)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array (same bits)."""
    return x.cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# Device (torch) arithmetic.
# ---------------------------------------------------------------------------
def _i64(x):
    return x.to(I64) if isinstance(x, torch.Tensor) else int(x)


def _fix_neg(d):
    """d in (-p, p) int32 -> [0, p): add p where the sign bit is set."""
    return d + ((d >> 31) & P)


def add(a, b):
    return _fix_neg(a - (P - b))


def sub(a, b):
    return _fix_neg(a - b)


def neg(a):
    return _fix_neg(0 - a)


def mul(a, b):
    """Montgomery product of Monty operands, reduced to [0, p), int32."""
    return ((_i64(a) * _i64(b)) % P * R_INV % P).to(I32)


def mul_canonical(x, c):
    """x * c mod p for a CANONICAL multiplier c (Monty x stays Monty)."""
    return ((_i64(x) * _i64(c)) % P).to(I32)


def shoup_mul(x, w, w_pr):
    """x * w mod p for a canonical constant w with w_pr = floor(w*2^32/p)
    (Harvey/Shoup), as the CUDA NTT computes it: q = hi32(x*w_pr),
    r = x*w - q*p lies in [0, 2p), one conditional subtract.  Exact in
    int64 because x < 2^31 and w_pr < 2^32."""
    x = _i64(x)
    q = (x * _i64(w_pr)) >> 32
    r = x * _i64(w) - q * P
    return torch.where(r >= P, r - P, r).to(I32)


def from_u32(x):
    """Canonical residue -> Monty form."""
    return ((_i64(x) << 32) % P).to(I32)


def to_u32(x):
    """Monty form -> canonical residue."""
    return (_i64(x) * R_INV % P).to(I32)


def pow_const(a, e: int):
    """a^e for a static non-negative exponent (square-and-multiply)."""
    acc = None
    base = a
    while e:
        if e & 1:
            acc = base if acc is None else mul(acc, base)
        e >>= 1
        if e:
            base = mul(base, base)
    if acc is None:
        return torch.full_like(a, MONTY_R)
    return acc


def inv(a):
    """Field inverse via Fermat (a^(p-2)); inv(0) = 0."""
    return pow_const(a, P - 2)


def monty_ones(shape, device) -> torch.Tensor:
    return torch.full(shape, MONTY_R, dtype=I32, device=device)


def powers(base_canonical: int, n: int, device) -> torch.Tensor:
    """[1, w, ..., w^(n-1)] CANONICAL int64 on ``device``, by doubling."""
    b = base_canonical % P
    out = torch.ones(1, dtype=I64, device=device)
    while out.shape[0] < n:
        step = pow(b, out.shape[0], P)
        out = torch.cat([out, out * step % P])
    return out[:n]


def powers_monty(base_canonical: int, n: int, device) -> torch.Tensor:
    """[1, w, ..., w^(n-1)] in Monty form, int32 on ``device``."""
    return from_u32(powers(base_canonical, n, device))


def pow_exponents(base_canonical: int, e: torch.Tensor, max_bits: int) -> torch.Tensor:
    """base^e in Monty form for an exponent tensor, by square-and-multiply
    over ``max_bits`` bits."""
    acc = monty_ones(e.shape, e.device)
    b = base_canonical % P
    e = e.to(I64)
    for k in range(max_bits):
        wk = monty_scalar(pow(b, 1 << k, P))
        acc = torch.where(((e >> k) & 1) == 1, mul(acc, wk), acc)
    return acc


def sum_mod(arr: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Modular sum along an axis.  Exact: int64 holds the sum of fewer than
    2^32 residues below 2^31."""
    return (arr.to(I64).sum(dim=axis) % P).to(I32)
