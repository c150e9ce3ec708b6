"""BabyBear, its degree-4 extension and the radix-2 transform, in plain
torch (int64 tensors of canonical values in [0, p)) and on the host (Python
ints).  Written from the field's definition: p = 15 * 2^27 + 1, the
multiplicative generator 31, the extension F[x] / (x^4 - 11)."""

from __future__ import annotations

from typing import Tuple

import torch

P = 0x78000001
GEN = 31
W = 11  # x^4 = W in the extension
TWO_ADICITY = 27
R_INV = pow(1 << 32, P - 2, P)  # 2^-32: a Montgomery form m stands for m * 2^-32

Ext = Tuple[int, int, int, int]


def two_adic_gen(bits: int) -> int:
    """The generator of the order-2^bits subgroup: 31^((p - 1) / 2^27) raised
    to 2^(27 - bits)."""
    return pow(pow(GEN, (P - 1) >> TWO_ADICITY, P), 1 << (TWO_ADICITY - bits), P)


def inv(x: int) -> int:
    return pow(x % P, P - 2, P)


# -- host extension arithmetic ------------------------------------------------
def e_add(a: Ext, b: Ext) -> Ext:
    return tuple((x + y) % P for x, y in zip(a, b))


def e_sub(a: Ext, b: Ext) -> Ext:
    return tuple((x - y) % P for x, y in zip(a, b))


def e_scale(a: Ext, s: int) -> Ext:
    return tuple(x * s % P for x in a)


def e_mul(a: Ext, b: Ext) -> Ext:
    c = [0] * 7
    for i in range(4):
        for j in range(4):
            c[i + j] += a[i] * b[j]
    return tuple((c[k] + W * (c[k + 4] if k < 3 else 0)) % P for k in range(4))


def e_pow(a: Ext, e: int) -> Ext:
    out, base = (1, 0, 0, 0), a
    while e:
        if e & 1:
            out = e_mul(out, base)
        base = e_mul(base, base)
        e >>= 1
    return out


def e_inv(a: Ext) -> Ext:
    """a^(p^4 - 2)."""
    return e_pow(a, P**4 - 2)


# -- device base field ---------------------------------------------------------
def t_pow(x: torch.Tensor, e: int) -> torch.Tensor:
    out = torch.ones_like(x)
    base = x
    while e:
        if e & 1:
            out = out * base % P
        base = base * base % P
        e >>= 1
    return out


def t_inv(x: torch.Tensor) -> torch.Tensor:
    return t_pow(x, P - 2)


def powers(x: int, n: int, device) -> torch.Tensor:
    """[x^0, ..., x^(n-1)] as an (n,) int64 tensor."""
    out = torch.ones(n, dtype=torch.int64, device=device)
    k = 1
    while k < n:
        m = min(k, n - k)
        out[k : k + m] = out[:m] * pow(x, k, P) % P
        k *= 2
    return out


def bitrev(log_n: int, device) -> torch.Tensor:
    """The bit reversal of [0, 2^log_n) as an int64 index tensor."""
    i = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    r = torch.zeros_like(i)
    for b in range(log_n):
        r |= ((i >> b) & 1) << (log_n - 1 - b)
    return r


# -- device extension field: tensors (..., 4) ---------------------------------------
def t_emul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Extension products; either side may be a host ``Ext``."""
    a = _ext_t(a, b)
    b = _ext_t(b, a)
    m = [[a[..., i] * b[..., j] % P for j in range(4)] for i in range(4)]
    return torch.stack([
        (m[0][0] + W * ((m[1][3] + m[2][2] + m[3][1]) % P)) % P,
        (m[0][1] + m[1][0] + W * ((m[2][3] + m[3][2]) % P)) % P,
        (m[0][2] + m[1][1] + m[2][0] + W * m[3][3]) % P,
        (m[0][3] + m[1][2] + m[2][1] + m[3][0]) % P,
    ], dim=-1)


def t_escale(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Extension values times base values (s broadcast over the 4 coefficients)."""
    return a * s.unsqueeze(-1) % P


def t_einv(a: torch.Tensor) -> torch.Tensor:
    """Extension inverses.  With u = x^2 (u^2 = W), a = A + x B for A, B in
    F[u]; a (A - x B) = A^2 - u B^2 = N lies in F[u], and N's inverse is
    its conjugate over N0^2 - W N1^2."""
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    n0 = (a0 * a0 % P + W * (a2 * a2 % P) - 2 * W * (a1 * a3 % P)) % P
    n1 = (2 * (a0 * a2 % P) - a1 * a1 % P - W * (a3 * a3 % P)) % P
    d = t_inv((n0 * n0 % P - W * (n1 * n1 % P)) % P)
    m0, m1 = n0 * d % P, (P - n1) * d % P
    conj = torch.stack([a0, (P - a1) % P, a2, (P - a3) % P], dim=-1)
    z = torch.zeros_like(m0)
    return t_emul(conj, torch.stack([m0, z, m1, z], dim=-1))


def t_ext_powers(z: Ext, n: int, device) -> torch.Tensor:
    """[z^0, ..., z^(n-1)] as an (n, 4) tensor."""
    out = torch.zeros((n, 4), dtype=torch.int64, device=device)
    out[0, 0] = 1
    k, zk = 1, z
    while k < n:
        m = min(k, n - k)
        out[k : k + m] = t_emul(out[:m], zk)
        k, zk = 2 * k, e_mul(zk, zk)
    return out


def t_eval(coeffs: torch.Tensor, z: Ext) -> list:
    """Each column of ``coeffs`` (h, w) as a polynomial at z: w host ``Ext``s."""
    zp = t_ext_powers(z, int(coeffs.shape[0]), coeffs.device)
    out = []
    for c in range(int(coeffs.shape[1])):
        s = (coeffs[:, c : c + 1] * zp % P).sum(dim=0) % P  # 2^26 terms below 2^31: no overflow
        out.append(tuple(int(v) for v in s.tolist()))
    return out


def _ext_t(a, like) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.tensor(a, dtype=torch.int64, device=like.device)


# -- the transform ---------------------------------------------------------------
def dft(coeffs: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The columns of ``coeffs`` (n, w) evaluated at g^0, ..., g^(n-1), g the
    order-n generator (its inverse, and the result over n, for ``inverse``):
    iterative radix-2 Cooley-Tukey on the bit-reversed input."""
    n = int(coeffs.shape[0])
    log_n = n.bit_length() - 1
    x = coeffs[bitrev(log_n, coeffs.device)]
    size = 2
    while size <= n:
        g = two_adic_gen(size.bit_length() - 1)
        tw = powers(inv(g) if inverse else g, size // 2, x.device)
        x = x.view(n // size, 2, size // 2, -1)
        v = x[:, 1] * tw[None, :, None] % P
        u = x[:, 0]
        x = torch.stack([(u + v) % P, (u - v) % P], dim=1).reshape(n, -1)
        size *= 2
    if inverse:
        x = x * inv(n) % P
    return x
