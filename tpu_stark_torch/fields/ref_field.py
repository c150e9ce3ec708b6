"""Pure-python scalar BabyBear and BabyBear^4 — the host field of the
transcript and verifier, and the oracle of the device field ops.  Same code
as ``tpu_stark/fields/ref_field.py``, re-homed so the port needs no jax."""

from __future__ import annotations

from .babybear import P, TWO_ADICITY, two_adic_generator  # noqa: F401

W = 11


def fadd(a, b):
    return (a + b) % P


def fsub(a, b):
    return (a - b) % P


def fmul(a, b):
    return (a * b) % P


def finv(a):
    return pow(a, P - 2, P)


def fpow(a, e):
    return pow(a, e, P)


# --- quartic extension, coefficients little-endian, X^4 = W ---
def eadd(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def esub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def emul(a, b):
    c = [0] * 8
    for i in range(4):
        for j in range(4):
            c[i + j] = (c[i + j] + a[i] * b[j]) % P
    return tuple((c[k] + W * c[k + 4]) % P for k in range(4))


def escale(a, s):
    return tuple((x * s) % P for x in a)


def efrom_base(x):
    return (x % P, 0, 0, 0)


def epow(a, e):
    r = (1, 0, 0, 0)
    b = a
    while e:
        if e & 1:
            r = emul(r, b)
        e >>= 1
        b = emul(b, b)
    return r


def einv(a):
    # prod of conjugates / norm
    f = pow(W, (P - 1) // 4, P)

    def frob(x, j):
        return tuple((x[i] * pow(f, (i * j) % 4, P)) % P for i in range(4))

    b = emul(frob(a, 1), emul(frob(a, 2), frob(a, 3)))
    n = emul(a, b)
    assert n[1] == n[2] == n[3] == 0
    return escale(b, finv(n[0]))


def naive_dft(column, shift=1):
    """O(n^2) DFT of polynomial coefficients `column` over the coset
    shift * <g_n>, natural order: out[i] = sum_j c_j (shift g^i)^j."""
    n = len(column)
    g = two_adic_generator(n.bit_length() - 1)
    out = []
    for i in range(n):
        x = (shift * pow(g, i, P)) % P
        acc = 0
        xp = 1
        for c in column:
            acc = (acc + c * xp) % P
            xp = (xp * x) % P
        out.append(acc)
    return out
