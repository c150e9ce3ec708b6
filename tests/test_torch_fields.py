"""BabyBear and BabyBear^4 on torch (tpu_stark_torch.fields) against the
JAX package's field ops on the same numpy inputs.  Integer field: every
comparison is exact (tolerance 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_stark.fields import babybear as jbb
from tpu_stark.fields import extension as jext
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.fields import extension as ext
from tpu_stark_torch.fields import ref_field as rf

EDGE = np.array([0, 1, 2, bb.P - 1, bb.P - 2, bb.MONTY_R, 1 << 30], dtype=np.uint32)


def _rand(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, bb.P, size=shape, dtype=np.uint32)


def _pair(seed, n=257):
    a = np.concatenate([EDGE, _rand(seed, (n,))])
    b = np.concatenate([EDGE[::-1], _rand(seed + 1, (n,))])
    return a, b


def _t(x):
    return bb.to_tensor(x, "cpu")


def _j(x):
    return jnp.asarray(x)


def _eq(got_t, want_j):
    assert np.array_equal(bb.to_numpy(got_t), np.asarray(want_j))


def test_constants_match():
    for name in ("P", "MU", "TWO_ADICITY", "GENERATOR", "MONTY_R", "MONTY_R2", "ROOT_27"):
        assert getattr(bb, name) == getattr(jbb, name), name
    assert ext.W == jext.W and ext.FROB == jext.FROB


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops(op):
    a, b = _pair(1)
    _eq(getattr(bb, op)(_t(a), _t(b)), getattr(jbb, op)(_j(a), _j(b)))


@pytest.mark.parametrize("op", ["neg", "inv", "to_u32", "from_u32"])
def test_unary_ops(op):
    a, _ = _pair(3)
    _eq(getattr(bb, op)(_t(a)), getattr(jbb, op)(_j(a)))


def test_shoup_mul():
    x, w = _pair(5)
    wp = jbb.np_shoup(w)
    got = bb.shoup_mul(_t(x), torch.from_numpy(w.astype(np.int64)), torch.from_numpy(wp.astype(np.int64)))
    _eq(got, jbb.shoup_mul(_j(x), _j(w), _j(wp)))


@pytest.mark.parametrize("e", [0, 1, 2, 7, 1 << 20, bb.P - 2])
def test_pow_const(e):
    a, _ = _pair(7)
    _eq(bb.pow_const(_t(a), e), jbb.pow_const(_j(a), e))


def test_powers_and_exponents():
    _eq(bb.powers_monty(bb.two_adic_generator(9), 1000, "cpu"),
        jbb.powers_monty(bb.two_adic_generator(9), 1000))
    e = np.random.default_rng(9).integers(0, 1 << 16, size=300, dtype=np.uint32)
    _eq(bb.pow_exponents(31, torch.from_numpy(e.astype(np.int64)), 16),
        jbb.pow_exponents(31, _j(e), 16))


@pytest.mark.parametrize("axis", [0, 1])
def test_sum_mod(axis):
    a = _rand(11, (37, 5))
    _eq(bb.sum_mod(_t(a), axis=axis), jbb.sum_mod(_j(a), axis=axis))


def test_host_helpers():
    x = _rand(13, (64,))
    assert np.array_equal(bb.np_to_monty(x), jbb.np_to_monty(x))
    assert np.array_equal(bb.np_from_monty(x), jbb.np_from_monty(x))
    assert np.array_equal(bb.np_shoup(x), jbb.np_shoup(x))
    assert np.array_equal(bb.np_powers(77, 100), jbb.np_powers(77, 100))
    for bits in range(0, 28):
        assert bb.two_adic_generator(bits) == jbb.two_adic_generator(bits)
    for v in (0, 1, 5, bb.P - 1):
        assert bb.host_to_monty(v) == jbb.host_to_monty(v)


def _ext_pair(seed, n=64):
    a = _rand(seed, (n, 4))
    b = _rand(seed + 1, (n, 4))
    a[0] = 0
    b[1] = 0
    a[2] = [bb.MONTY_R, 0, 0, 0]
    return a, b


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_ext_binary(op):
    a, b = _ext_pair(21)
    _eq(getattr(ext, op)(_t(a), _t(b)), getattr(jext, op)(_j(a), _j(b)))


def test_ext_mul_base_inv_frobenius():
    a, b = _ext_pair(23)
    s = b[:, 0]
    _eq(ext.mul_base(_t(a), _t(s)), jext.mul_base(_j(a), _j(s)))
    _eq(ext.inv(_t(a)), jext.inv(_j(a)))
    for j in range(4):
        _eq(ext.frobenius(_t(a), j), jext.frobenius(_j(a), j))


def test_ext_powers_device():
    z = (5, 7, 11, bb.P - 1)
    _eq(ext.powers_device(z, 77, "cpu"), jext.powers_device(z, 77))


def test_ext_mul_matches_scalar_oracle():
    a, b = _ext_pair(25, 8)
    got = bb.np_from_monty(bb.to_numpy(ext.mul(_t(a), _t(b))))
    ac, bc = bb.np_from_monty(a), bb.np_from_monty(b)
    for i in range(8):
        want = rf.emul(tuple(int(v) for v in ac[i]), tuple(int(v) for v in bc[i]))
        assert tuple(int(v) for v in got[i]) == want
