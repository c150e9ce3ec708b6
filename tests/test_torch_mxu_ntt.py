"""The port's limb-matmul NTT (``tpu_stark_torch/ntt/mxu_ntt.py``, kernel
K5's plain version on the CPU) and the narrow route through ``Dft``,
against the JAX package's ``mxu_ntt`` (its XLA path and its Pallas kernel
in interpret mode, as ``tests/test_mxu_ntt.py`` runs them) and against the
port's K2 route.  Exact comparisons.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_stark.ntt import mxu_ntt as jmxu
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.ntt import mxu_ntt, radix2
from tpu_stark_torch.ntt.dft import Dft

RNG = np.random.default_rng(5)


def _monty(shape) -> np.ndarray:
    return bb.np_to_monty(RNG.integers(0, bb.P, size=shape, dtype=np.uint32))


def _t(a: np.ndarray) -> torch.Tensor:
    return bb.to_tensor(a, "cpu")


@pytest.mark.parametrize("n", [2, 16, 32, 64, 128, 256])
def test_limb_tables_match_jax(n):
    for inverse in (False, True):
        want = np.asarray(jmxu._dft_matrix_limbs(n, inverse)).astype(np.float32).astype(np.uint8)
        got = mxu_ntt.dft_matrix_limbs(n, inverse)
        assert got.dtype == np.uint8 and got.shape == (4, n, n)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("a,b", [(2, 2), (32, 16), (256, 64), (512, 256)])
def test_twiddles_match_jax(a, b):
    for inverse in (False, True):
        assert np.array_equal(mxu_ntt.twiddle_monty(a, b, inverse), jmxu._twiddle_monty(a, b, inverse))


def test_reduce_3word_matches_jax():
    """Random words and the edges: zero, a high word that wraps the borrow,
    the largest value the reduction takes (2^64 p - 1)."""
    n = 4096
    w0 = RNG.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w1 = RNG.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w2 = RNG.integers(0, bb.P, n, dtype=np.uint32)
    top = (1 << 64) * bb.P - 1
    edges = [(0, 0, 0), (1, 0, 0), (0xFFFFFFFF, 0xFFFFFFFF, 0),
             (top & 0xFFFFFFFF, (top >> 32) & 0xFFFFFFFF, top >> 64)]
    for i, (a, b, c) in enumerate(edges):
        w0[i], w1[i], w2[i] = a, b, c
    want = np.asarray(jmxu._reduce_3word_monty(jnp.asarray(w0), jnp.asarray(w1), jnp.asarray(w2)))
    got = mxu_ntt.reduce_3word_monty_plain(*(torch.from_numpy(v.astype(np.int64)) for v in (w0, w1, w2)))
    assert np.array_equal(bb.to_numpy(got), want)
    value = [int(a) + (int(b) << 32) + (int(c) << 64) for a, b, c in zip(w0, w1, w2)]
    assert [int(v) for v in bb.to_numpy(got)[:64]] == [v * bb.R_INV % bb.P for v in value[:64]]


@pytest.mark.parametrize("n,m", [(16, 512), (64, 512), (256, 512), (32, 1024)])
def test_mod_matmul_matches_jax_xla_and_pallas(n, m):
    x = _monty((n, m))
    w = jmxu._dft_matrix_limbs(n, False)
    want = np.asarray(jmxu._mod_matmul_axis(jnp.asarray(x), jnp.asarray(w)))
    pallas = np.asarray(jmxu._mod_matmul_axis_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True))
    limbs = torch.from_numpy(mxu_ntt.dft_matrix_limbs(n, False))
    got = bb.to_numpy(mxu_ntt.mod_matmul_axis_plain(_t(x), limbs))
    assert np.array_equal(want, pallas)
    assert np.array_equal(got, want)
    # the wrapper runs the plain version for a CPU tensor
    assert np.array_equal(bb.to_numpy(mxu_ntt.mod_matmul_axis(_t(x), limbs)), want)


def test_mod_matmul_trailing_axes_and_ragged_width():
    x = _monty((64, 3, 7))  # M = 21, not a multiple of any tile
    w = jmxu._dft_matrix_limbs(64, True)
    want = np.asarray(jmxu._mod_matmul_axis(jnp.asarray(x), jnp.asarray(w)))
    got = mxu_ntt.mod_matmul_axis(_t(x), torch.from_numpy(mxu_ntt.dft_matrix_limbs(64, True)))
    assert got.shape == (64, 3, 7) and np.array_equal(bb.to_numpy(got), want)


def test_mod_matmul_wrapper_rejects_other_devices():
    x = torch.zeros((16, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        mxu_ntt.mod_matmul_axis(x, torch.zeros((4, 16, 16), dtype=torch.uint8, device="meta"))


@pytest.mark.parametrize("h,w", [(1 << 16, 2), (1 << 17, 4)])
def test_narrow_route_matches_jax_and_k2(h, w):
    """Dft(narrow="mxu") forward, inverse and coset LDE against JAX's
    mxu_ntt and the K2 route."""
    x = _monty((h, w))
    mxu, k2 = Dft("cpu", narrow="mxu"), Dft("cpu")
    fwd = mxu.dft_batch(_t(x))
    inv = mxu.idft_batch(_t(x))
    assert np.array_equal(bb.to_numpy(fwd), np.asarray(jmxu.dft_batch(jnp.asarray(x))))
    assert np.array_equal(bb.to_numpy(inv), np.asarray(jmxu.idft_batch(jnp.asarray(x))))
    assert torch.equal(fwd, k2.dft_batch(_t(x)))
    assert torch.equal(inv, k2.idft_batch(_t(x)))
    small = _t(x[: h // 2])  # LDE of h/2 rows onto h: both transforms on the route
    assert torch.equal(mxu.coset_lde_batch(small, 1, bb.GENERATOR), k2.coset_lde_batch(small, 1, bb.GENERATOR))


def test_route_gates(monkeypatch):
    """Only w <= 32 and h >= 2^16 take the limb-matmul NTT."""
    calls = []
    real = mxu_ntt.dft_axis0

    def counted(x, inverse):
        calls.append((tuple(x.shape), inverse))
        return real(x, inverse)

    monkeypatch.setattr(mxu_ntt, "dft_axis0", counted)
    dft = Dft("cpu", narrow="mxu")
    for h, w in [(1 << 15, 2), (1 << 16, 33), (1 << 16, 32)]:
        x = _t(_monty((h, w)))
        calls.clear()
        assert torch.equal(dft.dft_batch(x), Dft("cpu").dft_batch(x))
        assert bool(calls) == (h >= 1 << radix2.NARROW_MIN_LOG_H and w <= radix2.NARROW_MAX_W)
    calls.clear()
    Dft("cpu").idft_batch(_t(_monty((1 << 16, 2))))
    assert not calls
    with pytest.raises(ValueError):
        Dft("cpu", narrow="vpu4")
    assert mxu_ntt.supports(2, 1) and mxu_ntt.supports(1 << 27, 1) and not mxu_ntt.supports(1, 1)
