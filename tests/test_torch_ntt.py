"""K2 (the fused-stage NTT) through its plain torch passes, against the JAX
package: ``radix2`` (dft, idft, coset, LDE) and the Pallas fused-stage
kernel K2 replaces, ``pallas_ntt.ntt_from_bitrev``, in interpret mode.
Field values: exact comparison."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_stark.fields import babybear as jbb
from tpu_stark.matrix import bit_reversal_perm as j_bit_reversal_perm
from tpu_stark.matrix import reverse_matrix_index_bits as j_bitrev
from tpu_stark.ntt import pallas_ntt
from tpu_stark.ntt import radix2 as jr
from tpu_stark.ntt import reference as jref
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.matrix import bit_reversal_perm, reverse_matrix_index_bits
from tpu_stark_torch.ntt import ntt_kernel, radix2
from tpu_stark_torch.ntt.dft import Dft


def _monty(seed, shape):
    return np.random.default_rng(seed).integers(0, bb.P, size=shape, dtype=np.uint32)


def _t(x):
    return bb.to_tensor(x, "cpu")


WIDTHS = (1, 2, 8, 16, 128)


@functools.lru_cache(maxsize=None)
def _jax_transforms(log_h):
    """JAX dft/idft of one (2^log_h, sum(WIDTHS)) matrix: columns transform
    independently, so one JAX program per height serves every width."""
    m = _monty(log_h, (1 << log_h, sum(WIDTHS)))
    return m, np.asarray(jr.dft_batch(jnp.asarray(m))), np.asarray(jr.idft_batch(jnp.asarray(m)))


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("log_h", list(range(1, 13)))
def test_dft_idft_match_jax(log_h, w):
    m, fwd, inv = _jax_transforms(log_h)
    c0 = sum(WIDTHS[: WIDTHS.index(w)])
    cols = slice(c0, c0 + w)
    tm = _t(np.ascontiguousarray(m[:, cols]))
    assert np.array_equal(bb.to_numpy(radix2.dft_batch(tm)), fwd[:, cols])
    assert np.array_equal(bb.to_numpy(radix2.idft_batch(tm)), inv[:, cols])


@pytest.mark.parametrize("log_h,w", [(1, 1), (4, 2), (7, 8), (8, 16)])
def test_coset_and_lde_match_jax(log_h, w):
    m = _monty(log_h + 77, (1 << log_h, w))
    jm, tm = jnp.asarray(m), _t(m)
    shift = jbb.GENERATOR
    assert np.array_equal(bb.to_numpy(radix2.coset_dft_batch(tm, shift)), np.asarray(jr.coset_dft_batch(jm, shift)))
    assert np.array_equal(bb.to_numpy(radix2.coset_idft_batch(tm, shift)), np.asarray(jr.coset_idft_batch(jm, shift)))
    assert np.array_equal(
        bb.to_numpy(radix2.coset_lde_batch(tm, 2, shift)), np.asarray(jr.coset_lde_batch(jm, 2, shift))
    )
    assert np.array_equal(bb.to_numpy(radix2.lde_batch(tm, 1)), np.asarray(jr.lde_batch(jm, 1)))


def test_matches_pallas_fused_stage_kernel_interpret():
    """At the shape the TPU kernel was built for, (512, 128)."""
    m = _monty(5, (512, 128))
    want = np.asarray(pallas_ntt.ntt_from_bitrev(j_bitrev(jnp.asarray(m)), interpret=True))
    assert np.array_equal(bb.to_numpy(radix2.dft_batch(_t(m))), want)


def test_matches_naive_dft():
    m = _monty(6, (16, 3))
    got = bb.np_from_monty(bb.to_numpy(radix2.dft_batch(_t(m))))
    assert np.array_equal(got, jref.naive_dft_matrix(bb.np_from_monty(m)))


@pytest.mark.parametrize("log_h", [1, 8, 9, 14, 20, 23, 26])
@pytest.mark.parametrize("w", [1, 2, 3, 6, 8, 16, 33, 128])
def test_plan_covers_every_stage_within_the_tile(log_h, w):
    p = ntt_kernel.plan(log_h, w)
    stages = list(range(p.k0)) + [s for s0, k, _ in p.passes for s in range(s0, s0 + k)]
    assert stages == list(range(log_h))
    assert p.wc == min(w, ntt_kernel.MAX_WC)
    assert p.wc << (p.k0 + p.g_log) <= ntt_kernel.SMEM_WORDS
    assert p.g_log <= log_h - p.k0
    for s0, k, j_log in p.passes:
        assert k >= 1 and j_log <= s0
        assert p.wc << (k + j_log) <= ntt_kernel.SMEM_WORDS


def test_twiddle_table_is_prefix_stable_and_matches_jax():
    tw, twp = ntt_kernel.stage_twiddles(12, False, "cpu")
    jtw = jr._stage_twiddles_np(12, False)
    for s in range(12):
        m = 1 << s
        assert np.array_equal(bb.to_numpy(tw[m - 1 : 2 * m - 1]), jtw[s][0])
        assert np.array_equal(bb.to_numpy(twp[m - 1 : 2 * m - 1]), jtw[s][1])
    small, _ = ntt_kernel.stage_twiddles(5, False, "cpu")
    assert torch.equal(small[: (1 << 5) - 1], tw[: (1 << 5) - 1])


def test_passes_compose_to_the_transform():
    m = _t(_monty(8, (1 << 11, 3)))
    tw, twp = ntt_kernel.stage_twiddles(11, True, "cpu")
    p = ntt_kernel.plan(11, 3)
    x = ntt_kernel.pass0_plain(m, p.k0, tw, twp)
    for s0, k, _ in p.passes:
        x = ntt_kernel.pass_plain(x, s0, k, tw, twp)
    assert torch.equal(x, ntt_kernel.dft(m, inverse=True))
    assert torch.equal(x, ntt_kernel.dft_plain(m, inverse=True))


def test_bit_reversal_matches_jax():
    m = _monty(9, (64, 3))
    assert np.array_equal(bb.to_numpy(reverse_matrix_index_bits(_t(m))), np.asarray(j_bitrev(jnp.asarray(m))))
    assert np.array_equal(bit_reversal_perm(7), j_bit_reversal_perm(7))


def test_dft_facade_is_pinned_to_its_device():
    dft = Dft("cpu")
    m = _t(_monty(10, (8, 2)))
    assert torch.equal(dft.dft_batch(m), radix2.dft_batch(m))
    with pytest.raises(ValueError):
        Dft("meta").dft_batch(m)
