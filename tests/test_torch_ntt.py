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


@pytest.mark.parametrize("log_h", [1, 8, 9, 14, 20, 21, 22, 23, 24, 26])
@pytest.mark.parametrize("w", [1, 2, 3, 6, 8, 16, 33, 128, 257])
def test_plan_covers_every_stage_within_the_tile(log_h, w):
    p = ntt_kernel.plan(log_h, w)
    stages = list(range(p.k0)) + [s for s0, k, _ in p.passes for s in range(s0, s0 + k)]
    assert stages == list(range(log_h))
    ks = [p.k0] + [k for _, k, _ in p.passes]
    # a block's tile (2^k rows of 2^lanes_log words) is at most 64 KB, so
    # three blocks share an SM; as few passes as that allows, even
    max_k = ntt_kernel.TILE_LOG - p.lanes_log
    assert p.lanes_log == (5 if w >= 8 else 4)
    assert max(ks) <= max_k and max(ks) - min(ks) <= 1
    assert len(ks) == -(-log_h // max_k)
    if log_h in (17, 18):  # three passes of 8 stages before
        assert len(ks) == 2
    if 20 <= log_h <= 24:
        assert len(ks) == (2 if w < 8 and log_h == 20 else 3)
    lanes = 1 << p.lanes_log
    assert p.col_tiles == -(-w // lanes)
    # a tile row is one line of the matrix: `lanes` columns, or adjacent rows
    assert p.g_log <= log_h - p.k0 and w << p.g_log <= max(w, lanes)
    for v in (1, 2, 4):
        assert ntt_kernel.smem_bytes(p.k0, p.lanes_log, p.g_log, v) <= ntt_kernel.SMEM_LIMIT
    for s0, k, j_log in p.passes:
        assert k >= 1 and j_log <= s0 and w << j_log <= max(w, lanes)
        for v in (1, 2, 4):
            assert ntt_kernel.smem_bytes(k, p.lanes_log, j_log, v) <= ntt_kernel.SMEM_LIMIT


def test_twiddle_table_is_prefix_stable_and_matches_jax():
    tw = ntt_kernel.stage_twiddles(12, False, "cpu")
    jtw = jr._stage_twiddles_np(12, False)
    for s in range(12):
        m = 1 << s
        assert np.array_equal(bb.np_from_monty(bb.to_numpy(tw[m - 1 : 2 * m - 1])), jtw[s][0])
    small = ntt_kernel.stage_twiddles(5, False, "cpu")
    assert torch.equal(small[: (1 << 5) - 1], tw[: (1 << 5) - 1])


@pytest.mark.parametrize("inverse", [False, True])
def test_later_pass_twiddle_is_inner_times_twist(inverse):
    """The later-pass kernel builds the stage-(s0+l) twiddle of row
    t'*2^s0 + j as w_{2^(l+1)}^t' * w_{2^(s0+l+1)}^j from two table entries;
    checked against JAX's stage tables."""
    log_h = 14
    tw = ntt_kernel.stage_twiddles(log_h, inverse, "cpu")
    jtw = jr._stage_twiddles_np(log_h, inverse)
    rng = np.random.default_rng(3)
    for s0 in (1, 5, 7):
        for l in range(log_h - s0):
            t = torch.as_tensor(rng.integers(0, 1 << l, 16))
            j = torch.as_tensor(rng.integers(0, 1 << s0, 16))
            inner = tw[(1 << l) - 1 + t]
            twist = tw[(1 << (s0 + l)) - 1 + j]
            got = bb.np_from_monty(bb.to_numpy(bb.mul(inner, twist)))
            assert np.array_equal(got, jtw[s0 + l][0][((t << s0) + j).numpy()])


def test_passes_compose_to_the_transform():
    m = _t(_monty(8, (1 << 13, 3)))
    tw = ntt_kernel.stage_twiddles(13, True, "cpu")
    p = ntt_kernel.plan(13, 3)
    assert len(p.passes) == 1  # two passes
    x = ntt_kernel.pass0_plain(m, p.k0, tw)
    for s0, k, _ in p.passes:
        x = ntt_kernel.pass_plain(x, s0, k, tw)
    assert torch.equal(x, ntt_kernel.dft(m, inverse=True))
    assert torch.equal(x, ntt_kernel.dft_plain(m, inverse=True))


@pytest.mark.parametrize("max_stages", [1, 3, 5, 13])
def test_any_pass_split_gives_the_transform(max_stages):
    """The passes compose to the transform for any split of the stages, not
    only the plan's (the alternatives ``port_timing.py k2`` times)."""
    m = _t(_monty(11, (1 << 13, 2)))
    tw = ntt_kernel.stage_twiddles(13, False, "cpu")
    p = ntt_kernel.split(13, 2, ntt_kernel.NARROW_LANES_LOG, max_stages)
    assert 1 + len(p.passes) == -(-13 // max_stages)
    x = ntt_kernel.pass0(m, p, tw)
    for s0, k, j_log in p.passes:
        x = ntt_kernel.run_pass(x, s0, k, j_log, p, tw)
    assert torch.equal(x, ntt_kernel.dft(m))


def test_bit_reversal_matches_jax():
    m = _monty(9, (64, 3))
    assert np.array_equal(bb.to_numpy(reverse_matrix_index_bits(_t(m))), np.asarray(j_bitrev(jnp.asarray(m))))
    assert np.array_equal(bit_reversal_perm(7), j_bit_reversal_perm(7))


def test_dft_facade_is_pinned_to_its_device():
    dft = Dft(device="cpu")
    m = _t(_monty(10, (8, 2)))
    assert torch.equal(dft.dft_batch(m), radix2.dft_batch(m))
    with pytest.raises(ValueError):
        Dft("meta").dft_batch(m)
