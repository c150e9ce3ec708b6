"""The port's limb-matmul NTT (``tpu_stark_torch/ntt/mxu_ntt.py``, kernel
K5's plain versions on the CPU) and the narrow route through ``Dft``,
against the JAX package's ``mxu_ntt`` (its XLA path and its Pallas kernel
in interpret mode, as ``tests/test_mxu_ntt.py`` runs them) and against the
port's K2 route; and a numpy model of ``csrc/mxu_ntt.cu``'s index logic
(the table image, the raw tile's swizzle, the limb split, the wgmma
operands read through their descriptors, the two-step reduction and the
stores) against the plain versions.  Exact comparisons.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_stark.fields import babybear as jbb
from tpu_stark.ntt import mxu_ntt as jmxu
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.ntt import mxu_ntt, radix2
from tpu_stark_torch.ntt.dft import Dft


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tests here are CPU-bound torch work: two intra-op threads keep
    them off the cores that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


@pytest.mark.parametrize("b,a,r", [(16, 32, 1), (32, 32, 2), (64, 128, 3), (256, 512, 1)])
def test_fused_level_matches_jax_composition(b, a, r):
    """The inner level's plain version (and its wrapper on the CPU) against
    JAX's _dft_axis0 steps: the limb matmul, the twiddle product by
    _twiddle_monty(A, B).T and the moved axis."""
    x = _monty((b, a, r))
    for inverse in (False, True):
        t1 = jmxu._mod_matmul_axis(jnp.asarray(x), jnp.asarray(jmxu._dft_matrix_limbs(b, inverse)))
        tw = jnp.asarray(jmxu._twiddle_monty(a, b, inverse))
        want = np.asarray(jnp.moveaxis(jbb.mul(t1, tw.T.reshape(b, a, 1)), 1, 0))
        limbs = torch.from_numpy(mxu_ntt.dft_matrix_limbs(b, inverse))
        tw_t = mxu_ntt.twiddles_on(a, b, inverse, "cpu")
        assert tuple(tw_t.shape) == (a, b)
        got = mxu_ntt.mod_matmul_twiddle_moved_plain(_t(x), limbs, tw_t)
        assert got.shape == (a, b, r) and np.array_equal(bb.to_numpy(got), want)
        assert torch.equal(mxu_ntt.mod_matmul_twiddle_moved(_t(x), limbs, tw_t), got)


def test_dft_axis0_three_levels_matches_jax(monkeypatch):
    """dft_axis0 at 2^17 x 1 (256 x 512, then 16 x 32, then the 32-point
    leaf) through the two wrappers, one call a level, against JAX's
    _dft_axis0 on its XLA path and with its Pallas kernel in interpret
    mode; the route's height gate lowered, Dft's narrow route the same."""
    calls = []
    for name in ("mod_matmul_axis", "mod_matmul_twiddle_moved"):
        real = getattr(mxu_ntt, name)
        monkeypatch.setattr(mxu_ntt, name, lambda *args, _r=real, _n=name: calls.append(
            (_n, tuple(args[0].shape))) or _r(*args))
    monkeypatch.setattr(radix2, "NARROW_MIN_LOG_H", 4)
    x = _monty((1 << 17, 1))
    for inverse in (False, True):
        calls.clear()
        got = bb.to_numpy(mxu_ntt.dft_axis0(_t(x), inverse))
        assert calls == [("mod_matmul_twiddle_moved", (256, 512, 1)), ("mod_matmul_twiddle_moved", (16, 32, 256, 1)),
                         ("mod_matmul_axis", (32, 16, 256, 1))]
        assert np.array_equal(got, np.asarray(jmxu._dft_axis0(jnp.asarray(x), inverse)))
        pallas = jmxu._dft_axis0(jnp.asarray(x), inverse, use_pallas=True, interpret=True)
        assert np.array_equal(got, np.asarray(pallas))
    assert torch.equal(Dft("cpu", narrow="mxu").dft_batch(_t(x)), Dft("cpu").dft_batch(_t(x)))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """dtype, table shape, n outside 16-256, a non-contiguous x, the
    twiddles' shape, and a device that is neither the CPU nor CUDA."""
    def z(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    w16, tw = z((4, 16, 16), torch.uint8), z((8, 16))
    cases = [
        (TypeError, mxu_ntt.mod_matmul_axis, (z((16, 8), torch.int64), w16)),
        (ValueError, mxu_ntt.mod_matmul_axis, (z((16, 8)), z((4, 16, 8), torch.uint8))),
        (ValueError, mxu_ntt.mod_matmul_axis, (z((8, 8)), z((4, 8, 8), torch.uint8))),
        (ValueError, mxu_ntt.mod_matmul_axis, (z((512, 8)), z((4, 512, 512), torch.uint8))),
        (ValueError, mxu_ntt.mod_matmul_axis, (z((8, 16)).T, w16)),
        (ValueError, mxu_ntt.mod_matmul_axis, (z((16, 8)), w16)),
        (ValueError, mxu_ntt.mod_matmul_twiddle_moved, (z((16, 8, 2)), w16, z((16, 8)))),
        (ValueError, mxu_ntt.mod_matmul_twiddle_moved, (z((16, 8, 2)), w16, z((8, 16), torch.int64))),
        (ValueError, mxu_ntt.mod_matmul_twiddle_moved, (z((16, 8, 2)), w16, tw)),
    ]
    for err, fn, args in cases:
        with pytest.raises(err):
            fn(*args)


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
def test_kernel_table_image_layout(n):
    """Every byte of the table image where the kernel's descriptors read
    it: slice s, limb j, row c, k at s*4*NC*K + j*NC*K + (c//8)*8K +
    (k//16)*128 + (c%8)*16 + k%16, holding limb j of W*R mod p (zero past
    n)."""
    for inverse in (False, True):
        limbs = mxu_ntt.dft_matrix_limbs(n, inverse)
        image = mxu_ntt.kernel_image(torch.from_numpy(limbs)).numpy()
        k, nc = max(n, 32), mxu_ntt.slice_rows(n)
        assert image.shape == (4 * n * k,)
        w = sum(limbs[j].astype(np.uint64) << np.uint64(8 * j) for j in range(4))
        wr = (w << np.uint64(32)) % np.uint64(bb.P)
        j, c, kk = np.meshgrid(np.arange(4), np.arange(n), np.arange(k), indexing="ij")
        s_, cl = c // nc, c % nc
        off = s_ * 4 * nc * k + j * nc * k + (cl // 8) * 8 * k + (kk // 16) * 128 + (cl % 8) * 16 + kk % 16
        want = np.where(kk < n, (wr[np.minimum(kk, n - 1), c] >> (8 * j).astype(np.uint64)) & np.uint64(0xFF), 0)
        assert np.array_equal(image[off], want.astype(np.uint8))
        assert len(np.unique(off)) == off.size


# -- a model of csrc/mxu_ntt.cu ------------------------------------------------
_MU = 0x88000001  # p^-1 mod 2^32
_U = np.uint64


def _k5_geometry(n, a, r):
    g = dict(n=n, K=max(n, 32), TM=max(64, 8192 // n), NC=mxu_ntt.slice_rows(n), A=a, R=r, M=a * r)
    g["by_a"] = r < g["TM"]
    g["per_a"] = g["TM"] // r if g["by_a"] else -(-r // g["TM"])
    g["n_mtiles"] = -(-a // g["per_a"]) if g["by_a"] else a * g["per_a"]
    g["sbo"] = 8 * g["K"]
    g["plane"] = (g["TM"] // 8) * g["sbo"]
    return g


def _k5_tile(g, mt):
    if g["by_a"]:
        a0 = mt * g["per_a"]
        return a0, 0, min(g["per_a"], g["A"] - a0), g["R"]
    return mt // g["per_a"], (mt % g["per_a"]) * g["TM"], 1, min(g["TM"], g["R"] - (mt % g["per_a"]) * g["TM"])


def _k5_perm(x, y, sel):
    """__byte_perm(x, y, sel) on uint64 arrays holding u32 words."""
    b = np.stack([(x >> _U(8 * i)) & _U(0xFF) for i in range(4)] + [(y >> _U(8 * i)) & _U(0xFF) for i in range(4)])
    return sum(b[(sel >> (4 * p)) & 7] << _U(8 * p) for p in range(4))


def _k5_redc2(d):
    """reduce_diagonals: sum_s 2^(8s) d_s -> * 2^-64 mod p."""
    lo = d[0] + (d[1] << _U(8)) + (d[2] << _U(16)) + (d[3] << _U(24))
    v = d[4] + (d[5] << _U(8)) + (d[6] << _U(16)) + (lo >> _U(32))
    t1 = ((lo & _U(0xFFFFFFFF)) * _U(_MU)) & _U(0xFFFFFFFF)
    v1 = v + _U(bb.P) - ((t1 * _U(bb.P)) >> _U(32))
    t2 = ((v1 & _U(0xFFFFFFFF)) * _U(_MU)) & _U(0xFFFFFFFF)
    v2 = (v1 >> _U(32)) + _U(bb.P) - ((t2 * _U(bb.P)) >> _U(32))
    return np.where(v2 >= bb.P, v2 - _U(bb.P), v2)


def _k5_monty(a, b):
    t = a * b
    m = ((t & _U(0xFFFFFFFF)) * _U(_MU)) & _U(0xFFFFFFFF)
    u, hi = (m * _U(bb.P)) >> _U(32), t >> _U(32)
    return np.where(hi < u, hi + _U(bb.P) - u, hi - u)


def _k5_operand(buf, start, sbo, rows):
    """The canonical K-major no-swizzle wgmma operand of rows x 32 bytes at
    ``start``: (row, k) at (row // 8) * SBO + (k // 16) * LBO + (row % 8) * 16
    + k % 16, LBO = 128."""
    row, k = np.arange(rows)[:, None], np.arange(32)[None, :]
    return buf[start + (row // 8) * sbo + (k // 16) * 128 + (row % 8) * 16 + k % 16].astype(np.int64)


def _k5_model(x, w_limbs, tw):
    """out = the kernel's result for x (B, A, R) u32, as its index logic
    computes it; tw (A, B) or None (the leaf)."""
    n, a_, r_ = x.shape
    g = _k5_geometry(n, a_, r_)
    k_, tm, nc = g["K"], g["TM"], g["NC"]
    nw = 16 if n == 16 else 32
    image = mxu_ntt.kernel_image(w_limbs).numpy()
    xf, twf = x.reshape(-1).astype(_U), None if tw is None else tw.reshape(-1).astype(_U)
    out = np.full(x.size, 0xDEADBEEF, _U)
    lane = np.arange(32)
    for sl in range(n // nc):
        tab = image[sl * 4 * nc * k_:(sl + 1) * 4 * nc * k_]
        planes = np.zeros(4 * g["plane"] // 4, np.uint32)
        for mt in range(g["n_mtiles"]):
            a0, r0, na, nr = _k5_tile(g, mt)
            rows, m0 = na * nr, a0 * r_ + r0
            # cp.async: raw row b, 16-byte chunk c at chunk c ^ 2 * ((b >> 2) & 3), zero past the tile
            b, c, e = np.meshgrid(np.arange(n), np.arange(tm // 4), np.arange(4), indexing="ij")
            raw = np.zeros(n * tm, _U)
            i = 4 * c + e
            raw[b * tm + 4 * (c ^ (2 * ((b >> 2) & 3))) + e] = np.where(
                i < rows, xf[np.minimum(b * g["M"] + m0 + i, xf.size - 1)], 0)
            # the split: warp task (rg, kc), lane -> column rg*8 + lane%8, b-quad kc*4 + lane//8
            rg, kc, ln = np.meshgrid(np.arange(tm // 8), np.arange(n // 16), lane, indexing="ij")
            col, q = rg * 8 + (ln & 7), kc * 4 + (ln >> 3)
            v = [raw[(4 * q + e) * tm + 4 * ((col >> 2) ^ (2 * (q & 3))) + (col & 3)] for e in range(4)]
            word = rg * (g["sbo"] // 4) + kc * 32 + (ln & 7) * 4 + (ln >> 3)
            for limb in range(4):
                sel = limb | ((4 + limb) << 4)
                planes[limb * g["plane"] // 4 + word] = _k5_perm(
                    _k5_perm(v[0], v[1], sel), _k5_perm(v[2], v[3], sel), 0x5410)
            pb = planes.view(np.uint8)
            stage = np.zeros(tm * nc, _U)
            chunks = nc // nw
            for u in range((tm // 64) * chunks):
                row0, c0 = 64 * (u // chunks), nw * (u % chunks)
                d = np.zeros((7, 64, nw), np.int64)
                for ks in range(k_ // 32):
                    for i_ in range(4):
                        am = _k5_operand(pb, i_ * g["plane"] + (row0 // 8) * g["sbo"] + ks * 256, g["sbo"], 64)
                        for j in range(4):
                            bm = _k5_operand(tab, j * nc * k_ + (c0 // 8) * 8 * k_ + ks * 256, 8 * k_, nw)
                            d[i_ + j] += am @ bm.T
                val = _k5_redc2(d.astype(_U))
                # the accumulator fragment: warp wl, lane, register kr -> column i, output cl
                wl, ln, kr = np.meshgrid(np.arange(4), lane, np.arange(nw // 2), indexing="ij")
                i = row0 + 16 * wl + (ln >> 2) + 8 * ((kr >> 1) & 1)
                cl = c0 + 8 * (kr >> 2) + 2 * (ln & 3) + (kr & 1)
                ok = i < rows
                ia = np.where(ok, i // nr, 0) if g["by_a"] else np.zeros_like(i)
                ir = i - ia * nr
                vv = val[i - row0, cl - c0]
                if twf is not None:
                    vv = _k5_monty(vv, twf[np.minimum((a0 + ia) * n + sl * nc + cl, twf.size - 1)])
                if g["by_a"]:  # the staging tile in output order
                    stage[((ia * nc + cl) * nr + ir)[ok]] = vv[ok]
                else:
                    out[(a0 * n + sl * nc) * r_ + r0 + cl[ok] * r_ + i[ok]] = vv[ok]
            if g["by_a"]:  # 16-byte copies of each a's nc * nr contiguous outputs
                per_a = nc * nr
                idx = np.arange(0, per_a * na, dtype=np.int64)
                ia = (idx * (0xFFFFFFFF // per_a + 1)) >> 32
                out[(a0 * n + sl * nc) * r_ + ia * n * r_ + idx - ia * per_a] = stage[idx]
    return out.reshape(a_, n, r_).astype(np.uint32)


@pytest.mark.parametrize("n,a,r", [(16, 1, 70), (32, 1, 300), (16, 32, 1), (32, 32, 2), (64, 4, 5), (64, 16, 3),
                                   (128, 2, 70), (256, 4, 3), (256, 1, 65)])
def test_kernel_model_equals_plain(n, a, r):
    """The model of the kernel's index logic equals the plain versions:
    leaves (A = 1) and inner levels, tiles of whole a's and tiles of one
    a's columns, ragged tails, every n (the n = 256 table in four slices)."""
    x = RNG.integers(0, bb.P, size=(n, a, r), dtype=np.uint32)
    for inverse in (False, True):
        limbs = torch.from_numpy(mxu_ntt.dft_matrix_limbs(n, inverse))
        if a == 1:
            got = _k5_model(x, limbs, None).reshape(n, r)
            want = mxu_ntt.mod_matmul_axis_plain(_t(x.reshape(n, r)), limbs)
        else:
            tw = mxu_ntt.twiddle_monty(a, n, inverse)
            got = _k5_model(x, limbs, tw)
            want = mxu_ntt.mod_matmul_twiddle_moved_plain(_t(x), limbs, bb.to_tensor(tw, "cpu"))
        assert np.array_equal(got, bb.to_numpy(want))
