"""K9-K11, the open phase's PCS arithmetic (``commit/open_kernel.py``,
``csrc/open.cu``), on the CPU:

(a) the plain versions against the JAX package's XLA programs, bit for bit,
    on numpy-seeded Monty inputs: ``_combine_columns`` and
    ``_reduced_quotient`` (K9), ``_eval_at_point`` (K10), ``_fold_codeword``
    (K11), at heights 2^3 to 2^12 and widths 1, 2, 7, 64 and 65, at one and
    two points; row blocks (``row0``, ``r0``) against the slice of the
    whole, natural row order against the bit-reversed codeword, a group of
    operands against their concatenation;
(b) ``csrc/open.cu`` compiled with g++ under the host shim of
    ``cuda_host.py``, its per-item device functions looped over by host
    entry points with the card's C names: each wrapper's kernel path
    (through the host library) against its plain version, in both row
    orders, the no-point, dividing and ext-sum modes, operand groups (up
    to a launch's 32), several K10 row blocks and point pairs, K11's fused
    add, and the run of 8 rows a thread that row0 allows;
(c) whole proves routed through those emulated wrappers with every plain
    version made to raise: a fib zk prove and a streamed keccak-air zk prove
    give the JAX fixtures' bytes.
"""

import ctypes
import hashlib
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_host import gxx, shim_dir
from tpu_stark.commit import pcs as jpcs
from tpu_stark.fields import babybear as jbb
from tpu_stark.fields import extension as jext
from tpu_stark_torch import kernels
from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
from tpu_stark_torch.air.keccak_air import KeccakAir, generate_trace
from tpu_stark_torch.commit import open_kernel as ok
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.fields import extension as ext4
from tpu_stark_torch.fields import ref_field as rf
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.proof import serialize_proof
from tpu_stark_torch.prover.prove import prove
from tpu_stark_torch.fri.domains import TwoAdicCoset
from tpu_stark_torch.ntt.dft import Dft
from tpu_stark_torch.prover.wide import WideMatrixSource, prove_wide

GOLDEN = pathlib.Path(__file__).parent / "golden"
P = bb.P


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """CPU-bound torch work: two intra-op threads keep it off the cores
    that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _monty(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint32)


def _t(a):
    return bb.to_tensor(np.ascontiguousarray(a), "cpu")


def _point(rng):
    return tuple(int(v) for v in rng.integers(0, P, size=4))


def _canon(m):
    return tuple(int(v) for v in bb.np_from_monty(np.asarray(m, dtype=np.uint32)))


def _mz(z):
    return bb.np_to_monty(np.array(z, dtype=np.uint32))


def _ypts(log_h):
    g = bb.two_adic_generator(log_h)
    return bb.np_to_monty(np.array([pow(g, ok._bit_reverse(i, log_h), P) for i in range(1 << log_h)],
                                   dtype=np.uint32))


def _zpow(z, h, r0=0):
    rows, cur = [], rf.epow(z, r0)
    for _ in range(h):
        rows.append(cur)
        cur = rf.emul(cur, z)
    return bb.np_to_monty(np.array(rows, dtype=np.uint32))


def _j(a):
    return np.asarray(a).astype(np.uint32)


# ---------------------------------------------------------------------------
# (a) the plain versions against JAX
# ---------------------------------------------------------------------------
SHAPES = [(3, 1), (5, 2), (7, 7), (9, 64), (12, 65), (12, 2)]


@pytest.mark.parametrize("log_h,w", SHAPES)
def test_reduced_opening_plain_equals_jax(log_h, w):
    """K9's plain version, with a point and without, equals JAX's
    ``_reduced_quotient`` and ``_combine_columns`` (the opened sum passed as
    its canonical value, as the open loop passes the host's ``_dot_ext``)."""
    rng = np.random.default_rng(log_h * 100 + w)
    h = 1 << log_h
    mat, apows_m, p_z = _monty(rng, (h, w)), _monty(rng, (w, 4)), _monty(rng, (w, 4))
    z = _point(rng)
    s_m = _j(jbb.sum_mod(jext.mul(jnp.asarray(apows_m), jnp.asarray(p_z)), axis=0))
    want_q = _j(jpcs._reduced_quotient(jnp.asarray(mat), jnp.asarray(apows_m), jnp.asarray(p_z),
                                       jnp.asarray(_mz(z)), jnp.asarray(_ypts(log_h))))
    want_c = _j(jpcs._combine_columns(jnp.asarray(mat), jnp.asarray(apows_m)))
    acc = _monty(rng, (h, 4))
    got_q = ok.reduced_opening_plain(_t(acc), [_t(mat)], _t(apows_m), log_h, 0, [(z, _canon(s_m))])
    got_c = ok.reduced_opening_plain(_t(np.zeros((h, 4), np.uint32)), [_t(mat)], _t(apows_m), log_h)
    assert np.array_equal(bb.to_numpy(got_q), (acc.astype(np.uint64) + want_q) % P)
    assert np.array_equal(bb.to_numpy(got_c), want_c)


@pytest.mark.parametrize("log_h,w", SHAPES)
def test_eval_at_points_plain_equals_jax(log_h, w):
    """K10's plain version at one and two points equals JAX's
    ``_eval_at_point``; row blocks from r0 sum to the whole."""
    rng = np.random.default_rng(log_h * 7 + w)
    h = 1 << log_h
    coeffs = _monty(rng, (h, w))
    zs = [_point(rng), _point(rng)]
    want = [_j(jpcs._eval_at_point(jnp.asarray(coeffs), jnp.asarray(_zpow(z, h)))) for z in zs]
    assert np.array_equal(bb.to_numpy(ok.eval_at_points_plain(_t(coeffs), zs[:1]))[0], want[0])
    both = ok.eval_at_points_plain(_t(coeffs), zs)
    assert np.array_equal(bb.to_numpy(both), np.stack(want))
    blocks = torch.zeros((2, w, 4), dtype=torch.int32)
    m = max(1, h // 4)
    for r0 in range(0, h, m):  # the rank blocks of the sharded evaluation
        ok.eval_at_points_plain(_t(coeffs[r0 : r0 + m]), zs, r0, blocks)
    assert torch.equal(blocks, both)


@pytest.mark.parametrize("log_h", [3, 6, 9, 12])
def test_fri_fold_plain_equals_jax(log_h):
    """K11's plain version equals JAX's ``_fold_codeword``; a row block from
    row0 folds to the whole fold's rows, and the add joins them."""
    rng = np.random.default_rng(log_h)
    h = 1 << log_h
    cw = _monty(rng, (h, 4))
    beta = _point(rng)
    want = _j(jpcs._fold_codeword(jnp.asarray(cw), jnp.asarray(_mz(beta)), log_h))
    assert np.array_equal(bb.to_numpy(ok.fri_fold_plain(_t(cw), beta, log_h)), want)
    row0, n = h // 2, h // 4
    add = _monty(rng, (n // 2, 4))
    got = ok.fri_fold_plain(_t(cw[row0 : row0 + n]), beta, log_h, row0, _t(add))
    assert np.array_equal(bb.to_numpy(got), (want[row0 // 2 : (row0 + n) // 2].astype(np.uint64) + add) % P)


@pytest.mark.parametrize("log_h,row0,rows", [(6, 16, 16), (10, 256, 512), (12, 1000, 24)])
def test_reduced_opening_plain_rows_orders_and_groups(log_h, row0, rows):
    """K9's plain version over the rows [row0, row0 + rows) equals the
    whole's rows; natural order reads the natural codeword through the bit
    reversal; a group of operands is their concatenation; an ext sum joins
    the column sum."""
    rng = np.random.default_rng(row0)
    h = 1 << log_h
    parts = [_monty(rng, (h, w)) for w in (3, 1, 5)]
    whole = np.concatenate(parts, axis=1)
    apows = _t(_monty(rng, (9, 4)))
    point = [(_point(rng), _point(rng))]
    full = ok.reduced_opening_plain(_t(np.zeros((h, 4), np.uint32)), [_t(whole)], apows, log_h, 0, point)
    sl = slice(row0, row0 + rows)
    got = ok.reduced_opening_plain(_t(np.zeros((rows, 4), np.uint32)), [_t(p[sl]) for p in parts], apows, log_h,
                                   row0, point)
    assert torch.equal(got, full[sl])
    natural = [p[[ok._bit_reverse(i, log_h) for i in range(h)]] for p in parts]
    got_n = ok.reduced_opening_plain(_t(np.zeros((rows, 4), np.uint32)), [_t(p) for p in natural], apows, log_h,
                                     row0, point, natural=True)
    assert torch.equal(got_n, full[sl])
    ext = _t(bb.to_numpy(ok.reduced_opening_plain(_t(np.zeros((rows, 4), np.uint32)), [_t(parts[0][sl])],
                                                  apows[:3], log_h, row0)))
    got_e = ok.reduced_opening_plain(_t(np.zeros((rows, 4), np.uint32)), [_t(p[sl]) for p in parts[1:]],
                                     apows[3:], log_h, row0, point, ext_in=ext)
    assert torch.equal(got_e, full[sl])


# ---------------------------------------------------------------------------
# (b) csrc/open.cu on the host
# ---------------------------------------------------------------------------
HOST = """
#include <vector>
#include "open.cu"
// K9's blocks one after another (a grid of at most two, so that a block
// walks several tiles), each block's threads one after another between the
// kernel's barriers: the constants, then each item staged before the one
// before it is summed, as the double buffer runs
template <int R, int NS, int NP>
static void k9_blocks(const OpeningArgs& a) {
  std::vector<uint32_t> sm(k9_smem_words(a) + 4);
  const int64_t tiles = k9_tiles(a), nb = tiles < 2 ? tiles : 2;
  for (int64_t b = 0; b < nb; ++b) {
    for (int t = 0; t < kThreads; ++t) k9_prologue(a, sm.data(), t);
    std::vector<K9Sums<R, NS>> st(kThreads);
    for (auto& s : st)
      for (int r = 0; r < R; ++r)
        for (int k = 0; k < NS; ++k) s.c[r][k] = ts::ext_zero();
    const int64_t items = k9_items(a, b, nb);
    int64_t s_seq = 0, c_seq = 0;
    int s_u = 0, c_u = 0;
    if (items > 0) {
      for (int t = 0; t < kThreads; ++t) k9_stage(a, sm.data(), b, nb, s_seq, s_u, 0, t);
      k9_next(a, s_seq, s_u);
    }
    for (int64_t j = 0; j < items; ++j) {
      if (j + 1 < items) {
        for (int t = 0; t < kThreads; ++t) k9_stage(a, sm.data(), b, nb, s_seq, s_u, int((j + 1) & 1), t);
        k9_next(a, s_seq, s_u);
      }
      for (int t = 0; t < kThreads; ++t) k9_compute<R, NS, NP>(a, sm.data(), b, nb, c_seq, c_u, int(j & 1), t, st[t]);
      k9_next(a, c_seq, c_u);
    }
  }
}
template <int NS, int NP>
static void k9_rows(const OpeningArgs& a) {
  const int rr = 1 << a.log_r;
  if (rr == 8) { if (NS == 1) k9_blocks<8, 1, NP>(a); }
  else if (rr == 4) k9_blocks<4, NS, NP>(a);
  else if (rr == 2) k9_blocks<2, NS, NP>(a);
  else k9_blocks<1, NS, NP>(a);
}
extern "C" int ts_reduced_opening(const int64_t* w, const uint32_t* k, void*) {
  const OpeningArgs a = unpack_opening(w, k);
  if (a.rows <= 0) return 0;
  if (a.nops > kMaxOps || a.nunits < 1 || a.nunits > kMaxUnits || a.log_r < 0 || a.log_r > 3 || a.nsum < 1 ||
      a.nsum > 2 || (1 << a.log_r) * a.nsum > 8 || a.npts < 0 || a.npts > 2 || (a.nsum == 2 && a.npts == 1) ||
      (a.npts == 0 && a.log_r != 0) || a.swp % 4 || k9_smem_words(a) * 4 > 232448)
    return 1;
  if (a.npts == 0) { if (a.nsum == 2) k9_blocks<1, 2, 0>(a); else k9_blocks<1, 1, 0>(a); }
  else if (a.nsum == 2) k9_rows<2, 2>(a);
  else if (a.npts == 2) k9_rows<1, 2>(a);
  else k9_rows<1, 1>(a);
  return 0;
}
// K10's warp items one after another, their lanes summed as the shuffles
// sum them; then the second pass, a warp's lanes then their sum
template <int NP, int CB>
static void k10_items(const PointsArgs& a, const uint32_t* sm) {
  for (int64_t it = 0; it < a.nrange * a.ncg; ++it) {
    Ext sum[NP][CB];
    for (int p = 0; p < NP; ++p)
      for (int j = 0; j < CB; ++j) sum[p][j] = ts::ext_zero();
    for (int lane = 0; lane < 32; ++lane) {
      Ext v[NP][CB];
      points_lane<NP, CB>(a, sm, it, lane, v);
      for (int p = 0; p < NP; ++p)
        for (int j = 0; j < CB; ++j) sum[p][j] = ts::ext_add(sum[p][j], v[p][j]);
    }
    for (int p = 0; p < NP; ++p)
      for (int j = 0; j < CB; ++j) points_partial(a, it, p, j, sum[p][j]);
  }
}
extern "C" int ts_eval_at_points(const int64_t* w, const uint32_t* k, void*) {
  const PointsArgs a = unpack_points(w, k);
  if (a.h <= 0 || a.w <= 0) return 0;
  if (a.npts < 1 || a.npts > 2 || (a.cb != 1 && a.cb != 2 && a.cb != 4) || a.log_k < 0 || a.log_k > kMaxLogK ||
      a.ncg * a.cb < a.w || (a.nrange << (5 + a.log_k)) < a.h)
    return 1;
  std::vector<uint32_t> sm(4 * ((2 << kMaxLogK) + 64));
  for (int t = 0; t < kThreads; ++t) k10_prologue(a, sm.data(), t);
  if (a.npts == 2) {
    if (a.cb == 4) k10_items<2, 4>(a, sm.data()); else if (a.cb == 2) k10_items<2, 2>(a, sm.data());
    else k10_items<2, 1>(a, sm.data());
  } else {
    if (a.cb == 4) k10_items<1, 4>(a, sm.data()); else if (a.cb == 2) k10_items<1, 2>(a, sm.data());
    else k10_items<1, 1>(a, sm.data());
  }
  for (int64_t g = 0; g < a.npts * a.w * 4; ++g) {
    uint32_t s = 0;
    for (int lane = 0; lane < 32; ++lane) s = ts::add_mod(s, points_sum_lane(a, g, lane));
    points_store(a, g, s);
  }
  return 0;
}
extern "C" int ts_fri_fold(const int64_t* w, const uint32_t* k, void*) {
  const FoldArgs a = unpack_fold(w, k);
  if (a.half <= 0) return 0;
  const int64_t items = fold_items(a);
  for (int64_t g = 0; g < items; ++g) {
    if (a.log_r == 3) fold_item<8>(a, g); else fold_item<1>(a, g);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``csrc/open.cu`` as a host library with the card's entry points."""
    lib = gxx(shim_dir(tmp_path_factory.mktemp("open_host")), "open_host", HOST)
    for entry in (lib.ts_reduced_opening, lib.ts_eval_at_points, lib.ts_fri_fold):
        entry.argtypes, entry.restype = [ctypes.c_void_p] * 3, ctypes.c_int
    return lib


@pytest.fixture
def emulated(host_lib, monkeypatch):
    """The wrappers take their kernel path on CPU tensors, through the host
    library; the plain versions refuse to run.  Returns the plain ones."""
    plain = {name: getattr(ok, name) for name in ("reduced_opening_plain", "eval_at_points_plain", "fri_fold_plain")}
    monkeypatch.setattr(ok, "_on_card", lambda t: True)
    monkeypatch.setattr(kernels, "lib", lambda: host_lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: None)

    def refuse(*args, **kw):
        raise AssertionError("a plain open version ran on the kernel path")

    for name in plain:
        monkeypatch.setattr(ok, name, refuse)
    kernels.reset_launch_counts()
    return plain


# z in F_p^4 at random, in F_p (coefficients 1-3 zero) and in F_p^2 (the
# elements fixed by the square of the Frobenius: coefficients 1 and 3 zero)
DIVISION_Z = {
    "random": lambda rng: _point(rng),
    "base": lambda rng: (int(rng.integers(0, P)), 0, 0, 0),
    "quadratic": lambda rng: (int(rng.integers(0, P)), 0, int(rng.integers(1, P)), 0),
}


@pytest.mark.parametrize("kind", list(DIVISION_Z))
def test_division_poly_inverts_y_minus_z(kind):
    """K9's base-field division: for y in F_p, q_z(y) / chi_z(y) is the
    extension inverse of y - z (``ext4.inv``), and chi_z(y) = 0 only at
    y = z, where the plain inverse gives 0 as K9 does."""
    rng = np.random.default_rng(len(kind))
    for _ in range(10):
        z = DIVISION_Z[kind](rng)
        chi, q = ok.division_poly(z)
        ys = [int(v) for v in rng.integers(0, P, size=8)] + ([z[0]] if kind == "base" else [])
        for y in ys:
            chi_y = (y ** 4 + chi[3] * y ** 3 + chi[2] * y ** 2 + chi[1] * y + chi[0]) % P
            q_y = rf.eadd(rf.eadd(rf.efrom_base(y ** 3), rf.escale(q[2], y * y)), rf.eadd(rf.escale(q[1], y), q[0]))
            d = rf.esub(rf.efrom_base(y), z)
            assert rf.emul(d, q_y) == rf.efrom_base(chi_y)  # (y - z) q_z(y) = chi_z(y)
            want = bb.to_numpy(ext4.inv(_t(bb.np_to_monty(np.array([d], dtype=np.uint32)))))[0]
            if chi_y == 0:
                assert d == (0, 0, 0, 0) and not want.any()
                continue
            assert rf.escale(q_y, pow(chi_y, P - 2, P)) == rf.einv(d) == _canon(want)


def _scaled(apows: torch.Tensor, scale) -> torch.Tensor:
    """Every row of (n, 4) Monty ``apows`` times the canonical ``scale``."""
    return ext4.mul(apows, ext4.scalar(scale, "cpu")[None, :])


# (log_h, row0, rows, operand widths, natural, mode, ext sum): a lone matrix
# (one table, the second point's sum scaled) and a group (a plane a point),
# both row orders, row0 off a multiple of 256, the ext sum alone (the
# streamed division) and beside columns, slabs of a wide operand, more
# operands than a launch takes
K9_TWO_POINT_CASES = {
    "lone-scaled": (10, 0, 1024, (2,), False, "scaled", False),
    "lone-scaled-natural": (10, 0, 1024, (7,), True, "scaled", False),
    "lone-scaled-row0": (10, 96, 200, (2,), False, "scaled", False),
    "ext-sum-alone-scaled": (9, 0, 512, (), False, "scaled", True),
    "ext-sum-and-columns-scaled": (9, 128, 256, (3, 1), False, "scaled", True),
    "wide-scaled": (9, 256, 256, (70,), False, "scaled", False),
    "group-planes": (11, 512, 768, (3, 1, 5, 2), False, "planes", False),
    "group-planes-natural-ext": (10, 100, 300, (4, 8), True, "planes", True),
    "more-operands-planes": (7, 0, 128, (1,) * 33 + (2,), False, "planes", False),
    "more-operands-scaled-natural-ext": (8, 0, 256, (2, 1, 4) * 23, True, "scaled", True),
}


def _two_point_case(case):
    log_h, row0, rows, widths, natural, mode, with_ext = K9_TWO_POINT_CASES[case]
    rng = np.random.default_rng(len(case) * 17 + rows)
    n_rows = 1 << log_h if natural else rows
    mats = []
    for k, w in enumerate(widths):
        m = _t(_monty(rng, (n_rows, w + 2 * (k % 2))))
        mats.append(m[:, 1 : 1 + w] if k % 2 else m)
    width = sum(widths)
    points = [(_point(rng), _point(rng)), (_point(rng), _point(rng))]
    acc = _t(_monty(rng, (rows, 4)))
    if mode == "planes":
        apows = _t(_monty(rng, (2, width, 4)))
        ext = _t(_monty(rng, (2, rows, 4))) if with_ext else None
        scales, per_point = None, [(apows[p], None if ext is None else ext[p]) for p in range(2)]
    else:
        apows = _t(_monty(rng, (width, 4)))
        ext = _t(_monty(rng, (rows, 4))) if with_ext else None
        scales = [_point(rng), _point(rng)]
        per_point = [(_scaled(apows, c), None if ext is None else _scaled(ext, c)) for c in scales]
    return log_h, row0, mats, natural, points, acc, apows, ext, scales, per_point


@pytest.mark.parametrize("case", list(K9_TWO_POINT_CASES))
def test_plain_k9_two_points_equal_two_one_point_calls(case):
    """K9's plain version at two points (a plane a point, or one table and
    a scale a point) equals two one-point calls."""
    log_h, row0, mats, natural, points, acc, apows, ext, scales, per_point = _two_point_case(case)
    want = acc.clone()
    for (ap, ex), pt in zip(per_point, points):
        ok.reduced_opening_plain(want, mats, ap, log_h, row0, [pt], natural, ex)
    got = ok.reduced_opening_plain(acc.clone(), mats, apows, log_h, row0, points, natural, ext, scales)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", list(K9_TWO_POINT_CASES))
def test_host_k9_two_points_equal_two_one_point_calls(emulated, case):
    """K9's host build reads a group once for both points and equals two
    one-point plain calls (the launches: one, or the operand split's)."""
    log_h, row0, mats, natural, points, acc, apows, ext, scales, per_point = _two_point_case(case)
    want = acc.clone()
    for (ap, ex), pt in zip(per_point, points):
        emulated["reduced_opening_plain"](want, mats, ap, log_h, row0, [pt], natural, ex)
    ext_before = None if ext is None else ext.clone()
    got = ok.reduced_opening(acc.clone(), mats, apows, log_h, row0, points, natural, ext, scales)
    assert kernels.REDUCED_OPENING.launches == max(1, -(-len(mats) // ok.MAX_OPS))
    assert torch.equal(got, want)
    assert ext is None or torch.equal(ext, ext_before)


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_streamed_reduced_contrib_two_points_equals_each_point(request, path):
    """The streamed source at two points (its chunks summed once, one
    division for both) equals its contributions point by point, on the
    plain path and through K9's host build."""
    if path == "kernel":
        request.getfixturevalue("emulated")
    rng = np.random.default_rng(5)
    n, w, log_blowup = 16, 40, 2
    src = WideMatrixSource(torch.from_numpy(rng.integers(0, 2, size=(n, w), dtype=np.uint8)), Dft(device="cpu"),
                           log_blowup, TwoAdicCoset(4, 1), col_chunk=16)
    log_h = 4 + log_blowup
    apows = _t(_monty(rng, (w, 4)))
    points = [(_point(rng), _point(rng)), (_point(rng), _point(rng))]
    scales = [(1, 0, 0, 0), _point(rng)]
    acc = _t(_monty(rng, (1 << log_h, 4)))
    want = acc.clone()
    for pt, c in zip(points, scales):
        src.reduced_contrib(want, _scaled(apows, c), [pt], log_h, 0)
    launches = kernels.REDUCED_OPENING.launches
    got = src.reduced_contrib(acc.clone(), apows, points, log_h, 0, scales)
    assert torch.equal(got, want)
    if path == "kernel":  # three chunk sums and one division
        assert kernels.REDUCED_OPENING.launches - launches == 4


# (log_h, row0, rows, operand widths, natural, point, ext sum): the
# committed order and natural order, with and without a point, an ext sum
# alone and beside columns, a group of strided operands, operands read 16
# bytes at a time (aligned rows, widths of 4 words) beside ones read a word
# at a time, the run of 8 rows (row0 a multiple of 256) and one row a
# thread, the most operands a launch takes and more (summed into a scratch
# ext sum MAX_OPS operands a launch, then the last launch)
K9_CASES = {
    "br-point": (10, 0, 1024, (2,), False, True, False),
    "natural-point": (10, 0, 1024, (7,), True, True, False),
    "br-no-point": (9, 0, 512, (64,), False, False, False),
    "natural-no-point": (9, 0, 512, (65,), True, False, False),
    "ext-sum-alone": (8, 0, 256, (), False, True, True),
    "ext-sum-and-columns": (8, 0, 256, (3, 1), False, True, True),
    "group": (11, 512, 768, (3, 1, 5, 2), False, True, False),
    "group-natural": (11, 512, 768, (3, 1, 5, 2), True, True, False),
    "group-16-byte-rows": (10, 256, 512, (4, 8, 12), False, True, False),
    "natural-16-byte-rows": (9, 0, 512, (64,), True, True, False),
    "row0-one-row-a-thread": (10, 96, 200, (2,), False, True, False),
    "small": (3, 0, 8, (1,), False, True, False),
    "a-launch-of-operands": (7, 0, 128, (1,) * 31 + (2,), False, True, False),
    "more-operands-than-a-launch": (7, 0, 128, (1,) * 32 + (2,), False, True, False),
    "three-launches-natural-ext-sum": (8, 0, 256, (2, 1, 4) * 23, True, True, True),
    "two-launches-no-point": (9, 256, 256, (1,) * 40, False, False, False),
}


@pytest.mark.parametrize("case", list(K9_CASES))
def test_host_k9_equals_plain(emulated, case):
    log_h, row0, rows, widths, natural, with_point, with_ext = K9_CASES[case]
    rng = np.random.default_rng(len(case) * 31 + rows)
    h = 1 << log_h
    n_rows = h if natural else rows
    mats = []
    for k, w in enumerate(widths):  # every other operand a column slice of a wider matrix
        m = _t(_monty(rng, (n_rows, w + 2 * (k % 2))))
        mats.append(m[:, 1 : 1 + w] if k % 2 else m)
    apows = _t(_monty(rng, (sum(widths), 4)))
    points = [(_point(rng), _point(rng))] if with_point else []
    ext = _t(_monty(rng, (rows, 4))) if with_ext else None
    acc = _t(_monty(rng, (rows, 4)))
    ext_before = None if ext is None else ext.clone()
    want = emulated["reduced_opening_plain"](acc.clone(), mats, apows, log_h, row0, points, natural, ext)
    got = ok.reduced_opening(acc.clone(), mats, apows, log_h, row0, points, natural, ext)
    assert kernels.REDUCED_OPENING.launches == max(1, -(-len(widths) // ok.MAX_OPS))
    assert torch.equal(got, want)
    assert ext is None or torch.equal(ext, ext_before)  # the caller's ext sum is read, never written


def test_host_k9_zero_denominator_gives_zero(emulated):
    """A point on the domain (y - z = 0 at one row) gives that row 0, as the
    plain inverse of 0, and leaves the batch's other rows right."""
    log_h, rows = 9, 512
    rng = np.random.default_rng(3)
    mat, apows = _t(_monty(rng, (rows, 2))), _t(_monty(rng, (2, 4)))
    y = pow(bb.two_adic_generator(log_h), ok._bit_reverse(37, log_h), P)
    points = [((y, 0, 0, 0), _point(rng))]
    want = emulated["reduced_opening_plain"](torch.zeros((rows, 4), dtype=torch.int32), [mat], apows, log_h, 0,
                                             points)
    got = ok.reduced_opening(torch.zeros((rows, 4), dtype=torch.int32), [mat], apows, log_h, 0, points)
    assert torch.equal(got, want) and not got[37].any()


# (h, w, points, r0, accumulate into out, a column slice)
K10_CASES = {
    "one-column": (300, 1, 1, 0, False, False),
    "two-points": (1024, 2, 2, 0, False, False),
    "row-blocks": (16384, 2, 2, 0, False, False),
    "r0": (4096, 7, 2, 37, False, False),
    "tile": (512, 64, 1, 512, False, False),
    "ragged-tiles": (700, 65, 2, 5, False, True),
    "one-point-tiles": (256, 40, 1, 0, False, False),
    "accumulate": (2048, 5, 2, 1 << 20, True, False),
    "short": (8, 2, 2, 0, False, False),
    "w1-r0": (2048, 1, 2, 3, False, False),
    "w2-r0": (4096, 2, 2, 1 << 23, False, False),
    "w64-r0": (1024, 64, 2, 99, False, False),
    "w493-r0": (256, 493, 2, 12345, False, False),
    "w493-one-point": (96, 493, 1, 0, False, True),
}


@pytest.mark.parametrize("case", list(K10_CASES))
def test_host_k10_equals_plain(emulated, case):
    h, w, npts, r0, accumulate, sliced = K10_CASES[case]
    rng = np.random.default_rng(h + w + npts)
    coeffs = _t(_monty(rng, (h, w + 3)))
    coeffs = coeffs[:, 2 : 2 + w] if sliced else coeffs[:, :w].contiguous()
    zs = [_point(rng) for _ in range(npts)]
    out = _t(_monty(rng, (npts, w, 4))) if accumulate else None
    want = emulated["eval_at_points_plain"](coeffs, zs, r0, None if out is None else out.clone())
    got = ok.eval_at_points(coeffs, zs, r0, None if out is None else out.clone())
    assert kernels.EVAL_AT_POINTS.launches == 1
    assert torch.equal(got, want)


def test_host_launch_limits_raise(emulated):
    """More than two points for K10, alpha powers that do not match a K9
    group's widths, or a K9 scale of 0 (which the kernel cannot take into
    q_z and s), raise on the kernel path (no caller has any of them)."""
    m = torch.zeros((8, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 2"):
        ok.eval_at_points(m, [(1, 0, 0, 0)] * 3)
    with pytest.raises(ValueError, match="apows"):
        ok.reduced_opening(torch.zeros((8, 4), dtype=torch.int32), [m] * 33, torch.zeros((32, 4), dtype=torch.int32), 3)
    pts = [((5, 0, 0, 0), (1, 2, 3, 4))] * 2
    with pytest.raises(ValueError, match="none may be 0"):
        ok.reduced_opening(torch.zeros((8, 4), dtype=torch.int32), [m], torch.zeros((1, 4), dtype=torch.int32), 3,
                           0, pts, scales=[(1, 0, 0, 0), (0, 0, 0, P)])


def test_k10_plan_covers_the_rows():
    """K10's plan covers every column with its groups of CB and every row
    with its ranges of 32 K rows, 2^3 <= K <= 2^8, and keeps about K10_ITEMS warp
    items where the height allows."""
    for h, w in [(1, 1), (300, 1), (1 << 25, 2), (1 << 21, 64), (1 << 18, 493), (700, 65), (1 << 23, 2)]:
        cb, ncg, log_k, nrange = ok.k10_plan(h, w)
        assert cb in (1, 2, 4) and ncg * cb >= w > (ncg - 1) * cb
        assert ok.K10_MIN_LOG_K <= log_k <= ok.K10_MAX_LOG_K
        assert (nrange - 1) << (5 + log_k) < h <= nrange << (5 + log_k)
        if log_k < ok.K10_MAX_LOG_K and h >= 32 * ok.K10_ITEMS:
            assert nrange * ncg >= ok.K10_ITEMS
    assert ok.k10_plan(1 << 25, 2) == (2, 1, 8, 4096) and ok.k10_plan(1 << 18, 493)[:3] == (4, 124, 7)


# (log_h, row0, rows (None: the whole), add)
K11_CASES = {
    "two-rows": (1, 0, None, False),
    "small-add": (4, 0, None, True),
    "run": (10, 0, None, False),
    "block-one-row-a-thread": (10, 64, 256, True),
    "block-run": (12, 1024, 2048, True),
}


@pytest.mark.parametrize("case", list(K11_CASES))
def test_host_k11_equals_plain(emulated, case):
    log_h, row0, rows, with_add = K11_CASES[case]
    rng = np.random.default_rng(log_h + row0)
    n = rows or 1 << log_h
    cw = _t(_monty(rng, (n, 4)))
    beta = _point(rng)
    add = _t(_monty(rng, (n // 2, 4))) if with_add else None
    want = emulated["fri_fold_plain"](cw, beta, log_h, row0, add)
    got = ok.fri_fold(cw, beta, log_h, row0, add)
    assert kernels.FRI_FOLD.launches == 1
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# (c) whole proves through the emulated wrappers
# ---------------------------------------------------------------------------
def test_fib_zk_prove_through_the_kernels_equals_jax(emulated):
    """A fib zk prove (random codewords: the no-point mode) with every open
    step on K9-K11's host build gives the JAX prover's bytes."""
    want = json.loads((GOLDEN / "torch_fib_zk_jax_proofs.json").read_text())["tpu_10"]
    n = 1 << 10
    cfg = create_config(zk=True, zk_rng="smallrng", zk_layout="tpu", device="cpu")
    pis = [0, 1, fibonacci_value(0, 1, n)]
    blob = serialize_proof(prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, n), pis))
    assert (hashlib.sha256(blob).hexdigest(), len(blob)) == (want["sha256"], want["len"])
    launches = {k.name: k.launches for k in kernels.OPEN_KERNELS}
    assert all(v > 0 for v in launches.values()), launches


def test_streamed_zk_prove_through_the_kernels_equals_jax(emulated):
    """keccak-air's zk ``prove_wide`` on the Keccak stack in 4 column chunks:
    the streamed source's evaluations (K10 into column slices), its chunk
    sums in natural order and its one division (K9 on the ext sum), and the
    folds give the JAX prover's bytes."""
    want = json.loads((GOLDEN / "torch_keccak_air_wide_zk_jax_proofs.json").read_text())["keccak_4chunks"]
    trace = generate_trace(2, seed=want["seed"], device="cpu")
    cfg = create_config(zk=True, hash="keccak", device="cpu")
    blob = serialize_proof(prove_wide(cfg, KeccakAir(), trace, [], col_chunk=want["col_chunk"]))
    assert (hashlib.sha256(blob).hexdigest(), len(blob)) == (want["sha256"], want["len"])
    assert all(k.launches > 0 for k in kernels.OPEN_KERNELS)
