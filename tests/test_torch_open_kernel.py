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
from tpu_stark_torch.fields import ref_field as rf
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.proof import serialize_proof
from tpu_stark_torch.prover.prove import prove
from tpu_stark_torch.prover.wide import prove_wide

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
    got_q = ok.reduced_opening_plain(_t(acc), [_t(mat)], _t(apows_m), log_h, 0, (z, _canon(s_m)))
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
    point = (_point(rng), _point(rng))
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
extern "C" int ts_reduced_opening(const int64_t* w, const uint32_t* k, void*) {
  const OpeningArgs a = unpack_opening(w, k);
  if (a.rows <= 0) return 0;
  if (a.nops > kMaxOps) return 1;
  const int64_t items = opening_items(a);
  for (int64_t g = 0; g < items; ++g) {
    if (a.log_r == 3) opening_item<8>(a, g); else opening_item<1>(a, g);
  }
  return 0;
}
// K10's blocks one after another, their threads one after another between
// the kernel's barriers; the reduction over a tile's row lanes as sums
extern "C" int ts_eval_at_points(const int64_t* w, const uint32_t* k, void*) {
  const PointsArgs a = unpack_points(w, k);
  if (a.h <= 0 || a.w <= 0) return 0;
  const int np = a.npts;
  std::vector<uint32_t> pows(2 * kThreads * 4);
  std::vector<Ext> zp(2 * kThreads), acc(2 * kThreads);
  for (int64_t blk = 0; blk < a.nrb * a.nct; ++blk) {
    const int64_t rb = blk / a.nct, ct = blk % a.nct;
    const int64_t begin = rb * a.rb_rows, end = begin + a.rb_rows < a.h ? begin + a.rb_rows : a.h;
    for (int t = 0; t < kThreads; ++t)
      for (int p = 0; p < np; ++p) {
        zp[2 * t + p] = point_power(a, p, begin + t);
        acc[2 * t + p] = ts::ext_zero();
      }
    for (int64_t chunk = begin; chunk < end; chunk += kThreads) {
      for (int t = 0; t < kThreads; ++t)
        for (int p = 0; p < np; ++p) {
          ts::ext_store(pows.data() + (p * kThreads + t) * 4, zp[2 * t + p]);
          zp[2 * t + p] = ts::ext_mul(zp[2 * t + p], a.zstep[p]);
        }
      for (int t = 0; t < kThreads; ++t) {
        if (np == 2) points_chunk<2>(a, pows.data(), chunk, end, ct, t, &acc[2 * t]);
        else points_chunk<1>(a, pows.data(), chunk, end, ct, t, &acc[2 * t]);
      }
    }
    for (int64_t tx = 0; tx < a.cw; ++tx) {
      const int64_t col = ct * a.cw + tx;
      if (col >= a.w) continue;
      for (int p = 0; p < np; ++p) {
        Ext s = ts::ext_zero();
        for (int64_t ty = 0; ty < kThreads / a.cw; ++ty) s = ts::ext_add(s, acc[2 * (ty * a.cw + tx) + p]);
        ts::ext_store(a.partial + ((rb * np + p) * a.w + col) * 4, s);
      }
    }
  }
  for (int64_t g = 0; g < np * a.w * 4; ++g) {  // the warp's lanes, then their sum
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
    point = (_point(rng), _point(rng)) if with_point else None
    ext = _t(_monty(rng, (rows, 4))) if with_ext else None
    acc = _t(_monty(rng, (rows, 4)))
    ext_before = None if ext is None else ext.clone()
    want = emulated["reduced_opening_plain"](acc.clone(), mats, apows, log_h, row0, point, natural, ext)
    got = ok.reduced_opening(acc.clone(), mats, apows, log_h, row0, point, natural, ext)
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
    point = ((y, 0, 0, 0), _point(rng))
    want = emulated["reduced_opening_plain"](torch.zeros((rows, 4), dtype=torch.int32), [mat], apows, log_h, 0,
                                             point)
    got = ok.reduced_opening(torch.zeros((rows, 4), dtype=torch.int32), [mat], apows, log_h, 0, point)
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
    """More than two points for K10, or alpha powers that do not match a K9
    group's widths, raise on the kernel path (no caller has either)."""
    m = torch.zeros((8, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 2"):
        ok.eval_at_points(m, [(1, 0, 0, 0)] * 3)
    with pytest.raises(ValueError, match="apows"):
        ok.reduced_opening(torch.zeros((8, 4), dtype=torch.int32), [m] * 33, torch.zeros((32, 4), dtype=torch.int32), 3)


def test_k10_plan_covers_the_rows():
    for h, w in [(1, 1), (300, 1), (1 << 25, 2), (1 << 21, 64), (1 << 18, 493), (700, 65)]:
        cw, nct, rb_rows, nrb = ok.k10_plan(h, w)
        assert cw & (cw - 1) == 0 and cw <= 32 and nct * cw >= w > (nct - 1) * cw
        assert rb_rows % ok.K10_THREADS == 0 and (nrb - 1) * rb_rows < h <= nrb * rb_rows
    assert ok.k10_plan(1 << 25, 2)[3] == ok.K10_BLOCKS


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
