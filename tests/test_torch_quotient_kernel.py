"""The quotient pass's kernels K7 (constraint evaluation and alpha fold,
generated from the AIR's constraint DAG) and K8 (the panel coset fold) of
``tpu_stark_torch/air/quotient_kernel.py``, on the CPU:

(a) ``TracingAirBuilder`` counts the constraints ``SymbolicAirBuilder``
    counts, for fib, the chain, keccak-air and each of its 48 partitions;
(b) each captured DAG, interpreted with numpy (``quotient_dag.py``) on
    seeded random Monty panels, equals the plain ``QuotientBuilder`` /
    ``PartitionBuilder`` fold bit for bit, and the port's fold equals JAX's
    ``QuotientBuilder`` on the same inputs;
(c) the generated source is deterministic, and partitions with one DAG share
    one kernel (keccak-air: 8 for 48 partitions);
(d) the generated K7 sources and ``csrc/quotient.cu`` (K8), compiled with
    g++ under a host shim (``__device__`` and ``__forceinline__`` as
    ``inline``, ``__ldg`` a load; each launch a loop over blocks, units and
    threads), equal the plain versions at 5-1,500 rows; through the real
    wrappers, the dense and streamed quotient passes and whole proves give
    the plain versions' values and the JAX fixtures' bytes.
"""

import ctypes
import functools
import gc
import hashlib
import json
import pathlib
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_host import gxx, shim_dir
from quotient_dag import interpret
from tpu_stark.air import builders as jbuilders
from tpu_stark.air import fibonacci as jfib
from tpu_stark.air import keccak_air as jkeccak_air
from tpu_stark.air.values import DevVal as JDevVal
from tpu_stark.prover import wide as jwide
from tpu_stark_torch import kernels
from tpu_stark_torch.air import keccak_air, poseidon2_air
from tpu_stark_torch.air import quotient_kernel as qk
from tpu_stark_torch.air.air import BaseAir, SymbolicAirBuilder, TracingAirBuilder
from tpu_stark_torch.air.builders import PartitionBuilder, QuotientBuilder
from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
from tpu_stark_torch.air.values import DevVal
from tpu_stark_torch.dist.dryrun import keccak_subset_air
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.prover import wide
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.proof import serialize_proof
from tpu_stark_torch.prover.prove import _quotient_values, prove

GOLDEN = pathlib.Path(__file__).parent / "golden"
AIRS = {"fib": (FibonacciAir, 3), "chain": (poseidon2_air.Poseidon2ChainAir, 32), "keccak-air": (keccak_air.KeccakAir, 0)}
PARTS = [p.name for p in keccak_air.KeccakAir().partitions()]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The proves here are CPU-bound torch work: two intra-op threads keep
    them off the cores that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _monty(rng, shape):
    return rng.integers(0, bb.P, size=shape, dtype=np.int64).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _program(name):
    """The program of an AIR without partitions, or of a keccak-air partition
    (traced once a name: tracing keccak-air's 48 partitions takes a while)."""
    if name in AIRS:
        cls, npis = AIRS[name]
        return qk.programs(cls(), npis)[0], npis
    return next(p for p in qk.programs(keccak_air.KeccakAir(), 0) if p.name == name), 0


def _inputs(prog, npis, m, seed):
    """Seeded random Monty inputs of one call: panel rows, next rows,
    selectors, public values, alpha powers."""
    rng = np.random.default_rng(seed)
    u = len(prog.cols)
    sels = {name: _monty(rng, (m,)) for name in qk.SELECTORS}
    return _monty(rng, (m, u)), _monty(rng, (m, u)), sels, _monty(rng, (npis,)), _monty(rng, (prog.count, 4))


def _plain_fold(prog, cur, nxt, sels, pis):
    """The builder's fold of the program on (cur, nxt) rows: ``QuotientBuilder``
    for a whole AIR, ``PartitionBuilder`` for a partition."""
    sel = {k: torch.from_numpy(v) for k, v in sels.items()}
    pv = [DevVal(torch.tensor(int(p), dtype=torch.int32)) for p in pis]
    cur, nxt = torch.from_numpy(cur), torch.from_numpy(nxt)
    if prog.name == "air":
        return QuotientBuilder(cur, nxt, sel, pv)
    return PartitionBuilder(cur[:, prog.local_pos], nxt[:, prog.next_pos], prog.local_cols, prog.next_cols, sel, pv)


# ---------------------------------------------------------------------------
# (a) constraint counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(AIRS) + PARTS)
def test_tracing_count_equals_symbolic(name):
    if name in AIRS:
        cls, npis = AIRS[name]
        air = cls()
        fn, width = air.eval, air.width
    else:
        air, npis = keccak_air.KeccakAir(), 0
        fn, width = next(p for p in air.partitions() if p.name == name).eval, air.width
    ident = {c: c for c in range(width)}
    traced = TracingAirBuilder(width, npis, ident, ident)
    fn(traced)
    symbolic = SymbolicAirBuilder(width, npis)
    fn(symbolic)
    assert traced.constraint_count == symbolic.constraint_count == len(traced.roots) > 0


# ---------------------------------------------------------------------------
# (b) the DAG interpreted against the plain fold, and against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fib", "chain"] + PARTS)
def test_dag_interpretation_equals_plain(name):
    prog, npis = _program(name)
    cur, nxt, sels, pis, alpha = _inputs(prog, npis, 64, seed=len(name) * 31 + prog.offset)
    b = _plain_fold(prog, cur, nxt, sels, pis)
    prog.eval_fn(b)
    want = b.folded_constraints(torch.from_numpy(alpha)).numpy()
    got = interpret(prog.dag, cur, nxt, sels, pis, alpha)
    assert got.dtype == np.uint32 and np.array_equal(got, want.view(np.uint32))


@pytest.mark.parametrize("name", ["fib", "iota", "trans3", "apdef2", "flags"])
def test_fold_equals_jax(name):
    """The port's fold (interpreted DAG and ``eval_fold``) on the inputs
    JAX's builder folds: JAX's ``QuotientBuilder`` / ``_PartitionBuilder``."""
    prog, npis = _program(name)
    m = 32
    cur, nxt, sels, pis, alpha = _inputs(prog, npis, m, seed=5)
    jsel = {k: jnp.asarray(v.view(np.uint32)) for k, v in sels.items()}
    jpis = [JDevVal(jnp.uint32(int(p))) for p in pis]
    jcur, jnxt = jnp.asarray(cur.view(np.uint32)), jnp.asarray(nxt.view(np.uint32))
    if name == "fib":
        b = jbuilders.QuotientBuilder(jcur, jnxt, jsel, jpis)
        jfib.FibonacciAir().eval(b)
    else:
        part = next(p for p in jkeccak_air.KeccakAir().partitions() if p.name == name)
        b = jwide._PartitionBuilder(jcur[:, prog.local_pos], jnxt[:, prog.next_pos], part.local_cols,
                                    part.next_cols, jsel, jpis)
        part.eval(b)
    want = np.asarray(b.folded_constraints(jnp.asarray(alpha.view(np.uint32))))
    assert np.array_equal(interpret(prog.dag, cur, nxt, sels, pis, alpha), want)
    acc = torch.zeros((m, 4), dtype=torch.int32)
    qk.eval_fold(prog, torch.from_numpy(cur), torch.from_numpy(nxt), 0, {k: torch.from_numpy(v) for k, v in sels.items()},
                 0, 1, torch.from_numpy(pis), torch.from_numpy(alpha), acc, 0, 1, add=False, invz=False)
    assert np.array_equal(acc.numpy().view(np.uint32), want)


# ---------------------------------------------------------------------------
# (c) the generated source
# ---------------------------------------------------------------------------
def test_generated_source_is_deterministic_and_shared():
    progs = qk.programs(keccak_air.KeccakAir(), 0)
    again = [qk._trace(p.eval_fn, keccak_air.COLS, 0, p.local_cols, p.next_cols, p.local_pos, p.next_pos)
             for p in progs]
    assert [d.key for d in again] == [p.dag.key for p in progs]
    assert [qk.source(d) for d in again] == [qk.source(p.dag) for p in progs]
    by_class = {}
    for p in progs:
        by_class.setdefault(p.name.rstrip("0123456789"), set()).add(p.dag.key)
    assert len(by_class["trans"]) == 1 and len([p for p in progs if p.name.startswith("trans")]) == 24
    assert by_class["bool_a"] == by_class["bool_ap"] and len(by_class["bool_a"]) == 1
    assert len(by_class["theta"]) == len(by_class["apdef"]) == 1
    assert len(qk.distinct_dags(progs)) == 8
    assert [p.offset for p in progs] == list(np.cumsum([0] + [p.count for p in progs])[:-1])
    assert sum(p.count for p in progs) == 7241
    fib = qk.programs(FibonacciAir(), 3)
    assert len(fib) == 1 and fib[0].dag.span(0) == fib[0].dag.span(1) == (0, 2)
    assert "tsq::fold(acc, al[4], v" in qk.source(fib[0].dag)


def test_trace_prunes_unread_columns():
    chain = qk.programs(poseidon2_air.Poseidon2ChainAir(), 32)[0].dag
    assert chain.span(0) == (0, poseidon2_air.COLS) and chain.span(1) == (0, 16)
    assert all(chain.nodes[i][1:] < (i,) for i in range(len(chain.nodes)) if chain.nodes[i][0] in ("add", "sub", "mul"))


class _ScaledAir(BaseAir):
    """An AIR whose constraint depends on its instance: x0 * k = x1."""

    width = 2

    def __init__(self, k):
        self.k = k

    def eval(self, b):
        local = b.main_row(0)
        b.assert_eq(local[0] * self.k, local[1])


def test_programs_are_kept_per_air_instance():
    """Two instances of one class get their own DAGs; an instance's programs
    are traced once a count of public values and go with it (the dry run's
    keccak-air subsets, a class each, leave nothing behind)."""
    a, b = _ScaledAir(2), _ScaledAir(3)
    pa = qk.programs(a, 0)
    assert qk.programs(a, 0) is pa and qk.programs(a, 1) is not pa
    assert pa[0].dag.key != qk.programs(b, 0)[0].dag.key
    assert pa[0].dag.key == qk.programs(_ScaledAir(2), 0)[0].dag.key
    subset = keccak_subset_air(["iota", "trans1"])
    assert [p.name for p in qk.programs(subset, 0)] == ["iota", "trans1"]
    refs = [weakref.ref(a), weakref.ref(subset)]
    del a, pa, subset
    gc.collect()
    assert all(r() is None for r in refs)


def test_bound_reads_one_panel_once():
    """K7's bytes bound counts a word of the current panel once where the
    next rows are read from that panel (the dense pass), and both panels'
    spans otherwise or where the spans do not meet."""
    import chip_smoke

    fib = qk.programs(FibonacciAir(), 3)[0]
    cur = torch.zeros((64, 2), dtype=torch.int32)
    assert chip_smoke.same_panel(cur, cur) and not chip_smoke.same_panel(cur, cur.clone())
    rows = 1 << 20
    two = chip_smoke.quotient_eval_bound(fib.dag, rows, False, True, False)[0]
    one = chip_smoke.quotient_eval_bound(fib.dag, rows, False, True, True)[0]
    # fib: 2 + 2 panel words or 2, 3 selectors, 1/Z_H, a 16-byte row written
    assert two / one == pytest.approx((4 * (4 + 3 + 1) + 16) / (4 * (2 + 3 + 1) + 16))
    apart = qk.Dag((("col", 0, 0), ("col", 1, 5), ("sub", 0, 1)), (2,))  # spans [0, 1) and [5, 6)
    assert chip_smoke.quotient_eval_bound(apart, rows, True, False, True) == \
        chip_smoke.quotient_eval_bound(apart, rows, True, False, False)


FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  case "$a" in *broken*) echo "error: a broken source"; exit 1;; esac
  prev="$a"
done
echo "ptxas info    : Used 12 registers"
echo built > "$out"
"""


def test_nvcc_builds_start_together_and_clean_up(monkeypatch, tmp_path):
    """``build`` and ``build_generated`` through one parallel nvcc runner,
    ``kernels._nvcc_all`` (here a stand-in nvcc that writes its output): each
    output lands under its own name, a built generated hash is reused, a
    failed compile raises naming it, and no temporary or object is left
    behind."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    out_dir = tmp_path / "build"
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(out_dir))
    monkeypatch.setattr(kernels, "LIB_PATH", str(out_dir / "libk.so"))
    res = kernels.build(force=True)
    assert res.path == str(out_dir / "libk.so") and (out_dir / "libk.so").read_text() == "built\n"
    assert all(f"== {s}\nptxas info" in res.log for s in kernels.SOURCES)
    assert sorted(p.name for p in out_dir.iterdir()) == ["libk.so"]
    first = kernels.build_generated({"a": "// a", "b": "// b"})
    assert all(r.seconds > 0 and "Used 12 registers" in r.log for r in first.values())
    again = kernels.build_generated({"a": "// a"})
    assert again["a"].path == first["a"].path and again["a"].seconds == 0.0
    with pytest.raises(RuntimeError, match="nvcc failed on the generated quotient kernels:\n== broken"):
        kernels.build_generated({"c": "// c", "broken": "// x"})
    assert not [p.name for p in out_dir.iterdir() if ".tmp" in p.name or p.name.endswith(".o")]


# ---------------------------------------------------------------------------
# (d) the kernels' sources on the host
# ---------------------------------------------------------------------------
# the grid of a host launch: ``ts_q_grid`` blocks, or one a tile when 0
K7_HOST = """
#include <cstdint>
#include <vector>
static int64_t grid_blocks = 0;
extern "C" void ts_q_grid(int64_t blocks) { grid_blocks = blocks; }
"""

# a launch: every block of the grid through the kernel's device functions,
# thread by thread, one shared buffer for them all (a block finds the last
# one's words); the producers run as far ahead as the ring lets them (every
# slot filled, a slot refilled as soon as its unit is evaluated), so a unit
# staged into the wrong slot clobbers one still to be evaluated
K7_LAUNCH = """
extern "C" int ts_q_{key}(const int64_t* w, void*) {{
  using D = Q_{key};
  const tsq::Args a = tsq::unpack(w);
  if (a.rows <= 0) return 0;
  std::vector<uint32_t> smem(tsq::Layout<D>::kWordsTotal);
  const int64_t tiles = tsq::tiles_of<D>(a);
  const int64_t nb = grid_blocks > 0 && grid_blocks < tiles ? grid_blocks : tiles;
  const int consumers = tsq::Layout<D>::kConsumers, producers = D::NP * 32;
  std::vector<tsq::Acc> acc(consumers);
  for (int64_t b = 0; b < nb; ++b) {{
    for (int tid = 0; tid < consumers + producers; ++tid) tsq::stage_consts<D>(a, smem.data(), tid, consumers + producers);
    const int64_t units = tsq::units_of<D>(tiles, b, nb);
    auto stage = [&](int64_t u) {{
      for (int lane = 0; lane < producers; ++lane)
        tsq::stage_unit<D>(a, smem.data(), tsq::unit_t0<D>(b, nb, u), int(u % D::G), int(u % D::NS), lane, producers);
    }};
    for (int64_t u = 0; u < units && u < D::NS; ++u) stage(u);
    for (int64_t u = 0; u < units; ++u) {{
      const int64_t t0 = tsq::unit_t0<D>(b, nb, u);
      const int buf = int(u / D::G) & 1;
      for (int tid = 0; tid < consumers; ++tid)
        tsq::eval_unit<D>(a, smem.data(), t0, int(u % D::G), int(u % D::NS), tid, acc[tid], buf);
      if (u % D::G == D::G - 1)
        for (int tid = 0; tid < consumers; ++tid) tsq::store_row<D>(a, smem.data(), t0, tid, acc[tid], buf);
      if (u + D::NS < units) stage(u + D::NS);
    }}
  }}
  return 0;
}}
extern "C" int64_t ts_q_smem_{key}() {{ return tsq::Layout<Q_{key}>::kBytes; }}
"""

K8_LAUNCH = """
#include <vector>
#include "quotient.cu"
struct HostLoop {  // every segment: its table by every thread, then each thread's groups
  const PanelArgs& a;
  template <int R, int F, int V>
  int run() const {
    const int64_t seg = panel_seg<R, V>(a), nseg = (a.m + seg - 1) / seg;
    std::vector<uint32_t> tab(seg * R);
    for (int64_t s = 0; s < nseg; ++s) {
      const int64_t i0 = s * seg, rows = a.m - i0 < seg ? a.m - i0 : seg;
      for (int tid = 0; tid < kThreads; ++tid) seg_table<R>(a, tab.data(), i0, rows, tid, kThreads);
      for (int tid = 0; tid < kThreads; ++tid)
        seg_rows<R, F, V>(a, tab.data(), i0, rows, walk_of(a.u, V, tid, kThreads));
    }
    return 0;
  }
};
extern "C" int ts_panel_fold(const int64_t* words, const uint32_t* consts, void*) {
  const PanelArgs a = unpack_panel(words, consts);
  if (a.m <= 0 || a.u <= 0) return 0;
  return panel_dispatch(a, HostLoop{a});
}
"""


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The K7 sources of fib, the chain and keccak-air and K8's source as host
    libraries with the card's entry points (a launch runs every block's
    phases thread by thread)."""
    tmp = shim_dir(tmp_path_factory.mktemp("quotient_host"))
    fns, grids, smem = {}, [], {}
    for name, (cls, npis) in AIRS.items():
        dags = qk.distinct_dags(qk.programs(cls(), npis))
        text = K7_HOST + "".join(qk.source(d) + K7_LAUNCH.format(key=d.key) for d in dags)
        lib = gxx(tmp, name.replace("-", "_"), text)
        for d in dags:
            fn = getattr(lib, f"ts_q_{d.key}")
            fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
            fns[d.key] = fn
            smem[d.key] = getattr(lib, f"ts_q_smem_{d.key}")
            smem[d.key].restype = ctypes.c_int64
        lib.ts_q_grid.argtypes, lib.ts_q_grid.restype = [ctypes.c_int64], None
        grids.append(lib.ts_q_grid)
    k8 = gxx(tmp, "k8", K8_LAUNCH)
    k8.ts_panel_fold.argtypes, k8.ts_panel_fold.restype = [ctypes.c_void_p] * 3, ctypes.c_int
    return fns, k8, grids, smem


@pytest.fixture
def emulated(host_libs, monkeypatch):
    """The wrappers take their kernel path on CPU tensors, through the host
    libraries; the plain versions refuse to run."""
    fns, k8, grids, _ = host_libs
    for grid in grids:
        grid(0)
    monkeypatch.setattr(qk, "_on_card", lambda t: True)
    monkeypatch.setattr(qk, "_entry", lambda dag: fns[dag.key])
    monkeypatch.setattr(kernels, "lib", lambda: k8)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: None)

    def refuse(*args, **kw):
        raise AssertionError("a plain quotient version ran on the kernel path")

    plain = {"eval_fold_plain": qk.eval_fold_plain, "panel_fold_plain": qk.panel_fold_plain}
    monkeypatch.setattr(qk, "eval_fold_plain", refuse)
    monkeypatch.setattr(qk, "panel_fold_plain", refuse)
    kernels.reset_launch_counts()
    return plain


DAG_PROGRAMS = ["fib", "chain", "flags", "bool_a0", "bool_c_chi", "theta1", "apdef3", "chi00def", "iota", "trans7"]
# (rows, next rows, next-row shift, selector offset and stride, accumulator
# offset and stride, add, invz): the dense pass (step 2, times 1/Z_H), a
# rank block (given next rows), a streamed block (strided rows of the coset,
# added), the last streamed block (block 0's rows one on)
MODES = {
    "dense": (64, 64, 2, 0, 1, 0, 1, False, True),
    "rank-block": (96, 96, 0, 160, 1, 0, 1, False, True),
    "block": (256, 256, 0, 1, 4, 1, 4, True, False),
    "last-block": (64, 64, 1, 3, 4, 3, 4, True, False),
}


def _host_k7(emulated, name, seed, rows, nrows, nshift, sel_off, sel_stride, acc_off, acc_stride, add, invz, u=None):
    """One K7 launch through the host library against ``eval_fold_plain``
    on seeded random operands; returns the program."""
    prog, npis = _program(name)
    rng = np.random.default_rng(seed)
    u = u or len(prog.cols) + 3  # wider than the program: a row stride past its columns
    cur = torch.from_numpy(_monty(rng, (rows, u)))
    nxt = torch.from_numpy(_monty(rng, (nrows, u)))
    span = sel_off + rows * sel_stride
    sels = {k: torch.from_numpy(_monty(rng, (span,))) for k in qk.SELECTORS}
    pis, alpha = torch.from_numpy(_monty(rng, (npis,))), torch.from_numpy(_monty(rng, (prog.count, 4)))
    acc = torch.from_numpy(_monty(rng, (acc_off + rows * acc_stride, 4)))
    want = emulated["eval_fold_plain"](prog, cur, nxt, nshift, sels, sel_off, sel_stride, pis, alpha, acc.clone(),
                                       acc_off, acc_stride, add, invz)
    got = qk.eval_fold(prog, cur, nxt, nshift, sels, sel_off, sel_stride, pis, alpha, acc.clone(), acc_off,
                       acc_stride, add, invz)
    assert kernels.QUOTIENT_EVAL.launches == 1
    assert torch.equal(got, want)
    return prog, cur, nxt


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", DAG_PROGRAMS)
def test_host_k7_equals_plain(emulated, name, mode):
    _host_k7(emulated, name, DAG_PROGRAMS.index(name) * 10 + list(MODES).index(mode), *MODES[mode])


# the persistent grid and the ring: (rows, next rows, next-row shift (None:
# the mode's), grid blocks (0: one a tile), panels 16-byte aligned)
RING_CASES = {
    "walk": (1500, 1500, None, 2, False),  # blocks walk several tiles through the ring; a ragged last tile
    "ragged": (1100, 1100, None, 0, False),  # a ragged last tile, one block a tile
    "short": (5, 5, None, 0, False),  # fewer rows than one tile
    "wrap": (1200, 1200, 333, 2, False),  # the next rows wrap to row 0 inside a tile
    "aligned": (700, 700, None, 1, True),  # both panels take the 16-byte copies
}


@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", DAG_PROGRAMS)
def test_host_k7_ring_equals_plain(emulated, host_libs, name, mode, case):
    """The kernel's units and ring (``tsq::units_of``, ``unit_t0``, the ring
    slots, the shares' part buffers) at grids with fewer blocks than tiles,
    ragged and short tiles, next rows wrapping inside a tile and 16-byte
    staging, for each DAG (one phase or many) and call mode."""
    rows, nrows, nshift, blocks, aligned = RING_CASES[case]
    _, _, mode_shift, sel_off, sel_stride, acc_off, acc_stride, add, invz = MODES[mode]
    nshift = min(mode_shift, rows) if nshift is None else nshift
    prog, _ = _program(name)
    # aligned: a row stride of a multiple of 4 words; else an odd one, so the 4-byte copies
    u = (len(prog.cols) + 3) // 4 * 4 + 4 if aligned else (len(prog.cols) + 3) | 1
    for grid in host_libs[2]:
        grid(blocks)
    seed = 1000 + DAG_PROGRAMS.index(name) * 100 + list(MODES).index(mode) * 10 + list(RING_CASES).index(case)
    prog, cur, nxt = _host_k7(emulated, name, seed, rows, nrows, nshift, sel_off, sel_stride, acc_off, acc_stride,
                              add, invz, u)
    assert qk._vec(prog.dag, 0, cur) == qk._vec(prog.dag, 1, nxt) == aligned
    tile = qk.LANES * prog.dag.plan().warps
    assert rows < tile if case == "short" else -(-rows // tile) > max(blocks, 1)


@pytest.mark.parametrize("name", DAG_PROGRAMS)
def test_host_k7_smem_bytes_match_the_layout(host_libs, name):
    """``Dag.smem_bytes``, which ``plan`` and ``source`` hold to the block's
    limit, is the header's count (``tsq::Layout::kBytes``: the dynamic
    buffer and the ring's static mbarriers)."""
    dag = _program(name)[0].dag
    assert host_libs[3][dag.key]() == dag.smem_bytes() <= qk.SMEM_LIMIT
    assert dag.plan().threads <= qk.MAX_THREADS


def _block_fold(tf, log_m, shift):
    """One row block's fold on its own, as the JAX package's per-block
    ``_panel_eval_fn`` folds: the coefficients folded onto shift * <g_m>
    with powers of shift^m, then scaled by shift^i."""
    m = 1 << log_m
    fold = tf[:m]
    s_m = pow(shift, m, bb.P)
    w = s_m
    for q in range(1, int(tf.shape[0]) // m):
        fold = bb.add(fold, bb.mul_canonical(tf[q * m : (q + 1) * m], w))
        w = w * s_m % bb.P
    return bb.mul_canonical(fold, bb.powers(shift, m, tf.device)[:, None])


# a coset's fold: r blocks of m = 8 rows from npan = r or 2 r (zk) runs of
# coefficients, u columns (u >= 4 takes the 16-byte groups for r <= 8)
K8_COSETS = [(r, f, u) for r in (1, 2, 4, 8, 32) for f in (1, 2) for u in (1, 3, 24, 257)]


def _k8_operands(r, f, u, log_m=3):
    rng = np.random.default_rng(1000 * r + 100 * f + u)
    tf = torch.from_numpy(_monty(rng, (f * r << log_m, u))).clone()
    return tf, 31 * pow(bb.two_adic_generator(20), r + 7 * f + u, bb.P) % bb.P


@pytest.mark.parametrize("r,f,u", K8_COSETS)
def test_panel_fold_plain_equals_the_block_folds(r, f, u):
    """The one-pass fold's plain version (the r-point DFT across the blocks)
    equals the r per-block folds on shift * g^k * <g_m>, g of order r m."""
    tf, shift = _k8_operands(r, f, u)
    g = bb.two_adic_generator(3 + r.bit_length() - 1)
    want = torch.stack([_block_fold(tf, 3, shift * pow(g, k, bb.P) % bb.P) for k in range(r)])
    assert torch.equal(qk.panel_fold_plain(tf, 3, shift, r), want)


# (n, u, log_m, r): cosets of 1-16 blocks from r or 2 r runs, of several
# segments (a ragged last one; groups across rows' ends), m = 2 (single
# words), then the cosets of K8_COSETS
@pytest.mark.parametrize("n,u,log_m,r", [(64, 3, 6, 1), (64, 24, 4, 4), (256, 40, 5, 4), (128, 257, 3, 8),
                                         (256, 8, 3, 16), (512, 12, 4, 16), (256, 257, 6, 4), (512, 257, 6, 4),
                                         (1024, 24, 9, 2), (8192, 3, 12, 1), (2048, 5, 10, 2), (64, 6, 1, 32)]
                         + [(f * r << 3, u, 3, r) for r, f, u in K8_COSETS])
def test_host_k8_equals_plain(emulated, n, u, log_m, r):
    rng = np.random.default_rng(n + u + r)
    tf = torch.from_numpy(_monty(rng, (n, u))).clone()
    shift = 31 * pow(bb.two_adic_generator(10), n + u, bb.P) % bb.P
    got = qk.panel_fold(tf, log_m, shift, r)
    assert kernels.PANEL_FOLD.launches == 1
    assert got.shape == (r, 1 << log_m, u)
    assert qk._fold_vec(tf, got, 1 << log_m, u, r) == (log_m >= 2 and u >= 4 and r <= 8)
    assert torch.equal(got, emulated["panel_fold_plain"](tf, log_m, shift, r))


@pytest.mark.parametrize("n,log_m,r", [(64, 3, 2), (64, 4, 8), (64, 4, 64), (48, 3, 4)])
def test_panel_fold_refuses_other_shapes(emulated, n, log_m, r):
    """A coset's fold takes r or 2 r runs of m rows, r a power of two up to
    32: anything else raises on both paths, before any launch."""
    tf = torch.zeros((n, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="panel_fold"):
        qk.panel_fold(tf, log_m, 7, r)
    with pytest.raises(ValueError, match="panel_fold"):
        emulated["panel_fold_plain"](tf, log_m, 7, r)
    assert kernels.PANEL_FOLD.launches == 0


def test_panel_fold_raises_on_a_failed_launch(emulated, monkeypatch):
    """No fallback: a launch that returns a CUDA error raises."""
    monkeypatch.setattr(kernels, "lib", lambda: type("Lib", (), {"ts_panel_fold": lambda *a: 700})())
    with pytest.raises(RuntimeError, match="cudaError 700"):
        qk.panel_fold(torch.zeros((64, 4), dtype=torch.int32), 4, 7, 4)


def test_host_quotient_values_equal_plain(emulated):
    """``_quotient_values`` through K7 (one launch for fib and the chain, one
    a partition for keccak-air, a rank block with its given next rows)."""
    rng = np.random.default_rng(9)
    for name, log_n, log_m in (("fib", 5, 6), ("chain", 4, 6), ("keccak-air", 4, 6)):
        cls, npis = AIRS[name]
        air = cls()
        progs = qk.programs(air, npis)
        on_q = torch.from_numpy(_monty(rng, (1 << log_m, air.width)))
        pis = torch.from_numpy(_monty(rng, (npis,)))
        apows = torch.from_numpy(_monty(rng, (sum(p.count for p in progs), 4)))
        kernels.reset_launch_counts()
        got = _quotient_values(air, on_q, pis, apows, log_n, log_m)
        assert kernels.QUOTIENT_EVAL.launches == len(progs)
        step, r0 = (1 << log_m) >> log_n, 16
        blk = _quotient_values(air, on_q[r0:48], pis, apows, log_n, log_m,
                               main_next=torch.roll(on_q, -step, 0)[r0:48], row0=r0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(qk, "_on_card", lambda t: False)
            mp.setattr(qk, "eval_fold_plain", emulated["eval_fold_plain"])
            want = _quotient_values(air, on_q, pis, apows, log_n, log_m)
        assert torch.equal(got, want) and torch.equal(blk, want[r0:48])


def test_host_streamed_quotient_equals_plain(emulated):
    """``quotient_chunks_streamed`` on keccak-air through K8 and K7 in 16
    row blocks a coset (next rows across every block edge) equals the plain
    pass."""
    trace = keccak_air.generate_trace(3, seed=12, device="cpu")  # 128 rows
    n = int(trace.shape[0])
    pcs = create_config(zk=False, hash="poseidon2", device="cpu").pcs
    domain = pcs.natural_domain_for_degree(n)
    src = wide.WideMatrixSource(trace, pcs.dft, 1, domain)
    air = keccak_air.KeccakAir()
    apows = torch.from_numpy(_monty(np.random.default_rng(4), (7241, 4)))
    got = wide.quotient_chunks_streamed(air, src, domain, 2, apows, [], 0, 3)[1]
    assert kernels.QUOTIENT_EVAL.launches == 48 * 4 * 16 and kernels.PANEL_FOLD.launches == 48 * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qk, "_on_card", lambda t: False)
        mp.setattr(qk, "eval_fold_plain", emulated["eval_fold_plain"])
        mp.setattr(qk, "panel_fold_plain", emulated["panel_fold_plain"])
        want = wide.quotient_chunks_streamed(air, src, domain, 2, apows, [], 0, 3)[1]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_host_kernels_prove_the_jax_fixtures(emulated):
    """Whole proves through K7 and K8 give the JAX package's bytes: fib zk
    n = 8 (the golden file), the chain at 2^6 (Poseidon2 stack) and
    keccak-air zk at 64 rows on the Keccak stack (JAX's zk wide fixture)."""
    fib = json.loads((GOLDEN / "fib_air_zk_n8_smallrng.json").read_text())
    cfg = create_config(zk=True, zk_rng="smallrng", zk_layout="tpu", device="cpu")
    blob = serialize_proof(prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, 8), [0, 1, fibonacci_value(0, 1, 8)]))
    assert blob.hex() == fib["proof_hex"]
    chain = json.loads((GOLDEN / "torch_poseidon2_jax_proofs.json").read_text())["chain_6"]
    trace, pis = poseidon2_air.generate_trace(64, list(range(16)), device="cpu")
    blob = serialize_proof(prove(create_config(zk=False, hash="poseidon2", device="cpu"),
                                 poseidon2_air.Poseidon2ChainAir(), trace, pis))
    assert (len(blob), hashlib.sha256(blob).hexdigest()) == (chain["len"], chain["sha256"])
    want = json.loads((GOLDEN / "torch_keccak_air_wide_zk_jax_proofs.json").read_text())["keccak_4chunks"]
    trace = keccak_air.generate_trace(2, seed=8, device="cpu")
    blob = serialize_proof(wide.prove_wide(create_config(zk=True, hash="keccak", device="cpu"), keccak_air.KeccakAir(),
                                           trace, [], col_chunk=1024))
    assert (len(blob), hashlib.sha256(blob).hexdigest()) == (want["len"], want["sha256"])
    assert kernels.QUOTIENT_EVAL.launches > 48 and kernels.PANEL_FOLD.launches > 0


def test_kernel_path_raises_without_its_kernel(emulated, monkeypatch, tmp_path):
    """No fallback: a failed launch raises, and so does a build without
    nvcc."""
    prog, _ = _program("fib")
    args = (torch.zeros((32, 2), dtype=torch.int32), torch.zeros((32, 2), dtype=torch.int32), 0,
            {k: torch.zeros(32, dtype=torch.int32) for k in qk.SELECTORS}, 0, 1, torch.zeros(3, dtype=torch.int32),
            torch.zeros((5, 4), dtype=torch.int32), torch.zeros((32, 4), dtype=torch.int32), 0, 1, False, True)
    monkeypatch.setattr(qk, "_entry", lambda dag: (lambda w, s: 700))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        qk.eval_fold(prog, *args)
    monkeypatch.setattr(kernels, "_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(qk, "_entry", _real_entry)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        qk.eval_fold(prog, *args)


_real_entry = qk._entry
