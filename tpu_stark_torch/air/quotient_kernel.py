"""K7 and K8: the quotient pass on hand-written CUDA kernels.

**K7** evaluates an AIR's constraints on a panel of rows and folds them with
the powers of alpha (``eval_fold``).  Its source is generated from the
AIR's constraint DAG: ``programs(air, num_pis)`` traces each partition of
the constraint sequence (or the whole ``air.eval`` of an AIR without
partitions) through ``TracingAirBuilder`` with its columns renamed to panel
positions (``panel_cols``), and ``source`` emits, for each distinct DAG,
one struct of straight-line row functions for the fixed kernel of
``csrc/quotient_eval.cuh`` under its ``Plan``: the constraints cut into
phases by the 64-byte chunks of a row they read (each phase's quads staged
by the kernel's producer warps while the phase before is evaluated), each
phase cut into shares, one a consumer warp of a row group; a share's code
is the DAG's nodes it needs in creation order, each computed once
(``add_mod``, ``sub_mod``, ``monty_mul`` of ``csrc/babybear.cuh``), each
constraint folded into the row's sums as soon as it exists.  A
program's kernel is keyed by the SHA-256 of its DAG, so partitions with the
same DAG share one kernel: keccak-air's 48 partitions need 8 (the 24
``trans``, the 10 ``bool_a``/``bool_ap``, the 5 ``theta``, the 5
``apdef``, then ``flags``, ``bool_c_chi``, ``chi00def``, ``iota``), the
JAX package's class programs (``tpu_stark/prover/wide.py:733``).  The
alpha powers, the selectors and the public values are arguments.  Each DAG
builds into a shared library of its own (``kernels.build_generated``),
at first use.

**K8** (``csrc/quotient.cu``) is the panel coset fold (``panel_fold``) of
one quotient coset shift * <g> (g of order n = r m) cut into r row blocks,
block k the points shift g^k * <g_m>: out[k][i, c] = (shift g^k)^i *
sum_q tf[q m + i, c] * (shift g^k)^(m q), the (npan m, u) coefficient
columns folded onto each block and scaled for the NTT (K2) that evaluates
them there.  Since (g^k)^m = w^k with w = g^m of order r, the r folds are
one r-point DFT across the blocks of the coefficients scaled by
shift^(m q): one read of ``tf`` for the whole coset.

On the CPU each wrapper runs its plain version (``eval_fold_plain``,
``panel_fold_plain``: the ``QuotientBuilder`` / ``PartitionBuilder`` path
and the int64 fold); for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..fields import babybear as bb
from ..fields import extension as ext4
from .air import BaseAir, TracingAirBuilder
from .builders import PartitionBuilder
from .values import DevVal

HEADER = "quotient_eval.cuh"
LANES = 32  # threads a warp, one row each
WARPS = (16, 8, 4)  # row groups a block, the most whose ring fits: a tile of LANES * warps rows
CONSUMERS = 16  # consumer warps a block at least: warps * subs
STAGES = 2  # the ring of staged units (a phase of a tile) a block
CHUNK = 4  # quads a chunk: a phase stages whole 64-byte chunks of a row
SMEM_LIMIT = 232448  # shared memory a block may use on the H100
MAX_THREADS = 1024  # threads a block
NEXT, NONE = 0x8000, 0xFFFF  # a quad table entry of the next panel; an unused slot (tsq::kNext, kNone)


class Plan(NamedTuple):
    """A K7 kernel's shape: row groups of LANES rows a block, ring stages,
    the phases (each phase's constraints, in fold order, and the quads its
    rows stage: q for the current panel's columns [4q, 4q + 4), q | NEXT for
    the next panel's), the producer warps that stage them, and the consumer
    warps a row group."""

    warps: int
    stages: int
    phases: Tuple[Tuple[int, ...], ...]
    quads: Tuple[Tuple[int, ...], ...]
    producers: int
    subs: int  # consumer warps a row group: each runs its share of every phase's constraints

    def split(self, p: int) -> List[Tuple[int, ...]]:
        """Phase p's constraints cut into ``subs`` contiguous shares."""
        ks, size = self.phases[p], math.ceil(len(self.phases[p]) / self.subs)
        return [ks[j * size:(j + 1) * size] for j in range(self.subs)]

    @property
    def threads(self) -> int:
        return LANES * (self.warps * self.subs + self.producers)

    @property
    def width(self) -> int:
        """Quads a staged row: the most a phase stages."""
        return max(len(q) for q in self.quads)


def _stride(words: int) -> int:  # tsq::stride_of
    return 0 if words == 0 else (((words + 3) // 4) | 1) * 4


SELECTORS = ("is_first_row", "is_last_row", "is_transition", "inv_zeroifier")
_OPS = {"add": "ts::add_mod", "sub": "ts::sub_mod", "mul": "ts::monty_mul"}


def panel_cols(part) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The partition's columns (local, then the next-row ones not local)
    and the positions of its local and next columns among them."""
    cols = [int(c) for c in part.local_cols]
    pos = {c: i for i, c in enumerate(cols)}
    for c in part.next_cols:
        if int(c) not in pos:
            pos[int(c)] = len(cols)
            cols.append(int(c))
    local = np.array([pos[int(c)] for c in part.local_cols], dtype=np.int64)
    nxt = np.array([pos[int(c)] for c in part.next_cols], dtype=np.int64)
    return np.array(cols, dtype=np.int64), local, nxt


@dataclasses.dataclass(frozen=True)
class Dag:
    """A traced constraint program: ``nodes`` (see ``values.ExprGraph``)
    and ``roots``, each constraint's node in alpha-power order."""

    nodes: Tuple[tuple, ...]
    roots: Tuple[int, ...]

    @functools.cached_property
    def key(self) -> str:
        return hashlib.sha256(repr((self.nodes, self.roots)).encode()).hexdigest()[:16]

    @functools.cached_property
    def _spans(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        out = []
        for row in (0, 1):
            pos = [n[2] for n in self.nodes if n[0] == "col" and n[1] == row]
            out.append((min(pos), max(pos) + 1) if pos else (0, 0))
        return tuple(out)

    def span(self, row: int) -> Tuple[int, int]:
        """[lo, hi) of the panel positions read on the current (0) or next
        (1) row; (0, 0) when none."""
        return self._spans[row]

    def staged(self, row: int) -> Tuple[int, int]:
        """The span of ``row`` widened to 16-byte bounds: what a tile
        stages with 16-byte copies."""
        lo, hi = self.span(row)
        return (0, 0) if hi == lo else (lo & ~3, (hi + 3) & ~3)

    def _chunk_quads(self) -> Tuple[Tuple[Tuple[int, ...], ...], Dict[int, Tuple[int, ...]]]:
        """The chunks (c = q // CHUNK, or c | NEXT) each constraint reads, and
        each chunk's quads (q, or q | NEXT) inside its panel's staged span."""
        spans = [(lo // 4, hi // 4) for lo, hi in (self.staged(0), self.staged(1))]
        per, quads = [], {}
        for r in self.roots:
            cs = set()
            for i in _closure(self.nodes, [r]):
                n = self.nodes[i]
                if n[0] != "col":
                    continue
                c, tag, (lo, hi) = n[2] // 4 // CHUNK, NEXT if n[1] else 0, spans[n[1]]
                cs.add(c | tag)
                quads.setdefault(c | tag, tuple(q | tag for q in range(max(lo, c * CHUNK), min(hi, (c + 1) * CHUNK))))
            per.append(tuple(sorted(cs, reverse=True)))
        return tuple(per), quads

    def _phases(self, budget: int) -> List[Tuple[List[int], set]]:
        """The constraints in phases of at most ``budget`` quads (more only
        for a constraint that reads more alone), in whole chunks: ordered by
        the chunks they read, highest first, so that constraints on the same
        chunks meet, then cut greedily.  Returns each phase's constraints
        and quads."""
        per, quads = self._chunk_quads()
        out: List[Tuple[List[int], set]] = []
        for k in sorted(range(len(self.roots)), key=lambda k: (per[k], k)):
            new = {q for c in per[k] for q in quads[c]}
            if not out or len(out[-1][1] | new) > budget:
                out.append(([], set()))
            out[-1][0].append(k)
            out[-1][1].update(new)
        return out

    def plan(self) -> Plan:
        """The kernel's shape: the most row groups of LANES rows of WARPS for
        which a phase holds every constraint's chunks (else the fewest), the
        phases of the most quads a row whose ring of STAGES units fits a
        block, CONSUMERS consumer warps in all and one producer warp a row
        group."""
        per, quads = self._chunk_quads()
        alone = max(len({q for c in cs for q in quads[c]}) for cs in per)
        for w in WARPS:
            budget = max(1, (SMEM_LIMIT // 4 - 4 * len(self.roots)) // (STAGES * LANES * w * 4))
            if budget >= alone or w == WARPS[-1]:
                break
        while True:
            phases = self._phases(budget)
            plan = Plan(w, STAGES, tuple(tuple(ks) for ks, _ in phases), tuple(tuple(sorted(qs)) for _, qs in phases),
                        w, max(1, CONSUMERS // w))
            if budget == 1 or self.smem_bytes(plan) <= SMEM_LIMIT:
                return plan
            budget -= 1

    def smem_bytes(self, plan: Plan = None) -> int:
        """Shared memory of a block: ``tsq::Layout``'s dynamic buffer (the
        ring of staged units, the alpha powers, the phases' quad tables, the
        shares' sums) and the ring's mbarriers, ``full`` and ``empty`` (8 B
        each a stage, static)."""
        plan = plan or self.plan()
        rows = LANES * plan.warps
        table = (len(plan.phases) * plan.width + 1) // 2
        return 4 * (plan.stages * rows * _stride(4 * plan.width) + 4 * len(self.roots) + (table + 3) // 4 * 4
                    + 2 * (plan.subs - 1) * rows * 4) + 2 * 8 * plan.stages


@dataclasses.dataclass(frozen=True)
class Program:
    """One kernel call's constraints: a partition (or the whole AIR) over a
    panel whose columns are the global columns ``cols``; its current row
    reads ``local_cols`` at panel positions ``local_pos``, its next row
    ``next_cols`` at ``next_pos``; ``offset`` is its first alpha power."""

    name: str
    eval_fn: object
    cols: np.ndarray
    local_cols: np.ndarray
    next_cols: np.ndarray
    local_pos: np.ndarray
    next_pos: np.ndarray
    dag: Dag
    offset: int

    @property
    def count(self) -> int:
        return len(self.dag.roots)


def _closure(nodes, roots) -> set:
    need, stack = set(), list(roots)
    while stack:
        i = stack.pop()
        if i in need:
            continue
        need.add(i)
        if nodes[i][0] in _OPS or nodes[i][0] == "neg":
            stack.extend(nodes[i][1:])
    return need


def _trace(eval_fn, width: int, num_pis: int, local, next_, local_pos, next_pos) -> Dag:
    """The eval's DAG, cut to the nodes its constraints reach (renumbered
    in creation order)."""
    b = TracingAirBuilder(
        width, num_pis,
        {int(c): int(p) for c, p in zip(local, local_pos)},
        {int(c): int(p) for c, p in zip(next_, next_pos)},
    )
    eval_fn(b)
    if b.constraint_count != len(b.roots):
        raise AssertionError(f"traced {len(b.roots)} constraints, counted {b.constraint_count}")
    nodes = b.graph.nodes
    keep = sorted(_closure(nodes, b.roots))
    new = {old: i for i, old in enumerate(keep)}
    pruned = []
    for i in keep:
        n = nodes[i]
        pruned.append((n[0], *(new[a] for a in n[1:])) if n[0] in _OPS or n[0] == "neg" else n)
    return Dag(tuple(pruned), tuple(new[r] for r in b.roots))


# the attribute of an AIR instance under which its programs are kept (num_pis
# -> programs): its ``eval`` and partitions may depend on its state, and the
# programs go with it
_PROGRAMS_ATTR = "_quotient_programs"


def programs(air: BaseAir, num_pis: int) -> List[Program]:
    """The AIR's K7 programs in constraint order: one a partition, or one
    for the whole ``eval`` over every column when it has none.  Traced once
    an AIR instance and number of public values: an AIR's constraints must
    not change after its first quotient."""
    cached = vars(air).setdefault(_PROGRAMS_ATTR, {})
    if num_pis not in cached:
        parts = air.partitions()
        out, off = [], 0
        width = int(air.width)
        if parts is None:
            cols = np.arange(width, dtype=np.int64)
            items = [("air", air.eval, cols, cols, cols, cols, cols)]
        else:
            items = []
            for part in parts:
                cols, local_pos, next_pos = panel_cols(part)
                items.append((part.name, part.eval, cols, part.local_cols, part.next_cols, local_pos, next_pos))
        for name, fn, cols, local, next_, local_pos, next_pos in items:
            dag = _trace(fn, width, num_pis, local, next_, local_pos, next_pos)
            out.append(Program(name, fn, cols, np.asarray(local), np.asarray(next_), local_pos, next_pos, dag, off))
            off += len(dag.roots)
        cached[num_pis] = out
    return cached[num_pis]


# ---------------------------------------------------------------------------
# code generation
# ---------------------------------------------------------------------------
def _phase_source(dag: Dag, ks: Sequence[int], quads: Sequence[int], folds_before: int, total: int) -> List[str]:
    """Straight-line code of one phase's share, constraints ``ks``, on a
    thread's row: every node they need in creation order, each constraint
    folded right after its node, the sums settled after every fourth of the
    thread's ``total`` folds (``folds_before`` in the phases before this
    one).  A column is read from the row's staged quads (slot s holds
    ``quads[s]``), a quad at a time, at the first node that needs one of
    its columns."""
    nodes, roots = dag.nodes, dag.roots
    slot = {q: i for i, q in enumerate(quads)}
    folds: Dict[int, List[int]] = {}
    for k in ks:
        folds.setdefault(roots[k], []).append(k)
    loaded, lines, n_folds = set(), [], folds_before
    for i in sorted(_closure(nodes, [roots[k] for k in ks])):
        n = nodes[i]
        if n[0] == "col":
            sl = slot[n[2] // 4 | (NEXT if n[1] else 0)]
            if sl not in loaded:
                loaded.add(sl)
                lines.append(f"    const uint4 q{sl} = tsq::quad(lc, {sl});")
            expr = f"q{sl}.{'xyzw'[n[2] % 4]}"
        elif n[0] == "sel":
            expr = f"tsq::sel_at(a, {SELECTORS.index(n[1])}, t)"
        elif n[0] == "pub":
            expr = f"__ldg(a.pis + {n[1]})"
        elif n[0] == "const":
            expr = f"{bb.monty_scalar(n[1])}u"
        elif n[0] == "neg":
            expr = f"ts::sub_mod(0u, v{n[1]})"
        else:
            expr = f"{_OPS[n[0]]}(v{n[1]}, v{n[2]})"
        lines.append(f"    const uint32_t v{i} = {expr};")
        for k in folds.get(i, ()):
            lines.append(f"    tsq::fold(acc, al[{k}], v{i});")
            n_folds += 1
            if n_folds % 4 == 0 and n_folds < total:
                lines.append("    tsq::settle(acc);")
    return lines


def _struct_source(dag: Dag, plan: Plan) -> str:
    """The DAG's struct for ``tsq::quotient_kernel``: spans, shape, the
    phases' quad tables and each share's code."""
    key = dag.key
    (lo0, hi0), (lo1, hi1) = dag.span(0), dag.span(1)
    g, q = len(plan.phases), plan.width
    table = [e for qs in plan.quads for e in list(qs) + [NONE] * (q - len(qs))]
    sig = "(const tsq::Args& a, const uint32_t* lc, int64_t t, uint64_t* acc, const uint4* al)"
    out = [
        f"// {len(dag.roots)} constraints over {len(dag.nodes)} nodes; current row [{lo0}, {hi0}), "
        f"next row [{lo1}, {hi1}); {g} phases of at most {q} quads",
        "namespace {",
        f"__device__ const uint16_t kQuads_{key}[{g * q}] = {{{', '.join(map(str, table))}}};",
        f"struct Q_{key} {{",
        f"  static constexpr int lo0 = {lo0}, hi0 = {hi0}, lo1 = {lo1}, hi1 = {hi1};",
        f"  static constexpr int NW = {plan.warps}, S = {plan.subs}, NP = {plan.producers}, NS = {plan.stages}, "
        f"G = {g}, Q = {q}, C = {len(dag.roots)};",
        f"  __device__ __forceinline__ static const uint16_t* quads() {{ return kQuads_{key}; }}",
    ]
    shares = [plan.split(p) for p in range(g)]
    for j in range(plan.subs):
        folds, total = 0, sum(len(sh[j]) for sh in shares)
        for p in range(g):
            out.append(f"  __device__ __forceinline__ static void phase{p}_{j}{sig} {{")
            out.append("    (void)a; (void)lc; (void)t; (void)acc; (void)al;")
            out.extend(_phase_source(dag, shares[p][j], plan.quads[p], folds, total))
            out.append("  }")
            folds += len(shares[p][j])
    out.append(f"  __device__ __forceinline__ static void phase(int g, int j, {sig[1:]} {{")
    out.append("    switch (g * S + j) {")
    for p in range(g):
        for j in range(plan.subs):
            out.append(f"      case {p * plan.subs + j}: phase{p}_{j}(a, lc, t, acc, al); break;")
    out.append("    }")
    out.append("  }")
    out.append("};")
    out.append("}  // namespace")
    out.append("#ifdef __CUDACC__")
    out.append(f'extern "C" int ts_q_init_{key}(int* blocks_per_sm) {{ return tsq::init<Q_{key}>(blocks_per_sm); }}')
    out.append(f'extern "C" int ts_q_{key}(const int64_t* w, cudaStream_t stream) {{')
    out.append(f"  return tsq::launch<Q_{key}>(w, stream);")
    out.append("}")
    out.append("#endif")
    return "\n".join(out) + "\n"


def source(dag: Dag) -> str:
    """The CUDA source of the DAG's kernel under ``dag.plan()`` (a pure
    function of the DAG)."""
    plan = dag.plan()
    if plan.threads > MAX_THREADS or dag.smem_bytes(plan) > SMEM_LIMIT:
        raise ValueError(f"the quotient program {dag.key} needs {dag.smem_bytes(plan)} B of shared memory a block "
                         f"and {plan.threads} threads at {plan.warps} row groups, {plan.stages} stages and "
                         f"{plan.width} quads a row")
    return (f"// K7, generated by tpu_stark_torch/air/quotient_kernel.py from a constraint DAG: do not edit.\n"
            f'#include "{HEADER}"\n\n' + _struct_source(dag, plan))


def distinct_dags(progs: Sequence[Program]) -> List[Dag]:
    seen: Dict[str, Dag] = {}
    for p in progs:
        seen.setdefault(p.dag.key, p.dag)
    return list(seen.values())


_FNS: Dict[str, object] = {}


def _entry(dag: Dag):
    """The DAG's launch function; at load, its library's ``init`` sets the
    kernel's shared memory and grid once."""
    fn = _FNS.get(dag.key)
    if fn is None:
        lib = kernels.generated_lib(dag.key, source(dag))
        init = getattr(lib, f"ts_q_init_{dag.key}")
        init.argtypes, init.restype = [ctypes.c_void_p], ctypes.c_int
        kernels.check(init(None), f"quotient eval init {dag.key}")
        fn = getattr(lib, f"ts_q_{dag.key}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dag.key] = fn
    return fn


def _vec(dag: Dag, row: int, t: torch.Tensor) -> bool:
    """Whether a panel takes the kernel's 16-byte copies of ``dag.staged``:
    a 16-byte aligned base and row stride, and the widened span inside its
    columns."""
    return t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 and dag.staged(row)[1] <= int(t.shape[1])


# ---------------------------------------------------------------------------
# K7: the wrapper and its plain version
# ---------------------------------------------------------------------------
def _on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` launches its kernel (a CUDA tensor) or
    runs its plain version (the CPU; ``meta`` for the SoL report's audit)."""
    return t.device.type == "cuda"


def _check_i32(name: str, t: torch.Tensor, dim: int) -> None:
    if t.dtype != torch.int32 or t.dim() != dim:
        raise ValueError(f"{name}: want an int32 tensor of {dim} dimensions, got {t.dtype} {tuple(t.shape)}")


def eval_fold(prog: Program, cur: torch.Tensor, nxt: torch.Tensor, nshift: int, sels: Dict[str, torch.Tensor],
              sel_off: int, sel_stride: int, pis: torch.Tensor, alpha: torch.Tensor, acc: torch.Tensor,
              acc_off: int, acc_stride: int, add: bool, invz: bool) -> torch.Tensor:
    """K7 over rows t < len(cur): the program's constraints on the current
    row ``cur[t]`` (panel columns ``prog.cols``) and the next row
    ``nxt[(t + nshift) % len(nxt)]``, with selector values ``sels[name][
    sel_off + t * sel_stride]``, the public values ``pis`` (k,) and the
    program's alpha powers ``alpha`` (C, 4), all Monty; the (4,) sum of
    alpha^k * C_k, plus the accumulator's row when ``add``, times
    ``inv_zeroifier`` when ``invz``, replaces row acc_off + t * acc_stride
    of ``acc`` (N, 4), in place.  Returns ``acc``.  A CPU tensor runs
    ``eval_fold_plain``; on the card a failed build or launch raises."""
    if not _on_card(cur):
        return eval_fold_plain(prog, cur, nxt, nshift, sels, sel_off, sel_stride, pis, alpha, acc, acc_off,
                               acc_stride, add, invz)
    fn = _entry(prog.dag)  # builds the library (or raises) before any launch
    rows, nrows = int(cur.shape[0]), int(nxt.shape[0])
    for name, t, d in (("cur", cur, 2), ("nxt", nxt, 2), ("pis", pis, 1), ("alpha", alpha, 2), ("acc", acc, 2)):
        _check_i32(name, t, d)
    if cur.stride(1) != 1 or nxt.stride(1) != 1 or int(cur.shape[1]) < prog.dag.span(0)[1] \
            or int(nxt.shape[1]) < prog.dag.span(1)[1]:
        raise ValueError("eval_fold: the panels must hold the program's columns with unit column stride")
    if not (alpha.is_contiguous() and acc.is_contiguous() and pis.is_contiguous()) \
            or int(alpha.shape[0]) != prog.count or alpha.data_ptr() % 16 or acc.data_ptr() % 16:
        raise ValueError("eval_fold: alpha (C, 4) and acc (N, 4) must be contiguous and 16-byte aligned")
    if rows > nrows or not 0 <= nshift <= nrows:
        raise ValueError(f"eval_fold: {rows} rows, {nrows} next rows, shift {nshift}")
    if rows and acc_off + (rows - 1) * acc_stride >= int(acc.shape[0]):
        raise ValueError("eval_fold: the accumulator rows run past acc")
    ptrs = []
    for name in SELECTORS:
        s = sels[name]
        _check_i32(name, s, 1)
        if not s.is_contiguous() or (rows and sel_off + (rows - 1) * sel_stride >= int(s.shape[0])):
            raise ValueError(f"eval_fold: selector {name} of {tuple(s.shape)} rows")
        ptrs.append(s.data_ptr())
    vec = int(_vec(prog.dag, 0, cur)) | 2 * int(_vec(prog.dag, 1, nxt))
    words = (ctypes.c_int64 * 21)(
        cur.data_ptr(), cur.stride(0), nxt.data_ptr(), nxt.stride(0), nrows, nshift, *ptrs, sel_off, sel_stride,
        pis.data_ptr(), alpha.data_ptr(), acc.data_ptr(), acc_off, acc_stride, int(add), int(invz), rows, vec,
    )
    kernels.QUOTIENT_EVAL.launches += 1
    kernels.check(fn(words, kernels.stream_handle(cur.device)), f"quotient eval {prog.name}")
    return acc


def eval_fold_plain(prog: Program, cur: torch.Tensor, nxt: torch.Tensor, nshift: int, sels: Dict[str, torch.Tensor],
                    sel_off: int, sel_stride: int, pis: torch.Tensor, alpha: torch.Tensor, acc: torch.Tensor,
                    acc_off: int, acc_stride: int, add: bool, invz: bool) -> torch.Tensor:
    """``eval_fold`` in plain torch: the program's eval over a
    ``PartitionBuilder`` and ``folded_constraints``."""
    rows = int(cur.shape[0])
    t = torch.arange(rows, device=cur.device)
    nxt_rows = nxt if nshift == 0 and int(nxt.shape[0]) == rows else nxt[(t + nshift) % int(nxt.shape[0])]
    at = sel_off + t * sel_stride
    sel = {name: sels[name][at] for name in SELECTORS}
    b = PartitionBuilder(cur[:, torch.as_tensor(prog.local_pos, device=cur.device)],
                         nxt_rows[:, torch.as_tensor(prog.next_pos, device=cur.device)],
                         prog.local_cols, prog.next_cols, sel, [DevVal(pis[i]) for i in range(int(pis.shape[0]))])
    prog.eval_fn(b)
    folded = b.folded_constraints(alpha)
    idx = acc_off + t * acc_stride
    if add:
        folded = ext4.add(folded, acc[idx])
    if invz:
        folded = ext4.mul_base(folded, sel["inv_zeroifier"])
    acc[idx] = folded
    return acc


# ---------------------------------------------------------------------------
# K8: the panel coset fold
# ---------------------------------------------------------------------------
MAX_FOLD_BLOCKS = 32  # row blocks a coset (csrc/quotient.cu kMaxR)
_FOLD_CONSTS = MAX_FOLD_BLOCKS + MAX_FOLD_BLOCKS // 2 + 2 * MAX_FOLD_BLOCKS


def _fold_shape(tf: torch.Tensor, log_m: int, r: int) -> Tuple[int, int, int]:
    """(npan, m, u) of a fold of ``tf`` into r blocks of m = 2^log_m rows;
    raises unless npan = n_coef / m is r (the trace's n coefficients) or 2 r
    (zk's 2n) and r a power of two up to MAX_FOLD_BLOCKS."""
    n_coef, u = int(tf.shape[0]), int(tf.shape[1])
    m = 1 << log_m
    if r < 1 or r & (r - 1) or r > MAX_FOLD_BLOCKS or n_coef not in (r * m, 2 * r * m):
        raise ValueError(f"panel_fold: {r} blocks of {m} rows from {n_coef} coefficients")
    return n_coef // m, m, u


def _fold_vec(t: torch.Tensor, out: torch.Tensor, m: int, u: int, r: int) -> bool:
    """Whether K8 streams 16-byte groups of words (its segments of rows then
    start 16-byte aligned, whatever u is): m a multiple of 4, u >= 4, both
    bases 16-byte aligned and at most 8 blocks."""
    return m % 4 == 0 and u >= 4 and r <= 8 and t.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0


def panel_fold(tf: torch.Tensor, log_m: int, shift: int, r: int) -> torch.Tensor:
    """K8: the (r, m, u) Monty panels of one quotient coset shift * <g>
    (g of order r m = r 2^log_m) from its (npan m, u) Monty coefficient
    columns ``tf`` (npan = r, or 2 r in zk): ``out[k]`` is the fold onto
    block k, the points shift g^k * <g_m> (coefficients q m + i join i with
    weight (shift g^k)^(m q)), scaled by (shift g^k)^i: the NTT's input.
    One read of ``tf`` for all r blocks.  A CPU tensor runs
    ``panel_fold_plain``; on the card a failed build or launch raises."""
    if not _on_card(tf):
        return panel_fold_plain(tf, log_m, shift, r)
    so = kernels.lib()
    _check_i32("tf", tf, 2)
    npan, m, u = _fold_shape(tf, log_m, r)
    if not tf.is_contiguous():
        raise ValueError(f"panel_fold: a contiguous operand, got strides {tf.stride()}")
    out = torch.empty((r, m, u), dtype=torch.int32, device=tf.device)
    if out.numel() == 0:
        return out
    words = (ctypes.c_int64 * 7)(tf.data_ptr(), out.data_ptr(), npan, m, u, r.bit_length() - 1,
                                 int(_fold_vec(tf, out, m, u, r)))
    kernels.PANEL_FOLD.launches += 1
    kernels.check(so.ts_panel_fold(words, _fold_consts(shift % bb.P, log_m, r, npan),
                                   kernels.stream_handle(tf.device)), "panel fold")
    return out


@functools.lru_cache(maxsize=256)
def _fold_consts(s: int, log_m: int, r: int, npan: int):
    """K8's constants, Monty: S g^k (k < r), w^j (j < r/2), S^(m q) (q <
    npan), each list padded to the kernel's length (the partitions of a
    coset share them)."""
    m = 1 << log_m
    g = bb.two_adic_generator(log_m + r.bit_length() - 1)
    w, s_m = pow(g, m, bb.P), pow(s, m, bb.P)
    consts = [s * pow(g, k, bb.P) for k in range(r)] + [0] * (MAX_FOLD_BLOCKS - r)
    consts += [pow(w, j, bb.P) for j in range(r // 2)] + [0] * (MAX_FOLD_BLOCKS // 2 - r // 2)
    consts += [pow(s_m, q, bb.P) for q in range(npan)] + [0] * (2 * MAX_FOLD_BLOCKS - npan)
    return (ctypes.c_uint32 * _FOLD_CONSTS)(*(bb.monty_scalar(c) for c in consts))


def panel_fold_plain(tf: torch.Tensor, log_m: int, shift: int, r: int) -> torch.Tensor:
    """``panel_fold`` in plain torch (int64 products): the coefficients
    scaled by shift^(m q) and summed by q mod r, their r-point DFT across
    the blocks by w = g^m, block k scaled by (shift g^k)^i."""
    npan, m, u = _fold_shape(tf, log_m, r)
    s = shift % bb.P
    g = bb.two_adic_generator(log_m + r.bit_length() - 1)
    w, s_m = pow(g, m, bb.P), pow(s, m, bb.P)
    b = []
    for t in range(r):
        acc = tf[t * m : (t + 1) * m] if t == 0 else bb.mul_canonical(tf[t * m : (t + 1) * m], pow(s_m, t, bb.P))
        for q in range(t + r, npan, r):
            acc = bb.add(acc, bb.mul_canonical(tf[q * m : (q + 1) * m], pow(s_m, q, bb.P)))
        b.append(acc)
    out = torch.empty((r, m, u), dtype=torch.int32, device=tf.device)
    for k in range(r):
        acc = b[0]
        for t in range(1, r):
            acc = bb.add(acc, bb.mul_canonical(b[t], pow(w, k * t, bb.P)))
        out[k] = bb.mul_canonical(acc, bb.powers(s * pow(g, k, bb.P), m, tf.device)[:, None])
    return out
