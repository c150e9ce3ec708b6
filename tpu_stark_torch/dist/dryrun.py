"""Run ranks on one machine, and the multi-rank dry run (counterpart of
``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``).

``run_ranks(world, fn, *args)`` spawns ``world`` processes, joins them in
one ``torch.distributed`` group through a ``file://`` rendezvous in a
private temporary directory (so concurrent runs never contend for a port),
calls ``fn(mesh, *args)`` in each with its ``RowMesh``, and returns every
rank's result in rank order.  A rank that raises or exits without a result
fails the run: the other ranks are stopped and ``run_ranks`` raises with
the rank's traceback.  ``fn`` must be importable by name (a module-level
function); the workers here import nothing of the JAX package.

``dryrun_multichip(world, log_n=10, device=..., backend=...)`` runs, in
``world`` ranks, the JAX package's dry-run checks, each against the
single-device bytes or root:

* the sharded zk prove on the Keccak stack and on the Poseidon2 stack;
* for an even world of at least 4, a simulated 2-host pod;
* the column-sharded LDE commit and the row-sharded quotient;
* the streamed wide prove of keccak-air cut to four partitions
  (``prove_keccak_air``: 3 permutations, 2048-column chunks, Poseidon2, zk
  off), against the single-device proof;
* the sharded zk prove at 2^log_n rows (JAX's ``TPU_STARK_DRYRUN_LOG``).

``prove_fib`` and ``prove_keccak_air`` (the streamed wide prove, BASELINE
config 4 by default) are the rank workers that prove and measure.

CLI: ``python -m tpu_stark_torch.dist.dryrun --ranks N [--device cpu|cuda]
[--backend gloo|nccl] [--log-n K]``.  Like the port's other entry points,
the runner, the dry run and the CLI run on the card unless asked for
``cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import queue
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .comm import make_row_mesh

# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------
def _rank_main(rank: int, world: int, init: str, backend: str, device: str, threads: int,
               fn: Callable, args: tuple, results) -> None:
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
        out = fn(make_row_mesh(device=dev), *args)
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))  # the parent reports it and stops the other ranks
        raise


def run_ranks(world: int, fn: Callable, *args, backend: str = "gloo", device: str = "cuda",
              threads: int = 1, timeout: float = 900.0) -> List:
    """``fn(mesh, *args)`` in ``world`` spawned ranks; their results in rank
    order.  ``device`` "cuda" (the default) gives rank r card r mod the
    card count, and "cpu" runs the ranks on the CPU;
    ``threads`` caps each rank's torch threads."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory(prefix="ts_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(r, world, init, backend, device, threads, fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in got and p.exitcode is not None:
                            raise RuntimeError(f"rank {r} of {world} exited ({p.exitcode}) without a result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world} ranks did not finish in {timeout:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
                got[rank] = payload
            for r, p in enumerate(procs):
                p.join(timeout=60)
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} of {world} exited with {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    return [got[r] for r in range(world)]


def run_plan(mesh, plan) -> List[Optional[list]]:
    """Run several workers in one rank process: ``plan`` is a list of
    (size, [(fn, args), ...]); each group of calls runs on the subgroup of
    the first ``size`` ranks (every rank takes part in making it), and a
    rank outside it returns None for the group."""
    out = []
    for size, calls in plan:
        sub = mesh
        if size != mesh.size:
            group = dist.new_group(list(range(size)))
            sub = make_row_mesh(group, mesh.device) if mesh.rank < size else None
        out.append(None if sub is None else [fn(sub, *args) for fn, args in calls])
    return out


# ---------------------------------------------------------------------------
# Rank workers
# ---------------------------------------------------------------------------
def _fib(n: int):
    from ..air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows

    return FibonacciAir(), generate_trace_rows(0, 1, n), [0, 1, fibonacci_value(0, 1, n)]


def _measured_prove(mesh, cfg, prove_once, verify_once, label: str, single: bool, verify_it: bool) -> dict:
    """Run ``prove_once(config) -> (proof, timings)`` on the mesh and
    measure it (see ``prove_fib``); rank 0 also proves on one device and
    compares the bytes (``single``) and verifies (``verify_it``)."""
    from .. import kernels
    from ..prover.proof import serialize_proof

    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    mesh.reset_counts()
    before = {k.name: k.launches for k in kernels.ALL}
    t0 = time.perf_counter()
    config = cfg(mesh)
    proof, timings = prove_once(config)
    if cuda:
        torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - t0
    blob = serialize_proof(proof)
    pcs = config.pcs
    out = {
        "rank": mesh.rank, "transport": mesh.transport, "device": str(mesh.device),
        "sha256": hashlib.sha256(blob).hexdigest(), "len": len(blob), "wall_s": wall, "phases": timings,
        "peak_gib": torch.cuda.max_memory_allocated(mesh.device) / 2**30 if cuda else None,
        "sent": dict(mesh.sent), "staged": mesh.staged, "comm_s": dict(mesh.seconds),
        "launches": {k.name: k.launches - before[k.name] for k in kernels.ALL if k.launches > before[k.name]},
        "largest_gather": mesh.largest_gather,
        "largest_whole_commit": max(pcs.val_mmcs.largest_whole, pcs.challenge_mmcs.largest_whole),
    }
    if mesh.rank == 0:
        out["blob"] = blob
        if single and serialize_proof(prove_once(cfg(None))[0]) != blob:
            raise AssertionError(f"the sharded proof of {label} differs from the single-device proof")
        if verify_it and not verify_once(cfg(None), proof):
            raise AssertionError(f"the sharded proof of {label} does not verify")
    return out


def prove_fib(mesh, log_n: int, trace_path: Optional[str] = None, benchmark_fri: bool = False,
              hash: str = "keccak", zk: bool = True, zk_rng: str = "device", zk_layout: str = "tpu",
              single: bool = False, verify_it: bool = False) -> dict:
    """Prove fib_air at 2^log_n rows on the mesh (the trace loaded from
    ``trace_path``, an ``.npy`` file, or generated); return the proof
    (bytes on rank 0), its SHA-256 and length, this rank's wall clock,
    phase times, peak device memory (cuda), bytes sent and seconds spent
    by collective, staged bytes, the prove's kernel launches (the counts
    are not reset), transport, and the
    largest all-gather and whole commit.  ``single``: rank 0 also
    proves on one device and checks the bytes; ``verify_it``: rank 0
    verifies the proof."""
    from ..air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
    from ..fri.config import create_benchmark_fri_params
    from ..prover.config import create_config
    from ..prover.prove import prove
    from ..prover.verify import verify

    n = 1 << log_n
    air = FibonacciAir()
    trace = generate_trace_rows(0, 1, n) if trace_path is None else np.load(trace_path)
    pis = [0, 1, fibonacci_value(0, 1, n)]
    fri = create_benchmark_fri_params(1) if benchmark_fri else None

    def cfg(m):
        return create_config(fri, zk=zk, hash=hash, mesh=m, zk_rng=zk_rng, zk_layout=zk_layout, device=mesh.device)

    def prove_once(config):
        timings = {}
        return prove(config, air, trace, pis, timings=timings), timings

    return _measured_prove(mesh, cfg, prove_once, lambda config, proof: verify(config, air, proof, pis),
                           f"2^{log_n} rows", single, verify_it)


def keccak_subset_air(names):
    """keccak-air cut to the partitions ``names`` (the JAX package's
    ``SubsetAir`` of its sharded wide test and dry run): the full width,
    those partitions' constraints only."""
    from ..air.air import BaseAir
    from ..air.keccak_air import COLS, KeccakAir

    keep = [p for p in KeccakAir().partitions() if p.name in set(names)]

    class SubsetAir(BaseAir):
        width = COLS

        def partitions(self):
            return keep

        def eval(self, b):
            for p in keep:
                p.eval(b)

    return SubsetAir()


# the JAX package's dry-run subset (``_dryrun_wide_sharded_prove``)
DRYRUN_PARTITIONS = ("flags", "theta0", "apdef0", "trans1")


def prove_keccak_air(mesh, log_n: Optional[int] = None, perms: Optional[int] = None, hash: str = "poseidon2",
                     zk: bool = False, benchmark_fri: bool = True, col_chunk: Optional[int] = None,
                     trace_path: Optional[str] = None, single: bool = False, verify_it: bool = False,
                     seed: int = 1, partitions=None) -> dict:
    """Prove keccak-air through ``prove_wide`` on the mesh: BASELINE config
    4 by default (Poseidon2, zk off, benchmark FRI).  The trace: loaded
    from ``trace_path`` (an ``.npy`` of 0/1 bits), or ``perms`` random
    permutations, or 2^log_n rows of them (``generate_trace(2^log_n //
    24, seed)``, cut to 2^log_n rows, as the JAX package's benchmark
    makes it).  ``partitions``: prove the ``keccak_subset_air`` of those
    partitions.  Returns what ``prove_fib`` returns."""
    from ..air.keccak_air import NUM_ROUNDS, KeccakAir, generate_trace
    from ..fri.config import create_benchmark_fri_params
    from ..prover import wide
    from ..prover.config import create_config
    from ..prover.verify import verify

    dev = mesh.device
    if trace_path is not None:
        trace = torch.from_numpy(np.load(trace_path)).to(dev)
        label = f"keccak-air {tuple(trace.shape)}"
    elif log_n is not None:
        trace = generate_trace((1 << log_n) // NUM_ROUNDS, seed=seed, device=dev)[: 1 << log_n]
        label = f"keccak-air 2^{log_n}"
    else:
        trace = generate_trace(perms, seed=seed, device=dev)
        label = f"keccak-air of {perms} permutations"
    air = KeccakAir() if partitions is None else keccak_subset_air(partitions)
    fri = create_benchmark_fri_params(1) if benchmark_fri else None

    def cfg(m):
        return create_config(fri, zk=zk, hash=hash, mesh=m, device=dev)

    def prove_once(config):
        timings = {}
        return wide.prove_wide(config, air, trace, [], col_chunk=col_chunk, timings=timings), timings

    return _measured_prove(mesh, cfg, prove_once, lambda config, proof: verify(config, air, proof, []),
                           label, single, verify_it)


def wide_source_blocks(mesh, trace: np.ndarray, log_blowup: int, col_chunk: int, zk_seed: Optional[int],
                       points) -> dict:
    """A ``ShardedWideSource`` of ``trace`` (uint8 bits) on the mesh: this
    rank's block of every chunk's bit-reversed LDE, its rows 1 and 0 read
    by block-local index, the columns' values at ``points`` (plain-frame
    ext points), and the most rows of a chunk's randomizer that one of its
    draws took."""
    from ..fields import babybear as bb
    from ..fri.domains import TwoAdicCoset
    from ..ntt.dft import Dft
    from ..prover.wide import ShardedWideSource

    t = torch.from_numpy(trace).to(mesh.device)
    src = ShardedWideSource(t, Dft(mesh.device), log_blowup, TwoAdicCoset(int(trace.shape[0]).bit_length() - 1, 1),
                            mesh, col_chunk=col_chunk, zk_seed=zk_seed)
    blocks = [bb.to_numpy(src.lde_br_chunk(off, wc)) for off, wc in src.chunks()]
    return {"row0": src.row0, "blocks": blocks, "rows_1_0": bb.to_numpy(src[[1, 0]]),
            "evals": [bb.to_numpy(v) for v in src.eval_at_points(points)], "rand_rows": src.rand_rows}


def ntt_rank(mesh, cases) -> List[np.ndarray]:
    """For each case (name of a ``dist.ntt`` function, a global Monty
    matrix, the function's further arguments), this rank's block of the
    function applied to the rank's block of the matrix."""
    from ..fields import babybear as bb
    from . import ntt as dntt
    from .comm import block

    out = []
    for name, x, args in cases:
        r0, rows = block(mesh, int(x.shape[0]))
        got = getattr(dntt, name)(mesh, bb.to_tensor(x[r0 : r0 + rows], mesh.device), *args)
        out.append(bb.to_numpy(got))
    return out


def column_commit(mesh, trace: np.ndarray, log_blowup: int):
    """``sharded_lde_commit`` and ``sharded_prove_step`` of the rank's
    block of the columns of ``trace`` (a global Monty matrix): (the root,
    the rank's rows of the bit-reversed LDE, the step's root and sum)."""
    from ..fields import babybear as bb
    from .sharded import sharded_lde_commit, sharded_prove_step

    cols = int(trace.shape[1]) // mesh.size
    mine = bb.to_tensor(np.ascontiguousarray(trace[:, mesh.rank * cols : (mesh.rank + 1) * cols]), mesh.device)
    rows, root = sharded_lde_commit(mesh, mine, log_blowup)
    return tuple(root), bb.to_numpy(rows), sharded_prove_step(mesh, mine, log_blowup)


def multi_height_commit(mesh, evals: List[np.ndarray], as_block: List[bool], queries: List[int],
                        zk: bool, zk_layout: str = "tpu") -> dict:
    """``ShardedPcs.commit`` of matrices of several heights (``evals``:
    global Monty matrices, each its evaluations on the plain subgroup of its
    height; a matrix marked in ``as_block`` is handed over as the rank's row
    block, the others whole) on the Keccak stack, hiding when ``zk``: the
    root, the rank's blocks of the committed LDEs and of the coefficients,
    the domains and widths, and the MMCS openings at ``queries``."""
    from ..fields import babybear as bb
    from ..fri.domains import TwoAdicCoset
    from ..prover.config import create_config
    from .comm import block

    pcs = create_config(zk=zk, zk_layout=zk_layout, mesh=mesh, device=mesh.device).pcs
    items = []
    for e, part in zip(evals, as_block):
        h = int(e.shape[0])
        r0, rows = block(mesh, h) if part else (0, h)
        items.append((TwoAdicCoset(h.bit_length() - 1), bb.to_tensor(np.ascontiguousarray(e[r0 : r0 + rows]),
                                                                     mesh.device)))
    root, data = pcs.commit(items)
    openings = pcs.val_mmcs.open_batch_many(queries, data.merkle)
    return {"root": tuple(root), "ldes": [bb.to_numpy(m) for m in data.merkle.matrices],
            "r_coeffs": [bb.to_numpy(r) for r in data.r_coeffs],
            "domains": [(d.log_n, d.shift) for d in data.domains], "widths": list(data.widths),
            "openings": [(o.opened_values, o.opened_salts, o.proof) for o in openings]}


def fib_quotient(mesh, log_n: int, alpha=(3, 1, 4, 1)):
    """The row-sharded quotient of fib_air (not zk) at 2^log_n rows, as
    JAX's test builds its inputs: (the rank's block, the single-device
    quotient of every row), Monty."""
    from ..air.air import get_symbolic_info
    from ..air.fibonacci import FibonacciAir
    from ..fields import babybear as bb
    from ..fields import ref_field as rf
    from ..prover.config import create_config
    from ..prover.prove import _quotient_values, get_log_quotient_degree
    from .comm import block
    from .sharded import sharded_quotient

    dev, n = mesh.device, 1 << log_n
    air = FibonacciAir()
    _, trace, pis = _fib(n)
    log_qd = get_log_quotient_degree(air, len(pis), zk=False)
    pcs = create_config(zk=False, device=dev).pcs
    dom = pcs.natural_domain_for_degree(n)
    _c, data = pcs.commit([(dom, bb.to_tensor(bb.np_to_monty(trace), dev))])
    t_on_q = pcs.get_evaluations_on_domain(data, 0, dom.create_disjoint_domain(n << log_qd))
    k, _ = get_symbolic_info(air, len(pis))
    apows = [(1, 0, 0, 0)]
    for _ in range(k - 1):
        apows.append(rf.emul(apows[-1], alpha))
    apows_dev = bb.to_tensor(bb.np_to_monty(np.array(apows, dtype=np.uint64)), dev)
    pis_dev = bb.to_tensor(bb.np_to_monty(np.array(pis, dtype=np.uint64)), dev)
    want = _quotient_values(air, t_on_q, pis_dev, apows_dev, log_n, log_n + log_qd)
    q0, nq = block(mesh, n << log_qd)
    got = sharded_quotient(mesh, air, t_on_q[q0 : q0 + nq], pis_dev, apows_dev, log_n, log_n + log_qd)
    return bb.to_numpy(got), bb.to_numpy(want)


def _column_checks(mesh) -> str:
    """The column-sharded commit (root and row block) and the row-sharded
    quotient against the single-device ones."""
    from ..commit.merkle import MerkleTreeMmcs
    from ..fields import babybear as bb
    from ..matrix import reverse_matrix_index_bits
    from ..ntt import radix2
    from .comm import block

    h, w = 64, 2 * mesh.size
    trace = bb.np_to_monty(np.random.default_rng(0).integers(0, bb.P, size=(h, w)).astype(np.uint32))
    root, rows, _step = column_commit(mesh, trace, 2)
    lde_br = reverse_matrix_index_bits(radix2.coset_lde_batch(bb.to_tensor(trace, mesh.device), 2, bb.GENERATOR))
    want_root, _ = MerkleTreeMmcs(lowmem_log=0).commit([lde_br])
    r0, nr = block(mesh, int(lde_br.shape[0]))
    if root != tuple(want_root) or not np.array_equal(rows, bb.to_numpy(lde_br[r0 : r0 + nr])):
        raise AssertionError("the column-sharded commit differs from the single-device commit")
    got, want = fib_quotient(mesh, 6)
    q0, nq = block(mesh, int(want.shape[0]))
    if not np.array_equal(got, want[q0 : q0 + nq]):
        raise AssertionError("the sharded quotient differs from the single-device quotient")
    return f"column-sharded commit ({h}, {w}) root and rows, sharded quotient of fib 2^6 equal"


def pod_prove(mesh, log_n: int, **kwargs) -> dict:
    """``prove_fib`` on a simulated pod of 2 hosts of n / 2 ranks."""
    from .multihost import simulate_pod_mesh

    return prove_fib(simulate_pod_mesh(2, mesh.size // 2, device=mesh.device), log_n, **kwargs)


def pod_order(mesh, hosts: List[str]) -> str:
    """Whether ``make_pod_mesh`` takes ranks on hosts ``hosts`` (by rank):
    "host-major", or its error."""
    from .multihost import make_pod_mesh

    try:
        make_pod_mesh(device=mesh.device, host=hosts[mesh.rank])
    except ValueError as e:
        return str(e)
    return "host-major"


def dryrun_rank(mesh, log_n: int) -> List[str]:
    """The dry run's checks in one rank; rank 0 compares every proof with
    the single-device proof and verifies it.  Returns the check lines."""
    n = max(64, mesh.size * mesh.size)
    log_small = n.bit_length() - 1
    lines = []

    def timed(label, fn):
        t0 = time.perf_counter()
        detail = fn()
        if isinstance(detail, dict):
            detail = f"{detail['len']} B, sha256 {detail['sha256'][:16]}..., equal to the single-device proof"
        lines.append(f"{label}: {detail} ({time.perf_counter() - t0:.2f}s)")

    timed(f"keccak zk prove 2^{log_small}", lambda: prove_fib(mesh, log_small, single=True, verify_it=True))
    timed(f"poseidon2 zk prove 2^{log_small}",
          lambda: prove_fib(mesh, log_small, hash="poseidon2", single=True, verify_it=True))
    if mesh.size % 2 == 0 and mesh.size >= 4:
        timed(f"2-host pod ({mesh.size // 2} ranks a host) zk prove 2^{log_small}",
              lambda: pod_prove(mesh, log_small, single=True))
    timed("column-sharded kernels", lambda: _column_checks(mesh))
    timed(f"keccak-air {{{', '.join(DRYRUN_PARTITIONS)}}} wide prove, 3 permutations, 2048-column chunks",
          lambda: prove_keccak_air(mesh, perms=3, seed=12, benchmark_fri=False, col_chunk=2048,
                                   partitions=DRYRUN_PARTITIONS, single=True, verify_it=True))
    if log_n:
        timed(f"deep keccak zk prove 2^{log_n}", lambda: prove_fib(mesh, log_n, single=True, verify_it=True))
    return lines


def same_checks(per_rank: List[List[str]]) -> List[str]:
    """Rank 0's check lines, after checking that every rank ran the same
    checks."""
    for r, lines in enumerate(per_rank):
        if [ln.split(":")[0] for ln in lines] != [ln.split(":")[0] for ln in per_rank[0]]:
            raise AssertionError(f"rank {r} ran other checks than rank 0")
    return per_rank[0]


def dryrun_multichip(world: int, log_n: int = 10, device: str = "cuda", backend: str = "gloo") -> List[str]:
    """The dry run in ``world`` ranks (see the module docstring); returns
    rank 0's check lines."""
    return same_checks(run_ranks(world, dryrun_rank, log_n, backend=backend, device=device))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--log-n", type=int, default=10, help="the deep prove's log2 rows (0: skip it)")
    return ap


def main(argv=None) -> int:
    a = parser().parse_args(argv)
    t0 = time.perf_counter()
    for line in dryrun_multichip(a.ranks, a.log_n, a.device, a.backend):
        print(line, flush=True)
    print(f"dry run over {a.ranks} {a.backend} ranks on {a.device}: ok ({time.perf_counter() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
