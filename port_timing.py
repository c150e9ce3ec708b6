#!/usr/bin/env python3
"""Timing tools for the PyTorch + CUDA port (``tpu_stark_torch``) on one GPU.

    python3 port_timing.py profile [--log-n 20] [--tree DIR] [--reps 4]
    python3 port_timing.py warm [--tree DIR | --pcs-from DIR] [--reps 4]
    python3 port_timing.py verify [--log-n 20] [--pcs-from DIR]
    python3 port_timing.py k2 [--tree DIR]

Run from the root of a checkout on a machine with a CUDA device.  Each
subcommand prints the card (nvidia-smi name and power limit) first.

* ``profile``: proves BASELINE config 4 (keccak-air, Poseidon2 stack, zk
  off, blowup 2, 100 queries, 16 PoW bits) at 2^log_n rows once cold (the
  kernels' build included), ``reps`` times warm and unprofiled, then once
  under ``torch.profiler``, and prints every prove's wall clock and phase
  times, the warm proves' median, the profiled prove's summed device time and
  the device's idle share of that wall clock, the number of device kernels
  and copies, K2's share (the NTT pass kernels: device time and launches),
  and the 20 ops with the most device time.  The profiler's own host cost
  lengthens the profiled wall clock, so the idle share is an upper bound.
  ``--tree DIR`` profiles DIR's ``tpu_stark_torch`` (as for ``warm``).
* ``warm``: one cold and ``reps`` warm proves each of fib_air zk at 2^20
  (Keccak stack) and the Poseidon2 chain at 2^18 x 493 (BASELINE config 3),
  with phase times; the chain's trace generation is timed on its own.  Then
  BASELINE config 2 (fib_air zk at the defaults: device zk rng, blowup 2,
  100 queries, 16 PoW bits) at 2^20 on its two NTT routes, ``narrow_ntt=
  "mxu"`` (K5) and ``None`` (K2): one cold prove each, then ``reps`` rounds
  of warm proves in the order mxu, K2, K2, mxu, and each route's median.
  ``--tree DIR`` imports ``tpu_stark_torch`` from DIR instead (a
  ``git archive`` of another commit), so that two commits are compared in
  one chip call: parent, change, change, parent.  ``--pcs-from DIR`` keeps this
  tree but takes ``TwoAdicFriPcs.open`` from DIR's
  ``tpu_stark_torch/commit/pcs.py``, to tell the open phase's share of a
  difference from the rest.
* ``k2``: times K2 (``ntt_kernel.dft``, CUDA events, L2 flushed before
  each launch where the matrix would fit in it) at the main paths' shapes
  (2^21, 128), (2^20, 128) inverse, (2^18, 257) and (2^23, 2), against the
  whole transform's bound (one HBM read and write of the matrix), under
  the default plan and the alternatives the kernel can run: 16- and 32-word
  tile rows at every stage cap that fits a block's shared memory, each
  held equal to the default's result (``ntt_kernel.split``).  With
  ``--tree DIR`` of an older commit, which has no ``split``, only the
  default.
* ``verify``: proves config 4 at 2^log_n rows and times the port's
  ``verify`` of it twice; with ``--pcs-from DIR`` it then times it once
  more with ``TwoAdicFriPcs.verify`` taken from DIR's
  ``tpu_stark_torch/commit/pcs.py`` (the PCS verifier of another commit,
  on the same proof).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOP = 20


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _phases(timings) -> str:
    return ", ".join(f"{k} {v:.3f}s" for k, v in timings.items())


def _timed(torch, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _keccak_setup(dev, log_n: int):
    from tpu_stark_torch.air import keccak_air
    from tpu_stark_torch.fri.config import create_benchmark_fri_params
    from tpu_stark_torch.prover.config import create_config

    n = 1 << log_n
    air = keccak_air.KeccakAir()
    trace = keccak_air.generate_trace(max(1, n // keccak_air.NUM_ROUNDS), seed=1, device=dev)[:n]

    def config():
        return create_config(create_benchmark_fri_params(1), zk=False, hash="poseidon2", device=dev)

    return air, trace, config


def profile(torch, dev, args) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tpu_stark_torch.prover.wide import prove_wide

    air, trace, config = _keccak_setup(dev, args.log_n)
    label = f"keccak-air 2^{args.log_n} x {air.width} prove_wide"
    walls = []
    for i in range(1 + args.reps):
        timings = {}
        _, s = _timed(torch, lambda: prove_wide(config(), air, trace, [], timings=timings))
        print(f"{label}: {'cold' if i == 0 else 'warm'} {s:.3f}s ({_phases(timings)})", flush=True)
        walls.append(s)
    if args.reps:
        print(f"{label}: warm median {sorted(walls[1:])[args.reps // 2]:.3f}s of {args.reps}", flush=True)
    profiled = {}
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(torch, lambda: prove_wide(config(), air, trace, [], timings=profiled))
    on_device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in on_device) / 1e6
    print(f"profiled {wall:.3f}s ({_phases(profiled)}); device time {dev_s:.3f}s, idle "
          f"{100 * (1 - dev_s / wall):.1f}% of the profiled wall clock; "
          f"{sum(e.count for e in on_device)} device kernels and copies")
    k2 = [e for e in on_device if "ntt_pass" in e.key]
    print(f"K2 (NTT pass kernels): {sum(e.self_device_time_total for e in k2) / 1e6:.3f}s of device time "
          f"in {sum(e.count for e in k2)} launches")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:10.1f} ms  {e.count:7d}x  {e.key[:90]}")


def _other_pcs(tree: str):
    """``TwoAdicFriPcs`` of ``tree``'s ``tpu_stark_torch/commit/pcs.py``,
    loaded against this package's modules."""
    path = os.path.join(os.path.abspath(tree), "tpu_stark_torch", "commit", "pcs.py")
    spec = importlib.util.spec_from_file_location("tpu_stark_torch.commit._pcs_other", path)
    other = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    print(f"TwoAdicFriPcs from {path}", flush=True)
    return other.TwoAdicFriPcs


def warm(torch, dev, args) -> None:
    from tpu_stark_torch.air import poseidon2_air
    from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
    from tpu_stark_torch.commit import pcs as pcs_mod
    from tpu_stark_torch.fri.config import create_benchmark_fri_params
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.prove import prove

    if args.pcs_from:
        pcs_mod.TwoAdicFriPcs.open = _other_pcs(args.pcs_from).open

    def run(label, make_config, air, trace, pis):
        _, cold = _timed(torch, lambda: prove(make_config(), air, trace, pis))
        walls = []
        for _ in range(args.reps):
            timings = {}
            _, s = _timed(torch, lambda: prove(make_config(), air, trace, pis, timings=timings))
            walls.append(s)
            print(f"  {label} warm {s:.3f}s ({_phases(timings)})", flush=True)
        print(f"{label}: cold {cold:.3f}s; warm {', '.join(f'{s:.3f}' for s in walls)} s; "
              f"median {sorted(walls)[len(walls) // 2]:.3f}s", flush=True)

    n = 1 << 20
    run("fib 2^20 zk (Keccak)",
        lambda: create_config(zk=True, zk_rng="smallrng", zk_layout="tpu", device=dev),
        FibonacciAir(), generate_trace_rows(0, 1, n), [0, 1, fibonacci_value(0, 1, n)])
    (chain_trace, chain_pis), trace_s = _timed(
        torch, lambda: poseidon2_air.generate_trace(1 << 18, list(range(16)), device=dev))
    print(f"chain 2^18 trace generation {trace_s:.3f}s", flush=True)
    run("chain 2^18 x 493 (Poseidon2)",
        lambda: create_config(zk=False, hash="poseidon2", device=dev),
        poseidon2_air.Poseidon2ChainAir(), chain_trace, chain_pis)
    del chain_trace

    fib_trace, fib_pis = generate_trace_rows(0, 1, n), [0, 1, fibonacci_value(0, 1, n)]

    def config2(narrow, timings=None):
        cfg = create_config(create_benchmark_fri_params(1), zk=True, device=dev, narrow_ntt=narrow)
        return prove(cfg, FibonacciAir(), fib_trace, fib_pis, timings=timings)

    walls = {"mxu": [], None: []}
    for narrow in walls:
        _, cold = _timed(torch, lambda: config2(narrow))
        print(f"config 2 2^20 narrow_ntt={narrow!r}: cold {cold:.3f}s", flush=True)
    for _ in range(args.reps):
        for narrow in ("mxu", None, None, "mxu"):
            timings = {}
            _, s = _timed(torch, lambda: config2(narrow, timings))
            walls[narrow].append(s)
            print(f"  config 2 narrow_ntt={narrow!r} warm {s:.3f}s ({_phases(timings)})", flush=True)
    for narrow, ws in walls.items():
        print(f"config 2 2^20 narrow_ntt={narrow!r}: warm median {sorted(ws)[len(ws) // 2]:.3f}s "
              f"of {len(ws)}", flush=True)


def verify_timing(torch, dev, args) -> None:
    from tpu_stark_torch.commit import pcs as pcs_mod
    from tpu_stark_torch.prover.proof import deserialize_proof, serialize_proof
    from tpu_stark_torch.prover.verify import verify
    from tpu_stark_torch.prover.wide import prove_wide

    air, trace, config = _keccak_setup(dev, args.log_n)
    proof, prove_s = _timed(torch, lambda: prove_wide(config(), air, trace, []))
    del trace
    proof = deserialize_proof(serialize_proof(proof))
    print(f"keccak-air 2^{args.log_n} x {air.width} proved in {prove_s:.3f}s "
          f"({len(proof.opening_proof.query_proofs)} queries)", flush=True)
    for _ in range(2):
        ok, s = _timed(torch, lambda: verify(config(), air, proof, []))
        print(f"verify {s:.3f}s -> {ok}", flush=True)
        if not ok:
            raise AssertionError("the proof does not verify")
    if args.pcs_from:
        mine = pcs_mod.TwoAdicFriPcs.verify
        pcs_mod.TwoAdicFriPcs.verify = _other_pcs(args.pcs_from).verify
        try:
            ok, s = _timed(torch, lambda: verify(config(), air, proof, []))
        finally:
            pcs_mod.TwoAdicFriPcs.verify = mine
        print(f"verify with that PCS verifier: {s:.3f}s -> {ok}", flush=True)
        if not ok:
            raise AssertionError("the proof does not verify with the other PCS verifier")


K2_SHAPES = (((1 << 21, 128), False), ((1 << 20, 128), True), ((1 << 18, 257), False), ((1 << 23, 2), False))


def k2_timing(torch, dev, args) -> None:
    from tpu_stark_torch.fields import babybear as bb
    from tpu_stark_torch.ntt import ntt_kernel as nk

    alternatives = hasattr(nk, "split")
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def timed(fn, cold, reps=10):
        fn()
        total = 0.0
        for _ in range(reps):
            if cold:
                flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / reps

    def dft_with(x, p, tw):
        out = nk.pass0(x, p, tw)
        for s0, k, j_log in p.passes:
            out = nk.run_pass(out, s0, k, j_log, p, tw)
        return out

    for (h, w), inverse in K2_SHAPES:
        x = torch.randint(0, bb.P, (h, w), generator=gen, device=dev, dtype=torch.int64).to(torch.int32)
        log_h = h.bit_length() - 1
        cold = h * w * 4 < 50 << 20
        bound = h * w * 8 / 3.35e12 * 1e3  # one read and one write of the matrix
        label = f"({h}, {w}){' inv' if inverse else ''}"
        ms = timed(lambda: nk.dft(x, inverse), cold)
        print(f"{label} default plan: dft {ms:.4f} ms, {100 * bound / ms:.1f}% of {bound:.4f} ms", flush=True)
        if not alternatives:
            continue
        want = nk.dft(x, inverse)
        tw = nk.stage_twiddles(log_h, inverse, dev)
        for lanes_log in (4, 5):
            seen = set()
            for max_stages in range(12, 5, -1):
                p = nk.split(log_h, w, lanes_log, max_stages)
                ks = (p.k0,) + tuple(k for _, k, _ in p.passes)
                j_logs = (p.g_log,) + tuple(j for _, _, j in p.passes)
                if ks in seen or any(nk.smem_bytes(k, lanes_log, j, 1) > nk.SMEM_LIMIT
                                     for k, j in zip(ks, j_logs)):
                    continue
                seen.add(ks)
                if not torch.equal(dft_with(x, p, tw), want):
                    raise AssertionError(f"{label} plan {p}: not the default plan's result")
                ms = timed(lambda: dft_with(x, p, tw), cold)
                print(f"  {4 << lanes_log}-byte rows, stages {list(ks)}: dft {ms:.4f} ms, "
                      f"{100 * bound / ms:.1f}% of the bound, {100 * len(ks) * bound / ms:.1f}% of "
                      f"{len(ks)} passes' bound", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", choices=("profile", "warm", "verify", "k2"))
    parser.add_argument("--log-n", type=int, default=20, help="keccak-air rows, log2 (profile, verify)")
    parser.add_argument("--reps", type=int, default=4, help="warm proves per configuration (warm, profile)")
    parser.add_argument("--tree", help="import tpu_stark_torch from this directory (warm, profile, k2)")
    parser.add_argument("--pcs-from", help="take TwoAdicFriPcs.open (warm) or also time .verify (verify) "
                        "from this directory's tree")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else ROOT)

    import torch

    if not torch.cuda.is_available():
        print("port_timing: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import tpu_stark_torch

    print(f"card: {_smi_line()}; tpu_stark_torch from {os.path.dirname(tpu_stark_torch.__file__)}", flush=True)
    dev = torch.device("cuda", 0)
    {"profile": profile, "warm": warm, "verify": verify_timing, "k2": k2_timing}[args.what](torch, dev, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
