"""Prove benchmarks, the twins of the JAX package's root scripts
``bench_prove.py`` (``fib``), ``bench_poseidon2_chain.py`` (``chain``) and
``bench_keccak_air.py`` (``keccak-air``), with their positional arguments:

    python -m tpu_stark_torch.bench.prove fib [log_n] [keccak|poseidon2] [zk|plain] [reps] [test|bench]
    python -m tpu_stark_torch.bench.prove chain [log_n]
    python -m tpu_stark_torch.bench.prove keccak-air [log_n] [test|bench] [reps] [poseidon2|keccak] [plain|zk]

and the options ``--narrow none|mxu`` (the NTT route of
``create_config(narrow_ntt=...)``), ``--lowmem-log N``
(``create_config(lowmem_log=N)``: the low-memory levers from 2^N committed
rows; 0 switches them off; by default the card's own threshold,
``commit/lowmem.py::default_log``) and ``--device`` (default ``cuda``).
``test`` = 2 queries, 1 PoW bit, blowup 4; ``bench`` = 100 queries, 16 PoW
bits, blowup 2.  ``keccak-air``'s stack and mode default to
``bench_keccak_air.py``'s (Poseidon2, zk off); ``keccak zk`` is the
reference's stack (``create_config()``'s defaults: Keccak trees, zk, the
device rng).

Each prints the phase times of the cold prove and of every warm one, then as its last line one
JSON object with the JAX scripts' field names and ``metric`` strings
(``value`` is the fastest warm sample in seconds; ``reps`` 0 reports the
cold run), with ``trace_cols``, ``peak_hbm_gb`` (the allocator's peak over
the warm proves, or the cold one at ``reps`` 0), ``device`` (the card's
name and power limit from ``nvidia-smi``), ``narrow`` and ``lowmem_log``
(the threshold the run used).  Every sample
ends in ``torch.cuda.synchronize()``; the proof must verify.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Callable, Dict, Optional

import torch

from ..air import keccak_air, poseidon2_air
from ..air.fibonacci import FibonacciAir, generate_trace_rows
from ..backend.policy import card_label
from ..commit import lowmem
from ..fri.config import create_benchmark_fri_params, create_test_fri_params
from ..prover.config import create_config
from ..prover.proof import serialize_proof
from ..prover.prove import prove
from ..prover.verify import verify
from ..prover.wide import prove_wide
from .profiling import hbm_note

NARROW = {"none": None, "mxu": "mxu"}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fri(params: str):
    return create_test_fri_params(2) if params == "test" else create_benchmark_fri_params(1)


def _phases(timings: Dict[str, float]) -> str:
    return ", ".join(f"{k} {v:.6f}s" for k, v in timings.items())


def _measure(dev: torch.device, prove_once: Callable, check: Callable, reps: int) -> Dict:
    """A cold prove, ``reps`` warm ones, then verify: the JSON fields they
    give.  ``prove_once(timings)`` returns a proof; ``check(proof)`` its
    verdict."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    proof = prove_once(timings)
    _sync(dev)
    t_first = time.perf_counter() - t0
    print(f"cold: {t_first:.6f}s ({_phases(timings)}){hbm_note(dev)}", flush=True)
    if reps > 0 and dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    samples = []
    for rep in range(reps):
        gc.collect()  # drop the previous proof's device tensors before proving again
        timings = {}
        t0 = time.perf_counter()
        proof = prove_once(timings)
        _sync(dev)
        samples.append(time.perf_counter() - t0)
        print(f"warm {rep}: {samples[-1]:.6f}s ({_phases(timings)}){hbm_note(dev)}", flush=True)
    if not samples:
        samples = [t_first]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    t0 = time.perf_counter()
    ok = check(proof)
    t_verify = time.perf_counter() - t0
    if not ok:
        raise AssertionError("verification failed")
    return {
        "value": min(samples),
        "unit": "s",
        "samples": samples,
        "first_run_s": t_first,
        "verify_s": t_verify,
        "proof_bytes": len(serialize_proof(proof)),
        "peak_hbm_gb": peak,
    }


def _fib(a, dev, narrow) -> Dict:
    zk = a.mode == "zk"
    fri = _fri(a.params)

    def config():
        return create_config(fri, zk=zk, hash=a.hash, device=dev, narrow_ntt=narrow, lowmem_log=a.lowmem_log)

    t0 = time.perf_counter()
    trace = generate_trace_rows(0, 1, 1 << a.log_n)
    pis = [0, 1, int(trace[-1, 1])]
    t_tracegen = time.perf_counter() - t0
    air = FibonacciAir()
    out = _measure(dev, lambda t: prove(config(), air, trace, pis, timings=t),
                   lambda p: verify(config(), air, p, pis), a.reps)
    metric = f"fib_air_{'zk' if zk else 'plain'}_prove_2^{a.log_n}_{a.hash}_{a.params}"
    return {"metric": metric, **out, "tracegen_s": t_tracegen, "trace_cols": int(trace.shape[1])}


def _chain(a, dev, narrow) -> Dict:
    def config():
        return create_config(zk=False, hash="poseidon2", device=dev, narrow_ntt=narrow, lowmem_log=a.lowmem_log)

    t0 = time.perf_counter()
    trace, pis = poseidon2_air.generate_trace(1 << a.log_n, list(range(16)), device=dev)
    t_tracegen = time.perf_counter() - t0
    air = poseidon2_air.Poseidon2ChainAir()
    out = _measure(dev, lambda t: prove(config(), air, trace, pis, timings=t),
                   lambda p: verify(config(), air, p, pis), 1)
    return {"metric": f"poseidon2_chain_prove_2^{a.log_n}", **out, "tracegen_s": t_tracegen,
            "trace_cols": int(trace.shape[1])}


def _keccak_air(a, dev, narrow) -> Dict:
    fri = _fri(a.params)
    zk = a.mode == "zk"

    def config():
        return create_config(fri, zk=zk, hash=a.hash, device=dev, narrow_ntt=narrow, lowmem_log=a.lowmem_log)

    n = 1 << a.log_n
    t0 = time.perf_counter()
    trace = keccak_air.generate_trace(num_perms=n // keccak_air.NUM_ROUNDS, seed=1, dtype=torch.uint8, device=dev)[:n]
    _sync(dev)
    t_tracegen = time.perf_counter() - t0
    air = keccak_air.KeccakAir()
    out = _measure(dev, lambda t: prove_wide(config(), air, trace, [], timings=t),
                   lambda p: verify(config(), air, p, []), a.reps)
    stack = "" if (a.hash, a.mode) == ("poseidon2", "plain") else f"_{a.hash}_{a.mode}"
    return {"metric": f"keccak_air_prove_2^{a.log_n}_{a.params}{stack}", **out, "tracegen_s": t_tracegen,
            "trace_cols": int(trace.shape[1])}


def parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--narrow", choices=sorted(NARROW), default="none",
                        help="NTT route for tall narrow matrices (create_config(narrow_ntt=...))")
    common.add_argument("--lowmem-log", type=int,
                        help="log2 of the committed height from which the low-memory levers engage; 0: off "
                        "(default: the card's, create_config's)")
    common.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p = argparse.ArgumentParser(prog="python -m tpu_stark_torch.bench.prove")
    sub = p.add_subparsers(dest="workload", required=True)
    fib = sub.add_parser("fib", parents=[common], help="fib_air (bench_prove.py)")
    fib.add_argument("log_n", nargs="?", type=int, default=16)
    fib.add_argument("hash", nargs="?", default="keccak", choices=("keccak", "poseidon2"))
    fib.add_argument("mode", nargs="?", default="zk", choices=("zk", "plain"))
    fib.add_argument("reps", nargs="?", type=int, default=3)
    fib.add_argument("params", nargs="?", default="test", choices=("test", "bench"))
    chain = sub.add_parser("chain", parents=[common], help="Poseidon2 chain (bench_poseidon2_chain.py)")
    chain.add_argument("log_n", nargs="?", type=int, default=18)
    keccak = sub.add_parser("keccak-air", parents=[common], help="keccak-air (bench_keccak_air.py)")
    keccak.add_argument("log_n", nargs="?", type=int, default=20)
    keccak.add_argument("params", nargs="?", default="bench", choices=("test", "bench"))
    keccak.add_argument("reps", nargs="?", type=int, default=1)
    keccak.add_argument("hash", nargs="?", default="poseidon2", choices=("poseidon2", "keccak"))
    keccak.add_argument("mode", nargs="?", default="plain", choices=("plain", "zk"))
    return p


def main(argv: Optional[list] = None) -> Dict:
    """Run one twin and print its lines; returns the JSON object."""
    a = parser().parse_args(argv)
    dev = torch.device(a.device)
    if a.lowmem_log is None:
        a.lowmem_log = lowmem.default_log(dev)
    narrow = NARROW[a.narrow]
    run = {"fib": _fib, "chain": _chain, "keccak-air": _keccak_air}[a.workload]
    out = run(a, dev, narrow)
    keys = ("metric", "value", "unit", "samples", "tracegen_s", "first_run_s", "verify_s",
            "proof_bytes", "trace_cols", "peak_hbm_gb")
    result = {k: out[k] for k in keys}
    result.update(device=card_label(dev), narrow=a.narrow, lowmem_log=a.lowmem_log)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
