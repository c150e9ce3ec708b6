"""CLI, the reference app's startup sequence as a terminal program: select
the backend, probe, prove, benchmark, and print the result strings.

Usage: ``python -m tpu_stark_torch.app [--backend cuda|cpu] [--n N]
[--hash keccak|poseidon2] [--profile DIR] [--log-n L] [fib] [bench]
[keccak-air] [poseidon2-chain]`` (no workload = ``fib bench``).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpu_stark_torch")
    parser.add_argument("--backend", default="cuda", help="cuda|cpu")
    parser.add_argument("--n", type=int, default=8, help="fib trace length")
    parser.add_argument("--hash", default="keccak", help="commitment stack: keccak|poseidon2")
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a torch.profiler trace into DIR (bench/profiling.py)",
    )
    parser.add_argument(
        "--log-n", type=int, default=10, help="log2 rows for the keccak/poseidon2 AIR workloads",
    )
    parser.add_argument(
        "workloads", nargs="*", default=[],
        help="any of: fib bench keccak-air poseidon2-chain (default: fib bench)",
    )
    args = parser.parse_args(argv)

    from ..bench.profiling import maybe_trace
    from . import api

    try:
        api.set_backend(args.backend)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out = [f"cuda available: {api.is_cuda_available()}"]
    workloads = args.workloads or ["fib", "bench"]
    with maybe_trace(args.profile):
        if "fib" in workloads:
            out.append(api.run_fib_air_zk(args.n, hash=args.hash))
        if "bench" in workloads:
            out.append(api.run_dft_benchmark())
        if "keccak-air" in workloads:
            out.append(api.run_keccak_air(args.log_n))
        if "poseidon2-chain" in workloads:
            out.append(api.run_poseidon2_chain(args.log_n))
    print("\n\n".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
