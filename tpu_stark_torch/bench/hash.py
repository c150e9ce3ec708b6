"""Hash throughput on the card, the twin of the JAX package's root
``bench_hash.py``: the Keccak leaf sponge on K1 and the width-16 Poseidon2
permutation on K3, N rows chained R times, one line each in the JAX
script's format with the card's label.

    python -m tpu_stark_torch.bench.hash [--device cuda]

Each line times one chain of R dependent calls on the host clock, from the
first launch to ``torch.cuda.synchronize()``, after a warm-up chain:
throughput = N * R / wall.  The steps and their seeded inputs are the SoL
report's (``bench/sol.py``): the port has no bare permutation on the card,
so the Poseidon2 line runs K3's TruncatedPermutation compress (one
width-16 permutation a row, 8 of its 16 words stored) with its left half
fed back.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional, Tuple

import torch

from ..backend.policy import card_label
from . import sol

N = 1 << 20  # bench_hash.py's n
R = 32  # bench_hash.py's reps


def _timed_chain(step: Callable, arg: torch.Tensor, n: int, reps: int) -> Tuple[float, float]:
    """(seconds, Mperm/s) of ``reps`` dependent steps from ``arg``, after a
    warm-up chain."""
    for _ in range(2):  # the first chain warms up
        torch.cuda.synchronize(arg.device)
        t0 = time.perf_counter()
        v = arg
        for _ in range(reps):
            v = step(v)
        torch.cuda.synchronize(arg.device)
        dt = time.perf_counter() - t0
    return dt, n * reps / dt / 1e6


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(prog="python -m tpu_stark_torch.bench.hash")
    p.add_argument("--device", default="cuda", help="a CUDA device (default: cuda)")
    dev = torch.device(p.parse_args(argv).device)
    if dev.type != "cuda":
        raise ValueError(f"the hash benchmark needs a CUDA device, not {dev}")
    label = card_label(dev)

    dt, mperm = _timed_chain(sol.keccak_leaf_step, sol.keccak_leaf_input(N, dev), N, R)
    print(f"keccak leaf sponge  (N={N}, 6 u32, R={R}): {dt*1e3:8.2f} ms  {mperm:8.1f} Mperm/s  (K1, {label})",
          flush=True)

    left, right = sol.poseidon2_compress_input(N, dev)
    dt, mperm = _timed_chain(sol.poseidon2_compress_step(right), left, N, R)
    print(f"poseidon2-16        (N={N}, R={R}):        {dt*1e3:8.2f} ms  {mperm:8.1f} Mperm/s  "
          f"(K3 compress, {label})", flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
