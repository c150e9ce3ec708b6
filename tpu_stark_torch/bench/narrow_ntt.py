"""The narrow NTT routes on the card, the twin of the JAX package's root
``bench_narrow_ntt.py``: at the tall narrow shapes a 2^20 zk prove
dispatches, single-call latency with a sync (best of 5 after a warm-up),
Melems/s, and the speedup of one route over the other.

    python -m tpu_stark_torch.bench.narrow_ntt [--device cuda]

The JAX script times its ``plain`` radix-2 loop against its ``vpu4``
four-step, a TPU workaround the port does not have.  The port's two routes
are ``radix2.dft_batch(x, narrow=None)`` (K2's fused passes) and
``narrow="mxu"`` (the limb-matmul NTT on K5); every shape here passes the
``mxu`` route's gate (w <= 32, h >= 2^16).  The input is drawn on the card
from a ``torch.Generator`` seeded 0 and reduced mod p, and the two routes
must agree bit for bit at every shape.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from ..backend.policy import card_label
from ..fields import babybear as bb
from ..ntt import radix2

SHAPES = [  # (log_h, w): the prove's commit-path transforms at 2^20
    (21, 2),  # trace idft
    (23, 2),  # trace LDE dft
    (20, 8),  # quotient idft (grouped chunks)
    (22, 8),  # quotient LDE dft
    (21, 4),  # random-codeword dft/idft
    (23, 4),  # random-codeword LDE dft
    (22, 32),  # upper edge of the dispatch window
]
ROUTES = (("k2", None), ("mxu", "mxu"))  # (label, radix2's narrow argument)


def run(fn, x: torch.Tensor, label: str, reps: int = 5) -> float:
    """Best single-call latency (s) of ``fn(x)`` with a sync; prints it."""
    fn(x)
    torch.cuda.synchronize(x.device)  # build + settle
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize(x.device)
        best = min(best, time.perf_counter() - t0)
    n = x.shape[0] * x.shape[1]
    print(f"  {label:6s} single-call {best * 1e3:9.2f} ms  ({n / best / 1e6:8.1f} Melems/s)", flush=True)
    return best


def device_input(log_h: int, w: int, gen: torch.Generator) -> torch.Tensor:
    """(2^log_h, w) uniform u32 draws reduced mod p, made on the card."""
    bits = torch.randint(0, 1 << 32, (1 << log_h, w), generator=gen, device=gen.device, dtype=torch.int64)
    return (bits % bb.P).to(torch.int32)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(prog="python -m tpu_stark_torch.bench.narrow_ntt")
    p.add_argument("--device", default="cuda", help="a CUDA device (default: cuda)")
    dev = torch.device(p.parse_args(argv).device)
    if dev.type != "cuda":
        raise ValueError(f"the narrow NTT benchmark needs a CUDA device, not {dev}")
    print(f"backend: {card_label(dev)}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for log_h, w in SHAPES:
        x = device_input(log_h, w, gen)
        if not radix2._mxu(x, "mxu"):
            raise AssertionError(f"(2^{log_h}, {w}) is outside the mxu route's gate")
        print(f"(2^{log_h}, {w}):", flush=True)
        times = {label: run(lambda m, _r=narrow: radix2.dft_batch(m, _r), x, label) for label, narrow in ROUTES}
        if not torch.equal(radix2.dft_batch(x, None), radix2.dft_batch(x, "mxu")):
            raise AssertionError(f"(2^{log_h}, {w}): the k2 and mxu routes disagree")
        print(f"  speedup {times['k2'] / times['mxu']:5.2f}x (mxu over k2; bit-identical)", flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
