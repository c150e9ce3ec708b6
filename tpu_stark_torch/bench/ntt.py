"""NTT throughput benchmark, the twin of the JAX package's root
``bench.py``: one JSON line with the BabyBear batched-NTT kernel rate at the
reference's largest benchmark shape, 16384x128, timed as the harness's
``cuda_kernel`` tier (a device-resident chain of dependent transforms, CUDA
events), and beside it ``sol_pct_of_roof``: the speed-of-light report
(``bench/sol.py``) compacted as ``bench.py`` compacts it, its lines on
stderr.  Unlike ``bench.py``, which prints its line without the report
when the report fails, a failed report here fails the process: no line.

    python -m tpu_stark_torch.bench.ntt [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..backend.policy import card_label
from ..fields import babybear as bb
from ..ntt.dft import Dft
from . import harness, sol

# The reference's best kernel-only throughput at 16384x128: 135 Melems/s on
# the Galaxy A55's Vulkan backend (docs/optimization_attempts.md:167).
BASELINE_MELEMS = 135.0
SHAPE = (16384, 128)


def sol_compact(report: Dict) -> Dict:
    """The ``sol_pct_of_roof`` block of a ``sol.run`` report: the floor, the
    roofs, their sources, and each kernel's score, or ``roof-source:`` the
    roofs it defines, or ``n/a:l2-resident`` when its only resource was a
    dropped HBM model."""
    return {
        "dispatch_floor_ms": round(report["dispatch_floor_ms"], 2),
        "roofs": {k: round(v, 1) for k, v in report["roofs"].items()},
        "roof_sources": report["roof_sources"],
        "kernels": {
            k["kernel"]: (
                "roof-source:" + "/".join(k["roof_source_for"])
                if k.get("roof_source_for")
                else ("n/a:l2-resident" if k["sol_pct"] is None else round(k["sol_pct"], 1))
            )
            for k in report["kernels"]
        },
    }


def main(argv: Optional[list] = None) -> Dict:
    p = argparse.ArgumentParser(prog="python -m tpu_stark_torch.bench.ntt")
    p.add_argument("--device", default="cuda", help="a CUDA device (default: cuda)")
    dev = torch.device(p.parse_args(argv).device)
    if dev.type != "cuda":
        raise ValueError(f"the kernel tier needs a CUDA device, not {dev}")
    h, w = SHAPE
    x = torch.from_numpy(bb.np_to_monty(harness.benchmark_input(h, w)).view(np.int32)).to(dev)
    stats = harness.kernel_stats(Dft(dev), x)
    melems = h * w / (stats.avg_ms * 1e-3) / 1e6
    out = {
        "metric": f"babybear_ntt_kernel_{h}x{w}",
        "value": melems,
        "unit": "Melems/s",
        "vs_baseline": melems / BASELINE_MELEMS,
        "device": card_label(dev),
    }
    with contextlib.redirect_stdout(sys.stderr):
        report = sol.run(device=dev)
    out["sol_pct_of_roof"] = sol_compact(report)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
