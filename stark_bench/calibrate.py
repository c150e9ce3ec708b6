"""The readings that set ``correct``'s limits, in one process on the card:

    python -m stark_bench.calibrate --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6

For each seed, the window's first job (witness 0, the job's zk seed) is
proved at the cell's size by the program and, with ``--control-seeds``, by
the control (the program with one FRI query fewer than the configuration
states); each proof is compared with the plain reference's.
One JSON line a reading.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import reference, run, traffic


def control(config: dict, device) -> run.Program:
    """The control: the program breaking one guarantee the configuration
    states, one FRI query fewer (a proof-of-work bit fewer would give the
    same proof whenever the grind's first witness meets the stronger bound
    too, half the time)."""
    fri = dict(config["fri"], num_queries=config["fri"]["num_queries"] - 1)
    return run.Program(config, device, fri=fri)


def reading(cell: run.Cell, seed: int, program, device, kind: str) -> dict:
    trace, pis = run.make_witnesses(cell, seed, device, int(cell.config["statement"]["rows"]), only={0})[0]
    rng = traffic.rng_seed(seed, "job", 0)
    t0 = time.perf_counter()
    got = program.prove(trace, pis, rng)
    t1 = time.perf_counter()
    ref = reference.proof_bytes(cell.config, trace, pis, rng, device)
    run.sync(device)
    t2 = time.perf_counter()
    return {"cell": cell.name, "kind": kind, "seed": seed, "mismatched_bytes": run.mismatch(ref, got),
            "proof_bytes": len(got), "prove_s": t1 - t0, "reference_s": t2 - t1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m stark_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("stark_bench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = run.Cell.load(a.workload)
    programs = {"program": run.Program(cell.config, dev), "control": control(cell.config, dev)}
    for kind, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for s in (int(x) for x in seeds.split(",") if x):
            print(json.dumps(reading(cell, s, programs[kind], dev, kind)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
