"""The benchmark of ``tpu_stark_torch``: zk proofs run back to back on one card.

    python -m stark_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``: the statement, its stack and FRI parameters, the
program's and the reference's entries) and a traffic mix
(``traffic/<traffic>.json``); ``workloads/<cell>.json`` holds the cell's own
run parameters.  Set-up makes the witnesses from the seed (``inputs/``),
builds or loads the kernels and proves ``warmup_jobs`` times; the window then
runs proof jobs in a closed loop for ``--seconds``.  A job is one proof call
and its serialization to bytes, ended by a device synchronize.

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (``metrics/<name>.py``): every job of that
window passes the prover a ``timings`` dict (a synchronize at each phase end),
and its first ``profile_jobs`` jobs run under ``torch.profiler`` with the
kernel wrappers priced call by call (``roofline/``).

Once the window has closed and the program's state is freed, ``check_jobs``
jobs drawn from the seed are proved again by the plain reference
(``reference/``) from witnesses made anew, and ``correct`` says whether every
serialized proof equals the reference's byte for byte.  The last line of
standard output is the result as one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Callable, Dict, List, Optional, Tuple  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import reference, traffic as traffic_gen  # noqa: E402
from .devtrace import PhaseMarks, Reading  # noqa: E402
from .roofline.calls import Pricer  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "tpu_stark")  # top-level module names, compared whole


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def load_metric(name: str):
    """``metrics/<name>.py``: its ``UNIT``, ``LAYER``, ``MOVES`` and ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"stark_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict  # BENCHMARK.json's workloads entry
    params: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json

    @classmethod
    def load(cls, name: str, bench: Optional[dict] = None) -> "Cell":
        bench = bench or benchmark()
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        return cls(name, entry, load_json(HERE, "workloads", f"{name}.json"),
                   load_json(HERE, "configs", f"{entry['config']}.json"),
                   traffic_gen.check(load_json(HERE, "traffic", f"{entry['traffic']}.json")))

    def metric_names(self, trace: bool, bench: Optional[dict] = None) -> List[str]:
        """The metrics this cell reports: its end-to-end ones, or with
        ``trace`` the per-layer ones that list it or, listing no cell, move
        an end-to-end metric it reports."""
        bench = bench or benchmark()
        e2e = [m["name"] for m in bench["end_to_end"] if self.name in m.get("workloads", [self.name])]
        if not trace:
            return e2e
        return [m["name"] for m in bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def _attr(path: str):
    mod, name = path.split(":")
    return getattr(importlib.import_module(mod), name)


class Program:
    """The system under test: ``config``'s prover of ``tpu_stark_torch`` on
    ``device``.  ``fri`` replaces the configuration's FRI parameters (the
    control's fewer queries)."""

    def __init__(self, config: dict, device: torch.device, fri: Optional[dict] = None):
        from tpu_stark_torch.fri.config import FriParameters
        from tpu_stark_torch.prover.config import create_config
        from tpu_stark_torch.prover.proof import serialize_proof

        self.device = device
        self._stack = config["stack"]
        self._fri = FriParameters(**(fri or config["fri"]))
        self._create_config, self._serialize = create_config, serialize_proof
        self._prove = _attr(config["program"]["prove"])
        self._air = _attr(config["program"]["air"])()

    def prove(self, trace, public_values, rng_seed: int, timings=None) -> bytes:
        s = self._stack
        cfg = self._create_config(self._fri, zk=s["zk"], hash=s["hash"], zk_rng=s["zk_rng"], rng_seed=rng_seed,
                                  device=self.device)
        blob = self._serialize(self._prove(cfg, self._air, trace, public_values, timings=timings))
        sync(self.device)
        return blob

    @staticmethod
    def launches() -> int:
        from tpu_stark_torch import kernels

        return sum(k.launches for k in kernels.ALL)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _reset_peak(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def make_witnesses(cell: Cell, seed: int, device: torch.device, rows: int, only=None) -> dict:
    """The mix's witnesses by index (``only`` those indices)."""
    maker = importlib.import_module(f"{__package__}.inputs.{cell.config['statement']['air']}")
    out = {i: maker.make(rows, traffic_gen.witness_seed(seed, i), device)
           for i in range(int(cell.traffic["witnesses"])) if only is None or i in only}
    sync(device)
    return out


@dataclass
class Record:
    """What a run measured, as the metric readers see it (seconds)."""
    setup_s: float
    jobs: List[Tuple[float, float]] = field(default_factory=list)  # (start, end) of every job of the window
    failed: int = 0  # jobs of the window that raised
    window_peak_bytes: int = 0
    phases: List[Dict[str, float]] = field(default_factory=list)  # each traced job's phase times
    launches: int = 0  # kernel launches over the traced jobs
    reading: Optional[Reading] = None  # the profile of the first profile_jobs jobs
    priced_ms: Dict[str, float] = field(default_factory=dict)  # their wrapper calls' bounds by phase


@dataclass
class Job:
    index: int
    rng_seed: int
    proof: bytes


class _Profile:
    """``torch.profiler`` and the wrapper pricer over the window's first
    ``profile_jobs`` jobs."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.marks: List[Tuple[int, PhaseMarks]] = []
        self.pricer = Pricer(lambda: (self.marks[-1][0], len(self.marks[-1][1].order)))
        self.prof.__enter__()
        self.pricer.__enter__()

    def close(self) -> None:
        self.pricer.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def read(self, rec: Record) -> None:
        order = dict(self.marks)
        for (j, i), ms in self.pricer.ms.items():
            names = order[j].order
            phase = names[i] if i < len(names) else "after"
            rec.priced_ms[phase] = rec.priced_ms.get(phase, 0.0) + ms
        rec.reading = Reading(self.prof)


def _window(cell: Cell, program, witnesses, seed: int, seconds: float, trace: bool, rec: Record,
            failures: List[str]) -> List[Job]:
    """The closed loop: jobs until ``seconds`` have passed since the first
    started; returns the completed ones."""
    nw = len(witnesses)
    done: List[Job] = []
    profile_jobs = int(cell.params["profile_jobs"]) if trace else 0
    launches0 = program.launches() if trace else 0
    profile = _Profile(program.device) if profile_jobs else None  # started before the window: its set-up is slow
    t0 = time.perf_counter()
    j = 0
    while j == 0 or time.perf_counter() - t0 < seconds:
        trace_in, pis = witnesses[j % nw]
        rng = traffic_gen.rng_seed(seed, "job", j)
        timings = PhaseMarks() if trace else None
        if profile is not None and j < profile_jobs:
            profile.marks.append((j, timings))
        start = time.perf_counter()
        try:
            blob = program.prove(trace_in, pis, rng, timings)
        except Exception:  # a failed proof is counted and the loop goes on
            failures.append(traceback.format_exc())
            blob = None
        rec.jobs.append((start, time.perf_counter()))
        if profile is not None and j == profile_jobs - 1:
            profile.close()
        if blob is not None:
            done.append(Job(j, rng, blob))
            if timings is not None:
                rec.phases.append(dict(timings))
        j += 1
    if profile is not None:
        if j < profile_jobs:
            profile.close()
        profile.read(rec)
    if trace:
        rec.launches = program.launches() - launches0
    return done


def _card_label(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, rows: Optional[int] = None,
             program_factory: Callable = Program) -> dict:
    """One run of a cell on ``device``; returns the result object.  ``rows``
    replaces the statement's height (the tests' small sizes);
    ``program_factory(config, device)`` builds the system under test."""
    device = torch.device(device)
    bench = benchmark()
    cell = Cell.load(name, bench)
    rows = rows or int(cell.config["statement"]["rows"])
    readers = {m: load_metric(m) for m in cell.metric_names(trace, bench)}

    witnesses = make_witnesses(cell, seed, device, rows)
    program = program_factory(cell.config, device)
    for i in range(int(cell.params["warmup_jobs"])):
        trace_in, pis = witnesses[i % len(witnesses)]
        program.prove(trace_in, pis, traffic_gen.rng_seed(seed, "warmup", i))
    setup_peak = _peak(device)
    _reset_peak(device)
    rec = Record(setup_s=time.perf_counter() - T_START)

    failures: List[str] = []
    done = _window(cell, program, witnesses, seed, seconds, trace, rec, failures)
    rec.window_peak_bytes = _peak(device)
    rec.failed = len(failures)
    del program, witnesses
    _reset_peak(device)

    # the reference, from witnesses made anew, on a sample of the window's jobs
    picks = sorted(random.Random(traffic_gen.mix(seed, "check")).sample(
        range(len(done)), min(int(cell.params["check_jobs"]), len(done))))
    mismatched = 0
    if picks:
        nw = int(cell.traffic["witnesses"])
        fresh = make_witnesses(cell, seed, device, rows, only={done[k].index % nw for k in picks})
        t_ref = time.perf_counter()
        for k in picks:
            job = done[k]
            trace_in, pis = fresh[job.index % nw]
            ref = reference.proof_bytes(cell.config, trace_in, pis, job.rng_seed, device)
            mismatched = max(mismatched, mismatch(ref, job.proof))
        del fresh
        print(f"stark_bench: the reference proved {len(picks)} job(s) in {time.perf_counter() - t_ref:.3f} s",
              file=sys.stderr)
    checks = {
        "mismatched_bytes": {"value": mismatched, "limit": 0, "holds": "value <= limit"},
        "failed_jobs": {"value": len(failures), "limit": 0, "holds": "value <= limit"},
        "jobs_checked": {"value": len(picks), "limit": 1, "holds": "value >= limit"},
    }
    correct = bool(picks) and mismatched == 0 and not failures

    metrics = {}
    for m, reader in readers.items():
        v = reader.read(rec)
        if v is not None:
            metrics[m] = {"value": v, "unit": reader.UNIT}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": int(cell.entry["chips"]), "memory_peak_bytes": max(setup_peak, rec.window_peak_bytes),
                "card": _card_label(device)}
    out = {"correct": correct, "attempted": len(done) + len(failures), "failed": len(failures), "metrics": metrics,
           "device": dev_info}
    if rec.reading is not None:
        dev_info.update(busy_s=rec.reading.busy_s, window_s=rec.reading.window_s)
        out["breakdown"] = {"device_ops": rec.reading.device_ops, "idle_gaps": rec.reading.idle_gaps}
    out["checks"] = checks
    print("stark_bench: the window's jobs (s): " + " ".join(repr(e - s) for s, e in rec.jobs), file=sys.stderr)
    for f in failures[:3]:
        print(f, file=sys.stderr)
    return out


def mismatch(ref: bytes, got: bytes) -> int:
    """Bytes that differ, a length difference counted whole."""
    n = min(len(ref), len(got))
    a, b = np.frombuffer(ref[:n], dtype=np.uint8), np.frombuffer(got[:n], dtype=np.uint8)
    return int((a != b).sum()) + abs(len(ref) - len(got))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m stark_bench.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the window's length")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    a = parser().parse_args(argv)
    chips = int(Cell.load(a.workload).entry["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"stark_bench: {a.workload} needs {chips} CUDA device(s), this machine has {have}", file=sys.stderr)
        return 2
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda")
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))
    if found:
        print(f"stark_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']}, {v['holds']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
