"""The window's arithmetic on a stub program: prove_s is the window's wall
clock from the first job's start to the last job's end over the jobs that
completed."""

import time

import torch

from stark_bench import run
from stark_bench.run import Record, load_metric


def test_prove_s_from_job_times():
    rec = Record(setup_s=1.0, jobs=[(10.0, 12.0), (12.0, 14.5), (14.5, 16.0)])
    assert load_metric("prove_s").read(rec) == 2.0
    rec.failed = 1  # a failed job's time counts, the job does not
    assert load_metric("prove_s").read(rec) == 3.0
    assert load_metric("setup_s").read(rec) == 1.0
    assert load_metric("peak_gib").read(Record(setup_s=0, window_peak_bytes=3 * 2**30)) == 3.0


class _Stub:
    """Proves nothing: 30 ms a job."""

    def __init__(self, *_):
        self.device = torch.device("cpu")

    def prove(self, trace, pis, rng_seed, timings=None):
        time.sleep(0.03)
        if timings is not None:
            timings["open"] = 0.03
        return b"x"

    @staticmethod
    def launches():
        return 0


def test_window_runs_jobs_until_seconds_pass():
    cell = run.Cell.load("fib_zk.2p24")
    rec, failures = Record(setup_s=0.0), []
    done = run._window(cell, _Stub(), [(None, []), (None, [])], 7, 0.3, False, rec, failures)
    assert not failures and len(done) == len(rec.jobs) >= 5
    assert [j.index for j in done] == list(range(len(done)))
    assert rec.jobs[-1][0] - rec.jobs[0][0] < 0.3 <= rec.jobs[-1][1] - rec.jobs[0][0] + 0.03
    assert abs(load_metric("prove_s").read(rec) - 0.03) < 0.01
    assert len({j.rng_seed for j in done}) == len(done)
