"""``correct`` comes out false when the timed path is broken underneath: a
run driven past the look for a card (on the CPU, at a small height) with
each fault a cell can have planted in the program.  One card holds the
whole proof, so there is no exchange between chips to leave out.  The
control, the program with one FRI query fewer than the configuration states,
must fail too; a sound run must pass."""

import pytest
import torch

from stark_bench import run
from stark_bench.calibrate import control

ROWS = {"fib_zk.2p24": 64}


class StateUnchanged(run.Program):
    """Each job after the first hands back the previous job's proof."""

    def prove(self, trace, pis, rng_seed, timings=None):
        blob = getattr(self, "_last", None) or super().prove(trace, pis, rng_seed, timings)
        self._last = blob
        return blob


class HalfTheRows(run.Program):
    """Proves the first half of the witness's rows."""

    def prove(self, trace, pis, rng_seed, timings=None):
        half = trace[: trace.shape[0] // 2]
        if pis:
            pis = [pis[0], pis[1], int(half[-1, 1])]
        return super().prove(half, pis, rng_seed, timings)


class ByteAltered(run.Program):
    """One byte of every proof changed where it is produced."""

    def prove(self, trace, pis, rng_seed, timings=None):
        blob = bytearray(super().prove(trace, pis, rng_seed, timings))
        blob[len(blob) // 2] ^= 1
        return bytes(blob)


def _run(cell, factory, seed):
    return run.run_cell(cell, seed, 0.5, False, torch.device("cpu"), rows=ROWS[cell], program_factory=factory)


@pytest.mark.parametrize("cell", sorted(ROWS))
def test_sound_run_is_correct(cell):
    out = _run(cell, run.Program, 2**31 + 11)
    assert out["correct"] and out["checks"]["mismatched_bytes"]["value"] == 0


@pytest.mark.parametrize("fault", [StateUnchanged, HalfTheRows, ByteAltered, control], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(ROWS))
def test_fault_is_not_correct(cell, fault):
    out = _run(cell, fault, 2**31 + 12)
    assert not out["correct"] and out["checks"]["mismatched_bytes"]["value"] > 0
