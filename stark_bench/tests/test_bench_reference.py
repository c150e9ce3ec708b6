"""The plain reference against proofs that the JAX package made (stored with
the repository's tests: fib_air zk on the Keccak stack with the device rng,
``create_benchmark_fri_params(1)``, witness (0, 1), zk seed 1), byte for byte
at 2^3 rows and by SHA-256 at 2^10 and 2^12; and against the port's CPU path
on a witness of the benchmark's own, also in small row blocks."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from stark_bench import reference, run, traffic
from stark_bench.inputs import fib
from stark_bench.reference import keccak, threefry

GOLDEN = os.path.join(run.ROOT, "tests", "golden", "torch_fib_zk_device_jax_proofs.json")


@pytest.mark.parametrize("log_n", [3, 10, 12])
def test_reference_equals_the_jax_packages_proofs(log_n):
    with open(GOLDEN) as f:
        want = json.load(f)[str(log_n)]
    cell = run.Cell.load("fib_zk.2p24")
    trace = fib.trace_rows(0, 1, 1 << log_n)
    got = reference.proof_bytes(cell.config, trace, [0, 1, int(trace[-1, 1])], 1, torch.device("cpu"))
    assert len(got) == want["len"] and hashlib.sha256(got).hexdigest() == want["sha256"]
    if "proof_hex" in want:
        assert got.hex() == want["proof_hex"]


@pytest.mark.parametrize("blocks", [False, True])
def test_reference_equals_the_ports_cpu_path(blocks, monkeypatch):
    """With ``blocks`` the reference's row blocks are cut small, so that its
    blocked hashing and drawing run as at 2^24 rows."""
    if blocks:
        monkeypatch.setattr(keccak, "ROW_BLOCK", 16)
        monkeypatch.setattr(threefry, "DRAW_ELEMS", 40)
    cell = run.Cell.load("fib_zk.2p24")
    dev = torch.device("cpu")
    trace, pis = run.make_witnesses(cell, 2**31 + 99, dev, 64, only={0})[0]
    rng = traffic.rng_seed(2**31 + 99, "job", 0)
    got = run.Program(cell.config, dev).prove(trace, pis, rng)
    assert reference.proof_bytes(cell.config, trace, pis, rng, dev) == got


def test_the_fib_witness_is_the_recurrence():
    trace = fib.trace_rows(5, 7, 256)
    rows = np.zeros_like(trace)
    a, b = 5, 7
    for i in range(256):
        rows[i] = (a, b)
        a, b = b, (a + b) % fib.P
    assert np.array_equal(trace, rows)
