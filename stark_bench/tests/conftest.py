"""The benchmark's own CPU tests: ``python -m pytest stark_bench/tests -p no:xdist``
from the repository root (a few minutes; the proofs run the port's plain
versions and the reference at small heights)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _threads():
    torch.set_num_threads(4)
