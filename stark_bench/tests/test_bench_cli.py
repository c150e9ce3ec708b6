"""The run command refuses to run without a card: a non-zero exit and no
result line."""

import subprocess
import sys

import torch

from stark_bench import run


def test_refuses_without_a_card():
    assert not torch.cuda.is_available()
    out = subprocess.run([sys.executable, "-m", "stark_bench.run", "--workload", "fib_zk.2p24", "--seed",
                          str(2**31 + 3), "--seconds", "1", "--trace", "0"], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr
    assert not out.stdout.strip()
