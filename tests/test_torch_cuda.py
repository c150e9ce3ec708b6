"""Kernels K1 and K2 on the card against their plain torch versions, and the
port's n = 8 proofs on the card against the golden files.  Exact
comparisons.  Every test needs a CUDA device and skips without one; this
file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py -q
"""

import json
import pathlib

import pytest
import torch

from tpu_stark_torch import kernels
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.hash import keccak_kernel
from tpu_stark_torch.ntt import ntt_kernel, radix2

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    kernels.lib()
    return torch.device("cuda", 0)


def _monty(dev, shape, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randint(0, bb.P, shape, generator=g, device=dev, dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("n,k", [(1, 1), (37, 6), (129, 8), (1000, 40), (4096, 35), (77, 3608)])
def test_keccak_kernel_equals_plain(dev, n, k):
    a = _monty(dev, (n, k), n + k)
    before = kernels.KECCAK_SPONGE.launches
    got = keccak_kernel.hash_rows(a)
    assert kernels.KECCAK_SPONGE.launches == before + 1
    assert torch.equal(got, keccak_kernel.hash_rows_plain(a))


def test_keccak_kernel_split_rows_equal_plain(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    left = torch.randint(-(1 << 31), 1 << 31, (999, 8), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    right = torch.randint(-(1 << 31), 1 << 31, (999, 8), generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    assert torch.equal(keccak_kernel.hash_rows(left, right), keccak_kernel.hash_rows_plain(left, right))


@pytest.mark.parametrize("log_h", [1, 2, 5, 8, 9, 12, 13, 17, 21])
@pytest.mark.parametrize("w", [1, 2, 3, 6, 8, 16, 33, 128])
def test_ntt_kernel_equals_plain(dev, log_h, w):
    if (1 << log_h) * w > 1 << 24:
        w = max(1, (1 << 24) >> log_h)
    x = _monty(dev, (1 << log_h, w), log_h * 100 + w)
    for inverse in (False, True):
        assert torch.equal(ntt_kernel.dft(x, inverse), ntt_kernel.dft_plain(x, inverse))


def test_coset_lde_on_card_equals_cpu(dev):
    x = _monty(dev, (1 << 10, 4), 5)
    got = radix2.coset_lde_batch(x, 2, bb.GENERATOR).cpu()
    assert torch.equal(got, radix2.coset_lde_batch(x.cpu(), 2, bb.GENERATOR))


@pytest.mark.parametrize("layout,name", [("tpu", "fib_air_zk_n8_smallrng.json"), ("p3", "fib_air_zk_n8_smallrng_p3.json")])
def test_n8_proof_on_card_matches_golden(dev, layout, name):
    from tpu_stark_torch.air.fibonacci import FibonacciAir, generate_trace_rows
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.proof import serialize_proof
    from tpu_stark_torch.prover.prove import prove

    fixture = json.loads((pathlib.Path(__file__).parent / "golden" / name).read_text())
    cfg = create_config(zk=True, zk_rng="smallrng", zk_layout=layout, device=dev)
    proof = prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, 8), [0, 1, 21])
    assert serialize_proof(proof).hex() == fixture["proof_hex"]
