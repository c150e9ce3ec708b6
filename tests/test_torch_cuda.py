"""Kernels K1-K5 and the grind kernel on the card against their plain
torch versions, and the port's n = 8 proofs (the BASELINE config 2 one on
both NTT routes) and a keccak-air wide proof on the card against the golden
files and the JAX fixtures.  Exact
comparisons.  Every test needs a CUDA device and skips without one; this
file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py -q
"""

import json
import pathlib

import pytest
import torch

from tpu_stark_torch import kernels
from tpu_stark_torch.challenger import grind
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.hash import keccak_kernel, poseidon2_kernel
from tpu_stark_torch.ntt import mxu_ntt, ntt_kernel, radix2

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


@pytest.mark.parametrize("log_h", [9, 10, 11, 18, 19, 20, 21])
@pytest.mark.parametrize("w", [1, 2, 3, 8, 128, 257])
def test_ntt_kernel_equals_plain_at_pass_boundaries(dev, log_h, w):
    """Heights where the plan goes from one pass to two (2^9 -> 2^10 for
    w >= 8, 2^10 -> 2^11 below) and from two to three (2^18 -> 2^19,
    2^20 -> 2^21)."""
    if (1 << log_h) * w > 1 << 26:
        w = max(1, min(w, (1 << 26) >> log_h))
    x = _monty(dev, (1 << log_h, w), log_h * 1000 + w)
    p = ntt_kernel.plan(log_h, w)
    before = (kernels.NTT_PASS0.launches, kernels.NTT_PASS.launches)
    for inverse in (False, True):
        assert torch.equal(ntt_kernel.dft(x, inverse), ntt_kernel.dft_plain(x, inverse))
    assert kernels.NTT_PASS0.launches == before[0] + 2
    assert kernels.NTT_PASS.launches == before[1] + 2 * len(p.passes)


@pytest.mark.parametrize("w,offset", [(128, 1), (4, 1), (4, 2), (8, 2), (2, 1), (3, 1)])
def test_ntt_kernel_on_a_misaligned_row_slice(dev, w, offset):
    """A matrix whose data_ptr() is not 16-byte aligned takes the narrower
    vector (or scalar) path of the same kernel."""
    h = 1 << 15
    flat = _monty(dev, (h * w + offset,), w + offset)
    x = flat[offset:].view(h, w)
    assert ntt_kernel.vector_lanes(w, x) < 4
    for inverse in (False, True):
        assert torch.equal(ntt_kernel.dft(x, inverse), ntt_kernel.dft_plain(x, inverse))


def test_ntt_kernel_equals_plain_at_the_chunk_lde_shape(dev):
    x = _monty(dev, (1 << 21, 128), 21128)
    for inverse in (False, True):
        assert torch.equal(ntt_kernel.dft(x, inverse), ntt_kernel.dft_plain(x, inverse))


def test_coset_lde_on_card_equals_cpu(dev):
    x = _monty(dev, (1 << 10, 4), 5)
    got = radix2.coset_lde_batch(x, 2, bb.GENERATOR).cpu()
    assert torch.equal(got, radix2.coset_lde_batch(x.cpu(), 2, bb.GENERATOR))


@pytest.mark.parametrize("n,k", [(1, 1), (37, 7), (129, 8), (1000, 9), (777, 16), (4097, 493)])
def test_poseidon2_kernel_equals_plain(dev, n, k):
    a = _monty(dev, (n, k), 7 * n + k)
    before = kernels.POSEIDON2_SPONGE.launches
    got = poseidon2_kernel.hash_rows(a)
    assert kernels.POSEIDON2_SPONGE.launches == before + 1
    assert torch.equal(got, poseidon2_kernel.hash_rows_plain(a))
    if k > 1:  # a salted leaf: the row and its salt as two operands
        assert torch.equal(poseidon2_kernel.hash_rows(a[:, : k - 1], a[:, k - 1 :]), got)


def test_poseidon2_compress_strided_rows_equal_plain(dev):
    layer = _monty(dev, (2 * 999, 8), 11)
    left, right = layer[0::2], layer[1::2]  # a tree layer's pairs, read through strides
    want = poseidon2_kernel.compress_plain(left, right)
    assert torch.equal(poseidon2_kernel.compress(left, right), want)
    assert torch.equal(poseidon2_kernel.compress(left.contiguous(), right.contiguous()), want)


@pytest.mark.parametrize(
    "n,chunks", [(1, (8,)), (37, (5,)), (129, (16, 8, 3)), (1000, (128, 128, 109)), (4097, (64, 64))]
)
def test_poseidon2_absorb_kernel_equals_plain(dev, n, chunks):
    """Chunked absorbs, ragged only as the row's last chunk, from the zero
    state and from a carried one."""
    a = _monty(dev, (n, sum(chunks)), 13 * n)
    carried = _monty(dev, (n, 16), 17 * n)
    for first in (True, False):
        got, want = carried.clone(), carried.clone()
        before = kernels.POSEIDON2_ABSORB.launches
        off = 0
        for i, wc in enumerate(chunks):  # a[:, off:off+wc] reads rows through their stride
            poseidon2_kernel.absorb_rows(got, a[:, off : off + wc], first=first and i == 0)
            poseidon2_kernel.absorb_rows_plain(want, a[:, off : off + wc], first=first and i == 0)
            off += wc
        assert kernels.POSEIDON2_ABSORB.launches == before + len(chunks)
        assert torch.equal(got, want)
        if first:
            assert torch.equal(got[:, :8], poseidon2_kernel.hash_rows(a))


def test_keccak_air_wide_proof_on_card_matches_jax(dev):
    import hashlib

    from tpu_stark_torch.air.keccak_air import KeccakAir, generate_trace
    from tpu_stark_torch.fri.config import create_benchmark_fri_params
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.proof import serialize_proof
    from tpu_stark_torch.prover.wide import prove_wide

    want = json.loads((pathlib.Path(__file__).parent / "golden" / "torch_keccak_air_jax_proofs.json").read_text())
    cfg = create_config(create_benchmark_fri_params(1), zk=False, hash="poseidon2", device=dev)
    before = kernels.POSEIDON2_ABSORB.launches
    blob = serialize_proof(prove_wide(cfg, KeccakAir(), generate_trace(2, seed=1, device=dev), []))
    assert kernels.POSEIDON2_ABSORB.launches > before
    assert hashlib.sha256(blob).hexdigest() == want["perms_2"]["sha256"]


@pytest.mark.parametrize("layout", ["tpu", "p3"])
def test_poseidon2_n8_proof_on_card_matches_jax(dev, layout):
    from tpu_stark_torch.air.fibonacci import FibonacciAir, generate_trace_rows
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.proof import serialize_proof
    from tpu_stark_torch.prover.prove import prove

    fixture = json.loads((pathlib.Path(__file__).parent / "golden" / "torch_poseidon2_jax_proofs.json").read_text())
    cfg = create_config(zk=True, hash="poseidon2", zk_rng="smallrng", zk_layout=layout, device=dev)
    proof = prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, 8), [0, 1, 21])
    assert serialize_proof(proof).hex() == fixture[f"fib_zk_{layout}_3"]["proof_hex"]


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


@pytest.mark.parametrize("n,m", [(16, 1), (16, 4133), (32, 999), (64, 65536), (128, 4097), (256, 65536), (256, 33)])
def test_mxu_kernel_equals_plain(dev, n, m):
    x = _monty(dev, (n, m), n + m)
    for inverse in (False, True):
        limbs = mxu_ntt.limbs_on(n, inverse, dev)
        before = kernels.MXU_MM.launches
        got = mxu_ntt.mod_matmul_axis(x, limbs)
        assert kernels.MXU_MM.launches == before + 1
        assert torch.equal(got, mxu_ntt.mod_matmul_axis_plain(x, limbs))


def test_mxu_kernel_extremes_equal_plain(dev):
    """All-(p-1) data against the DFT matrix (the largest diagonals), and zeros."""
    for fill in (bb.P - 1, 0):
        x = torch.full((256, 640), fill, dtype=torch.int32, device=dev)
        limbs = mxu_ntt.limbs_on(256, False, dev)
        assert torch.equal(mxu_ntt.mod_matmul_axis(x, limbs), mxu_ntt.mod_matmul_axis_plain(x, limbs))


@pytest.mark.parametrize("h,w", [(1 << 16, 2), (1 << 17, 4), (1 << 21, 2), (1 << 16, 32)])
def test_narrow_route_on_card_equals_k2(dev, h, w):
    from tpu_stark_torch.ntt.dft import Dft

    x = _monty(dev, (h, w), h + w)
    mxu, k2 = Dft(dev, narrow="mxu"), Dft(dev)
    before = kernels.MXU_MM.launches
    assert torch.equal(mxu.dft_batch(x), k2.dft_batch(x))
    assert torch.equal(mxu.idft_batch(x), k2.idft_batch(x))
    assert kernels.MXU_MM.launches > before


@pytest.mark.parametrize("n_bytes", [32, 132, 134, 200, 268])
def test_grind_kernel_equals_plain(dev, n_bytes):
    import numpy as np

    data = bytes(np.random.default_rng(n_bytes).integers(0, 256, size=n_bytes, dtype=np.uint8))
    prefix, tail, w_off = grind._plan(data)
    pre, tl = grind._operands(prefix, tail, dev)
    for bits in (1, 8, 16):
        before = kernels.KECCAK_GRIND.launches
        got = grind.verdicts(12345, 1 << 16, pre, tl, w_off, bits)
        assert kernels.KECCAK_GRIND.launches == before + 1
        assert torch.equal(got, grind.verdicts_plain(12345, 1 << 16, pre, tl, w_off, bits))


def test_config2_n8_proof_on_card_matches_jax(dev):
    from tpu_stark_torch.air.fibonacci import FibonacciAir, generate_trace_rows
    from tpu_stark_torch.fri.config import create_benchmark_fri_params
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.proof import serialize_proof
    from tpu_stark_torch.prover.prove import prove

    fixture = json.loads((pathlib.Path(__file__).parent / "golden" / "torch_fib_zk_device_jax_proofs.json").read_text())
    for narrow in (None, "mxu"):
        cfg = create_config(create_benchmark_fri_params(1), zk=True, device=dev, narrow_ntt=narrow)
        before = kernels.KECCAK_GRIND.launches
        proof = prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, 8), [0, 1, 21])
        assert kernels.KECCAK_GRIND.launches > before
        assert serialize_proof(proof).hex() == fixture["3"]["proof_hex"]
