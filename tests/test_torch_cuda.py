"""Kernels K1-K5 (K1's tree kernel, its carried-state absorb and K5's fused
inner level too),
the grind kernel and K6 (the device rng's sample) on the card against their plain torch versions, and the
port's n = 8 proofs (the BASELINE config 2 one on both NTT routes) and
keccak-air wide proofs (zk off, and zk on the Keccak stack) on the card
against the golden files and the JAX fixtures; the app, the DFT harness (its exact check against the CPU tier),
the NTT oracle, the prove twins and the SoL probes on the card; K7 (the
quotient pass's constraint evaluation and fold, generated from the AIR's
DAG) and K8 (the panel coset fold) against their plain versions and the
DAG's numpy interpretation, and the dense and streamed quotient passes on
the card against the CPU; K9-K11 (the open phase's reduced opening, point
evaluations and FRI fold) against their plain versions, raising where the
build fails, and a fib zk prove that runs no plain open step.  Exact comparisons.  Every test needs a CUDA device and skips without one; this
file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py -q
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from quotient_dag import interpret
from tpu_stark_torch import kernels
from tpu_stark_torch.air import keccak_air, poseidon2_air
from tpu_stark_torch.air import quotient_kernel as qk
from tpu_stark_torch.air.fibonacci import FibonacciAir
from tpu_stark_torch.challenger import grind
from tpu_stark_torch.compat import device_rng as drng
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


def _u32(dev, shape, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=g, device=dev, dtype=torch.int64).to(torch.int32)


def _layers_equal(got, want):
    return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("log_n", range(1, 24))
def test_keccak_tree_equals_plain(dev, log_n):
    """Every compress layer of a tree over 2^log_n digests (2 to 2^23, the
    fib prove's heights) in ``tree_plan``'s launches, against the plain
    layer loop."""
    d = _u32(dev, (1 << log_n, 4, 2), log_n)
    before = kernels.KECCAK_TREE.launches
    got = keccak_kernel.compress_levels(d, log_n)
    assert kernels.KECCAK_TREE.launches == before + len(keccak_kernel.tree_plan(log_n, log_n))
    assert _layers_equal(got, keccak_kernel.compress_levels_plain(d, log_n))


@pytest.mark.parametrize("log_n,levels", [
    (7, 7), (8, 8), (9, 9), (9, 1), (15, 15), (16, 16), (16, 3), (17, 17), (17, 1), (17, 9),
    (20, 20), (21, 21), (21, 5), (22, 22), (22, 6), (22, 13)])
def test_keccak_tree_at_plan_boundaries(dev, log_n, levels):
    """Around the plan's group sizes (a subtree of 2^(TOP_LOG - 1), 2^TOP_LOG
    and 2^(TOP_LOG + 1) digests a block; layers at 2^BIG_LOG and a band more
    or less), runs that stop below the root, and other launch plans through
    ``run_plan``."""
    assert (keccak_kernel.TOP_LOG, keccak_kernel.BIG_LOG, keccak_kernel.BAND_LEVELS) == (8, 16, 5)
    d = _u32(dev, (1 << log_n, 4, 2), 1000 * log_n + levels)
    want = keccak_kernel.compress_levels_plain(d, levels)
    assert _layers_equal(keccak_kernel.compress_levels(d, levels), want)
    for plan in _other_plans(log_n, levels):
        assert _layers_equal(keccak_kernel.run_plan(d, plan), want)


def _other_plans(log_n, levels):
    """Launch plans of the same levels besides tree_plan's: groups of 6 from
    the bottom, and bands of 3 levels whose blocks keep 32 nodes at the top
    (a subtree no larger than its layer or MAX_SUB_LOG)."""
    groups, bands, m, left = [], [], log_n, levels
    while left:
        groups.append((min(6, left), min(6, left)))
        left -= groups[-1][1]
    left = levels
    while left:
        lv = min(3, left)
        bands.append((min(lv + 5, m, keccak_kernel.MAX_SUB_LOG), lv))
        m, left = m - lv, left - lv
    return groups, bands


@pytest.mark.parametrize("offset_words", [8, 24, 1, 3])
def test_keccak_tree_on_a_layer_with_an_offset_base(dev, offset_words):
    """A layer that is a slice of a larger buffer: whole digests in (16-byte
    aligned) and single words in (4 bytes past a boundary)."""
    n = 1 << 12
    flat = _u32(dev, (n * 8 + offset_words,), offset_words)
    d = flat[offset_words:].view(n, 4, 2)
    assert _layers_equal(keccak_kernel.compress_levels(d, 12), keccak_kernel.compress_levels_plain(d, 12))


def test_keccak_wrappers_never_run_plain_on_the_card(dev, monkeypatch):
    """A CUDA tensor reaches the kernels, never the plain versions."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    a, d = _u32(dev, (100, 6), 1), _u32(dev, (64, 4, 2), 2)
    want_rows, want_tree = keccak_kernel.hash_rows_plain(a), keccak_kernel.compress_levels_plain(d, 6)
    monkeypatch.setattr(keccak_kernel, "hash_rows_plain", refuse)
    monkeypatch.setattr(keccak_kernel, "compress_levels_plain", refuse)
    assert torch.equal(keccak_kernel.hash_rows(a), want_rows)
    assert _layers_equal(keccak_kernel.compress_levels(d, 6), want_tree)


@pytest.mark.parametrize(
    "n,chunking", [(1, (34,)), (37, (7, 30, 34, 10)), (129, (1, 33, 34, 35, 68)), (1000, (64, 64, 64, 64, 4)),
                   (4097, (64, 64, 20)), (300, (33, 1)), (2048, (128, 128, 4))]
)
def test_keccak_absorb_kernel_equals_plain(dev, n, chunking):
    """K1's carried-state absorb over chunks, one launch a chunk (the
    pending words it writes back read by the next launch; a chunk that
    completes no block only joins them), in every operand form: canonical
    words or Montgomery forms in the tree's row order, or (n a power of two)
    Montgomery forms in natural order; from the zero state and a carried
    one, the state and the chunks off 16-byte boundaries; then the finalize,
    with and without a last chunk: each step equals the plain version, and
    from the zero state the canonical tree-order digests equal hash_rows.
    Canonical words in natural order are refused."""
    forms = [(False, False), (True, False)] + ([(True, True)] if n & (n - 1) == 0 else [])
    with pytest.raises(ValueError, match="Montgomery"):
        keccak_kernel.absorb_rows(torch.zeros((50, 64), dtype=torch.int32, device=dev),
                                  _u32(dev, (64, 34), n), natural=True)
    for monty, natural in forms:
        m = (_monty if monty else _u32)(dev, (n, sum(chunking) + 3), 29 * n)[:, 2 : 2 + sum(chunking)]
        for first in (True, False):
            flat = _u32(dev, (50 * n + 1,), 31 * n)
            state = flat[1:].view(50, n)
            want = state.clone()
            pend = want_pend = None
            off, begun, before = 0, False, kernels.KECCAK_ABSORB.launches
            for wc in chunking:
                blk = m[:, off : off + wc]
                off += wc
                start = first and not begun
                pend = keccak_kernel.absorb_rows(state, blk, start, pend, monty, natural)
                want_pend = keccak_kernel.absorb_rows_plain(want, blk, start, want_pend, monty, natural)
                begun = off >= keccak_kernel.BLOCK_WORDS  # a block absorbed: the state is carried
                torch.cuda.synchronize()
                assert torch.equal(state, want)
                assert (pend is None) == (want_pend is None)
                assert pend is None or torch.equal(pend, want_pend)
            start = first and not begun
            got = keccak_kernel.finalize_rows(state, pend, start)
            assert kernels.KECCAK_ABSORB.launches == before + len(chunking) + 1
            assert torch.equal(got, keccak_kernel.finalize_rows_plain(want, want_pend, start))
            last = m[:, :5]
            assert torch.equal(keccak_kernel.finalize_rows(state, pend, start, last, monty, natural),
                               keccak_kernel.finalize_rows_plain(want, want_pend, start, last, monty, natural))
            if first and not monty and not natural:
                assert torch.equal(got, keccak_kernel.hash_rows(m))


def test_keccak_row_stream_never_runs_plain_on_the_card(dev, monkeypatch):
    from tpu_stark_torch.hash.sponge import KeccakRowStream

    from tpu_stark_torch.matrix import reverse_matrix_index_bits

    m = _u32(dev, (513, 150), 3)
    want = keccak_kernel.hash_rows_plain(m)
    # natural-order Montgomery chunks as K2 leaves them, then tree-order salts
    code, salts = _monty(dev, (512, 150), 4), _monty(dev, (512, 4), 5)
    want_code = keccak_kernel.hash_rows_plain(bb.to_u32(torch.cat([reverse_matrix_index_bits(code), salts], 1)))

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("absorb_rows_plain", "finalize_rows_plain", "keccak_f_plain", "hash_rows_plain"):
        monkeypatch.setattr(keccak_kernel, name, refuse)
    stream = KeccakRowStream(513, dev)
    for off in range(0, 150, 64):
        stream.absorb_cols(m[:, off : off + 64])
    assert torch.equal(stream.finalize(), want)
    stream, before = KeccakRowStream(512, dev), kernels.KECCAK_ABSORB.launches
    for off in range(0, 150, 64):
        stream.absorb_monty(code[:, off : off + 64].contiguous(), True)
    stream.absorb_monty(salts, False)
    assert torch.equal(stream.finalize(), want_code)
    assert kernels.KECCAK_ABSORB.launches == before + 4  # the salts complete no block: the finalize reads them


def test_zk_wide_proof_on_card_matches_jax(dev):
    """The reference's stack in 4 column chunks: the JAX fixture's bytes."""
    import hashlib

    from tpu_stark_torch.air.keccak_air import KeccakAir, generate_trace
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.proof import serialize_proof
    from tpu_stark_torch.prover.wide import prove_wide

    path = pathlib.Path(__file__).parent / "golden" / "torch_keccak_air_wide_zk_jax_proofs.json"
    want = json.loads(path.read_text())["keccak_4chunks"]
    before = kernels.KECCAK_ABSORB.launches
    blob = serialize_proof(prove_wide(create_config(zk=True, hash="keccak", device=dev), KeccakAir(),
                                      generate_trace(2, seed=8, device=dev), [], col_chunk=1024))
    assert kernels.KECCAK_ABSORB.launches > before
    assert hashlib.sha256(blob).hexdigest() == want["sha256"] and len(blob) == want["len"]


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


def _misaligned(dev, n, k, seed):
    """An (n, k) contiguous matrix whose data_ptr() is 4 bytes past a
    16-byte boundary."""
    flat = _monty(dev, (n * k + 1,), seed)
    x = flat[1:].view(n, k)
    assert x.data_ptr() % 16 == 4
    return x


@pytest.mark.parametrize("n,k", [(1, 1), (37, 7), (129, 8), (1000, 9), (777, 16), (4097, 493),
                                 (513, 4), (300, 12), (260, 20), (129, 3), (1000, 13), (2048, 128)])
def test_poseidon2_kernel_equals_plain(dev, n, k):
    """Leaves at widths that are and are not multiples of 4 and 8, on
    16-byte-aligned rows, on a misaligned base and through a column slice."""
    a = _monty(dev, (n, k), 7 * n + k)
    before = kernels.POSEIDON2_SPONGE.launches
    got = poseidon2_kernel.hash_rows(a)
    assert kernels.POSEIDON2_SPONGE.launches == before + 1
    assert torch.equal(got, poseidon2_kernel.hash_rows_plain(a))
    if k > 1:  # a salted leaf: the row and its salt as two operands
        assert torch.equal(poseidon2_kernel.hash_rows(a[:, : k - 1], a[:, k - 1 :]), got)
    m = _misaligned(dev, n, k, 5 * n + k)
    assert torch.equal(poseidon2_kernel.hash_rows(m), poseidon2_kernel.hash_rows_plain(m))
    wide = _monty(dev, (n, k + 1), 3 * n + k)[:, 1:]  # rows 4 bytes past their stride's start
    assert torch.equal(poseidon2_kernel.hash_rows(wide), poseidon2_kernel.hash_rows_plain(wide))


def test_poseidon2_compress_strided_rows_equal_plain(dev):
    layer = _monty(dev, (2 * 999, 8), 11)
    left, right = layer[0::2], layer[1::2]  # a tree layer's pairs, read through strides
    want = poseidon2_kernel.compress_plain(left, right)
    assert torch.equal(poseidon2_kernel.compress(left, right), want)
    assert torch.equal(poseidon2_kernel.compress(left.contiguous(), right.contiguous()), want)
    odd = _misaligned(dev, 999, 8, 12)  # one side off a 16-byte boundary
    assert torch.equal(poseidon2_kernel.compress(odd, right), poseidon2_kernel.compress_plain(odd, right))


@pytest.mark.parametrize(
    "n,chunks", [(1, (8,)), (37, (5,)), (129, (16, 8, 3)), (1000, (128, 128, 109)), (4097, (64, 64)),
                 (300, (8, 12)), (513, (24, 16, 6)), (2048, (128, 128, 128))]
)
def test_poseidon2_absorb_kernel_equals_plain(dev, n, chunks):
    """Chunked absorbs, ragged only as the row's last chunk, from the zero
    state and from a carried one, with the matrix and the state on 16-byte
    boundaries and off them."""
    carried = _monty(dev, (n, 16), 17 * n)
    for a, state in ((_monty(dev, (n, sum(chunks)), 13 * n), torch.empty_like(carried)),
                     (_misaligned(dev, n, sum(chunks), 19 * n), _misaligned(dev, n, 16, 23 * n))):
        _absorb_in_chunks(n, chunks, a, carried, state)


def _absorb_in_chunks(n, chunks, a, carried, got):
    for first in (True, False):
        got.copy_(carried)
        want = carried.clone()
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


def _route_levels(h, w):
    """(B, A, R) of each level of mxu_ntt.dft_axis0 on (h, w), outermost
    first; the leaf has A = 1."""
    out, n, r = [], h, w
    while n > mxu_ntt.MAX_DIRECT:
        b = 1 << min((n.bit_length() - 1) // 2, 8)
        out.append((b, n // b, r))
        n, r = n // b, r * b
    out.append((n, 1, r))
    return out


def _fused_plain(x, w, tw, rows=1 << 22):
    """The inner level's plain version, in slices of the A axis (its
    columns are independent) so that the int64 and float64 temporaries stay
    small at 2^28 elements."""
    b, a = int(x.shape[0]), int(x.shape[1])
    step = max(1, rows // (b * (x.numel() // (b * a))))
    return torch.cat([mxu_ntt.mod_matmul_twiddle_moved_plain(x[:, a0:a0 + step].contiguous(), w, tw[a0:a0 + step])
                      for a0 in range(0, a, step)])


@pytest.mark.parametrize("log_h", range(16, 24))
@pytest.mark.parametrize("w", [1, 2, 4, 8, 32])
def test_mxu_fused_levels_equal_plain(dev, log_h, w):
    """Every level the route makes for (2^log_h, w), both directions: the
    fused inner level (product, twiddle, moved store) and the leaf."""
    for b, a, r in _route_levels(1 << log_h, w):
        x = _monty(dev, (b, a, r), b + a + r + w)
        for inverse in (False, True):
            lw = mxu_ntt.limbs_on(b, inverse, dev)
            if a == 1:
                got, want = mxu_ntt.mod_matmul_axis(x, lw), mxu_ntt.mod_matmul_axis_plain(x, lw)
            else:
                tw = mxu_ntt.twiddles_on(a, b, inverse, dev)
                got, want = mxu_ntt.mod_matmul_twiddle_moved(x, lw, tw), _fused_plain(x, lw, tw)
            assert torch.equal(got, want), (b, a, r, inverse)
        del x


@pytest.mark.parametrize("b,a,r", [(16, 32, 1), (32, 32, 2), (64, 128, 3), (256, 512, 1), (16, 8, 37),
                                   (128, 2, 70), (256, 4, 33), (64, 64, 100), (32, 1024, 5)])
def test_mxu_fused_ragged_equals_plain(dev, b, a, r):
    """Ragged R (tiles of whole a's with a partial last tile, tiles of one
    a's columns with a partial tail) and R below and above the tile."""
    x = _monty(dev, (b, a, r), b * a + r)
    for inverse in (False, True):
        lw, tw = mxu_ntt.limbs_on(b, inverse, dev), mxu_ntt.twiddles_on(a, b, inverse, dev)
        assert torch.equal(mxu_ntt.mod_matmul_twiddle_moved(x, lw, tw), _fused_plain(x, lw, tw))


def test_mxu_fused_extremes_equal_plain(dev):
    """All-(p-1) data (the largest diagonals) and zeros, through the fused
    epilogue with both store paths (R below and above the tile)."""
    for b, a, r in [(256, 64, 2), (64, 16, 512)]:
        lw, tw = mxu_ntt.limbs_on(b, False, dev), mxu_ntt.twiddles_on(a, b, False, dev)
        for fill in (bb.P - 1, 0):
            x = torch.full((b, a, r), fill, dtype=torch.int32, device=dev)
            assert torch.equal(mxu_ntt.mod_matmul_twiddle_moved(x, lw, tw), _fused_plain(x, lw, tw))


@pytest.mark.parametrize("h,w", [(1 << 16, 2), (1 << 20, 8), (1 << 23, 2)])
def test_mxu_route_launches_one_kernel_a_level(dev, h, w):
    """dft_axis0 launches K5 once a level and nothing else: the launch
    count rises by the number of levels, and the profiler sees only K5's
    kernels between input and output (tables made by a first call)."""
    from torch.profiler import ProfilerActivity, profile

    x = _monty(dev, (h, w), h + w)
    for inverse in (False, True):
        mxu_ntt.dft_axis0(x, inverse)
        torch.cuda.synchronize()
        before = kernels.MXU_MM.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mxu_ntt.dft_axis0(x, inverse)
            torch.cuda.synchronize()
        assert kernels.MXU_MM.launches - before == len(_route_levels(h, w))
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert names and all("mxu_mm_kernel" in name for name in names), names


# transcript lengths: the witness inside a lane (32, 130, 200), filling
# block 0's last lane (132, 268), straddling two lanes (37) and the block
# boundary (134, 135)
@pytest.mark.parametrize("n_bytes", [32, 132, 134, 200, 268, 37, 130, 135])
def test_grind_kernel_equals_plain(dev, n_bytes):
    """Counts whose last block is partly idle (1000, 2^17 + 77), and the
    main path's 2^17."""
    import numpy as np

    data = bytes(np.random.default_rng(n_bytes).integers(0, 256, size=n_bytes, dtype=np.uint8))
    prefix, tail, w_off = grind._plan(data)
    pre, tl = grind._operands(prefix, tail, dev)
    for bits, count in ((1, 1 << 16), (8, (1 << 17) + 77), (16, 1 << 17), (3, 1000)):
        before = kernels.KECCAK_GRIND.launches
        got = grind.verdicts(12345, count, pre, tl, w_off, bits)
        assert kernels.KECCAK_GRIND.launches == before + 1
        assert torch.equal(got, grind.verdicts_plain(12345, count, pre, tl, w_off, bits))


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


def _rng_plain(k, cols, dev, rows=0, sel=None, row0=0, row_idx=None):
    """The plain Threefry sample on the card's tensors: rows row0 + (r or
    row_idx[r]) and columns (c or sel[c]) of a sample of ``cols`` columns."""
    r = torch.arange(rows) if row_idx is None else torch.as_tensor(row_idx)
    c = torch.arange(cols) if sel is None else torch.as_tensor(sel)
    return drng._monty_at(k, ((r[:, None] + row0) * cols + c[None, :]).to(dev))


# (rows, cols, sel, row0, row_idx) of K6's calls: whole samples (the salts'
# 4 columns, odd widths), columns with repeats, rows from row0 with flat
# indices past 2^32, gathered rows with repeats
RNG_CASES = [
    (1, 1, None, 0, None), (1000, 4, None, 0, None), (777, 3, None, 0, None), (4099, 64, None, 0, None),
    (1 << 20, 4, None, 0, None), (513, 13, [12, 0, 0, 5, 5, 5, 7], 0, None), (300, 64, list(range(0, 64, 3)), 9, None),
    (1000, 4, None, (1 << 32) // 4 - 500, None), (17, 5, [4, 1], (1 << 33) + 3, None),
    (0, 4, None, 0, [7, 7, 0, 1 << 20, 3, 3]), (0, 4, None, (1 << 32) // 4 - 2, [0, 1, 2, 3, 1, 0]),
    (0, 7, None, 5, [9, 2, 2]),
]


@pytest.mark.parametrize("rows,cols,sel,row0,row_idx", RNG_CASES)
def test_threefry_kernel_equals_plain(dev, rows, cols, sel, row0, row_idx):
    k = drng.fold_in(drng.key(1), 5)
    before = kernels.THREEFRY_MONTY.launches
    if row_idx is None:
        got = drng._sample_monty(k, rows, cols, dev, sel=sel, row0=row0)
    else:
        got = drng.LazyMatrix(k, 1 << 21, cols, dev, row0=row0).rows(torch.tensor(row_idx, device=dev))
    assert kernels.THREEFRY_MONTY.launches == before + 1
    assert torch.equal(got, _rng_plain(k, cols, dev, rows, sel, row0, row_idx))


def test_rng_never_runs_plain_on_the_card(dev, monkeypatch):
    """Config 2 at n = 8 (device rng) with the plain Threefry refused: K6
    draws every sample and the bytes are the JAX fixture's."""
    from tpu_stark_torch.air.fibonacci import FibonacciAir, generate_trace_rows
    from tpu_stark_torch.fri.config import create_benchmark_fri_params
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.proof import serialize_proof
    from tpu_stark_torch.prover.prove import prove

    def refuse(*args, **kwargs):
        raise AssertionError("the plain Threefry ran on CUDA tensors")

    monkeypatch.setattr(drng, "_monty_at", refuse)
    fixture = json.loads((pathlib.Path(__file__).parent / "golden" / "torch_fib_zk_device_jax_proofs.json").read_text())
    before = kernels.THREEFRY_MONTY.launches
    cfg = create_config(create_benchmark_fri_params(1), zk=True, device=dev)
    proof = prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, 8), [0, 1, 21])
    assert kernels.THREEFRY_MONTY.launches > before
    assert serialize_proof(proof).hex() == fixture["3"]["proof_hex"]


def test_harness_case_on_card_equals_cpu_tier(dev):
    from tpu_stark_torch.bench import harness

    before = kernels.NTT_PASS0.launches
    res = harness.run_case(1024, 8, use_cuda=True, device=dev)  # raises unless the card's output is the CPU tier's
    runs = harness.WARMUP + harness.REPEATS
    assert kernels.NTT_PASS0.launches - before == runs * (1 + harness.E2E_BATCH + harness.KERNEL_INNER) + 1
    for tier in (res.cuda_e2e, res.cuda_batched, res.cuda_kernel):
        assert 0 < tier.avg_ms and tier.median_ms <= tier.p95_ms
    line = res.format_line()
    assert line.startswith("dft 1024x8: cpu=") and "cuda_e2e=" in line and "cuda_kernel=" in line


def test_dft_benchmark_report_on_card(dev):
    from tpu_stark_torch.bench import harness

    out = harness.run_dft_benchmark([(256, 8), (256, 16000)])
    lines = out.splitlines()
    assert lines[0].startswith("policy: ") and torch.cuda.get_device_name(dev) in lines[0]
    assert "kernels yes" in lines[0]
    assert [ln.split(":")[0] for ln in lines[1:]] == ["dft 256x8", "dft 256x16000"]
    assert all("cuda_batched=" in ln for ln in lines[1:])


def test_app_on_card(dev):
    from tpu_stark_torch.app import api
    from tpu_stark_torch.backend import registry

    saved = registry.backend_kind()
    try:
        api.set_backend("cuda")
        assert registry.device().type == "cuda"
        before = kernels.KECCAK_SPONGE.launches
        assert api.run_fib_air_zk() == "fib_air zk ok (n=8, x=21)"
        assert kernels.KECCAK_SPONGE.launches > before
        assert api.run_poseidon2_chain(3) == "poseidon2_chain ok (rows=2^3)"
    finally:
        registry.set_backend(saved)


def test_reference_oracle_on_card(dev):
    import numpy as np

    from tpu_stark_torch.ntt.reference import naive_dft_matrix

    mat = np.random.default_rng(16).integers(0, bb.P, size=(16, 3), dtype=np.uint64).astype(np.uint32)
    for shift in (1, bb.GENERATOR):
        got = radix2.coset_dft_batch(bb.to_tensor(bb.np_to_monty(mat), dev), shift)
        assert np.array_equal(bb.np_from_monty(bb.to_numpy(got)), naive_dft_matrix(mat, shift))


def test_prove_twins_on_card_have_jax_lengths(dev, capsys):
    from tpu_stark_torch.bench import prove as bench_prove

    golden = pathlib.Path(__file__).parent / "golden"
    config2 = json.loads((golden / "torch_fib_zk_device_jax_proofs.json").read_text())
    chain = json.loads((golden / "torch_poseidon2_jax_proofs.json").read_text())
    out = bench_prove.main(["fib", "10", "keccak", "zk", "1", "bench", "--device", str(dev)])
    assert out["metric"] == "fib_air_zk_prove_2^10_keccak_bench"
    assert out["proof_bytes"] == config2["10"]["len"]
    assert out["peak_hbm_gb"] > 0 and torch.cuda.get_device_name(dev) in out["device"]
    out = bench_prove.main(["chain", "3", "--device", str(dev), "--narrow", "mxu"])
    assert (out["proof_bytes"], out["narrow"]) == (chain["chain_3"]["len"], "mxu")
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out


def test_ntt_twin_on_card(dev):
    from tpu_stark_torch.bench import ntt as bench_ntt

    out = bench_ntt.main(["--device", str(dev)])
    assert out["metric"] == "babybear_ntt_kernel_16384x128" and out["unit"] == "Melems/s"
    assert out["value"] > 0 and out["vs_baseline"] == out["value"] / 135.0
    block = out["sol_pct_of_roof"]
    assert set(block) == {"dispatch_floor_ms", "roofs", "roof_sources", "kernels"}
    assert set(block["roofs"]) == {"mul", "alu", "hbm"} and len(block["kernels"]) == 9


@pytest.mark.parametrize("n,reps", [(1, 1), (1000, 2), (4099, 1)])
def test_sol_probes_equal_plain(dev, n, reps):
    from tpu_stark_torch.bench import sol

    x, tw = sol.mul_operands(n, dev)
    before = [k.launches for k in kernels.SOL_PROBES]
    assert torch.equal(sol.mul_chain(x, tw, reps), sol.mul_chain_plain(x, tw, reps))
    v = sol.alu_operands(n, dev)
    assert torch.equal(sol.alu_chain(v, reps), sol.alu_chain_plain(v, reps))
    s = torch.arange(n, dtype=torch.int32, device=dev)
    assert torch.equal(sol.stream_step(s.clone()), sol.stream_step_plain(s.clone()))
    assert [k.launches for k in kernels.SOL_PROBES] == [b + 1 for b in before]


# ---------------------------------------------------------------------------
# K7 and K8: the quotient pass
# ---------------------------------------------------------------------------
QUOTIENT_AIRS = {"fib": (FibonacciAir, 3), "chain": (poseidon2_air.Poseidon2ChainAir, 32),
                 "keccak-air": (keccak_air.KeccakAir, 0)}
# one program of each DAG: fib's, the chain's and keccak-air's eight
QUOTIENT_PROGRAMS = ["fib", "chain", "flags", "bool_a0", "bool_c_chi", "theta1", "apdef3", "chi00def", "iota",
                     "trans7"]
# (next rows, next-row shift, selector offset and stride, accumulator offset
# and stride, add, invz): the dense pass, a rank block, a streamed block, the
# last streamed block
QUOTIENT_MODES = {
    "dense": (0, 2, 0, 1, 0, 1, False, True),
    "rank-block": (0, 0, 160, 1, 0, 1, False, True),
    "block": (0, 0, 1, 4, 1, 4, True, False),
    "last-block": (0, 1, 3, 4, 3, 4, True, False),
}


def _quotient_program(name):
    if name in QUOTIENT_AIRS:
        cls, npis = QUOTIENT_AIRS[name]
        return qk.programs(cls(), npis)[0], npis
    return next(p for p in qk.programs(keccak_air.KeccakAir(), 0) if p.name == name), 0


@pytest.mark.parametrize("rows", [1, 33, 4096])
@pytest.mark.parametrize("mode", list(QUOTIENT_MODES))
@pytest.mark.parametrize("name", QUOTIENT_PROGRAMS)
def test_quotient_eval_equals_plain(dev, name, mode, rows):
    _, nshift, sel_off, sel_stride, acc_off, acc_stride, add, invz = QUOTIENT_MODES[mode]
    prog, npis = _quotient_program(name)
    seed = QUOTIENT_PROGRAMS.index(name) * 100 + list(QUOTIENT_MODES).index(mode) * 10 + rows
    u = len(prog.cols) + 3  # a row stride past the program's columns
    cur, nxt = _monty(dev, (rows, u), seed), _monty(dev, (rows, u), seed + 1)
    nshift = min(nshift, rows)
    sels = {k: _monty(dev, (sel_off + rows * sel_stride,), seed + 2 + i) for i, k in enumerate(qk.SELECTORS)}
    pis, alpha = _monty(dev, (npis,), seed + 7), _monty(dev, (prog.count, 4), seed + 8)
    acc = _monty(dev, (acc_off + rows * acc_stride, 4), seed + 9)
    before = kernels.QUOTIENT_EVAL.launches
    got = qk.eval_fold(prog, cur, nxt, nshift, sels, sel_off, sel_stride, pis, alpha, acc.clone(), acc_off,
                       acc_stride, add, invz)
    want = qk.eval_fold_plain(prog, cur, nxt, nshift, sels, sel_off, sel_stride, pis, alpha, acc.clone(), acc_off,
                              acc_stride, add, invz)
    torch.cuda.synchronize()
    assert kernels.QUOTIENT_EVAL.launches == before + 1
    assert torch.equal(got, want)


# K7's persistent grid and ring on the card: (rows, next-row shift (None:
# the mode's), panels 16-byte aligned): a grid with fewer blocks than tiles,
# each walking many through the ring, with a ragged last tile; the next rows
# wrapping to row 0 inside a tile; both panels on the 16-byte copies
QUOTIENT_RING_CASES = {
    "walk": ((1 << 17) + 5, None, False),
    "wrap": ((1 << 12) + 3, 1000, False),
    "aligned": ((1 << 16) + 7, None, True),
}


@pytest.mark.parametrize("case", list(QUOTIENT_RING_CASES))
@pytest.mark.parametrize("mode", list(QUOTIENT_MODES))
@pytest.mark.parametrize("name", QUOTIENT_PROGRAMS)
def test_quotient_eval_ring_equals_plain(dev, name, mode, case):
    rows, shift, aligned = QUOTIENT_RING_CASES[case]
    _, nshift, sel_off, sel_stride, acc_off, acc_stride, add, invz = QUOTIENT_MODES[mode]
    nshift = nshift if shift is None else shift
    prog, npis = _quotient_program(name)
    seed = 5000 + QUOTIENT_PROGRAMS.index(name) * 100 + list(QUOTIENT_MODES).index(mode) * 10 \
        + list(QUOTIENT_RING_CASES).index(case)
    # aligned: a row stride of a multiple of 4 words; else an odd one, so the 4-byte copies
    u = (len(prog.cols) + 3) // 4 * 4 + 4 if aligned else (len(prog.cols) + 3) | 1
    cur, nxt = _monty(dev, (rows, u), seed), _monty(dev, (rows, u), seed + 1)
    assert qk._vec(prog.dag, 0, cur) == qk._vec(prog.dag, 1, nxt) == aligned
    sels = {k: _monty(dev, (sel_off + rows * sel_stride,), seed + 2 + i) for i, k in enumerate(qk.SELECTORS)}
    pis, alpha = _monty(dev, (npis,), seed + 7), _monty(dev, (prog.count, 4), seed + 8)
    acc = _monty(dev, (acc_off + rows * acc_stride, 4), seed + 9)
    before = kernels.QUOTIENT_EVAL.launches
    got = qk.eval_fold(prog, cur, nxt, nshift, sels, sel_off, sel_stride, pis, alpha, acc.clone(), acc_off,
                       acc_stride, add, invz)
    want = qk.eval_fold_plain(prog, cur, nxt, nshift, sels, sel_off, sel_stride, pis, alpha, acc.clone(), acc_off,
                              acc_stride, add, invz)
    torch.cuda.synchronize()
    assert kernels.QUOTIENT_EVAL.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", QUOTIENT_PROGRAMS)
def test_quotient_eval_equals_dag_interpretation(dev, name):
    prog, npis = _quotient_program(name)
    rows, u = 1000, len(prog.cols)
    cur, nxt = _monty(dev, (rows, u), 1), _monty(dev, (rows, u), 2)
    sels = {k: _monty(dev, (rows,), 3 + i) for i, k in enumerate(qk.SELECTORS)}
    pis, alpha = _monty(dev, (npis,), 8), _monty(dev, (prog.count, 4), 9)
    acc = torch.zeros((rows, 4), dtype=torch.int32, device=dev)
    qk.eval_fold(prog, cur, nxt, 0, sels, 0, 1, pis, alpha, acc, 0, 1, False, False)
    host = {k: v.cpu().numpy() for k, v in sels.items()}
    want = interpret(prog.dag, cur.cpu().numpy(), nxt.cpu().numpy(), host, pis.cpu().numpy(), alpha.cpu().numpy())
    assert np.array_equal(acc.cpu().numpy().view(np.uint32), want)


# (n coefficients, u, log_m, r blocks): cosets of r = 1, 2, 4, 8, 16 blocks
# from npan = r or 2 r (zk) runs, on the 16-byte groups (u >= 4, r <= 8)
# and on single words
@pytest.mark.parametrize("n,u,log_m,r", [(64, 3, 6, 1), (4096, 24, 10, 4), (1 << 16, 257, 14, 2),
                                         (1 << 17, 768, 14, 8), (1 << 12, 5, 12, 1), (1 << 14, 320, 13, 2),
                                         (1 << 15, 384, 13, 2), (1 << 16, 768, 14, 4), (1 << 17, 768, 14, 4),
                                         (1 << 16, 257, 14, 4), (1 << 17, 257, 14, 4), (1 << 14, 24, 10, 16),
                                         (1 << 15, 100, 10, 16), (1 << 13, 1, 13, 1), (1 << 14, 24, 13, 1)])
def test_panel_fold_equals_plain(dev, n, u, log_m, r):
    tf = _monty(dev, (n, u), n + u + r)
    shift = 31 * pow(bb.two_adic_generator(20), n + u, bb.P) % bb.P
    before = kernels.PANEL_FOLD.launches
    got = qk.panel_fold(tf, log_m, shift, r)
    want = qk.panel_fold_plain(tf, log_m, shift, r)
    torch.cuda.synchronize()
    assert kernels.PANEL_FOLD.launches == before + 1
    assert got.shape == (r, 1 << log_m, u)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(QUOTIENT_AIRS))
def test_dense_quotient_on_card_equals_cpu(dev, name, monkeypatch):
    """``_quotient_values`` launches K7 (one launch a program) and never the
    plain fold on the card, and equals the CPU pass."""
    from tpu_stark_torch.prover.prove import _quotient_values

    cls, npis = QUOTIENT_AIRS[name]
    air = cls()
    progs = qk.programs(air, npis)
    log_n, log_m = 8, 10
    on_q = _monty(dev, (1 << log_m, air.width), 11)
    pis, apows = _monty(dev, (npis,), 12), _monty(dev, (sum(p.count for p in progs), 4), 13)
    want = _quotient_values(air, on_q.cpu(), pis.cpu(), apows.cpu(), log_n, log_m)
    monkeypatch.setattr(qk, "eval_fold_plain", lambda *a, **k: pytest.fail("the plain fold ran on the card"))
    before = kernels.QUOTIENT_EVAL.launches
    got = _quotient_values(air, on_q, pis, apows, log_n, log_m)
    torch.cuda.synchronize()
    assert kernels.QUOTIENT_EVAL.launches == before + len(progs)
    assert torch.equal(got.cpu(), want)


def test_streamed_quotient_on_card_equals_cpu(dev, monkeypatch):
    """keccak-air's streamed quotient in 16 row blocks a coset on K8 (one
    launch a partition and coset), K2 and K7 equals the CPU pass."""
    from tpu_stark_torch.prover import wide
    from tpu_stark_torch.prover.config import create_config

    def chunks(device):
        trace = keccak_air.generate_trace(3, seed=12, device=device)  # 128 rows
        pcs = create_config(zk=False, hash="poseidon2", device=device).pcs
        domain = pcs.natural_domain_for_degree(int(trace.shape[0]))
        src = wide.WideMatrixSource(trace, pcs.dft, 1, domain)
        apows = _monty(dev, (7241, 4), 4).to(device)
        return wide.quotient_chunks_streamed(keccak_air.KeccakAir(), src, domain, 2, apows, [], 0, 3)[1]

    want = chunks("cpu")
    monkeypatch.setattr(qk, "eval_fold_plain", lambda *a, **k: pytest.fail("the plain fold ran on the card"))
    monkeypatch.setattr(qk, "panel_fold_plain", lambda *a, **k: pytest.fail("the plain panel fold ran on the card"))
    before = (kernels.QUOTIENT_EVAL.launches, kernels.PANEL_FOLD.launches)
    got = chunks(dev)
    torch.cuda.synchronize()
    assert (kernels.QUOTIENT_EVAL.launches - before[0], kernels.PANEL_FOLD.launches - before[1]) == (3072, 192)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# K9-K11: the open phase's PCS arithmetic
# ---------------------------------------------------------------------------
def _ext_point(seed):
    rng = np.random.default_rng(seed)
    return tuple(int(v) for v in rng.integers(0, bb.P, size=4))


# (log_h, row0, rows, operand widths, natural, points, ext sum); at two
# points a lone operand takes one table and scales, a group a plane a point
K9_CARD = [
    (12, 0, 4096, (2,), False, True, False),
    (12, 0, 4096, (64,), True, True, False),
    (11, 0, 2048, (65,), False, False, False),
    (13, 2048, 4096, (3, 1, 493), False, True, False),
    (13, 2048, 4096, (3, 1, 493), True, True, False),
    (10, 96, 200, (7,), False, True, True),
    (10, 0, 1024, (), False, True, True),
    (8, 0, 256, (1,) * 32, False, True, False),
    (9, 0, 512, (1,) * 33 + (2,), False, True, False),
    (10, 256, 512, (3, 4, 1) * 24, True, True, True),
    (9, 0, 512, (2,) * 40, False, False, False),
    (16, 0, 1 << 16, (2,), False, 2, False),
    (16, 1 << 15, 1 << 14, (2,), False, 2, False),
    (12, 0, 4096, (493,), False, 2, False),
    (12, 0, 4096, (64,), True, 2, False),
    (12, 0, 4096, (), False, 2, True),
    (11, 96, 1000, (3, 1, 5, 2), False, 2, True),
    (9, 0, 512, (1,) * 33 + (2,), True, 2, False),
]


@pytest.mark.parametrize("case", K9_CARD, ids=[f"k9-{i}" for i in range(len(K9_CARD))])
def test_reduced_opening_equals_plain(dev, case):
    from tpu_stark_torch.commit import open_kernel as ok

    from tpu_stark_torch.fields import extension as ext4

    log_h, row0, rows, widths, natural, npts, with_ext = case
    n_rows = (1 << log_h) if natural else rows
    mats = [_monty(dev, (n_rows, w + k % 2), 100 + k)[:, : w] for k, w in enumerate(widths)]
    acc = _monty(dev, (rows, 4), 9)
    before = kernels.REDUCED_OPENING.launches
    if npts == 2:  # one launch for both points against two one-point plain calls
        points = [(_ext_point(log_h), _ext_point(rows)), (_ext_point(rows + 1), _ext_point(log_h + 1))]
        if len(widths) == 1 or not widths:
            apows = _monty(dev, (sum(widths), 4), 7)
            ext = _monty(dev, (rows, 4), 8) if with_ext else None
            scales = [(1, 0, 0, 0), _ext_point(5)]
            per_point = [(ext4.mul(apows, ext4.scalar(c, dev)[None]),
                          None if ext is None else ext4.mul(ext, ext4.scalar(c, dev)[None])) for c in scales]
        else:
            apows = _monty(dev, (2, sum(widths), 4), 7)
            ext = _monty(dev, (2, rows, 4), 8) if with_ext else None
            scales = None
            per_point = [(apows[p], None if ext is None else ext[p]) for p in range(2)]
        got = ok.reduced_opening(acc.clone(), mats, apows, log_h, row0, points, natural, ext, scales)
        want = acc.clone()
        for (ap, ex), pt in zip(per_point, points):
            ok.reduced_opening_plain(want, mats, ap, log_h, row0, [pt], natural, ex)
    else:
        apows = _monty(dev, (sum(widths), 4), 7)
        points = [(_ext_point(log_h), _ext_point(rows))] if npts else []
        ext = _monty(dev, (rows, 4), 8) if with_ext else None
        got = ok.reduced_opening(acc.clone(), mats, apows, log_h, row0, points, natural, ext)
        want = ok.reduced_opening_plain(acc.clone(), mats, apows, log_h, row0, points, natural, ext)
    torch.cuda.synchronize()
    assert kernels.REDUCED_OPENING.launches == before + max(1, -(-len(widths) // ok.MAX_OPS))
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w,npts,r0", [(300, 1, 1, 0), (1 << 16, 2, 2, 0), (1 << 14, 7, 2, 37),
                                         (1 << 12, 64, 1, 4096), (700, 65, 2, 5), (1 << 13, 493, 2, 0),
                                         (1 << 25, 2, 2, 0), (1 << 18, 493, 2, 0), (1 << 23, 2, 2, 1 << 23),
                                         (1 << 21, 64, 2, 0), (5000, 1, 2, 77)])
def test_eval_at_points_equals_plain(dev, h, w, npts, r0):
    from tpu_stark_torch.commit import open_kernel as ok

    coeffs = _monty(dev, (h, w + 1), h + w)[:, 1:]
    zs = [_ext_point(h + p) for p in range(npts)]
    before = kernels.EVAL_AT_POINTS.launches
    got = ok.eval_at_points(coeffs, zs, r0)
    want = ok.eval_at_points_plain(coeffs, zs, r0)
    torch.cuda.synchronize()
    assert kernels.EVAL_AT_POINTS.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("log_h,row0,rows,with_add", [(1, 0, None, False), (10, 0, None, True), (16, 0, None, False),
                                                       (12, 64, 1024, True), (14, 4096, 8192, False)])
def test_fri_fold_equals_plain(dev, log_h, row0, rows, with_add):
    from tpu_stark_torch.commit import open_kernel as ok

    n = rows or 1 << log_h
    cw = _monty(dev, (n, 4), log_h)
    add = _monty(dev, (n // 2, 4), row0 + 1) if with_add else None
    beta = _ext_point(log_h + 1)
    before = kernels.FRI_FOLD.launches
    got = ok.fri_fold(cw, beta, log_h, row0, add)
    want = ok.fri_fold_plain(cw, beta, log_h, row0, add)
    torch.cuda.synchronize()
    assert kernels.FRI_FOLD.launches == before + 1
    assert torch.equal(got, want)


def test_open_wrappers_raise_when_the_build_fails(dev, monkeypatch):
    """On a CUDA tensor a failed build raises: no wrapper falls back to its
    plain version."""
    from tpu_stark_torch.commit import open_kernel as ok

    def broken():
        raise RuntimeError("nvcc failed on the kernel sources")

    monkeypatch.setattr(kernels, "lib", broken)
    for name in ("reduced_opening_plain", "eval_at_points_plain", "fri_fold_plain"):
        monkeypatch.setattr(ok, name, lambda *a, **k: pytest.fail("a plain open version ran on the card"))
    m, acc = _monty(dev, (64, 2), 1), torch.zeros((64, 4), dtype=torch.int32, device=dev)
    for call in (lambda: ok.reduced_opening(acc, [m], _monty(dev, (2, 4), 2), 6),
                 lambda: ok.eval_at_points(m, [_ext_point(3)]),
                 lambda: ok.fri_fold(acc, _ext_point(4), 6)):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()


def test_fib_zk_proof_on_card_runs_no_plain_open_step(dev, monkeypatch):
    """A fib zk prove on the card launches K9, K10 and K11 and never a
    plain open version, and gives the JAX prover's bytes."""
    import hashlib

    from tpu_stark_torch.air.fibonacci import fibonacci_value, generate_trace_rows
    from tpu_stark_torch.commit import open_kernel as ok
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.proof import serialize_proof
    from tpu_stark_torch.prover.prove import prove

    want = json.loads((pathlib.Path(__file__).parent / "golden" / "torch_fib_zk_jax_proofs.json").read_text())
    for name in ("reduced_opening_plain", "eval_at_points_plain", "fri_fold_plain"):
        monkeypatch.setattr(ok, name, lambda *a, **k: pytest.fail("a plain open version ran on the card"))
    before = {k.name: k.launches for k in kernels.OPEN_KERNELS}
    n = 1 << 12
    cfg = create_config(zk=True, zk_rng="smallrng", zk_layout="tpu", device=dev)
    blob = serialize_proof(prove(cfg, FibonacciAir(), generate_trace_rows(0, 1, n), [0, 1, fibonacci_value(0, 1, n)]))
    assert (hashlib.sha256(blob).hexdigest(), len(blob)) == (want["tpu_12"]["sha256"], want["tpu_12"]["len"])
    assert all(k.launches > before[k.name] for k in kernels.OPEN_KERNELS)
