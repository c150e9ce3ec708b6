"""The port's Poseidon2 stack against the JAX package's, on the same inputs
(made with numpy from a seed): round constants, the permutation, the
sponge and compress of kernel K3's plain versions, the Poseidon2 Merkle
MMCS (roots, layers, salts, openings) and the duplex challenger's
transcript.  Exact comparison.  Also the open phase's blocked column
reductions of ``commit/pcs.py``: several blocks and column chunks give the
bits of one block, and the block plan bounds the intermediates at the
Poseidon2 chain's trace size."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_stark.commit import poseidon2_mmcs as jmmcs
from tpu_stark.compat.smallrng import SmallRng as JRng
from tpu_stark.hash import poseidon2 as jp2
from tpu_stark_torch import kernels
from tpu_stark_torch.commit import pcs
from tpu_stark_torch.commit import poseidon2_mmcs as tmmcs
from tpu_stark_torch.commit.merkle import BatchOpening
from tpu_stark_torch.compat.smallrng import SmallRng
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.fields import extension as ext4
from tpu_stark_torch.hash import poseidon2 as tp2
from tpu_stark_torch.hash import poseidon2_kernel

SRC = pathlib.Path(__file__).resolve().parents[1] / "tpu_stark_torch" / "csrc" / "poseidon2_sponge.cu"


def _monty(seed, shape):
    return np.random.default_rng(seed).integers(0, bb.P, size=shape, dtype=np.uint32)


# ---------------------------------------------------------------------------
# Constants and the permutation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", [16, 24])
def test_constants_match_jax(width):
    assert tp2.round_constants(width) == jp2.round_constants(width)
    assert tp2.internal_diag(width) == jp2.internal_diag(width)
    for a, b in zip(tp2.consts_monty(width), jp2._consts_monty(width)):
        assert np.array_equal(a, b)


def test_cuda_constant_table_matches_consts_monty():
    text = SRC.read_text()
    table = text[text.index("BEGIN POSEIDON2 CONSTANTS") : text.index("END POSEIDON2 CONSTANTS")]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", table)]
    ext, internal, diag = tp2.consts_monty(16)
    assert words == [int(v) for v in np.concatenate([ext.reshape(-1), internal, diag])]


@pytest.mark.parametrize("width", [16, 24])
def test_permute_plain_matches_jax(width):
    state = _monty(width, (5, width))
    got = bb.to_numpy(tp2.permute_plain(bb.to_tensor(state, "cpu")))
    assert np.array_equal(got, np.asarray(jp2.permute_batched(jnp.asarray(state))))
    # and the host permutation, row by row, in canonical form
    canon = bb.np_from_monty(state)
    for row, out in zip(canon, bb.np_from_monty(got)):
        host = tp2.permute_host([int(v) for v in row])
        assert host == jp2.permute_host([int(v) for v in row])
        assert host == [int(v) for v in out]


def test_permute_plain_batches_leading_axes():
    state = bb.to_tensor(_monty(7, (2, 3, 16)), "cpu")
    flat = tp2.permute_plain(state.reshape(6, 16))
    assert torch.equal(tp2.permute_plain(state).reshape(6, 16), flat)


# ---------------------------------------------------------------------------
# K3's plain versions against the JAX batched sponge and compress
# ---------------------------------------------------------------------------
@pytest.fixture
def jit_permutation(monkeypatch):
    """The JAX sponge runs its real chunk loop with its real permutation,
    compiled once instead of retraced per chunk (62 eager retraces at
    k = 493 take most of a minute on the CPU)."""
    import jax

    monkeypatch.setattr(jp2, "permute_batched", jax.jit(jp2.permute_batched))


@pytest.mark.parametrize("k", [1, 7, 8, 9, 16, 493])
def test_hash_rows_plain_matches_jax(k, jit_permutation):
    mat = _monty(100 + k, (6, k))
    got = poseidon2_kernel.hash_rows_plain(bb.to_tensor(mat, "cpu"))
    want = np.asarray(jmmcs.hash_rows_batched(jnp.asarray(mat)))
    assert np.array_equal(bb.to_numpy(got), want)
    # two operands hash as their concatenation (a salted leaf: row || salt)
    if k > 1:
        t = bb.to_tensor(mat, "cpu")
        assert torch.equal(poseidon2_kernel.hash_rows_plain(t[:, : k // 2], t[:, k // 2 :]), got)
    # the host sponge gives the canonical digest of the same row
    row = [int(v) for v in bb.np_from_monty(mat[0])]
    assert tmmcs.hash_row_host(row) == tuple(int(v) for v in bb.np_from_monty(want[0]))


def test_compress_plain_matches_jax(jit_permutation):
    left, right = _monty(1, (9, 8)), _monty(2, (9, 8))
    got = poseidon2_kernel.compress_plain(bb.to_tensor(left, "cpu"), bb.to_tensor(right, "cpu"))
    want = np.asarray(jmmcs.compress_batched(jnp.asarray(left), jnp.asarray(right)))
    assert np.array_equal(bb.to_numpy(got), want)
    lc, rc = bb.np_from_monty(left[3]), bb.np_from_monty(right[3])
    assert tmmcs.compress_host(lc, rc) == tuple(int(v) for v in bb.np_from_monty(want[3]))


def test_wrappers_run_plain_on_cpu_only():
    a = bb.to_tensor(_monty(3, (4, 11)), "cpu")
    before = kernels.POSEIDON2_SPONGE.launches
    assert torch.equal(poseidon2_kernel.hash_rows(a), poseidon2_kernel.hash_rows_plain(a))
    d = a[:, :8]
    assert torch.equal(poseidon2_kernel.compress(d, d), poseidon2_kernel.compress_plain(d, d))
    assert kernels.POSEIDON2_SPONGE.launches == before  # the plain path is not a launch
    with pytest.raises(ValueError, match="unsupported device"):
        poseidon2_kernel.hash_rows(torch.empty((4, 11), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="8"):
        poseidon2_kernel.compress(a, a)


# ---------------------------------------------------------------------------
# The Merkle MMCS
# ---------------------------------------------------------------------------
SHAPES = [(16, 3), (8, 2), (16, 9), (4, 5)]  # two injected heights


def _commit_both(hiding, seed):
    mats = [_monty(seed * 10 + i, s) for i, s in enumerate(SHAPES)]
    jm = jmmcs.Poseidon2Mmcs(hiding=hiding, rng=JRng.seed_from_u64(seed))
    tm = tmmcs.Poseidon2Mmcs(hiding=hiding, rng=SmallRng.seed_from_u64(seed))
    jroot, jdata = jm.commit([jnp.asarray(m) for m in mats])
    troot, tdata = tm.commit([bb.to_tensor(m, "cpu") for m in mats])
    return jm, tm, (jroot, jdata), (troot, tdata)


@pytest.mark.parametrize("hiding", [False, True])
def test_mmcs_commit_matches_jax(hiding, jit_permutation):
    jm, tm, (jroot, jdata), (troot, tdata) = _commit_both(hiding, 3)
    assert troot == jroot and len(troot) == 8
    assert len(tdata.layers) == len(jdata.layers)
    for tl, jl in zip(tdata.layers, jdata.layers):
        assert np.array_equal(bb.to_numpy(tl), np.asarray(jl))  # Monty (N, 8)
    if hiding:
        for ts, js in zip(tdata.salts, jdata.salts):
            assert np.array_equal(bb.to_numpy(ts), np.asarray(js))
        assert tm._rng.s == jm._rng.s
    else:
        assert tdata.salts is None


@pytest.mark.parametrize("hiding", [False, True])
def test_mmcs_openings_match_jax_and_verify(hiding, jit_permutation):
    jm, tm, (jroot, jdata), (troot, tdata) = _commit_both(hiding, 4)
    idx = [0, 5, 15, 6]
    for to, jo, i in zip(tm.open_batch_many(idx, tdata), jm.open_batch_many(idx, jdata), idx):
        assert to.proof == jo.proof  # canonical sibling digests
        for a, b in zip(to.opened_values, jo.opened_values):
            assert np.array_equal(a, np.asarray(b))
        if hiding:
            for a, b in zip(to.opened_salts, jo.opened_salts):
                assert np.array_equal(a, np.asarray(b))
        assert tm.verify_batch(troot, SHAPES, i, to)
        assert jm.verify_batch(jroot, SHAPES, i, to)
        assert not tm.verify_batch(troot, SHAPES, i ^ 1, to)
        bad = [v.copy() for v in to.opened_values]
        bad[2][4] = (int(bad[2][4]) + 1) % bb.P
        assert not tm.verify_batch(troot, SHAPES, i, BatchOpening(bad, to.opened_salts, to.proof))
        path = list(to.proof)
        path[1] = (path[1][0] ^ 1,) + tuple(path[1][1:])
        assert not tm.verify_batch(troot, SHAPES, i, BatchOpening(to.opened_values, to.opened_salts, path))


def test_single_row_tree():
    m = np.arange(3, dtype=np.uint32)[None, :]
    troot, tdata = tmmcs.Poseidon2Mmcs().commit([bb.to_tensor(m, "cpu")])
    jroot, _ = jmmcs.Poseidon2Mmcs().commit([jnp.asarray(m)])
    assert troot == jroot and len(tdata.layers) == 1


# ---------------------------------------------------------------------------
# The duplex challenger
# ---------------------------------------------------------------------------
def test_duplex_challenger_transcript_matches_jax():
    rng = np.random.default_rng(11)
    tc, jc = tmmcs.DuplexChallenger(), jmmcs.DuplexChallenger()
    got, want = [], []
    for step in range(6):
        vals = [int(v) for v in rng.integers(0, 1 << 32, size=int(rng.integers(1, 13)), dtype=np.uint64)]
        digest = [int(v) for v in rng.integers(0, bb.P, size=8)]
        for c, out in ((tc, got), (jc, want)):
            c.observe_u32s(vals)
            out.append(c.sample_ext())
            c.observe_commitment(digest)
            out.append(c.sample_bits(10 + step))
            out.append(c.grind(1 + step % 3))
            out.append(c.sample_u32())
    assert got == want
    assert tc.state == jc.state


# ---------------------------------------------------------------------------
# pcs: the open phase's column reductions, bounded by rows x columns
# ---------------------------------------------------------------------------
def _reductions(h, w, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: bb.to_tensor(a, "cpu")  # noqa: E731
    mat = t(rng.integers(0, bb.P, size=(h, w), dtype=np.uint32))
    apows = t(rng.integers(0, bb.P, size=(w, 4), dtype=np.uint32))
    zpow = t(rng.integers(0, bb.P, size=(h, 4), dtype=np.uint32))
    p_z = t(rng.integers(0, bb.P, size=(w, 4), dtype=np.uint32))
    z = t(rng.integers(0, bb.P, size=(4,), dtype=np.uint32))
    y = t(rng.integers(0, bb.P, size=(h,), dtype=np.uint32))
    return (
        pcs._eval_at_point(mat, zpow),
        pcs._combine_columns(mat, apows),
        pcs._reduced_quotient(mat, apows, p_z, z, y),
    )


def test_blocked_column_reductions_equal_one_block(monkeypatch):
    h, w = 64, 500
    monkeypatch.setattr(pcs, "_COL_CHUNK", 1 << 20)
    monkeypatch.setattr(pcs, "_ELEM_BUDGET", 1 << 30)
    assert pcs._block_plan(h, w) == (h, w)
    one = _reductions(h, w, 5)
    # 7 column chunks (the last one ragged) by 4 row blocks (the last one ragged)
    monkeypatch.setattr(pcs, "_COL_CHUNK", 77)
    monkeypatch.setattr(pcs, "_ELEM_BUDGET", 4 * 77 * 17)
    assert pcs._block_plan(h, w) == (17, 77)
    many = _reductions(h, w, 5)
    for a, b in zip(one, many):
        assert torch.equal(a, b)
    # row 3 of the combination, summed directly
    rng = np.random.default_rng(5)
    mat = bb.to_tensor(rng.integers(0, bb.P, size=(h, w), dtype=np.uint32), "cpu")
    apows = bb.to_tensor(rng.integers(0, bb.P, size=(w, 4), dtype=np.uint32), "cpu")
    want = ext4.mul_base(apows, mat[3]).to(torch.int64).sum(0) % bb.P
    assert torch.equal(many[1][3], want.to(torch.int32))


def test_block_plan_bounds_intermediates_at_chain_size():
    """The chain's trace round reduces (2^20, 493) codewords: one block's
    (rows, cols, 4) int64 intermediate stays far below the card's memory
    (one (2^20, 493, 4) int64 block would be 16.5 GB)."""
    for h, w in [(1 << 20, 493), (1 << 18, 493), (1 << 23, 2), (1 << 20, 8)]:
        rows, cols = pcs._block_plan(h, w)
        assert rows * cols * 4 * 8 < 2 << 30
        assert 1 <= rows <= h and 1 <= cols <= w
    assert pcs._block_plan(1 << 20, 493)[1] < 493  # the columns really chunk
