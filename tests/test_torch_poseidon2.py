"""The port's Poseidon2 stack against the JAX package's, on the same inputs
(made with numpy from a seed): round constants, the permutation, the
sponge and compress of kernel K3's plain versions, the Poseidon2 Merkle
MMCS (roots, layers, salts, openings) and the duplex challenger's
transcript.  Exact comparison.  Also the open phase's blocked column
reductions of ``commit/open_kernel.py``: several blocks and column chunks give the
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
from tpu_stark_torch.commit import open_kernel
from tpu_stark_torch.commit import poseidon2_mmcs as tmmcs
from tpu_stark_torch.commit.merkle import BatchOpening
from tpu_stark_torch.compat.smallrng import SmallRng
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.fields import extension as ext4
from tpu_stark_torch.hash import poseidon2 as tp2
from tpu_stark_torch.hash import poseidon2_kernel


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tests here are CPU-bound torch work: two intra-op threads keep
    them off the cores that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


def _diag_list():
    """The kernel's internal-diagonal list: {lane: (sign, mul, shift)}."""
    text = SRC.read_text()
    block = text[text.index("BEGIN POSEIDON2 DIAGONAL") : text.index("END POSEIDON2 DIAGONAL")]
    return {int(i): (int(sg), int(m), int(sh))
            for i, sg, m, sh in re.findall(r"X\((\d+), (-?\d+), (\d+), (\d+)\)", block)}


def test_cuda_constant_table_matches_consts_monty():
    """The kernel's round constants (Monty forms) are ``consts_monty(16)``,
    its internal-diagonal list (sign * mul * 2^-shift, one entry a lane) is
    ``internal_diag(16)``, and its reduction constant is P^-1 mod 2^32."""
    text = SRC.read_text()
    table = text[text.index("BEGIN POSEIDON2 CONSTANTS") : text.index("END POSEIDON2 CONSTANTS")]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", table)]
    ext, internal, _ = tp2.consts_monty(16)
    assert words == [int(v) for v in np.concatenate([ext.reshape(-1), internal])]
    diag = _diag_list()
    assert sorted(diag) == list(range(16))
    for i, d in enumerate(tp2.internal_diag(16)):
        sign, mul, shift = diag[i]
        assert (sign * mul * pow(2, -shift, P)) % P == d, i
    header = (SRC.parent / "babybear.cuh").read_text()
    mu = int(re.search(r"MU = 0x([0-9a-f]{8})u", header).group(1), 16)
    assert mu == MU and (mu * P) % (1 << 32) == 1
    # lane 0 alone has d = -2, formed as the sum of the other lanes less x
    assert [i for i, e in diag.items() if e == (-1, 2, 0)] == [0]


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
# K3/K4's arithmetic (csrc/poseidon2_sponge.cu), emulated in torch int64
# (every value a u32, every product below 2^63); each identity against the
# full Montgomery product, each stated bound asserted.
# ---------------------------------------------------------------------------
P = bb.P
M32 = (1 << 32) - 1
MU = pow(P, -1, 1 << 32)
T_MAX = (1 << 32) * ((1 << 32) - P)  # mul's domain: hi(t) - hi(m P) + P < 2^32


def _i64(values):
    return torch.tensor([int(v) for v in values], dtype=torch.int64)


def _red(x):
    """min(x, x - P) on u32: [0, 2P) -> [0, P)."""
    assert int(x.min()) >= 0 and int(x.max()) <= M32
    return torch.minimum(x, (x - P) & M32)


def _add(a, b):
    assert int(torch.maximum(a, b).max()) < P
    return _red(a + b)


def _sub(a, b):
    assert int(torch.maximum(a, b).max()) < P
    d = (a - b) & M32
    return torch.minimum(d, (d + P) & M32)


def _lazy(t):
    """hi(t) - hi(m P) + P with m = lo(t) P^-1 mod 2^32, for 0 <= t < T_MAX."""
    assert int(t.min()) >= 0 and int(t.max()) < min(T_MAX, 1 << 63)
    m = ((t & M32) * MU) & M32
    mp = m * P
    assert torch.equal(t & M32, mp & M32)  # t - m P is a multiple of 2^32
    r = (t >> 32) - (mp >> 32) + P
    assert int(r.min()) >= 0 and int(r.max()) <= M32
    return r


def _monty_mul(a, b):
    """The full Montgomery product a b 2^-32 mod P, canonical."""
    return bb.mul(a.to(torch.int32), b.to(torch.int32)).to(torch.int64) & M32


def _sbox(y):
    assert int(y.max()) < P
    x2 = _lazy(y * y)
    assert int(x2.max()) < 1.47 * P
    x2 = _red(x2)
    x4 = _lazy(x2 * x2)
    assert int(x4.max()) < 1.47 * P
    x6 = _lazy(x4 * x2)
    assert int(x6.max()) < 1.69 * P
    x7 = _lazy(x6 * y)
    assert int(x7.max()) < 1.80 * P
    return _red(x7)


def _m4(x0, x1, x2, x3):
    dbl = lambda v: _add(v, v)  # noqa: E731
    t0, t1 = _add(x0, x1), _add(x2, x3)
    t2, t3 = _add(dbl(x1), t1), _add(dbl(x3), t0)
    t4, t5 = _add(dbl(dbl(t1)), t3), _add(dbl(dbl(t0)), t2)
    return _add(t3, t5), t5, _add(t2, t4), t4


def _external_mds(s):
    blocks = [list(_m4(*(s[..., 4 * b + j] for j in range(4)))) for b in range(4)]
    for j in range(4):
        col = _add(_add(blocks[0][j], blocks[1][j]), _add(blocks[2][j], blocks[3][j]))
        for b in range(4):
            blocks[b][j] = _add(blocks[b][j], col)
    return torch.stack([blocks[b][j] for b in range(4) for j in range(4)], -1)


def _diag_lane(lane, sign, mul, shift, total, sp, x):
    """The kernel's diag_lane: total + sign mul 2^-shift x, in [0, P)
    (lane 0: sp - x)."""
    if lane == 0:
        return _sub(sp, x)
    if shift == 0:
        v = {1: lambda: x, 2: lambda: _add(x, x), 3: lambda: _add(_add(x, x), x),
             4: lambda: _add(_add(x, x), _add(x, x))}[mul]()
    elif shift == 1:
        v = (x + (x & 1) * P) >> 1
        assert int(v.max()) < P
    else:
        q, t = x >> shift, (x & ((1 << shift) - 1)) * (15 << (27 - shift))
        assert int(q.max()) < 1 << (31 - shift) and int(t.max()) < P
        if sign > 0 and shift >= 4:
            w = total + P + q - t
            assert int(w.min()) > 0 and int(w.max()) < 2 * P + (1 << (31 - shift)) <= M32
            return _red(_red(w))
        d = (q - t) if sign > 0 else (t - q)
        return _add(total, torch.minimum(d & M32, (d + P) & M32))
    return _add(total, v) if sign > 0 else _sub(total, v)


def _internal_round(s, rc):
    s = s.clone()
    s[..., 0] = _sbox(_add(s[..., 0], torch.full_like(s[..., 0], int(rc))))
    sp = s[..., 1]
    for i in range(2, 16):
        sp = _add(sp, s[..., i])
    total = _add(sp, s[..., 0])
    diag = _diag_list()
    return torch.stack([_diag_lane(i, *diag[i], total, sp, s[..., i]) for i in range(16)], -1)


def _permute_device(s):
    ext_np, int_np, _ = tp2.consts_monty(16)
    s = _external_mds(s)
    for r in range(8):
        if r == 4:
            for c in int_np:
                s = _internal_round(s, c)
        s = _external_mds(_sbox(_add(s, _i64(ext_np[r]).expand_as(s))))
    return s


EDGES = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, (P + 1) // 2, 1 << 27, 2 << 27, 3 << 27, 14 << 27, (1 << 31) - 1 - P]


def _edge_and_random(n=4000, seed=21):
    rng = np.random.default_rng(seed)
    return _i64(EDGES + [int(v) for v in rng.integers(0, P, size=n)])


def test_red_add_and_lazy_product_match_the_full_product():
    x = _edge_and_random()
    y = x.roll(7)
    assert torch.equal(_red(x + P), x) and torch.equal(_red(x), x)
    assert torch.equal(_add(x, y), (x + y) % P) and torch.equal(_sub(x, y), (x - y) % P)
    # a product of residues: the Montgomery product, below 2P
    r = _lazy(x * y)
    assert int(r.max()) < 2 * P and torch.equal(r % P, _monty_mul(x, y))
    # at the stated headroom: t up to P 2^32 - 1 gives [0, 2P); up to T_MAX - 1 a u32
    rng = np.random.default_rng(3)
    tops = [P * (1 << 32) - 1 - int(v) for v in rng.integers(0, 1 << 40, size=500)] + [P * (1 << 32) - 1]
    r = _lazy(_i64(tops))
    assert int(r.max()) < 2 * P
    assert [int(v) for v in r % P] == [v * pow(1 << 32, -1, P) % P for v in tops]
    wide = [min(T_MAX, 1 << 63) - 1 - int(v) for v in rng.integers(0, 1 << 40, size=200)]
    r = _lazy(_i64(wide))
    assert [int(v) for v in r % P] == [v * pow(1 << 32, -1, P) % P for v in wide]


def test_sbox_chain_matches_the_full_product():
    y = _edge_and_random()
    x2 = _monty_mul(y, y)
    x4 = _monty_mul(x2, x2)
    assert torch.equal(_sbox(y), _monty_mul(_monty_mul(x4, x2), y))


def test_internal_diagonal_forms_match_the_full_product():
    """Each lane of the internal layer as the kernel forms it, total + d_i x
    by shifts and additions (lane 0: the sum of the other lanes less x),
    against the full Montgomery product by Monty(d_i) and a modular add."""
    _, _, diag_np = tp2.consts_monty(16)
    x = _edge_and_random(n=3000)
    others = x.roll(11)
    total = _add(others, x)  # lane 0's sum includes x
    for i, (sign, mul, shift) in sorted(_diag_list().items()):
        d = _i64([int(diag_np[i])]).expand_as(x)
        if i == 0:
            got, want = _diag_lane(i, sign, mul, shift, total, others, x), (_monty_mul(x, d) + total) % P
        else:
            got, want = _diag_lane(i, sign, mul, shift, others, None, x), (_monty_mul(x, d) + others) % P
        assert torch.equal(got, want), i


def test_device_permutation_emulation_equals_permute_plain():
    rng = np.random.default_rng(9)
    state = rng.integers(0, P, size=(64, 16), dtype=np.uint32)
    state[0], state[1], state[2] = 0, P - 1, np.array(EDGES + [1, 2, 3, 4])[:16]
    got = _permute_device(torch.from_numpy(state.astype(np.int64)))
    want = tp2.permute_plain(bb.to_tensor(state, "cpu")).to(torch.int64) & M32
    assert torch.equal(got, want)


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


@pytest.mark.parametrize("hiding", [False, True])
def test_mmcs_open_batch_matches_jax(hiding, jit_permutation):
    """``open_batch(index, data)``, reached through ``Poseidon2Mmcs``, equals
    JAX's at every index."""
    jm, tm, (jroot, jdata), (troot, tdata) = _commit_both(hiding, 6)
    for i in range(16):
        to, jo = tm.open_batch(i, tdata), jm.open_batch(i, jdata)
        assert to.proof == jo.proof
        for a, b in zip(to.opened_values, jo.opened_values):
            assert np.array_equal(a, np.asarray(b))
        if hiding:
            for a, b in zip(to.opened_salts, jo.opened_salts):
                assert np.array_equal(a, np.asarray(b))
        assert tm.verify_batch(troot, SHAPES, i, to)


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
# open_kernel: the open phase's plain column reductions, bounded by rows x columns
# ---------------------------------------------------------------------------
def _reductions(h, w, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: bb.to_tensor(a, "cpu")  # noqa: E731
    mat = t(rng.integers(0, bb.P, size=(h, w), dtype=np.uint32))
    apows = t(rng.integers(0, bb.P, size=(w, 4), dtype=np.uint32))
    zpow = t(rng.integers(0, bb.P, size=(h, 4), dtype=np.uint32))
    point = [tuple(tuple(int(v) for v in rng.integers(0, bb.P, size=4)) for _ in range(2))]  # z, the opened sum
    return (
        open_kernel._eval_at_point(mat, zpow),
        open_kernel._combine_columns(mat, apows),
        open_kernel.reduced_opening_plain(torch.zeros((h, 4), dtype=torch.int32), [mat], apows, h.bit_length() - 1, 0,
                                          point),
    )


def test_blocked_column_reductions_equal_one_block(monkeypatch):
    h, w = 64, 500
    monkeypatch.setattr(open_kernel, "_COL_CHUNK", 1 << 20)
    monkeypatch.setattr(open_kernel, "_ELEM_BUDGET", 1 << 30)
    assert open_kernel._block_plan(h, w) == (h, w)
    one = _reductions(h, w, 5)
    # 7 column chunks (the last one ragged) by 4 row blocks (the last one ragged)
    monkeypatch.setattr(open_kernel, "_COL_CHUNK", 77)
    monkeypatch.setattr(open_kernel, "_ELEM_BUDGET", 4 * 77 * 17)
    assert open_kernel._block_plan(h, w) == (17, 77)
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
        rows, cols = open_kernel._block_plan(h, w)
        assert rows * cols * 4 * 8 < 2 << 30
        assert 1 <= rows <= h and 1 <= cols <= w
    assert open_kernel._block_plan(1 << 20, 493)[1] < 493  # the columns really chunk
