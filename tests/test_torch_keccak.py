"""K1 (the Keccak sponge) through its plain torch version, against the JAX
package: ``sponge.hash_field_rows_batched`` / ``compress_digests_batched``
with ``impl="xla"``, the reduced-round Pallas kernel in interpret mode, and
the host scalar oracle.  Digests are u32 words: exact comparison."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_stark.hash import keccak as jkeccak
from tpu_stark.hash import pallas_keccak as jpk
from tpu_stark.hash import sponge as jsponge
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.hash import keccak, keccak_kernel, sponge


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tests here are CPU-bound torch work: two intra-op threads keep
    them off the cores that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _u32(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return bb.to_tensor(x, "cpu")


@pytest.mark.parametrize("k", [1, 6, 8, 16, 33, 34, 35, 40])
def test_leaf_hash_matches_jax(k):
    mat = _u32(k, (37, k))  # ragged N, odd k, multi-chunk rows
    want = np.asarray(jsponge.hash_field_rows_batched(jnp.asarray(mat), impl="xla"))
    got = bb.to_numpy(sponge.hash_field_rows_batched(_t(mat)))
    assert np.array_equal(got, want)


def test_compress_matches_jax_and_split_rows():
    left, right = _u32(1, (19, 4, 2)), _u32(2, (19, 4, 2))
    want = np.asarray(jsponge.compress_digests_batched(jnp.asarray(left), jnp.asarray(right), impl="xla"))
    assert np.array_equal(bb.to_numpy(sponge.compress_digests_batched(_t(left), _t(right))), want)
    # a row split over two inputs hashes as the concatenated row
    rows = np.concatenate([left.reshape(19, 8), right.reshape(19, 8)], axis=1)
    assert np.array_equal(bb.to_numpy(keccak_kernel.hash_rows(_t(rows))), want)
    assert np.array_equal(
        bb.to_numpy(keccak_kernel.hash_rows(_t(rows[:, :3]), _t(rows[:, 3:]))), want
    )


def test_plain_matches_host_oracle():
    mat = _u32(3, (5, 41))
    got = bb.to_numpy(keccak_kernel.hash_rows_plain(_t(mat)))
    for r in range(5):
        want = sponge.hash_field_row([int(v) for v in mat[r]])
        assert tuple(int(got[r, j, 0]) | (int(got[r, j, 1]) << 32) for j in range(4)) == want
        assert want == jsponge.hash_field_row([int(v) for v in mat[r]])


def test_keccak_f_plain_matches_host():
    rng = np.random.default_rng(4)
    states = [[int(v) for v in rng.integers(0, 1 << 63, size=25, dtype=np.int64)] for _ in range(3)]
    states[0][7] |= 1 << 63  # a lane with the top bit set
    lanes = torch.tensor([[v - (1 << 64) if v >= 1 << 63 else v for v in s] for s in states])
    got = keccak_kernel.keccak_f_plain(lanes)
    for i, s in enumerate(states):
        want = keccak.keccak_f(s)
        assert [int(v) & keccak.U64 for v in got[i]] == want
        assert want == jkeccak.keccak_f(s)


def test_pallas_interpret_reduced_rounds_agree_with_host():
    """The JAX kernel K1 replaces, in interpret mode at 2 rounds, against the
    same host oracle the port's plain sponge is held to above."""
    n, k, n_rounds = 128, 6, 2
    mat = _u32(5, (n, k)) % np.uint32(bb.P)
    mat_t, n_items = jpk._pad_transpose(jnp.asarray(mat))
    out = np.asarray(
        jpk.hash_rows_transposed(mat_t, n_items=n_items, interpret=True, n_rounds=n_rounds)
    ).T.reshape(n, 4, 2)
    for r in (0, n - 1):
        items = sponge.pack_u32s_to_u64s([int(v) for v in mat[r]])
        state = [0] * sponge.WIDTH
        for i, v in enumerate(items):
            state[i] = v
        want = keccak.keccak_f(state, n_rounds)[: sponge.OUT]
        assert [int(out[r, j, 0]) | (int(out[r, j, 1]) << 32) for j in range(4)] == list(want)


def test_keccak256_matches_jax():
    for msg in (b"", b"abc", bytes(range(200))):
        assert keccak.keccak256(msg) == jkeccak.keccak256(msg)
        assert keccak._keccak256_py(msg) == keccak.keccak256(msg)


def test_empty_row_is_rejected():
    with pytest.raises(ValueError):
        keccak_kernel.hash_rows(_t(np.zeros((3, 0), dtype=np.uint32)))


@pytest.fixture(scope="module")
def jax_tree():
    """2^10 random digests and the JAX package's 10 compress layers above
    them: the first 2^k digests' layers are the layers' prefixes."""
    digests = _u32(100, (1 << 10, 4, 2))
    layers, d = [], digests
    for l in range(1, 11):  # every layer zero-padded to 2^10 digests: one compiled shape
        pad = np.zeros_like(digests)
        pad[: len(d)] = d
        d = np.asarray(jsponge.compress_digests_batched(jnp.asarray(pad[0::2]), jnp.asarray(pad[1::2]),
                                                        impl="xla"))[: (1 << 10) >> l]
        layers.append(d)
    return digests, layers


@pytest.mark.parametrize("log_n", range(1, 11))
def test_compress_levels_matches_layer_loop_and_jax(log_n, jax_tree):
    """``compress_levels`` on the CPU, every run length from one level to the
    root, against the loop of one ``hash_rows`` a layer and JAX's layers."""
    digests = jax_tree[0][: 1 << log_n]
    want = [layer[: (1 << log_n) >> (l + 1)] for l, layer in enumerate(jax_tree[1][:log_n])]
    loop, d = [], _t(digests)
    for _ in range(log_n):
        d = keccak_kernel.hash_rows(d.reshape(-1, 16))
        loop.append(bb.to_numpy(d))
    for levels in range(1, log_n + 1):
        got = keccak_kernel.compress_levels(_t(digests), levels)
        assert len(got) == levels
        for l, g in enumerate(got):
            assert tuple(g.shape) == ((1 << log_n) >> (l + 1), 4, 2)
            assert np.array_equal(bb.to_numpy(g), want[l]) and np.array_equal(bb.to_numpy(g), loop[l])


def test_compress_levels_rejects_bad_layers():
    with pytest.raises(ValueError):
        keccak_kernel.compress_levels(_t(_u32(1, (6, 4, 2))), 1)  # not a power of two
    with pytest.raises(ValueError):
        keccak_kernel.compress_levels(_t(_u32(1, (8, 4, 2))), 4)  # above the root
    with pytest.raises(ValueError):
        keccak_kernel.compress_levels(_t(_u32(1, (8, 8))), 1)
    assert keccak_kernel.compress_levels(_t(_u32(1, (8, 4, 2))), 0) == []


@pytest.mark.parametrize("log_ns", [range(1, 9), range(9, 17), range(17, 23), range(23, 28)])
def test_tree_plan_covers_every_level(log_ns):
    """Every plan builds exactly the asked levels, bottom first; a block's
    subtree lies inside its layer and within the kernel's shared memory; a
    band keeps at least a warp's 32 nodes a block at its top."""
    for log_n in log_ns:
        for levels in range(log_n + 1):
            plan = keccak_kernel.tree_plan(log_n, levels)
            assert sum(lv for _, lv in plan) == levels
            m = log_n
            for sub, lv in plan:
                assert 1 <= lv <= sub <= min(m, keccak_kernel.MAX_SUB_LOG)
                assert sub == lv or sub - lv >= 5
                m -= lv


def test_tree_plan_launches_of_the_fib_and_config2_trees():
    """The Merkle trees of a fib 2^20 prove (trace 2^23 leaves, quotient
    2^22, FRI 2^23 .. 2^2) and of a config-2 prove (2^22, 2^21, FRI 2^22 ..
    2^1): one leaf launch and a few tree launches each, under 100 a prove
    (one launch a layer took 344 and 320)."""
    fib = [23, 22] + list(range(23, 1, -1))
    config2 = [22, 21] + list(range(22, 0, -1))
    for heights in (fib, config2):
        launches = sum(1 + len(keccak_kernel.tree_plan(h, h)) for h in heights)
        assert launches < 100
        assert all(len(keccak_kernel.tree_plan(h, h)) <= 4 for h in heights)


def _emulated_tree_launch(src, n_in, sub_log, lv, out):
    """The tree kernel's contract in plain torch: levels 1..lv above the n_in
    digests at ``src``, written one layer after another from ``out`` on."""
    assert n_in % (1 << sub_log) == 0 and 1 <= lv <= sub_log
    flat = torch.empty(0, dtype=torch.int32).set_(
        out.untyped_storage(), out.storage_offset(), (n_in - (n_in >> lv),) + tuple(out.shape[1:]))
    got = keccak_kernel.compress_levels_plain(src[:n_in], lv)
    flat.copy_(torch.cat(got))


def _explicit_plans(log_n, levels):
    """tree_plan's launches and others of the same levels: one level a
    launch, and bands of 2 levels whose blocks keep 4 nodes at the top."""
    bands, m, left = [], log_n, levels
    while left:
        lv = min(2, left)
        bands.append((min(lv + 2, m, keccak_kernel.MAX_SUB_LOG), lv))
        m, left = m - lv, left - lv
    return [keccak_kernel.tree_plan(log_n, levels), [(1, 1)] * levels, bands]


@pytest.mark.parametrize("log_n", [1, 5, 8, 11])
def test_run_plan_places_every_layer(log_n, monkeypatch):
    """``run_plan``'s buffer, layer views and launch operands, with each
    launch emulated by the plain version: equal to the layer loop under
    every plan, from a layer with an offset base too."""
    monkeypatch.setattr(keccak_kernel, "_tree_launch", _emulated_tree_launch)
    big = _t(_u32(log_n, ((1 << log_n) + 3, 4, 2)))
    for digests in (big[:-3], big[3:]):
        want = keccak_kernel.compress_levels_plain(digests, log_n)
        for levels in sorted({1, log_n // 2 + 1, log_n}):
            for plan in _explicit_plans(log_n, levels):
                got = keccak_kernel.run_plan(digests, plan)
                assert len(got) == levels
                assert all(torch.equal(g, w) for g, w in zip(got, want))


def _rotl_halves(lo, hi, r, fma):
    """One rotation on u32 halves, emulated in uint64 numpy: for r >= 32
    the halves swap and rotate by r - 32; a half (x << s) | (y >> (32 - s))
    is one funnel shift in csrc/keccak_sponge.cu's ``rotl64``, or, on the
    FMA pipe, hi(y 2^s) + x 2^s (IMAD.HI over IMAD: the two terms share no
    bit), the form the K1 variants measured slower on the card."""
    s = r & 31
    l, h = (lo, hi) if r < 32 else (hi, lo)
    m = np.uint64(1 << s)
    mask = np.uint64(0xFFFFFFFF)
    if fma:
        olo = (((h * m) >> np.uint64(32)) + ((l * m) & mask)) & mask
        ohi = (((l * m) >> np.uint64(32)) + ((h * m) & mask)) & mask
    else:
        olo = (((l << np.uint64(32)) | h) << np.uint64(s) >> np.uint64(32)) & mask
        ohi = (((h << np.uint64(32)) | l) << np.uint64(s) >> np.uint64(32)) & mask
    return olo, ohi


def test_rotation_halves_match_keccak():
    """For every rotation amount 1-63 (32, none of Keccak's, is the swap
    alone), both forms of each half equal ``keccak.py``'s 64-bit rotation,
    on random lanes."""
    lanes = np.random.default_rng(9).integers(0, 1 << 63, size=64, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    lo, hi = lanes & np.uint64(0xFFFFFFFF), lanes >> np.uint64(32)
    for r in range(1, 64):
        want = [keccak._rotl64(int(v), r) for v in lanes]
        for fma in (False, True):
            olo, ohi = _rotl_halves(lo, hi, r, fma)
            assert [int(a) | (int(b) << 32) for a, b in zip(olo, ohi)] == want
