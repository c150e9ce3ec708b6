"""K1 (the Keccak sponge) through its plain torch version, against the JAX
package: ``sponge.hash_field_rows_batched`` / ``compress_digests_batched``
with ``impl="xla"``, the reduced-round Pallas kernel in interpret mode, and
the host scalar oracle.  Digests are u32 words: exact comparison."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_stark.hash import keccak as jkeccak
from tpu_stark.hash import pallas_keccak as jpk
from tpu_stark.hash import sponge as jsponge
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.hash import keccak, keccak_kernel, sponge


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
    import torch

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
