"""K1's carried-state absorb (``keccak_kernel.absorb_rows`` /
``finalize_rows``), the port's ``KeccakRowStream``, the device rng's lazy
samples and the verifier's one-index bit reversal, against the JAX package
on the same inputs made with numpy from a seed.  Exact comparison; the
kernel runs its plain torch version here.

* the absorb and its finalize over column chunks equal the one-shot
  ``hash_rows_plain`` and JAX's ``hash_field_rows_batched(..., impl="xla")``;
* the port's ``KeccakRowStream`` carries the same state and pending words
  as JAX's after every ``absorb_cols`` (``compat.from_jax.
  keccak_stream_from_jax``), and the same digests;
* ``DeviceRng.sample_lazy`` advances the counter as a sample does, and its
  ``materialize()`` gives the sample's bits and JAX's ``LazyMatrix``'s;
* ``commit/pcs.py::_plain_point_at`` reverses one index without a table.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_stark.compat.device_rng import DeviceRng as JRng
from tpu_stark.hash import sponge as jsponge
from tpu_stark_torch.commit import pcs
from tpu_stark_torch.compat import device_rng as drng
from tpu_stark_torch.compat.device_rng import DeviceRng
from tpu_stark_torch.compat.from_jax import keccak_stream_from_jax
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.hash import keccak_kernel as kk
from tpu_stark_torch.hash.sponge import KeccakRowStream
from tpu_stark_torch.matrix import bit_reversal_perm

# (rows, chunk widths): tests/test_wide_prove.py's ragged and odd widths, and
# one chunking of widths 1, 33, 34, 35, 68 and a chunk that leaves 0 pending
CHUNKINGS = [(16, (7, 30, 34, 10)), (9, (1, 33, 34, 35, 68, 35))]


def _u32(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _jax_digests(mat: np.ndarray) -> np.ndarray:
    return np.asarray(jsponge.hash_field_rows_batched(jnp.asarray(mat), impl="xla"))


@pytest.mark.parametrize("n,chunking", CHUNKINGS)
def test_absorb_and_finalize_plain_match_one_shot_and_jax(n, chunking):
    """Whole blocks through ``absorb_rows`` (pending words read beside the
    chunk), the tail through ``finalize_rows``."""
    mat = _u32(sum(chunking), (n, sum(chunking)))
    t = _t(mat)
    state = torch.full((50, n), 7, dtype=torch.int32)  # overwritten: first
    first, pend, off = True, None, 0
    for wc in chunking:
        chunk = t[:, off : off + wc]
        off += wc
        p = 0 if pend is None else int(pend.shape[1])
        blocks = (p + wc) // kk.BLOCK_WORDS
        take = blocks * kk.BLOCK_WORDS - p
        if blocks == 0:
            pend = chunk if pend is None else torch.cat([pend, chunk], dim=1)
            continue
        assert kk.absorb_rows(state, chunk[:, :take], first=first, pend=pend) is state  # in place
        first, pend = False, (chunk[:, take:] if take < wc else None)
    got = kk.finalize_rows(state, pend)
    assert torch.equal(got, kk.hash_rows_plain(t))
    assert np.array_equal(got.numpy().view(np.uint32), _jax_digests(mat))


def test_absorb_continues_a_carried_state_and_finalize_leaves_it():
    n = 12
    start = _t(_u32(1, (50, n)))
    mat = _t(_u32(2, (n, 68 + 5)))
    want = kk.absorb_rows_plain(start.clone(), mat[:, :68])
    state = start.clone()
    kk.absorb_rows(state, mat[:, :34])
    kk.absorb_rows(state, mat[:, 51:68], pend=mat[:, 34:51])  # strided operands: 17 + 17 words
    assert torch.equal(state, want)
    before = state.clone()
    digest = kk.finalize_rows(state, mat[:, 68:73])
    assert torch.equal(state, before)
    assert torch.equal(digest, kk.finalize_rows_plain(want, mat[:, 68:73]))
    assert torch.equal(kk.finalize_rows(state, None), kk.finalize_rows_plain(want, mat[:, :0]))
    start_rows = kk.absorb_rows_plain(torch.empty_like(start), mat[:, :68], first=True)
    assert torch.equal(kk.finalize_rows(start_rows, mat[:, 68:73]), kk.hash_rows_plain(mat))


def test_absorb_rejects_partial_blocks_and_bad_states():
    state = torch.zeros((50, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="whole rate blocks"):
        kk.absorb_rows(state, torch.zeros((4, 33), dtype=torch.int32))
    with pytest.raises(ValueError, match="whole rate blocks"):
        kk.absorb_rows(state, torch.zeros((4, 0), dtype=torch.int32), pend=torch.zeros((4, 34), dtype=torch.int32))
    with pytest.raises(ValueError, match="partial block"):
        kk.finalize_rows(state, torch.zeros((4, 34), dtype=torch.int32))
    with pytest.raises(ValueError, match="empty sponge input"):
        kk.finalize_rows(state, None, first=True)
    with pytest.raises(ValueError, match=r"\(50, N\)"):
        kk.absorb_rows(torch.zeros((4, 50), dtype=torch.int32), torch.zeros((4, 34), dtype=torch.int32))


def _jax_carry(jstream):
    lanes = [(np.asarray(lo), np.asarray(hi)) for lo, hi in jstream._state]
    pend = [(np.asarray(lo), np.asarray(hi)) for lo, hi in jstream._pend]
    half = None if jstream._half is None else np.asarray(jstream._half)
    return keccak_stream_from_jax(lanes, pend, half, device="cpu")


@pytest.mark.parametrize("n,chunking", CHUNKINGS)
def test_keccak_row_stream_matches_jax_after_every_chunk(n, chunking):
    mat = _u32(100 + n, (n, sum(chunking)))
    stream, jstream = KeccakRowStream(n, "cpu"), jsponge.KeccakRowStream(n)
    off = 0
    for wc in chunking:
        stream.absorb_cols(_t(mat[:, off : off + wc]))
        jstream.absorb_cols(jnp.asarray(mat[:, off : off + wc]))
        off += wc
        want_state, want_pend = _jax_carry(jstream)
        assert torch.equal(stream._state, want_state)
        if want_pend is None:
            assert stream._pend is None
        else:
            assert torch.equal(stream._pend, want_pend)
    got = stream.finalize()
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(jstream.finalize()))
    assert torch.equal(got, kk.hash_rows_plain(_t(mat)))


def test_keccak_row_stream_of_short_rows():
    """Rows shorter than a block never reach ``absorb_rows``."""
    mat = _u32(5, (6, 9))
    stream = KeccakRowStream(6, "cpu")
    stream.absorb_cols(_t(mat[:, :4]))
    stream.absorb_cols(_t(mat[:, 4:]))
    assert stream._first
    assert torch.equal(stream.finalize(), kk.hash_rows_plain(_t(mat)))
    with pytest.raises(ValueError, match="empty sponge input"):
        KeccakRowStream(6, "cpu").finalize()


@pytest.mark.parametrize("seed,stream", [(1, "salts"), (7, "trace"), (3, "")])
def test_sample_lazy_matches_sample_and_jax(seed, stream):
    lazy_rng, dense_rng, jrng = DeviceRng(seed, stream, "cpu"), DeviceRng(seed, stream, "cpu"), JRng(seed, stream)
    for rows, cols in [(8, 4), (33, 3), (1, 1), (257, 4)]:
        handle = lazy_rng.sample_lazy(rows, cols)
        jhandle = jrng.sample_lazy(rows, cols)
        assert handle.shape == (rows, cols) == jhandle.shape
        dense = dense_rng.sample_babybear_matrix_monty(rows, cols)
        assert lazy_rng._counter == dense_rng._counter == jrng._counter
        got = handle.materialize()
        assert torch.equal(got, dense) and torch.equal(handle.materialize(), got)
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(jhandle.materialize()))


def test_sample_columns_equal_the_whole_sample():
    """Drawing only some columns of a sample gives those columns' bits."""
    k = drng.fold_in(drng.key(5), 3)
    whole = drng._sample_monty(k, 40, 16, "cpu")
    sel = np.array([15, 0, 7, 7, 3])
    assert torch.equal(drng._sample_monty(k, 40, 16, "cpu", sel), whole[:, torch.as_tensor(sel)])


def test_plain_point_at_reverses_without_a_table():
    rng = np.random.default_rng(11)
    for log_h in range(1, 21):
        perm = bit_reversal_perm(log_h)
        g = bb.two_adic_generator(log_h)
        for i in rng.integers(0, 1 << log_h, size=8):
            assert pcs._bit_reverse(int(i), log_h) == int(perm[i])
            assert pcs._plain_point_at(log_h, int(i)) == pow(g, int(perm[i]), bb.P)
    assert pcs._plain_point_at(0, 0) == 1
