"""K1's carried-state absorb (``keccak_kernel.absorb_rows`` /
``finalize_rows``), the port's ``KeccakRowStream``, the device rng's lazy
samples and the verifier's one-index bit reversal, against the JAX package
on the same inputs made with numpy from a seed.  Exact comparison; the
kernel runs its plain torch version here.

* the absorb and its finalize over column chunks equal the one-shot
  ``hash_rows_plain`` and JAX's ``hash_field_rows_batched(..., impl="xla")``;
* the port's ``KeccakRowStream`` carries the same state and pending words
  as JAX's after every ``absorb_cols`` (``compat.from_jax.
  keccak_stream_from_jax``), and the same digests; so does its
  ``absorb_monty`` of Montgomery codeword chunks in natural or the tree's
  row order against JAX's stream fed the canonical bit-reversed copy;
* ``DeviceRng.sample_lazy`` advances the counter as a sample does, and its
  ``materialize()`` gives the sample's bits and JAX's ``LazyMatrix``'s;
* ``commit/pcs.py::_plain_point_at`` reverses one index without a table.
"""

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import keccak_host

from tpu_stark.compat.device_rng import DeviceRng as JRng
from tpu_stark.hash import sponge as jsponge
from tpu_stark_torch import kernels
from tpu_stark_torch.air.keccak_air import KeccakAir, generate_trace
from tpu_stark_torch.commit import pcs
from tpu_stark_torch.compat import device_rng as drng
from tpu_stark_torch.compat.device_rng import DeviceRng
from tpu_stark_torch.compat.from_jax import keccak_stream_from_jax
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.hash import keccak_kernel as kk
from tpu_stark_torch.hash.sponge import KeccakRowStream
from tpu_stark_torch.matrix import bit_reversal_perm
from tpu_stark_torch.prover.config import create_config
from tpu_stark_torch.prover.proof import serialize_proof
from tpu_stark_torch.prover.wide import prove_wide


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tests here are CPU-bound torch work: two intra-op threads keep
    them off the cores that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

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
    """Each chunk through ``absorb_rows`` (the whole blocks of the pending
    words and the chunk absorbed, the words after them returned as the next
    pending words), the tail through ``finalize_rows``."""
    mat = _u32(sum(chunking), (n, sum(chunking)))
    t = _t(mat)
    state = torch.full((50, n), 7, dtype=torch.int32)  # overwritten: first
    pend, off = None, 0
    for wc in chunking:
        first = off < kk.BLOCK_WORDS  # no block absorbed yet
        before = state.clone()
        pend = kk.absorb_rows(state, t[:, off : off + wc], first=first, pend=pend)
        off += wc
        assert pend is None or pend.shape == (n, off % kk.BLOCK_WORDS)
        if off < kk.BLOCK_WORDS:
            assert torch.equal(state, before)  # no block: the state is not touched
    got = kk.finalize_rows(state, pend)
    assert torch.equal(got, kk.hash_rows_plain(t))
    assert np.array_equal(got.numpy().view(np.uint32), _jax_digests(mat))


def test_absorb_continues_a_carried_state_and_finalize_leaves_it():
    n = 12
    start = _t(_u32(1, (50, n)))
    mat = _t(_u32(2, (n, 68 + 5)))
    want = start.clone()
    assert kk.absorb_rows_plain(want, mat[:, :68]) is None
    state = start.clone()
    assert kk.absorb_rows(state, mat[:, :34]) is None
    assert kk.absorb_rows(state, mat[:, 51:68], pend=mat[:, 34:51]) is None  # strided operands: 17 + 17 words
    assert torch.equal(state, want)
    before = state.clone()
    digest = kk.finalize_rows(state, mat[:, 68:73])
    assert torch.equal(state, before)
    assert torch.equal(digest, kk.finalize_rows_plain(want, mat[:, 68:73]))
    assert torch.equal(kk.finalize_rows(state, None), kk.finalize_rows_plain(want, mat[:, :0]))
    start_rows = torch.empty_like(start)
    kk.absorb_rows_plain(start_rows, mat[:, :68], first=True)
    assert torch.equal(kk.finalize_rows(start_rows, mat[:, 68:73]), kk.hash_rows_plain(mat))
    # a partial chunk: its last words come back; the finalize may take a chunk too
    state = start.clone()
    rest = kk.absorb_rows(state, mat[:, 5:], pend=mat[:, :5])
    assert torch.equal(state, want) and torch.equal(rest, mat[:, 68:])
    assert torch.equal(kk.finalize_rows(start, mat[:, :30], mat=mat[:, 30:]), kk.finalize_rows(want, rest))


def test_absorb_rejects_partial_blocks_and_bad_states():
    """A pending operand of a whole block or more, a natural-order chunk of
    rows that are not a power of two or of canonical words, empty input and
    a state that is not (50, N)."""
    state = torch.zeros((50, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="partial block"):
        kk.absorb_rows(state, torch.zeros((4, 0), dtype=torch.int32), pend=torch.zeros((4, 34), dtype=torch.int32))
    with pytest.raises(ValueError, match="partial block"):
        kk.finalize_rows(state, torch.zeros((4, 34), dtype=torch.int32))
    with pytest.raises(ValueError, match="empty sponge input"):
        kk.finalize_rows(state, None, first=True)
    with pytest.raises(ValueError, match="power of two"):
        kk.absorb_rows(torch.zeros((50, 6), dtype=torch.int32), torch.zeros((6, 34), dtype=torch.int32),
                       monty=True, natural=True)
    with pytest.raises(ValueError, match="Montgomery"):
        kk.absorb_rows(state, torch.zeros((4, 34), dtype=torch.int32), natural=True)
    with pytest.raises(ValueError, match=r"\(50, N\)"):
        kk.absorb_rows(torch.zeros((4, 50), dtype=torch.int32), torch.zeros((4, 34), dtype=torch.int32))


def _jax_carry(jstream):
    lanes = [(np.asarray(lo), np.asarray(hi)) for lo, hi in jstream._state]
    pend = [(np.asarray(lo), np.asarray(hi)) for lo, hi in jstream._pend]
    half = None if jstream._half is None else np.asarray(jstream._half)
    return keccak_stream_from_jax(lanes, pend, half, device="cpu")


def _pending(stream):
    """The port's pending words as JAX holds them: the words the last
    launch wrote back, then a chunk that completes no block, as the next
    launch will read it."""
    parts = [] if stream._pend is None else [stream._pend]
    if stream._tail is not None:
        parts.append(kk._row_words(None, *stream._tail))
    return torch.cat(parts, dim=1) if parts else None


def _check_carry(stream, jstream):
    want_state, want_pend = _jax_carry(jstream)
    assert torch.equal(stream._state, want_state)
    got = _pending(stream)
    assert (got is None) == (want_pend is None)
    assert got is None or torch.equal(got, want_pend)


@pytest.mark.parametrize("n,chunking", CHUNKINGS)
def test_keccak_row_stream_matches_jax_after_every_chunk(n, chunking):
    mat = _u32(100 + n, (n, sum(chunking)))
    stream, jstream = KeccakRowStream(n, "cpu"), jsponge.KeccakRowStream(n)
    off = 0
    for wc in chunking:
        stream.absorb_cols(_t(mat[:, off : off + wc]))
        jstream.absorb_cols(jnp.asarray(mat[:, off : off + wc]))
        off += wc
        _check_carry(stream, jstream)
    got = stream.finalize()
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(jstream.finalize()))
    assert torch.equal(got, kk.hash_rows_plain(_t(mat)))


def test_keccak_row_stream_of_short_rows():
    """Rows shorter than a block absorb no block: the chunks wait for the
    finalize."""
    mat = _u32(5, (6, 9))
    stream = KeccakRowStream(6, "cpu")
    stream.absorb_cols(_t(mat[:, :4]))
    stream.absorb_cols(_t(mat[:, 4:]))
    assert stream._first
    assert torch.equal(stream.finalize(), kk.hash_rows_plain(_t(mat)))
    with pytest.raises(ValueError, match="empty sponge input"):
        KeccakRowStream(6, "cpu").finalize()


def _monty(seed, shape):
    return np.random.default_rng(seed).integers(0, bb.P, size=shape, dtype=np.int64).astype(np.uint32)


# (log2 rows, Montgomery chunk widths): cell 6's 64-column chunks and its
# 24-column last one, and odd widths whose blocks and u32 pairs straddle
# chunks, a chunk that completes no block among them
MONTY_CHUNKINGS = [(6, (64, 64, 24)), (8, (7, 30, 34, 10)), (10, (1, 33, 35, 68, 3))]


@pytest.mark.parametrize("natural", [True, False])
@pytest.mark.parametrize("log_n,chunking", MONTY_CHUNKINGS)
@pytest.mark.parametrize("carried", [False, True])
def test_monty_chunks_match_jax_on_the_canonical_reversed_copy(log_n, chunking, natural, carried):
    """``absorb_monty`` of codeword chunks (Montgomery forms) in natural
    row order, as K2 leaves them, or already in the tree's order, then 4
    Montgomery salt columns in the tree's order, against JAX's stream fed
    ``bb.to_u32`` of the bit-reversed chunks (its commit's input): the same
    state and pending words after every chunk and the same digests; from
    the zero state, or (``carried``) after 5 canonical columns."""
    from tpu_stark.fields import babybear as jbb
    from tpu_stark.matrix import reverse_matrix_index_bits as jreverse

    n = 1 << log_n
    code = _monty(log_n + len(chunking), (n, sum(chunking)))  # natural order
    salts = _monty(7, (n, 4))  # the tree's order
    stream, jstream = KeccakRowStream(n, "cpu"), jsponge.KeccakRowStream(n)
    if carried:
        lead = _u32(3, (n, 5))
        stream.absorb_cols(_t(lead))
        jstream.absorb_cols(jnp.asarray(lead))
    tree = code[bit_reversal_perm(log_n)]
    off = 0
    for wc in chunking:
        chunk = code[:, off : off + wc] if natural else tree[:, off : off + wc]
        stream.absorb_monty(_t(chunk), natural)
        jstream.absorb_cols(jbb.to_u32(jreverse(jnp.asarray(code[:, off : off + wc]))))
        off += wc
        _check_carry(stream, jstream)
    stream.absorb_monty(_t(salts), False)
    jstream.absorb_cols(jbb.to_u32(jnp.asarray(salts)))
    _check_carry(stream, jstream)
    got = stream.finalize()
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(jstream.finalize()))


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

# ---------------------------------------------------------------------------
# K1's absorb kernel (csrc/keccak_sponge.cu) on the host
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return keccak_host.build(tmp_path_factory.mktemp("keccak_host"))


@pytest.fixture
def emulated(host_lib, monkeypatch):
    """The absorb's wrappers take their kernel path on CPU tensors, through
    the host library; the plain versions refuse to run.  Returns them."""
    plain = {name: getattr(kk, name) for name in ("absorb_rows_plain", "finalize_rows_plain")}
    monkeypatch.setattr(kk, "_on_card", lambda t: True)
    monkeypatch.setattr(kernels, "lib", lambda: host_lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: None)

    def refuse(*args, **kw):
        raise AssertionError("a plain absorb ran on the kernel path")

    for name in plain:
        monkeypatch.setattr(kk, name, refuse)
    kernels.reset_launch_counts()
    return plain


# (rows, pending words, new words): whole blocks alone, the pending words'
# block, the words written back, no block at all, several tiles, rows past
# one block of 128 threads
HOST_ABSORB_CASES = [(1, 0, 34), (64, 30, 64), (200, 33, 1), (256, 5, 0), (64, 0, 5), (128, 7, 100),
                     (256, 12, 150), (200, 0, 68), (64, 2, 66)]


@pytest.mark.parametrize("n,p,k,monty,natural", [
    (n, p, k, monty, natural) for n, p, k in HOST_ABSORB_CASES for monty in (False, True) for natural in (False, True)
    if not natural or (n & (n - 1) == 0 and k)])  # a natural-order chunk has a power-of-two height
def test_host_absorb_kernel_equals_plain(emulated, host_lib, n, p, k, monty, natural):
    """The kernel's staging (16-byte copies where the chunk allows, else
    4-byte ones), its reversed row reads and Montgomery reductions, the
    pending words it reads (word-major, as it writes them) and writes back,
    and the finalize, against the plain versions; from the zero state and a
    carried one.  A natural-order chunk of canonical words (no caller has
    one) is refused by the wrapper and by the kernel's entry."""
    rng = np.random.default_rng(n + 7 * p + 11 * k)
    if natural and not monty:
        state, mat = _t(_u32(n, (50, n))), _t(_u32(k, (n, k)))
        with pytest.raises(ValueError, match="Montgomery"):
            kk.absorb_rows(state, mat, False, None, monty, natural)
        with pytest.raises(ValueError, match="Montgomery"):
            kk.finalize_rows(state, None, False, mat, monty, natural)
        out = torch.empty((n, 8), dtype=torch.int32)
        assert host_lib.ts_keccak_absorb(state.data_ptr(), n, n.bit_length() - 1, None, 0, 0, 0, mat.data_ptr(), k, k,
                                         0, 1, 0, 1, out.data_ptr(), None) == 1  # cudaErrorInvalidValue
        return
    for first, aligned in ((True, True), (False, True), (False, False)):
        width = k if aligned else k + 3
        words = rng.integers(0, bb.P if monty else 1 << 32, size=n * width + 1, dtype=np.int64)
        flat = torch.from_numpy(words.astype(np.uint32).view(np.int32))
        mat = (flat[:-1] if aligned else flat[1:]).view(n, width)[:, :k] if k else None
        pend = _t(_u32(p + 1, (p, n))).t() if p else None
        state = _t(_u32(n, (50, n)))
        want_state = state.clone()
        digest = kk.finalize_rows(state, pend, first, mat, monty, natural)
        assert torch.equal(digest, emulated["finalize_rows_plain"](state, pend, first, mat, monty, natural))
        if mat is None:
            continue
        rest = kk.absorb_rows(state, mat, first, pend, monty, natural)
        want = emulated["absorb_rows_plain"](want_state, mat, first, pend, monty, natural)
        assert torch.equal(state, want_state)
        assert (rest is None) == (want is None) and (rest is None or torch.equal(rest, want))


def test_streamed_zk_prove_through_the_absorb_kernel_equals_jax(emulated):
    """keccak-air's zk ``prove_wide`` on the Keccak stack in 4 column chunks,
    its commit absorbing each natural-order Montgomery chunk and the salts
    through the kernel: the JAX prover's bytes."""
    fixture = pathlib.Path(__file__).parent / "golden" / "torch_keccak_air_wide_zk_jax_proofs.json"
    want = json.loads(fixture.read_text())["keccak_4chunks"]
    trace = generate_trace(2, seed=want["seed"], device="cpu")
    cfg = create_config(zk=True, hash="keccak", device="cpu")
    blob = serialize_proof(prove_wide(cfg, KeccakAir(), trace, [], col_chunk=want["col_chunk"]))
    assert (hashlib.sha256(blob).hexdigest(), len(blob)) == (want["sha256"], want["len"])
    assert kernels.KECCAK_ABSORB.launches > 0
