"""The port's device zk rng (``tpu_stark_torch/compat/device_rng.py``)
against JAX's ``jax.random`` Threefry and the JAX package's ``DeviceRng``,
bit for bit.

``tests/golden/torch_device_rng_jax.json`` holds JAX's samples (SHA-256 of
the u32 little-endian bytes and the first words) for seeds 1 and 7, every
stream tag the prover uses, counters 0-2 and shapes up to (2^21, 4), and
the witnesses JAX's ``device_grind`` finds at 8-16 bits
(``tests/test_torch_grind.py`` reads those), so that the card's machine,
which has no JAX, can check both (``chip_smoke.py`` phase 15).  The tests
here read the small samples.  Regenerate it with JAX on the CPU:

    PYTHONPATH=. python tests/test_torch_device_rng.py regen
"""

import hashlib
import inspect
import json
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.extend.random import threefry_2x32

from tpu_stark.challenger.grind import device_grind as j_device_grind
from tpu_stark.compat.device_rng import DeviceRng as JRng
from tpu_stark.compat.device_rng import _sample_monty as j_sample_monty
from tpu_stark_torch import kernels
from tpu_stark_torch.compat import device_rng as drng
from tpu_stark_torch.compat.device_rng import DeviceRng
from tpu_stark_torch.compat import from_jax
from tpu_stark_torch.compat.from_jax import device_rng_from_state
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.prover.config import make_zk_rng

FIXTURE = pathlib.Path(__file__).parent / "golden" / "torch_device_rng_jax.json"
SEEDS = (1, 7)
STREAMS = ("", "salts", "codewords", "trace")
# per counter 0, 1, 2: the sample's shape for seed 1 and seed 7
SHAPES = {1: ((8, 4), (1000, 3), (1 << 21, 4)), 7: ((5, 1), (257, 2), (1 << 20, 2))}
CPU_MAX_ELEMS = 1 << 14
# (transcript bytes, PoW bits) of the stored grind witnesses
GRIND_CASES = ((32, 8), (134, 12), (200, 16), (268, 16))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The samples here are CPU-bound torch work: two intra-op threads keep
    them off the cores that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _u32(t) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _key_pair(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", [0, 1, 7, (1 << 32) + 3, 0xFFFFFFFF])
def test_primitives_match_jax_random(seed):
    """key, fold_in, split and bits, each against jax.random."""
    jk = jax.random.key(np.uint64(seed) & np.uint64(0xFFFFFFFF))
    tk = drng.key(seed & 0xFFFFFFFF)
    assert tk == _key_pair(jk)
    for data in (0, 1, 2, 0xDEADBEEF, 0xFFFFFFFF):
        assert drng.fold_in(tk, data) == _key_pair(jax.random.fold_in(jk, data))
    j_hi, j_lo = jax.random.split(jk)
    assert drng.split(tk) == (_key_pair(j_hi), _key_pair(j_lo))
    for shape in [(1, 1), (3, 5), (64, 4), (7, 1)]:
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        assert np.array_equal(_u32(drng.random_bits(tk, *shape, "cpu")), want)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("seed", [1, 7, (1 << 33) + 5])
def test_samples_match_jax_device_rng(seed, stream):
    """Successive sample calls (the counter) at several shapes."""
    j, t = JRng(seed, stream), DeviceRng(seed, stream, "cpu")
    for rows, cols in [(8, 4), (1, 1), (33, 3), (512, 2)]:
        want = np.asarray(j.sample_babybear_matrix_monty(rows, cols))
        got = t.sample_babybear_matrix_monty(rows, cols)
        assert got.dtype == bb.I32 and got.device.type == "cpu"
        assert np.array_equal(_u32(got), want)
        assert int(want.max()) < bb.P


def test_carried_mid_stream():
    """A JAX stream advanced by two calls continues in the port."""
    j = JRng(1, "salts")
    for _ in range(2):
        j.sample_babybear_matrix_monty(16, 4)
    t = device_rng_from_state(np.asarray(jax.random.key_data(j._key)), j._counter, "cpu")
    for rows, cols in [(16, 4), (100, 2)]:
        assert np.array_equal(_u32(t.sample_babybear_matrix_monty(rows, cols)),
                              np.asarray(j.sample_babybear_matrix_monty(rows, cols)))


def test_carry_helpers_default_to_the_card():
    """Like the port's other entry points, the helpers that carry JAX state
    across put it on the card unless the caller asks for the CPU."""
    for fn in (from_jax.device_rng_from_state, from_jax.prover_data_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_make_zk_rng_modes():
    dev = make_zk_rng("device", 1, "salts", "cpu")
    assert isinstance(dev, DeviceRng) and dev.device.type == "cpu"
    assert type(make_zk_rng("smallrng", 1, "salts", "cpu")).__name__ == "SmallRng"
    with pytest.raises(ValueError):
        make_zk_rng("philox", 1)


# The addressing contract of a sample, which kernel K6 meets on the card
# (tests/test_torch_cuda.py holds K6 to the plain version there): element
# (r, c) of a sample of ``cols`` columns hashes the flat index
# row * cols + col, for any rows (row0, a block, gathered row indices with
# repeats) and columns (``sel``, with repeats).
ADDR_KEYS = ((1, 0), (7, 2), (0xDEADBEEF, 5))


def _port_key(seed, counter):
    return drng.fold_in(drng.key(seed), counter)


def _jax_sample(k, rows, cols) -> np.ndarray:
    """JAX's ``_sample_monty`` of the whole (rows, cols) sample under the
    port's key pair ``k``."""
    return np.asarray(j_sample_monty(jax.random.wrap_key_data(np.asarray(k, dtype=np.uint32)), rows, cols))


@pytest.mark.parametrize("seed,counter", ADDR_KEYS)
def test_sample_columns_match_jax(seed, counter):
    """``sel`` (repeats and any order) draws those columns of the sample."""
    k = _port_key(seed, counter)
    rows, cols = 40, 13
    whole = _jax_sample(k, rows, cols)
    for sel in ([0], [12, 3, 3, 0, 7], list(range(13))[::-1], [5, 5, 5, 5, 1, 2, 11, 11]):
        got = drng._sample_monty(k, rows, cols, "cpu", sel=np.asarray(sel))
        assert np.array_equal(_u32(got), whole[:, sel])


@pytest.mark.parametrize("seed,counter", ADDR_KEYS)
def test_sample_rows_from_row0_match_jax(seed, counter):
    """``row0`` draws rows [row0, row0 + rows) of a taller sample, with
    ``sel`` or without; ``LazyMatrix.block`` is the same draw deferred."""
    k = _port_key(seed, counter)
    rows, cols = 96, 5
    whole = _jax_sample(k, rows, cols)
    for r0, n in ((0, 96), (17, 30), (95, 1), (64, 32)):
        assert np.array_equal(_u32(drng._sample_monty(k, n, cols, "cpu", row0=r0)), whole[r0 : r0 + n])
        sel = [4, 0, 0, 2]
        assert np.array_equal(_u32(drng._sample_monty(k, n, cols, "cpu", sel=sel, row0=r0)),
                              whole[r0 : r0 + n][:, sel])
        lazy = drng.LazyMatrix(k, rows, cols, "cpu").block(r0, n)
        assert np.array_equal(_u32(lazy.materialize()), whole[r0 : r0 + n])


@pytest.mark.parametrize("seed,counter", ADDR_KEYS)
def test_lazy_rows_match_jax(seed, counter):
    """``LazyMatrix.rows`` with repeated and unsorted rows, of the whole
    sample and of a block of it."""
    k = _port_key(seed, counter)
    rows, cols = 128, 4
    whole = _jax_sample(k, rows, cols)
    idx = np.array([127, 0, 5, 5, 64, 3, 127, 1, 1, 99])
    lazy = drng.LazyMatrix(k, rows, cols, "cpu")
    assert np.array_equal(_u32(lazy.rows(idx)), whole[idx])
    assert np.array_equal(_u32(lazy.rows(torch.from_numpy(idx))), whole[idx])
    part = lazy.block(32, 64)
    local = np.array([63, 0, 0, 10, 2])
    assert np.array_equal(_u32(part.rows(local)), whole[32 + local])


@pytest.mark.parametrize("key", [(0, 0), (1, 2), (0xFFFFFFFF, 0x12345678)])
def test_threefry_at_high_counter_words_matches_jax(key):
    """Threefry-2x32 at counter pairs whose high word is not 0 (flat
    indices at and past 2^32), against ``jax.extend.random.threefry_2x32``."""
    flat = np.array([1 << 32, (1 << 32) + 1, (3 << 32) + 7, (0xFFFF << 32) | 0xFFFFFFFF, (1 << 40) + 5, 12],
                    dtype=np.uint64)
    x0, x1 = (flat >> np.uint64(32)).astype(np.uint32), (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want = np.asarray(threefry_2x32(np.asarray(key, dtype=np.uint32), np.concatenate([x0, x1])))
    b0, b1 = drng.threefry2x32(key, torch.from_numpy(x0.astype(np.int64)), torch.from_numpy(x1.astype(np.int64)))
    assert np.array_equal(np.concatenate([_u32(b0), _u32(b1)]), want)


@pytest.mark.parametrize("seed,counter", ADDR_KEYS)
def test_sample_past_two_to_the_32_matches_jax_threefry(seed, counter):
    """Rows of a sample whose flat indices pass 2^32 (the rows of a tall
    sample that ``row0``, ``LazyMatrix.block`` and ``rows`` address): each
    element is (hi * 2^32 + lo) mod p of JAX's Threefry under the split
    keys at its flat index."""
    k = _port_key(seed, counter)
    cols = 4
    row0 = (1 << 32) // cols - 3  # the rows straddle flat index 2^32
    rows = 8
    flat = (np.arange(row0, row0 + rows, dtype=np.uint64)[:, None] * np.uint64(cols)
            + np.arange(cols, dtype=np.uint64)).ravel()
    x = np.concatenate([(flat >> np.uint64(32)).astype(np.uint32), (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)])

    def bits(half):
        out = np.asarray(threefry_2x32(np.asarray(half, dtype=np.uint32), x)).astype(np.uint64)
        return out[: len(flat)] ^ out[len(flat) :]

    k_hi, k_lo = drng.split(k)
    want = ((bits(k_hi) * np.uint64((1 << 32) % bb.P) + bits(k_lo)) % np.uint64(bb.P)).reshape(rows, cols)
    assert np.array_equal(_u32(drng._sample_monty(k, rows, cols, "cpu", row0=row0)), want)
    lazy = drng.LazyMatrix(k, 1 << 31, cols, "cpu")
    assert np.array_equal(_u32(lazy.block(row0, rows).materialize()), want)
    assert np.array_equal(_u32(lazy.rows(np.arange(row0 + rows - 1, row0 - 1, -1))), want[::-1])


class _Launched(Exception):
    pass


def test_samples_on_the_card_never_run_the_plain_version(monkeypatch):
    """For a CUDA device the sample and ``LazyMatrix.rows`` go to kernel K6
    (the library is loaded first, here a stand-in that stops the call);
    the plain ``_monty_at`` never runs.  Other devices are refused."""
    def launched():
        raise _Launched

    def refuse(*args, **kwargs):
        raise AssertionError("the plain Threefry ran for a CUDA device")

    monkeypatch.setattr(kernels, "lib", launched)
    monkeypatch.setattr(drng, "_monty_at", refuse)
    k = _port_key(1, 0)
    lazy = drng.LazyMatrix(k, 64, 4, "cuda")
    calls = [lambda: drng._sample_monty(k, 8, 4, "cuda"), lambda: drng._sample_monty(k, 8, 4, "cuda", sel=[3, 3]),
             lambda: drng._sample_monty(k, 8, 4, "cuda:0", row0=1 << 30), lazy.materialize,
             lambda: lazy.rows([5, 5, 0]), lambda: lazy.block(16, 8).rows([1]),
             lambda: DeviceRng(1, "salts", "cuda").sample_babybear_matrix_monty(4, 4)]
    for call in calls:
        with pytest.raises(_Launched):
            call()
    with pytest.raises(ValueError, match="unsupported device"):
        drng._sample_monty(k, 8, 4, "meta")
    def plain(*args):
        raise _Launched("plain")

    monkeypatch.setattr(drng, "_monty_at", plain)
    with pytest.raises(_Launched, match="plain"):  # the CPU keeps the plain version
        drng._sample_monty(k, 8, 4, "cpu")


def sample_digest(sample: np.ndarray) -> dict:
    flat = np.ascontiguousarray(sample, dtype="<u4")
    return {"sha256": hashlib.sha256(flat.tobytes()).hexdigest(), "first": [int(v) for v in flat.ravel()[:8]]}


def test_fixture_samples():
    """The fixture's small samples; each call advances the counter."""
    entries = json.loads(FIXTURE.read_text())["samples"]
    assert len(entries) == len(SEEDS) * len(STREAMS) * 3
    checked = 0
    for e in entries:
        t = DeviceRng(e["seed"], e["stream"], "cpu")
        for _ in range(e["counter"]):
            t.sample_babybear_matrix_monty(1, 1)
        if e["rows"] * e["cols"] > CPU_MAX_ELEMS:
            continue
        got = sample_digest(_u32(t.sample_babybear_matrix_monty(e["rows"], e["cols"])))
        assert got == {"sha256": e["sha256"], "first": e["first"]}, e
        checked += 1
    assert checked == len(SEEDS) * len(STREAMS) * 2


def grind_transcript(n_bytes: int) -> bytes:
    return bytes(np.random.default_rng(1000 + n_bytes).integers(0, 256, size=n_bytes, dtype=np.uint8))


def _regen():
    jax.config.update("jax_platforms", "cpu")
    samples = []
    for seed in SEEDS:
        for stream in STREAMS:
            j = JRng(seed, stream)
            for counter, (rows, cols) in enumerate(SHAPES[seed]):
                sample = np.asarray(j.sample_babybear_matrix_monty(rows, cols))
                samples.append({"seed": seed, "stream": stream, "counter": counter, "rows": rows,
                                "cols": cols, **sample_digest(sample)})
    grinds = []
    for n_bytes, bits in GRIND_CASES:
        data = grind_transcript(n_bytes)
        grinds.append({"transcript_hex": data.hex(), "bits": bits, "witness": j_device_grind(data, bits)})
    FIXTURE.write_text(json.dumps({"samples": samples, "grind": grinds}, indent=1))


if __name__ == "__main__":
    assert sys.argv[1:] == ["regen"], "usage: python tests/test_torch_device_rng.py regen"
    _regen()
