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
import json
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_stark.challenger.grind import device_grind as j_device_grind
from tpu_stark.compat.device_rng import DeviceRng as JRng
from tpu_stark_torch.compat import device_rng as drng
from tpu_stark_torch.compat.device_rng import DeviceRng
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


def test_make_zk_rng_modes():
    dev = make_zk_rng("device", 1, "salts", "cpu")
    assert isinstance(dev, DeviceRng) and dev.device.type == "cpu"
    assert type(make_zk_rng("smallrng", 1, "salts", "cpu")).__name__ == "SmallRng"
    with pytest.raises(ValueError):
        make_zk_rng("philox", 1)


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
