"""The port's batched proof-of-work search (``tpu_stark_torch/challenger/
grind.py``) against the JAX package's ``device_grind`` and the scalar
``Challenger.check_witness``, on the CPU (the plain verdicts), for every
block geometry of the witness: inside block 0, filling it exactly,
straddling the 136-byte boundary, in a later block.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from tpu_stark.challenger.challenger import Challenger as JChallenger
from tpu_stark.challenger.challenger import HashChallenger as JHash
from tpu_stark.challenger.grind import device_grind as j_device_grind
from tpu_stark_torch.challenger import grind
from tpu_stark_torch.challenger.challenger import GRIND_DEVICE_MIN_BITS, Challenger, HashChallenger
from tpu_stark_torch.fields import babybear as bb

GEOMETRIES = [32, 132, 134, 200, 268]
FIXTURE = pathlib.Path(__file__).parent / "golden" / "torch_device_rng_jax.json"


def _transcript(n_bytes: int, seed: int = 11) -> bytes:
    return bytes(np.random.default_rng(seed + n_bytes).integers(0, 256, size=n_bytes, dtype=np.uint8))


def _challenger(data: bytes) -> Challenger:
    c = Challenger(HashChallenger(), device="cpu")
    c.inner.observe_bytes(data)
    return c


def _host_grind(ch: Challenger, bits: int) -> int:
    return next(w for w in range(bb.P) if ch.clone().check_witness(bits, w))


@pytest.mark.parametrize("n_bytes", GEOMETRIES)
def test_verdicts_match_check_witness(n_bytes):
    """Every flag of a chunk equals the scalar check of its witness."""
    ch = _challenger(_transcript(n_bytes))
    prefix, tail, w_off = grind._plan(bytes(ch.inner._input))
    pre, tl = grind._operands(prefix, tail, "cpu")
    start, count, bits = 1000, 300, 3
    flags = grind.verdicts(start, count, pre, tl, w_off, bits)
    want = [grind.PASSED if ch.clone().check_witness(bits, start + i) else 0 for i in range(count)]
    assert flags.dtype == torch.uint8 and flags.tolist() == want


@pytest.mark.parametrize("bits", [1, 6, 9, 12])
@pytest.mark.parametrize("n_bytes", GEOMETRIES)
def test_device_grind_matches_host_loop(n_bytes, bits):
    ch = _challenger(_transcript(n_bytes))
    got = grind.device_grind(bytes(ch.inner._input), bits, "cpu", chunk=1 << 12,
                             host_check=lambda w: ch.clone().check_witness(bits, w))
    assert got == _host_grind(ch, bits)


@pytest.mark.parametrize("n_bytes,bits", [(32, 16), (134, 16), (200, 11), (268, 8)])
def test_device_grind_matches_jax(n_bytes, bits):
    data = _transcript(n_bytes)
    jc = JChallenger(JHash())
    jc.inner.observe_bytes(data)
    want = j_device_grind(data, bits, chunk=1 << 14, host_check=lambda w: jc.clone().check_witness(bits, w))
    ch = _challenger(data)
    assert grind.device_grind(data, bits, "cpu", chunk=1 << 14) == want
    assert ch.clone().check_witness(bits, want)


@pytest.mark.parametrize("case", range(4))
def test_device_grind_matches_the_stored_jax_witness(case):
    """The witnesses ``chip_smoke.py`` holds the card to (written by JAX's
    ``device_grind``, see tests/test_torch_device_rng.py)."""
    entry = json.loads(FIXTURE.read_text())["grind"][case]
    data = bytes.fromhex(entry["transcript_hex"])
    got = grind.device_grind(data, entry["bits"], "cpu")
    assert got == entry["witness"]
    assert _challenger(data).check_witness(entry["bits"], got)


def test_challenger_grind_dispatch_matches_jax():
    """At 16 bits ``Challenger.grind`` takes the batched search, returns
    JAX's witness and leaves the transcript as JAX's does."""
    data = _transcript(96)
    ch, jc = _challenger(data), JChallenger(JHash())
    jc.inner.observe_bytes(data)
    assert GRIND_DEVICE_MIN_BITS == 6
    assert ch.grind(16) == jc.grind(16)
    assert bytes(ch.inner._input) == bytes(jc.inner._input)
    assert ch.sample_u32() == jc.sample_u32()


def test_chaining_corner_goes_to_the_host_check(monkeypatch):
    """Candidates whose 8 draws all reject (forced here by flagging them
    NEEDS_HOST in a patched draw check) are decided by ``host_check``: a
    flagged candidate that fails it is skipped, one that passes is taken."""
    ch = _challenger(_transcript(40))
    bits = 7
    want = _host_grind(ch, bits)
    real = grind.verdicts
    forced = {want // 2, want}

    def patched(start, count, *args):
        flags = real(start, count, *args)
        for w in forced:
            if start <= w < start + count:
                flags[w - start] = grind.NEEDS_HOST
        return flags

    monkeypatch.setattr(grind, "verdicts", patched)
    asked = []

    def host_check(w):
        asked.append(w)
        return ch.clone().check_witness(bits, w)

    assert grind.device_grind(bytes(ch.inner._input), bits, "cpu", chunk=256, host_check=host_check) == want
    assert asked == sorted(forced)
    # with no host check the corner is skipped: the next passing witness wins
    nxt = next(w for w in range(want + 1, bb.P) if ch.clone().check_witness(bits, w))
    assert grind.device_grind(bytes(ch.inner._input), bits, "cpu", chunk=256) == nxt


def test_last_chunk_stops_at_p(monkeypatch):
    """The last chunk runs past p - 1; a hit there is not a witness."""
    def patched(start, count, *args):
        flags = torch.zeros(count, dtype=torch.uint8)
        if start + count > bb.P:
            flags[bb.P - start] = grind.PASSED
        return flags

    monkeypatch.setattr(grind, "verdicts", patched)
    assert grind.device_grind(b"x" * 10, 8, "cpu", chunk=1 << 26) is None


def test_wrapper_rejects_other_devices():
    pre, tl = grind._operands(*grind._plan(b"abc")[:2], "cpu")
    with pytest.raises(ValueError):
        grind.verdicts(0, 8, pre.to("meta"), tl.to("meta"), 3, 4)
