"""The port's batched proof-of-work search (``tpu_stark_torch/challenger/
grind.py``) against the JAX package's ``device_grind`` and the scalar
``Challenger.check_witness``, on the CPU (the plain verdicts), for every
block geometry of the witness: inside block 0, filling it exactly,
straddling the 136-byte boundary, in a later block.  The grind kernel's
witness placement (``witness_lanes``) against the plain byte loop, and the
kernel itself (``csrc/keccak_sponge.cu`` built for the host,
``tests/keccak_host.py``) against the plain verdicts and JAX's witnesses.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import keccak_host
from tpu_stark.challenger.challenger import Challenger as JChallenger
from tpu_stark.challenger.challenger import HashChallenger as JHash
from tpu_stark.challenger.grind import device_grind as j_device_grind
from tpu_stark_torch import kernels
from tpu_stark_torch.challenger import grind
from tpu_stark_torch.challenger.challenger import GRIND_DEVICE_MIN_BITS, Challenger, HashChallenger
from tpu_stark_torch.fields import babybear as bb


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tests here are CPU-bound torch work: two intra-op threads keep
    them off the cores that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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
    got = grind.device_grind(bytes(ch.inner._input), bits, chunk=1 << 12, device="cpu",
                             host_check=lambda w: ch.clone().check_witness(bits, w))
    assert got == _host_grind(ch, bits)


@pytest.mark.parametrize("n_bytes,bits", [(32, 16), (134, 16), (200, 11), (268, 8)])
def test_device_grind_matches_jax(n_bytes, bits):
    data = _transcript(n_bytes)
    jc = JChallenger(JHash())
    jc.inner.observe_bytes(data)
    want = j_device_grind(data, bits, chunk=1 << 14, host_check=lambda w: jc.clone().check_witness(bits, w))
    ch = _challenger(data)
    assert grind.device_grind(data, bits, chunk=1 << 14, device="cpu") == want
    assert ch.clone().check_witness(bits, want)


@pytest.mark.parametrize("case", range(4))
def test_device_grind_matches_the_stored_jax_witness(case):
    """The witnesses ``chip_smoke.py`` holds the card to (written by JAX's
    ``device_grind``, see tests/test_torch_device_rng.py)."""
    entry = json.loads(FIXTURE.read_text())["grind"][case]
    data = bytes.fromhex(entry["transcript_hex"])
    got = grind.device_grind(data, entry["bits"], device="cpu")
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

    assert grind.device_grind(bytes(ch.inner._input), bits, chunk=256, host_check=host_check, device="cpu") == want
    assert asked == sorted(forced)
    # with no host check the corner is skipped: the next passing witness wins
    nxt = next(w for w in range(want + 1, bb.P) if ch.clone().check_witness(bits, w))
    assert grind.device_grind(bytes(ch.inner._input), bits, chunk=256, device="cpu") == nxt


def test_last_chunk_stops_at_p(monkeypatch):
    """The last chunk runs past p - 1; a hit there is not a witness."""
    def patched(start, count, *args):
        flags = torch.zeros(count, dtype=torch.uint8)
        if start + count > bb.P:
            flags[bb.P - start] = grind.PASSED
        return flags

    monkeypatch.setattr(grind, "verdicts", patched)
    assert grind.device_grind(b"x" * 10, 8, chunk=1 << 26, device="cpu") is None


def test_wrapper_rejects_other_devices():
    pre, tl = grind._operands(*grind._plan(b"abc")[:2], "cpu")
    with pytest.raises(ValueError):
        grind.verdicts(0, 8, pre.to("meta"), tl.to("meta"), 3, 4)


def test_device_grind_binds_arguments_as_jax_does():
    """``chunk`` and ``host_check`` keep the positions and defaults of JAX's
    ``device_grind``; the port's ``device`` is keyword-only, so a call
    written for JAX finds the same witness."""
    import inspect

    mine = inspect.signature(grind.device_grind).parameters
    theirs = inspect.signature(j_device_grind).parameters
    positional = [n for n, p in mine.items() if p.kind is p.POSITIONAL_OR_KEYWORD]
    assert positional == list(theirs)
    for name in theirs:
        assert mine[name].default == theirs[name].default, name
    assert mine["device"].kind is inspect.Parameter.KEYWORD_ONLY
    data = _transcript(134)
    want = j_device_grind(data, 9, 1 << 12, None)
    assert grind.device_grind(data, 9, 1 << 12, None, device="cpu") == want
    with pytest.raises(TypeError):
        grind.device_grind(data, 9, 1 << 12, None, "cpu")


# transcript lengths: the witness inside one lane (32, 130, 200), ending
# block 0 (132, 268), across two lanes (37, 45) and across the tail's two
# blocks (133, 134, 135)
PLACEMENTS = [32, 37, 45, 130, 132, 133, 134, 135, 200, 268]


@pytest.mark.parametrize("n_bytes", PLACEMENTS)
def test_witness_lanes_place_the_bytes_as_the_byte_loop(n_bytes):
    """The kernel's lanes (block, lane, shift) xor w into the tail exactly as
    the plain version's byte loop places its 4 little-endian bytes."""
    prefix, tail, w_off = grind._plan(_transcript(n_bytes))
    blocks = len(tail) // grind.RATE_BYTES
    parts = grind.witness_lanes(w_off)
    assert parts[0][1] >= 0 and sum(lane >= 0 for _, lane, _ in parts) == 1 + (w_off % 8 > 4)
    for w in (0x01020304, 0xFFFFFFFF, 0x80000001, 12345):
        by_bytes = bytearray(tail)
        for i in range(4):
            by_bytes[w_off + i] ^= (w >> (8 * i)) & 0xFF
        by_lanes = [int.from_bytes(tail[8 * j : 8 * j + 8], "little") for j in range(blocks * grind.RATE_LANES)]
        for block, lane, shift in parts:
            if lane >= 0:
                v = (w << shift) if shift >= 0 else (w >> -shift)
                by_lanes[block * grind.RATE_LANES + lane] ^= v & ((1 << 64) - 1)
        assert b"".join(v.to_bytes(8, "little") for v in by_lanes) == bytes(by_bytes)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return keccak_host.build(tmp_path_factory.mktemp("grind_host"))


@pytest.fixture
def emulated(host_lib, monkeypatch):
    """``verdicts`` takes its kernel path on CPU tensors, through the host
    library; the plain version refuses to run.  Returns it."""
    plain = grind.verdicts_plain
    monkeypatch.setattr(grind, "_on_card", lambda t: True)
    monkeypatch.setattr(kernels, "lib", lambda: host_lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda device: None)

    def refuse(*args, **kw):
        raise AssertionError("the plain verdicts ran on the kernel path")

    monkeypatch.setattr(grind, "verdicts_plain", refuse)
    kernels.reset_launch_counts()
    return plain


@pytest.mark.parametrize("n_bytes", PLACEMENTS)
def test_host_grind_kernel_equals_plain(emulated, n_bytes):
    """The kernel's verdicts (its constants staged once, w xored into its
    lanes, the last round for lanes 0-3 only) against the plain ones."""
    prefix, tail, w_off = grind._plan(_transcript(n_bytes))
    pre, tl = grind._operands(prefix, tail, "cpu")
    for start, count, bits in ((0, 1000, 1), (12345, 777, 3), ((1 << 32) - 300, 300, 5)):
        got = grind.verdicts(start, count, pre, tl, w_off, bits)
        assert torch.equal(got, emulated(start, count, pre, tl, w_off, bits))
    assert kernels.KECCAK_GRIND.launches == 3


@pytest.mark.parametrize("case", range(4))
def test_device_grind_through_the_kernel_matches_the_stored_jax_witness(emulated, case):
    entry = json.loads(FIXTURE.read_text())["grind"][case]
    assert grind.device_grind(bytes.fromhex(entry["transcript_hex"]), entry["bits"], device="cpu") == entry["witness"]
