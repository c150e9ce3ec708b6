"""Fiat-Shamir transcript: HashChallenger + SerializingChallenger32
(counterpart of ``tpu_stark/challenger/challenger.py``), host code.

* ``HashChallenger`` (p3 ``HashChallenger<u8, Keccak256Hash, 32>``): an
  input and an output buffer; ``observe`` clears the output and appends to
  the input; ``sample`` refills by hashing the input when the output is
  empty (the digest becomes both buffers) and pops bytes from the end.
* ``Challenger`` (p3 ``SerializingChallenger32`` over BabyBear): observes
  canonical u32 and [u64; 4] commitments as little-endian bytes, samples by
  31-bit-masked rejection.

``grind`` is the scalar proof-of-work search, used below
``GRIND_DEVICE_MIN_BITS``; the device-batched search of
``tpu_stark/challenger/grind.py`` is not ported yet, so higher bit counts
raise instead of silently taking the host loop.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

from ..fields import babybear as bb
from ..hash.keccak import keccak256

_MASK31 = (1 << 31) - 1

# Where the JAX package switches to its device grind (challenger.py:153).
GRIND_DEVICE_MIN_BITS = 6


class HashChallenger:
    def __init__(self, initial: bytes = b""):
        self._input = bytearray(initial)
        self._output = bytearray()

    def observe_byte(self, b: int) -> None:
        self._output.clear()
        self._input.append(b & 0xFF)

    def observe_bytes(self, bs: bytes | Iterable[int]) -> None:
        self._output.clear()
        self._input.extend(bytes(bs))

    def _flush(self) -> None:
        digest = keccak256(bytes(self._input))
        self._input = bytearray(digest)
        self._output = bytearray(digest)

    def sample_byte(self) -> int:
        if not self._output:
            self._flush()
        return self._output.pop()

    def clone(self) -> "HashChallenger":
        c = HashChallenger()
        c._input = bytearray(self._input)
        c._output = bytearray(self._output)
        return c


class Challenger:
    def __init__(self, inner: HashChallenger | None = None):
        self.inner = inner if inner is not None else HashChallenger()

    def clone(self) -> "Challenger":
        return Challenger(self.inner.clone())

    def observe_u32(self, value: int) -> None:
        self.inner.observe_bytes(int(value).to_bytes(4, "little"))

    def observe_u32s(self, values: Sequence[int]) -> None:
        for v in values:
            self.observe_u32(int(v))

    def observe_commitment(self, digest: Tuple[int, int, int, int]) -> None:
        for w in digest:
            self.inner.observe_bytes(int(w).to_bytes(8, "little"))

    def sample_u32(self) -> int:
        while True:
            bs = bytes(self.inner.sample_byte() for _ in range(4))
            v = int.from_bytes(bs, "little") & _MASK31
            if v < bb.P:
                return v

    def sample_ext(self) -> Tuple[int, int, int, int]:
        return tuple(self.sample_u32() for _ in range(4))  # type: ignore[return-value]

    def sample_bits(self, bits: int) -> int:
        return self.sample_u32() & ((1 << bits) - 1)

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe_u32(witness)
        return self.sample_bits(bits) == 0

    def grind(self, bits: int) -> int:
        """Smallest canonical witness passing ``check_witness``."""
        if bits >= GRIND_DEVICE_MIN_BITS:
            raise NotImplementedError(
                f"device grind: later PR (proof_of_work_bits={bits})"
            )
        for w in range(bb.P):
            if self.clone().check_witness(bits, w):
                self.observe_u32(w)
                if self.sample_bits(bits) != 0:
                    raise RuntimeError("grind witness failed its own check")
                return w
        raise RuntimeError("grinding failed (unreachable)")
