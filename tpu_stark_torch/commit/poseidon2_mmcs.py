"""Poseidon2 Merkle MMCS + duplex challenger: the field-native commitment
stack (counterpart of ``tpu_stark/commit/poseidon2_mmcs.py``).

* leaf hash   = PaddingFreeSponge<Poseidon2_16, 16, 8, 8> over the row's
  field elements (rate-8 overwrite-absorb, permute per chunk, first 8 lanes);
* compression = TruncatedPermutation<Poseidon2_16, 2, 8, 16>:
  compress(l, r) = perm(l || r)[:8];
* digests     = 8 BabyBear elements: Monty (N, 8) int32 layers on the
  device, canonical ints on the host (roots, opened siblings, verifier);
* hiding      = 4 salt elements per row from the MMCS's SmallRng, hashed
  after the row values, as in the Keccak tree;
* challenger  = DuplexChallenger<Poseidon2_16, 16, 8>, host code.

The tree rules (heights, injection, salts, batched openings) are the Keccak
MMCS's (``merkle.MerkleTreeMmcs``); only the hash stack differs.  Unlike
the Keccak tree, rows hash as the Monty values themselves: the permutation
is field arithmetic, so Monty in gives the Monty form of the canonical
digest.  Every device layer is one launch of kernel K3.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..compat.native import p2_hash_row_native
from ..fields import babybear as bb
from ..hash import poseidon2, poseidon2_kernel
from ..hash.poseidon2_kernel import OUT, RATE, WIDTH
from .merkle import MerkleTreeMmcs

FieldDigest = Tuple[int, ...]  # 8 canonical ints


# ---------------------------------------------------------------------------
# Host primitives (transcript and per-query verification)
# ---------------------------------------------------------------------------
def hash_row_host(values: Sequence[int]) -> FieldDigest:
    vals = [int(v) % bb.P for v in values]
    if not vals:
        return tuple([0] * OUT)
    out = p2_hash_row_native(vals, *poseidon2.native_consts16())
    if out is not None:
        return out
    state = [0] * WIDTH
    for off in range(0, len(vals), RATE):
        for i, v in enumerate(vals[off : off + RATE]):
            state[i] = v
        state = poseidon2.permute_host(state)
    return tuple(state[:OUT])


def compress_host(left: Sequence[int], right: Sequence[int]) -> FieldDigest:
    state = [int(v) % bb.P for v in list(left) + list(right)]
    if len(state) != WIDTH:
        raise ValueError(f"compress takes two 8-element digests, got {len(state)} elements")
    return tuple(poseidon2.permute_host(state)[:OUT])


class Poseidon2Mmcs(MerkleTreeMmcs):
    """Field-native Merkle MMCS (p3 MerkleTreeMmcs over Poseidon2); the
    hiding variant salts rows from a persistent SmallRng like the Keccak
    MMCS."""

    @staticmethod
    def leaf_layer(mats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Hash the rows of the matrices (and salts) of one height, side by
        side; one or two operands go to K3 without a concatenated copy."""
        mats = list(mats)
        if len(mats) > 2:
            mats = [torch.cat(mats, dim=1)]
        return poseidon2_kernel.hash_rows(*mats)

    @staticmethod
    def compress_layer(digests: torch.Tensor) -> torch.Tensor:
        return poseidon2_kernel.compress(digests[0::2], digests[1::2])

    compress = staticmethod(poseidon2_kernel.compress)

    @staticmethod
    def fetch_digests(layer: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        return bb.to_u32(layer[rows])

    @staticmethod
    def host_digest(row: np.ndarray) -> FieldDigest:
        return tuple(int(v) for v in row)

    hash_row_host = staticmethod(hash_row_host)
    compress_host = staticmethod(compress_host)


# ---------------------------------------------------------------------------
# Duplex challenger (p3 DuplexChallenger shape), host code
# ---------------------------------------------------------------------------
class DuplexChallenger:
    """Observations buffer up to RATE elements, then overwrite the front of
    the state and permute; samples pop from the end of the squeezed rate
    window.  ``grind`` is the host search at any bit count, as in the JAX
    package; ``device`` is accepted for the config's factory call and not
    used."""

    def __init__(self, device=None):
        self.state = [0] * WIDTH
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []

    def _duplex(self) -> None:
        for i, v in enumerate(self.input_buffer):
            self.state[i] = v
        self.input_buffer.clear()
        self.state = poseidon2.permute_host(self.state)
        self.output_buffer = list(self.state[:RATE])

    def observe_u32(self, value: int) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(int(value) % bb.P)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_u32s(self, values: Sequence[int]) -> None:
        for v in values:
            self.observe_u32(v)

    def observe_commitment(self, digest: Sequence[int]) -> None:
        self.observe_u32s(list(digest))

    def sample_u32(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def sample_ext(self) -> Tuple[int, int, int, int]:
        return tuple(self.sample_u32() for _ in range(4))  # type: ignore[return-value]

    def sample_bits(self, bits: int) -> int:
        return self.sample_u32() & ((1 << bits) - 1)

    def clone(self) -> "DuplexChallenger":
        c = DuplexChallenger()
        c.state = list(self.state)
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe_u32(witness)
        return self.sample_bits(bits) == 0

    def grind(self, bits: int) -> int:
        """Smallest canonical witness passing ``check_witness``."""
        for w in range(bb.P):
            if self.clone().check_witness(bits, w):
                self.observe_u32(w)
                if self.sample_bits(bits) != 0:
                    raise RuntimeError("grind witness failed its own check")
                return w
        raise RuntimeError("grinding failed (unreachable)")
