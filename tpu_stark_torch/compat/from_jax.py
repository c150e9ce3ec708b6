"""Carry state from the JAX package into the port, through numpy only.

With these a test can commit with ``tpu_stark`` and open with
``tpu_stark_torch``, so each stage is compared on the same data.  The caller
pulls the JAX arrays with ``np.asarray``; nothing here imports jax.  Like
the port's other entry points, both helpers put what they make on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..commit.merkle import ProverData
from ..commit.pcs import PcsProverData
from ..compat.device_rng import DeviceRng
from ..compat.smallrng import SmallRng
from ..fields import babybear as bb
from ..fri.domains import TwoAdicCoset


def smallrng_from_state(words: Sequence[int]) -> SmallRng:
    """A SmallRng continuing from a copied Xoshiro256++ state (4 u64)."""
    return SmallRng([int(w) for w in words])


def device_rng_from_state(key_words: Sequence[int], counter: int, device="cuda") -> DeviceRng:
    """A DeviceRng continuing a JAX ``DeviceRng`` from its key data
    (``jax.random.key_data(rng._key)``, two u32) and its call counter."""
    return DeviceRng.from_state((int(key_words[0]), int(key_words[1])), counter, device)


def prover_data_from_numpy(
    *,
    matrices: Sequence[np.ndarray],  # Monty uint32, bit-reversed LDE rows
    salts,  # None or Sequence[np.ndarray] Monty uint32
    layers: Sequence[np.ndarray],  # (N_l, 4, 2) uint32, leaf layer first
    root: Tuple[int, int, int, int],
    r_coeffs: Sequence[np.ndarray],  # Monty uint32 plain-frame coefficients
    domains: Sequence[Tuple[int, int]],  # (log_n, shift) per matrix
    widths: Sequence[int],
    device="cuda",
) -> PcsProverData:
    """The port's ``PcsProverData`` from a JAX ``PcsProverData``'s arrays."""

    def t(a: np.ndarray) -> torch.Tensor:
        return bb.to_tensor(np.asarray(a, dtype=np.uint32), device)

    merkle = ProverData(
        [t(m) for m in matrices],
        None if salts is None else [t(s) for s in salts],
        [t(l) for l in layers],
        tuple(int(w) for w in root),  # type: ignore[arg-type]
    )
    return PcsProverData(
        merkle,
        [t(r) for r in r_coeffs],
        [TwoAdicCoset(int(log_n), int(shift)) for log_n, shift in domains],
        [int(w) for w in widths],
    )


def keccak_stream_from_jax(
    lanes: Sequence[Tuple[np.ndarray, np.ndarray]],  # 25 (lo, hi) uint32 arrays of shape (n,)
    pend: Sequence[Tuple[np.ndarray, np.ndarray]],  # the pending u64 items as (lo, hi), fewer than 17
    half: Optional[np.ndarray],  # (n, 1) uint32: the first word of a split pair, or None
    device="cuda",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A JAX ``KeccakRowStream``'s carried state (``_state``, ``_pend``,
    ``_half``) as the port's: the lane-major (50, n) int32 state and the
    pending (n, p) int32 words (items as lo, hi pairs, then the split half),
    or None when nothing is pending."""
    words = [w for lo_hi in lanes for w in lo_hi]
    state = np.stack([np.asarray(w, dtype=np.uint32) for w in words]).view(np.int32)
    cols = [np.asarray(w, dtype=np.uint32).reshape(-1) for item in pend for w in item]
    if half is not None:
        cols.append(np.asarray(half, dtype=np.uint32).reshape(-1))
    pend_t = None
    if cols:
        pend_t = torch.from_numpy(np.ascontiguousarray(np.stack(cols, axis=1).view(np.int32))).to(device)
    return torch.from_numpy(np.ascontiguousarray(state)).to(device), pend_t