"""Carry state from the JAX package into the port, through numpy only.

With these a test can commit with ``tpu_stark`` and open with
``tpu_stark_torch``, so each stage is compared on the same data.  The caller
pulls the JAX arrays with ``np.asarray``; nothing here imports jax.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..commit.merkle import ProverData
from ..commit.pcs import PcsProverData
from ..compat.smallrng import SmallRng
from ..fields import babybear as bb
from ..fri.domains import TwoAdicCoset


def smallrng_from_state(words: Sequence[int]) -> SmallRng:
    """A SmallRng continuing from a copied Xoshiro256++ state (4 u64)."""
    return SmallRng([int(w) for w in words])


def prover_data_from_numpy(
    *,
    matrices: Sequence[np.ndarray],  # Monty uint32, bit-reversed LDE rows
    salts,  # None or Sequence[np.ndarray] Monty uint32
    layers: Sequence[np.ndarray],  # (N_l, 4, 2) uint32, leaf layer first
    root: Tuple[int, int, int, int],
    r_coeffs: Sequence[np.ndarray],  # Monty uint32 plain-frame coefficients
    domains: Sequence[Tuple[int, int]],  # (log_n, shift) per matrix
    widths: Sequence[int],
    device="cpu",
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
