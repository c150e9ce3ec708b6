"""``Dft`` — the TwoAdicSubgroupDft facade (counterpart of
``tpu_stark/ntt/dft.py``), pinned to one device.

Unlike the JAX facade it has no backend registry and no fallback: a matrix
on another device than the facade's is an error, and a kernel failure
propagates.  CPU tensors run the kernels' plain torch versions.
``narrow="mxu"`` sends tall narrow transforms to the limb-matmul NTT (kernel
K5, see ``radix2``); ``None`` keeps every transform on K2.
"""

from __future__ import annotations

import torch

from . import radix2


class Dft:
    def __init__(self, device="cuda", narrow=None):
        if narrow not in radix2.NARROW_ROUTES:
            raise ValueError(f"unknown narrow NTT route {narrow!r}")
        self.device = torch.device(device)
        self.narrow = narrow

    def _on_device(self, mat: torch.Tensor) -> torch.Tensor:
        if mat.device.type != self.device.type or (
            self.device.index is not None and mat.device.index != self.device.index
        ):
            raise ValueError(f"Dft on {self.device} got a matrix on {mat.device}")
        return mat

    def dft_batch(self, mat: torch.Tensor) -> torch.Tensor:
        return radix2.dft_batch(self._on_device(mat), self.narrow)

    def idft_batch(self, mat: torch.Tensor) -> torch.Tensor:
        return radix2.idft_batch(self._on_device(mat), self.narrow)

    def coset_dft_batch(self, mat: torch.Tensor, shift: int) -> torch.Tensor:
        return radix2.coset_dft_batch(self._on_device(mat), shift, self.narrow)

    def coset_idft_batch(self, mat: torch.Tensor, shift: int) -> torch.Tensor:
        return radix2.coset_idft_batch(self._on_device(mat), shift, self.narrow)

    def coset_lde_batch(self, mat: torch.Tensor, added_bits: int, shift: int = 1) -> torch.Tensor:
        return radix2.coset_lde_batch(self._on_device(mat), added_bits, shift, self.narrow)

    def lde_batch(self, mat: torch.Tensor, added_bits: int) -> torch.Tensor:
        return self.coset_lde_batch(mat, added_bits, 1)
