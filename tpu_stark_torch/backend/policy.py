"""The device policy (counterpart of ``tpu_stark/backend/policy.py``): one
frozen description of the card a process runs on, from
``torch.cuda.get_device_properties``, and the gates the port's kernels and
routes apply to it.

The gates are read from the modules that own them, never copied: the
narrow-NTT route's ``radix2.NARROW_MAX_W`` / ``NARROW_MIN_LOG_H`` and K2's
tile and shared-memory limits ``ntt_kernel.TILE_LOG`` / ``SMEM_LIMIT``.
The JAX policy's VMEM budgets, its tunnel flag and its FRI host tail are
TPU workarounds and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import platform
from typing import Optional, Tuple

import torch

from ..ntt import ntt_kernel, radix2

KERNEL_CAPABILITY = (9, 0)  # the kernels are built for sm_90a


@dataclasses.dataclass(frozen=True)
class DevicePolicy:
    platform: str  # "cuda" | "cpu"
    name: str  # torch.cuda.get_device_name, or the CPU's machine type
    num_devices: int
    sm_count: Optional[int] = None
    total_memory: Optional[int] = None  # bytes
    capability: Optional[Tuple[int, int]] = None
    smem_per_block: Optional[int] = None  # bytes a block may opt in to

    @property
    def ntt_narrow_max_w(self) -> int:
        return radix2.NARROW_MAX_W

    @property
    def ntt_narrow_min_logh(self) -> int:
        return radix2.NARROW_MIN_LOG_H

    @property
    def ntt_tile_log(self) -> int:
        return ntt_kernel.TILE_LOG

    @property
    def ntt_smem_limit(self) -> int:
        return ntt_kernel.SMEM_LIMIT

    @property
    def runs_kernels(self) -> bool:
        """Whether the hand-written kernels can run here: an sm_90 card
        whose blocks may take K2's shared memory."""
        return (
            self.platform == "cuda"
            and self.capability == KERNEL_CAPABILITY
            and (self.smem_per_block or 0) >= self.ntt_smem_limit
        )


@functools.cache
def _policy(dev: torch.device) -> DevicePolicy:
    if dev.type != "cuda":
        return DevicePolicy(platform="cpu", name=platform.machine() or "cpu", num_devices=1)
    p = torch.cuda.get_device_properties(dev)
    return DevicePolicy(
        platform="cuda",
        name=str(p.name),
        num_devices=torch.cuda.device_count(),
        sm_count=int(p.multi_processor_count),
        total_memory=int(p.total_memory),
        capability=(int(p.major), int(p.minor)),
        smem_per_block=getattr(p, "shared_memory_per_block_optin", None),
    )


def current_policy(device=None) -> DevicePolicy:
    """The policy of ``device`` (cached: the hardware is fixed for a
    process's life).  With None: the first card when there is one, else
    the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _policy(dev)


def describe(device=None) -> str:
    """One-line policy report (the bench harness's first line)."""
    p = current_policy(device)
    gates = (
        f"ntt tile 2^{p.ntt_tile_log} words, smem limit {p.ntt_smem_limit >> 10} KiB, "
        f"narrow_w<={p.ntt_narrow_max_w}@h>=2^{p.ntt_narrow_min_logh}"
    )
    if p.platform != "cuda":
        return f"policy: {p.name} (cpu, {os.cpu_count()} threads), kernels' plain versions; {gates}"
    smem = f"{p.smem_per_block >> 10} KiB" if p.smem_per_block else "?"
    return (
        f"policy: {p.name} x{p.num_devices} (cuda, sm_{p.capability[0]}{p.capability[1]}, "
        f"{p.sm_count} SMs, {p.total_memory / 2**30:.1f} GiB, smem/block {smem}, "
        f"kernels {'yes' if p.runs_kernels else 'no'}); {gates}"
    )


def card_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    import subprocess

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read (nvidia-smi failed)"
