"""K2: the fused-stage radix-2 DIT NTT (kernel ``csrc/ntt.cu``).

``dft(x, inverse)`` takes an (h, w) int32 Monty matrix with natural-order
rows and returns the unscaled transform of every column, natural order:
out[i] = sum_j x[j] * g^(i*j), g the order-h root (or its inverse).  It is
the DIT of the bit-reversed rows, split into passes:

* pass 0 reads the rows in bit-reversed order and runs stages 0..k0-1
  (replaces ``tpu_stark/ntt/pallas_ntt.py::_pass0_kernel``);
* each later pass runs stages s0..s0+k-1 in place
  (replaces ``tpu_stark/ntt/pallas_ntt.py::_pass_kernel``).

``plan`` sizes the passes so a block's tile fits ``SMEM_WORDS`` of shared
memory at any width: columns are tiled by at most ``MAX_WC``, and a narrow
matrix gets several tiles (pass 0) or stride offsets (later passes) per
block, so that a warp still reads whole 128-byte lines.  On the H100 each
pass is one HBM round trip of the matrix and the butterflies are far below
the ALU roof, so the design's aim is few passes: 8 stages per pass, which
makes a 2^23-row transform three passes instead of 23 stages.  Each pass
runs at about a tenth of the HBM roof so far (PERF.md).

Twiddles are the tables of ``tpu_stark/ntt/radix2.py::_stage_twiddles_np``
(canonical w_{2^(s+1)}^p and Shoup companions), concatenated so stage s
starts at offset 2^s - 1; the table for a larger size extends the one for a
smaller size, so one table per (device, direction) serves every size.

``pass0_plain`` / ``pass_plain`` are the plain torch versions of the two
passes, over the same plan and tables.  The wrapper runs them only for CPU
tensors; for a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .. import kernels
from ..fields import babybear as bb
from ..matrix import log2_strict, reverse_matrix_index_bits

SMEM_WORDS = 8192  # u32 words of one block's tile (32 KiB)
MAX_WC = 32  # columns per block
LINE_WORDS = 32  # a 128-byte line


def _ceil_log2(n: int) -> int:
    return (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Plan:
    wc: int  # columns per block
    k0: int  # stages of pass 0
    g_log: int  # log2 tiles per pass-0 block
    passes: Tuple[Tuple[int, int, int], ...]  # (s0, k, j_log) per later pass


def plan(log_h: int, w: int) -> Plan:
    wc = min(w, MAX_WC)
    lb = (SMEM_WORDS // wc).bit_length() - 1  # log2 rows a tile can hold
    g_want = max(0, _ceil_log2(LINE_WORDS) - _ceil_log2(wc))
    k0 = min(log_h, lb - g_want)
    g_log = min(g_want, log_h - k0)
    passes = []
    s0 = k0
    while s0 < log_h:
        j_log = min(g_want, s0)
        k = min(log_h - s0, lb - j_log)
        passes.append((s0, k, j_log))
        s0 += k
    return Plan(wc, k0, g_log, tuple(passes))


_TWIDDLES: Dict[Tuple[str, bool], Tuple[int, torch.Tensor, torch.Tensor]] = {}


def _twiddles_np(log_h: int, inverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    ws = []
    for s in range(log_h):
        root = bb.two_adic_generator(s + 1)
        if inverse:
            root = pow(root, bb.P - 2, bb.P)
        ws.append(bb.np_powers(root, 1 << s))
    w = np.concatenate(ws)
    return w, bb.np_shoup(w)


def stage_twiddles(log_h: int, inverse: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tw, twp) int32 tensors on ``device`` covering stages 0..log_h-1
    (possibly more); twp holds the u32 Shoup companions' bits."""
    key = (str(torch.device(device)), bool(inverse))
    hit = _TWIDDLES.get(key)
    if hit is None or hit[0] < log_h:
        w, wp = _twiddles_np(log_h, inverse)
        hit = (log_h, bb.to_tensor(w, device), bb.to_tensor(wp, device))
        _TWIDDLES[key] = hit
    return hit[1], hit[2]


def _stage_plain(x: torch.Tensor, s: int, tw, twp) -> torch.Tensor:
    h, w = x.shape
    m = 1 << s
    y = x.view(h // (2 * m), 2, m, w)
    lo, hi = y[:, 0], y[:, 1]
    if s:
        w_s = tw[m - 1 : 2 * m - 1].view(1, m, 1)
        wp_s = (twp[m - 1 : 2 * m - 1].to(torch.int64) & 0xFFFFFFFF).view(1, m, 1)
        hi = bb.shoup_mul(hi, w_s, wp_s)
    return torch.stack([bb.add(lo, hi), bb.sub(lo, hi)], dim=1).reshape(h, w)


def pass0_plain(x: torch.Tensor, k: int, tw, twp) -> torch.Tensor:
    """Stages 0..k-1 of the bit-reversed rows of x."""
    x = reverse_matrix_index_bits(x)
    for s in range(k):
        x = _stage_plain(x, s, tw, twp)
    return x


def pass_plain(x: torch.Tensor, s0: int, k: int, tw, twp) -> torch.Tensor:
    """Stages s0..s0+k-1 of x."""
    for s in range(s0, s0 + k):
        x = _stage_plain(x, s, tw, twp)
    return x


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"ntt: unsupported device {x.device}")
    if x.dtype != torch.int32 or x.dim() != 2:
        raise TypeError("ntt takes a 2-D int32 Monty matrix")


def pass0(x: torch.Tensor, p: Plan, tw, twp) -> torch.Tensor:
    """Pass 0 into a new tensor (kernel on CUDA, plain on CPU)."""
    if x.device.type == "cpu":
        return pass0_plain(x, p.k0, tw, twp)
    _check_cuda(x)
    x = x.contiguous()
    h, w = x.shape
    out = torch.empty_like(x)
    so = kernels.lib()
    kernels.NTT_PASS0.launches += 1
    kernels.check(
        so.ts_ntt_pass0(
            x.data_ptr(), out.data_ptr(), w, log2_strict(h), p.k0, p.g_log, p.wc,
            tw.data_ptr(), twp.data_ptr(), kernels.stream_handle(x.device),
        ),
        "ntt pass 0",
    )
    return out


def run_pass(x: torch.Tensor, s0: int, k: int, j_log: int, p: Plan, tw, twp) -> torch.Tensor:
    """A later pass (kernel in place on CUDA, plain on CPU)."""
    if x.device.type == "cpu":
        return pass_plain(x, s0, k, tw, twp)
    _check_cuda(x)
    if not x.is_contiguous():
        raise ValueError("ntt pass runs in place on a contiguous matrix")
    h, w = x.shape
    so = kernels.lib()
    kernels.NTT_PASS.launches += 1
    kernels.check(
        so.ts_ntt_pass(
            x.data_ptr(), w, log2_strict(h), s0, k, j_log, p.wc,
            tw.data_ptr(), twp.data_ptr(), kernels.stream_handle(x.device),
        ),
        "ntt pass",
    )
    return x


def dft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Unscaled NTT of every column, natural order in and out (new tensor)."""
    h, w = x.shape
    log_h = log2_strict(int(h))
    if log_h == 0 or w == 0:
        return x.clone()
    tw, twp = stage_twiddles(log_h, inverse, x.device)
    p = plan(log_h, int(w))
    out = pass0(x, p, tw, twp)
    for s0, k, j_log in p.passes:
        out = run_pass(out, s0, k, j_log, p, tw, twp)
    return out


def dft_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """``dft`` through the plain passes on any device (the kernel's
    reference on the card)."""
    h, w = x.shape
    log_h = log2_strict(int(h))
    if log_h == 0 or w == 0:
        return x.clone()
    tw, twp = stage_twiddles(log_h, inverse, x.device)
    p = plan(log_h, int(w))
    out = pass0_plain(x, p.k0, tw, twp)
    for s0, k, _j_log in p.passes:
        out = pass_plain(out, s0, k, tw, twp)
    return out
