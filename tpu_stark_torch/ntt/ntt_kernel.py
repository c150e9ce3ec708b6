"""K2: the fused-stage radix-2 DIT NTT (kernel ``csrc/ntt.cu``).

``dft(x, inverse)`` takes an (h, w) int32 Monty matrix with natural-order
rows and returns the unscaled transform of every column, natural order:
out[i] = sum_j x[j] * g^(i*j), g the order-h root (or its inverse).  It is
the DIT of the bit-reversed rows, split into passes:

* pass 0 reads the rows in bit-reversed order and runs stages 0..k0-1
  (replaces ``tpu_stark/ntt/pallas_ntt.py::_pass0_kernel``);
* each later pass runs stages s0..s0+k-1 in place
  (replaces ``tpu_stark/ntt/pallas_ntt.py::_pass_kernel``).

``plan`` splits the log_h stages into as few passes as a block's tile
allows, evenly.  A tile is 2^k positions x 2^lanes_log words, at most
2^TILE_LOG words (64 KB, three blocks to an H100 SM): 32-word (128-byte)
rows for w >= 8, so k <= 9, and 16-word rows for narrower matrices, k <= 10.
A row is ``2^lanes_log`` columns of a column tile (``col_tiles`` of them,
splitting the columns evenly) when w is wider, else 2^g_log (pass 0) or
2^j_log (later passes) adjacent rows of every column.  On the H100 three
passes of 128-byte rows beat two passes of 2^11-row tiles, which fit only
with narrower rows or one block per SM, so config 4's (2^21, 128) chunk LDE
takes three passes, as before, each several times faster (PERF.md has the
times and the variants that lost).  Inside a block each thread runs 3-5
stages in registers between shared-memory exchanges (``csrc/ntt.cu``).

Twiddles are one table of Montgomery forms: stage s holds w_{2^(s+1)}^e at
offset 2^s - 1 + e (the values of ``tpu_stark/ntt/radix2.py::
_stage_twiddles_np``, times 2^32 mod p); the table for a larger size
extends the one for a smaller size, so one table per (device, direction)
serves every size.  A later pass's kernel builds each twiddle as
w_{2^(l+1)}^t' * w_{2^(s0+l+1)}^j from two entries of it.

``pass0_plain`` / ``pass_plain`` are the plain torch versions of the two
passes, over the same plan and table.  The wrapper runs them only for CPU
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

LANES_LOG = 5  # log2 u32 words per tile row: one 128-byte line
NARROW_LANES_LOG = 4  # the same for w < 8: 64 bytes, 2^j_log rows of 2-7 columns
TILE_LOG = 14  # log2 words of a block's tile: 64 KB, three blocks to an SM
SMEM_LIMIT = 227 * 1024  # bytes of shared memory one H100 block may use
_ROUNDS = {4: 3, 2: 4, 1: 5}  # vector lanes -> stages a thread runs in registers


@dataclasses.dataclass(frozen=True)
class Plan:
    lanes_log: int  # log2 words per tile row
    col_tiles: int  # column tiles per row block (1 when w <= 2^lanes_log)
    k0: int  # stages of pass 0
    g_log: int  # log2 adjacent source rows per pass-0 tile row
    passes: Tuple[Tuple[int, int, int], ...]  # (s0, k, j_log) per later pass


def plan(log_h: int, w: int) -> Plan:
    """Passes of at most as many stages as a 2^TILE_LOG-word tile holds, as
    even as possible, pass 0 the largest."""
    lanes_log = LANES_LOG if w >= 8 else NARROW_LANES_LOG
    return split(log_h, w, lanes_log, TILE_LOG - lanes_log)


def split(log_h: int, w: int, lanes_log: int, max_stages: int) -> Plan:
    """The even split of log_h stages into passes of at most ``max_stages``
    on tile rows of 2^lanes_log words (``plan``'s choice of both, or an
    alternative to time against it)."""
    lanes = 1 << lanes_log
    n = max(1, -(-log_h // max_stages))
    ks = [log_h // n + (i < log_h % n) for i in range(n)]
    rows_log = (lanes // w).bit_length() - 1 if w < lanes else 0
    passes = []
    s0 = ks[0]
    for k in ks[1:]:
        passes.append((s0, k, min(rows_log, s0)))
        s0 += k
    return Plan(lanes_log, -(-w // lanes), ks[0], min(rows_log, log_h - ks[0]), tuple(passes))


def smem_bytes(k: int, lanes_log: int, j_log: int, v: int) -> int:
    """Shared memory of one block (as ``ts_ntt_pass`` sizes it)."""
    def up4(n):
        return (n + 3) & ~3

    tile = (1 << (k + lanes_log)) if k > _ROUNDS[v] else 0
    return 4 * (up4(1 << k) + up4(k << j_log) + tile)


_TWIDDLES: Dict[Tuple[str, bool], Tuple[int, torch.Tensor]] = {}


def twiddles_np(log_h: int, inverse: bool) -> np.ndarray:
    """Montgomery forms of w_{2^(s+1)}^e for s < log_h, stage s at 2^s - 1."""
    ws = []
    for s in range(log_h):
        root = bb.two_adic_generator(s + 1)
        if inverse:
            root = pow(root, bb.P - 2, bb.P)
        ws.append(bb.np_powers(root, 1 << s))
    return bb.np_to_monty(np.concatenate(ws))


def stage_twiddles(log_h: int, inverse: bool, device) -> torch.Tensor:
    """The twiddle table (int32) on ``device``, covering stages
    0..log_h-1 (possibly more)."""
    key = (str(torch.device(device)), bool(inverse))
    hit = _TWIDDLES.get(key)
    if hit is None or hit[0] < log_h:
        hit = (log_h, bb.to_tensor(twiddles_np(log_h, inverse), device))
        _TWIDDLES[key] = hit
    return hit[1]


def _stage_plain(x: torch.Tensor, s: int, tw) -> torch.Tensor:
    h, w = x.shape
    m = 1 << s
    y = x.view(h // (2 * m), 2, m, w)
    lo, hi = y[:, 0], y[:, 1]
    if s:
        hi = bb.mul(hi, tw[m - 1 : 2 * m - 1].view(1, m, 1))
    return torch.stack([bb.add(lo, hi), bb.sub(lo, hi)], dim=1).reshape(h, w)


def pass0_plain(x: torch.Tensor, k: int, tw) -> torch.Tensor:
    """Stages 0..k-1 of the bit-reversed rows of x."""
    x = reverse_matrix_index_bits(x)
    for s in range(k):
        x = _stage_plain(x, s, tw)
    return x


def pass_plain(x: torch.Tensor, s0: int, k: int, tw) -> torch.Tensor:
    """Stages s0..s0+k-1 of x."""
    for s in range(s0, s0 + k):
        x = _stage_plain(x, s, tw)
    return x


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"ntt: unsupported device {x.device}")
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise TypeError("ntt takes a contiguous 2-D int32 Monty matrix")


def vector_lanes(w: int, *tensors: torch.Tensor) -> int:
    """Words per vector access: 4 (16-byte) or 2 (8-byte) where the row
    length and every pointer allow it, else 1 (the scalar path)."""
    for v in (4, 2):
        if w % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in tensors):
            return v
    return 1


def _launch(info, x_in, out, s0: int, k: int, j_log: int, p: Plan, tw) -> None:
    h, w = out.shape
    v = vector_lanes(w, x_in, out)
    info.launches += 1
    kernels.check(
        kernels.lib().ts_ntt_pass(
            x_in.data_ptr(), out.data_ptr(), w, log2_strict(h), s0, k, p.lanes_log,
            j_log, p.col_tiles, v, tw.data_ptr(), kernels.stream_handle(out.device),
        ),
        f"ntt pass s0={s0}",
    )


def pass0(x: torch.Tensor, p: Plan, tw) -> torch.Tensor:
    """Pass 0 into a new tensor (kernel on CUDA, plain on CPU)."""
    if x.device.type == "cpu":
        return pass0_plain(x, p.k0, tw)
    x = x.contiguous()
    _check_cuda(x)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    _launch(kernels.NTT_PASS0, x, out, 0, p.k0, p.g_log, p, tw)
    return out


def run_pass(x: torch.Tensor, s0: int, k: int, j_log: int, p: Plan, tw) -> torch.Tensor:
    """A later pass (kernel in place on CUDA, plain on CPU)."""
    if x.device.type == "cpu":
        return pass_plain(x, s0, k, tw)
    _check_cuda(x)
    _launch(kernels.NTT_PASS, x, x, s0, k, j_log, p, tw)
    return x


def dft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Unscaled NTT of every column, natural order in and out (new tensor)."""
    h, w = x.shape
    log_h = log2_strict(int(h))
    if log_h == 0 or w == 0:
        return x.clone()
    tw = stage_twiddles(log_h, inverse, x.device)
    p = plan(log_h, int(w))
    out = pass0(x, p, tw)
    for s0, k, j_log in p.passes:
        out = run_pass(out, s0, k, j_log, p, tw)
    return out


def dft_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """``dft`` through the plain passes on any device (the kernel's
    reference on the card)."""
    h, w = x.shape
    log_h = log2_strict(int(h))
    if log_h == 0 or w == 0:
        return x.clone()
    tw = stage_twiddles(log_h, inverse, x.device)
    p = plan(log_h, int(w))
    out = pass0_plain(x, p.k0, tw)
    for s0, k, _j_log in p.passes:
        out = pass_plain(out, s0, k, tw)
    return out
