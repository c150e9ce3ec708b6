"""K3: the batched Poseidon2-16 sponge (Merkle leaf and compress layers).

``hash_rows(a, b)`` computes PaddingFreeSponge<Poseidon2_16, 16, 8, 8> over
each row of ``a`` (N, ka) followed by the same row of ``b`` (N, kb), Monty
int32 in and out: each rate-8 chunk overwrites the front of the state (a
final partial chunk only its own lanes) and the permutation runs after every
chunk.  ``compress(left, right)`` is TruncatedPermutation: the first 8 lanes
of the permutation of left || right, i.e. the same sponge with one rate-16
chunk.  Out: (N, 8) Monty int32.

Replaces ``tpu_stark/hash/pallas_poseidon2.py::_sponge_kernel`` (wrappers
``hash_rows`` and ``compress``).  On the H100 the kernel
(``csrc/poseidon2_sponge.cu``) is integer-ALU bound: one thread per row
holds the 16-lane state in registers and runs ~800 Montgomery products per
permutation.  It takes any N and any width (no tile padding and no
transposed copy, which the Pallas kernel needed), reads rows through their
strides, so a compress of a layer's even and odd rows copies nothing.

K4: ``absorb_rows(state, chunk, first)`` continues that sponge over a
further column chunk of the rows: state (N, 16) Monty int32, updated in
place (the Pallas kernel aliases its state the same way), chunk (N, k) Monty
rows, possibly strided; ``first`` starts from the zero state.  Each rate-8
block of the chunk overwrites the front state lanes (a final partial block
only its own lanes) and is permuted.  So a ragged chunk (k not a multiple of
8) must be the last of the row: ``prover/wide.py::P2RowStream`` carries a
partial block over to the next chunk.  Replaces
``tpu_stark/hash/pallas_poseidon2.py::_absorb_kernel`` (kernel
``p2_absorb_kernel`` in ``csrc/poseidon2_sponge.cu``).

``hash_rows_plain``, ``compress_plain`` and ``absorb_rows_plain`` are the
plain torch versions.  The wrappers run them only for CPU tensors; for a
CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .poseidon2 import permute_plain

WIDTH = 16
RATE = 8
OUT = 8


def hash_rows_plain(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    rows = a if b is None else torch.cat([a, b], dim=1)
    n, k = rows.shape
    if k == 0:
        raise ValueError("empty sponge input")
    st = torch.zeros((n, WIDTH), dtype=torch.int32, device=rows.device)
    for off in range(0, k, RATE):
        chunk = rows[:, off : off + RATE]
        st[:, : chunk.shape[1]] = chunk
        st = permute_plain(st)
    return st[:, :OUT].contiguous()


def compress_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    return permute_plain(torch.cat([left, right], dim=1))[:, :OUT].contiguous()


def absorb_rows_plain(state: torch.Tensor, chunk: torch.Tensor, first: bool = False) -> torch.Tensor:
    st = torch.zeros_like(state) if first else state.clone()
    for off in range(0, int(chunk.shape[1]), RATE):
        blk = chunk[:, off : off + RATE]
        st[:, : blk.shape[1]] = blk
        st = permute_plain(st)
    state.copy_(st)
    return state


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """A 2-D int32 operand whose columns are contiguous (rows may stride)."""
    if t.dtype != torch.int32:
        raise TypeError(f"poseidon2 sponge: {name} must be int32 Monty rows")
    if t.dim() != 2:
        raise ValueError(f"poseidon2 sponge: {name} must be 2-D, got {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        t = t.contiguous()
    return t


def _launch(a: torch.Tensor, b: Optional[torch.Tensor], rate: int) -> torch.Tensor:
    if a.device.type != "cuda":
        raise ValueError(f"poseidon2 sponge: unsupported device {a.device}")
    a = _rows(a, "a")
    n, ka = a.shape
    kb = 0
    if b is not None:
        b = _rows(b, "b")
        if b.device != a.device or b.shape[0] != n:
            raise ValueError("poseidon2 sponge: left and right rows disagree")
        kb = int(b.shape[1])
    if ka + kb == 0:
        raise ValueError("empty sponge input")
    out = torch.empty((n, OUT), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    so = kernels.lib()
    kernels.POSEIDON2_SPONGE.launches += 1
    kernels.check(
        so.ts_poseidon2_rows(
            a.data_ptr(), a.stride(0), ka,
            None if b is None else b.data_ptr(), 0 if b is None else b.stride(0), kb,
            n, rate, out.data_ptr(), kernels.stream_handle(a.device),
        ),
        "poseidon2 sponge",
    )
    return out


def hash_rows(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, ka) [+ (N, kb)] Monty int32 rows -> (N, 8) Monty digests."""
    if a.device.type == "cpu":
        return hash_rows_plain(a, b)
    return _launch(a, b, RATE)


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (N, 8) Monty digests -> (N, 8)."""
    if left.shape[1] != OUT or right.shape[1] != OUT:
        raise ValueError("poseidon2 compress takes (N, 8) digests")
    if left.device.type == "cpu":
        return compress_plain(left, right)
    return _launch(left, right, WIDTH)


def absorb_rows(state: torch.Tensor, chunk: torch.Tensor, first: bool = False) -> torch.Tensor:
    """Absorb the (N, k) Monty rows of ``chunk`` into the (N, 16) sponge
    states, in place; returns ``state``."""
    if state.dim() != 2 or state.shape[1] != WIDTH or chunk.dim() != 2 or chunk.shape[0] != state.shape[0]:
        raise ValueError(f"poseidon2 absorb: state {tuple(state.shape)} and chunk {tuple(chunk.shape)}")
    if chunk.shape[1] == 0:
        raise ValueError("empty sponge input")
    if state.device.type == "cpu":
        return absorb_rows_plain(state, chunk, first)
    if state.device.type != "cuda" or chunk.device != state.device:
        raise ValueError(f"poseidon2 absorb: unsupported devices {state.device}, {chunk.device}")
    if state.dtype != torch.int32 or not state.is_contiguous():
        raise ValueError("poseidon2 absorb: the state must be a contiguous int32 tensor (updated in place)")
    chunk = _rows(chunk, "chunk")
    n, k = chunk.shape
    if n == 0:
        return state
    so = kernels.lib()
    kernels.POSEIDON2_ABSORB.launches += 1
    kernels.check(
        so.ts_poseidon2_absorb(
            state.data_ptr(), chunk.data_ptr(), chunk.stride(0), k, n, int(bool(first)),
            kernels.stream_handle(state.device),
        ),
        "poseidon2 absorb",
    )
    return state
