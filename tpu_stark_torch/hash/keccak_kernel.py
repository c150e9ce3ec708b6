"""K1: the batched Keccak sponge (Merkle leaf and compress layers).

``hash_rows(a, b)`` computes PaddingFreeSponge<Keccak-f[1600], 25, 17, 4>
over each row of ``a`` (N, ka) followed by the same row of ``b`` (N, kb),
as the JAX package's ``sponge.hash_field_rows_batched`` does over one
concatenated (N, ka + kb) u32 matrix: u32 pairs form little-endian u64
items, each rate-17 chunk overwrites the front of the state, and the
permutation runs after every chunk.  Out: (N, 4, 2) int32 = 4 u64 words as
[lo, hi] (the same bits as JAX's uint32 digests).

``compress_levels(digests, levels)`` returns the ``levels`` Merkle layers
above a contiguous (N, 4, 2) layer, N a power of two: layer l is
(N / 2^l, 4, 2), its row i the compress (the hash of the 16 words) of rows
2i and 2i + 1 of layer l - 1.

Both replace ``tpu_stark/hash/pallas_keccak.py::_sponge_kernel`` (wrappers
``hash_field_rows`` and ``compress_digests``).  On the H100 the kernels
(``csrc/keccak_sponge.cu``) are bound by the ALU pipe, where LOP3 and the
funnel shift run: one thread per row holds the 25 lanes as u32 halves and
runs a round in the least count of those.  ``hash_rows`` takes any N (no
tile padding, which the Pallas kernel needed) and any width, and a
compress of two 8-word operands reads both directly (other splits, which
only the tests pass, are concatenated first).  ``compress_levels`` builds a tree's layers in a few
launches of the tree kernel (``tree_plan``): a block compresses a subtree
through shared memory and writes every level to its layer.

``absorb_rows(state, mat, first, pend)`` continues the sponge of each row
over more of its words: the pending words ``pend`` (N, p), p < 34, then
``mat`` (N, k), p + k a multiple of 34 (whole rate blocks), into a carried
(50, N) int32 state, lane-major (word 2l + h of lane l at row 2l + h: lo,
then hi), updated in place; ``first`` starts from the zero state.
``finalize_rows(state, pend)`` absorbs the last partial block (p < 34
words, an odd one with a zero high half), permutes when p > 0, and returns
the (N, 4, 2) digests, the state untouched.  Together they give
``hash_rows`` of the whole rows.  Kernel ``keccak_absorb_kernel`` (same
file); it replaces the JAX package's XLA absorb
``tpu_stark/hash/sponge.py::_absorb_full_blocks``, which has no Pallas
kernel, so that the streamed commit hashes on the card.

``hash_rows_plain``, ``compress_levels_plain``, ``absorb_rows_plain`` and
``finalize_rows_plain`` are the plain torch versions: int64 lanes,
vectorized over rows.  The wrappers run them only for CPU tensors; for a
CUDA tensor they launch the kernels or raise.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .keccak import ROT, ROUND_CONSTANTS

RATE = 17
WIDTH = 25
OUT = 4

# rho + pi as a gather: destination lane j takes source lane _SRC[j],
# rotated left by _ROTJ[j]
_SRC = np.zeros(25, dtype=np.int64)
_ROTJ = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _j = _y + 5 * ((2 * _x + 3 * _y) % 5)
        _SRC[_j] = _x + 5 * _y
        _ROTJ[_j] = ROT[_x + 5 * _y]
_RC_SIGNED = [rc - (1 << 64) if rc >= 1 << 63 else rc for rc in ROUND_CONSTANTS]


_X_MINUS_1 = [4, 0, 1, 2, 3]
_X_PLUS_1 = [1, 2, 3, 4, 0]
_X_PLUS_2 = [2, 3, 4, 0, 1]


def keccak_f_plain(a: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] over an (N, 25) int64 lane tensor (lane x + 5y).
    Rotations shift left and mask the arithmetic right shift back to a
    logical one."""
    dev = a.device
    src = torch.from_numpy(_SRC).to(dev)
    rot = torch.from_numpy(_ROTJ).to(dev)
    rs = rot.clamp(min=1)
    mask = torch.tensor([(1 << int(r)) - 1 for r in rs], device=dev)
    xm1, xp1, xp2 = (torch.tensor(i, device=dev) for i in (_X_MINUS_1, _X_PLUS_1, _X_PLUS_2))
    n = a.shape[0]
    for rc in _RC_SIGNED:
        g = a.view(n, 5, 5)  # [y][x]
        c = g[:, 0] ^ g[:, 1] ^ g[:, 2] ^ g[:, 3] ^ g[:, 4]
        cp = c[:, xp1]
        d = c[:, xm1] ^ ((cp << 1) | ((cp >> 63) & 1))
        b = (g ^ d[:, None, :]).view(n, 25)[:, src]
        b = torch.where(rot == 0, b, (b << rs) | ((b >> (64 - rs)) & mask)).view(n, 5, 5)
        a = (b ^ (~b[:, :, xp1] & b[:, :, xp2])).view(n, 25)
        a[:, 0] ^= rc
    return a


def _items(row_u32: torch.Tensor) -> torch.Tensor:
    """(N, k) int32 u32 bits -> (N, ceil(k/2)) int64 items lo | hi << 32."""
    n, k = row_u32.shape
    if k % 2:
        row_u32 = torch.cat(
            [row_u32, torch.zeros((n, 1), dtype=torch.int32, device=row_u32.device)], 1
        )
    pairs = row_u32.to(torch.int64).view(n, -1, 2)
    return (pairs[..., 1] << 32) | (pairs[..., 0] & 0xFFFFFFFF)


def _digest_words(st: torch.Tensor) -> torch.Tensor:
    """(N, >=4) int64 lanes -> (N, 4, 2) int32 [lo, hi] of the first 4."""
    w = st[:, :OUT]
    lo = ((w & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    hi = w >> 32
    return torch.stack([lo, hi], dim=-1).to(torch.int32)


def hash_rows_plain(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    rows = a if b is None else torch.cat([a, b], dim=1)
    if rows.shape[1] == 0:
        raise ValueError("empty sponge input")
    items = _items(rows)
    n, n_items = items.shape
    st = torch.zeros((n, WIDTH), dtype=torch.int64, device=rows.device)
    for off in range(0, n_items, RATE):
        chunk = items[:, off : off + RATE]
        st[:, : chunk.shape[1]] = chunk
        st = keccak_f_plain(st)
    return _digest_words(st)


def hash_rows(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, ka) [+ (N, kb)] int32 rows -> (N, 4, 2) int32 digests."""
    if a.device.type == "cpu":
        return hash_rows_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"keccak sponge: unsupported device {a.device}")
    n, ka = a.shape
    kb = 0 if b is None else int(b.shape[1])
    if a.dtype != torch.int32 or (b is not None and b.dtype != torch.int32):
        raise TypeError("keccak sponge takes int32 (u32-bit) rows")
    if b is not None and (b.device != a.device or b.shape[0] != n):
        raise ValueError("keccak sponge: left and right rows disagree")
    if ka + kb == 0:
        raise ValueError("empty sponge input")
    if b is not None and (ka, kb) != (8, 8):  # the kernel reads two operands of a compress only
        a, b = torch.cat([a, b], dim=1), None
    a = a.contiguous()
    b = None if b is None else b.contiguous()
    out = torch.empty((n, OUT, 2), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    so = kernels.lib()
    kernels.KECCAK_SPONGE.launches += 1
    kernels.check(
        so.ts_keccak_rows(
            a.data_ptr(), int(a.shape[1]), None if b is None else b.data_ptr(), n,
            out.data_ptr(), kernels.stream_handle(a.device),
        ),
        "keccak sponge",
    )
    return out


BLOCK_WORDS = 2 * RATE  # u32 words of a rate block


def _state_lanes(state: torch.Tensor) -> torch.Tensor:
    """(50, N) int32 lane-major state -> (N, 25) int64 lanes."""
    s = state.to(torch.int64)
    return ((s[1::2] << 32) | (s[0::2] & 0xFFFFFFFF)).t().contiguous()


def absorb_rows_plain(state: torch.Tensor, mat: torch.Tensor, first: bool = False,
                      pend: Optional[torch.Tensor] = None) -> torch.Tensor:
    rows = mat if pend is None else torch.cat([pend, mat], dim=1)
    if rows.shape[1] % BLOCK_WORDS:
        raise ValueError(f"keccak absorb: {rows.shape[1]} words are not whole rate blocks")
    st = torch.zeros((rows.shape[0], WIDTH), dtype=torch.int64, device=rows.device) if first else _state_lanes(state)
    items = _items(rows)
    for off in range(0, items.shape[1], RATE):
        st[:, :RATE] = items[:, off : off + RATE]
        st = keccak_f_plain(st)
    lo = ((st & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    state[0::2] = lo.t().to(torch.int32)
    state[1::2] = (st >> 32).t().to(torch.int32)
    return state


def finalize_rows_plain(state: torch.Tensor, pend: Optional[torch.Tensor], first: bool = False) -> torch.Tensor:
    n = int(state.shape[1])
    st = torch.zeros((n, WIDTH), dtype=torch.int64, device=state.device) if first else _state_lanes(state)
    if pend is not None and pend.shape[1]:
        items = _items(pend)
        st[:, : items.shape[1]] = items
        st = keccak_f_plain(st)
    return _digest_words(st)


def _absorb_operands(state, mat, pend):
    """Check the absorb's operands on the card; returns (mat, pend) with
    contiguous columns (rows may stride)."""
    if state.device.type != "cuda":
        raise ValueError(f"keccak absorb: unsupported device {state.device}")
    if state.dtype != torch.int32 or not state.is_contiguous():
        raise ValueError("keccak absorb: the state must be a contiguous int32 tensor (updated in place)")
    n = int(state.shape[1])
    out = []
    for name, t in (("mat", mat), ("pend", pend)):
        if t is not None:
            if t.device != state.device or t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != n:
                raise ValueError(f"keccak absorb: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                                 f"against a state of {n} rows")
            if t.shape[1] > 1 and t.stride(1) != 1:
                t = t.contiguous()
        out.append(t)
    return out


def _absorb_launch(state, mat, pend, first, out) -> None:
    p, k = (0 if t is None else int(t.shape[1]) for t in (pend, mat))
    if int(state.shape[1]) == 0:
        return
    kernels.KECCAK_ABSORB.launches += 1
    kernels.check(
        kernels.lib().ts_keccak_absorb(
            state.data_ptr(), int(state.shape[1]),
            None if pend is None else pend.data_ptr(), p, 0 if pend is None else pend.stride(0),
            None if mat is None else mat.data_ptr(), k, 0 if mat is None else mat.stride(0),
            int(bool(first)), None if out is None else out.data_ptr(), kernels.stream_handle(state.device),
        ),
        "keccak absorb",
    )


def _check_state(state: torch.Tensor) -> None:
    if state.dim() != 2 or state.shape[0] != 2 * WIDTH:
        raise ValueError(f"keccak absorb: a state of shape {tuple(state.shape)}, not (50, N)")


def absorb_rows(state: torch.Tensor, mat: torch.Tensor, first: bool = False,
                pend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Absorb pend's then mat's words (whole rate blocks) into the (50, N)
    state, in place; returns ``state``."""
    _check_state(state)
    p = 0 if pend is None else int(pend.shape[1])
    if p >= BLOCK_WORDS or (p + int(mat.shape[1])) % BLOCK_WORDS:
        raise ValueError(f"keccak absorb: {p} pending and {int(mat.shape[1])} new words are not whole rate blocks")
    if state.device.type == "cpu":
        return absorb_rows_plain(state, mat, first, pend)
    mat, pend = _absorb_operands(state, mat, pend)
    _absorb_launch(state, mat, pend, first, None)
    return state


def finalize_rows(state: torch.Tensor, pend: Optional[torch.Tensor], first: bool = False) -> torch.Tensor:
    """(N, 4, 2) digests of the rows whose last p < 34 words are ``pend``."""
    _check_state(state)
    p = 0 if pend is None else int(pend.shape[1])
    if p >= BLOCK_WORDS:
        raise ValueError(f"keccak absorb: {p} pending words are more than a partial block")
    if first and p == 0:
        raise ValueError("empty sponge input")
    if state.device.type == "cpu":
        return finalize_rows_plain(state, pend, first)
    _, pend = _absorb_operands(state, None, pend)
    out = torch.empty((int(state.shape[1]), OUT, 2), dtype=torch.int32, device=state.device)
    _absorb_launch(state, None, pend, first, out)
    return out


# compress_levels' launch plan (tree_plan)
TOP_LOG = 8  # a group of at most 2^TOP_LOG digests a block, one permutation a thread a level
BAND_LEVELS = 5  # levels a band launch builds; its blocks keep 32 nodes (a full warp) at the top
BIG_LOG = 16  # layers of more than 2^BIG_LOG digests are built by band launches
MAX_SUB_LOG = BAND_LEVELS + 5  # a block's subtree, at most (the kernel's limit: 24 KB of shared memory)


def tree_plan(log_n: int, levels: int) -> List[Tuple[int, int]]:
    """The tree kernel's launches for the ``levels`` layers above 2^log_n
    digests, bottom first: (sub_log, lv) = each block compresses a subtree
    of 2^sub_log digests through lv levels.  Layers of more than 2^BIG_LOG
    digests go through bands of BAND_LEVELS levels (a subtree of
    2^(lv + 5) digests, 32 nodes at its top: no warp idles in part);
    then groups of TOP_LOG levels, each block a whole subtree of
    2^lv digests (one permutation a thread a level), the last one block."""
    if not 0 <= levels <= log_n:
        raise ValueError(f"keccak tree: {levels} levels above 2^{log_n} digests")
    plan = []
    while levels:
        if log_n > BIG_LOG:
            lv = min(BAND_LEVELS, log_n - BIG_LOG, levels)
            sub = lv + 5
        else:
            lv = sub = min(TOP_LOG, levels)
        plan.append((sub, lv))
        log_n -= lv
        levels -= lv
    return plan


def compress_levels_plain(digests: torch.Tensor, levels: int) -> List[torch.Tensor]:
    out = []
    for _ in range(levels):
        digests = hash_rows_plain(digests.reshape(-1, 2 * OUT * 2))
        out.append(digests)
    return out


def _tree_launch(src: torch.Tensor, n_in: int, sub_log: int, lv: int, out: torch.Tensor) -> None:
    """One launch of the tree kernel: levels 1..lv above the n_in digests
    at ``src`` into ``out`` (those layers one after another)."""
    kernels.KECCAK_TREE.launches += 1
    kernels.check(
        kernels.lib().ts_keccak_tree(src.data_ptr(), n_in, sub_log, lv, out.data_ptr(),
                                     kernels.stream_handle(src.device)),
        "keccak tree",
    )


def run_plan(digests: torch.Tensor, plan: List[Tuple[int, int]]) -> List[torch.Tensor]:
    """The layers above a contiguous (N, 4, 2) CUDA layer, built by the
    launches of ``plan`` (``tree_plan``'s form, each sub_log at most
    MAX_SUB_LOG), as views of one buffer."""
    n, levels = int(digests.shape[0]), sum(lv for _, lv in plan)
    out = torch.empty((n - (n >> levels), OUT, 2), dtype=torch.int32, device=digests.device)
    layers = [out[n - (n >> (l - 1)) : n - (n >> l)] for l in range(1, levels + 1)]
    src, n_in, done = digests, n, 0
    for sub_log, lv in plan:
        _tree_launch(src, n_in, sub_log, lv, layers[done])
        done += lv
        src, n_in = layers[done - 1], n_in >> lv
    return layers


def compress_levels(digests: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """The ``levels`` layers above an (N, 4, 2) int32 layer, N a power of
    two, 0 <= levels <= log2 N: layer l is (N / 2^l, 4, 2)."""
    n = int(digests.shape[0])
    if tuple(digests.shape[1:]) != (OUT, 2) or n < 1 or n & (n - 1):
        raise ValueError(f"keccak tree: a layer of shape {tuple(digests.shape)}")
    if not 0 <= levels < n.bit_length():
        raise ValueError(f"keccak tree: {levels} levels above {n} digests")
    if digests.device.type == "cpu":
        return compress_levels_plain(digests, levels)
    if digests.device.type != "cuda":
        raise ValueError(f"keccak tree: unsupported device {digests.device}")
    if digests.dtype != torch.int32:
        raise TypeError("keccak tree takes int32 (u32-bit) digests")
    return run_plan(digests.contiguous(), tree_plan(n.bit_length() - 1, levels))
