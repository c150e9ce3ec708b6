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

``absorb_rows(state, mat, first, pend, monty, natural)`` continues the
sponge of each row over more of its words: the pending words ``pend`` (N,
p), p < 34, canonical, then ``mat`` (N, k): Montgomery forms with
``monty``, and with ``natural`` (which needs ``monty``) a codeword chunk in
natural row order as K2 leaves it (the tree's row r is its row bitrev(r)).  It absorbs the whole
rate blocks into a carried (50, N) int32 state, lane-major (word 2l + h of
lane l at row 2l + h: lo, then hi), updated in place (``first`` starts from
the zero state), and returns the words after them, canonical and in the
tree's order: the next call's pending words.  ``finalize_rows(state, pend,
first, mat, monty, natural)`` absorbs the rest, the last partial block
included (an odd word gets a zero high half), and returns the (N, 4, 2)
digests, the state untouched.  Together they give ``hash_rows`` of the
whole canonical rows in the tree's order.  Kernel
``keccak_absorb_kernel<FIN, REV, MONTY>`` (same file): one launch reads the
chunk as it lies (no bit-reversed copy, no int64 conversion) and writes the
pending words word-major; it replaces the JAX package's XLA absorb
``tpu_stark/hash/sponge.py::_absorb_full_blocks``, which has no Pallas
kernel, and the canonical bit-reversed copy the JAX commit feeds it.

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
from ..fields import babybear as bb
from ..matrix import reverse_matrix_index_bits
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


def _row_words(pend: Optional[torch.Tensor], mat: Optional[torch.Tensor], monty: bool,
               natural: bool) -> Optional[torch.Tensor]:
    """Each row's words as the absorb reads them: pend's, then mat's in the
    tree's row order (``natural``: a bit-reversed copy) and canonical form
    (``monty``: ``to_u32``)."""
    if mat is not None:
        if natural:
            mat = reverse_matrix_index_bits(mat)
        if monty:
            mat = bb.to_u32(mat)
    parts = [t for t in (pend, mat) if t is not None]
    return torch.cat(parts, dim=1) if len(parts) > 1 else (parts[0] if parts else None)


def _absorb_blocks_plain(st: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(N, 25) int64 lanes after absorbing the whole rate blocks of ``rows``."""
    items = _items(rows[:, : rows.shape[1] // BLOCK_WORDS * BLOCK_WORDS])
    for off in range(0, items.shape[1], RATE):
        st[:, :RATE] = items[:, off : off + RATE]
        st = keccak_f_plain(st)
    return st


def absorb_rows_plain(state: torch.Tensor, mat: torch.Tensor, first: bool = False,
                      pend: Optional[torch.Tensor] = None, monty: bool = False,
                      natural: bool = False) -> Optional[torch.Tensor]:
    rows = _row_words(pend, mat, monty, natural)
    take = rows.shape[1] // BLOCK_WORDS * BLOCK_WORDS
    if take:
        st = torch.zeros((rows.shape[0], WIDTH), dtype=torch.int64, device=rows.device) if first else _state_lanes(state)
        st = _absorb_blocks_plain(st, rows)
        lo = ((st & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
        state[0::2] = lo.t().to(torch.int32)
        state[1::2] = (st >> 32).t().to(torch.int32)
    return rows[:, take:].contiguous() if take < rows.shape[1] else None


def finalize_rows_plain(state: torch.Tensor, pend: Optional[torch.Tensor], first: bool = False,
                        mat: Optional[torch.Tensor] = None, monty: bool = False, natural: bool = False) -> torch.Tensor:
    n = int(state.shape[1])
    st = torch.zeros((n, WIDTH), dtype=torch.int64, device=state.device) if first else _state_lanes(state)
    rows = _row_words(pend, mat, monty, natural)
    if rows is not None and rows.shape[1]:
        st = _absorb_blocks_plain(st, rows)
        rest = rows[:, rows.shape[1] // BLOCK_WORDS * BLOCK_WORDS :]
        if rest.shape[1]:
            items = _items(rest)
            st[:, : items.shape[1]] = items
            st = keccak_f_plain(st)
    return _digest_words(st)


def _check_absorb(state: torch.Tensor, mat: Optional[torch.Tensor], pend: Optional[torch.Tensor],
                  monty: bool, natural: bool) -> Tuple[int, int]:
    """(p, k): the pending and new words a row."""
    if state.dim() != 2 or state.shape[0] != 2 * WIDTH:
        raise ValueError(f"keccak absorb: a state of shape {tuple(state.shape)}, not (50, N)")
    n = int(state.shape[1])
    p = 0 if pend is None else int(pend.shape[1])
    k = 0 if mat is None else int(mat.shape[1])
    if p >= BLOCK_WORDS:
        raise ValueError(f"keccak absorb: {p} pending words are more than a partial block")
    if natural and (n & (n - 1) or mat is None):
        raise ValueError(f"keccak absorb: a natural-order chunk of {n} rows, not a power of two")
    if natural and not monty:
        raise ValueError("keccak absorb: a natural-order chunk is a codeword of Montgomery forms (monty)")
    return p, k


def _on_card(state: torch.Tensor) -> bool:
    """Whether the absorb given ``state`` launches its kernel (a CUDA
    tensor) or runs its plain version (the CPU)."""
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"keccak absorb: unsupported device {state.device}")
    return state.device.type == "cuda"


def _absorb_operands(state, mat, pend):
    """Check the absorb's operands for its kernel; returns (mat, pend), mat
    with contiguous columns (pend's rows and columns may both stride)."""
    if state.dtype != torch.int32 or not state.is_contiguous():
        raise ValueError("keccak absorb: the state must be a contiguous int32 tensor (updated in place)")
    n = int(state.shape[1])
    for name, t in (("mat", mat), ("pend", pend)):
        if t is not None and (t.device != state.device or t.dtype != torch.int32 or t.dim() != 2
                              or t.shape[0] != n):
            raise ValueError(f"keccak absorb: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                             f"against a state of {n} rows")
    if mat is not None and mat.shape[1] > 1 and mat.stride(1) != 1:
        mat = mat.contiguous()
    return mat, pend


def _absorb_launch(state, mat, pend, first, monty, natural, fin, out) -> None:
    n = int(state.shape[1])
    if n == 0:
        return
    p, k = (0 if t is None or t.shape[1] == 0 else int(t.shape[1]) for t in (pend, mat))
    kernels.KECCAK_ABSORB.launches += 1
    kernels.check(
        kernels.lib().ts_keccak_absorb(
            state.data_ptr(), n, n.bit_length() - 1,
            pend.data_ptr() if p else None, p, pend.stride(0) if p else 0, pend.stride(1) if p else 0,
            mat.data_ptr() if k else None, k, mat.stride(0) if k else 0,
            int(bool(first)), int(bool(natural)), int(bool(monty)), int(fin),
            None if out is None else out.data_ptr(), kernels.stream_handle(state.device),
        ),
        "keccak absorb",
    )


def absorb_rows(state: torch.Tensor, mat: torch.Tensor, first: bool = False,
                pend: Optional[torch.Tensor] = None, monty: bool = False,
                natural: bool = False) -> Optional[torch.Tensor]:
    """Absorb the whole rate blocks of each row's words into the (50, N)
    state, in place (only when there is one): pend's p < 34 canonical
    words, then mat's k words, Montgomery forms with ``monty``, and with
    ``natural`` (which needs ``monty``) a codeword chunk in natural row order
    (the tree's row r is its row bitrev(r)).  Returns the words after the last whole block, canonical and
    in the tree's order, (N, (p + k) % 34), or None when there are none.
    On the card one launch reads mat as it lies and writes those words."""
    p, k = _check_absorb(state, mat, pend, monty, natural)
    if not _on_card(state):
        return absorb_rows_plain(state, mat, first, pend, monty, natural)
    mat, pend = _absorb_operands(state, mat, pend)
    rest = (p + k) % BLOCK_WORDS
    out = torch.empty((rest, int(state.shape[1])), dtype=torch.int32, device=state.device) if rest else None
    _absorb_launch(state, mat, pend, first, monty, natural, False, out)
    return None if out is None else out.t()  # word-major: a warp's stores and the next launch's loads coalesce


def finalize_rows(state: torch.Tensor, pend: Optional[torch.Tensor], first: bool = False,
                  mat: Optional[torch.Tensor] = None, monty: bool = False, natural: bool = False) -> torch.Tensor:
    """(N, 4, 2) digests of the rows whose remaining words are pend's then
    mat's (as for ``absorb_rows``), the last partial block included; the
    state is left as it is."""
    p, k = _check_absorb(state, mat, pend, monty, natural)
    if first and p + k == 0:
        raise ValueError("empty sponge input")
    if not _on_card(state):
        return finalize_rows_plain(state, pend, first, mat, monty, natural)
    mat, pend = _absorb_operands(state, mat, pend)
    out = torch.empty((int(state.shape[1]), OUT, 2), dtype=torch.int32, device=state.device)
    _absorb_launch(state, mat, pend, first, monty, natural, True, out)
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
