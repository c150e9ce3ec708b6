"""K9, K10 and K11: the open phase's PCS arithmetic on hand-written CUDA
kernels (``csrc/open.cu`` on the BabyBear^4 device functions of
``csrc/ext4.cuh``), the counterpart of ``air/quotient_kernel.py`` for the
open phase.

**K9** ``reduced_opening`` adds one group's reduced opening into a height's
accumulator: for each row i of the height-2^log_h codeword held from
global row ``row0``, ``acc[i] += (sum_c alpha^(off+c) m[i, c] - s) /
(y_i - z)``, ``y_i = g_H^bitrev(row0 + i)``, or the column sum alone with no
point (random codewords).  The group's matrices are operands side by side
(no concatenation; a launch takes ``MAX_OPS``, and a larger group sums its
first ones into an ext sum), read in the committed bit-reversed row order or in
natural order (row ``bitrev(row0 + i)``: a recomputed codeword skips its
bit reversal); an (rows, 4) ext sum may join the columns (the streamed
source sums its chunks with the no-point mode, then divides once).

**K10** ``eval_at_points`` is ``sum_r c[r, col] z^(r0 + r)`` for every
column at one or two points, in one read of the coefficients: the powers of
z are made in the kernel, never an (h, 4) table.

**K11** ``fri_fold`` is one arity-2 FRI fold in the bit-reversed plain frame,
``(e + o)/2 + beta (e - o)/(2 y)``, with ``1/(2 y)`` made in the kernel and
the next height's reduced opening optionally added.

Out-of-domain points, opened sums and beta are host values (canonical
coefficient tuples): the opened values are on the host already, and the
opened sum is their exact host dot product with the alpha powers
(``pcs._dot_ext``, as the verifier computes it).  On the CPU (and on
``meta`` tensors, for the SoL report's audit) each wrapper runs its plain
int64 torch version; a CUDA tensor launches its kernel or raises.  Every result has the plain
version's bits.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..fields import babybear as bb
from ..fields import extension as ext4
from ..fields import ref_field as rf
from ..fri.domains import ExtPoint
from ..matrix import bit_reversal_perm_device, log2_strict, reverse_bits_device

MAX_OPS = 32  # operands of one K9 launch (csrc/open.cu kMaxOps)
RUN = 8  # rows a K9 / K11 thread takes when row0 allows it (kTab)
K10_THREADS = 256  # threads a K10 block, and the rows a block steps at a time
K10_BLOCKS = 1024  # K10 blocks a launch at most, about
K10_MIN_ROWS = 4096  # rows a K10 block at least, where the height allows

# ---------------------------------------------------------------------------
# Plain versions (int64 torch), row-blocked: the column reductions run over
# (rows, cols) blocks of at most _COL_CHUNK columns and as many rows as keep
# one (rows, cols, 4) int64 intermediate within _ELEM_BUDGET elements
# (256 MiB), at any height and width.  Sums across blocks reduce mod p.
# ---------------------------------------------------------------------------
_COL_CHUNK = 64
_ELEM_BUDGET = 1 << 25


def _block_plan(h: int, w: int) -> Tuple[int, int]:
    """(rows, cols) per block of an (h, w) column reduction."""
    cols = max(1, min(w, _COL_CHUNK))
    rows = max(1, min(h, _ELEM_BUDGET // (4 * cols)))
    return rows, cols


def _eval_at_point(r_coeffs: torch.Tensor, zpow: torch.Tensor) -> torch.Tensor:
    """r(z) for every column: (H, w) base coeffs x (H, 4) ext powers ->
    (w, 4) Monty.  Products reduce mod p before the int64 row sum of a
    block (below 2^63 for any block of fewer than 2^32 rows)."""
    h, w = r_coeffs.shape
    rows, cols = _block_plan(h, w)
    out = torch.empty((w, 4), dtype=bb.I32, device=r_coeffs.device)
    for c0 in range(0, w, cols):
        acc = torch.zeros((min(cols, w - c0), 4), dtype=torch.int64, device=r_coeffs.device)
        for r0 in range(0, h, rows):
            prod = bb.mul(r_coeffs[r0 : r0 + rows, c0 : c0 + cols, None], zpow[r0 : r0 + rows, None, :])
            acc = (acc + prod.to(torch.int64).sum(dim=0)) % bb.P
        out[c0 : c0 + cols] = acc.to(bb.I32)
    return out


def _combine_columns(mat_br: torch.Tensor, apows: torch.Tensor) -> torch.Tensor:
    """sum_col apows[col] * mat[:, col]: (H, w) x (w, 4) -> (H, 4) ext.  A
    row block sums its column chunks' reduced values in int64 (below w * p)
    and reduces once."""
    h, w = mat_br.shape
    rows, cols = _block_plan(h, w)
    out = torch.empty((h, 4), dtype=bb.I32, device=mat_br.device)
    for r0 in range(0, h, rows):
        acc = torch.zeros((min(rows, h - r0), 4), dtype=torch.int64, device=mat_br.device)
        for c0 in range(0, w, cols):
            prod = ext4.mul_base(apows[None, c0 : c0 + cols, :], mat_br[r0 : r0 + rows, c0 : c0 + cols])
            acc += prod.to(torch.int64).sum(dim=1)
        out[r0 : r0 + rows] = (acc % bb.P).to(bb.I32)
    return out


def _over_y_minus_z(combined, opened_sum, z_dev, y_br) -> torch.Tensor:
    """(combined - opened_sum) / (y - z) over one row block; ``combined`` is
    ``_combine_columns`` of the block's codeword rows."""
    diff = ext4.sub(combined, opened_sum[None, :])
    y_minus_z = ext4.sub(ext4.from_base(y_br), z_dev[None, :])
    return ext4.mul(diff, ext4.inv(y_minus_z))


def _bit_reverse(index: int, log_h: int) -> int:
    """``index`` with its low ``log_h`` bits reversed."""
    rev = 0
    for _ in range(log_h):
        rev = (rev << 1) | (index & 1)
        index >>= 1
    return rev


def _br_powers(base: int, log_n: int, start: int, count: int, device) -> torch.Tensor:
    """Canonical base^bitrev_n(j) for j in [start, start + count), int64.
    For count a power of two dividing start, with j = d * count + t,
    bitrev_n(j) = bitrev(t) * 2^k + bitrev_k(d), k = log_n - log2(count),
    so a block is a scalar times the powers of base^(2^k) in bit-reversed
    order; any other range takes the exponents' square-and-multiply."""
    if count & (count - 1) == 0 and start % count == 0:
        log_c = log2_strict(count)
        k = log_n - log_c
        scal = pow(base, _bit_reverse(start >> log_c, k), bb.P)
        pows = bb.powers(pow(base, 1 << k, bb.P), count, device)[bit_reversal_perm_device(log_c, device)]
        return pows * scal % bb.P
    exps = reverse_bits_device(torch.arange(start, start + count, dtype=torch.int64, device=device), log_n)
    return bb.to_u32(bb.pow_exponents(base, exps, max(1, log_n))).to(torch.int64)


def _plain_points_br(log_h: int, device, start: int = 0, count: Optional[int] = None) -> torch.Tensor:
    """Monty g_H^bitrev(i) for i in [start, start + count) (all i < 2^log_h
    by default)."""
    count = 1 << log_h if count is None else count
    return bb.from_u32(_br_powers(bb.two_adic_generator(log_h), log_h, start, count, device))


def _fold_inv2y(log_h: int, device, start: int = 0, count: Optional[int] = None) -> torch.Tensor:
    """Canonical 1/(2*y_j), y_j = g_lh^bitrev_{lh-1}(j), for j in [start,
    start + count) (all j < 2^(lh-1) by default): 1/y = (g^-1)^e, so the
    table is a gathered power table."""
    g_inv = pow(bb.two_adic_generator(log_h), bb.P - 2, bb.P)
    count = 1 << (log_h - 1) if count is None else count
    return _br_powers(g_inv, log_h - 1, start, count, device) * ((bb.P + 1) // 2) % bb.P


def _fold_codeword(cw: torch.Tensor, beta_dev: torch.Tensor, log_h: int, row0: int = 0) -> torch.Tensor:
    """One arity-2 FRI fold in the bit-reversed plain frame:
    (e + o)/2 + beta * (e - o)/(2y); (H, 4) -> (H/2, 4).  ``cw`` may be the
    rows [row0, row0 + len) of the height-2^log_h codeword (fold pairs are
    adjacent rows)."""
    e, o = cw[0::2], cw[1::2]
    half_sum = bb.mul_canonical(ext4.add(e, o), (bb.P + 1) // 2)
    inv2y = _fold_inv2y(log_h, cw.device, row0 >> 1, int(cw.shape[0]) >> 1)
    half_diff = bb.mul_canonical(ext4.sub(e, o), inv2y[:, None])
    return ext4.add(half_sum, ext4.mul(beta_dev[None, :], half_diff))


def reduced_opening_plain(acc: torch.Tensor, mats: Sequence[torch.Tensor], apows: torch.Tensor, log_h: int,
                          row0: int = 0, point: Optional[Tuple[ExtPoint, ExtPoint]] = None, natural: bool = False,
                          ext_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``reduced_opening`` in plain torch, one row block at a time."""
    rows, dev = int(acc.shape[0]), acc.device
    width = sum(int(m.shape[1]) for m in mats)
    blk = _block_plan(rows, max(1, width))[0]
    if point is not None:
        z_dev, s_dev = ext4.scalar(point[0], dev), ext4.scalar(point[1], dev)
    for r0 in range(0, rows, blk):
        n = min(blk, rows - r0)
        comb = ext4.zero((n,), dev) if ext_in is None else ext_in[r0 : r0 + n]
        sel = (reverse_bits_device(torch.arange(row0 + r0, row0 + r0 + n, dtype=torch.int64, device=dev), log_h)
               if natural else slice(r0, r0 + n))
        off = 0
        for m in mats:
            w = int(m.shape[1])
            comb = ext4.add(comb, _combine_columns(m[sel], apows[off : off + w]))
            off += w
        if point is not None:
            comb = _over_y_minus_z(comb, s_dev, z_dev, _plain_points_br(log_h, dev, row0 + r0, n))
        acc[r0 : r0 + n] = ext4.add(acc[r0 : r0 + n], comb)
    return acc


def eval_at_points_plain(coeffs: torch.Tensor, points: Sequence[ExtPoint], r0: int = 0,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``eval_at_points`` in plain torch: an (h, 4) power table a point."""
    h, dev = int(coeffs.shape[0]), coeffs.device
    vals = []
    for z in points:
        zpow = ext4.powers_device(z, h, dev)
        if r0:
            zpow = ext4.mul(zpow, ext4.scalar(rf.epow(z, r0), dev)[None, :])
        vals.append(_eval_at_point(coeffs, zpow))
    res = torch.stack(vals) if vals else torch.empty((0, int(coeffs.shape[1]), 4), dtype=bb.I32, device=dev)
    if out is None:
        return res
    out.copy_(ext4.add(out, res))
    return out


def fri_fold_plain(cw: torch.Tensor, beta: ExtPoint, log_h: int, row0: int = 0,
                   add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fri_fold`` in plain torch (the 1/(2y) table built on the device)."""
    folded = _fold_codeword(cw, ext4.scalar(beta, cw.device), log_h, row0)
    return folded if add is None else ext4.add(folded, add)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------
def _on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` launches its kernel (a CUDA tensor) or
    runs its plain version (the CPU; ``meta`` for the SoL report's audit)."""
    return t.device.type == "cuda"


def _ext_rows(name: str, t: torch.Tensor, rows: int) -> None:
    """An (rows, 4) int32 operand the kernels read and write as 16-byte rows."""
    if t.dtype != torch.int32 or tuple(t.shape) != (rows, 4) or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: want a contiguous 16-byte aligned int32 ({rows}, 4), got {t.dtype} "
                         f"{tuple(t.shape)} {t.stride()}")


def _monty(x: int) -> int:
    return bb.host_to_monty(int(x) % bb.P)


def _ext_monty(z: ExtPoint) -> List[int]:
    return [_monty(c) for c in z]


def _run_table(base: int, log_n: int) -> List[int]:
    """Monty base^bitrev_n(32 r) for r < RUN: a thread's rows 32 r apart."""
    return [_monty(pow(base, _bit_reverse((32 * r) % (1 << log_n), log_n), bb.P)) for r in range(RUN)]


def _log_run(first: int) -> int:
    """log2 of the rows a thread takes: RUN where ``first`` (the global
    index of the launch's first row) keeps bitrev additive over a run of
    32 RUN rows, else 1."""
    return 3 if first % (32 * RUN) == 0 else 0


def _vec_rows(m: torch.Tensor) -> bool:
    """Whether K9 reads ``m``'s rows 16 bytes at a time: a 16-byte aligned
    base, and a width and row stride that are multiples of 4 words."""
    return m.data_ptr() % 16 == 0 and int(m.shape[1]) % 4 == 0 and m.stride(0) % 4 == 0 and int(m.shape[1]) > 0


def reduced_opening(acc: torch.Tensor, mats: Sequence[torch.Tensor], apows: torch.Tensor, log_h: int,
                    row0: int = 0, point: Optional[Tuple[ExtPoint, ExtPoint]] = None, natural: bool = False,
                    ext_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9: add one group's reduced opening into ``acc`` (rows, 4) Monty, the
    rows [row0, row0 + rows) of a height-2^log_h reduced opening, in place.

    ``mats`` are the group's (Monty) matrices, each with unit column stride:
    the held rows in bit-reversed order, or with ``natural`` the whole
    natural-order codeword (2^log_h rows); ``apows`` (sum of widths, 4) are
    their columns' alpha powers, in order; a launch takes MAX_OPS
    operands, so a larger group sums its first ones into a scratch ext sum
    first.  ``ext_in`` (rows, 4), when given, adds to the column sum.
    ``point`` = (z, s), canonical: the plain-frame point and the opened sum
    sum_col alpha^k y_col(z); each row then adds
    (sum - s) / (y - z), y = g_H^bitrev(row0 + i); without it the sum
    alone.  Returns ``acc``.  A CPU tensor runs ``reduced_opening_plain``;
    on the card a failed build or launch raises."""
    if not _on_card(acc):
        return reduced_opening_plain(acc, mats, apows, log_h, row0, point, natural, ext_in)
    so = kernels.lib()
    rows, mats = int(acc.shape[0]), list(mats)
    _ext_rows("acc", acc, rows)
    if ext_in is not None:
        _ext_rows("ext_in", ext_in, rows)
    width = sum(int(m.shape[1]) for m in mats)
    _ext_rows("apows", apows, width)
    if row0 < 0 or row0 + rows > 1 << log_h:
        raise ValueError(f"reduced_opening: rows [{row0}, {row0 + rows}) of a height-2^{log_h} codeword")
    for m in mats:
        if m.dtype != torch.int32 or m.dim() != 2 or m.stride(1) != 1 or m.device != acc.device:
            raise ValueError(f"reduced_opening: an int32 matrix with unit column stride on {acc.device}, got "
                             f"{m.dtype} {tuple(m.shape)} {m.stride()} on {m.device}")
        if int(m.shape[0]) != (1 << log_h if natural else rows):
            raise ValueError(f"reduced_opening: a matrix of {m.shape[0]} rows ({'natural' if natural else 'held'} "
                             f"order, {rows} rows held of 2^{log_h})")
    if rows == 0:
        return acc
    if len(mats) > MAX_OPS:
        # more operands than a launch takes: the first ones, MAX_OPS a
        # launch, sum with no point into an (rows, 4) scratch that joins the
        # last launch's columns as its ext sum
        scratch = torch.zeros_like(acc) if ext_in is None else ext_in.clone()
        while len(mats) > MAX_OPS:
            w = sum(int(m.shape[1]) for m in mats[:MAX_OPS])
            _opening_launch(so, scratch, mats[:MAX_OPS], apows[:w], log_h, row0, None, natural, None)
            mats, apows = mats[MAX_OPS:], apows[w:]
        ext_in = scratch
    _opening_launch(so, acc, mats, apows, log_h, row0, point, natural, ext_in)
    return acc


def _opening_launch(so, acc, mats, apows, log_h, row0, point, natural, ext_in) -> None:
    """One K9 launch over at most MAX_OPS checked operands."""
    rows = int(acc.shape[0])
    g = bb.two_adic_generator(log_h)
    z, s = point if point is not None else ((0, 0, 0, 0), (0, 0, 0, 0))
    # an operand of 16-byte aligned rows whose width is a multiple of 4 is
    # read 16 bytes at a time: its width goes in negated
    ops = [v for m in mats for v in (m.data_ptr(), -int(m.shape[1]) if _vec_rows(m) else int(m.shape[1]),
                                     m.stride(0))]
    words = (ctypes.c_int64 * (10 + len(ops)))(
        rows, row0, log_h, int(natural), int(point is not None), _log_run(row0), apows.data_ptr(),
        0 if ext_in is None else ext_in.data_ptr(), acc.data_ptr(), len(mats), *ops)
    consts = (ctypes.c_uint32 * 17)(_monty(g), *_ext_monty(z), *_ext_monty(s), *_run_table(g, log_h))
    kernels.REDUCED_OPENING.launches += 1
    kernels.check(so.ts_reduced_opening(words, consts, kernels.stream_handle(acc.device)), "reduced opening")


def k10_plan(h: int, w: int) -> Tuple[int, int, int, int]:
    """K10's (tile width cw, tiles, rows a block, row blocks) for (h, w):
    cw the least power of two >= w up to 32; about K10_BLOCKS blocks of at
    least K10_MIN_ROWS rows where the height allows, each a multiple of
    K10_THREADS rows."""
    cw = min(32, 1 << max(0, (w - 1).bit_length()))
    nct = -(-w // cw)
    nrb = max(1, min(-(-h // K10_MIN_ROWS), -(-K10_BLOCKS // nct)))
    rb_rows = -(-(-(-h // nrb)) // K10_THREADS) * K10_THREADS
    return cw, nct, rb_rows, -(-h // rb_rows)


def eval_at_points(coeffs: torch.Tensor, points: Sequence[ExtPoint], r0: int = 0,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10: sum_r coeffs[r, col] z^(r0 + r) for every column and point:
    (h, w) Monty coefficients (unit column stride) at canonical ext points
    -> (P, w, 4) Monty, P <= 2, in one launch.  With ``out``, a
    (P, w, 4) tensor (or view) whose (w, 4) blocks are contiguous, the
    values are added into it and it is returned.  A CPU tensor runs
    ``eval_at_points_plain``; on the card a failed build or launch raises."""
    points = list(points)
    if not _on_card(coeffs):
        return eval_at_points_plain(coeffs, points, r0, out)
    so = kernels.lib()
    if len(points) > 2:
        raise ValueError(f"eval_at_points: {len(points)} points, at most 2 a launch")
    h, w = int(coeffs.shape[0]), int(coeffs.shape[1])
    if coeffs.dtype != torch.int32 or coeffs.dim() != 2 or coeffs.stride(1) != 1:
        raise ValueError(f"eval_at_points: an int32 (h, w) matrix with unit column stride, got {coeffs.dtype} "
                         f"{tuple(coeffs.shape)} {coeffs.stride()}")
    npts = len(points)
    accumulate = out is not None
    if out is None:
        out = torch.empty((npts, w, 4), dtype=torch.int32, device=coeffs.device)
    if (out.dtype != torch.int32 or tuple(out.shape) != (npts, w, 4) or out.stride(2) != 1
            or (w > 1 and out.stride(1) != 4) or out.device != coeffs.device):
        raise ValueError(f"eval_at_points: out must be int32 ({npts}, {w}, 4) with contiguous (w, 4) blocks, got "
                         f"{out.dtype} {tuple(out.shape)} {out.stride()}")
    if npts == 0 or w == 0:
        return out
    if h == 0:
        if not accumulate:
            out.zero_()
        return out
    cw, nct, rb_rows, nrb = k10_plan(h, w)
    partial = torch.empty((nrb, npts, w, 4), dtype=torch.int32, device=coeffs.device)
    consts = [0] * 24
    for p, z in enumerate(points):
        consts[4 * p : 4 * p + 4] = _ext_monty(z)
        consts[8 + 4 * p : 12 + 4 * p] = _ext_monty(rf.epow(z, r0))
        consts[16 + 4 * p : 20 + 4 * p] = _ext_monty(rf.epow(z, K10_THREADS))
    words = (ctypes.c_int64 * 13)(coeffs.data_ptr(), h, w, coeffs.stride(0), npts, cw, nct, rb_rows, nrb,
                                  partial.data_ptr(), out.data_ptr(), out.stride(0), int(accumulate))
    kernels.EVAL_AT_POINTS.launches += 1
    kernels.check(so.ts_eval_at_points(words, (ctypes.c_uint32 * 24)(*consts), kernels.stream_handle(coeffs.device)),
                  "eval at points")
    return out


def fri_fold(cw: torch.Tensor, beta: ExtPoint, log_h: int, row0: int = 0,
             add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K11: one arity-2 FRI fold, (e + o)/2 + beta (e - o)/(2y) over the
    adjacent row pairs of ``cw``, the rows [row0, row0 + len) of the
    height-2^log_h codeword ((len, 4) Monty, bit-reversed plain frame),
    beta canonical, y = g_lh^bitrev_{lh-1}(row0/2 + j); ``add`` (len/2, 4),
    the next height's reduced opening on the same rows, is added when
    given.  A CPU tensor runs ``fri_fold_plain``; on the card a failed
    build or launch raises."""
    if not _on_card(cw):
        return fri_fold_plain(cw, beta, log_h, row0, add)
    so = kernels.lib()
    n = int(cw.shape[0])
    if n % 2 or row0 % 2 or row0 + n > 1 << log_h:
        raise ValueError(f"fri_fold: {n} rows from {row0} of a height-2^{log_h} codeword")
    half = n // 2
    _ext_rows("cw", cw, n)
    if add is not None:
        _ext_rows("add", add, half)
    out = torch.empty((half, 4), dtype=torch.int32, device=cw.device)
    if half == 0:
        return out
    j0 = row0 >> 1
    g_inv = pow(bb.two_adic_generator(log_h), bb.P - 2, bb.P)
    inv2 = (bb.P + 1) // 2
    tab = [_monty(inv2 * pow(g_inv, _bit_reverse((32 * r) % (1 << (log_h - 1)), log_h - 1), bb.P)) for r in range(RUN)]
    words = (ctypes.c_int64 * 7)(cw.data_ptr(), out.data_ptr(), 0 if add is None else add.data_ptr(), half, j0,
                                 log_h, _log_run(j0))
    consts = (ctypes.c_uint32 * 14)(_monty(g_inv), _monty(inv2), *_ext_monty(beta), *tab)
    kernels.FRI_FOLD.launches += 1
    kernels.check(so.ts_fri_fold(words, consts, kernels.stream_handle(cw.device)), "fri fold")
    return out

