"""K9, K10 and K11: the open phase's PCS arithmetic on hand-written CUDA
kernels (``csrc/open.cu`` on the BabyBear^4 device functions of
``csrc/ext4.cuh``), the counterpart of ``air/quotient_kernel.py`` for the
open phase.

**K9** ``reduced_opening`` adds one group's reduced opening into a height's
accumulator: for each row i of the height-2^log_h codeword held from
global row ``row0``, ``acc[i] += sum_p (C_p[i] - s_p) / (y_i - z_p)`` over
the group's points (one or two: z and g z), ``y_i = g_H^bitrev(row0 + i)``,
``C_p = sum_c alpha_p,c m[i, c]``, or the column sum alone with no point
(random codewords).  Each element is read once for all the points: point
p's powers are its own plane of a (P, width, 4) table, or point p's sum is
``scales[p]`` times the one table's (a lone matrix at z and g z:
alpha^width; the wrapper folds the scale into q_z and s).  The group's
matrices are operands side by side (no concatenation; a launch takes
``MAX_OPS`` and ``MAX_SLOTS`` columns, and a larger group sums its first
ones into an ext sum), read in the committed
bit-reversed row order or in natural order (row ``bitrev(row0 + i)``: a
recomputed codeword skips its bit reversal); an (rows, 4) ext sum may join
the columns (the streamed source sums its chunks with the no-point mode,
then divides once for all the points).  The division runs in the base
field: ``1/(y - z) = q_z(y) / chi_z(y)`` with z's characteristic
polynomial chi_z (``division_poly``).

**K10** ``eval_at_points`` is ``sum_r c[r, col] z^(r0 + r)`` for every
column at one or two points, in one read of the coefficients: the powers of
z are made in the kernel, never an (h, 4) table.

**K11** ``fri_fold`` is one arity-2 FRI fold in the bit-reversed plain frame,
``(e + o)/2 + beta (e - o)/(2 y)``, with ``1/(2 y)`` made in the kernel and
the next height's reduced opening optionally added.

Out-of-domain points, opened sums, scales and beta are host values
(canonical coefficient tuples): the opened values are on the host already,
and the opened sum is their exact host dot product with the alpha powers
(``pcs._dot_ext``, as the verifier computes it).  On the CPU (and on
``meta`` tensors, for the SoL report's audit) each wrapper runs its plain
int64 torch version (the ext inverse, a point at a time); a CUDA tensor
launches its kernel or raises.  Every result has the plain version's bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..fields import babybear as bb
from ..fields import extension as ext4
from ..fields import ref_field as rf
from ..fri.domains import ExtPoint
from ..matrix import bit_reversal_perm_device, log2_strict, reverse_bits_device

MAX_OPS = 32  # operands of one K9 launch (csrc/open.cu kMaxOps)
MAX_UNITS = 64  # staged column slabs of one K9 launch (kMaxUnits)
MAX_SLOTS = 640  # alpha slots (quad-padded columns) of a K9 launch's plane
PIECE_COLS = 512  # a wider K9 operand is cut into column slices of this many
K9_POINT_WORDS = 24  # a point's constants (csrc/open.cu kPointWords)
RUN = 8  # rows a K11 thread takes when row0 allows it (kTab)
K10_ITEMS = 4096  # K10's warp items (ranges x column groups) a launch, about, where the height allows
K10_MIN_LOG_K, K10_MAX_LOG_K = 3, 8  # a K10 range is 32 K rows, 2^3 <= K <= 2^8 (kMaxLogK)

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
                          row0: int = 0, points: Sequence[Tuple[ExtPoint, ExtPoint]] = (), natural: bool = False,
                          ext_in: Optional[torch.Tensor] = None,
                          scales: Optional[Sequence[ExtPoint]] = None) -> torch.Tensor:
    """``reduced_opening`` in plain torch, one row block at a time: each
    point's column sum, then its quotient by the ext inverse of y - z."""
    rows, dev = int(acc.shape[0]), acc.device
    planes = [apows[k] for k in range(int(apows.shape[0]))] if apows.dim() == 3 else [apows]
    width = sum(int(m.shape[1]) for m in mats)
    blk = _block_plan(rows, max(1, width * len(planes)))[0]
    pts = [(ext4.scalar(z, dev), ext4.scalar(s, dev)) for z, s in points]
    scl = None if scales is None else [ext4.scalar(c, dev) for c in scales]
    for r0 in range(0, rows, blk):
        n = min(blk, rows - r0)
        sel = (reverse_bits_device(torch.arange(row0 + r0, row0 + r0 + n, dtype=torch.int64, device=dev), log_h)
               if natural else slice(r0, r0 + n))
        combs = []
        for k, ap in enumerate(planes):
            comb = ext4.zero((n,), dev) if ext_in is None else (ext_in[k] if apows.dim() == 3 else ext_in)[r0 : r0 + n]
            off = 0
            for m in mats:
                w = int(m.shape[1])
                comb = ext4.add(comb, _combine_columns(m[sel], ap[off : off + w]))
                off += w
            combs.append(comb)
        if not pts:
            acc[r0 : r0 + n] = ext4.add(acc[r0 : r0 + n], combs[0])
            continue
        y_br = _plain_points_br(log_h, dev, row0 + r0, n)
        for p, (z_dev, s_dev) in enumerate(pts):
            comb = combs[p if len(planes) > 1 else 0]
            if scl is not None:
                comb = ext4.mul(comb, scl[p][None, :])
            acc[r0 : r0 + n] = ext4.add(acc[r0 : r0 + n], _over_y_minus_z(comb, s_dev, z_dev, y_br))
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


def _log_run(first: int) -> int:
    """log2 of the rows a thread takes: RUN where ``first`` (the global
    index of the launch's first row) keeps bitrev additive over a run of
    32 RUN rows, else 1."""
    return 3 if first % (32 * RUN) == 0 else 0


# ---------------------------------------------------------------------------
# K9's host constants
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _gpow_table(log_h: int) -> Tuple[int, ...]:
    """Monty g_H^(2^j), j < 32 (1 from j = log_h on)."""
    g, out = bb.two_adic_generator(log_h), []
    for _ in range(32):
        out.append(_monty(g))
        g = g * g % bb.P
    return tuple(out)


@functools.lru_cache(maxsize=256)
def division_poly(z: ExtPoint) -> Tuple[Tuple[int, ...], Tuple[ExtPoint, ...]]:
    """z's characteristic polynomial chi_z(Y) = prod_k (Y - z^(p^k)) (monic,
    its coefficients c0..c3 in F_p: they are symmetric in the conjugates)
    and q_z = chi_z / (Y - z) = Y^3 + q2 Y^2 + q1 Y + q0 over the
    extension, by synthetic division; canonical.  For y in F_p, chi_z(y) is
    the norm of y - z, so 1/(y - z) = q_z(y) / chi_z(y) where chi_z(y) != 0,
    and chi_z(y) = 0 only at y = z."""
    frob = pow(rf.W, (bb.P - 1) // 4, bb.P)
    poly: List[ExtPoint] = [(1, 0, 0, 0)]  # low coefficient first
    for k in range(4):
        conj = tuple(c * pow(frob, (i * k) % 4, bb.P) % bb.P for i, c in enumerate(z))
        shifted = [(0, 0, 0, 0)] + poly
        poly = [rf.esub(shifted[i], rf.emul(poly[i], conj)) if i < len(poly) else shifted[i]
                for i in range(len(shifted))]
    if any(c[1:] != (0, 0, 0) for c in poly) or poly[4] != (1, 0, 0, 0):
        raise AssertionError(f"chi_z of {z} is not a monic quartic over F_p")
    chi = tuple(c[0] for c in poly[:4])
    q2 = rf.eadd(rf.efrom_base(chi[3]), z)
    q1 = rf.eadd(rf.efrom_base(chi[2]), rf.emul(z, q2))
    q0 = rf.eadd(rf.efrom_base(chi[1]), rf.emul(z, q1))
    if rf.eadd(rf.efrom_base(chi[0]), rf.emul(z, q0)) != (0, 0, 0, 0):
        raise AssertionError(f"Y - {z} does not divide chi_z")
    return chi, (q0, q1, q2)


def _k9_plan(widths: Sequence[int], nsum: int, dividing: bool) -> Tuple[int, int, int]:
    """K9's (log2 R, staged slab width, staged row stride) in words: a
    dividing group of narrow rows takes R rows a thread (one base inverse
    for R x points values), a wide one a row and slabs of 32 words; the
    stride is 4 x odd words (conflict-free 16-byte reads)."""
    widest = max(list(widths) + [1])
    if dividing and widest <= 4:
        log_r = 3 if nsum == 1 else 2
    elif dividing and widest <= 16:
        log_r = 1
    else:
        log_r = 0
    sw = 32 if log_r == 0 else (widest + 3) & ~3
    return log_r, sw, sw + 4 if (sw // 4) % 2 == 0 else sw


def _k9_pieces(mats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The operands cut into column slices of at most PIECE_COLS."""
    return [m[:, c : c + PIECE_COLS] for m in mats for c in range(0, int(m.shape[1]), PIECE_COLS)]


def _k9_launches(pieces: Sequence[torch.Tensor], sw: int) -> List[List[torch.Tensor]]:
    """The pieces packed in order into launches of at most MAX_OPS operands,
    MAX_UNITS slabs and MAX_SLOTS alpha slots (at least one launch)."""
    out: List[List[torch.Tensor]] = [[]]
    units = slots = 0
    for m in pieces:
        w = int(m.shape[1])
        u, sl = -(-w // sw), sum(-(-min(sw, w - c) // 4) * 4 for c in range(0, w, sw))
        if out[-1] and (len(out[-1]) == MAX_OPS or units + u > MAX_UNITS or slots + sl > MAX_SLOTS):
            out.append([])
            units = slots = 0
        out[-1].append(m)
        units, slots = units + u, slots + sl
    return out


def _vec_rows(m: torch.Tensor) -> bool:
    """Whether K9 stages ``m``'s rows 16 bytes a copy: a 16-byte aligned
    base, and a width and row stride that are multiples of 4 words."""
    return m.data_ptr() % 16 == 0 and int(m.shape[1]) % 4 == 0 and m.stride(0) % 4 == 0 and int(m.shape[1]) > 0


def reduced_opening(acc: torch.Tensor, mats: Sequence[torch.Tensor], apows: torch.Tensor, log_h: int,
                    row0: int = 0, points: Sequence[Tuple[ExtPoint, ExtPoint]] = (), natural: bool = False,
                    ext_in: Optional[torch.Tensor] = None,
                    scales: Optional[Sequence[ExtPoint]] = None) -> torch.Tensor:
    """K9: add one group's reduced opening into ``acc`` (rows, 4) Monty, the
    rows [row0, row0 + rows) of a height-2^log_h reduced opening, in place.

    ``mats`` are the group's (Monty) matrices, each with unit column stride:
    the held rows in bit-reversed order, or with ``natural`` the whole
    natural-order codeword (2^log_h rows), read once for all the points.
    ``points``: none (the column sum alone), or one or two (z, s): the
    plain-frame point and its opened sum sum_col alpha^k y_col(z),
    canonical; each row then adds sum_p (C_p - s_p) / (y - z_p), y =
    g_H^bitrev(row0 + i).  ``apows``: (sum of widths, 4), the columns'
    alpha powers in order, every point's (``scales[p]``, canonical and not
    0, when given, multiplies point p's sum: a lone matrix's second point
    takes alpha^width); or (P, sum of widths, 4), a plane a point.
    ``ext_in`` ((rows, 4), or (P, rows, 4) with planes) joins the column
    sums.  A
    launch takes MAX_OPS operands and MAX_SLOTS columns, so a larger group
    sums its first ones into a scratch ext sum first.  Returns ``acc``.  A
    CPU tensor runs ``reduced_opening_plain``; on the card a failed build or
    launch raises."""
    if not _on_card(acc):
        return reduced_opening_plain(acc, mats, apows, log_h, row0, points, natural, ext_in, scales)
    so = kernels.lib()
    rows, mats, points = int(acc.shape[0]), list(mats), list(points)
    _ext_rows("acc", acc, rows)
    width = sum(int(m.shape[1]) for m in mats)
    nsum = int(apows.shape[0]) if apows.dim() == 3 else 1
    if len(points) > 2 or (apows.dim() == 3 and (nsum != len(points) or scales is not None)):
        raise ValueError(f"reduced_opening: {len(points)} points with alpha planes of shape {tuple(apows.shape)}"
                         f"{' and scales' if scales is not None else ''}")
    if scales is not None and (len(scales) != len(points) or any(not any(int(v) % bb.P for v in c)
                                                                   for c in scales)):
        raise ValueError(f"reduced_opening: scales {list(scales)} for {len(points)} points (none may be 0)")
    planes = apows if apows.dim() == 3 else apows[None]
    if planes.dtype != torch.int32 or tuple(planes.shape[1:]) != (width, 4) or (width and (
            planes.stride(2) != 1 or (width > 1 and planes.stride(1) != 4) or planes.data_ptr() % 16
            or planes.stride(0) % 4)):
        raise ValueError(f"reduced_opening: apows must be int32 16-byte aligned rows of ({width}, 4) a plane, got "
                         f"{planes.dtype} {tuple(apows.shape)} {apows.stride()}")
    if ext_in is not None:
        ext_planes = ext_in if ext_in.dim() == 3 else ext_in[None]
        if int(ext_planes.shape[0]) != nsum:
            raise ValueError(f"reduced_opening: ext_in {tuple(ext_in.shape)} for {nsum} alpha planes")
        for k in range(nsum):
            _ext_rows("ext_in", ext_planes[k], rows)
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
    log_r, sw, swp = _k9_plan([int(m.shape[1]) for m in mats], nsum, bool(points))
    launches = _k9_launches(_k9_pieces(mats), sw)
    col = 0
    if len(launches) > 1:
        # more than a launch takes: the first launches sum their columns with
        # no point into a scratch ext sum, which the last one reads
        scratch = (torch.zeros((nsum, rows, 4), dtype=torch.int32, device=acc.device) if ext_in is None
                   else ext_planes.clone())
        plan0 = _k9_plan([int(m.shape[1]) for m in mats], nsum, False)
        for ops in launches[:-1]:
            w = sum(int(m.shape[1]) for m in ops)
            _opening_launch(so, scratch, ops, planes[:, col : col + w], log_h, row0, [], natural, None, None, plan0)
            col += w
        ext_in = scratch
    _opening_launch(so, acc, launches[-1], planes[:, col:], log_h, row0, points, natural, ext_in, scales,
                    (log_r, sw, swp))
    return acc


def _opening_launch(so, acc, ops, planes, log_h, row0, points, natural, ext_in, scales, plan) -> None:
    """One K9 launch: ``acc`` (rows, 4), or with no point (nsum, rows, 4)
    planes, over at most MAX_OPS checked operands (``planes``: their
    (nsum, width, 4) alpha powers)."""
    log_r, sw, swp = plan
    nsum = int(planes.shape[0])
    rows = int(acc.shape[-2])
    units, slot, col = [], 0, 0
    for k, m in enumerate(ops):
        w = int(m.shape[1])
        for c0 in range(0, w, sw):
            n = min(sw, w - c0)
            units.append((k, c0, n, col + c0, slot))
            slot += -(-n // 4) * 4
        col += w
    if not units:  # no columns: one empty unit ends each tile
        units = [(0, 0, 0, 0, 0)]
    ext_planes = None if ext_in is None else (ext_in if ext_in.dim() == 3 else ext_in[None])
    consts = [0] * (32 + 2 * K9_POINT_WORDS)
    consts[0:32] = _gpow_table(log_h)
    for p, (z, s) in enumerate(points):
        chi, q = division_poly(tuple(int(c) % bb.P for c in z))
        # a scaled point: (c C - s) q_z / chi_z = (C - s / c) (c q_z) / chi_z
        scale = (1, 0, 0, 0) if scales is None else tuple(int(v) % bb.P for v in scales[p])
        q = [rf.emul(scale, v) for v in q] + [scale]
        s = rf.emul(tuple(int(v) % bb.P for v in s), rf.einv(scale))
        c = 32 + K9_POINT_WORDS * p
        # c0 and q0 join raw products (2^64 times the values): a second Monty factor
        consts[c : c + 4] = [_monty(_monty(chi[0])), *(_monty(v) for v in chi[1:])]
        consts[c + 4 : c + 8] = [_monty(_monty(v)) for v in q[0]]
        for k in range(1, 4):
            consts[c + 4 * k + 4 : c + 4 * k + 8] = _ext_monty(q[k])
        consts[c + 20 : c + 24] = _ext_monty(s)
    ops_words = [v for m in ops for v in (m.data_ptr(), m.stride(0), int(_vec_rows(m)))]
    unit_words = [v for u in units for v in u]
    ext_words = (0, 0) if ext_planes is None else (ext_planes.data_ptr(), ext_planes.stride(0) if nsum > 1 else 0)
    words = [rows, row0, log_h, int(natural), len(points), nsum, log_r, swp, len(ops), len(units), slot,
             planes.data_ptr(), planes.stride(0) if nsum > 1 else 0, *ext_words,
             acc.data_ptr(), acc.stride(0) if acc.dim() == 3 else 0, *ops_words, *unit_words]
    kernels.REDUCED_OPENING.launches += 1
    kernels.check(so.ts_reduced_opening((ctypes.c_int64 * len(words))(*words),
                                        (ctypes.c_uint32 * len(consts))(*consts), kernels.stream_handle(acc.device)),
                  "reduced opening")


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------
def k10_plan(h: int, w: int) -> Tuple[int, int, int, int]:
    """K10's (columns a lane CB, column groups, log2 K, ranges) for (h, w):
    CB = 4 from 3 columns (else w); a range is 32 K rows, K a power of two
    from 2^3 (a lane loads 8 rows at a time) up to 2^8, as large as keeps
    about K10_ITEMS warp items (ranges x column groups) where the height
    allows."""
    cb = 4 if w >= 3 else max(1, w)
    ncg = -(-w // cb)
    log_k = max(K10_MIN_LOG_K, min(K10_MAX_LOG_K, (h * ncg // (32 * K10_ITEMS)).bit_length() - 1))
    return cb, ncg, log_k, -(-h // (32 << log_k))


@functools.lru_cache(maxsize=256)
def _points_consts(points: Tuple[ExtPoint, ...], r0: int):
    """K10's constants (a ctypes array) for canonical points and r0: each
    point's Monty z^r0 and z^(2^j), j < 32."""
    consts = [0] * 264
    for p, z in enumerate(points):
        consts[132 * p : 132 * p + 4] = _ext_monty(rf.epow(z, r0))
        cur = z
        for j in range(32):
            consts[132 * p + 4 + 4 * j : 132 * p + 8 + 4 * j] = _ext_monty(cur)
            cur = rf.emul(cur, cur)
    return (ctypes.c_uint32 * 264)(*consts)


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
    cb, ncg, log_k, nrange = k10_plan(h, w)
    align = 4 * cb if cb > 1 else 4
    vec = int(cb > 1 and coeffs.data_ptr() % align == 0 and coeffs.stride(0) % cb == 0)
    partial = torch.empty((npts, w, 4, nrange), dtype=torch.int32, device=coeffs.device)
    consts = _points_consts(tuple(tuple(int(c) % bb.P for c in z) for z in points), r0)
    words = (ctypes.c_int64 * 14)(coeffs.data_ptr(), h, w, coeffs.stride(0), npts, cb, log_k, vec, ncg, nrange,
                                  partial.data_ptr(), out.data_ptr(), out.stride(0), int(accumulate))
    kernels.EVAL_AT_POINTS.launches += 1
    kernels.check(so.ts_eval_at_points(words, consts, kernels.stream_handle(coeffs.device)), "eval at points")
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

