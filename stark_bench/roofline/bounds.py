"""Peaks of one H100 SXM and the least time each kernel's work needs.

``HBM_BYTES_PER_S`` is NVIDIA's published 3.35 TB/s.  ``INT32_OPS_PER_S`` is
derived, not published: 132 SMs x 4 sub-partitions x 32 lanes x the 1.98 GHz
boost clock = 33.45 T int32 instructions a second, one instruction a lane a
clock.  The port's own probes reach 58-70 % of it, so a share of it reads
low where a kernel is bound by instructions.  Both assume the card's full
700 W; the harness prints the card's power limit beside every share.

Each ``*_bound`` returns ``(ms, what binds)``: the larger of the bytes over
the bandwidth and the instructions over the int32 rate.  Bytes count each
input word read once and each output word written once; instructions count
the work the function needs, not what a kernel happens to repeat.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 4 * 32 * 1.98e9

KECCAK_F_OPS = 24 * 180  # a Keccak-f permutation: 24 rounds of 180 ALU instructions
NTT_BUTTERFLY_OPS = 9  # Montgomery product 5, add 2, subtract 2
NTT_STAGE0_OPS = 4  # a transform's stage 0: every twiddle is 1, no product
MONTY_MUL_OPS = 5
MOD_ADD_OPS = 2
# K6 an element: two Threefry-2x32 of 20 rounds (an add, a funnel shift and
# an xor each), 12 key injections and the output xor, two conditional
# subtracts (2 each), a Montgomery product and a modular add
THREEFRY_MONTY_OPS = 2 * (20 * 3 + 12 + 1) + 2 * 2 + MONTY_MUL_OPS + 2
# K7 a fold: four 64-bit multiply-adds of raw products (2 each) and a quarter
# of the four settles after every fourth fold (2 each)
QUOTIENT_FOLD_OPS = 4 * 2 + 2
# an ext add 4 modular adds, an ext product by a base element 4 Montgomery
# products, an ext product (Karatsuba) 12 Montgomery products and 27 modular
# adds; the base inverse by square-and-multiply over P - 2 (61 products); an
# ext inverse by the norm
EXT_ADD_OPS = 4 * MOD_ADD_OPS
EXT_MUL_BASE_OPS = 4 * MONTY_MUL_OPS
EXT_MUL_OPS = 12 * MONTY_MUL_OPS + 27 * MOD_ADD_OPS
BASE_INV_OPS = 61 * MONTY_MUL_OPS
EXT_INV_OPS = 8 * MONTY_MUL_OPS + 3 * EXT_MUL_OPS + BASE_INV_OPS + 4 * MONTY_MUL_OPS
K9_POINT_ROW_OPS = MONTY_MUL_OPS + MOD_ADD_OPS + 4 * EXT_MUL_OPS + 2 * EXT_ADD_OPS
K9_ELEMENT_OPS = EXT_MUL_BASE_OPS + EXT_ADD_OPS
K11_OUTPUT_OPS = 2 * (EXT_ADD_OPS + EXT_MUL_BASE_OPS) + MONTY_MUL_OPS + EXT_MUL_OPS + EXT_ADD_OPS
# lazy reduction: a raw 64-bit product-add 2 instructions, a sum settled and
# reduced once; an element 4 product-adds and a quarter of the settle of 4
# sums, a row's plane settled and reduced
LAZY_PRODUCT_OPS = 2
LAZY_SUM_OPS = LAZY_PRODUCT_OPS + MONTY_MUL_OPS
LAZY_ELEMENT_OPS = 4 * LAZY_PRODUCT_OPS + LAZY_PRODUCT_OPS
LAZY_REDUCE_OPS = 4 * LAZY_SUM_OPS
K9_DIVIDE_OPS = ((4 + 8 + 16 + 4) * LAZY_PRODUCT_OPS + 5 * LAZY_SUM_OPS + MOD_ADD_OPS
                 + (3 + 4 + 3) * MONTY_MUL_OPS + EXT_ADD_OPS)
K9_SCALED_OPS = 4 * LAZY_PRODUCT_OPS
K9_DIVIDE_ROW_OPS = 3 * MONTY_MUL_OPS + LAZY_REDUCE_OPS + EXT_ADD_OPS
BASE_INV_CHAIN_OPS = 41 * MONTY_MUL_OPS
K9_RUN_VALUES = 16
MONTY_REDUCE_OPS = 2  # a Montgomery form to its canonical u32
# the last round of a grind candidate's permutation, whose draws read lanes 0-3 only
KECCAK_DIGEST_ROUND_OPS = 58


def bound(n_bytes: float, n_ops: float):
    """(ms, what binds) of a call that moves ``n_bytes`` and runs ``n_ops``
    int32 instructions."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ntt_ops(n: int, stages: int, first: bool) -> int:
    """int32 instructions of ``stages`` butterfly stages over n elements
    (``first``: they include the transform's stage 0)."""
    return n // 2 * (stages * NTT_BUTTERFLY_OPS - first * (NTT_BUTTERFLY_OPS - NTT_STAGE0_OPS))


def dft_bound(h: int, w: int):
    """A transform of w columns of h elements: the matrix read and written
    once, log2 h butterfly stages (however many passes a kernel takes)."""
    return bound(2 * h * w * 4, ntt_ops(h * w, h.bit_length() - 1, True))


def hash_rows_bound(n: int, words: int, rate: int = 17):
    """Keccak over n rows of ``words`` u32 words (two a 64-bit item, ``rate``
    items a permutation): the words read, a 32-byte digest a row written."""
    items = -(-words // 2)
    return bound(n * words * 4 + n * 32, n * -(-items // rate) * KECCAK_F_OPS)


def tree_bound(n: int, levels: int):
    """The ``levels`` compress layers above n digests: n digests read, each
    output digest written, one permutation each."""
    out_rows = n - (n >> levels)
    return bound(n * 32 + out_rows * 32, out_rows * KECCAK_F_OPS)


def keccak_absorb_bound(n: int, p: int, k: int, first: bool, fin: bool, monty: bool = False):
    """One absorb (``fin``: finalize) over n rows of p pending and k new
    words: each word read once (the new ones reduced from their Montgomery
    forms with ``monty``), the 200-byte state read (unless ``first``) and
    written (the digest instead when ``fin``) where a block is absorbed, the
    words after the last whole block written (not ``fin``); one permutation
    a whole block (and the last partial one when ``fin``)."""
    words = p + k
    blocks = words // 34
    perms = blocks + (1 if fin and words % 34 else 0)
    state = fin or blocks > 0
    n_bytes = n * ((0 if first or not state else 200) + (32 if fin else 200 if blocks else 0) + 4 * words
                   + (0 if fin else 4 * (words % 34)))
    return bound(n_bytes, n * (perms * KECCAK_F_OPS + (k * MONTY_REDUCE_OPS if monty else 0)))


def threefry_bound(elems: int):
    """K6, a sample of ``elems`` elements: each written once."""
    return bound(4 * elems, elems * THREEFRY_MONTY_OPS)


def grind_bound(count: int, n_blocks: int):
    """The proof-of-work search over ``count`` candidates: its constants
    read once, a byte out a candidate; n_blocks permutations a candidate,
    the last one's last round for lanes 0-3 only."""
    rounds = (24 * n_blocks - 1) * KECCAK_F_OPS // 24 + KECCAK_DIGEST_ROUND_OPS
    return bound(count + 8 * (25 + 17 * n_blocks), count * rounds)


def quotient_eval_bound(spans, sel_cols: int, n_nodes_mul: int, n_nodes_add: int, n_roots: int, rows: int,
                        add: bool, invz: bool, one_panel: bool = False):
    """K7 over ``rows`` rows of a constraint DAG that reads the column
    ``spans`` [(lo, hi) of the current rows, (lo, hi) of the next rows]:
    those columns read (the union where the next rows are the current
    panel's, ``one_panel``), ``sel_cols`` selectors (and the inverse
    zeroifier with ``invz``), the 16-byte accumulator row written (and read
    with ``add``); a Montgomery product a multiply, a modular add an add,
    subtract or negation, a fold a root."""
    (lo0, hi0), (lo1, hi1) = spans
    if one_panel and hi0 > lo0 and hi1 > lo1 and lo1 <= hi0 and lo0 <= hi1:
        panel_words = max(hi0, hi1) - min(lo0, lo1)
    else:
        panel_words = (hi0 - lo0) + (hi1 - lo1)
    n_bytes = 4 * rows * (panel_words + sel_cols + int(invz)) + 16 * rows * (1 + int(add))
    node_ops = n_nodes_mul * MONTY_MUL_OPS + n_nodes_add * MOD_ADD_OPS
    return bound(n_bytes, rows * (node_ops + QUOTIENT_FOLD_OPS * n_roots))


def panel_fold_bound(n: int, u: int, m: int, r: int):
    """K8 on one quotient coset: (n, u) coefficients folded into r blocks of
    m rows: each coefficient read once, each output written once; a row and
    column the npan - 1 scales and npan - r joins of the fold, the r-point
    DFT's butterflies, r products for the coset scale, and r products a row
    for the next row's scales."""
    npan, log_r = n // m, r.bit_length() - 1
    dft_mul = r // 2 * log_r - (r - 1)
    per = MONTY_MUL_OPS * (npan - 1 + dft_mul + r) + MOD_ADD_OPS * (npan - r + r * log_r)
    return bound(4 * (n + r * m) * u, m * u * per + m * r * MONTY_MUL_OPS)


def reduced_opening_bound(rows: int, log_h: int, row0: int, widths, npts: int, ext_in: bool, nsum: int = 1,
                          scaled: int = 0):
    """K9 over ``npts`` points in one read: each operand word read once for
    all the points, the accumulator rows read and written (a plane a sum
    with no point), the ext sums read; instructions the lesser of two
    counts (a point at a time with full reductions, and the lazy count with
    the division in the base field)."""
    width = sum(widths)
    n_bytes = 4 * rows * width + 32 * rows * (1 if npts else nsum) + (16 * rows * nsum if ext_in else 0)
    run = 8 if row0 % 256 == 0 else 1

    def one(point: bool) -> float:
        ops = rows * width * K9_ELEMENT_OPS + rows * (EXT_ADD_OPS if ext_in else 0)
        if point:
            return ops + rows * K9_POINT_ROW_OPS + -(-rows // run) * (1.5 * log_h * MONTY_MUL_OPS + EXT_INV_OPS)
        return ops + rows * EXT_ADD_OPS

    old = npts * one(True) if npts else nsum * one(False)
    new = rows * nsum * (width * LAZY_ELEMENT_OPS + (LAZY_REDUCE_OPS if width else 0) + (EXT_ADD_OPS if ext_in else 0))
    if npts:
        new += (rows * (K9_DIVIDE_ROW_OPS + npts * K9_DIVIDE_OPS + scaled * K9_SCALED_OPS)
                + -(-rows * npts // K9_RUN_VALUES) * BASE_INV_CHAIN_OPS)
    else:
        new += rows * nsum * EXT_ADD_OPS
    return bound(n_bytes, min(old, new))


def eval_at_points_bound(h: int, w: int, npts: int):
    """K10: each coefficient read once and the (npts, w, 4) result written;
    instructions the lesser of the full-reduction and the lazy counts."""
    old = npts * (h * w * K9_ELEMENT_OPS + h * EXT_MUL_OPS)
    new = npts * (h * w * LAZY_ELEMENT_OPS + w * (LAZY_REDUCE_OPS + EXT_MUL_OPS))
    return bound(4 * h * w + 16 * npts * w, min(old, new))


def fri_fold_bound(n: int, add: bool):
    """K11: the n ext rows read, n / 2 written (and read with ``add``)."""
    half = n // 2
    return bound(16 * n + 16 * half * (2 if add else 1), half * (K11_OUTPUT_OPS + (EXT_ADD_OPS if add else 0)))
