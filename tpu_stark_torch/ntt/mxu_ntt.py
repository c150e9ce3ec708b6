"""The 4-step NTT over limb matmuls (counterpart of
``tpu_stark/ntt/mxu_ntt.py``), with kernel K5 (``csrc/mxu_ntt.cu``).

* 4-step decomposition: H = A * B with x[a + A*b];
      y[c + B*d] = sum_a w_A^(ad) * w^(ac) * (sum_b x[a + A*b] * w_B^(bc))
  two matrix DFTs of size <= 256 along axis 0, joined by an elementwise
  Montgomery twiddle product, recursing on the A axis.
* Exact integer matmul: operands stay Monty; the DFT matrix is stored with
  an extra Montgomery factor R and split into four 8-bit limbs, the data
  too, and the 16 limb products are summed per diagonal s = i + j.  The 7
  diagonals recombine into a 3-word (96-bit) integer, reduced by one
  Montgomery REDC step back into Monty form.

K5 (``csrc/mxu_ntt.cu``) replaces ``_mm_kernel`` /
``_mod_matmul_axis_pallas`` and runs every level of ``dft_axis0`` in one
launch, through two wrappers:

* ``mod_matmul_axis(x, w_limbs)``: the leaf level, out[c, m] for x (n, M);
* ``mod_matmul_twiddle_moved(x, w_limbs, tw)``: an inner level, the product
  along axis 0 of x viewed as (B, A, ...), times the 4-step twiddles
  w^(a*c), stored with the A axis moved to the front: (A, B, ...), the
  tensor the next level transforms.

On a CUDA tensor each launches the kernel (its limb products are u8 x u8
-> s32 ``wgmma`` products) or raises; on a CPU tensor each runs its plain
version: ``mod_matmul_axis_plain`` (``_mod_matmul_axis``: limb products as
float64 matrix products, exact since n * 255^2 < 2^53 and out of TF32's
reach, int64 diagonals, the 3-word recombine and
``reduce_3word_monty_plain``), and ``mod_matmul_twiddle_moved_plain``,
that product, then ``bb.mul`` by the twiddles and the moved axis as a copy:
the JAX package's sequence in ``_dft_axis0``.  Unlike the TPU kernel it
takes any M: no (n, 512) tiles and no fallback for ragged widths.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from .. import kernels
from ..fields import babybear as bb
from ..matrix import log2_strict

MAX_DIRECT = 256  # largest direct DFT matmul
MIN_KERNEL_N = 16  # K5 takes n = 16 .. 256 (K padded to 32 below 32)

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# 3-word Montgomery reduction (int64 tensors holding u32 words)
# ---------------------------------------------------------------------------
def reduce_3word_monty_plain(w0: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """(w0 + 2^32 w1 + 2^64 w2) * R^-1 mod p in [0, p), as int32, for a
    value below 2^64 * p.  One REDC step (an exact division by 2^32), then
    Solinas folds of the high word (2^32 = 2^28 - 2 mod p) and conditional
    subtracts, the JAX package's sequence on u32 words."""
    # w0 * MU mod 2^32 with MU = 2^31 + 2^27 + 1, every term below 2^63
    t = (w0 + ((w0 << 27) & _M32) + ((w0 << 31) & _M32)) & _M32
    u = t * bb.P  # < 2^63; its low word equals w0
    u_hi = u >> 32
    borrow = (w1 < u_hi).to(torch.int64)
    v0 = (w1 - u_hi) & _M32
    v1 = (w2 - borrow) & _M32
    v1 = torch.where(v1 >= 1 << 31, (v1 + bb.P) & _M32, v1)
    for _ in range(8):
        lo = (v1 << 28) & _M32
        hi = v1 >> 4
        two_v1 = (v1 << 1) & _M32
        s0 = (v0 + lo) & _M32
        carry = (s0 < v0).to(torch.int64)
        borrow2 = (s0 < two_v1).to(torch.int64)
        v0 = (s0 - two_v1) & _M32
        v1 = (hi + carry - borrow2) & _M32
    fold_c = (1 << 28) - 2
    add = torch.where(v1 != 0, fold_c, 0)
    s = (v0 + add) & _M32
    wrapped = (s < v0) & (add != 0)
    v0 = torch.where(wrapped, (s + fold_c) & _M32, s)
    v0 = torch.where(v0 >= bb.P, v0 - bb.P, v0)
    v0 = torch.where(v0 >= bb.P, v0 - bb.P, v0)
    return v0.to(torch.int32)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def dft_matrix_limbs(n: int, inverse: bool) -> np.ndarray:
    """(4, n, n) uint8 limbs (least significant first) of W[b, c] =
    g_n^(bc) * R mod p, the n-point DFT matrix with an extra Montgomery R so
    that REDC(x_monty . W) stays in Monty form."""
    g = bb.two_adic_generator(log2_strict(n))
    if inverse:
        g = pow(g, bb.P - 2, bb.P)
    pows = bb.np_powers(g, n).astype(np.uint64)
    idx = np.arange(n, dtype=np.int64)
    w = pows[(idx[:, None] * idx[None, :]) % n]  # g has order n
    w = (w << 32) % bb.P
    return np.stack([(w >> (8 * i)) & 0xFF for i in range(4)]).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def twiddle_monty(a: int, b: int, inverse: bool) -> np.ndarray:
    """(A, B) Monty twiddles w^(a*c) for w = g_(A*B)."""
    g = bb.two_adic_generator(log2_strict(a * b))
    if inverse:
        g = pow(g, bb.P - 2, bb.P)
    pows = bb.np_powers(g, a * b).astype(np.uint64)
    ra = np.arange(a, dtype=np.int64)[:, None]
    cb = np.arange(b, dtype=np.int64)[None, :]
    return bb.np_to_monty(pows[ra * cb].astype(np.uint32))


_DEVICE_TABLES: Dict[Tuple[str, str, int, bool], torch.Tensor] = {}


def _on_device(kind: str, key: Tuple[int, ...], inverse: bool, device, make) -> torch.Tensor:
    """A table made by ``make()``, cached per (device, kind, size, direction)."""
    k = (str(torch.device(device)), kind, key, inverse)
    t = _DEVICE_TABLES.get(k)
    if t is None:
        t = _DEVICE_TABLES[k] = make().to(device)
    return t


def limbs_on(n: int, inverse: bool, device) -> torch.Tensor:
    return _on_device("limbs", (n,), inverse, device,
                      lambda: torch.from_numpy(dft_matrix_limbs(n, inverse)))


def twiddles_on(a: int, b: int, inverse: bool, device) -> torch.Tensor:
    """The (A, B) Monty twiddles w^(a*c) of an inner level, on ``device``."""
    return _on_device("twiddle", (a, b), inverse, device,
                      lambda: bb.to_tensor(twiddle_monty(a, b, inverse), "cpu"))


def slice_rows(n: int) -> int:
    """Output rows c in one block's slice of the kernel's table."""
    return n if n <= 128 else 64


def kernel_image(w_limbs: torch.Tensor) -> torch.Tensor:
    """The table K5 reads, flat uint8, for a (4, n, n) limb table of W: the
    limbs of W * R mod p (one more Montgomery factor, which the kernel's
    two-step reduction takes out), transposed to K-major rows c, zero past
    n up to K = max(n, 32), and laid out as the kernel's shared memory
    holds it: per slice of ``slice_rows(n)`` rows c, per limb j, core
    matrices of 8 rows x 16 bytes, element (c, k) at (c // 8) * 8K +
    (k // 16) * 128 + (c % 8) * 16 + k % 16."""
    n = int(w_limbs.shape[1])
    k, nc = max(n, 32), slice_rows(n)
    w = sum(w_limbs[j].to(torch.int64) << (8 * j) for j in range(4))  # W[b, c]
    w = (w << 32) % bb.P
    t = torch.zeros((4, n, k), dtype=torch.uint8, device=w_limbs.device)
    for j in range(4):
        t[j, :, :n] = ((w >> (8 * j)) & 0xFF).to(torch.uint8).T
    t = t.view(4, n // nc, nc // 8, 8, k // 16, 16).permute(1, 0, 2, 4, 3, 5)
    return t.contiguous().view(-1)


_IMAGES: Dict[int, Tuple[torch.Tensor, int, torch.Tensor]] = {}


def _image_of(w_limbs: torch.Tensor) -> torch.Tensor:
    """``kernel_image(w_limbs)``, made once per table tensor (the entry
    keeps the tensor alive, so its id is not reused; an in-place change of
    the table makes a new image)."""
    hit = _IMAGES.get(id(w_limbs))
    if hit is not None and hit[0] is w_limbs and hit[1] == w_limbs._version:
        return hit[2]
    if len(_IMAGES) >= 64:
        _IMAGES.clear()
    image = kernel_image(w_limbs)
    _IMAGES[id(w_limbs)] = (w_limbs, w_limbs._version, image)
    return image


# ---------------------------------------------------------------------------
# K5 and its plain version
# ---------------------------------------------------------------------------
def _accumulate_and_reduce(diags) -> torch.Tensor:
    """sum_s 2^(8s) diags[s] (int64, each < 2^27) -> 3 u32 words -> Monty."""
    w0 = diags[0]
    w1 = torch.zeros_like(w0)
    w2 = torch.zeros_like(w0)
    for s in range(1, 7):
        d = diags[s]
        shift = 8 * s
        if shift < 32:
            lo = (d << shift) & _M32
            hi = d >> (32 - shift)
            nw0 = (w0 + lo) & _M32
            carry = (nw0 < w0).to(torch.int64)
            w0 = nw0
            nw1 = (w1 + hi + carry) & _M32
            w2 = w2 + (nw1 < w1).to(torch.int64)
            w1 = nw1
        else:
            sh = shift - 32
            lo = (d << sh) & _M32
            hi = d >> (32 - sh) if sh else torch.zeros_like(d)
            nw1 = (w1 + lo) & _M32
            carry = (nw1 < w1).to(torch.int64)
            w1 = nw1
            w2 = w2 + hi + carry
    return reduce_3word_monty_plain(w0, w1, w2)


def mod_matmul_axis_plain(x: torch.Tensor, w_limbs: torch.Tensor) -> torch.Tensor:
    """out[c, ...] = REDC(sum_b x[b, ...] * W[b, c]) for x (n, ...) int32
    Monty and the (4, n, n) uint8 limb table, on any device."""
    n = int(x.shape[0])
    rest = tuple(x.shape[1:])
    x2 = x.reshape(n, -1).to(torch.int64) & _M32
    xl = [((x2 >> (8 * i)) & 0xFF).to(torch.float64) for i in range(4)]
    wl = [w_limbs[j].to(torch.float64).T for j in range(4)]  # (c, b)
    diags = [None] * 7
    for i in range(4):
        for j in range(4):
            d = torch.matmul(wl[j], xl[i]).to(torch.int64)  # (c, m), exact
            s = i + j
            diags[s] = d if diags[s] is None else diags[s] + d
    return _accumulate_and_reduce(diags).reshape((n,) + rest)


def mod_matmul_twiddle_moved_plain(x: torch.Tensor, w_limbs: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """y[a, c, ...] = REDC(sum_b x[b, a, ...] * W[b, c]) * tw[a, c] (Monty)
    for x (B, A, ...) and the (A, B) twiddles: ``mod_matmul_axis_plain``,
    the twiddle product and the moved axis, as ``_dft_axis0`` runs them."""
    b, a = int(x.shape[0]), int(x.shape[1])
    t = bb.mul(mod_matmul_axis_plain(x, w_limbs), tw.T.reshape(b, a, *([1] * (x.dim() - 2))))
    return t.movedim(1, 0).contiguous()


def _checked(x: torch.Tensor, w_limbs: torch.Tensor, tw=None) -> int:
    """Raise on what the kernel does not take (the device last, so that
    each refusal shows on a meta tensor); return n."""
    n = int(x.shape[0]) if x.dim() else 0
    if x.dtype != torch.int32 or w_limbs.dtype != torch.uint8:
        raise TypeError("mxu matmul takes int32 Monty data and a uint8 limb table")
    if tuple(w_limbs.shape) != (4, n, n) or w_limbs.device != x.device:
        raise ValueError(f"mxu matmul: limb table {tuple(w_limbs.shape)} on {w_limbs.device} "
                         f"for {n} rows on {x.device}")
    if not (MIN_KERNEL_N <= n <= MAX_DIRECT) or n & (n - 1):
        raise ValueError(f"mxu matmul: the kernel takes n = 16, 32, 64, 128 or 256, got {n}")
    if not x.is_contiguous():
        raise ValueError("mxu matmul: the kernel takes a contiguous x")
    if tw is not None:
        a = int(x.shape[1]) if x.dim() > 1 else -1
        if (tw.dtype != torch.int32 or tuple(tw.shape) != (a, n) or tw.device != x.device
                or not tw.is_contiguous()):
            raise ValueError(f"mxu matmul: twiddles {tw.dtype} {tuple(tw.shape)} on {tw.device} for x "
                             f"{tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"mxu matmul: unsupported device {x.device}")
    return n


def _launch(x: torch.Tensor, w_limbs: torch.Tensor, tw, out: torch.Tensor, a: int, r: int) -> None:
    so = kernels.lib()
    kernels.MXU_MM.launches += 1
    kernels.check(
        so.ts_mxu_mm(x.data_ptr(), _image_of(w_limbs).data_ptr(), None if tw is None else tw.data_ptr(),
                     out.data_ptr(), int(x.shape[0]), a, r, kernels.stream_handle(x.device)),
        "mxu matmul",
    )


def mod_matmul_axis(x: torch.Tensor, w_limbs: torch.Tensor) -> torch.Tensor:
    """K5 at the leaf: ``mod_matmul_axis_plain``'s function, the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return mod_matmul_axis_plain(x, w_limbs)
    n = _checked(x, w_limbs)
    out = torch.empty_like(x)
    m = x.numel() // n
    if m:
        _launch(x, w_limbs, None, out, 1, m)
    return out


def mod_matmul_twiddle_moved(x: torch.Tensor, w_limbs: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """K5 at an inner level: ``mod_matmul_twiddle_moved_plain``'s function
    for x (B, A, ...) and the (A, B) int32 twiddles, the kernel on a CUDA
    tensor (one launch: product, twiddle and moved store), the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return mod_matmul_twiddle_moved_plain(x, w_limbs, tw)
    n = _checked(x, w_limbs, tw)
    a = int(x.shape[1])
    out = torch.empty((a, n) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    r = x.numel() // (n * a) if a else 0
    if r:
        _launch(x, w_limbs, tw, out, a, r)
    return out


# ---------------------------------------------------------------------------
# 4-step DFT along axis 0
# ---------------------------------------------------------------------------
def dft_axis0(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Unscaled DFT along axis 0 (length a power of two), natural order in
    and out, any trailing batch axes; Monty in and out.  One K5 launch a
    level on the card."""
    n = int(x.shape[0])
    log_n = log2_strict(n)
    x = x.contiguous()
    if n <= MAX_DIRECT:
        return mod_matmul_axis(x, limbs_on(n, inverse, x.device))
    log_b = min(log_n // 2, 8)
    b = 1 << log_b
    a = n // b
    rest = tuple(x.shape[1:])
    # x[a + A*b] -> X[b, a, ...]: the inner DFT over b for each a, times
    # w^(a*c), with the a axis moved to the front: (A, B, ...)
    t = mod_matmul_twiddle_moved(x.reshape(b, a, *rest), limbs_on(b, inverse, x.device),
                                 twiddles_on(a, b, inverse, x.device))
    # the outer DFT over a (recursive); y[c + B*d] = t3[d, c, ...]
    return dft_axis0(t, inverse).reshape((n,) + rest)


def dft_batch(mat: torch.Tensor) -> torch.Tensor:
    """(H, W) Monty NTT of every column, natural order."""
    return dft_axis0(mat, False)


def idft_batch(mat: torch.Tensor) -> torch.Tensor:
    """Inverse NTT, scaled by H^-1."""
    h = int(mat.shape[0])
    return bb.mul_canonical(dft_axis0(mat, True), pow(h, bb.P - 2, bb.P))


def supports(h: int, w: int) -> bool:
    return 2 <= h <= (1 << bb.TWO_ADICITY)
