"""Distributed batch NTT over a row mesh (counterpart of
``tpu_stark/dist/ntt.py``).

Radix-2 over rows, contiguous row blocks: rank d of n holds rows
[d * L, (d + 1) * L) of a height-H matrix, L = H / n.

* **Forward = decimation in frequency.**  Stage s pairs rows at stride
  H / 2^(s+1), so exactly the first log2(n) stages cross ranks, each one
  whole-block pair exchange (rank d with d ^ stride).  The rest act inside
  a block, and because block offsets are multiples of every later stride
  they are a standard length-L DIF with standard twiddles: natural in,
  bit-reversed out, which is ``reverse_matrix_index_bits(dft(x))`` on
  kernel K2.
* **Output order is commit order.**  The DIF leaves X[bitrev(j)] at row j:
  with contiguous blocks that is the bit-reversed frame the Merkle commit
  wants, so the sharded pipeline never builds natural-order evaluations.
* **Inverse = decimation in time** from that frame: the local stages
  (``dft(reverse_matrix_index_bits(x), inverse=True)`` on K2, without the
  1/H scale), then log2(n) exchanges, natural-order coefficients out.
* An exchange stage's twiddles are w^((d & (stride - 1)) * L + t): the
  rank's scalar w^(L * (d & (stride - 1))), a host ``pow`` (the rank is a
  Python int), times the powers w^t.  The butterflies, twiddle products
  and permutations of the exchange stages are plain torch, as JAX's are
  plain ``jnp``.
* The bit-reversal reshard (natural <-> bit-reversed frame, an involution)
  is one all-to-all plus local permutations; it needs H >= n^2.

Every function takes the mesh and the rank's block and returns the rank's
block of the result.
"""

from __future__ import annotations

import torch

from ..fields import babybear as bb
from ..matrix import bit_reversal_perm_device, log2_strict, reverse_matrix_index_bits
from ..ntt import ntt_kernel
from .comm import RowMesh, block


def _root(log_order: int, inverse: bool) -> int:
    root = bb.two_adic_generator(log_order)
    return pow(root, bb.P - 2, bb.P) if inverse else root


def _block_powers(base: int, start: int, count: int, device) -> torch.Tensor:
    """Canonical base^(start + t) for t < count, int64 on ``device``."""
    return bb.powers(base, count, device) * pow(base, start, bb.P) % bb.P


def _dif_exchange_stage(mesh: RowMesh, local: torch.Tensor, s: int, log_h: int, inverse_root: bool) -> torch.Tensor:
    """Cross-rank DIF stage s (s < log2(n)): half = H >> (s + 1) >= L.
    lo' = a + c; hi' = (a - c) * w^(j mod half), w of order 2 * half."""
    d, log_nd = mesh.rank, mesh.log_size
    l = int(local.shape[0])
    stride = 1 << (log_nd - s - 1)
    other = mesh.exchange(local, d ^ stride)
    if d & stride == 0:
        return bb.add(local, other)
    root = _root(log_h - s, inverse_root)
    tw = _block_powers(root, l * (d & (stride - 1)), l, local.device)
    return bb.mul_canonical(bb.sub(other, local), tw[:, None])


def _dit_exchange_stage(mesh: RowMesh, local: torch.Tensor, s: int, log_h: int, inverse_root: bool) -> torch.Tensor:
    """Cross-rank DIT stage (half = L << s): lo' = a + w^j b;
    hi' = a - w^j b, w of order 2 * half."""
    d = mesh.rank
    l = int(local.shape[0])
    stride = 1 << s
    other = mesh.exchange(local, d ^ stride)
    root = _root(log2_strict(l) + s + 1, inverse_root)
    tw = _block_powers(root, l * (d & (stride - 1)), l, local.device)[:, None]
    if d & stride == 0:
        return bb.add(local, bb.mul_canonical(other, tw))
    return bb.sub(other, bb.mul_canonical(local, tw))


def _check(mesh: RowMesh, x: torch.Tensor, log_h: int) -> None:
    if x.device != mesh.device:
        raise ValueError(f"a block on {x.device} given to a mesh on {mesh.device}")
    if int(x.shape[0]) << mesh.log_size != 1 << log_h:
        raise ValueError(f"a block of {x.shape[0]} rows is not 2^{log_h} / {mesh.size}")


def dft_br(mesh: RowMesh, x: torch.Tensor, log_h: int, inverse_root: bool = False) -> torch.Tensor:
    """Sharded forward NTT (unscaled, the inverse root if asked): the
    rank's natural-order block in, its block of the bit-reversed
    evaluations out."""
    _check(mesh, x, log_h)
    for s in range(mesh.log_size):
        x = _dif_exchange_stage(mesh, x, s, log_h, inverse_root)
    return reverse_matrix_index_bits(ntt_kernel.dft(x.contiguous(), inverse=inverse_root))


def idft_from_br(mesh: RowMesh, x: torch.Tensor, log_h: int) -> torch.Tensor:
    """Sharded inverse NTT: the rank's block of bit-reversed evaluations
    in, its block of natural-order coefficients out (with the 1/H scale)."""
    _check(mesh, x, log_h)
    x = ntt_kernel.dft(reverse_matrix_index_bits(x).contiguous(), inverse=True)
    for s in range(mesh.log_size):
        x = _dit_exchange_stage(mesh, x, s, log_h, inverse_root=True)
    return bb.mul_canonical(x, pow(1 << log_h, bb.P - 2, bb.P))


def bitrev_reshard(mesh: RowMesh, x: torch.Tensor, log_h: int) -> torch.Tensor:
    """Global row bit-reversal of a sharded matrix (an involution).

    With i = d * L + t, bitrev_H(d * L + t) = bitrev_L(t) * n + rev_n(d):
    rank d ends up with the stride-n residue class rev_n(d), ordered by
    bitrev_L.  One all-to-all moves the classes; the relabeling and the
    local bitrev_L are permutations."""
    _check(mesh, x, log_h)
    n, log_nd = mesh.size, mesh.log_size
    l, w = int(x.shape[0]), int(x.shape[1])
    log_l = log2_strict(l)
    if log_nd == 0:
        return reverse_matrix_index_bits(x)
    if log_l < log_nd:
        raise ValueError(f"the bit-reversal reshard needs H >= n^2 (H = 2^{log_h}, n = {n})")
    y = x.reshape(l // n, n, w).transpose(0, 1)  # y[r][q] = local row q * n + r
    z = y[bit_reversal_perm_device(log_nd, x.device)]  # z[e] = y[rev(e)], sent to rank e
    recv = mesh.all_to_all_rows(list(z), [l // n] * n, "bitrev_reshard")
    return reverse_matrix_index_bits(torch.cat(recv, dim=0))


def row_powers(mesh: RowMesh, log_h: int, base: int, device) -> torch.Tensor:
    """Canonical base^i for the rank's rows i of a height-2^log_h matrix."""
    r0, rows = block(mesh, 1 << log_h)
    return _block_powers(base, r0, rows, device)


def scale_rows_by_powers(mesh: RowMesh, x: torch.Tensor, log_h: int, base: int) -> torch.Tensor:
    """x[i] *= base^i on a natural-order sharded matrix."""
    _check(mesh, x, log_h)
    return bb.mul_canonical(x, row_powers(mesh, log_h, base % bb.P, x.device)[:, None])


def move_rows(mesh: RowMesh, held, pieces, wanted, name: str = "move_rows"):
    """Rows of a global matrix moved to the ranks that want them, in one
    all-to-all.  ``held(j)``: the (first row, rows) intervals that rank j
    holds, disjoint over the ranks, and ``pieces`` this rank's tensors of
    its intervals; ``wanted(j)``: the intervals rank j needs.  Returns a
    tensor per wanted interval of this rank; a row that no rank holds is
    zero.  Every rank knows every rank's intervals, so the counts need no
    collective of their own."""
    n, d = mesh.size, mesh.rank
    mine = list(held(d))
    like = pieces[0]

    def segments(want, have):
        """(wanted interval, held interval, first row, rows) of each
        overlap, in the order the rows travel."""
        out = []
        for wi, (w0, wc) in enumerate(want):
            for hi, (h0, hc) in enumerate(have):
                a, b = max(w0, h0), min(w0 + wc, h0 + hc)
                if a < b:
                    out.append((wi, hi, a, b - a))
        return out

    parts = []
    for j in range(n):
        segs = segments(list(wanted(j)), mine)
        parts.append(torch.cat([pieces[hi][a - mine[hi][0] : a - mine[hi][0] + c] for _, hi, a, c in segs])
                     if segs else like[:0])
    want = list(wanted(d))
    plan = [segments(want, list(held(j))) for j in range(n)]
    got = mesh.all_to_all_rows(parts, [sum(seg[3] for seg in segs) for segs in plan], name)
    out = [torch.zeros((c, int(like.shape[1])), dtype=like.dtype, device=like.device) for _, c in want]
    for rows, segs in zip(got, plan):
        pos = 0
        for wi, _, a, c in segs:
            out[wi][a - want[wi][0] : a - want[wi][0] + c] = rows[pos : pos + c]
            pos += c
    return out


def reshard_rows(mesh: RowMesh, x: torch.Tensor, h_in: int, h_out: int, name: str = "reshard") -> torch.Tensor:
    """The height-h_in sharded matrix cut to its first h_out rows, or
    zero-extended to h_out rows, in blocks of h_out / n rows (the zero pad
    of the LDE and the prefix of the quotient domain: GSPMD reshards in
    JAX).  Only rows that exist move; zeros are made where they land."""
    n, d = mesh.size, mesh.rank
    li, lo = h_in // n, h_out // n
    if int(x.shape[0]) != li or li * n != h_in or lo * n != h_out:
        raise ValueError(f"cannot reshard {tuple(x.shape)} blocks of {h_in} rows into {h_out} over {n} ranks")
    live = min(h_in, h_out)

    def held(j):
        return [(j * li, max(0, min(li, live - j * li)))]

    return move_rows(mesh, held, [x[: held(d)[0][1]]], lambda j: [(j * lo, lo)], name)[0]


def pad_rows(mesh: RowMesh, x: torch.Tensor, log_h: int, added_bits: int) -> torch.Tensor:
    """Zero-pad (H, w) -> (H << added_bits, w), both sharded: the
    coefficient block spreads from H / n rows a rank to (H << b) / n."""
    return reshard_rows(mesh, x, 1 << log_h, 1 << (log_h + added_bits), "pad")


def coset_lde_br(mesh: RowMesh, evals_natural: torch.Tensor, added_bits: int, shift: int) -> torch.Tensor:
    """Sharded coset LDE in commit order: the rank's block of natural-order
    evals on the plain subgroup of height H in, its block of the
    bit-reversed codeword on shift * <g'> of height H << added_bits out
    (iNTT, coset scale, zero pad, DIF NTT)."""
    log_h = log2_strict(int(evals_natural.shape[0]) << mesh.log_size)
    evals_br = bitrev_reshard(mesh, evals_natural, log_h)
    coeffs = idft_from_br(mesh, evals_br, log_h)
    scaled = scale_rows_by_powers(mesh, coeffs, log_h, shift % bb.P)
    padded = pad_rows(mesh, scaled, log_h, added_bits)
    return dft_br(mesh, padded, log_h + added_bits)
