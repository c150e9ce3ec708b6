"""Poseidon2 hash-chain AIR (counterpart of ``tpu_stark/air/poseidon2_air.py``;
BASELINE config 3: 2^18 rows, blowup 4, the Poseidon2 stack).

Proves a chain ``state_{i+1} = Poseidon2(state_i)`` with one full width-16
permutation per trace row.  Aux columns keep every constraint at degree <= 3:
for each S-box x^7 the witness stores y = e^3, so x^7 = y^2 * e is a cubic
expression in columns.

Column layout (width = 16 + 8*32 + 13*17 = 493):

  [0:16)       input state x of the row
  per external round r (8):   y_r (16 cols), o_r (16 cols)
  per internal round r (13):  y0_r (1 col),  o_r (16 cols)

Constraints:
  * first row:   x = public[0:16]
  * per round:   y = (e + rc)^3 ; o = MDS/diag combination of y^2 (e + rc)
  * transition:  next.x = o_last
  * last row:    o_last = public[16:32]

The chain itself is sequential; ``generate_trace`` runs it on the host
through the C permutation, then expands every row's round intermediates in
one vectorized plain torch pass on the given device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..fields import babybear as bb
from ..hash import poseidon2
from .air import AirBuilder, BaseAir

W = 16
COLS = W + poseidon2.ROUNDS_F * (2 * W) + poseidon2.rounds_p(W) * (W + 1)


def _mds_generic(vals: List):
    """M_E = circ(2*M4, M4, ...) over generic builder values (adds only)."""

    def m4(x0, x1, x2, x3):
        t0 = x0 + x1
        t1 = x2 + x3
        t2 = (x1 + x1) + t1
        t3 = (x3 + x3) + t0
        t4 = ((t1 + t1) + (t1 + t1)) + t3
        t5 = ((t0 + t0) + (t0 + t0)) + t2
        return [t3 + t5, t5, t2 + t4, t4]

    blocks = [m4(*vals[i : i + 4]) for i in range(0, W, 4)]
    sums = []
    for j in range(4):
        s = blocks[0][j]
        for blk in blocks[1:]:
            s = s + blk[j]
        sums.append(s)
    return [blocks[i][j] + sums[j] for i in range(W // 4) for j in range(4)]


class Poseidon2ChainAir(BaseAir):
    width = COLS

    def eval(self, b: AirBuilder) -> None:
        ext_rc, int_rc = poseidon2.round_constants(W)
        diag = poseidon2.internal_diag(W)
        local = b.main_row(0)
        nxt = b.main_row(1)

        x = local[0:W]
        first = b.when_first_row()
        for j in range(W):
            first.assert_eq(x[j], b.public_value(j))

        col = W
        state = _mds_generic(x)
        half = poseidon2.ROUNDS_F // 2

        def external(r, state, col):
            e = [state[j] + int(ext_rc[r][j]) for j in range(W)]
            y = local[col : col + W]
            col += W
            for j in range(W):
                b.assert_eq(y[j], e[j] * e[j] * e[j])
            z = [y[j] * y[j] * e[j] for j in range(W)]
            o = local[col : col + W]
            col += W
            mz = _mds_generic(z)
            for j in range(W):
                b.assert_eq(o[j], mz[j])
            return list(o), col

        for r in range(half):
            state, col = external(r, state, col)
        for r in range(poseidon2.rounds_p(W)):
            e0 = state[0] + int(int_rc[r])
            y0 = local[col]
            col += 1
            b.assert_eq(y0, e0 * e0 * e0)
            z0 = y0 * y0 * e0
            wvals = [z0] + list(state[1:])
            tot = wvals[0]
            for v in wvals[1:]:
                tot = tot + v
            o = local[col : col + W]
            col += W
            for j in range(W):
                b.assert_eq(o[j], int(diag[j]) * wvals[j] + tot)
            state = list(o)
        for r in range(half, poseidon2.ROUNDS_F):
            state, col = external(r, state, col)
        assert col == COLS

        trans = b.when_transition()
        for j in range(W):
            trans.assert_eq(nxt[j], state[j])
        last = b.when_last_row()
        for j in range(W):
            last.assert_eq(state[j], b.public_value(W + j))


# ---------------------------------------------------------------------------
# Trace generation
# ---------------------------------------------------------------------------
def _expand_rows(inputs: torch.Tensor) -> torch.Tensor:
    """(N, 16) Monty row inputs -> (N, COLS) Monty trace (vectorized)."""
    ext_np, int_np, diag_np = poseidon2.consts_monty(W)
    ext_rc = bb.to_tensor(ext_np, inputs.device)
    diag = bb.to_tensor(diag_np, inputs.device)
    cols = [inputs]
    state = poseidon2.external_mds_plain(inputs)
    half = poseidon2.ROUNDS_F // 2

    def external(r, state):
        e = bb.add(state, ext_rc[r])
        y = bb.mul(bb.mul(e, e), e)
        cols.append(y)
        o = poseidon2.external_mds_plain(bb.mul(bb.mul(y, y), e))
        cols.append(o)
        return o

    for r in range(half):
        state = external(r, state)
    for r in range(poseidon2.rounds_p(W)):
        e0 = bb.add(state[:, :1], int(int_np[r]))
        y0 = bb.mul(bb.mul(e0, e0), e0)
        cols.append(y0)
        wv = torch.cat([bb.mul(bb.mul(y0, y0), e0), state[:, 1:]], dim=1)
        state = bb.add(bb.mul(wv, diag), bb.sum_mod(wv, axis=1)[:, None])
        cols.append(state)
    for r in range(half, poseidon2.ROUNDS_F):
        state = external(r, state)
    return torch.cat(cols, dim=1)


def generate_trace(n_rows: int, initial_state: Sequence[int], device="cuda") -> tuple:
    """(trace canonical (n, COLS) uint32 numpy array, public_values[32]).
    The row expansion runs on ``device`` (the card unless the caller passes
    another device)."""
    if n_rows < 1 or n_rows & (n_rows - 1):
        raise ValueError(f"trace length {n_rows} is not a power of two")
    state = [int(v) % bb.P for v in initial_state]
    states = np.empty((n_rows, W), dtype=np.uint32)
    for i in range(n_rows):
        states[i] = state
        state = poseidon2.permute_host(state)
    trace = _expand_rows(bb.to_tensor(bb.np_to_monty(states), torch.device(device)))
    pis = [int(v) % bb.P for v in initial_state] + [int(v) for v in state]
    return bb.to_numpy(bb.to_u32(trace)), pis
