"""Pricing the port's kernel wrappers call by call.

``Pricer`` replaces each wrapper named in ``WRAPPERS`` by one that adds the
call's bound (``bounds.py``) to the phase in progress, then calls the
original; leaving the ``with`` block puts the originals back.  A wrapper the
program no longer has is skipped, and a call that no entry knows adds
nothing: a renamed or new wrapper can only lower a share, never raise it.
Only the traced run prices calls.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Tuple

from . import bounds as b


def _cols(t) -> int:
    return 0 if t is None else int(t.shape[1])


def _hash_rows(a, b_=None):
    return b.hash_rows_bound(int(a.shape[0]), _cols(a) + _cols(b_))


def _compress_levels(digests, levels):
    return b.tree_bound(int(digests.shape[0]), levels)


def _absorb_rows(state, mat, first=False, pend=None, monty=False, natural=False):
    return b.keccak_absorb_bound(int(state.shape[1]), _cols(pend), _cols(mat), first, False, monty)


def _finalize_rows(state, pend, first=False, mat=None, monty=False, natural=False):
    return b.keccak_absorb_bound(int(state.shape[1]), _cols(pend), _cols(mat), first, True, monty)


def _dft(x, inverse=False):
    return b.dft_bound(int(x.shape[0]), int(x.shape[1]))


def _threefry(k, rows, cols, device, sel=None, row0=0, row_idx=None):
    n = rows if row_idx is None else len(row_idx)
    return b.threefry_bound(n * (cols if sel is None else len(sel)))


def _verdicts(start, count, prefix, tail, w_off, bits):
    return b.grind_bound(count, int(tail.shape[0]))


def _same_panel(cur, nxt) -> bool:
    return cur.data_ptr() == nxt.data_ptr() and cur.stride(0) == nxt.stride(0)


def _eval_fold(prog, cur, nxt, nshift, sels, sel_off, sel_stride, pis, alpha, acc, acc_off, acc_stride, add, invz):
    dag = prog.dag
    ops = [n[0] for n in dag.nodes]
    sel_cols = len({n[1] for n in dag.nodes if n[0] == "sel"})
    return b.quotient_eval_bound((dag.span(0), dag.span(1)), sel_cols, ops.count("mul"),
                                 sum(ops.count(k) for k in ("add", "sub", "neg")), len(dag.roots),
                                 int(cur.shape[0]), add, invz, _same_panel(cur, nxt))


def _panel_fold(tf, log_m, shift, r):
    return b.panel_fold_bound(int(tf.shape[0]), int(tf.shape[1]), 1 << log_m, r)


def _reduced_opening(acc, mats, apows, log_h, row0=0, points=(), natural=False, ext_in=None, scales=None):
    scaled = sum(tuple(c) != (1, 0, 0, 0) for c in scales or [])
    return b.reduced_opening_bound(int(acc.shape[0]), log_h, row0, [int(m.shape[1]) for m in mats], len(points),
                                   ext_in is not None, int(apows.shape[0]) if apows.dim() == 3 else 1, scaled)


def _eval_at_points(coeffs, points, r0=0, out=None):
    return b.eval_at_points_bound(int(coeffs.shape[0]), int(coeffs.shape[1]), len(list(points)))


def _fri_fold(cw, beta, log_h, row0=0, add=None):
    return b.fri_fold_bound(int(cw.shape[0]), add is not None)


# (module of the program, wrapper, its pricing): the kernel wrappers of the
# Keccak stack's prove path
WRAPPERS: Tuple[Tuple[str, str, Callable], ...] = (
    ("tpu_stark_torch.hash.keccak_kernel", "hash_rows", _hash_rows),
    ("tpu_stark_torch.hash.keccak_kernel", "compress_levels", _compress_levels),
    ("tpu_stark_torch.hash.keccak_kernel", "absorb_rows", _absorb_rows),
    ("tpu_stark_torch.hash.keccak_kernel", "finalize_rows", _finalize_rows),
    ("tpu_stark_torch.ntt.ntt_kernel", "dft", _dft),
    ("tpu_stark_torch.compat.device_rng", "_monty_kernel", _threefry),
    ("tpu_stark_torch.challenger.grind", "verdicts", _verdicts),
    ("tpu_stark_torch.air.quotient_kernel", "eval_fold", _eval_fold),
    ("tpu_stark_torch.air.quotient_kernel", "panel_fold", _panel_fold),
    ("tpu_stark_torch.commit.open_kernel", "reduced_opening", _reduced_opening),
    ("tpu_stark_torch.commit.open_kernel", "eval_at_points", _eval_at_points),
    ("tpu_stark_torch.commit.open_kernel", "fri_fold", _fri_fold),
)


class Pricer:
    """While open, ``ms[phase]`` sums the bounds (ms) of the wrapper calls
    made while ``phase()`` names that phase, and ``calls[phase]`` counts
    them."""

    def __init__(self, phase: Callable[[], str]):
        self.phase = phase
        self.ms: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self._orig: List[tuple] = []

    def __enter__(self):
        for mod_name, name, price in WRAPPERS:
            try:
                mod = importlib.import_module(mod_name)
            except ImportError:
                continue
            orig = getattr(mod, name, None)
            if orig is None:
                continue

            def priced(*args, _orig=orig, _price=price, **kw):
                key = self.phase()
                self.ms[key] = self.ms.get(key, 0.0) + _price(*args, **kw)[0]
                self.calls[key] = self.calls.get(key, 0) + 1
                return _orig(*args, **kw)

            setattr(mod, name, priced)
            self._orig.append((mod, name, orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._orig):
            setattr(mod, name, orig)
        self._orig.clear()
