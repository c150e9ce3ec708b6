"""The frozen bound arithmetic held to numbers computed when it was copied
(from ``chip_smoke.py``'s functions, which gave the same at these shapes, the
wrappers' shapes in fib_zk at 2^24 and keccak-air at 2^20), and the pricer's wrap and unwrap."""

import pytest
import torch

from stark_bench.roofline import bounds as b
from stark_bench.roofline.calls import WRAPPERS, Pricer

CASES = [
    (b.keccak_absorb_bound, (1 << 21, 30, 64, False, False, True), 0.5508936597014925, "bytes"),
    (b.keccak_absorb_bound, (1 << 21, 12, 0, False, True, False), 0.2708099173553719, "operations"),
    (b.tree_bound, (1 << 21, 21), 0.2708097882231405, "operations"),
    (b.threefry_bound, ((1 << 20) * 64,), 0.31494190388735843, "operations"),
    (b.grind_bound, (1 << 20, 2), 0.26698598102234467, "operations"),
    (b.panel_fold_bound, (1 << 21, 768, 1 << 19, 4), 3.8462393695522388, "bytes"),
    (b.reduced_opening_bound, (1 << 21, 21, 0, [3608], 2, False), 9.054688515820896, "bytes"),
    (b.eval_at_points_bound, (1 << 21, 128, 2), 0.32052117014925374, "bytes"),
    (b.fri_fold_bound, (1 << 21, True), 0.020032496716417908, "bytes"),
    (b.dft_bound, (1 << 21, 128), 0.7382077747168656, "operations"),
    (b.dft_bound, (1 << 26, 2), 0.45937385981022344, "operations"),
    (b.hash_rows_bound, (1 << 26, 4), 8.665917355371901, "operations"),
]


@pytest.mark.parametrize("fn,args,ms,by", CASES, ids=lambda v: getattr(v, "__name__", None))
def test_bound_is_frozen(fn, args, ms, by):
    got = fn(*args)
    assert got[1] == by and got[0] == pytest.approx(ms, rel=1e-12)


def test_peaks():
    assert b.HBM_BYTES_PER_S == 3.35e12
    assert b.INT32_OPS_PER_S == pytest.approx(33.45e12, rel=1e-3)


def test_pricer_wraps_and_restores():
    import importlib

    mods = {(m, n): getattr(importlib.import_module(m), n) for m, n, _ in WRAPPERS}
    with Pricer(lambda: "p") as pricer:
        from tpu_stark_torch.ntt import ntt_kernel

        x = torch.zeros((16, 4), dtype=torch.int32)
        ntt_kernel.dft(x)
    assert pricer.calls == {"p": 1} and pricer.ms["p"] == pytest.approx(b.dft_bound(16, 4)[0])
    assert {(m, n): getattr(importlib.import_module(m), n) for m, n, _ in WRAPPERS} == mods
