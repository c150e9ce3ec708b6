"""The port's speed-of-light report (``tpu_stark_torch/bench/sol.py``)
against the JAX package's (``tpu_stark/bench/sol.py``) on the CPU.

On the CPU this checks structure only: the audit counter, the probes'
plain twins, the report's contract on ``run(small=True, device="cpu")``
(mirroring ``tests/test_sol.py``), the scoring against JAX's arithmetic on
the same synthetic measurements, the full run's kernel list against JAX's,
and the ``sol_pct_of_roof`` block against the root ``bench.py``'s.  The
numbers mean something only on the card (``python -m
tpu_stark_torch.bench.sol``).
"""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from tpu_stark.bench import sol as jsol
from tpu_stark.fields import babybear as jbb
from tpu_stark_torch.air.air import get_symbolic_info
from tpu_stark_torch.air.fibonacci import FibonacciAir
from tpu_stark_torch.bench import ntt as bench_ntt
from tpu_stark_torch.bench import sol
from tpu_stark_torch.commit import open_kernel
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.hash import keccak_kernel, poseidon2_kernel
from tpu_stark_torch.ntt import ntt_kernel
from tpu_stark_torch.prover.prove import _quotient_values


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """CPU-bound torch work: two intra-op threads keep it off the cores
    that the suite's other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _z(*shape, device="cpu"):
    return torch.zeros(shape, dtype=torch.int32, device=device)


def test_audit_counts_montmul():
    a = _z(64)
    ops = sol.audit_ops(bb.mul, a, a)
    assert set(ops) == {"mul", "alu"}
    # whole multiples of the element count: two int64 products and two
    # remainders an element
    assert ops["mul"] % 64 == 0 and ops["mul"] >= 64
    assert ops["alu"] % 64 == 0
    assert sol.audit_ops(bb.mul, _z(128), _z(128)) == {k: 2 * v for k, v in ops.items()}


def test_audit_keccak_mix_step_has_no_multiplies():
    ops = sol.audit_ops(sol.mix_plain, _z(64))
    assert ops["mul"] == 0 and ops["alu"] > 0 and ops["alu"] % 64 == 0


def test_audit_skips_floating_and_data_movement():
    x = torch.arange(64, dtype=torch.float64)
    assert sol.audit_ops(lambda v: v * v + 1.0, x) == {"mul": 0, "alu": 0}
    i = torch.arange(64, dtype=torch.int32)
    assert sol.audit_ops(lambda v: torch.cat([v, v])[torch.arange(8)].clone(), i) == {"mul": 0, "alu": 0}
    # an in-place op counts like its out-of-place form
    assert sol.audit_ops(lambda v: v.clone().bitwise_xor_(3), i) == {"mul": 0, "alu": 64}


def _quotient_twin(h):
    air = FibonacciAir()
    nc, _ = get_symbolic_info(air, 3)
    log_m = h.bit_length() - 1

    def fn(t, p, a):
        return _quotient_values(air, t, p, a, log_m - 1, log_m)

    return fn, ((h, 2), (3,), (nc, 4))


OPENING_POINT = ((5, 9, 2, 6), (5, 3, 5, 8))  # the audited reduced opening's point and opened sum


def _twins():
    q_fn, q_shapes = _quotient_twin(128)
    return {
        "ntt": (ntt_kernel.dft_plain, ((256, 8),)),
        "poseidon2_compress": (poseidon2_kernel.compress_plain, ((64, 8), (64, 8))),
        "poseidon2_sponge": (poseidon2_kernel.hash_rows_plain, ((64, 6),)),
        "quotient": (q_fn, q_shapes),
        "fri_fold": (lambda v: open_kernel.fri_fold(v, sol.FOLD_BETA, 8), ((256, 4),)),
        "reduced_opening": (lambda acc, m, a: open_kernel.reduced_opening(acc, [m], a, 8, 0, [OPENING_POINT]),
                            ((256, 4), (256, 2), (2, 4))),
        "mul_step": (bb.mul, ((64,), (64,))),
        "alu_step": (sol.mix_plain, ((64,),)),
    }


@pytest.mark.parametrize("twin", list(_twins()))
def test_meta_audit_equals_cpu_audit(twin):
    """The report audits its twins on ``meta`` at the measured shape: the
    counts are the CPU run's."""
    fn, shapes = _twins()[twin]
    cpu = sol.audit_ops(fn, *(_z(*s) for s in shapes))
    meta = sol.audit_ops(fn, *(_z(*s, device="meta") for s in shapes))
    assert cpu == meta and cpu["mul"] + cpu["alu"] > 0


def test_keccak_audit_scales_linearly():
    """K1's plain twin cannot run on ``meta``: ``audit_linear`` extrapolates
    from 256 and 512 rows, exact against audits at 1024 and 2048."""
    for n in (1024, 2048):
        want = sol.audit_ops(keccak_kernel.hash_rows_plain, _z(n, 6))
        assert sol.audit_linear(keccak_kernel.hash_rows_plain, sol._keccak_rows, n) == want
    assert sol.audit_linear(keccak_kernel.hash_rows_plain, sol._keccak_rows, 128) == sol.audit_ops(
        keccak_kernel.hash_rows_plain, _z(128, 6))
    with pytest.raises(ValueError, match="multiple"):
        sol.audit_linear(keccak_kernel.hash_rows_plain, sol._keccak_rows, 300)


def test_probe_twins_compute_jax_probe_steps():
    """The mul twin is JAX's Montgomery product chained; the alu twin is
    JAX's Keccak-mix step on u32 words."""
    x, tw = sol.mul_operands(256, "cpu")
    got = bb.to_numpy(sol.mul_chain_plain(x, tw, 1))
    want = jnp.asarray(bb.to_numpy(x))
    for _ in range(sol._INNER):
        want = jbb.mul(want, jnp.asarray(bb.to_numpy(tw)))
    assert np.array_equal(got, np.asarray(want))
    v = sol.alu_operands(256, "cpu")
    v[0, :4] = torch.tensor([-1, -(1 << 31), 0x7FFFFFFF, 0x12345678], dtype=torch.int32)
    u = bb.to_numpy(v)
    for _ in range(sol._INNER):
        r = (u << np.uint32(13)) | (u >> np.uint32(19))
        s = (u << np.uint32(7)) | (u >> np.uint32(25))
        u = u ^ (~r & s)
    assert np.array_equal(bb.to_numpy(sol.alu_chain_plain(v, 1)), u)
    y = torch.arange(16, dtype=torch.int32)
    assert sol.stream_step(y) is y and torch.equal(y, torch.arange(1, 17, dtype=torch.int32))


def test_probe_wrappers_refuse_other_devices():
    m = _z(sol._ILP, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        sol.mul_chain(m, _z(8, device="meta"), 1)
    with pytest.raises(ValueError, match="device"):
        sol.alu_chain(m, 1)
    with pytest.raises(ValueError, match="device"):
        sol.stream_step(_z(8, device="meta"))


@pytest.fixture(scope="module")
def small_report():
    return sol.run(small=True, device="cpu")


def test_small_report_structure(small_report):
    rep = small_report
    assert set(rep["roofs"]) == {"mul", "alu", "hbm"}
    assert all(v > 0 for v in rep["roofs"].values())
    assert rep["device"] == "cpu"
    names = {k["kernel"].rsplit("_", 1)[0] for k in rep["kernels"]}
    assert any(k.startswith("ntt_radix2") for k in names)
    assert any(k.startswith("quotient_fib") for k in names)
    assert any(k.startswith("fri_fold") for k in names)
    for k in rep["kernels"]:
        # no kernel above its roof (lifting guarantees it for the audited
        # resources); a kernel whose only resource was a dropped HBM model
        # is unscored and flagged
        if k["sol_pct"] is None:
            assert k.get("hbm_model_exceeds_roof"), k
        else:
            assert 0 < k["sol_pct"] <= 100.0 + 1e-9, k
            assert k["binding"] in rep["roofs"]
    line = sol.report_json(rep)["sol_report"]
    assert json.loads(json.dumps(line))["roofs"] == rep["roofs"]
    assert all("achieved" not in k for k in line["kernels"])


def test_run_open_scores_the_reduced_opening_and_the_fold(small_report):
    """``run_open`` scores K11 (the fold) against a report's roofs: the CPU
    runs its plain twin, audited on ``meta``, and says that its ops are the
    plain twin's.  The reduced opening (K9) is left out: its plain twin's
    audit counts an ext inverse a row that K9 does not compute, so the
    score would clip at 100 % and say nothing of K9."""
    got = sol.run_open(small_report["roofs"], log_h=8, device="cpu")
    assert [k["kernel"] for k in got] == ["fri_fold_2^8"]
    assert not hasattr(sol, "_measure_reduced_opening")
    for k in got:
        assert k["audit"].startswith("ops of the plain twin")
        assert k["ops"]["mul"] > 0 and k["ops"]["alu"] > 0 and k["rate"] > 0
        assert k["sol_pct"] is None or 0 < k["sol_pct"] <= 100.0 + 1e-9


ROOFS = {"mul": 1e9, "alu": 4e9, "hbm": 2e12}
# one synthetic measurement for each of JAX's seven small-run kernels: one
# lifts mul, one lifts alu, one's HBM model exceeds the stream roof, one has
# only bytes, one only bytes above the roof (unscored)
SYNTHETIC = [
    {"kernel": "lifts_mul", "ops": {"mul": 1000, "alu": 10}, "rate": 2e6},
    {"kernel": "hbm_over", "ops": {"mul": 10, "alu": 100}, "rate": 1e4, "bytes_per_call": 4e8},
    {"kernel": "bytes_only", "ops": {"mul": 0, "alu": 0}, "rate": 100.0, "bytes_per_call": 1e9},
    {"kernel": "bytes_only_over", "ops": {"mul": 0, "alu": 0}, "rate": 1000.0, "bytes_per_call": 1e10},
    {"kernel": "lifts_alu", "ops": {"mul": 5, "alu": 5000}, "rate": 1e6},
    {"kernel": "plain", "ops": {"mul": 100, "alu": 300}, "rate": 1e6},
    {"kernel": "ntt_like", "ops": {"mul": 300, "alu": 900}, "rate": 1e6, "bytes_per_call": 1e5},
]
JAX_MEASURES = ("_measure_ntt", "_measure_keccak", "_measure_poseidon2", "_measure_poseidon2_sponge",
                "_measure_quotient", "_measure_fri_fold", "_measure_bitrev")


def _patch_jax_probes(monkeypatch):
    monkeypatch.setattr(jsol, "mul_roof", lambda **kw: {"mul": ROOFS["mul"], "alu": 0.0})
    monkeypatch.setattr(jsol, "alu_roof", lambda **kw: {"mul": 0.0, "alu": ROOFS["alu"]})
    monkeypatch.setattr(jsol, "hbm_roof", lambda **kw: ROOFS["hbm"])
    monkeypatch.setattr(jsol, "dispatch_floor", lambda: 1e-3)


def test_scoring_equals_jax(monkeypatch):
    """JAX's ``run`` on synthetic probes and measurements, and the port's
    ``score`` on the same: equal roofs, sources, bindings, scores, utils,
    roof sources and flags."""
    _patch_jax_probes(monkeypatch)
    for name, syn in zip(JAX_MEASURES, SYNTHETIC):
        monkeypatch.setattr(jsol, name, lambda *a, _s=syn, **kw: copy.deepcopy(_s))
    want = jsol.run(small=True)
    roofs, sources, got = sol.score(ROOFS, sol.PROBE_SOURCES, SYNTHETIC)
    assert sources == want["roof_sources"]
    assert sources["mul"] == "kernel:lifts_mul" and sources["alu"] == "kernel:lifts_alu"
    assert roofs == pytest.approx(want["roofs"], rel=1e-9)
    assert len(got) == len(want["kernels"])
    for g, w in zip(got, want["kernels"]):
        assert (g["kernel"], g["binding"], g["roof_source_for"]) == (w["kernel"], w["binding"], w["roof_source_for"])
        if w["sol_pct"] is None:
            assert g["sol_pct"] is None
        else:
            assert g["sol_pct"] == pytest.approx(w["sol_pct"], rel=1e-9)
        assert g["utils"] == pytest.approx(w["utils"], rel=1e-9)
        assert bool(g.get("hbm_model_exceeds_roof")) == bool(w.get("hbm_model_exceeds_roof"))
    flagged = [k["kernel"] for k in got if k.get("hbm_model_exceeds_roof")]
    assert flagged == ["hbm_over", "bytes_only_over"]
    assert SYNTHETIC[0].keys() == {"kernel", "ops", "rate"}  # score left its inputs alone


@pytest.mark.parametrize("small", [True, False])
def test_kernel_list_equals_jax(monkeypatch, small):
    """The kernels ``run`` measures are JAX's list (``sol.py:600-609`` in
    full, its smoke list when small), by name: both runs with the probes,
    the timing and the audits stubbed (no kernel is timed)."""
    _patch_jax_probes(monkeypatch)
    monkeypatch.setattr(jsol, "_timed", lambda mk, arg, reps: 1.0)
    monkeypatch.setattr(jsol, "audit_ops", lambda fn, *args: {"mul": 1, "alu": 1, "while_loops": 0})
    import tpu_stark.commit.pcs as jpcs

    monkeypatch.setattr(jpcs, "_fold_inv2y", lambda log_h: None)
    want = [k["kernel"] for k in jsol.run(small=small)["kernels"]]
    monkeypatch.setattr(sol, "mul_roof", lambda **kw: {"mul": ROOFS["mul"], "alu": 0.0})
    monkeypatch.setattr(sol, "alu_roof", lambda **kw: {"mul": 0.0, "alu": ROOFS["alu"]})
    monkeypatch.setattr(sol, "hbm_roof", lambda **kw: ROOFS["hbm"])
    monkeypatch.setattr(sol, "_timed", lambda mk, arg, reps: 1.0)
    monkeypatch.setattr(sol, "audit_ops", lambda fn, *args: {"mul": 1, "alu": 1})
    monkeypatch.setattr(sol, "audit_linear", lambda fn, make, n: {"mul": 1, "alu": 1})
    got = [k["kernel"] for k in sol.run(small=small, device="cpu")["kernels"]]
    assert got == want
    if not small:
        assert got == ["ntt_radix2_16384x128", "ntt_radix2_65536x128", "ntt_radix2_1048576x8",
                       "keccak_leaf_sponge_N1048576", "poseidon2_16_N1048576", "poseidon2_leaf_sponge_N1048576",
                       "quotient_fib_2^19", "fri_fold_2^22", "bit_reversal_4194304x8"]


def test_sol_compact_equals_bench_py(monkeypatch, capsys):
    """``bench.ntt``'s ``sol_pct_of_roof`` block is the root ``bench.py``'s
    (lines 65-82) on one synthetic report, with ``n/a:l2-resident`` where
    JAX says ``n/a:vmem-resident``."""
    roofs, sources, kernels = sol.score(ROOFS, sol.PROBE_SOURCES, SYNTHETIC)
    report = {"roofs": roofs, "roof_sources": sources, "kernels": kernels, "dispatch_floor_ms": 1.23456}
    monkeypatch.setattr(jsol, "_timed", lambda mk, arg, reps: 1000.0)
    monkeypatch.setattr(jsol, "run", lambda: report)
    jax_bench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["sol_pct_of_roof"]
    got = json.loads(json.dumps(bench_ntt.sol_compact(report)))
    assert "n/a:l2-resident" in got["kernels"].values()
    assert "roof-source:mul" in got["kernels"].values()
    na = {k: ("n/a:vmem-resident" if v == "n/a:l2-resident" else v) for k, v in got["kernels"].items()}
    assert {**got, "kernels": na} == want
