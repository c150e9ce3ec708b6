"""The port's bench layer (``tpu_stark_torch/bench``) and NTT oracle
(``tpu_stark_torch/ntt/reference.py``) against the JAX package's on the
CPU.

* the harness's constants, ``benchmark_input`` (bit for bit),
  ``percentile_ms``, ``Stats.from_times`` and ``format_line``'s format, and
  ``run_case``'s cpu tier at a small shape;
* the naive DFT oracle against JAX's and against the port's NTT;
* ``maybe_trace`` writes a Chrome trace;
* the prove twins (``bench/prove.py``) at tiny heights: their last line has
  the JAX scripts' keys, and their ``metric`` and ``proof_bytes`` equal
  those of the JAX scripts' configuration at that height, the proofs of
  the JAX fixtures ``torch_poseidon2_jax_proofs.json`` (the chain at 2^3:
  JAX's cold CPU compile of the chain takes minutes) and
  ``torch_keccak_air_jax_proofs.json`` (keccak-air at 64 rows);
  ``test_torch_app.py`` holds the fib twin against JAX's proof, made there
  on the JAX compile it shares with ``run_fib_air_zk``.
"""

import contextlib
import io
import json
import os
import pathlib

import numpy as np
import pytest

from tpu_stark.bench import harness as jax_harness
from tpu_stark.fields import babybear as jax_bb
from tpu_stark.ntt.reference import naive_dft_matrix as jax_naive_dft
from tpu_stark_torch.bench import harness, narrow_ntt, profiling
from tpu_stark_torch.bench import hash as bench_hash
from tpu_stark_torch.bench import ntt as bench_ntt
from tpu_stark_torch.bench import prove as bench_prove
from tpu_stark_torch.fields import babybear as bb
from tpu_stark_torch.ntt import radix2
from tpu_stark_torch.ntt.reference import naive_dft_matrix

JAX_P2_PROOFS = pathlib.Path(__file__).parent / "golden" / "torch_poseidon2_jax_proofs.json"

# the keys of the JAX scripts' last lines (bench_poseidon2_chain.py,
# bench_keccak_air.py)
JAX_KEYS = {
    "chain": {"metric", "value", "unit", "tracegen_s", "first_run_s", "verify_s", "proof_bytes"},
    "keccak-air": {"metric", "value", "unit", "samples", "tracegen_s", "first_run_s", "verify_s",
                   "proof_bytes", "trace_cols", "peak_hbm_gb"},
}


def test_harness_constants_equal_jax():
    assert harness.DEFAULT_CASES == jax_harness.DEFAULT_CASES
    assert len(harness.DEFAULT_CASES) == 11
    assert (harness.REPEATS, harness.WARMUP, harness.E2E_BATCH) == (
        jax_harness.REPEATS, jax_harness.WARMUP, jax_harness.E2E_BATCH) == (10, 1, 4)


@pytest.mark.parametrize("h,w", [(256, 8), (16384, 128), (256, 16000), (3, 5)])
def test_benchmark_input_bit_equal_jax(h, w):
    got, want = harness.benchmark_input(h, w), jax_harness.benchmark_input(h, w)
    assert got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("times", [[], [4.0], [3.0, 1.0, 2.0], [float(i * 7 % 11) + 0.25 for i in range(10)],
                                   [0.5 * i for i in range(21)]])
def test_percentile_and_stats_equal_jax(times):
    s = sorted(times)
    for pct in (0, 50, 95, 100):
        assert harness.percentile_ms(s, pct) == jax_harness.percentile_ms(s, pct)
    if times:
        got, want = harness.Stats.from_times(times), jax_harness.Stats.from_times(times)
        assert (got.avg_ms, got.median_ms, got.p95_ms) == (want.avg_ms, want.median_ms, want.p95_ms)


def test_format_line_pinned():
    st = harness.Stats

    cpu_only = harness.CaseResult(256, 8, st(2.0, 1.5, 3.0), None, None, None)
    assert cpu_only.format_line() == "dft 256x8: cpu=2.000ms"
    full = harness.CaseResult(16384, 128, st(64.0, 60.0, 70.0), st(4.0, 4.0, 5.0), st(2.0, 2.0, 2.5),
                              st(0.25, 0.25, 0.3))
    line = full.format_line()
    assert line == ("dft 16384x128: cpu=64.000ms cuda_e2e=4.000ms (16.00x) cuda_batched=2.000ms (32.00x) "
                    "cuda_kernel=0.250ms (256.00x)")
    jst = jax_harness.Stats
    jax_line = jax_harness.CaseResult(16384, 128, jst(64.0, 60.0, 70.0), jst(4.0, 4.0, 5.0), jst(2.0, 2.0, 2.5),
                                      jst(0.25, 0.25, 0.3)).format_line()
    assert line == jax_line.replace("tpu_e2e", "cuda_e2e").replace("tpu_batched", "cuda_batched").replace(
        "tpu_kernel", "cuda_kernel")
    assert full.kernel_melems_per_s() == 16384 * 128 / 0.25e-3 / 1e6


def test_run_case_cpu_tier():
    res = harness.run_case(256, 8, use_cuda=False)
    assert (res.h, res.w) == (256, 8)
    assert res.cuda_e2e is None and res.cuda_batched is None and res.cuda_kernel is None
    assert 0 < res.cpu.avg_ms and res.cpu.median_ms <= res.cpu.p95_ms
    assert res.format_line().startswith("dft 256x8: cpu=")
    with pytest.raises(ValueError, match="CUDA"):
        harness.run_case(256, 8, use_cuda=True, device="cpu")


def test_ntt_twin_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        bench_ntt.main(["--device", "cpu"])
    assert bench_ntt.BASELINE_MELEMS == 135.0


@pytest.mark.parametrize("twin", [bench_hash, narrow_ntt], ids=["hash", "narrow_ntt"])
def test_hash_and_narrow_twins_need_the_card(twin):
    with pytest.raises(ValueError, match="CUDA"):
        twin.main(["--device", "cpu"])


def test_narrow_twin_shapes_are_the_jax_scripts():
    import bench_narrow_ntt

    assert narrow_ntt.SHAPES == bench_narrow_ntt.SHAPES
    assert len(narrow_ntt.SHAPES) == 7
    # every shape passes the mxu route's gate
    assert all(w <= radix2.NARROW_MAX_W and log_h >= radix2.NARROW_MIN_LOG_H for log_h, w in narrow_ntt.SHAPES)
    assert [narrow for _label, narrow in narrow_ntt.ROUTES] == list(radix2.NARROW_ROUTES)


def test_hash_twin_sizes_are_the_jax_scripts():
    """bench_hash.py's n and reps are locals of its main(): read them off
    its source."""
    import ast

    import bench_hash as jax_bench_hash

    tree = ast.parse(pathlib.Path(jax_bench_hash.__file__).read_text())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main")
    consts = {
        node.targets[0].id: eval(compile(ast.Expression(node.value), "bench_hash.py", "eval"))
        for node in main.body
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
        and node.targets[0].id in ("n", "reps")
    }
    assert (bench_hash.N, bench_hash.R) == (consts["n"], consts["reps"]) == (1 << 20, 32)


@pytest.mark.parametrize("step", ["keccak", "poseidon2"])
def test_hash_twin_steps_equal_jax_bodies(step):
    """One step of each chain the hash twin times (``bench/sol.py``'s
    helpers, here on their plain versions) equals the JAX script's loop body
    on the same 64 rows: the Keccak leaf sponge's first 6 digest words, and
    K3's compress = the first 8 words of the width-16 permutation."""
    import jax.numpy as jnp

    from tpu_stark.hash import poseidon2 as jax_poseidon2
    from tpu_stark.hash import sponge as jax_sponge
    from tpu_stark_torch.bench import sol

    n = 64
    if step == "keccak":
        mat = sol.keccak_leaf_input(n, "cpu")
        got = sol.keccak_leaf_step(mat).numpy().view(np.uint32)
        want = np.asarray(jax_sponge.hash_field_rows_batched(jnp.asarray(mat.numpy().view(np.uint32))))
        want = want.reshape(n, 8)[:, :6]
    else:
        left, right = sol.poseidon2_compress_input(n, "cpu")
        got = bb.to_numpy(sol.poseidon2_compress_step(right)(left))
        state = np.concatenate([bb.to_numpy(left), bb.to_numpy(right)], axis=1)
        want = np.asarray(jax_poseidon2.permute_batched(jnp.asarray(state)))[:, :8]
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("label,narrow", narrow_ntt.ROUTES)
def test_narrow_routes_equal_jax_radix2(label, narrow):
    """Each route of the narrow twin (the plain versions here: K2's passes,
    the limb-matmul NTT) equals the JAX package's radix-2 DFT at (2^16, 4)."""
    import jax.numpy as jnp

    from tpu_stark.ntt import radix2 as jax_radix2

    mat = bb.np_to_monty(np.random.default_rng(15).integers(0, bb.P, size=(1 << 16, 4), dtype=np.uint32))
    x = bb.to_tensor(mat, "cpu")
    assert radix2._mxu(x, narrow) == (label == "mxu")
    got = bb.to_numpy(radix2.dft_batch(x, narrow))
    assert np.array_equal(got, np.asarray(jax_radix2.dft_batch(jnp.asarray(mat))))


@pytest.mark.parametrize("shift", [1, bb.GENERATOR])
def test_reference_oracle_equals_jax_and_the_ntt(shift):
    rng = np.random.default_rng(16 + shift)
    mat = rng.integers(0, bb.P, size=(16, 3), dtype=np.uint64).astype(np.uint32)
    got = naive_dft_matrix(mat, shift)
    assert got.dtype == np.uint32
    assert np.array_equal(got, jax_naive_dft(mat, shift))
    x = bb.to_tensor(bb.np_to_monty(mat), "cpu")
    ntt = radix2.dft_batch(x) if shift == 1 else radix2.coset_dft_batch(x, shift)
    assert np.array_equal(bb.np_from_monty(bb.to_numpy(ntt)), got)
    assert jax_bb.P == bb.P


def test_maybe_trace_writes_a_chrome_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    with profiling.maybe_trace(str(trace_dir)):
        radix2.dft_batch(bb.to_tensor(bb.np_to_monty(harness.benchmark_input(64, 4)), "cpu"))
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(files) == 1
    with open(trace_dir / files[0]) as f:
        assert json.load(f)["traceEvents"]
    with profiling.maybe_trace(None):
        pass
    assert profiling.hbm_note("cpu") == ""


def _twin(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = bench_prove.main(argv)
    lines = buf.getvalue().splitlines()
    assert json.loads(lines[-1]) == out
    return out, lines


def test_chain_twin_equals_jax_script_config():
    out, _lines = _twin(["chain", "3", "--device", "cpu"])
    assert JAX_KEYS["chain"] <= set(out)
    assert out["metric"] == "poseidon2_chain_prove_2^3"
    assert out["proof_bytes"] == json.loads(JAX_P2_PROOFS.read_text())["chain_3"]["len"]
    assert out["trace_cols"] == 493 and len(out["samples"]) == 1


def test_keccak_air_twin_equals_jax_script_config():
    """``keccak-air 6 bench 0``: 64 rows of generate_trace(64 // 24,
    seed=1), benchmark FRI parameters, the configuration of the JAX
    fixture's ``perms_2`` (tests/golden/torch_keccak_air_jax_proofs.json)."""
    out, _lines = _twin(["keccak-air", "6", "bench", "0", "--device", "cpu"])
    assert JAX_KEYS["keccak-air"] <= set(out)
    want = json.loads((pathlib.Path(__file__).parent / "golden" / "torch_keccak_air_jax_proofs.json").read_text())
    assert want["perms_2"]["rows"] == 64
    assert out["metric"] == "keccak_air_prove_2^6_bench"
    assert out["proof_bytes"] == want["perms_2"]["len"]
    assert out["trace_cols"] == 3608 and out["samples"] == [out["first_run_s"]]


def test_twin_reps_zero_reports_the_cold_run():
    out, lines = _twin(["fib", "3", "keccak", "plain", "0", "test", "--device", "cpu", "--narrow", "mxu"])
    assert out["metric"] == "fib_air_plain_prove_2^3_keccak_test"
    assert out["samples"] == [out["first_run_s"]] == [out["value"]]
    assert out["narrow"] == "mxu" and len(lines) == 2


def test_twin_arguments_are_the_jax_scripts():
    p = bench_prove.parser()
    a = p.parse_args(["fib"])
    assert (a.log_n, a.hash, a.mode, a.reps, a.params, a.narrow, a.device) == (
        16, "keccak", "zk", 3, "test", "none", "cuda")
    assert p.parse_args(["chain"]).log_n == 18
    a = p.parse_args(["keccak-air", "7", "test", "2"])
    assert (a.log_n, a.params, a.reps) == (7, "test", 2)
    assert p.parse_args(["keccak-air"]).params == "bench"
    with pytest.raises(SystemExit):
        p.parse_args(["fib", "6", "sha256"])
    with pytest.raises(SystemExit):
        p.parse_args(["chain", "6", "--narrow", "vpu4"])
