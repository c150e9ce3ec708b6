#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``tpu_stark_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and a CUDA build of PyTorch.  Imports nothing of JAX.  Phases, one
line each, any failure an uncaught exception and a nonzero exit:

1. device name, ``nvidia-smi`` name and power limit; build the kernels of
   ``tpu_stark_torch/csrc`` with nvcc (and the C host helper);
2. K1 (Keccak sponge) against its plain torch version, exact, at leaf
   shapes (2^20, 6), (2^20, 8), (1000, 40) and 2^20 compress pairs;
3. K2 (NTT passes) against the plain passes, exact: dft/idft at (2^20, 2),
   (2^21, 8), (2^23, 2), (16384, 128) and a coset LDE at (2^20, 2);
4. fib_air zk n = 8 proofs, both layouts, byte-equal to the golden files;
5. n = 2^14 proofs, both layouts, with the SHA-256 and length the JAX
   package produced (tests/golden/torch_fib_zk_jax_proofs.json);
6. an n = 2^20 prove (launch counts reset just before it, read just after),
   verified by the port's verifier, with cold/warm wall clock, phase times
   and peak device memory.

Then a JSON line of per-kernel results, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Exits nonzero without a result when
CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn over reps launches (CUDA events, warmed up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(torch, a, b) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    d = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
    return d


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "tpu_stark_torch")):
        print("chip_smoke: tpu_stark_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from tpu_stark.compat import native
    from tpu_stark_torch import kernels
    from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
    from tpu_stark_torch.fields import babybear as bb
    from tpu_stark_torch.hash import keccak_kernel
    from tpu_stark_torch.ntt import ntt_kernel, radix2
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.proof import deserialize_proof, serialize_proof
    from tpu_stark_torch.prover.prove import prove
    from tpu_stark_torch.prover.verify import verify

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _smi_line()

    # -- 1. device + build ---------------------------------------------------
    t0 = time.perf_counter()
    build = kernels.build(force=True)
    kernels.lib()
    if native.get_lib() is None:
        raise RuntimeError("the C host helper (native/) did not build")
    regs = [ln.strip() for ln in build.log.splitlines() if "registers" in ln]
    print(f"[1] device {kind!r}; nvidia-smi: {smi}; nvcc build {build.seconds:.2f}s "
          f"(all builds {time.perf_counter() - t0:.2f}s); ptxas: {' | '.join(regs)}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand_u32(shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    def rand_monty(shape):
        return torch.randint(0, bb.P, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    results = {}

    # -- 2. K1 vs plain --------------------------------------------------------
    k1_lines = []
    for label, a, b in [
        ("leaf (1048576, 6)", rand_monty((1 << 20, 6)), None),
        ("leaf (1048576, 8)", rand_monty((1 << 20, 8)), None),
        ("leaf (1000, 40)", rand_monty((1000, 40)), None),
        ("compress 1048576 pairs", rand_u32((1 << 20, 8)), rand_u32((1 << 20, 8))),
    ]:
        got = keccak_kernel.hash_rows(a, b)
        want = keccak_kernel.hash_rows_plain(a, b)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"K1 {label}: kernel != plain (max_abs_err {err})")
        ms = _cuda_ms(torch, lambda: keccak_kernel.hash_rows(a, b), 20)
        plain_ms = _cuda_ms(torch, lambda: keccak_kernel.hash_rows_plain(a, b), 2)
        k1_lines.append(f"{label}: {ms:.4f} ms vs plain {plain_ms:.3f} ms "
                        f"({a.shape[0] / ms / 1e3:.1f} Mrows/s)")
        if label.startswith("leaf (1048576, 6)"):
            results["keccak_sponge"] = (err, ms, plain_ms)
    print("[2] K1 keccak sponge == plain (exact): " + "; ".join(k1_lines), flush=True)

    # -- 3. K2 vs plain --------------------------------------------------------
    k2_lines = []
    for h, w in [(1 << 20, 2), (1 << 21, 8), (1 << 23, 2), (16384, 128)]:
        x = rand_monty((h, w))
        for inverse in (False, True):
            got = radix2.idft_batch(x) if inverse else radix2.dft_batch(x)
            plain = ntt_kernel.dft_plain(x, inverse)
            if inverse:
                plain = bb.mul_canonical(plain, pow(h, bb.P - 2, bb.P))
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise AssertionError(f"K2 ({h}, {w}) inverse={inverse}: kernel != plain")
        ms = _cuda_ms(torch, lambda: ntt_kernel.dft(x), 10)
        plain_ms = _cuda_ms(torch, lambda: ntt_kernel.dft_plain(x), 2)
        k2_lines.append(f"({h}, {w}): {ms:.4f} ms vs plain {plain_ms:.3f} ms "
                        f"({h * w / ms / 1e3:.1f} Melems/s)")
    # coset LDE at (2^20, 2), added_bits 2
    x = rand_monty((1 << 20, 2))
    got = radix2.coset_lde_batch(x, 2, bb.GENERATOR)
    coeffs = bb.mul_canonical(ntt_kernel.dft_plain(x, True), pow(1 << 20, bb.P - 2, bb.P))
    pad = torch.zeros((1 << 22, 2), dtype=torch.int32, device=dev)
    pad[: 1 << 20] = coeffs
    pad = bb.mul_canonical(pad, bb.powers(bb.GENERATOR, 1 << 22, dev)[:, None])
    want = ntt_kernel.dft_plain(pad)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K2 coset_lde_batch (2^20, 2) +2 bits: kernel != plain")
    k2_lines.append("coset_lde (1048576, 2) +2 bits exact")
    # the two pass kernels alone at the trace-LDE shape (2^23, 2)
    x = rand_monty((1 << 23, 2))
    tw, twp = ntt_kernel.stage_twiddles(23, False, dev)
    p = ntt_kernel.plan(23, 2)
    got0 = ntt_kernel.pass0(x, p, tw, twp)
    want0 = ntt_kernel.pass0_plain(x, p.k0, tw, twp)
    s0, k, j_log = p.passes[0]
    got1 = ntt_kernel.run_pass(want0.clone(), s0, k, j_log, p, tw, twp)
    want1 = ntt_kernel.pass_plain(want0, s0, k, tw, twp)
    torch.cuda.synchronize()
    err0, err1 = _max_abs_err(torch, got0, want0), _max_abs_err(torch, got1, want1)
    if err0 or err1:
        raise AssertionError(f"K2 pass kernels != plain passes ({err0}, {err1})")
    buf = want0.clone()
    results["ntt_pass0"] = (
        err0,
        _cuda_ms(torch, lambda: ntt_kernel.pass0(x, p, tw, twp), 10),
        _cuda_ms(torch, lambda: ntt_kernel.pass0_plain(x, p.k0, tw, twp), 2),
    )
    results["ntt_pass"] = (
        err1,
        _cuda_ms(torch, lambda: ntt_kernel.run_pass(buf, s0, k, j_log, p, tw, twp), 10),
        _cuda_ms(torch, lambda: ntt_kernel.pass_plain(want0, s0, k, tw, twp), 2),
    )
    k2_lines.append(
        f"(8388608, 2) pass0 k={p.k0}: {results['ntt_pass0'][1]:.4f} ms vs plain "
        f"{results['ntt_pass0'][2]:.3f} ms; pass s0={s0} k={k}: "
        f"{results['ntt_pass'][1]:.4f} ms vs plain {results['ntt_pass'][2]:.3f} ms"
    )
    print("[3] K2 ntt == plain (exact): " + "; ".join(k2_lines), flush=True)

    air = FibonacciAir()

    traces = {}

    def prove_bytes(log_n: int, layout: str, timings=None):
        """Prove fib(0, 1) at n = 2^log_n; the trace is made once, untimed."""
        n = 1 << log_n
        if log_n not in traces:
            traces[log_n] = (generate_trace_rows(0, 1, n), [0, 1, fibonacci_value(0, 1, n)])
        trace, pis = traces[log_n]
        cfg = create_config(zk=True, zk_rng="smallrng", zk_layout=layout, device=dev)
        proof = prove(cfg, air, trace, pis, timings=timings)
        return cfg, pis, serialize_proof(proof)

    # -- 4. n = 8 goldens --------------------------------------------------------
    for layout, name in (("tpu", "fib_air_zk_n8_smallrng.json"), ("p3", "fib_air_zk_n8_smallrng_p3.json")):
        with open(os.path.join(GOLDEN, name)) as f:
            fixture = json.load(f)
        cfg, pis, blob = prove_bytes(3, layout)
        if blob.hex() != fixture["proof_hex"]:
            raise AssertionError(f"n=8 {layout} proof differs from {name}")
        if not verify(cfg, air, deserialize_proof(blob), pis):
            raise AssertionError(f"n=8 {layout} proof does not verify")
    print("[4] n=8 proofs equal both golden files byte for byte, and verify", flush=True)

    # -- 5. JAX fixture at the largest n -----------------------------------------
    with open(os.path.join(GOLDEN, "torch_fib_zk_jax_proofs.json")) as f:
        jax_fixture = json.load(f)
    log_big = max(int(k.split("_")[1]) for k in jax_fixture)
    for layout in ("tpu", "p3"):
        _, _, blob = prove_bytes(log_big, layout)
        want = jax_fixture[f"{layout}_{log_big}"]
        got = {"sha256": hashlib.sha256(blob).hexdigest(), "len": len(blob)}
        if got["sha256"] != want["sha256"] or got["len"] != want["len"]:
            raise AssertionError(f"n=2^{log_big} {layout}: {got} != JAX {want}")
    print(f"[5] n=2^{log_big} proofs (tpu, p3) match the JAX SHA-256 and length", flush=True)

    # -- 6. n = 2^20 prove -------------------------------------------------------
    log_n = 20
    traces[log_n] = (generate_trace_rows(0, 1, 1 << log_n), [0, 1, fibonacci_value(0, 1, 1 << log_n)])
    t0 = time.perf_counter()
    prove_bytes(log_n, "tpu")
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, pis, blob = prove_bytes(log_n, "tpu", timings)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    ok = verify(cfg, air, deserialize_proof(blob), pis)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("n=2^20 proof does not verify")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by the n=2^20 prove")
    phases = ", ".join(f"{k} {v:.3f}s" for k, v in timings.items())
    print(f"[6] n=2^20 zk prove: cold {cold:.3f}s, warm {warm:.3f}s ({phases}); "
          f"verify {verify_s:.3f}s ok; proof {len(blob)} B; launches {launches}; "
          f"peak device memory {peak / 2**30:.3f} GiB", flush=True)

    kernel_rows = []
    for info in kernels.ALL:
        err, ms, plain_ms = results[info.name]
        kernel_rows.append({
            "name": info.name, "route": "cuda", "source": info.source,
            "replaces": info.replaces, "launches": launches[info.name],
            "max_abs_err": err, "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
        })
    print(_smi_line(), flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
