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
   (2^21, 8), (2^23, 2), (16384, 128) and a coset LDE at (2^20, 2); then at
   the main paths' shapes (2^21, 128), (2^20, 128) inverse, (2^18, 257) and
   (2^23, 2) each pass alone and the whole ``dft``, exact and timed against
   plain, the per-pass bound and the whole transform's HBM bound (one read
   and one write of the matrix), its int32 bound beside it (L2 flushed
   before each launch where the matrix would fit in it);
4. fib_air zk n = 8 proofs, both layouts, byte-equal to the golden files;
5. n = 2^14 proofs, both layouts, with the SHA-256 and length the JAX
   package produced (tests/golden/torch_fib_zk_jax_proofs.json);
6. an n = 2^20 fib_air zk prove on the Keccak stack (launch counts reset
   just before it, read just after), verified by the port's verifier, with
   cold/warm wall clock, phase times and peak device memory;
7. K3 (Poseidon2 sponge) against its plain torch version, exact, at leaf
   shapes (2^16, 493), (2^20, 8), (1000, 13) and 2^20 compress pairs;
8. Poseidon2-stack proofs equal to the JAX package's
   (tests/golden/torch_poseidon2_jax_proofs.json): fib_air zk n = 8 in both
   layouts byte for byte, fib_air non-zk n = 2^10 and the Poseidon2 chain at
   n = 8 and 2^6 by SHA-256 and length; each verifies;
9. the Poseidon2 chain at n = 2^18 x 493 columns (BASELINE config 3):
   trace generation timed on its own, a cold and a warm prove (launch counts
   reset just before the warm one, read just after), phase times, peak
   device memory, the quotient pass's own peak, and the port's verifier;
10. K4 (Poseidon2 carry-state absorb) against its plain torch version,
    exact: (2^16, 493) in chunks of 128, 128, 128 and 109 columns (also
    against one-shot K3) and (2^21, 128) on a carried random state, timed;
11. keccak-air proofs of the streamed wide prover equal to the JAX
    package's (tests/golden/torch_keccak_air_jax_proofs.json: SHA-256 and
    length at 64 and 128 rows); each verifies;
12. keccak-air at 2^20 x 3608 through ``prove_wide`` (BASELINE config 4:
    Poseidon2 stack, zk off, blowup 2, 100 queries, 16 PoW bits): trace
    generation timed on its own, a cold and a warm prove (launch counts
    reset just before the warm one, read just after), phase times, peak
    device memory, and the port's verifier, timed;
14. K5 (the limb-matmul DFT on the integer tensor cores) against its plain
    version, exact, at (256, 65536), (128, 131072) and ragged widths for
    n = 64, 32, 16; then the narrow NTT route (``narrow_ntt="mxu"``)
    against K2 at (2^16, 2), (2^21, 2), (2^22, 4), (2^23, 2) and
    (2^20, 32), forward and inverse, each timed beside K2;
15. the device zk rng against JAX's samples
    (tests/golden/torch_device_rng_jax.json: seeds 1 and 7, every stream
    tag, counters 0-2, up to (2^21, 4)), timed; the grind kernel against
    its plain version and the host check at 8-16 bits, and ``device_grind``
    against the witnesses JAX's stored;
16. BASELINE config 2 (fib_air zk at the defaults: device zk rng, blowup 2,
    100 queries, 16 PoW bits): proofs equal to the JAX package's
    (tests/golden/torch_fib_zk_device_jax_proofs.json: n = 8 byte for byte,
    2^10 and 2^12 by SHA-256 and length) on both NTT routes, then n = 2^20
    with ``narrow_ntt="mxu"``: a cold and a warm prove (launch counts reset
    just before the warm one, read just after), phase times, peak device
    memory, the port's verifier, and the same warm prove with
    ``narrow_ntt=None`` (its own launch counts), whose bytes must be equal;
13. (run last) every kernel against its plain version, exact, at every
    operand shape the five warm proves (phases 6, 9, 12 and the two of 16)
    called its wrapper with: K2's transforms by height, width and direction
    (the wide prover's (2^21, 128) chunk LDEs, (2^20, 128) iNTTs and
    quotient panels such as (2^18, 257)), K1's and K3's leaf and compress
    layers and K4's chunks by rows, widths and row strides, K5's products
    by n and width (both directions' tables) and the grind's chunks by
    count, tail blocks, witness offset and bits, on random inputs of those
    shapes.

Then the nvidia-smi line, a JSON line of per-kernel results (launches
summed over the five main paths; time, plain time and the bound of each
kernel at the shape it was timed; the largest error of phases 2-16), and
last ``{"ok": true, "device": {...}}``.  Exits nonzero without a result when
CUDA is unavailable or the package is missing.

The bound of a kernel is the least time the H100 could take for its work:
the larger of the bytes it must move (each input read once, each output
written once) over 3.35 TB/s and its int32 instructions over the issue
rate, 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz = 33.45 T/s (one warp
instruction per scheduler per clock, the most any integer mix can reach;
1.98 GHz is the clock of the data sheet's 67 TFLOP/s fp32), and for K5
also its 16 * 2 * n^2 * M int8 tensor operations over the data sheet's
dense int8 peak, 1,979 TOPS.  Instruction counts are lower bounds read off
the sources: a Montgomery product 5 (three multiplies, a subtract, a
select), a modular add 2, an NTT butterfly 9 (4 in a transform's stage 0,
whose twiddles are all 1), a Keccak round 180 (LOP3-fused xors, two funnel
shifts per 64-bit rotation), K5's epilogue 30 per output (the 7-diagonal
recombine in 64-bit adds and shifts, one REDC, a 64-bit remainder by P).
"""

from __future__ import annotations

import contextlib
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


HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 4 * 32 * 1.98e9
# int32 instructions, lower bounds (see the module docstring)
KECCAK_F_OPS = 24 * 180
# csrc/poseidon2_sponge.cu: 772 Montgomery products and 1300 modular adds
# per permutation (8 external rounds of 64 + 0 and 100 adds, 13 internal of
# 20 and 32, the first M_E's 84 adds)
POSEIDON2_PERM_OPS = 772 * 5 + 1300 * 2
NTT_BUTTERFLY_OPS = 9  # Montgomery product 5, add 2, subtract 2
NTT_STAGE0_OPS = 4  # a transform's stage 0: every twiddle is 1, no product


def _ntt_ops(n: int, stages: int, first: bool) -> int:
    """int32 instructions of ``stages`` butterfly stages over n elements
    (``first``: they include the transform's stage 0)."""
    return n // 2 * (stages * NTT_BUTTERFLY_OPS - first * (NTT_BUTTERFLY_OPS - NTT_STAGE0_OPS))


INT8_TENSOR_OPS_PER_S = 1.979e15
MXU_EPILOGUE_OPS = 30  # per output of K5


def _bound(n_bytes: float, n_ops: float, n_tensor_ops: float = 0.0):
    """(bound_ms, bound_by): the largest of the bytes, the int32
    instructions and the int8 tensor operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / INT32_OPS_PER_S, n_tensor_ops / INT8_TENSOR_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def import_port():
    """Import the port's modules this script drives (and nothing of JAX)."""
    import types

    from tpu_stark_torch import kernels
    from tpu_stark_torch.air import keccak_air, poseidon2_air
    from tpu_stark_torch.challenger import grind
    from tpu_stark_torch.challenger.challenger import Challenger, HashChallenger
    from tpu_stark_torch.compat.device_rng import DeviceRng
    from tpu_stark_torch.air.air import get_symbolic_info
    from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
    from tpu_stark_torch.compat import native
    from tpu_stark_torch.fields import babybear as bb
    from tpu_stark_torch.fri.config import create_benchmark_fri_params
    from tpu_stark_torch.hash import keccak_kernel, poseidon2_kernel
    from tpu_stark_torch.ntt import mxu_ntt, ntt_kernel, radix2
    from tpu_stark_torch.prover import prove as prove_mod
    from tpu_stark_torch.prover import wide
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.proof import deserialize_proof, serialize_proof
    from tpu_stark_torch.prover.prove import prove
    from tpu_stark_torch.prover.verify import verify

    return types.SimpleNamespace(**locals())


def _drive(kernels, fn, path_kernels):
    """Run one main path with every launch count set to 0 just before it;
    return (fn's result, the counts read just after).  Fails if a kernel of
    the path was not launched."""
    kernels.reset_launch_counts()
    out = fn()
    launches = {k.name: k.launches for k in kernels.ALL}
    for info in path_kernels:
        if launches[info.name] <= 0:
            raise AssertionError(f"kernel {info.name} was not launched by its main path")
    return out, launches


# wrapper call -> the kernels it launches
_SHAPE_KERNELS = {
    "dft": ("ntt_pass0", "ntt_pass"),
    "keccak_hash_rows": ("keccak_sponge",),
    "poseidon2_hash_rows": ("poseidon2_sponge",),
    "poseidon2_compress": ("poseidon2_sponge",),
    "poseidon2_absorb": ("poseidon2_absorb",),
    "mod_matmul_axis": ("mxu_mm",),
    "grind_verdicts": ("keccak_grind",),
}


@contextlib.contextmanager
def _record_shapes(port, seen: dict, path: str):
    """While open, note in ``seen`` (key -> the paths that gave it) the
    operands of every kernel wrapper call: K2's ``dft`` by height, width and
    direction; K1's and K3's ``hash_rows`` / ``compress`` and K4's
    ``absorb_rows`` by rows, and each operand's width and row stride; K5's
    ``mod_matmul_axis`` by n and width; the grind's ``verdicts`` by count,
    tail blocks, witness offset and bits."""
    nk, kk, pk = port.ntt_kernel, port.keccak_kernel, port.poseidon2_kernel

    def rows(t):
        return (0, 0) if t is None else (int(t.shape[1]), int(t.stride(0)))

    keys = {
        (nk, "dft"): lambda x, inverse=False: ("dft", int(x.shape[0]), int(x.shape[1]), bool(inverse)),
        (kk, "hash_rows"): lambda a, b=None: ("keccak_hash_rows", int(a.shape[0]), *rows(a), *rows(b)),
        (pk, "hash_rows"): lambda a, b=None: ("poseidon2_hash_rows", int(a.shape[0]), *rows(a), *rows(b)),
        (pk, "compress"): lambda a, b: ("poseidon2_compress", int(a.shape[0]), *rows(a), *rows(b)),
        (pk, "absorb_rows"): lambda s, c, first=False: (
            "poseidon2_absorb", int(c.shape[0]), *rows(c), bool(first)),
        (port.mxu_ntt, "mod_matmul_axis"): lambda x, w: (
            "mod_matmul_axis", int(x.shape[0]), x.numel() // int(x.shape[0])),
        (port.grind, "verdicts"): lambda start, count, pre, tail, w_off, bits: (
            "grind_verdicts", int(count), int(tail.shape[0]), int(w_off), int(bits)),
    }
    originals = {}
    for (mod, name), key in keys.items():
        orig = originals[(mod, name)] = getattr(mod, name)

        def recorded(*args, _orig=orig, _key=key, **kw):
            seen.setdefault(_key(*args, **kw), set()).add(path)
            return _orig(*args, **kw)

        setattr(mod, name, recorded)
    try:
        yield
    finally:
        for (mod, name), orig in originals.items():
            setattr(mod, name, orig)


def _check_shapes(torch, port, seen: dict, rand_u32, rand_monty) -> dict:
    """Phase 13: every wrapper noted by ``_record_shapes`` against its plain
    version, exactly, on random operands of the noted shapes and row
    strides.  Returns {call kind: [shapes checked, max_abs_err]}."""
    nk, kk, pk, mx = port.ntt_kernel, port.keccak_kernel, port.poseidon2_kernel, port.mxu_ntt

    def operand(rand, n, k, stride):
        return None if k == 0 else rand((n, max(k, stride)))[:, :k]

    done = {}
    for key in sorted(seen, key=repr):
        kind, n = key[0], key[1]
        if kind == "dft":
            x = rand_monty((n, key[2]))
            got, want = nk.dft(x, key[3]), nk.dft_plain(x, key[3])
        elif kind == "mod_matmul_axis":
            x = rand_monty((n, key[2]))
            both = [mx.limbs_on(n, inverse, x.device) for inverse in (False, True)]
            got = torch.stack([mx.mod_matmul_axis(x, w) for w in both])
            want = torch.stack([mx.mod_matmul_axis_plain(x, w) for w in both])
        elif kind == "grind_verdicts":
            pre, tail = rand_u32((25, 2)).view(torch.int64).view(25), rand_u32((key[2], 34)).view(torch.int64)
            got = port.grind.verdicts(0, n, pre, tail, key[3], key[4])
            want = port.grind.verdicts_plain(0, n, pre, tail, key[3], key[4])
        elif kind == "poseidon2_absorb":
            state, chunk = rand_monty((n, pk.WIDTH)), operand(rand_monty, n, key[2], key[3])
            got = pk.absorb_rows(state.clone(), chunk, key[4])
            want = pk.absorb_rows_plain(state.clone(), chunk, key[4])
        else:
            rand = rand_u32 if kind == "keccak_hash_rows" else rand_monty
            a, b = operand(rand, n, key[2], key[3]), operand(rand, n, key[4], key[5])
            mod = kk if kind == "keccak_hash_rows" else pk
            if kind == "poseidon2_compress":
                got, want = mod.compress(a, b), mod.compress_plain(a, b)
            else:
                got, want = mod.hash_rows(a, b), mod.hash_rows_plain(a, b)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"{key} (from {sorted(seen[key])}): kernel != plain (max_abs_err {err})")
        entry = done.setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] = max(entry[1], err)
    return done


# K2's timed shapes: config 4's chunk LDE, its iNTT and a quotient panel, and
# the fib trace LDE
K2_TIMED = (((1 << 21, 128), False), ((1 << 20, 128), True), ((1 << 18, 257), False), ((1 << 23, 2), False))
L2_BYTES = 50 << 20


def _cuda_ms_cold(torch, fn, reps: int, flush) -> float:
    """Mean device time of fn with L2 flushed before each launch (where
    ``flush`` is a tensor; with None, as _cuda_ms)."""
    if flush is None:
        return _cuda_ms(torch, fn, reps)
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _phase3_k2(torch, port, rand_monty, results, dev) -> str:
    """K2 exact against its plain version (dft/idft, the coset LDE, each pass
    alone), then each pass and the whole transform timed at K2_TIMED against
    plain, the per-pass bound and the whole transform's bound (one read and
    one write of the matrix); returns the phase's line."""
    nk, radix2, bb = port.ntt_kernel, port.radix2, port.bb
    lines = []
    for h, w in [(1 << 20, 2), (1 << 21, 8), (1 << 23, 2), (16384, 128)]:
        x = rand_monty((h, w))
        for inverse in (False, True):
            got = radix2.idft_batch(x) if inverse else radix2.dft_batch(x)
            plain = nk.dft_plain(x, inverse)
            if inverse:
                plain = bb.mul_canonical(plain, pow(h, bb.P - 2, bb.P))
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise AssertionError(f"K2 ({h}, {w}) inverse={inverse}: kernel != plain")
    x = rand_monty((1 << 20, 2))  # coset LDE at (2^20, 2), added_bits 2
    got = radix2.coset_lde_batch(x, 2, bb.GENERATOR)
    coeffs = bb.mul_canonical(nk.dft_plain(x, True), pow(1 << 20, bb.P - 2, bb.P))
    pad = torch.zeros((1 << 22, 2), dtype=torch.int32, device=dev)
    pad[: 1 << 20] = coeffs
    pad = bb.mul_canonical(pad, bb.powers(bb.GENERATOR, 1 << 22, dev)[:, None])
    want = nk.dft_plain(pad)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K2 coset_lde_batch (2^20, 2) +2 bits: kernel != plain")
    lines.append("dft/idft exact at (1048576, 2), (2097152, 8), (8388608, 2), (16384, 128); "
                 "coset_lde (1048576, 2) +2 bits exact")

    flush = torch.empty(L2_BYTES + (14 << 20), dtype=torch.int8, device=dev)
    for (h, w), inverse in K2_TIMED:
        x = rand_monty((h, w))
        log_h, n = h.bit_length() - 1, h * w
        cold = flush if n * 4 < L2_BYTES else None  # config 4 finds these cold
        tw = nk.stage_twiddles(log_h, inverse, dev)
        p = nk.plan(log_h, w)
        got = nk.pass0(x, p, tw)
        cur = nk.pass0_plain(x, p.k0, tw)
        err = _max_abs_err(torch, got, cur)
        stages = [p.k0]
        times = [(_cuda_ms_cold(torch, lambda: nk.pass0(x, p, tw), 10, cold),
                  _cuda_ms(torch, lambda: nk.pass0_plain(x, p.k0, tw), 1))]
        for s0, k, j_log in p.passes:
            got = nk.run_pass(cur.clone(), s0, k, j_log, p, tw)
            nxt = nk.pass_plain(cur, s0, k, tw)
            err = max(err, _max_abs_err(torch, got, nxt))
            stages.append(k)
            times.append((_cuda_ms_cold(torch, lambda: nk.run_pass(got, s0, k, j_log, p, tw), 10, cold),
                          _cuda_ms(torch, lambda: nk.pass_plain(cur, s0, k, tw), 1)))
            cur = nxt
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"K2 ({h}, {w}) inverse={inverse}: a pass kernel != its plain pass ({err})")
        dft_ms = _cuda_ms_cold(torch, lambda: nk.dft(x, inverse), 10, cold)
        dft_plain_ms = _cuda_ms(torch, lambda: nk.dft_plain(x, inverse), 1)
        transform_bound = 2 * n * 4 / HBM_BYTES_PER_S * 1e3  # one read and one write of the matrix
        transform_ops = _ntt_ops(n, log_h, True) / INT32_OPS_PER_S * 1e3
        passes = []
        for i, (k, (ms, plain_ms)) in enumerate(zip(stages, times)):
            bound_ms, bound_by = _bound(2 * n * 4, _ntt_ops(n, k, i == 0))
            passes.append(f"{'pass0' if i == 0 else 'pass'} k={k} {ms:.4f} ms vs plain {plain_ms:.3f} ms, "
                          f"{100 * bound_ms / ms:.1f}% of {bound_ms:.4f} ms ({bound_by})")
            name = "ntt_pass0" if i == 0 else "ntt_pass"
            if (h, w) == K2_TIMED[0][0] and name not in results:
                results[name] = (err, ms, plain_ms, bound_ms, bound_by, {
                    "shape": [h, w], "transform_ms": round(dft_ms, 6),
                    "transform_bound_ms": round(transform_bound, 6), "transform_ops_ms": round(transform_ops, 6)})
        lines.append(
            f"({h}, {w}){' inv' if inverse else ''}: dft {dft_ms:.4f} ms vs plain {dft_plain_ms:.3f} ms, "
            f"{100 * transform_bound / dft_ms:.1f}% of the transform's HBM bound {transform_bound:.4f} ms "
            f"(int32 instructions {transform_ops:.4f} ms)"
            f"{' (L2 flushed)' if cold is not None else ''}; " + "; ".join(passes))
    del flush
    return "[3] K2 ntt == plain (exact): " + " | ".join(lines)


def _phase14_mxu(torch, port, rand_monty, results) -> str:
    """K5 against its plain version at the route's widths, then the narrow
    route against K2; returns the phase's line."""
    mx, radix2 = port.mxu_ntt, port.radix2
    lines = []
    for n, m in [(256, 65536), (128, 131072), (64, 262147), (32, 524269), (16, 1048573)]:
        x = rand_monty((n, m))
        err = 0
        for inverse in (False, True):
            limbs = mx.limbs_on(n, inverse, x.device)
            got, want = mx.mod_matmul_axis(x, limbs), mx.mod_matmul_axis_plain(x, limbs)
            torch.cuda.synchronize()
            err = max(err, _max_abs_err(torch, got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"K5 ({n}, {m}) inverse={inverse}: kernel != plain (max_abs_err {err})")
        limbs = mx.limbs_on(n, False, x.device)
        ms = _cuda_ms(torch, lambda: mx.mod_matmul_axis(x, limbs), 20)
        tensor_ops = 16 * 2 * n * n * m
        lines.append(f"({n}, {m}): {ms:.4f} ms ({tensor_ops / ms / 1e9:.1f} int8 TOPS)")
        if n == 256:
            plain_ms = _cuda_ms(torch, lambda: mx.mod_matmul_axis_plain(x, limbs), 2)
            results["mxu_mm"] = (err, ms, plain_ms, *_bound(
                2 * n * m * 4 + 4 * n * n, n * m * MXU_EPILOGUE_OPS, tensor_ops))
            lines[-1] += f" vs plain {plain_ms:.3f} ms, bound {results['mxu_mm'][3]:.4f} ms"
        del x
    route = []
    for h, w in [(1 << 16, 2), (1 << 21, 2), (1 << 22, 4), (1 << 23, 2), (1 << 20, 32)]:
        x = rand_monty((h, w))
        for inverse in (False, True):
            fn = radix2.idft_batch if inverse else radix2.dft_batch
            if not torch.equal(fn(x, "mxu"), fn(x)):
                raise AssertionError(f"narrow route ({h}, {w}) inverse={inverse} != K2")
        mxu_ms = _cuda_ms(torch, lambda: radix2.dft_batch(x, "mxu"), 5)
        k2_ms = _cuda_ms(torch, lambda: radix2.dft_batch(x), 5)
        route.append(f"({h}, {w}): route {mxu_ms:.4f} ms vs K2 {k2_ms:.4f} ms")
        del x
    return ("[14] K5 mxu matmul == plain (exact): " + "; ".join(lines)
            + ". Narrow route == K2 (dft and idft, exact); dft times: " + "; ".join(route))


def _phase15_rng_grind(torch, port, dev, results) -> str:
    """The device rng against JAX's samples, the grind kernel against its
    plain version, the host check and JAX's witnesses; returns the line."""
    import numpy as np

    with open(os.path.join(GOLDEN, "torch_device_rng_jax.json")) as f:
        fixture = json.load(f)
    for e in fixture["samples"]:
        rng = port.DeviceRng(e["seed"], e["stream"], dev)
        for _ in range(e["counter"]):
            rng.sample_babybear_matrix_monty(1, 1)
        flat = rng.sample_babybear_matrix_monty(e["rows"], e["cols"]).cpu().numpy().astype("<u4").ravel()
        got = (hashlib.sha256(flat.tobytes()).hexdigest(), [int(v) for v in flat[:8]])
        if got != (e["sha256"], e["first"]):
            raise AssertionError(f"device rng {e['seed']}/{e['stream']!r}/{e['counter']} "
                                 f"({e['rows']}, {e['cols']}) differs from JAX's sample")
    rng = port.DeviceRng(1, "salts", dev)
    rng_ms = {shape: _cuda_ms(torch, lambda: rng.sample_babybear_matrix_monty(*shape), 5)
              for shape in [(1 << 21, 4), (1 << 22, 4)]}
    grind = port.grind
    lines = []
    err = 0
    for e in fixture["grind"]:
        data, bits = bytes.fromhex(e["transcript_hex"]), e["bits"]
        prefix, tail, w_off = grind._plan(data)
        pre, tl = grind._operands(prefix, tail, dev)
        flags = grind.verdicts(0, 1 << 17, pre, tl, w_off, bits)
        want = grind.verdicts_plain(0, 1 << 17, pre, tl, w_off, bits)
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(torch, flags, want))
        if not torch.equal(flags, want):
            raise AssertionError(f"grind kernel != plain ({len(data)} B, {bits} bits)")
        ch = port.Challenger(port.HashChallenger(data), device=dev)
        host = [grind.PASSED if ch.clone().check_witness(bits, w) else 0 for w in range(512)]
        if flags[:512].cpu().tolist() != host or not ch.clone().check_witness(bits, e["witness"]):
            raise AssertionError(f"grind kernel != host check ({len(data)} B, {bits} bits)")
        t0 = time.perf_counter()
        w = grind.device_grind(data, bits, dev)
        wall = time.perf_counter() - t0
        if w != e["witness"]:
            raise AssertionError(f"device_grind found {w}, JAX {e['witness']} ({len(data)} B, {bits} bits)")
        lines.append(f"{len(data)} B at {bits} bits: witness {w} in {wall * 1e3:.2f} ms")
        if bits == 16 and "keccak_grind" not in results:
            n_blocks = int(tl.shape[0])
            ms = _cuda_ms(torch, lambda: grind.verdicts(0, 1 << 17, pre, tl, w_off, bits), 20)
            plain_ms = _cuda_ms(torch, lambda: grind.verdicts_plain(0, 1 << 17, pre, tl, w_off, bits), 2)
            results["keccak_grind"] = [err, ms, plain_ms, *_bound(
                (1 << 17) + 8 * (25 + 17 * n_blocks), (1 << 17) * n_blocks * KECCAK_F_OPS)]
            lines[-1] += f" (2^17-candidate chunk, {n_blocks} block(s): {ms:.4f} ms vs plain {plain_ms:.3f} ms)"
    results["keccak_grind"][0] = err
    return (f"[15] device rng == JAX's {len(fixture['samples'])} samples; one sample (2^21, 4) "
            f"{rng_ms[(1 << 21, 4)]:.4f} ms, (2^22, 4) {rng_ms[(1 << 22, 4)]:.4f} ms. Grind kernel == plain "
            f"== host check; device_grind == JAX: " + "; ".join(lines))


@contextlib.contextmanager
def _note_rng_shapes(port, shapes: list):
    """While open, append the shape of every device-rng sample call to ``shapes``."""
    cls = port.DeviceRng
    orig = cls.sample_babybear_matrix_monty

    def noted(self, rows, cols):
        shapes.append((int(rows), int(cols)))
        return orig(self, rows, cols)

    cls.sample_babybear_matrix_monty = noted
    try:
        yield
    finally:
        cls.sample_babybear_matrix_monty = orig


def _phase16_config2(torch, port, dev, seen, log_n: int):
    """BASELINE config 2: the JAX fixture on both routes, then 2^log_n with
    each route.  Returns (the phase's line, {path: launches})."""
    kernels = port.kernels
    air = port.FibonacciAir()

    def cfg(narrow):
        return port.create_config(port.create_benchmark_fri_params(1), zk=True, device=dev, narrow_ntt=narrow)

    def prove_blob(n, narrow, timings=None):
        pis = [0, 1, port.fibonacci_value(0, 1, n)]
        c = cfg(narrow)
        return c, pis, port.serialize_proof(port.prove(c, air, traces[n], pis, timings=timings))

    with open(os.path.join(GOLDEN, "torch_fib_zk_device_jax_proofs.json")) as f:
        fixture = json.load(f)
    traces = {1 << int(k): port.generate_trace_rows(0, 1, 1 << int(k)) for k in fixture}
    for k, want in sorted(fixture.items(), key=lambda kv: int(kv[0])):
        for narrow in (None, "mxu"):
            c, pis, blob = prove_blob(1 << int(k), narrow)
            if "proof_hex" in want and blob.hex() != want["proof_hex"]:
                raise AssertionError(f"config 2 n=2^{k} ({narrow}): bytes differ from the JAX fixture")
            if (hashlib.sha256(blob).hexdigest(), len(blob)) != (want["sha256"], want["len"]):
                raise AssertionError(f"config 2 n=2^{k} ({narrow}): SHA-256 or length differs from JAX's")
            if not port.verify(c, air, port.deserialize_proof(blob), pis):
                raise AssertionError(f"config 2 n=2^{k} ({narrow}): proof does not verify")
    n = 1 << log_n
    traces[n] = port.generate_trace_rows(0, 1, n)
    t0 = time.perf_counter()
    prove_blob(n, "mxu")
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches, warm, timings, blobs, peaks, rng_shapes = {}, {}, {}, {}, {}, {}
    for narrow, path, path_kernels in (
        ("mxu", "config2-mxu", (kernels.MXU_MM, kernels.KECCAK_SPONGE, kernels.KECCAK_GRIND)),
        (None, "config2-k2", (kernels.NTT_PASS0, kernels.NTT_PASS, kernels.KECCAK_SPONGE, kernels.KECCAK_GRIND)),
    ):
        torch.cuda.reset_peak_memory_stats(dev)
        timings[path] = {}

        def warm_prove():
            t0 = time.perf_counter()
            out = prove_blob(n, narrow, timings[path])
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        with _record_shapes(port, seen, path), _note_rng_shapes(port, rng_shapes.setdefault(path, [])):
            ((c, pis, blobs[path]), warm[path]), launches[path] = _drive(kernels, warm_prove, path_kernels)
        peaks[path] = torch.cuda.max_memory_allocated(dev)
    if blobs["config2-mxu"] != blobs["config2-k2"]:
        raise AssertionError(f"config 2 n=2^{log_n}: the mxu and K2 routes' proofs differ")
    proof = port.deserialize_proof(blobs["config2-mxu"])
    t0 = time.perf_counter()
    ok = port.verify(c, air, proof, pis)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"config 2 n=2^{log_n} proof does not verify")
    if (proof.degree_bits != log_n or len(proof.opening_proof.query_proofs) != 100
            or proof.opening_proof.pow_witness is None):
        raise AssertionError(f"config 2 n=2^{log_n}: not a 100-query proof of 2^{log_n} rows")

    def phases(path):
        return ", ".join(f"{k} {v:.3f}s" for k, v in timings[path].items())

    # the device rng's share: each sample call of the warm prove, timed alone
    rng = port.DeviceRng(1, "salts", dev)
    shapes = rng_shapes["config2-mxu"]
    rng_s = sum(_cuda_ms(torch, lambda: rng.sample_babybear_matrix_monty(*shape), 3) for shape in shapes) / 1e3

    line = (f"[16] config 2 (fib zk, device rng, blowup 2, 100 queries, 16 PoW bits): the JAX fixture "
            f"(n=8 bytes, 2^10 and 2^12 SHA-256) on both routes, all verify; n=2^{log_n} narrow_ntt='mxu': "
            f"cold {cold:.3f}s, warm {warm['config2-mxu']:.3f}s ({phases('config2-mxu')}); peak device memory "
            f"{peaks['config2-mxu'] / 2**30:.3f} GiB; launches {launches['config2-mxu']}; narrow_ntt=None: warm "
            f"{warm['config2-k2']:.3f}s ({phases('config2-k2')}), peak {peaks['config2-k2'] / 2**30:.3f} GiB, "
            f"launches {launches['config2-k2']}; same bytes ({len(blobs['config2-mxu'])} B); verify "
            f"{verify_s:.3f}s ok; the warm prove's {len(shapes)} device-rng samples {sorted(shapes)} take "
            f"{rng_s * 1e3:.3f} ms alone (CUDA events), {100 * rng_s / warm['config2-mxu']:.1f}% of its warm time")
    return line, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "tpu_stark_torch")):
        print("chip_smoke: tpu_stark_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    port = import_port()
    kernels, native, bb = port.kernels, port.native, port.bb
    keccak_air, poseidon2_air, wide = port.keccak_air, port.poseidon2_air, port.wide
    keccak_kernel, poseidon2_kernel = port.keccak_kernel, port.poseidon2_kernel
    FibonacciAir, fibonacci_value, generate_trace_rows = (
        port.FibonacciAir, port.fibonacci_value, port.generate_trace_rows)
    create_config, prove, verify, prove_mod = port.create_config, port.prove, port.verify, port.prove_mod
    serialize_proof, deserialize_proof = port.serialize_proof, port.deserialize_proof
    get_symbolic_info = port.get_symbolic_info

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _smi_line()

    # -- 1. device + build ---------------------------------------------------
    t0 = time.perf_counter()
    build = kernels.build(force=True)
    kernels.lib()
    if native.get_lib() is None:
        raise RuntimeError("the C host helper (tpu_stark_torch/csrc/host) did not build")
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
    seen = {}  # operand shapes of the kernel wrappers in the warm proves (phase 13)

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
            n, k = a.shape
            items = -(-k // 2)  # u32 pairs form the u64 items of the rate-17 sponge
            perms = n * -(-items // keccak_kernel.RATE)
            results["keccak_sponge"] = (err, ms, plain_ms, *_bound(n * k * 4 + n * 32, perms * KECCAK_F_OPS))
    print("[2] K1 keccak sponge == plain (exact): " + "; ".join(k1_lines), flush=True)

    # -- 3. K2 vs plain --------------------------------------------------------
    print(_phase3_k2(torch, port, rand_monty, results, dev), flush=True)

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

    def warm_fib():
        t0 = time.perf_counter()
        out = prove_bytes(log_n, "tpu", timings)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with _record_shapes(port, seen, "fib"):
        ((cfg, pis, blob), warm), fib_launches = _drive(
            kernels, warm_fib, (kernels.KECCAK_SPONGE, kernels.NTT_PASS0, kernels.NTT_PASS))
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    ok = verify(cfg, air, deserialize_proof(blob), pis)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("n=2^20 proof does not verify")
    phases = ", ".join(f"{k} {v:.3f}s" for k, v in timings.items())
    print(f"[6] n=2^20 zk prove: cold {cold:.3f}s, warm {warm:.3f}s ({phases}); "
          f"verify {verify_s:.3f}s ok; proof {len(blob)} B; launches {fib_launches}; "
          f"peak device memory {peak / 2**30:.3f} GiB", flush=True)

    # -- 7. K3 vs plain --------------------------------------------------------
    k3_lines = []
    for label, a, b in [
        ("leaf (65536, 493)", rand_monty((1 << 16, 493)), None),
        ("leaf (1048576, 8)", rand_monty((1 << 20, 8)), None),
        ("leaf (1000, 13)", rand_monty((1000, 13)), None),
        ("compress 1048576 pairs", rand_monty((1 << 20, 8)), rand_monty((1 << 20, 8))),
    ]:
        if b is None:
            got, want = poseidon2_kernel.hash_rows(a), poseidon2_kernel.hash_rows_plain(a)
            run = lambda: poseidon2_kernel.hash_rows(a)  # noqa: E731
            run_plain = lambda: poseidon2_kernel.hash_rows_plain(a)  # noqa: E731
            perms = a.shape[0] * -(-a.shape[1] // poseidon2_kernel.RATE)
        else:
            got, want = poseidon2_kernel.compress(a, b), poseidon2_kernel.compress_plain(a, b)
            run = lambda: poseidon2_kernel.compress(a, b)  # noqa: E731
            run_plain = lambda: poseidon2_kernel.compress_plain(a, b)  # noqa: E731
            perms = a.shape[0]
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"K3 {label}: kernel != plain (max_abs_err {err})")
        ms = _cuda_ms(torch, run, 10)
        plain_ms = _cuda_ms(torch, run_plain, 1)
        k3_lines.append(f"{label}: {ms:.4f} ms vs plain {plain_ms:.3f} ms "
                        f"({perms / ms / 1e3:.1f} Mperm/s)")
        if label.startswith("leaf (65536, 493)"):
            results["poseidon2_sponge"] = (
                err, ms, plain_ms, *_bound(a.numel() * 4 + a.shape[0] * 32, perms * POSEIDON2_PERM_OPS))
    # the kernel alone at the chain's trace-leaf shape (2^20, 493)
    a = rand_monty((1 << 20, 493))
    ms = _cuda_ms(torch, lambda: poseidon2_kernel.hash_rows(a), 3)
    k3_lines.append(f"leaf (1048576, 493) kernel only: {ms:.4f} ms "
                    f"({a.shape[0] * 62 / ms / 1e3:.1f} Mperm/s)")
    del a
    print("[7] K3 poseidon2 sponge == plain (exact): " + "; ".join(k3_lines), flush=True)

    # -- 8. Poseidon2-stack proofs against the JAX fixture -----------------------
    with open(os.path.join(GOLDEN, "torch_poseidon2_jax_proofs.json")) as f:
        p2_fixture = json.load(f)
    chain_air = poseidon2_air.Poseidon2ChainAir()
    chain_init = list(range(16))

    def p2_fib(log_n, zk, layout="tpu"):
        n = 1 << log_n
        cfg = create_config(zk=zk, hash="poseidon2", zk_rng="smallrng", zk_layout=layout, device=dev)
        pis = [0, 1, fibonacci_value(0, 1, n)]
        return cfg, air, pis, prove(cfg, air, generate_trace_rows(0, 1, n), pis)

    def p2_chain(log_n, timings=None, trace_pis=None):
        cfg = create_config(zk=False, hash="poseidon2", device=dev)
        trace, pis = trace_pis or poseidon2_air.generate_trace(1 << log_n, chain_init, device=dev)
        return cfg, chain_air, pis, prove(cfg, chain_air, trace, pis, timings=timings)

    for key, job in [
        ("fib_zk_tpu_3", lambda: p2_fib(3, True, "tpu")),
        ("fib_zk_p3_3", lambda: p2_fib(3, True, "p3")),
        ("fib_plain_10", lambda: p2_fib(10, False)),
        ("chain_3", lambda: p2_chain(3)),
        ("chain_6", lambda: p2_chain(6)),
    ]:
        cfg, p_air, pis, proof = job()
        blob = serialize_proof(proof)
        want = p2_fixture[key]
        if "proof_hex" in want and blob.hex() != want["proof_hex"]:
            raise AssertionError(f"poseidon2 {key}: proof bytes differ from the JAX fixture")
        got = {"sha256": hashlib.sha256(blob).hexdigest(), "len": len(blob)}
        if got["sha256"] != want["sha256"] or got["len"] != want["len"]:
            raise AssertionError(f"poseidon2 {key}: {got} != JAX {want}")
        if not verify(cfg, p_air, deserialize_proof(blob), pis):
            raise AssertionError(f"poseidon2 {key}: proof does not verify")
    print("[8] Poseidon2 stack: fib zk n=8 (tpu, p3) byte-equal to JAX; fib 2^10 and "
          "chain n=8, 2^6 match the JAX SHA-256 and length; all verify", flush=True)

    # -- 9. the Poseidon2 chain at n = 2^18 x 493 (BASELINE config 3) ------------
    log_chain = 18
    t0 = time.perf_counter()
    chain_trace = poseidon2_air.generate_trace(1 << log_chain, chain_init, device=dev)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p2_chain(log_chain, trace_pis=chain_trace)
    torch.cuda.synchronize()
    chain_cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    chain_timings = {}

    def warm_chain():
        t0 = time.perf_counter()
        out = p2_chain(log_chain, chain_timings, chain_trace)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with _record_shapes(port, seen, "chain"):
        ((cfg, p_air, pis, proof), chain_warm), chain_launches = _drive(
            kernels, warm_chain, (kernels.NTT_PASS0, kernels.NTT_PASS, kernels.POSEIDON2_SPONGE))
    chain_peak = torch.cuda.max_memory_allocated(dev)
    blob = serialize_proof(proof)
    t0 = time.perf_counter()
    ok = verify(cfg, p_air, deserialize_proof(blob), pis)
    chain_verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("chain n=2^18 proof does not verify")
    # the quotient pass alone (525 constraints folded over 2^19 points), on
    # the trace's own rows as stand-in inputs: its peak above those inputs
    qd_log = proof.log_quotient_degree
    q_in = bb.to_tensor(bb.np_to_monty(chain_trace[0]), dev).repeat(1 << qd_log, 1)
    apows = rand_monty((get_symbolic_info(p_air, len(pis))[0], 4))
    pis_dev = bb.from_u32(torch.tensor(pis, dtype=torch.int64, device=dev))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    prove_mod._quotient_values(p_air, q_in, pis_dev, apows, log_chain, log_chain + qd_log)
    torch.cuda.synchronize()
    q_peak = torch.cuda.max_memory_allocated(dev) - base
    del q_in
    if proof.degree_bits != log_chain or len(proof.commitments.trace) != 8:
        raise AssertionError("chain n=2^18 proof is not a Poseidon2 proof of 2^18 rows")
    phases = ", ".join(f"{k} {v:.3f}s" for k, v in chain_timings.items())
    print(f"[9] chain n=2^18 x {poseidon2_air.COLS} prove (Poseidon2, zk=False, blowup 4): "
          f"trace generation {trace_s:.3f}s; cold {chain_cold:.3f}s, warm {chain_warm:.3f}s "
          f"({phases}); verify {chain_verify_s:.3f}s ok; proof {len(blob)} B; launches "
          f"{chain_launches}; peak device memory {chain_peak / 2**30:.3f} GiB; quotient pass "
          f"peak {q_peak / 2**30:.3f} GiB above its inputs", flush=True)

    # -- 10. K4 vs plain ---------------------------------------------------------
    a = rand_monty((1 << 16, 493))
    got = torch.empty((1 << 16, 16), dtype=torch.int32, device=dev)
    want = torch.empty_like(got)
    off = 0
    for i, wc in enumerate((128, 128, 128, 109)):  # ragged only as the row's last chunk
        poseidon2_kernel.absorb_rows(got, a[:, off : off + wc], first=(i == 0))
        poseidon2_kernel.absorb_rows_plain(want, a[:, off : off + wc], first=(i == 0))
        off += wc
    one_shot = poseidon2_kernel.hash_rows(a)
    torch.cuda.synchronize()
    err_a = _max_abs_err(torch, got, want)
    if err_a != 0 or not torch.equal(got[:, :8], one_shot):
        raise AssertionError(f"K4 (65536, 493) in 4 chunks: kernel != plain or != K3 (max_abs_err {err_a})")
    chunk = rand_monty((1 << 21, 128))
    carried = rand_monty((1 << 21, 16))
    got = poseidon2_kernel.absorb_rows(carried.clone(), chunk)
    want = poseidon2_kernel.absorb_rows_plain(carried.clone(), chunk)
    torch.cuda.synchronize()
    err_b = _max_abs_err(torch, got, want)
    if err_b != 0:
        raise AssertionError(f"K4 (2097152, 128) on a carried state: kernel != plain (max_abs_err {err_b})")
    k4_ms = _cuda_ms(torch, lambda: poseidon2_kernel.absorb_rows(got, chunk), 5)
    k4_plain_ms = _cuda_ms(torch, lambda: poseidon2_kernel.absorb_rows_plain(want, chunk), 1)
    perms = chunk.shape[0] * chunk.shape[1] // poseidon2_kernel.RATE
    results["poseidon2_absorb"] = (
        max(err_a, err_b), k4_ms, k4_plain_ms,
        *_bound(chunk.numel() * 4 + 2 * carried.numel() * 4, perms * POSEIDON2_PERM_OPS),
    )
    del a, got, want, chunk, carried, one_shot
    print(f"[10] K4 poseidon2 absorb == plain (exact): (65536, 493) in chunks 128+128+128+109 "
          f"== plain == one-shot K3; (2097152, 128) on a carried state: {k4_ms:.4f} ms vs plain "
          f"{k4_plain_ms:.3f} ms ({perms / k4_ms / 1e3:.1f} Mperm/s)", flush=True)

    # -- 11. keccak-air wide proofs against the JAX fixture ----------------------
    with open(os.path.join(GOLDEN, "torch_keccak_air_jax_proofs.json")) as f:
        k_fixture = json.load(f)
    k_air = keccak_air.KeccakAir()

    def k_cfg():
        return create_config(port.create_benchmark_fri_params(1), zk=False, hash="poseidon2", device=dev)

    for perms_n, col_chunk in ((2, None), (5, 64)):
        want = k_fixture[f"perms_{perms_n}"]
        k_trace = keccak_air.generate_trace(perms_n, seed=1, device=dev)
        blob = serialize_proof(wide.prove_wide(k_cfg(), k_air, k_trace, [], col_chunk=col_chunk))
        got = {"sha256": hashlib.sha256(blob).hexdigest(), "len": len(blob)}
        if got["sha256"] != want["sha256"] or got["len"] != want["len"]:
            raise AssertionError(f"keccak-air perms={perms_n}: {got} != JAX {want}")
        if not verify(k_cfg(), k_air, deserialize_proof(blob), []):
            raise AssertionError(f"keccak-air perms={perms_n}: proof does not verify")
    print("[11] keccak-air prove_wide at 64 and 128 rows (benchmark FRI) match the JAX SHA-256 "
          "and length; both verify", flush=True)

    # -- 12. keccak-air at 2^20 x 3608 (BASELINE config 4) ------------------------
    log_k = 20
    t0 = time.perf_counter()
    k_trace = keccak_air.generate_trace((1 << log_k) // keccak_air.NUM_ROUNDS, seed=1, device=dev)[: 1 << log_k]
    torch.cuda.synchronize()
    k_trace_s = time.perf_counter() - t0
    cold_timings = {}
    t0 = time.perf_counter()
    wide.prove_wide(k_cfg(), k_air, k_trace, [], timings=cold_timings)
    torch.cuda.synchronize()
    k_cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    k_timings = {}

    def warm_keccak():
        t0 = time.perf_counter()
        out = wide.prove_wide(k_cfg(), k_air, k_trace, [], timings=k_timings)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with _record_shapes(port, seen, "keccak-air"):
        (proof, k_warm), k_launches = _drive(kernels, warm_keccak, (
            kernels.NTT_PASS0, kernels.NTT_PASS, kernels.POSEIDON2_SPONGE, kernels.POSEIDON2_ABSORB))
    k_peak = torch.cuda.max_memory_allocated(dev)
    blob = serialize_proof(proof)
    t0 = time.perf_counter()
    ok = verify(k_cfg(), k_air, deserialize_proof(blob), [])
    k_verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("keccak-air 2^20 proof does not verify")
    if (proof.degree_bits != log_k or proof.log_quotient_degree != 2
            or len(proof.opening_proof.query_proofs) != 100 or len(proof.opened_values.trace_local) != keccak_air.COLS):
        raise AssertionError("keccak-air 2^20 proof is not a 100-query proof of 2^20 x 3608 with 4 quotient chunks")
    phases = ", ".join(f"{k} {v:.3f}s" for k, v in k_timings.items())
    cold_phases = ", ".join(f"{k} {v:.3f}s" for k, v in cold_timings.items())
    print(f"[12] keccak-air n=2^20 x {keccak_air.COLS} prove_wide (Poseidon2, zk=False, blowup 2, "
          f"100 queries, 16 PoW bits): trace generation {k_trace_s:.3f}s ({k_trace.numel() / 2**30:.3f} GiB "
          f"uint8 on the device); cold {k_cold:.3f}s ({cold_phases}), warm {k_warm:.3f}s ({phases}); "
          f"verify {k_verify_s:.3f}s ok; proof {len(blob)} B; launches {k_launches}; peak device memory "
          f"{k_peak / 2**30:.3f} GiB (trace included); on {smi}", flush=True)

    del k_trace, proof, blob

    # -- 14. K5 vs plain, the narrow route vs K2 --------------------------------
    print(_phase14_mxu(torch, port, rand_monty, results), flush=True)

    # -- 15. device rng vs JAX, the grind kernel vs plain ------------------------
    print(_phase15_rng_grind(torch, port, dev, results), flush=True)

    # -- 16. BASELINE config 2 ----------------------------------------------------
    line, c2_launches = _phase16_config2(torch, port, dev, seen, 20)
    print(line, flush=True)

    # -- 13. every kernel vs plain at every shape of the five main paths --------
    path_launches = {"fib": fib_launches, "chain": chain_launches, "keccak-air": k_launches, **c2_launches}
    for path, launches in path_launches.items():
        noted = {name for key, paths in seen.items() if path in paths for name in _SHAPE_KERNELS[key[0]]}
        missing = [name for name, n in launches.items() if n > 0 and name not in noted]
        if missing:
            raise AssertionError(f"{path}: no operand shapes noted for the launched kernels {missing}")
    t0 = time.perf_counter()
    checked = _check_shapes(torch, port, seen, rand_u32, rand_monty)
    shape_err = {}
    for call, (_count, err) in checked.items():
        for name in _SHAPE_KERNELS[call]:
            shape_err[name] = max(shape_err.get(name, 0), err)
    dft_shapes = ", ".join(
        f"({k[1]}, {k[2]}){' inv' if k[3] else ''}" for k in sorted(seen) if k[0] == "dft" and "keccak-air" in seen[k])
    mxu_shapes = ", ".join(
        f"({k[1]}, {k[2]})" for k in sorted(seen) if k[0] == "mod_matmul_axis" and "config2-mxu" in seen[k])
    print(f"[13] every kernel == plain (exact) at the {len(seen)} operand shapes of the warm proves "
          f"({', '.join(f'{call} {c}' for call, (c, _e) in sorted(checked.items()))}) in "
          f"{time.perf_counter() - t0:.1f}s; keccak-air's transforms: {dft_shapes}; config 2's K5 "
          f"products: {mxu_shapes}", flush=True)

    kernel_rows = []
    for info in kernels.ALL:
        err, ms, plain_ms, bound_ms, bound_by, *more = results[info.name]
        err = max(err, shape_err.get(info.name, 0))
        kernel_rows.append({
            "name": info.name, "route": "cuda", "source": info.source, "replaces": info.replaces,
            "launches": sum(launches[info.name] for launches in path_launches.values()),
            "max_abs_err": err, "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
            "bound_ms": round(bound_ms, 6), "bound_by": bound_by, "library_ms": None,
            **(more[0] if more else {}),
        })
    print(_smi_line(), flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
