#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``tpu_stark_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and a CUDA build of PyTorch.  Imports nothing of JAX.  Phases, one
line each, any failure an uncaught exception and a nonzero exit:

1. device name, ``nvidia-smi`` name and power limit; build the kernels of
   ``tpu_stark_torch/csrc`` with nvcc (and the C host helper), and beside
   them K7's libraries, one a constraint DAG of fib, the chain and
   keccak-air (``air/quotient_kernel.py``: 10 sources generated from the
   AIRs, each compiled by its own nvcc), with each one's compile seconds
   and ptxas registers;
2. K1 (Keccak sponge) against its plain torch version, exact, at leaf
   shapes (2^20, 6), (2^20, 8), (1000, 40) and 2^20 compress pairs; then
   its tree kernel (``compress_levels``, every compress layer of a tree in
   a few launches) against the plain layer loop at the fib prove's tree
   heights, 2^1 to 2^23 digests, the tree over 2^23 timed;
3. K2 (NTT passes) against the plain passes, exact: dft/idft at (2^20, 2),
   (2^21, 8), (2^23, 2), (16384, 128) and a coset LDE at (2^20, 2); then at
   the main paths' shapes (2^21, 128), (2^20, 128) inverse, (2^18, 257) and
   (2^23, 2) each pass alone and the whole ``dft``, exact and timed against
   plain, the per-pass bound and the whole transform's HBM bound (one read
   and one write of the matrix), its int32 bound beside it (L2 flushed
   before each launch where the matrix would fit in it);
24. (run after 3) K7 against its plain version, exact, and timed beside
    its bound: one keccak-air partition of each of its 8 DAGs at config
    4's panel (2^20 rows a coset cut into ``block_count``'s blocks: a
    block's rows, the next block's as next rows, the last block's strided
    selectors and accumulator rows, added in place), the dense pass of
    config 2 at 2^20 (2^21 x 2, step 2, times 1/Z_H) and of the chain (2^19
    x 493); K8 against its plain version, exact, and timed beside its bound
    (queued behind a spin of the device) at config 4's and cell 6's panel
    folds of a whole coset ((2^20, 768),
    (2^21, 768), (2^20, 257) coefficients into 4 blocks, (2^21, 24) into
    one);
25. (run after 24) K9, K10 and K11 (``commit/open_kernel.py``, the open
    phase's reduced opening, out-of-domain evaluation and FRI fold) against
    their plain versions, exact, and timed beside their bounds (launches
    queued behind a spin of the device): K9 and K10 at ``OPEN_ROWS``, config
    2 at 2^24's 2^26 x 2 trace codeword at a point and at two points in one
    read, the chain's 2^20 x 493 group (one and two points), a rank block
    (2^24 rows from row0 2^24 of 2^26), cell 6's (2^22, 64) streamed chunk
    in natural order without a point and the one division of its (2^22, 4)
    ext sum (one and two points); K10 at (2^25, 2), (2^21, 64), (2^18, 493)
    and a rank block (2^23 rows from r0 2^23) at two points; K11 at the
    2^26-row top fold, the 2^25-row fold with the next height's add and a
    rank block;
4. fib_air zk n = 8 proofs, both layouts, byte-equal to the golden files;
5. n = 2^14 proofs, both layouts, with the SHA-256 and length the JAX
   package produced (tests/golden/torch_fib_zk_jax_proofs.json);
6. an n = 2^20 fib_air zk prove on the Keccak stack (launch counts reset
   just before it, read just after), verified by the port's verifier, with
   cold/warm wall clock, phase times and peak device memory;
7. K3 (Poseidon2 sponge) against its plain torch version, exact, at leaf
   shapes (2^16, 493), (2^20, 8), (1000, 13), (4097, 12), (4097, 128) on a
   misaligned base and (4097, 127) through a column slice, 2^20 compress
   pairs and 4097 with one side misaligned;
8. Poseidon2-stack proofs equal to the JAX package's
   (tests/golden/torch_poseidon2_jax_proofs.json): fib_air zk n = 8 in both
   layouts byte for byte, fib_air non-zk n = 2^10 and the Poseidon2 chain at
   n = 8 and 2^6 by SHA-256 and length; each verifies;
9. the Poseidon2 chain at n = 2^18 x 493 columns (BASELINE config 3):
   trace generation timed on its own, a cold and a warm prove (launch counts
   reset just before the warm one, read just after), phase times, peak
   device memory, the quotient pass's own peak, and the port's verifier;
   the proof's length must equal the JAX package's (JAX_PROOF_BYTES);
10. K4 (Poseidon2 carry-state absorb) against its plain torch version,
    exact: (2^16, 493) in chunks of 128, 128, 128 and 109 columns (also
    against one-shot K3), (4097, 148) in chunks of 64, 64 and 20 with the
    matrix and the state off 16-byte boundaries, and (2^21, 128) on a
    carried random state, timed;
11. keccak-air proofs of the streamed wide prover equal to the JAX
    package's (tests/golden/torch_keccak_air_jax_proofs.json: SHA-256 and
    length at 64 and 128 rows); each verifies;
12. keccak-air at 2^20 x 3608 through ``prove_wide`` (BASELINE config 4:
    Poseidon2 stack, zk off, blowup 2, 100 queries, 16 PoW bits): trace
    generation timed on its own, a cold and a warm prove (launch counts
    reset just before the warm one, read just after), phase times, peak
    device memory, and the port's verifier, timed; the proof's length must
    equal the JAX package's (JAX_PROOF_BYTES); its SHA-256 is kept for
    phase 22 (d);
14. K5 (the limb-matmul DFT on the integer tensor cores) against its plain
    version, exact, at (256, 65536), (128, 131072) and ragged widths for
    n = 64, 32, 16, each timed; then every level (B, A, R) of config 2's
    narrow-route transforms (CONFIG2_TRANSFORMS; an inner level through
    ``mod_matmul_twiddle_moved``, the product, twiddle and moved axis in one
    launch), exact against its plain version and timed beside its bound,
    with a prove's launches summed; then the narrow NTT route
    (``narrow_ntt="mxu"``) against K2 at (2^16, 2), (2^21, 2), (2^22, 4),
    (2^23, 2) and (2^20, 32), forward and inverse, each timed beside K2;
15. the device zk rng (K6, ``csrc/threefry.cu``: one launch a sample)
    against JAX's samples (tests/golden/torch_device_rng_jax.json: seeds 1
    and 7, every stream tag, counters 0-2, up to (2^21, 4)), each sample
    one K6 launch; K6 against the plain Threefry, exact, at whole samples,
    columns with repeats, rows from row0 past flat index 2^32 and gathered
    rows (``RNG_CHECKS``); K6 at cell 6's randomizer chunk (2^20, 64) and
    at (2^21, 4) and (2^22, 4) timed beside the plain version and its bound; the grind kernel against
    its plain version and the host check at 8-16 bits (2^17 candidates
    timed beside its bound and its ALU model), against its plain version
    with the witness across two lanes and across the tail's two blocks at
    1000 and 2^17 + 77 candidates, and ``device_grind`` against the
    witnesses JAX's stored;
16. BASELINE config 2 (fib_air zk at the defaults: device zk rng, blowup 2,
    100 queries, 16 PoW bits): proofs equal to the JAX package's
    (tests/golden/torch_fib_zk_device_jax_proofs.json: n = 8 byte for byte,
    2^10 and 2^12 by SHA-256 and length) on both NTT routes, then n = 2^20
    with ``narrow_ntt="mxu"``: a cold and a warm prove (launch counts reset
    just before the warm one, read just after), phase times, peak device
    memory, the port's verifier, and the same warm prove with
    ``narrow_ntt=None`` (its own launch counts), whose bytes must be equal,
    and whose length must equal the JAX package's (JAX_PROOF_BYTES);
17. the application surface: ``python -m tpu_stark_torch.app --backend
    cuda fib bench`` in-process (launch counts reset just before it, read
    just after): ``cuda available: True``, the contract string ``fib_air
    zk ok (n=8, x=21)``, the policy line naming the card, and the DFT
    harness's 11 cases in its three CUDA tiers, each checked exactly against
    its CPU tier; then the prove twins (``tpu_stark_torch.bench.prove``) of
    config 2 at 2^12 (``fib 12 keccak zk 1 bench``), the chain at 2^6 and
    keccak-air at 128 rows and on the reference's stack (``keccak-air 6
    test 1 keccak zk``) at 64 rows, each driven alone, each proof as long as
    the JAX package's proof of its configuration in the golden fixtures
    (``TWINS``);
18. K1's carried-state absorb (``keccak_kernel.absorb_rows`` /
    ``finalize_rows``) against its plain version, exact: 30 pending words
    (word-major, as the kernel writes them back) and a (2^22, 64) chunk on
    a carried random state in its three operand forms (Montgomery forms in
    natural or the tree's row order, canonical words in the tree's order;
    canonical words in natural order refused), the state and the 26
    words written back compared (the natural Montgomery chunk, cell 6's
    commit step, timed beside its bound and the ALU pipe's model), the
    finalize of 26 pending and 4 Montgomery salt words, 33 pending words, a
    state and chunk off 16-byte boundaries, and ``KeccakRowStream`` over
    odd-width canonical chunks and over natural Montgomery chunks against
    one-shot K1;
19. the zk wide fixture (tests/golden/torch_keccak_air_wide_zk_jax_proofs.
    json: keccak-air at 64 rows, zk, the Keccak stack in 4 column chunks
    and the Poseidon2 stack in one) by SHA-256 and length; each verifies;
20. keccak-air at 2^20 x 3608 through ``prove_wide`` on the reference's
    stack (``create_config()``'s Keccak trees and zk with the device rng,
    benchmark FRI; 2^21 committed rows, 2^22 LDE rows, 57 chunks, 8
    quotient chunks): trace generation timed on its own, one cold prove
    only (launch counts reset just before it, read just after; the warm
    numbers come from its twin, ``python -m tpu_stark_torch.bench.prove
    keccak-air 20 bench 1 keccak zk``), phase times, peak device memory and
    the port's verifier; no JAX log of this configuration exists, so the
    proof is held to the SHA-256 of the tree before K6
    (``KECCAK_AIR_ZK_SHA256``, the plain Threefry's bytes);
21. BASELINE config 2 in low-memory mode (lazy salts drawn row by row, 3
    dropped leaf layers rebuilt per query block, codewords released and
    recomputed): at n = 2^24, on one generated trace, one prove with
    ``lowmem_log=0`` and one with ``lowmem_log=24`` (the JAX package's
    threshold; launch counts reset just before it, read just after; the
    codewords' recomputes counted), each with its wall clock, phases and
    peak device memory (reset before, read after); equal SHA-256, the JAX
    package's length (JAX_PROOF_BYTES), verified; then n = 2^25 (a
    2^27-row LDE, BabyBear's two-adic limit) at ``create_config()``'s
    default, the card's threshold (2^27 on an 80 GB card), which must
    release codewords there, verified, its length the port's own; 1024
    rows of a 2^26 x 4 lazy salt draw drawn alone against the whole draw's
    gather, timed and equal; and the phase's own wall clock; the warm
    numbers come from the twins (``python -m tpu_stark_torch.bench.prove
    fib 24 keccak zk 1 bench --lowmem-log 0|24``);
22. the sharded prover (``tpu_stark_torch/dist``) through
    ``dist/dryrun.py``'s runner, one process a rank: (a) config 2 at 2^20
    over an NCCL group of min(cards, 4) ranks, (b) BASELINE config 5, fib
    zk at 2^24 with config 2's benchmark FRI, over four gloo ranks on
    cuda:0 (host-staged), each equal on every rank to phase 16's and phase
    21's single-device SHA-256 and verified, with every rank's wall clock,
    peak device memory, bytes sent and seconds spent by collective, staged
    bytes, K1/K2 launches and transport; (c) the dry run
    (``dryrun_multichip(4, device="cuda", backend="gloo")``'s checks, the
    wide prove of keccak-air cut to four partitions included, each rank
    through a worker that counts its launches, K3 and K4 included); (d)
    BASELINE config 4 (keccak-air 2^20 x 3608 through ``prove_wide``,
    Poseidon2, zk off, benchmark FRI) over the NCCL group of (a), equal to
    phase 12's SHA-256 and the JAX package's length, verified, K2, K3 and
    K4 launched; (e) keccak-air at 2^16 x 3608 on the reference's stack
    (Keccak trees, zk, the device rng, benchmark FRI) over four gloo ranks
    on cuda:0, every rank's bytes equal to rank 0's single-device proof,
    verified, K1's absorb and K2 launched (``dist.dryrun.
    prove_keccak_air``; every rank's wall clock, peak, bytes sent and
    staged, and launches printed); the ranks load the library phase 1
    built and return their kernels' operand shapes for phase 13;
23. the speed-of-light report (``tpu_stark_torch.bench.sol.run()`` at full
    size; launch counts reset just before it, read just after, its operand
    shapes noted): the card's mul, alu and stream roofs measured by the
    probe kernels of ``csrc/sol_probes.cu`` (each > 0, the stream at most
    the data sheet's 3.35 TB/s, each probe launched), the 9 kernels of the
    JAX package's list each scored in (0, 100] on its binding roof or
    flagged, and its compact block as ``bench.ntt`` prints it; each probe
    against its plain twin, exact, timed beside its bound (the stream
    beside ``torch.add``); then ``bench.hash``'s two lines (K1, K3) and
    ``bench.narrow_ntt``'s seven shapes, its k2 and mxu routes
    bit-identical, each twin a main path of its own (launch counts reset
    just before it, read just after, its operand shapes noted); and K7
    scored the same way at one keccak-air partition of each DAG over 2^20
    rows (``sol.run_quotient_partitions``, in the report's path) and K11 at
    2^22 rows (``sol.run_open``; the report's own ``fri_fold_2^22`` is K11
    too; K9 is held to its own bound in phase 25, not to an audit of its
    plain twin's per-row inverse);
13. (run last) every kernel against its plain version, exact, at every
    operand shape the five warm proves (phases 6, 9, 12 and the two of 16),
    phase 17's runs, phase 20's prove, phase 21's 2^24 prove with the levers,
    the ranks of phase 22 (a) to (e), phase 23's report and its two twins
    (the query blocks' leaf and compress layers, the recomputed
    transforms) called its wrapper with (the plain versions on slices of
    at most 2^22 rows or 2^26 elements), printing the shapes only phase 21
    gave: K2's
    transforms by height, width and direction
    (the wide prover's (2^21, 128) chunk LDEs, (2^20, 128) iNTTs and
    quotient panels such as (2^18, 257)), K1's and K3's leaf and compress
    layers and K4's chunks by rows, widths, row strides and 16-byte
    alignment, K1's tree runs by height, levels and alignment, K1's absorb
    and finalize by rows, the new words' width, row stride and alignment,
    the pending words' width, row and column strides and alignment, and the
    operand flags (Montgomery forms, natural row order; phase 20's,
    printed), K5's leaf
    products by n and width (both directions' tables) and its inner levels
    by n, A, R and direction (config 2's set must be phase 14's), the
    grind's chunks by count, tail blocks, witness offset and bits, and K6's
    samples by rows, columns, selected columns, row0 or row indices and
    whether a flat index passes 2^32 (checked past it), K7's calls by DAG,
    rows, operand widths and strides, next rows and shift, selector and
    accumulator strides, ``add`` and ``invz`` (the plain version over row
    slices of 2^22), K8's by operand shape, block size and blocks, K9's by rows,
    height, row0, row order, point, ext sum and each operand's width and
    row stride, K10's by rows, width, row stride, points, r0 and output,
    K11's by rows, height, row0 and add (their plain versions over row
    slices of 2^22), on random inputs of those shapes.  Every path that
    proves must have launched K7, K9, K10 and K11, and no path may have
    called a plain quotient or open version.

Then the nvidia-smi line, a JSON line of per-kernel results (launches
summed over the main paths, and by path in ``launches_by_path``: the five
warm proves, phase 17's five runs, phase 20's prove, phase 21's 2^24 prove
with the levers, every rank of phase 22 (a) to (e) and phase 23's report
and twins,
each under its path name: config2-nccl, config5-sharded, dryrun,
config4-nccl, keccak-air-zk-sharded, sol, bench-hash and
bench-narrow-ntt; the three SoL probes join it,
each against its twin at phase 23's shapes; time, plain time and the bound of each kernel at the shape it was timed; the largest error of phases 2-21), and
last ``{"ok": true, "device": {...}}``.  Exits nonzero without a result when
CUDA is unavailable or the package is missing.

The bound of a kernel is the least time the H100 could take for its work:
the larger of the bytes it must move (each input read once, each output
written once) over 3.35 TB/s and its int32 instructions over the issue
rate, 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz = 33.45 T/s (one warp
instruction per scheduler per clock, the most any integer mix can reach;
1.98 GHz is the clock of the data sheet's 67 TFLOP/s fp32), and for K5
also its 16 * 2 * n^2 * M int8 tensor operations over the data sheet's
dense int8 peak, 1,979 TOPS; a K5 level's bytes count x read and the
result written once, the limb table and, at an inner level, the (A, B)
twiddle table read once (``k5_bound``).  A tree of compress layers (K1's tree kernel)
reads its input layer once and writes one digest a node, one permutation
each; K1's absorb reads and writes its 200-byte state a row (the digest
instead of the state in a finalize), reads each word once and writes the
words after its last whole block once, one permutation a rate block and,
for a Montgomery chunk, one reduction a word, 2 instructions
(``keccak_absorb_bound``); the grind reads its constants once and writes
a byte a candidate, its last round 58 instructions (lanes 0-3 only:
``grind_bound``).  Instruction counts are lower bounds read off
the sources: a Montgomery product 5 (three multiplies, a subtract, a
select), a modular add 2, an NTT butterfly 9 (4 in a transform's stage 0,
whose twiddles are all 1), a Keccak round 180 (LOP3-fused xors, two funnel
shifts per 64-bit rotation), K5's epilogue 17 per output (the 7-diagonal
recombine in five wide multiply-adds and a 64-bit add, two Montgomery
steps, a conditional subtract) and at an inner level a Montgomery product
more for the twiddle, and a K6 element 157 (two Threefry-2x32 of 20
rounds of an add, a funnel shift and an xor, 12 key injections and the
output xor each, two conditional subtracts, a Montgomery product and a
modular add), whose only bytes are its 4-byte output (``threefry_bound``).

A Poseidon2 permutation (K3, K4) counts the least int32 work of
csrc/poseidon2_sponge.cu's arithmetic, 5,892 instructions: a lazy
Montgomery product 4 (IMAD.WIDE, IMAD, IMAD.HI, IADD3), a reduction
min(x, x - P) 1 (VIADDMNMX), a modular add or subtract 2, so an S-box 18
(four products, two reductions), an external round 16 x (2 + 18) + 168
(M_E: 84 adds) = 488, an internal round 2 + 18 + 30 (the lane sum) + 90
(the diagonal by shifts and adds: lanes 2, 2, 4, 5, 6, 6, 5, 6, 6, 6, 7,
7, 6, 7, 7, 7, and sum + P once) = 140, and 168 + 8 x 488 + 13 x 140.
The parent commit's arithmetic (772 full products, 1,300 adds) needs more;
both are held to this count.  K3's and K4's per-pipe bound (the SASS
instructions of a permutation on each integer pipe over the rate the card
reaches there) is ``port_timing.py sass``'s, not this script's.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")


# The JAX package's proof lengths at the benchmark heights, from its own
# benchmark runs, each of the same configuration as the phase that gates on
# it: the chain at 2^18 x 493 (``bench_poseidon2_chain.py``:
# ``create_config(zk=False, hash="poseidon2")``, test FRI parameters, the
# trace of ``generate_trace(2^18, range(16))``), keccak-air at 2^20 x 3608
# (``bench_keccak_air.py 20 bench``: benchmark FRI parameters, zk off,
# Poseidon2, ``generate_trace(2^20 // 24, seed=1)[:2^20]``) and config 2 at
# 2^20 and 2^24 (``bench_prove.py 20 keccak zk 2 bench``, ``... 24 ...``:
# benchmark FRI parameters, zk, Keccak, the defaults rng_seed 1, zk_rng
# "device", zk_layout "tpu", fib(0, 1)).  A serialized proof's length depends on its structure only
# (fixed-width words), so equal lengths check the structure, not the bytes.
JAX_PROOF_BYTES = {
    "chain 2^18": (54292, "_r4_logs/p2chain_2p18.log:108"),
    "keccak-air 2^20": (3381676, "_r5_logs/keccak_air_2p20_r5b.log:143"),
    "config 2 2^20": (1188316, "_r5_logs/prove_2p20_r5.log:178"),
    "config 2 2^24": (1589260, "_r5_logs/prove_2p24_r5.log:157"),
}


# SHA-256 of the single-device proofs that phase 22's sharded proofs must
# equal: config 2 at 2^20 (phase 16) and at 2^24 (phase 21), keccak-air at
# 2^20 (phase 12)
SINGLE_DEVICE_SHA256 = {}

# SHA-256 of phase 20's proof (keccak-air 2^20 x 3608, Keccak, zk, device
# rng, benchmark FRI; no JAX log of this configuration) from the tree before
# K6 (commit 4ca5582, the plain Threefry on the card; ``port_timing.py
# profile --workload keccak-zk --tree`` of its checkout): K6 must give the
# same bytes
KECCAK_AIR_ZK_SHA256 = "55c2653a2da3418468255f595436f8ea8c7fd6ac2aa668e420f1f17e061a129e"


def _check_jax_length(label: str, blob: bytes) -> str:
    want, where = JAX_PROOF_BYTES[label]
    if len(blob) != want:
        raise AssertionError(f"{label}: the proof has {len(blob)} B, the JAX package's {want} B ({where})")
    return f"{len(blob)} B (= the JAX package's, {where})"


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(torch, fn, reps: int, queued: bool = False) -> float:
    """Mean device time of fn over reps launches (CUDA events, warmed up).
    ``queued``: the launches wait behind a spin of the device
    (``torch.cuda._sleep``), so that the events time the kernels and not
    the host's issue of them (a wrapper's Python can take longer than a
    short kernel)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)  # ~10 ms of SM clocks: more than the host takes to queue the launches
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
# csrc/poseidon2_sponge.cu, per permutation (see the module docstring)
POSEIDON2_PERM_OPS = 168 + 8 * 488 + 13 * 140
NTT_BUTTERFLY_OPS = 9  # Montgomery product 5, add 2, subtract 2
NTT_STAGE0_OPS = 4  # a transform's stage 0: every twiddle is 1, no product


def _ntt_ops(n: int, stages: int, first: bool) -> int:
    """int32 instructions of ``stages`` butterfly stages over n elements
    (``first``: they include the transform's stage 0)."""
    return n // 2 * (stages * NTT_BUTTERFLY_OPS - first * (NTT_BUTTERFLY_OPS - NTT_STAGE0_OPS))


INT8_TENSOR_OPS_PER_S = 1.979e15
MXU_EPILOGUE_OPS = 17  # per output of K5 (see the module docstring)
MONTY_MUL_OPS = 5
# K6 (csrc/threefry.cu), an element: two Threefry-2x32 of 20 rounds (an add,
# a funnel shift and an xor each), 12 key injections and the output xor,
# then two conditional subtracts (2 each), a Montgomery product and a
# modular add
THREEFRY_MONTY_OPS = 2 * (20 * 3 + 12 + 1) + 2 * 2 + MONTY_MUL_OPS + 2


def threefry_bound(elems: int):
    """K6's bound for a sample of ``elems`` elements: each written once
    (4 bytes), THREEFRY_MONTY_OPS int32 instructions each."""
    return _bound(4 * elems, elems * THREEFRY_MONTY_OPS)


def _bound(n_bytes: float, n_ops: float, n_tensor_ops: float = 0.0):
    """(bound_ms, bound_by): the largest of the bytes, the int32
    instructions and the int8 tensor operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_ops / INT32_OPS_PER_S, n_tensor_ops / INT8_TENSOR_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k5_bound(b: int, a: int, r: int):
    """The bound of one level of the limb-matmul DFT on x viewed as (B, A,
    R): x read and the result written once, the (4, B, B) limb table and,
    for an inner level (A > 1), the (A, B) twiddle table read once; the
    epilogue's int32 instructions (and the twiddle's Montgomery product);
    16 limb products of 2 B^2 A R int8 operations."""
    m = a * r
    n_bytes = 8 * b * m + 4 * b * b + (4 * a * b if a > 1 else 0)
    n_ops = b * m * (MXU_EPILOGUE_OPS + (MONTY_MUL_OPS if a > 1 else 0))
    return _bound(n_bytes, n_ops, 32 * b * b * m)


def k5_levels(h: int, w: int):
    """The levels of ``mxu_ntt.dft_axis0`` on an (h, w) matrix, outermost
    first: (B, A, R) with x viewed as (B, A, R), B the DFT size; the leaf
    has A = 1 (R = h * w / B)."""
    out, n, r = [], h, w
    while n > 256:
        b = 1 << min((n.bit_length() - 1) // 2, 8)
        out.append((b, n // b, r))
        n, r = n // b, r * b
    out.append((n, 1, r))
    return out


# K7 (the quotient pass's generated kernels): a multiply of the DAG a
# Montgomery product, an add, subtract or negation a modular add, and a fold
# four 64-bit multiply-adds of raw products (2 each) and a quarter of the
# four settles that follow every fourth fold (2 each); its bytes the
# columns it reads of the two panels (of one panel, each word once, where
# the next rows are the current panel's: ``one_panel``), its selectors (and
# inv_zeroifier with invz) and the 16-byte accumulator row written (and
# read with add)
MOD_ADD_OPS = 2
QUOTIENT_FOLD_OPS = 4 * 2 + 2


def same_panel(cur, nxt) -> bool:
    """Whether K7's next rows come from its current panel (the dense pass)."""
    return cur.data_ptr() == nxt.data_ptr() and cur.stride(0) == nxt.stride(0)


def quotient_eval_bound(dag, rows: int, add: bool, invz: bool, one_panel: bool = False):
    (lo0, hi0), (lo1, hi1) = dag.span(0), dag.span(1)
    if one_panel and hi0 > lo0 and hi1 > lo1 and lo1 <= hi0 and lo0 <= hi1:
        panel_words = max(hi0, hi1) - min(lo0, lo1)  # the two spans overlap: their union
    else:
        panel_words = (hi0 - lo0) + (hi1 - lo1)
    used = {n[1] for n in dag.nodes if n[0] == "sel"}
    n_bytes = 4 * rows * (panel_words + len(used) + int(invz)) + 16 * rows * (1 + int(add))
    node_ops = sum(MONTY_MUL_OPS if n[0] == "mul" else MOD_ADD_OPS for n in dag.nodes
                   if n[0] in ("add", "sub", "mul", "neg"))
    return _bound(n_bytes, rows * (node_ops + QUOTIENT_FOLD_OPS * len(dag.roots)))


# K8's timed cosets (phase 24, ``port_timing.py k8``): (label, coefficients
# in trace heights (2: zk), columns, row blocks at 2^20 rows)
K8_COSETS = (("config 4 apdef", 1, 768, 4), ("cell 6 apdef", 2, 768, 4), ("config 4 trans", 1, 257, 4),
             ("cell 6 flags", 2, 24, 1))


def panel_fold_bound(n: int, u: int, m: int, r: int):
    """K8 on one quotient coset: (n, u) coefficients folded into r blocks of
    m rows, whatever kernel does it (one launch a coset, or one a block):
    each coefficient read once, each output written once; a row and column
    the npan - 1 scales by S^(m q) (products) and npan - r joins (modular
    adds) of the fold, the r-point DFT's (r/2) log2 r butterflies (an add
    and a subtract each, a product where the twiddle is not 1), r products
    for the scale by (S g^k)^i; and r products a row for the next row's
    scales."""
    npan, log_r = n // m, r.bit_length() - 1
    dft_mul = r // 2 * log_r - (r - 1)
    per = MONTY_MUL_OPS * (npan - 1 + dft_mul + r) + MOD_ADD_OPS * (npan - r + r * log_r)
    return _bound(4 * (n + r * m) * u, m * u * per + m * r * MONTY_MUL_OPS)


# K9-K11 (csrc/open.cu on csrc/ext4.cuh), instruction counts read off the
# sources: an ext add or subtract 4 modular adds, an ext product by a base
# element 4 Montgomery products, an ext product (Karatsuba) 12 Montgomery
# products (3 by W) and 27 modular adds, the base inverse's square-and-
# multiply over P - 2 (31 squarings, 30 products), an ext inverse by the
# norm 8 Frobenius products (3 conjugates of 3, 2 and 3 twists other than
# 1), 3 ext products, the base inverse and 4 products
EXT_ADD_OPS = 4 * MOD_ADD_OPS
EXT_MUL_BASE_OPS = 4 * MONTY_MUL_OPS
EXT_MUL_OPS = 12 * MONTY_MUL_OPS + 27 * MOD_ADD_OPS
BASE_INV_OPS = 61 * MONTY_MUL_OPS
EXT_INV_OPS = 8 * MONTY_MUL_OPS + 3 * EXT_MUL_OPS + BASE_INV_OPS + 4 * MONTY_MUL_OPS
# K9's dividing row (a thread's R rows share one power and one inverse), the
# work the function needs, not the kernel's recomputation: y (one product)
# and y - z (one modular add: z's other coordinates are the same every
# row), the running product, the back-substitution's two products, the
# subtract of s, the quotient's product and the add
K9_POINT_ROW_OPS = MONTY_MUL_OPS + MOD_ADD_OPS + 4 * EXT_MUL_OPS + 2 * EXT_ADD_OPS
K9_ELEMENT_OPS = EXT_MUL_BASE_OPS + EXT_ADD_OPS
# K11's output: the half sum and half difference (an add and a base product
# each), 1/(2y)'s product, beta's ext product and the add (two with ``add``)
K11_OUTPUT_OPS = 2 * (EXT_ADD_OPS + EXT_MUL_BASE_OPS) + MONTY_MUL_OPS + EXT_MUL_OPS + EXT_ADD_OPS


# PR 20's recount, the least work the functions need (csrc/open.cu since
# PR 20): a raw 64-bit product-add (IMAD.WIDE) 2 instructions; a sum of raw
# products settled (2) and reduced (5) once, LAZY_SUM_OPS; an element 4
# product-adds and a quarter of the settle of 4 sums every four terms, 10 a
# plane; a row's plane settled and reduced, LAZY_REDUCE_OPS.  K9's division
# in the base field, a point and row (K9_DIVIDE_OPS): chi_z(y) 4
# product-adds and one reduction; q_z(y) 2 product-adds a coefficient and
# one reduction each, y^3's modular add; the batch inverse's 3 products;
# q_z(y) chi_z(y)^-1 4 products; W times three of its coefficients 3
# products; C - s; (C - s) times it 16 product-adds and the settle of 4
# sums.  A point whose sum is scaled (a lone matrix's second point: the
# scale is folded into its q_z) adds q_z's leading coefficient, 4
# product-adds.  A dividing row (K9_DIVIDE_ROW_OPS): y one product, y^2 and
# y^3 two, the points' summed products reduced once, the accumulator's add;
# the base inverse by its addition chain (41 products) once for a thread's
# run of 16 values.
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


def reduced_opening_bound(rows: int, log_h: int, row0: int, widths, npts: int, ext_in: bool, nsum: int = 1,
                          scaled: int = 0):
    """K9's bound over ``npts`` points in one read: each operand word read
    once for all the points, the accumulator rows read and written (a plane
    a sum with no point), the ext sums read; operations the lesser of two
    counts.  PR 19's: a launch a point, every element's product and add
    fully reduced, per dividing row the ext batch inverse's work, per thread
    of R rows its power of g and one ext inverse.  PR 20's, the least work
    the function needs: ``nsum`` planes of raw 64-bit sums, the division in
    the base field, ``scaled`` points whose sum is the first's scaled."""
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
    return _bound(n_bytes, min(old, new))


def eval_at_points_bound(h: int, w: int, npts: int):
    """K10's bound: each coefficient read once and the (npts, w, 4) result
    written; operations the lesser of PR 19's count (per point an element's
    product and add and a row's step of z's power, one ext product a row)
    and PR 20's least work (per point an element's raw 64-bit products
    settled every four terms, a column's reduction and its one ext product
    by a power of z)."""
    old = npts * (h * w * K9_ELEMENT_OPS + h * EXT_MUL_OPS)
    new = npts * (h * w * LAZY_ELEMENT_OPS + w * (LAZY_REDUCE_OPS + EXT_MUL_OPS))
    return _bound(4 * h * w + 16 * npts * w, min(old, new))


def fri_fold_bound(n: int, add: bool):
    """K11's bound: the n rows read, n / 2 written (and read with ``add``)."""
    half = n // 2
    return _bound(16 * n + 16 * half * (2 if add else 1), half * (K11_OUTPUT_OPS + (EXT_ADD_OPS if add else 0)))


# phase 14's K5 leaves (n, M) and narrow-route transforms (h, w)
K5_TIMED = ((256, 65536), (128, 131072), (64, 262147), (32, 524269), (16, 1048573))
ROUTE_TIMED = ((1 << 16, 2), (1 << 21, 2), (1 << 22, 4), (1 << 23, 2), (1 << 20, 32))


# config 2's narrow-route transforms at 2^20 (h, w, inverse), one call each a
# prove, as ``port_timing.py k5`` records them from a prove (phase 13 holds
# the noted level shapes of phase 16's warm prove to these)
CONFIG2_TRANSFORMS = ((1 << 20, 2, True), (1 << 20, 8, True), (1 << 21, 2, False), (1 << 21, 2, True),
                      (1 << 21, 4, False), (1 << 21, 4, True), (1 << 21, 8, False), (1 << 22, 2, False),
                      (1 << 22, 4, False))


def config2_levels():
    """{(B, A, R, inverse): launches a prove} of CONFIG2_TRANSFORMS."""
    out = {}
    for h, w, inverse in CONFIG2_TRANSFORMS:
        for b, a, r in k5_levels(h, w):
            out[(b, a, r, inverse)] = out.get((b, a, r, inverse), 0) + 1
    return out


def _tree_bound(n: int, levels: int):
    """The bound of the ``levels`` compress layers above n digests: n
    digests read, each output digest written, one permutation each."""
    out_rows = n - (n >> levels)
    return _bound(n * 32 + out_rows * 32, out_rows * KECCAK_F_OPS)


# K1's carried-state absorb: its per-pipe model counts keccak_rows_kernel's
# ALU-pipe SASS a round (185, all LOP3 and SHF, read off by port_timing.py sass)
# over the ALU pipe's nominal rate, half an SM's issue rate (port_timing.py
# probe reaches it for LOP3 + SHF): a model of the kernel's round, not a bound
KECCAK_ROUND_ALU_SASS = 185
ALU_PIPE_OPS_PER_S = 132 * 2 * 32 * 1.98e9


# a Montgomery form x to its canonical u32 (K1's absorb of a Monty chunk):
# hi32((1 - x P^-1) P), an IMAD and an IMAD.HI (csrc/keccak_sponge.cu's
# from_monty)
MONTY_REDUCE_OPS = 2


def keccak_absorb_bound(n: int, p: int, k: int, first: bool, fin: bool, monty: bool = False):
    """The bound of one absorb (``fin``: finalize) over n rows of p pending
    and k new words: each word read once (the new ones reduced from their
    Montgomery forms with ``monty``), the state read (unless ``first``) and
    written (the digest instead when ``fin``) where a block is absorbed, the
    words after the last whole block written (not ``fin``); one
    permutation a whole block (and the last partial one when ``fin``)."""
    words = p + k
    blocks = words // 34
    perms = blocks + (1 if fin and words % 34 else 0)
    state = fin or blocks > 0
    n_bytes = n * ((0 if first or not state else 200) + (32 if fin else 200 if blocks else 0) + 4 * words
                   + (0 if fin else 4 * (words % 34)))
    return _bound(n_bytes, n * (perms * KECCAK_F_OPS + (k * MONTY_REDUCE_OPS if monty else 0)))


def keccak_alu_model_ms(perms: int) -> float:
    return perms * 24 * KECCAK_ROUND_ALU_SASS / ALU_PIPE_OPS_PER_S * 1e3


# the last round of a grind candidate's permutation, whose draws read lanes
# 0-3 only: theta's column sums 20 and D's rotations 10, D applied to plane
# 0's five sources 10, their rotations 8, chi of 4 lanes 8, iota 2
KECCAK_DIGEST_ROUND_OPS = 58


def grind_bound(count: int, n_blocks: int):
    """The grind's bound: its constants read once, a byte out a candidate;
    n_blocks permutations a candidate, the last one's last round for lanes
    0-3 only."""
    rounds = (24 * n_blocks - 1) * KECCAK_F_OPS // 24 + KECCAK_DIGEST_ROUND_OPS
    return _bound(count + 8 * (25 + 17 * n_blocks), count * rounds)


def grind_alu_model_ms(count: int, n_blocks: int) -> float:
    """Its per-pipe model: the full rounds' ALU-pipe SASS and the last round's count."""
    return count * ((24 * n_blocks - 1) * KECCAK_ROUND_ALU_SASS + KECCAK_DIGEST_ROUND_OPS) / ALU_PIPE_OPS_PER_S * 1e3


def import_port():
    """Import the port's modules this script drives (and nothing of JAX)."""
    import types

    from tpu_stark_torch import kernels, matrix
    from tpu_stark_torch.air import keccak_air, poseidon2_air
    from tpu_stark_torch.air import quotient_kernel
    from tpu_stark_torch.app.__main__ import main as app_main
    from tpu_stark_torch.bench import harness, sol
    from tpu_stark_torch.bench import hash as bench_hash
    from tpu_stark_torch.bench import narrow_ntt as bench_narrow_ntt
    from tpu_stark_torch.bench import ntt as bench_ntt
    from tpu_stark_torch.bench import prove as bench_prove
    from tpu_stark_torch.challenger import grind
    from tpu_stark_torch.challenger.challenger import Challenger, HashChallenger
    from tpu_stark_torch.compat.device_rng import DeviceRng
    from tpu_stark_torch.air.air import get_symbolic_info
    from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
    from tpu_stark_torch.commit import lowmem, open_kernel, pcs
    from tpu_stark_torch.compat import device_rng, native
    from tpu_stark_torch.dist import dryrun
    from tpu_stark_torch.fields import babybear as bb
    from tpu_stark_torch.fields import extension as ext4
    from tpu_stark_torch.fri.config import create_benchmark_fri_params
    from tpu_stark_torch.hash import keccak_kernel, poseidon2_kernel, sponge
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
    "keccak_compress_levels": ("keccak_tree",),
    "keccak_absorb": ("keccak_absorb",),
    "keccak_finalize": ("keccak_absorb",),
    "poseidon2_hash_rows": ("poseidon2_sponge",),
    "poseidon2_compress": ("poseidon2_sponge",),
    "poseidon2_absorb": ("poseidon2_absorb",),
    "mod_matmul_axis": ("mxu_mm",),
    "mod_matmul_twiddle_moved": ("mxu_mm",),
    "grind_verdicts": ("keccak_grind",),
    "rng_sample": ("threefry_monty",),
    "quotient_eval": ("quotient_eval",),
    "panel_fold": ("panel_fold",),
    "reduced_opening": ("reduced_opening",),
    "eval_at_points": ("eval_at_points",),
    "fri_fold": ("fri_fold",),
}


def _rng_key(k, rows, cols, device, sel=None, row0=0, row_idx=None):
    """A K6 call's shape key (see ``_record_shapes``)."""
    import torch

    n = rows if row_idx is None else len(row_idx)
    n_sel = -1 if sel is None else len(sel)
    high = False
    if n > 0 and n_sel != 0:
        last_col = cols - 1 if sel is None else int(torch.as_tensor(sel).max())
        last_row = row0 + (n - 1 if row_idx is None else int(torch.as_tensor(row_idx).max()))
        high = last_row * cols + last_col >= 1 << 32
    return ("rng_sample", int(n), int(cols), n_sel, row0 != 0, row_idx is not None, high)


def _quotient_key(prog, cur, nxt, nshift, sels, sel_off, sel_stride, pis, alpha, acc, acc_off, acc_stride, add,
                  invz):
    """A K7 call's shape key (see ``_record_shapes``); None off the card
    (the SoL report audits the plain twin on ``meta`` through the wrapper)."""
    if not cur.is_cuda:
        return None
    return ("quotient_eval", prog.dag.key, int(cur.shape[0]), int(cur.shape[1]), int(cur.stride(0)),
            int(nxt.shape[0]), int(nxt.shape[1]), int(nxt.stride(0)), int(nshift), int(sel_stride),
            int(sels["is_first_row"].shape[0]), int(acc_stride), int(acc.shape[0]), bool(add), bool(invz),
            int(pis.shape[0]))


def _opening_key(acc, mats, apows, log_h, row0=0, points=(), natural=False, ext_in=None, scales=None):
    """A K9 call's shape key: rows, height, row0, natural order, points, ext
    sum, each operand's width and row stride, alpha planes (0: one table)
    and scaled points; None off the card."""
    if not acc.is_cuda:
        return None
    return ("reduced_opening", int(acc.shape[0]), int(log_h), int(row0), bool(natural), len(points),
            ext_in is not None, tuple((int(m.shape[1]), int(m.stride(0))) for m in mats),
            int(apows.shape[0]) if apows.dim() == 3 else 0, 0 if scales is None else len(scales))


def _points_key(coeffs, points, r0=0, out=None):
    """A K10 call's shape key: rows, width, row stride, points, r0 and the
    accumulated output's point stride (None: a new output)."""
    if not coeffs.is_cuda:
        return None
    return ("eval_at_points", int(coeffs.shape[0]), int(coeffs.shape[1]), int(coeffs.stride(0)), len(list(points)),
            int(r0), None if out is None else int(out.stride(0)))


def _fold_key(cw, beta, log_h, row0=0, add=None):
    """A K11 call's shape key: rows, height, row0 and the fused add."""
    if not cw.is_cuda:
        return None
    return ("fri_fold", int(cw.shape[0]), int(log_h), int(row0), add is not None)


@contextlib.contextmanager
def _record_shapes(port, seen: dict, path: str):
    """While open, note in ``seen`` (key -> the paths that gave it) the
    operands of every kernel wrapper call: K2's ``dft`` by height, width and
    direction; K1's and K3's ``hash_rows`` / ``compress`` and K4's
    ``absorb_rows`` by rows, and each operand's width, row stride and
    16-byte alignment; K1's ``compress_levels`` by rows, levels and
    alignment; K1's ``absorb_rows`` and ``finalize_rows`` by rows, each
    operand's width, row stride and alignment, ``first`` and the state's
    alignment; K5's
    ``mod_matmul_axis`` by n and width and ``mod_matmul_twiddle_moved`` by
    n, A, R and direction; the grind's ``verdicts`` by count,
    tail blocks, witness offset and bits; K6's samples (``device_rng.
    _monty_kernel``) by rows, columns, the number of ``sel`` columns (-1:
    all), whether ``row0`` and row indices are given, and whether a flat
    index reaches 2^32; K7's ``eval_fold`` by its DAG, rows, operand widths
    and row strides, next-row count and shift, selector and accumulator
    strides and lengths, ``add``, ``invz`` and the public values' count
    (``_quotient_key``); K8's ``panel_fold`` by its operand's shape, the
    blocks' size and their count; K9's ``reduced_opening``, K10's ``eval_at_points`` and
    K11's ``fri_fold`` by ``_opening_key``, ``_points_key`` and
    ``_fold_key``.  A call of either plain quotient version notes
    ``plain_quotient``, of a plain open version ``plain_open``, which no
    main path may give on the card."""
    nk, kk, pk = port.ntt_kernel, port.keccak_kernel, port.poseidon2_kernel

    def rows(t):  # width, row stride, and the base's offset in words past a 16-byte boundary
        return (0, 0, 0) if t is None else (int(t.shape[1]), int(t.stride(0)), t.data_ptr() % 16 // 4)

    def words(t):  # K1's pending words: width, row and column strides, the base's offset
        return (0, 0, 0, 0) if t is None else (int(t.shape[1]), int(t.stride(0)), int(t.stride(1)),
                                                t.data_ptr() % 16 // 4)

    keys = {
        (nk, "dft"): lambda x, inverse=False: ("dft", int(x.shape[0]), int(x.shape[1]), bool(inverse)),
        (kk, "hash_rows"): lambda a, b=None: ("keccak_hash_rows", int(a.shape[0]), *rows(a), *rows(b)),
        (kk, "compress_levels"): lambda d, levels: (
            "keccak_compress_levels", int(d.shape[0]), int(levels), d.data_ptr() % 16 // 4),
        (kk, "absorb_rows"): lambda st, m, first=False, pend=None, monty=False, natural=False: (
            "keccak_absorb", int(st.shape[1]), *rows(m), *words(pend), bool(first), bool(monty), bool(natural),
            st.data_ptr() % 16 // 4),
        (kk, "finalize_rows"): lambda st, pend, first=False, mat=None, monty=False, natural=False: (
            "keccak_finalize", int(st.shape[1]), *rows(mat), *words(pend), bool(first), bool(monty), bool(natural),
            st.data_ptr() % 16 // 4),
        (pk, "hash_rows"): lambda a, b=None: ("poseidon2_hash_rows", int(a.shape[0]), *rows(a), *rows(b)),
        (pk, "compress"): lambda a, b: ("poseidon2_compress", int(a.shape[0]), *rows(a), *rows(b)),
        (pk, "absorb_rows"): lambda s, c, first=False: (
            "poseidon2_absorb", int(c.shape[0]), *rows(c), bool(first)),
        (port.mxu_ntt, "mod_matmul_axis"): lambda x, w: (
            "mod_matmul_axis", int(x.shape[0]), x.numel() // int(x.shape[0])),
        (port.mxu_ntt, "mod_matmul_twiddle_moved"): lambda x, w, tw: (
            "mod_matmul_twiddle_moved", int(x.shape[0]), int(x.shape[1]), x.numel() // int(x.shape[0] * x.shape[1]),
            w is port.mxu_ntt._DEVICE_TABLES.get((str(x.device), "limbs", (int(x.shape[0]),), True))),
        (port.grind, "verdicts"): lambda start, count, pre, tail, w_off, bits: (
            "grind_verdicts", int(count), int(tail.shape[0]), int(w_off), int(bits)),
        (port.device_rng, "_monty_kernel"): _rng_key,
        (port.quotient_kernel, "eval_fold"): _quotient_key,
        (port.quotient_kernel, "panel_fold"): lambda tf, log_m, shift, r: (
            ("panel_fold", int(tf.shape[0]), int(tf.shape[1]), int(log_m), int(r)) if tf.is_cuda else None),
        (port.quotient_kernel, "eval_fold_plain"): lambda prog, cur, *a, **k: (
            ("plain_quotient", "eval_fold_plain") if cur.is_cuda else None),
        (port.quotient_kernel, "panel_fold_plain"): lambda tf, *a, **k: (
            ("plain_quotient", "panel_fold_plain") if tf.is_cuda else None),
        (port.open_kernel, "reduced_opening"): _opening_key,
        (port.open_kernel, "eval_at_points"): _points_key,
        (port.open_kernel, "fri_fold"): _fold_key,
        (port.open_kernel, "reduced_opening_plain"): lambda acc, *a, **k: (
            ("plain_open", "reduced_opening_plain") if acc.is_cuda else None),
        (port.open_kernel, "eval_at_points_plain"): lambda c, *a, **k: (
            ("plain_open", "eval_at_points_plain") if c.is_cuda else None),
        (port.open_kernel, "fri_fold_plain"): lambda cw, *a, **k: (
            ("plain_open", "fri_fold_plain") if cw.is_cuda else None),
    }
    originals = {}
    for (mod, name), key in keys.items():
        orig = originals[(mod, name)] = getattr(mod, name)

        def recorded(*args, _orig=orig, _key=key, **kw):
            k = _key(*args, **kw)
            if k is not None:  # None: a call that no kernel serves (the SoL report's audit on meta)
                seen.setdefault(k, set()).add(path)
            return _orig(*args, **kw)

        setattr(mod, name, recorded)
    try:
        yield
    finally:
        for (mod, name), orig in originals.items():
            setattr(mod, name, orig)


def _check_shapes(torch, port, seen: dict, rand_u32, rand_monty) -> dict:
    """Phase 13: every wrapper noted by ``_record_shapes`` against its plain
    version, exactly, on random operands of the noted shapes, row strides
    and alignments.  Returns {call kind: [shapes checked, max_abs_err]}."""
    nk, kk, pk, mx = port.ntt_kernel, port.keccak_kernel, port.poseidon2_kernel, port.mxu_ntt
    dev = rand_u32((1,)).device

    def operand(rand, n, k, stride, mis):
        if k == 0:
            return None
        flat = rand((n * max(k, stride) + mis,))
        return flat[mis:].as_strided((n, k), (max(k, stride), 1))

    def rowwise(fn, *ops):
        """A row-wise plain version over slices of PLAIN_ROWS rows, joined
        (the plain Keccak's int64 lanes of 2^26 rows would not fit)."""
        n = int(ops[0].shape[0])
        return torch.cat([fn(*(None if o is None else o[r : r + PLAIN_ROWS] for o in ops))
                          for r in range(0, n, PLAIN_ROWS)])

    def dft_plain(x, inverse):  # column slices of at most PLAIN_ELEMS elements
        step = max(1, PLAIN_ELEMS // int(x.shape[0]))
        return torch.cat([nk.dft_plain(x[:, c : c + step].contiguous(), inverse)
                          for c in range(0, int(x.shape[1]), step)], dim=1)

    def compress_levels_plain(d, levels):  # compress_levels_plain, a level at a time by row slices
        out = []
        for _ in range(levels):
            d = rowwise(kk.hash_rows_plain, d.reshape(-1, 16))
            out.append(d)
        return out

    qk = port.quotient_kernel
    progs = {p.dag.key: p for air, npis in ((port.FibonacciAir(), 3), (port.poseidon2_air.Poseidon2ChainAir(), 32),
                                            (port.keccak_air.KeccakAir(), 0)) for p in qk.programs(air, npis)}
    done = {}
    for key in sorted(seen, key=repr):
        kind, n = key[0], key[1]
        if kind in ("reduced_opening", "eval_at_points", "fri_fold"):
            got, want = _check_open(torch, port.open_kernel, key, rand_monty)
        elif kind == "quotient_eval":
            got, want = _check_quotient_eval(torch, qk, progs[key[1]], key, rand_monty)
        elif kind == "panel_fold":
            tf = rand_monty((n, key[2]))
            shift = 31 * pow(port.bb.two_adic_generator(key[3] + 1), 5, port.bb.P) % port.bb.P
            got, want = qk.panel_fold(tf, key[3], shift, key[4]), qk.panel_fold_plain(tf, key[3], shift, key[4])
        elif kind == "dft":
            x = rand_monty((n, key[2]))
            got, want = nk.dft(x, key[3]), dft_plain(x, key[3])
        elif kind == "mod_matmul_axis":
            x = rand_monty((n, key[2]))
            both = [mx.limbs_on(n, inverse, x.device) for inverse in (False, True)]
            step = max(1, PLAIN_ELEMS // n)  # column slices of at most PLAIN_ELEMS elements
            got = torch.stack([mx.mod_matmul_axis(x, w) for w in both])
            want = torch.stack([torch.cat([mx.mod_matmul_axis_plain(x[:, c : c + step], w)
                                           for c in range(0, key[2], step)], dim=1) for w in both])
        elif kind == "mod_matmul_twiddle_moved":
            x = rand_monty((n, key[2], key[3]))
            w, tw = mx.limbs_on(n, key[4], x.device), mx.twiddles_on(key[2], n, key[4], x.device)
            step = max(1, PLAIN_ELEMS // (n * key[2]))  # slices of the trailing axis
            got = mx.mod_matmul_twiddle_moved(x, w, tw)
            want = torch.cat([mx.mod_matmul_twiddle_moved_plain(x[:, :, r : r + step], w, tw)
                              for r in range(0, key[3], step)], dim=2)
        elif kind == "rng_sample":
            cols, n_sel, has_row0, has_idx, high = key[2:]
            k = port.device_rng.fold_in(port.device_rng.key(3), done.get(kind, [0])[0])
            sel = None if n_sel < 0 else rand_monty((n_sel,)).long() % cols
            idx = rand_monty((n,)).long() % max(1, n) if has_idx else None
            # a noted flat index past 2^32 is checked past it: rows straddling 2^32 / cols
            row0 = (max(1, (1 << 32) // cols - n // 2) if high else 1) if (has_row0 or has_idx) else 0
            got = port.device_rng._monty_kernel(k, n, cols, dev, sel=sel, row0=row0, row_idx=idx)
            want = _rng_plain(torch, port, k, cols, dev, n, sel, row0, idx)
        elif kind == "grind_verdicts":
            pre, tail = rand_u32((25, 2)).view(torch.int64).view(25), rand_u32((key[2], 34)).view(torch.int64)
            got = port.grind.verdicts(0, n, pre, tail, key[3], key[4])
            want = port.grind.verdicts_plain(0, n, pre, tail, key[3], key[4])
        elif kind == "keccak_compress_levels":
            d = rand_u32((n * 8 + key[3],))[key[3]:].view(n, 4, 2)
            got, want = torch.cat(kk.compress_levels(d, key[2])), torch.cat(compress_levels_plain(d, key[2]))
        elif kind in ("keccak_absorb", "keccak_finalize"):
            flat = rand_u32((50 * n + key[-1],))
            state = flat[key[-1]:].view(50, n)
            want_state = state.clone()
            first, monty, natural = key[9:12]
            mat = operand(rand_monty if monty else rand_u32, n, *key[2:5])
            p, prs, pcs, mis = key[5:9]
            pend = rand_u32((n * p + mis,))[mis:].as_strided((n, p), (prs, pcs)) if p else None
            if kind == "keccak_absorb":  # the state and the words written back
                rest = kk.absorb_rows(state, mat, first, pend, monty, natural)
                want_rest = kk.absorb_rows_plain(want_state, mat, first, pend, monty, natural)
                empty = torch.empty((n, 0), dtype=torch.int32, device=dev)
                got = torch.cat([state.t(), empty if rest is None else rest], 1)
                want = torch.cat([want_state.t(), empty if want_rest is None else want_rest], 1)
            else:
                got = kk.finalize_rows(state, pend, first, mat, monty, natural)
                want = kk.finalize_rows_plain(want_state, pend, first, mat, monty, natural)
        elif kind == "poseidon2_absorb":
            state, chunk = rand_monty((n, pk.WIDTH)), operand(rand_monty, n, *key[2:5])
            got = pk.absorb_rows(state.clone(), chunk, key[5])
            want = pk.absorb_rows_plain(state.clone(), chunk, key[5])
        else:
            rand = rand_u32 if kind == "keccak_hash_rows" else rand_monty
            a, b = operand(rand, n, *key[2:5]), operand(rand, n, *key[5:8])
            mod = kk if kind == "keccak_hash_rows" else pk
            if kind == "poseidon2_compress":
                got, want = mod.compress(a, b), mod.compress_plain(a, b)
            else:
                got, want = mod.hash_rows(a, b), rowwise(mod.hash_rows_plain, a, b)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"{key} (from {sorted(seen[key])}): kernel != plain (max_abs_err {err})")
        entry = done.setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] = max(entry[1], err)
    return done


def _check_quotient_eval(torch, qk, prog, key, rand_monty):
    """K7 at a noted shape (``_quotient_key``) on random operands, and its
    plain version over slices of PLAIN_ROWS rows (each slice's next rows,
    selectors and accumulator rows offset to its first row); the last
    block's offsets when the selector stride is above 1."""
    rows, u, ld, nrows, u_nxt, ld_nxt, nshift, sel_stride, sel_len, acc_stride, acc_len, add, invz, npis = key[2:]

    def operand(n, k, stride):
        return rand_monty((n * stride,)).as_strided((n, k), (stride, 1))

    cur, nxt = operand(rows, u, ld), operand(nrows, u_nxt, ld_nxt)
    sels = {name: rand_monty((sel_len,)) for name in qk.SELECTORS}
    pis, alpha, acc = rand_monty((npis,)), rand_monty((prog.count, 4)), rand_monty((acc_len, 4))
    sel_off, acc_off = sel_stride - 1, acc_stride - 1
    got = qk.eval_fold(prog, cur, nxt, nshift, sels, sel_off, sel_stride, pis, alpha, acc.clone(), acc_off,
                       acc_stride, add, invz)
    want = acc.clone()
    for r0 in range(0, rows, PLAIN_ROWS):
        qk.eval_fold_plain(prog, cur[r0 : r0 + PLAIN_ROWS], nxt, (nshift + r0) % nrows, sels,
                           sel_off + r0 * sel_stride, sel_stride, pis, alpha, want, acc_off + r0 * acc_stride,
                           acc_stride, add, invz)
    return got, want


def _rand_point(rand_monty):
    """A random canonical ext point (any residues)."""
    return tuple(int(v) for v in rand_monty((4,)).cpu().tolist())


def _check_open(torch, ok, key, rand_monty):
    """K9, K10 or K11 at a noted shape (``_opening_key``, ``_points_key``,
    ``_fold_key``) on random operands, and its plain version over row slices
    of PLAIN_ROWS rows (each slice's row0, r0 and accumulator rows offset to
    its first row)."""
    kind, n = key[0], key[1]
    S = PLAIN_ROWS

    def strided(rows, w, ld):
        return rand_monty((max(1, rows * ld),)).as_strided((rows, w), (ld, 1))

    if kind == "reduced_opening":
        log_h, row0, natural, npts, has_ext, ops, planes, nscales = key[2:]
        mats = [strided((1 << log_h) if natural else n, w, ld) for w, ld in ops]
        width = sum(w for w, _ in ops)
        apows = rand_monty((planes, width, 4) if planes else (width, 4))
        points = [(_rand_point(rand_monty), _rand_point(rand_monty)) for _ in range(npts)]
        scales = [_rand_point(rand_monty) for _ in range(nscales)] if nscales else None
        ext = rand_monty((planes, n, 4) if planes else (n, 4)) if has_ext else None
        acc = rand_monty((n, 4))
        got = ok.reduced_opening(acc.clone(), mats, apows, log_h, row0, points, natural, ext, scales)
        want = acc.clone()
        for a in range(0, n, S):
            ok.reduced_opening_plain(want[a : a + S], mats if natural else [m[a : a + S] for m in mats], apows, log_h,
                                     row0 + a, points, natural,
                                     None if ext is None else ext[..., a : a + S, :], scales)
        return got, want
    if kind == "eval_at_points":
        w, ld, npts, r0, out_ld = key[2:]
        coeffs = strided(n, w, ld)
        zs = [_rand_point(rand_monty) for _ in range(npts)]
        if out_ld is None:
            got, want = ok.eval_at_points(coeffs, zs, r0), torch.zeros((npts, w, 4), dtype=torch.int32,
                                                                        device=coeffs.device)
        else:
            buf = rand_monty((npts, max(w, out_ld // 4), 4))
            want = buf.clone()[:, :w]
            got = ok.eval_at_points(coeffs, zs, r0, buf[:, :w])
        for a in range(0, n, S):
            ok.eval_at_points_plain(coeffs[a : a + S], zs, r0 + a, want)
        return got, want
    log_h, row0, has_add = key[2:]
    cw = rand_monty((n, 4))
    add = rand_monty((n // 2, 4)) if has_add else None
    beta = _rand_point(rand_monty)
    got = ok.fri_fold(cw, beta, log_h, row0, add)
    want = torch.cat([ok.fri_fold_plain(cw[a : a + S], beta, log_h, row0 + a,
                                        None if add is None else add[a // 2 : (a + S) // 2]) for a in range(0, n, S)])
    return got, want


# phase 13's plain versions run on slices of at most this many rows (row-wise
# ones) or elements (the plain NTT, by column slices)
PLAIN_ROWS = 1 << 22
PLAIN_ELEMS = 1 << 26


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


def _phase24_quotient(torch, port, rand_monty, results, log_n: int = 20) -> str:
    """K7 and K8 against their plain versions, exact, and timed beside their
    bounds at the main paths' shapes: K7 on one partition of each of
    keccak-air's DAGs at config 4's panel (2^20 rows a coset in
    ``block_count``'s blocks: a block's rows, the next block's as next rows,
    the last block's strided selectors and accumulator rows), the dense
    pass of config 2 at 2^20 (2^21 x 2, times 1/Z_H) and of the chain
    (2^19 x 493); K8 at config 4's and cell 6's panel folds of a whole
    coset (2^20 and 2^21 coefficients into r blocks)."""
    qk, wide = port.quotient_kernel, port.wide
    n = 1 << log_n
    timed, lines, err = [], [], 0

    def one(label, prog, cur, nxt, nshift, sels, off, stride, pis, add, invz):
        nonlocal err
        alpha, acc = rand_monty((prog.count, 4)), rand_monty((int(sels["is_first_row"].shape[0]), 4))
        args = (prog, cur, nxt, nshift, sels, off, stride, pis, alpha)
        got = qk.eval_fold(*args, acc.clone(), off, stride, add, invz)
        want = qk.eval_fold_plain(*args, acc.clone(), off, stride, add, invz)
        torch.cuda.synchronize()
        e = _max_abs_err(torch, got, want)
        if e != 0 or not torch.equal(got, want):
            raise AssertionError(f"K7 {label}: kernel != plain (max_abs_err {e})")
        err = max(err, e)
        ms = _cuda_ms(torch, lambda: qk.eval_fold(*args, acc, off, stride, add, invz), 10)
        plain_ms = _cuda_ms(torch, lambda: qk.eval_fold_plain(*args, acc, off, stride, add, invz), 1)
        bound_ms, bound_by = quotient_eval_bound(prog.dag, int(cur.shape[0]), add, invz, same_panel(cur, nxt))
        row = {"label": label, "shape": list(cur.shape), "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
               "bound_ms": round(bound_ms, 6), "bound_by": bound_by}
        timed.append(row)
        lines.append(f"{label} {tuple(cur.shape)}: {ms:.4f} ms vs plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}, {100 * bound_ms / ms:.1f} %)")
        return row

    no_pis = torch.zeros((0,), dtype=torch.int32, device=rand_monty((1,)).device)
    seen_dags = set()
    for prog in qk.programs(port.keccak_air.KeccakAir(), 0):
        if prog.dag.key in seen_dags:
            continue
        seen_dags.add(prog.dag.key)
        u = len(prog.cols)
        r = wide.block_count(n, u, len(prog.next_cols) > 0, wide.PANEL_BUDGET, wide.MIN_BLOCK_LOG)
        sels = {k: rand_monty((n,)) for k in qk.SELECTORS}
        row = one(f"keccak-air {prog.name}", prog, rand_monty((n // r, u)), rand_monty((n // r, u)), 0, sels, r - 1,
                  r, no_pis, True, False)
        if prog.name == "apdef0":
            results["quotient_eval"] = (0, row["ms"], row["plain_ms"], row["bound_ms"], row["bound_by"])
    for label, air, npis, log_h in (("config 2 dense", port.FibonacciAir(), 3, log_n + 1),
                                    ("chain dense", port.poseidon2_air.Poseidon2ChainAir(), 32, log_n - 1)):
        prog = qk.programs(air, npis)[0]
        h = 1 << log_h
        cur = rand_monty((h, air.width))
        one(label, prog, cur, cur, 2, {k: rand_monty((h,)) for k in qk.SELECTORS}, 0, 1, rand_monty((npis,)), False,
            True)
    k8 = []
    for label, runs, u, r in K8_COSETS:
        n_coef, log_m = runs * n, log_n - (r.bit_length() - 1)
        tf = rand_monty((n_coef, u))
        shift = 31 * pow(port.bb.two_adic_generator(22), 3, port.bb.P) % port.bb.P
        got, want = qk.panel_fold(tf, log_m, shift, r), qk.panel_fold_plain(tf, log_m, shift, r)
        torch.cuda.synchronize()
        e = _max_abs_err(torch, got, want)
        if e != 0 or not torch.equal(got, want):
            raise AssertionError(f"K8 {label}: kernel != plain (max_abs_err {e})")
        del got, want
        ms = _cuda_ms(torch, lambda: qk.panel_fold(tf, log_m, shift, r), 10, queued=True)
        plain_ms = _cuda_ms(torch, lambda: qk.panel_fold_plain(tf, log_m, shift, r), 1)
        bound_ms, bound_by = panel_fold_bound(n_coef, u, 1 << log_m, r)
        k8.append({"label": label, "shape": [n_coef, u, 1 << log_m, r], "ms": round(ms, 6),
                   "plain_ms": round(plain_ms, 6), "bound_ms": round(bound_ms, 6), "bound_by": bound_by})
        lines.append(f"K8 {label} ({n_coef}, {u}) -> {r} x {1 << log_m} rows (a coset): {ms:.4f} ms vs plain "
                     f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f} %, "
                     f"target 70 % {'met' if bound_ms / ms >= 0.7 else 'not met'})")
        if label == "config 4 apdef":
            results["panel_fold"] = (0, ms, plain_ms, bound_ms, bound_by, {"shape": [n_coef, u, 1 << log_m, r],
                                                                          "timed": k8})
        del tf
    ms, plain_ms, bound_ms, bound_by = results["quotient_eval"][1:]
    shape = next(row["shape"] for row in timed if row["label"] == "keccak-air apdef0")
    results["quotient_eval"] = (err, ms, plain_ms, bound_ms, bound_by, {"shape": shape, "timed": timed})
    return "[24] K7 and K8 == plain (exact): " + "; ".join(lines)


# K9 and K10 at the main paths' shapes (phase 25; ``port_timing.py open``):
# (kernel, label, rows (K10: h), log_h, row0 (K10: r0), width, points,
# natural order, ext sum).  A two-point K9 row is a lone matrix (one table,
# the second point's sum scaled by alpha^w) read once for both points.
OPEN_ROWS = (
    ("K9", "config 2 2^24 trace codeword", 1 << 26, 26, 0, 2, 1, False, False),
    ("K9", "config 2 2^24 trace codeword, two points", 1 << 26, 26, 0, 2, 2, False, False),
    ("K9", "chain group", 1 << 20, 20, 0, 493, 1, False, False),
    ("K9", "chain group, two points", 1 << 20, 20, 0, 493, 2, False, False),
    ("K9", "config 5 rank block", 1 << 24, 26, 1 << 24, 2, 1, False, False),
    ("K9", "cell 6 chunk, natural order, no point", 1 << 22, 22, 0, 64, 0, True, False),
    ("K9", "cell 6 division of the ext sum", 1 << 22, 22, 0, 0, 1, False, True),
    ("K9", "cell 6 division of the ext sum, two points", 1 << 22, 22, 0, 0, 2, False, True),
    ("K10", "config 2 2^24 coefficients", 1 << 25, 0, 0, 2, 2, False, False),
    ("K10", "cell 6 chunk coefficients", 1 << 21, 0, 0, 64, 2, False, False),
    ("K10", "chain coefficients", 1 << 18, 0, 0, 493, 2, False, False),
    ("K10", "config 5 rank block", 1 << 23, 0, 1 << 23, 2, 2, False, False),
)


def open_row_bound(row):
    """The bound of an ``OPEN_ROWS`` row."""
    kind, _label, n, log_h, row0, w, npts, _natural, with_ext = row
    if kind == "K9":
        return reduced_opening_bound(n, log_h, row0, [w] if w else [], npts, with_ext, scaled=int(npts == 2))
    return eval_at_points_bound(n, w, npts)


def _phase25_open(torch, port, rand_monty, results, log_top: int = 26) -> str:
    """K9, K10 and K11 against their plain versions, exact, and timed beside
    their bounds at the main paths' shapes: K9 and K10 at ``OPEN_ROWS``
    (config 2 at 2^24: its 2^26-row trace codeword, 2 columns, and its 2^25
    coefficient rows; cell 6's streamed 64-column chunk: 2^22 LDE rows read
    in natural order into the ext sum, the one division on that sum, 2^21
    coefficient rows at two points; the chain's group, 2^20 x 493, and its
    2^18 coefficient rows; a rank block, config 5's rank 1 of 4: row0 = r0
    = a quarter of the height; K9 also at two points in one launch against
    two one-point plain calls); K11 at the top fold, the next with the next
    height's add, and a rank block.  Returns the phase's line."""
    ok, ext4 = port.open_kernel, port.ext4
    lines, err = [], {"reduced_opening": 0, "eval_at_points": 0, "fri_fold": 0}
    timed = {name: [] for name in err}

    def row(name, label, shape, got_fn, want_fn, run, bound):
        got, want = got_fn(), want_fn()
        torch.cuda.synchronize()
        e = _max_abs_err(torch, got, want)
        if e != 0 or not torch.equal(got, want):
            raise AssertionError(f"{name} {label}: kernel != plain (max_abs_err {e})")
        del got, want
        ms = _cuda_ms(torch, run, 10, queued=True)
        plain_ms = _cuda_ms(torch, want_fn, 1)
        bound_ms, bound_by = bound
        timed[name].append({"label": label, "shape": shape, "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
                            "bound_ms": round(bound_ms, 6), "bound_by": bound_by})
        lines.append(f"{name} {label} {tuple(shape)}: {ms:.4f} ms vs plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}, {100 * bound_ms / ms:.1f} %)")
        if name not in results:
            results[name] = (0, ms, plain_ms, bound_ms, bound_by, {"shape": shape, "timed": timed[name]})

    points = [(_rand_point(rand_monty), _rand_point(rand_monty)) for _ in range(2)]
    scales = [(1, 0, 0, 0), _rand_point(rand_monty)]

    def per_point(acc, mats, apows, log_h, row0, pts, natural, ext, scl):
        """K9's plain version a point at a time (a scaled point on its
        scaled alpha powers and ext sum)."""
        want = acc.clone()
        if not pts:
            return ok.reduced_opening_plain(want, mats, apows, log_h, row0, (), natural, ext)
        for p, pt in enumerate(pts):
            c = (1, 0, 0, 0) if scl is None else scl[p]

            def scaled(t):
                return ext4.mul(t, ext4.scalar(c, t.device)[None, :])

            ok.reduced_opening_plain(want, mats, scaled(apows), log_h, row0, [pt], natural,
                                     None if ext is None else scaled(ext))
        return want

    for spec in OPEN_ROWS:
        kind, label, n, log_h, row0, w, npts, natural, with_ext = spec
        if kind == "K9":
            mats = [rand_monty(((1 << log_h) if natural else n, w))] if w else []
            apows, acc = rand_monty((w, 4)), rand_monty((n, 4))
            ext = rand_monty((n, 4)) if with_ext else None
            pts, scl = points[:npts], scales if npts == 2 else None
            row("reduced_opening", label, [n, w] + ([npts] if npts == 2 else []),
                lambda: ok.reduced_opening(acc.clone(), mats, apows, log_h, row0, pts, natural, ext, scl),
                lambda: per_point(acc, mats, apows, log_h, row0, pts, natural, ext, scl),
                lambda: ok.reduced_opening(acc, mats, apows, log_h, row0, pts, natural, ext, scl),
                open_row_bound(spec))
            del mats, acc, ext
        else:
            coeffs = rand_monty((n, w))
            zs = [z for z, _s in points[:npts]]
            row("eval_at_points", label, [n, w, npts], lambda: ok.eval_at_points(coeffs, zs, row0),
                lambda: ok.eval_at_points_plain(coeffs, zs, row0), lambda: ok.eval_at_points(coeffs, zs, row0),
                open_row_bound(spec))
            del coeffs
    # K11
    beta, top = _rand_point(rand_monty), 1 << log_top
    for label, log_h, n, row0, with_add in (("config 2 2^24 top fold", log_top, top, 0, False),
                                            ("config 2 2^24 second fold, with the add", log_top - 1, top // 2, 0, True),
                                            ("config 5 rank block", log_top, top // 4, top // 4, False)):
        cw = rand_monty((n, 4))
        add = rand_monty((n // 2, 4)) if with_add else None
        row("fri_fold", label, [n, 4], lambda: ok.fri_fold(cw, beta, log_h, row0, add),
            lambda: ok.fri_fold_plain(cw, beta, log_h, row0, add), lambda: ok.fri_fold(cw, beta, log_h, row0, add),
            fri_fold_bound(n, with_add))
        del cw, add
    return "[25] K9, K10 and K11 == plain (exact): " + "; ".join(lines)


def _phase14_mxu(torch, port, rand_monty, results) -> str:
    """K5 against its plain version at the route's widths, then the narrow
    route against K2; returns the phase's line."""
    mx, radix2 = port.mxu_ntt, port.radix2
    lines = []
    for n, m in K5_TIMED:
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
            results["mxu_mm"] = (err, ms, plain_ms, *k5_bound(n, 1, m))
            lines[-1] += f" vs plain {plain_ms:.3f} ms, bound {results['mxu_mm'][3]:.4f} ms"
        del x
    levels, total_ms, total_bound = [], 0.0, 0.0
    for (b, a, r, inverse), count in sorted(config2_levels().items()):
        x = rand_monty((b, a, r))
        w = mx.limbs_on(b, inverse, x.device)
        if a == 1:
            def fn():
                return mx.mod_matmul_axis(x, w)
            want = mx.mod_matmul_axis_plain(x, w)
        else:
            tw = mx.twiddles_on(a, b, inverse, x.device)

            def fn():
                return mx.mod_matmul_twiddle_moved(x, w, tw)
            want = mx.mod_matmul_twiddle_moved_plain(x, w, tw)
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K5 level ({b}, {a}, {r}) inverse={inverse}: kernel != plain "
                                 f"(max_abs_err {_max_abs_err(torch, got, want)})")
        ms = _cuda_ms(torch, fn, 20)
        bound, by = k5_bound(b, a, r)
        total_ms, total_bound = total_ms + count * ms, total_bound + count * bound
        levels.append(f"({b}, {a}, {r}){' inv' if inverse else ''} x{count} {ms:.4f} ms "
                      f"({100 * bound / ms:.0f}% of {bound:.4f}, {by})")
        del x, got, want
    route = []
    for h, w in ROUTE_TIMED:
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
            + f". Config 2's K5 levels (B, A, R), each == plain (exact), timed: " + "; ".join(levels)
            + f"; a prove's {sum(config2_levels().values())} launches {total_ms:.4f} ms against "
            f"{total_bound:.4f} ms. Narrow route == K2 (dft and idft, exact); dft times: " + "; ".join(route))


def _rng_plain(torch, port, k, cols, dev, rows=0, sel=None, row0=0, row_idx=None):
    """The plain Threefry sample on the card (``device_rng._monty_at``) of
    rows row0 + (r or row_idx[r]) and columns (c or sel[c]) of a sample of
    ``cols`` columns, in row slices of ``device_rng._DRAW_ELEMS`` elements,
    as the plain path draws them."""
    drng = port.device_rng
    r = torch.arange(rows, device=dev) if row_idx is None else torch.as_tensor(row_idx, device=dev)
    c = torch.arange(cols, device=dev) if sel is None else torch.as_tensor(sel, device=dev)
    step = max(1, drng._DRAW_ELEMS // max(1, int(c.shape[0])))
    return torch.cat([drng._monty_at(k, (r[i : i + step, None] + row0) * cols + c[None, :])
                      for i in range(0, max(1, int(r.shape[0])), step)])


# phase 15's K6 checks: (rows, cols, sel, row0, row_idx), whole samples,
# columns with repeats, rows past flat index 2^32, gathered rows
RNG_CHECKS = (
    (1 << 22, 4, None, 0, None), (1 << 20, 64, None, 0, None), (4097, 3, None, 0, None),
    (1 << 16, 64, list(range(63, -1, -5)) + [0, 0], 0, None), (1 << 20, 4, None, (1 << 32) // 4 - (1 << 19), None),
    (4096, 64, [1, 1, 62], (1 << 33) // 64, None), (0, 4, None, (1 << 32) // 4 - 8, list(range(15, -1, -1)) * 2),
)
# timed: a randomizer chunk of cell 6 (n = 2^20 rows of a 64-column chunk),
# then salts of 2^21 and 2^22 rows (the last is the kernels line's shape)
RNG_TIMED = ((1 << 20, 64), (1 << 21, 4), (1 << 22, 4))


# transcript lengths whose witness straddles two lanes (37 B) or the tail's
# two blocks (134, 135 B)
GRIND_GEOMETRIES = (37, 134, 135)


def _phase15_rng_grind(torch, port, dev, results) -> str:
    """K6 against the plain Threefry and JAX's samples, timed; the grind
    kernel against its plain version, the host check and JAX's witnesses;
    returns the line."""
    import numpy as np

    with open(os.path.join(GOLDEN, "torch_device_rng_jax.json")) as f:
        fixture = json.load(f)
    drng, kernels = port.device_rng, port.kernels
    before = kernels.THREEFRY_MONTY.launches
    for e in fixture["samples"]:
        rng = port.DeviceRng(e["seed"], e["stream"], dev)
        for _ in range(e["counter"]):
            rng.sample_babybear_matrix_monty(1, 1)
        flat = rng.sample_babybear_matrix_monty(e["rows"], e["cols"]).cpu().numpy().astype("<u4").ravel()
        got = (hashlib.sha256(flat.tobytes()).hexdigest(), [int(v) for v in flat[:8]])
        if got != (e["sha256"], e["first"]):
            raise AssertionError(f"device rng {e['seed']}/{e['stream']!r}/{e['counter']} "
                                 f"({e['rows']}, {e['cols']}) differs from JAX's sample")
    if kernels.THREEFRY_MONTY.launches - before != sum(e["counter"] + 1 for e in fixture["samples"]):
        raise AssertionError("the device rng's samples on the card did not each launch K6 once")
    k = drng.fold_in(drng.key(1), 5)
    err = 0
    for rows, cols, sel, row0, row_idx in RNG_CHECKS:
        if row_idx is None:
            got = drng._sample_monty(k, rows, cols, dev, sel=sel, row0=row0)
        else:
            got = drng.LazyMatrix(k, 1 << 31, cols, dev, row0=row0).rows(torch.tensor(row_idx, device=dev))
        want = _rng_plain(torch, port, k, cols, dev, rows, sel, row0, row_idx)
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(torch, got, want))
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"K6 ({rows}, {cols}, sel {sel}, row0 {row0}, rows {row_idx}): kernel != plain "
                                 f"(max_abs_err {err})")
    rng_lines = []
    for rows, cols in RNG_TIMED:
        ms = _cuda_ms(torch, lambda: drng._sample_monty(k, rows, cols, dev), 20)
        plain_ms = _cuda_ms(torch, lambda: _rng_plain(torch, port, k, cols, dev, rows), 3)
        bound_ms, bound_by = threefry_bound(rows * cols)
        results["threefry_monty"] = [err, ms, plain_ms, bound_ms, bound_by, {"shape": [rows, cols]}]
        rng_lines.append(f"({rows}, {cols}) {ms:.4f} ms vs plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by}), {100 * bound_ms / ms:.1f}% of it")
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
        w = grind.device_grind(data, bits, device=dev)
        wall = time.perf_counter() - t0
        if w != e["witness"]:
            raise AssertionError(f"device_grind found {w}, JAX {e['witness']} ({len(data)} B, {bits} bits)")
        lines.append(f"{len(data)} B at {bits} bits: witness {w} in {wall * 1e3:.2f} ms")
        if bits == 16 and "keccak_grind" not in results:
            n_blocks = int(tl.shape[0])
            ms = _cuda_ms(torch, lambda: grind.verdicts(0, 1 << 17, pre, tl, w_off, bits), 20, queued=True)
            plain_ms = _cuda_ms(torch, lambda: grind.verdicts_plain(0, 1 << 17, pre, tl, w_off, bits), 2)
            bound_ms, bound_by = grind_bound(1 << 17, n_blocks)
            model_ms = grind_alu_model_ms(1 << 17, n_blocks)
            results["keccak_grind"] = [err, ms, plain_ms, bound_ms, bound_by, {"alu_model_ms": round(model_ms, 6)}]
            lines[-1] += (f" (2^17-candidate chunk, {n_blocks} block(s): {ms:.4f} ms vs plain {plain_ms:.3f} ms, "
                          f"{100 * bound_ms / ms:.1f}% of its bound {bound_ms:.4f} ms ({bound_by}), "
                          f"{100 * model_ms / ms:.1f}% of the ALU model {model_ms:.4f} ms)")
    for n_bytes in GRIND_GEOMETRIES:  # the witness across two lanes and across the tail's two blocks
        data = bytes(range(n_bytes))
        prefix, tail, w_off = grind._plan(data)
        pre, tl = grind._operands(prefix, tail, dev)
        for count in (1000, (1 << 17) + 77):  # the last block partly idle
            flags, want = grind.verdicts(9, count, pre, tl, w_off, 8), grind.verdicts_plain(9, count, pre, tl, w_off, 8)
            torch.cuda.synchronize()
            err = max(err, _max_abs_err(torch, flags, want))
            if not torch.equal(flags, want):
                raise AssertionError(f"grind kernel != plain ({n_bytes} B, {count} candidates)")
    results["keccak_grind"][0] = err
    return (f"[15] device rng (K6) == JAX's {len(fixture['samples'])} samples; K6 == plain (exact) at "
            f"{len(RNG_CHECKS)} samples (whole, sel with repeats, rows from row0 past flat index 2^32, gathered "
            f"rows); one sample: " + "; ".join(rng_lines) + ". Grind kernel == plain == host check; == plain with "
            f"the witness across lanes and blocks ({', '.join(map(str, GRIND_GEOMETRIES))} B transcripts) at 1000 "
            f"and 2^17 + 77 candidates; device_grind == JAX: " + "; ".join(lines))


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
        ("mxu", "config2-mxu", (kernels.MXU_MM, kernels.KECCAK_SPONGE, kernels.KECCAK_TREE, kernels.KECCAK_GRIND,
                                kernels.THREEFRY_MONTY, kernels.QUOTIENT_EVAL)),
        (None, "config2-k2", (kernels.NTT_PASS0, kernels.NTT_PASS, kernels.KECCAK_SPONGE, kernels.KECCAK_TREE,
                              kernels.KECCAK_GRIND, kernels.THREEFRY_MONTY, kernels.QUOTIENT_EVAL)),
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
    c2_len = _check_jax_length(f"config 2 2^{log_n}", blobs["config2-mxu"])
    SINGLE_DEVICE_SHA256[f"config 2 2^{log_n}"] = hashlib.sha256(blobs["config2-mxu"]).hexdigest()
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
            f"launches {launches['config2-k2']}; same bytes, {c2_len}; verify "
            f"{verify_s:.3f}s ok; the warm prove's {len(shapes)} device-rng samples {sorted(shapes)} take "
            f"{rng_s * 1e3:.3f} ms alone (CUDA events), {100 * rng_s / warm['config2-mxu']:.1f}% of its warm time")
    return line, launches



# phase 17's prove twins: (path, arguments, the golden fixture and key whose
# JAX proof has the twin's configuration, the kernels the path must launch)
TWINS = (
    ("twin-fib", ["fib", "12", "keccak", "zk", "1", "bench"], ("torch_fib_zk_device_jax_proofs.json", "12"),
     ("KECCAK_SPONGE", "KECCAK_TREE", "NTT_PASS0", "NTT_PASS", "KECCAK_GRIND", "THREEFRY_MONTY", "QUOTIENT_EVAL")),
    ("twin-chain", ["chain", "6"], ("torch_poseidon2_jax_proofs.json", "chain_6"),
     ("NTT_PASS0", "POSEIDON2_SPONGE", "QUOTIENT_EVAL")),
    # 7: the perms_5 fixture's 128 rows, generate_trace(128 // 24, seed=1)
    ("twin-keccak-air", ["keccak-air", "7", "bench", "1"], ("torch_keccak_air_jax_proofs.json", "perms_5"),
     ("NTT_PASS0", "POSEIDON2_SPONGE", "POSEIDON2_ABSORB", "QUOTIENT_EVAL", "PANEL_FOLD")),
    # the reference's stack at 64 rows: as long as the zk fixture's proof
    ("twin-keccak-air-zk", ["keccak-air", "6", "test", "1", "keccak", "zk"],
     ("torch_keccak_air_wide_zk_jax_proofs.json", "keccak_4chunks"),
     ("NTT_PASS0", "KECCAK_SPONGE", "KECCAK_TREE", "KECCAK_ABSORB", "THREEFRY_MONTY", "QUOTIENT_EVAL", "PANEL_FOLD")),
)


def _phase17_app_bench(torch, port, kind: str, seen: dict):
    """The application surface: ``python -m tpu_stark_torch.app --backend
    cuda fib bench`` in-process (the contract string, the policy line, the
    harness's 11 cases in all three CUDA tiers, each checked exactly against
    the CPU tier), then the prove twins at small heights, each proof as long
    as the JAX package's proof of its configuration.  Returns (the phase's
    line, {path: launches})."""
    kernels, harness = port.kernels, port.harness
    checked = []
    real_run_case = harness.run_case

    def run_case(h, w, use_cuda, device="cuda"):
        res = real_run_case(h, w, use_cuda, device)  # raises unless the card's output is the CPU tier's
        if use_cuda:
            checked.append((h, w))
        return res

    def quiet(fn, *args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
        return out, buf.getvalue().splitlines()

    launches = {}
    harness.run_case = run_case
    try:
        with _record_shapes(port, seen, "app"):
            (rc, lines), launches["app"] = _drive(
                kernels, lambda: quiet(port.app_main, ["--backend", "cuda", "fib", "bench"]),
                (kernels.KECCAK_SPONGE, kernels.KECCAK_TREE, kernels.NTT_PASS0, kernels.NTT_PASS, kernels.QUOTIENT_EVAL))
    finally:
        harness.run_case = real_run_case
    dft_lines = [ln for ln in lines if ln.startswith("dft ")]
    policy = [ln for ln in lines if ln.startswith("policy: ")]
    if rc != 0 or lines[0] != "cuda available: True" or "fib_air zk ok (n=8, x=21)" not in lines:
        raise AssertionError("the app's output is not the contract's:\n" + "\n".join(lines))
    if len(policy) != 1 or kind not in policy[0]:
        raise AssertionError(f"the app's policy line does not name {kind!r}: {policy}")
    if len(dft_lines) != len(harness.DEFAULT_CASES) or not all(
            f" {tier}=" in ln for ln in dft_lines for tier in ("cuda_e2e", "cuda_batched", "cuda_kernel")):
        raise AssertionError("the app's benchmark lines are not 11 cases in all three CUDA tiers:\n"
                             + "\n".join(lines))
    if checked != list(harness.DEFAULT_CASES):
        raise AssertionError(f"the harness's exact check ran on {checked}, not on its 11 cases")
    twins = []
    for path, argv, (fixture, key), path_kernels in TWINS:
        with open(os.path.join(GOLDEN, fixture)) as f:
            want = json.load(f)[key]["len"]
        with _record_shapes(port, seen, path):
            (out, _lines), launches[path] = _drive(
                kernels, lambda: quiet(port.bench_prove.main, argv),
                [getattr(kernels, name) for name in path_kernels])
        if out["proof_bytes"] != want or not out["peak_hbm_gb"] or out["narrow"] != "none":
            raise AssertionError(f"{path}: {out} is not {want} B of proof (JAX's, {fixture} {key})")
        used = {k: n for k, n in launches[path].items() if n}
        twins.append(f"{' '.join(argv)} -> {json.dumps(out)}, launches {used}")
    line = (f"[17] app --backend cuda fib bench: contract string ok; {policy[0]}; the harness's exact check "
            f"against the CPU tier passed at its {len(checked)} cases: " + " | ".join(dft_lines)
            + f"; launches {launches['app']}. Prove twins, each proof as long as JAX's of its configuration: "
            + " | ".join(twins))
    return line, launches


# phase 18: the absorb timed at the zk wide commit's step: 2^22 LDE rows,
# 30 pending words and a natural-order (2^22, 64) Montgomery chunk (two
# blocks absorbed, 26 words written back)
K1_ABSORB_TIMED = (1 << 22, 30, 64)


def _phase18_absorb(torch, port, rand_u32, rand_monty, results) -> str:
    """K1's carried-state absorb against its plain version, exactly: the
    timed step (the state and the words it writes back) on a carried random
    state in its three operand forms (Montgomery forms in natural or the
    tree's row order, canonical words in the tree's order; canonical words
    in natural order are refused), the finalize of the pending words and 4
    Montgomery salt words, 33 pending + 35, a state and operands off
    16-byte boundaries, and ``KeccakRowStream`` over odd-width canonical
    chunks and over natural Montgomery chunks against one-shot K1.  Returns
    the phase's line."""
    kk, bb, matrix = port.keccak_kernel, port.bb, port.matrix
    err = 0

    def check(label, got, want):
        nonlocal err
        torch.cuda.synchronize()
        e = _max_abs_err(torch, got, want)
        err = max(err, e)
        if e != 0 or not torch.equal(got, want):
            raise AssertionError(f"K1 absorb {label}: kernel != plain (max_abs_err {e})")

    n, p, k = K1_ABSORB_TIMED
    state, chunk, pend = rand_u32((50, n)), rand_monty((n, k)), rand_u32((p, n)).t()
    try:
        kk.absorb_rows(state.clone(), chunk, False, pend, False, True)
    except ValueError:
        pass
    else:
        raise AssertionError("K1 absorb took a natural-order chunk of canonical words")
    for monty, natural in ((True, True), (True, False), (False, False)):
        st, want = state.clone(), state.clone()
        rest = kk.absorb_rows(st, chunk, False, pend, monty, natural)
        want_rest = kk.absorb_rows_plain(want, chunk, False, pend, monty, natural)
        check(f"({n}, {p} + {k}) monty {monty} natural {natural}", torch.cat([st.t(), rest], 1),
              torch.cat([want.t(), want_rest], 1))
        del st, want, rest, want_rest
    salts, left = rand_monty((n, 4)), rand_u32((26, n)).t()
    check(f"finalize ({n}, 26 pending + 4 Montgomery salt words)", kk.finalize_rows(state, left, False, salts, True),
          kk.finalize_rows_plain(state, left, False, salts, True))
    m = rand_u32((4097, 33 + 35))
    st = rand_u32((50, 4097))
    want = st.clone()
    kk.absorb_rows(st, m[:, 33:], pend=m[:, :33])
    kk.absorb_rows_plain(want, m[:, 33:], pend=m[:, :33])
    check("(4097, 33 pending + 35)", st, want)
    for mis in (1, 2, 3):  # the state and the operands 4 mis bytes past a 16-byte boundary
        flat = rand_u32((50 * 4097 + mis,))
        st = flat[mis:].view(50, 4097)
        mm = rand_u32((4097 * 70 + mis,))[mis:].view(4097, 70)
        want = st.clone()
        kk.absorb_rows_plain(want, mm[:, 1:69])
        kk.absorb_rows(st, mm[:, 1:69])
        check(f"(4097, 68) misaligned by {4 * mis} B", st, want)
    wide = rand_u32((4097, 64 + 63 + 65 + 1 + 7))
    stream = port.sponge.KeccakRowStream(4097, wide.device)
    off = 0
    for wc in (64, 63, 65, 1, 7):  # odd widths: a u32 pair straddles chunks
        stream.absorb_cols(wide[:, off : off + wc])
        off += wc
    check("stream of chunks 64, 63, 65, 1, 7 vs one-shot K1", stream.finalize(), kk.hash_rows(wide))
    code = rand_monty((4096, 64 + 63 + 1 + 7))
    stream = port.sponge.KeccakRowStream(4096, code.device)
    off = 0
    for wc in (64, 63, 1, 7):  # natural-order Montgomery chunks, as K2 leaves them
        stream.absorb_monty(code[:, off : off + wc].contiguous(), True)
        off += wc
    check("stream of natural Montgomery chunks 64, 63, 1, 7 vs one-shot K1", stream.finalize(),
          kk.hash_rows(bb.to_u32(matrix.reverse_matrix_index_bits(code))))
    ms = _cuda_ms(torch, lambda: kk.absorb_rows(state, chunk, False, pend, True, True), 20)
    plain_ms = _cuda_ms(torch, lambda: kk.absorb_rows_plain(state, chunk, False, pend, True, True), 1)
    bound_ms, bound_by = keccak_absorb_bound(n, p, k, False, False, True)
    perms = n * ((p + k) // 34)
    model_ms = keccak_alu_model_ms(perms)
    results["keccak_absorb"] = (err, ms, plain_ms, bound_ms, bound_by,
                                {"shape": [n, p, k], "natural": True, "monty": True,
                                 "alu_model_ms": round(model_ms, 6)})
    return (f"[18] K1 carried-state absorb == plain (exact): ({n}, {p} pending + {k}) on a carried state in the "
            f"three operand forms (Montgomery in natural or tree order, canonical in tree order; the state and "
            f"the 26 words written back), the finalize of 26 pending + 4 Montgomery salt words, 33 pending + 35, "
            f"a state and chunk off 16-byte boundaries, streams of odd-width canonical and natural Montgomery chunks == "
            f"one-shot K1; ({n}, {p} + natural Montgomery {k}): {ms:.4f} ms vs plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it; ALU-pipe model {model_ms:.4f} "
            f"ms, {100 * model_ms / ms:.1f}% of it ({perms / ms / 1e3:.1f} Mperm/s)")


def _phase19_zk_fixture(torch, port, dev) -> str:
    """The zk wide fixture's two proofs on the card: SHA-256, length, verify."""
    with open(os.path.join(GOLDEN, "torch_keccak_air_wide_zk_jax_proofs.json")) as f:
        fixture = json.load(f)
    air = port.keccak_air.KeccakAir()
    for name, want in sorted(fixture.items()):
        def cfg():
            return port.create_config(zk=True, hash=want["hash"], device=dev)

        trace = port.keccak_air.generate_trace(2, seed=want["seed"], device=dev)
        blob = port.serialize_proof(port.wide.prove_wide(cfg(), air, trace, [], col_chunk=want["col_chunk"]))
        got = {"sha256": hashlib.sha256(blob).hexdigest(), "len": len(blob)}
        if got["sha256"] != want["sha256"] or got["len"] != want["len"]:
            raise AssertionError(f"zk keccak-air {name}: {got} != JAX {want}")
        if not port.verify(cfg(), air, port.deserialize_proof(blob), []):
            raise AssertionError(f"zk keccak-air {name}: proof does not verify")
    return (f"[19] zk keccak-air prove_wide at 64 rows ({', '.join(sorted(fixture))}) match the JAX SHA-256 "
            f"and length; both verify")


def _phase20_zk_wide(torch, port, dev, seen, smi: str, log_k: int = 20):
    """keccak-air at 2^20 x 3608 through ``prove_wide`` on the reference's
    stack (Keccak, zk, the device rng, benchmark FRI): one cold prove (launch
    counts reset just before it, read just after), its phases and peak
    device memory, and the port's verifier.  Returns (line, launches)."""
    kernels, keccak_air = port.kernels, port.keccak_air
    t0 = time.perf_counter()
    trace = keccak_air.generate_trace((1 << log_k) // keccak_air.NUM_ROUNDS, seed=1, device=dev)[: 1 << log_k]
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    air = keccak_air.KeccakAir()

    def cfg():
        return port.create_config(port.create_benchmark_fri_params(1), zk=True, hash="keccak", device=dev)

    timings = {}

    def cold():
        t0 = time.perf_counter()
        out = port.wide.prove_wide(cfg(), air, trace, [], timings=timings)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    with _record_shapes(port, seen, "keccak-air-zk"):
        (proof, cold_s), launches = _drive(kernels, cold, (
            kernels.KECCAK_SPONGE, kernels.KECCAK_TREE, kernels.KECCAK_ABSORB, kernels.NTT_PASS0,
            kernels.NTT_PASS, kernels.KECCAK_GRIND, kernels.THREEFRY_MONTY, kernels.QUOTIENT_EVAL, kernels.PANEL_FOLD))
    peak = torch.cuda.max_memory_allocated(dev)
    blob = port.serialize_proof(proof)
    t0 = time.perf_counter()
    ok = port.verify(cfg(), air, port.deserialize_proof(blob), [])
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"zk keccak-air 2^{log_k} proof does not verify")
    if (proof.degree_bits != log_k or proof.log_quotient_degree != 3 or len(proof.commitments.trace) != 4
            or proof.opening_proof.random_commit is None or len(proof.opening_proof.query_proofs) != 100
            or len(proof.opened_values.trace_local) != keccak_air.COLS):
        raise AssertionError(f"zk keccak-air 2^{log_k} proof is not a 100-query Keccak zk proof of "
                             f"2^{log_k} x 3608 with 8 quotient chunks")
    sha = hashlib.sha256(blob).hexdigest()
    if log_k == 20 and sha != KECCAK_AIR_ZK_SHA256:
        raise AssertionError(f"zk keccak-air 2^{log_k}: SHA-256 {sha} is not the plain Threefry's "
                             f"{KECCAK_AIR_ZK_SHA256}")
    phases = ", ".join(f"{k} {v:.3f}s" for k, v in timings.items())
    used = {k: n for k, n in launches.items() if n}
    line = (f"[20] keccak-air n=2^{log_k} x {keccak_air.COLS} prove_wide on the reference's stack (Keccak, zk, "
            f"device rng, blowup 2, 100 queries, 16 PoW bits; 2^{log_k + 1} committed rows, 2^{log_k + 2} LDE "
            f"rows, {-(-keccak_air.COLS // port.wide.default_col_chunk(1 << (log_k + 2)))} chunks): trace generation "
            f"{trace_s:.3f}s; cold (only) {cold_s:.3f}s ({phases}); verify {verify_s:.3f}s ok; proof "
            f"{len(blob)} B, SHA-256 {sha} (the port's own: no JAX log of this configuration; the plain Threefry's "
            f"bytes); launches {used}; peak device "
            f"memory {peak / 2**30:.3f} GiB (trace included); on {smi}")
    return line, launches


def _phase21_lowmem(torch, port, dev, seen, smi: str, log_n: int = 24, log_top: int = 25):
    """BASELINE config 2 in low-memory mode: at 2^log_n, on one trace, one
    prove with the levers off (``lowmem_log=0``) and one with them from the
    JAX package's 2^24 committed rows (the main path: launch counts reset
    just before it, read just after, its operand shapes noted), each with
    its own peak; equal SHA-256 at the JAX package's length, verified; then
    one prove at 2^log_top at the card's default threshold, which must
    engage the levers there, verified.  Returns (line, launches)."""
    import gc

    t_phase = time.perf_counter()
    kernels, pcs, lowmem = port.kernels, port.pcs, port.lowmem
    air = port.FibonacciAir()
    card_log = lowmem.default_log(dev)

    def cfg(lowmem_log):
        return port.create_config(port.create_benchmark_fri_params(1), zk=True, device=dev, lowmem_log=lowmem_log)

    recomputes = []  # (rows, columns) of every released codeword's recompute
    real_codeword = pcs._LazyLde.codeword

    def codeword(mats):
        recomputes.append((mats[0].shape[0], sum(m.shape[1] for m in mats)))
        return real_codeword(mats)

    def trace_of(log):
        t0 = time.perf_counter()
        trace = port.generate_trace_rows(0, 1, 1 << log)
        return trace, time.perf_counter() - t0

    def one(log, trace, lowmem_log):
        pis = [0, 1, port.fibonacci_value(0, 1, 1 << log)]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        timings = {}
        t0 = time.perf_counter()
        proof = port.prove(cfg(lowmem_log), air, trace, pis, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        blob = port.serialize_proof(proof)
        t0 = time.perf_counter()
        ok = port.verify(cfg(lowmem_log), air, port.deserialize_proof(blob), pis)
        verify_s = time.perf_counter() - t0
        if not ok:
            raise AssertionError(f"config 2 n=2^{log} lowmem_log={lowmem_log}: the proof does not verify")
        if proof.degree_bits != log or len(proof.opening_proof.query_proofs) != 100:
            raise AssertionError(f"config 2 n=2^{log} lowmem_log={lowmem_log}: not a 100-query proof of 2^{log} rows")
        phases = ", ".join(f"{k} {v:.3f}s" for k, v in timings.items())
        return blob, f"prove {wall:.3f}s ({phases}), peak {peak:.3f} GiB, verify {verify_s:.3f}s ok"

    trace, trace_s = trace_of(log_n)
    off_blob, off_note = one(log_n, trace, 0)
    pcs._LazyLde.codeword = staticmethod(codeword)
    try:
        with _record_shapes(port, seen, "config2-lowmem"):
            (on_blob, on_note), launches = _drive(kernels, lambda: one(log_n, trace, lowmem.LOWMEM_LOG), (
                kernels.NTT_PASS0, kernels.NTT_PASS, kernels.KECCAK_SPONGE, kernels.KECCAK_TREE,
                kernels.KECCAK_GRIND, kernels.THREEFRY_MONTY, kernels.QUOTIENT_EVAL))
        n_on = len(recomputes)
        del trace
        if not n_on:
            raise AssertionError(f"config 2 n=2^{log_n} lowmem_log={lowmem.LOWMEM_LOG}: no codeword released")
        if on_blob != off_blob:
            raise AssertionError(f"config 2 n=2^{log_n}: the proofs with the levers on and off differ")
        length = _check_jax_length(f"config 2 2^{log_n}", on_blob)
        SINGLE_DEVICE_SHA256[f"config 2 2^{log_n}"] = hashlib.sha256(on_blob).hexdigest()
        trace, top_trace_s = trace_of(log_top)
        top_blob, top_note = one(log_top, trace, None)
        del trace
        if len(recomputes) == n_on:
            raise AssertionError(f"config 2 n=2^{log_top} at the card's threshold 2^{card_log}: no codeword released")
    finally:
        pcs._LazyLde.codeword = staticmethod(real_codeword)
    # what a lazy salt's opening costs: the whole draw (JAX's materialize()[rows]) or the rows alone
    draw = port.DeviceRng(1, "salts", dev).sample_lazy(1 << (log_n + 2), 4)
    rows = torch.randint(0, 1 << (log_n + 2), (1024,), device=dev)
    whole_ms = _cuda_ms(torch, lambda: draw.materialize()[rows], 2)
    rows_ms = _cuda_ms(torch, lambda: draw.rows(rows), 5)
    if not torch.equal(draw.rows(rows), draw.materialize()[rows]):
        raise AssertionError("LazyMatrix.rows differs from materialize()[rows]")
    used = {k: v for k, v in launches.items() if v}
    line = (f"[21] config 2 low-memory mode (fib zk, device rng, benchmark FRI) on {smi}: n=2^{log_n} "
            f"(trace generation {trace_s:.3f}s, one trace for both) levers off (lowmem_log=0): {off_note}; "
            f"levers on (lowmem_log={lowmem.LOWMEM_LOG}, the JAX package's): {on_note}; the same SHA-256 "
            f"{hashlib.sha256(on_blob).hexdigest()[:16]}..., {length}; {n_on} codeword recomputes "
            f"(rows, columns) {recomputes[:n_on]}; launches {used}; 1024 rows of a (2^{log_n + 2}, 4) salt draw: "
            f"{rows_ms:.3f} ms drawn alone vs {whole_ms:.3f} ms through the whole draw (CUDA events, equal); "
            f"n=2^{log_top} at the card's default threshold 2^{card_log} (levers on; trace generation "
            f"{top_trace_s:.3f}s): {top_note}, {len(recomputes) - n_on} codeword recomputes, proof {len(top_blob)} B "
            f"(the port's own: no JAX log); phase 21 took {time.perf_counter() - t_phase:.3f}s")
    return line, launches


OPEN_KERNEL_NAMES = ("reduced_opening", "eval_at_points", "fri_fold")  # K9, K10, K11: every prove's open phase
SHARDED_KERNELS = ("ntt_pass0", "ntt_pass", "keccak_sponge", "keccak_tree", "keccak_grind", "threefry_monty",
                   "quotient_eval") + OPEN_KERNEL_NAMES
# the dry run's proves use the test FRI, whose 1-bit grind is host work
DRYRUN_KERNELS = ("ntt_pass0", "ntt_pass", "keccak_sponge", "keccak_tree", "poseidon2_sponge", "poseidon2_absorb",
                  "threefry_monty", "quotient_eval", "panel_fold")
# the streamed wide prove on a mesh: (d) BASELINE config 4 on the Poseidon2
# stack, (e) the reference's stack (Keccak trees, zk)
WIDE_KERNELS = {"d": ("ntt_pass0", "ntt_pass", "poseidon2_sponge", "poseidon2_absorb", "quotient_eval", "panel_fold")
                + OPEN_KERNEL_NAMES,
                "e": ("ntt_pass0", "ntt_pass", "keccak_absorb", "threefry_monty", "quotient_eval", "panel_fold")
                + OPEN_KERNEL_NAMES}


def _phase22_rank(mesh, path: str, log_n: int, trace_path):
    """One rank of phase 22: config 2 (benchmark FRI) at 2^log_n on the
    mesh through ``dist.dryrun.prove_fib``, the operand shapes of its
    kernel wrappers noted under ``path``.  The rank loads the library the
    parent built: a missing or stale one fails it before any build."""
    port = _rank_port()
    seen = {}
    port.kernels.reset_launch_counts()
    with _record_shapes(port, seen, path):
        out = port.dryrun.prove_fib(mesh, log_n, trace_path=trace_path, benchmark_fri=True)
    out["launches"] = {k.name: k.launches for k in port.kernels.ALL if k.launches}
    out["shapes"] = [(key, sorted(paths)) for key, paths in seen.items()]
    return out


def _phase22_wide_rank(mesh, path: str, kwargs: dict):
    """One rank of phase 22 (d) or (e): keccak-air through ``prove_wide`` on
    the mesh (``dist.dryrun.prove_keccak_air(mesh, **kwargs)``), the
    operand shapes of its kernel wrappers noted under ``path``.  Every
    launch count is set to 0 just before, and the result's launches are
    the counts read just after the sharded prove (before rank 0's
    single-device prove that ``single`` asks for)."""
    port = _rank_port()
    seen = {}
    port.kernels.reset_launch_counts()
    with _record_shapes(port, seen, path):
        out = port.dryrun.prove_keccak_air(mesh, **kwargs)
    out["shapes"] = [(key, sorted(paths)) for key, paths in seen.items()]
    return out


def _phase22_dryrun_rank(mesh, log_n: int):
    """One rank of phase 22's dry run (``dist.dryrun.dryrun_rank``): its
    check lines, its kernel launches (counts reset just before, read just
    after) and its kernels' operand shapes under the path "dryrun"."""
    port = _rank_port()
    seen = {}
    port.kernels.reset_launch_counts()
    with _record_shapes(port, seen, "dryrun"):
        lines = port.dryrun.dryrun_rank(mesh, log_n)
    return {"rank": mesh.rank, "lines": lines,
            "launches": {k.name: k.launches for k in port.kernels.ALL if k.launches},
            "shapes": [(key, sorted(paths)) for key, paths in seen.items()]}


def _rank_port():
    """The port in a rank of phase 22, which loads the library the parent
    built: a missing or stale one fails the rank before any build."""
    port = import_port()
    if not port.kernels.up_to_date():
        raise RuntimeError("the kernel library is missing or stale: a rank would start an nvcc build")

    def no_nvcc():
        raise RuntimeError("a rank would start an nvcc build of a K7 library that phase 1 did not build")

    port.kernels._nvcc = no_nvcc
    return port


def _phase22_sharded(torch, port, dev, seen, smi: str, log_a: int = 20, log_b: int = 24, log_d: int = 20,
                     log_e: int = 16):
    """The sharded prover through ``dist/dryrun.py``'s runner: (a) config 2
    at 2^log_a over an NCCL group of min(cards, 4) ranks, (b) BASELINE
    config 5 (fib_air zk at 2^log_b, config 2's benchmark FRI) over four
    gloo ranks on this card, host-staged, (c) the dry run over four gloo
    ranks at its default depth, (d) BASELINE config 4 (keccak-air at
    2^log_d x 3608 through ``prove_wide``: Poseidon2, zk off, benchmark
    FRI) over the NCCL group of (a), (e) keccak-air at 2^log_e x 3608 on
    the reference's stack (Keccak trees, zk, the device rng, benchmark FRI)
    over four gloo ranks on this card, rank 0 also proving on one device.
    (a), (b) and (d) must give phase 16's, phase 21's and phase 12's
    single-device SHA-256 on every rank, (e) rank 0's single-device bytes
    on every rank; each verifies.  Every rank of (a) and (b) must launch
    K1, K2 and the grind, of (c) K1, K2, K3 and K4, of (d) K2, K3 and K4,
    of (e) K1's absorb and K2 (counts reset just before the part's work,
    read just after), and returns its kernels' operand shapes for phase 13.
    Returns (line, {path: launches summed over the ranks})."""
    import gc
    import tempfile

    import numpy as np

    t_phase = time.perf_counter()
    dryrun = port.dryrun
    air = port.FibonacciAir()
    k_air = port.keccak_air.KeccakAir()
    gc.collect()
    torch.cuda.empty_cache()

    def check(label, per_rank, want, need, verify_blob, length_key=None):
        """Every rank's SHA-256 ``want`` (rank 0's when None), ``need``'s
        kernels launched on every rank, the length, the verifier; the
        line and the launches summed over the ranks."""
        want = want or per_rank[0]["sha256"]
        for r in per_rank:
            if r["sha256"] != want:
                raise AssertionError(f"{label}: rank {r['rank']}'s proof is not the single-device proof")
            missing = [k for k in need if r["launches"].get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"{label}: rank {r['rank']} did not launch {missing}")
            for key, paths in r["shapes"]:
                seen.setdefault(key, set()).update(paths)
        blob = per_rank[0]["blob"]
        length = _check_jax_length(length_key, blob) if length_key else f"{len(blob)} B"
        t0 = time.perf_counter()
        if not verify_blob(blob):
            raise AssertionError(f"{label}: the sharded proof does not verify")
        verify_s = time.perf_counter() - t0
        launches = {k.name: 0 for k in port.kernels.ALL}
        for r in per_rank:
            for k, v in r["launches"].items():
                launches[k] += v
        notes = []
        for r in per_rank:
            sent = ", ".join(f"{k} {v}" for k, v in sorted(r["sent"].items()) if v)
            notes.append(
                f"rank {r['rank']} ({r['device']}, {r['transport']}): wall {r['wall_s']:.3f}s "
                f"({', '.join(f'{k} {v:.3f}s' for k, v in r['phases'].items())}), peak {r['peak_gib']:.3f} GiB, "
                f"sent B by collective {{{sent}}}, staged {r['staged']} B, {sum(r['comm_s'].values()):.3f}s in "
                f"collectives ({', '.join(f'{k} {v:.3f}' for k, v in sorted(r['comm_s'].items()))}), "
                f"launches {r['launches']}")
        return (f"{label}: every rank's SHA-256 {want[:16]}... = the single-device proof's, {length}; verify "
                f"{verify_s:.3f}s ok; " + "; ".join(notes)), launches

    def verify_fib(log_n):
        pis = [0, 1, port.fibonacci_value(0, 1, 1 << log_n)]
        cfg = port.create_config(port.create_benchmark_fri_params(1), zk=True, device=dev)
        return lambda blob: port.verify(cfg, air, port.deserialize_proof(blob), pis)

    def verify_keccak(zk, hash):
        cfg = port.create_config(port.create_benchmark_fri_params(1), zk=zk, hash=hash, device=dev)
        return lambda blob: port.verify(cfg, k_air, port.deserialize_proof(blob), [])

    n_a = min(torch.cuda.device_count(), 4)
    t0 = time.perf_counter()
    res_a = dryrun.run_ranks(n_a, _phase22_rank, "config2-nccl", log_a, None, backend="nccl", device="cuda",
                             timeout=300)
    line_a, launches_a = check(f"(a) config 2 2^{log_a} over {n_a} NCCL rank(s)", res_a,
                               SINGLE_DEVICE_SHA256[f"config 2 2^{log_a}"], SHARDED_KERNELS, verify_fib(log_a),
                               f"config 2 2^{log_a}")
    line_a += f"; (a) took {time.perf_counter() - t0:.3f}s"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ts_phase22_") as tmp:
        trace_path = os.path.join(tmp, "trace.npy")
        np.save(trace_path, port.generate_trace_rows(0, 1, 1 << log_b))
        trace_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_b = dryrun.run_ranks(4, _phase22_rank, "config5-sharded", log_b, trace_path, backend="gloo",
                                 device="cuda:0", timeout=600)
    line_b, launches_b = check(f"(b) BASELINE config 5 (fib zk 2^{log_b}, benchmark FRI) over 4 gloo ranks on "
                               f"cuda:0", res_b, SINGLE_DEVICE_SHA256[f"config 2 2^{log_b}"], SHARDED_KERNELS,
                               verify_fib(log_b), f"config 2 2^{log_b}")
    line_b += f"; (b) took {time.perf_counter() - t0:.3f}s after {trace_s:.3f}s of trace generation"
    t0 = time.perf_counter()
    res_c = dryrun.run_ranks(4, _phase22_dryrun_rank, 10, backend="gloo", device="cuda", timeout=300)
    lines_c = dryrun.same_checks([r["lines"] for r in res_c])
    launches_c = {k.name: 0 for k in port.kernels.ALL}
    for r in res_c:
        missing = [k for k in DRYRUN_KERNELS if r["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"(c) dry run: rank {r['rank']} did not launch {missing}")
        for k, v in r["launches"].items():
            launches_c[k] += v
        for key, paths in r["shapes"]:
            seen.setdefault(key, set()).update(paths)
    used_c = {k: v for k, v in launches_c.items() if v}
    line_c = (f"(c) dry run over 4 gloo ranks on the card: {'; '.join(lines_c)}; launches over the ranks {used_c}; "
              f"(c) took {time.perf_counter() - t0:.3f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res_d = dryrun.run_ranks(n_a, _phase22_wide_rank, "config4-nccl", {"log_n": log_d}, backend="nccl",
                             device="cuda", timeout=300)
    line_d, launches_d = check(
        f"(d) BASELINE config 4 (keccak-air 2^{log_d} x {port.keccak_air.COLS}, prove_wide, Poseidon2, zk off, "
        f"benchmark FRI) over {n_a} NCCL rank(s)", res_d, SINGLE_DEVICE_SHA256[f"keccak-air 2^{log_d}"],
        WIDE_KERNELS["d"], verify_keccak(False, "poseidon2"), f"keccak-air 2^{log_d}")
    line_d += f"; (d) took {time.perf_counter() - t0:.3f}s"
    t0 = time.perf_counter()
    res_e = dryrun.run_ranks(4, _phase22_wide_rank, "keccak-air-zk-sharded",
                             {"log_n": log_e, "hash": "keccak", "zk": True, "single": True}, backend="gloo",
                             device="cuda:0", timeout=600)
    line_e, launches_e = check(
        f"(e) keccak-air 2^{log_e} x {port.keccak_air.COLS} on the reference's stack (Keccak, zk, device rng, "
        f"benchmark FRI) over 4 gloo ranks on cuda:0, rank 0's single-device prove equal", res_e, None,
        WIDE_KERNELS["e"], verify_keccak(True, "keccak"))
    line_e += f"; (e) took {time.perf_counter() - t0:.3f}s"
    line = (f"[22] the sharded prover on {smi}: {line_a}; {line_b}; {line_c}; {line_d}; {line_e}; phase 22 took "
            f"{time.perf_counter() - t_phase:.3f}s")
    return line, {"config2-nccl": launches_a, "config5-sharded": launches_b, "dryrun": launches_c,
                  "config4-nccl": launches_d, "keccak-air-zk-sharded": launches_e}


# phase 23: each probe of bench/sol.py against its plain twin, the mul and
# alu probes at sol.py's n with one rep (16 dependent steps of 16 chains a
# column), the stream at its 2^27 words; int32 instructions a step, read off
# the probes' SASS: the mul probe's Montgomery product against a vector
# operand (IMAD.WIDE, IMAD, IMAD.HI, ISETP and three adds), the alu probe's
# two funnel shifts and one LOP3
SOL_MUL_STEP_OPS = 7
SOL_ALU_STEP_OPS = 3
SOL_STREAM_N = 1 << 27


def _sol_probe_rows(torch, port, dev, report, results) -> str:
    """Each SoL probe kernel against its plain twin on the same inputs,
    exact, timed beside its bound (and the stream beside ``torch.add``);
    fills ``results`` and returns the line's part."""
    sol = port.sol
    n, ilp = sol._N, sol._ILP
    steps = sol._INNER * ilp * n
    parts = []

    def row(name, err, ms, plain_ms, bound, extra):
        results[name] = (err, ms, plain_ms, *bound, extra)
        parts.append(f"{name} {ms:.4f} ms vs plain {plain_ms:.3f} ms, {100 * bound[0] / ms:.1f}% of its bound "
                     f"{bound[0]:.4f} ms ({bound[1]})")

    x, tw = sol.mul_operands(n, dev)
    err = _max_abs_err(torch, sol.mul_chain(x, tw, 1), sol.mul_chain_plain(x, tw, 1))
    row("sol_mul_probe", err, _cuda_ms(torch, lambda: sol.mul_chain(x, tw, 1), 10),
        _cuda_ms(torch, lambda: sol.mul_chain_plain(x, tw, 1), 1),
        _bound(4 * (2 * ilp * n + n), steps * SOL_MUL_STEP_OPS),
        {"shape": [ilp, n], "reps": 1, "roof_mul_op_s": report["roofs"]["mul"]})
    del x, tw
    x = sol.alu_operands(n, dev)
    err = _max_abs_err(torch, sol.alu_chain(x, 1), sol.alu_chain_plain(x, 1))
    row("sol_alu_probe", err, _cuda_ms(torch, lambda: sol.alu_chain(x, 1), 10),
        _cuda_ms(torch, lambda: sol.alu_chain_plain(x, 1), 1),
        _bound(8 * ilp * n, steps * SOL_ALU_STEP_OPS),
        {"shape": [ilp, n], "reps": 1, "roof_alu_op_s": report["roofs"]["alu"]})
    del x
    x = torch.arange(SOL_STREAM_N, dtype=torch.int32, device=dev)
    y, z = x.clone(), torch.empty_like(x)
    err = _max_abs_err(torch, sol.stream_step(x), sol.stream_step_plain(y))
    library_ms = _cuda_ms(torch, lambda: torch.add(y, 1, out=z), 10)
    row("sol_hbm_probe", err, _cuda_ms(torch, lambda: sol.stream_step(x), 10),
        _cuda_ms(torch, lambda: sol.stream_step_plain(y), 10), _bound(8 * SOL_STREAM_N, SOL_STREAM_N),
        {"shape": [SOL_STREAM_N], "library_ms": round(library_ms, 6), "roof_hbm_b_s": report["roofs"]["hbm"]})
    parts[-1] += f", torch.add {library_ms:.4f} ms"
    del x, y, z
    torch.cuda.synchronize()
    bad = {name: results[name][0] for name in ("sol_mul_probe", "sol_alu_probe", "sol_hbm_probe")
           if results[name][0]}
    if bad:
        raise AssertionError(f"SoL probe != its plain twin: {bad}")
    return "; ".join(parts)


def _phase23_sol(torch, port, dev, seen, smi: str, results):
    """The speed-of-light report (``bench/sol.py``) at full size on the
    card (the main path: launch counts reset just before it, read just
    after, its operand shapes noted): every roof > 0, the stream roof at
    most the data sheet's 3.35 TB/s, every probe launched, each of the 9
    kernels scored in (0, 100] on a roof or flagged; its compact block as
    ``bench.ntt`` prints it; each probe against its plain twin; then
    ``bench.hash``'s two lines and ``bench.narrow_ntt``'s seven shapes, its
    two routes bit-identical, each twin a path of its own (``bench-hash``,
    ``bench-narrow-ntt``: counts reset just before it, read just after, its
    operand shapes noted for phase 13).  Returns (the phase's lines,
    {path: launches})."""
    kernels, sol = port.kernels, port.sol
    t_phase = time.perf_counter()

    def quiet(fn, *args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
        return out, buf.getvalue().splitlines()

    def sol_run():
        report, report_lines = quiet(sol.run, False, dev)
        return (report, report_lines, sol.run_quotient_partitions(report["roofs"], device=dev),
                sol.run_open(report["roofs"], device=dev))

    t0 = time.perf_counter()
    with _record_shapes(port, seen, "sol"):
        (report, report_lines, q_parts, o_parts), launches = _drive(
            kernels, sol_run,
            kernels.SOL_PROBES + (kernels.NTT_PASS0, kernels.NTT_PASS, kernels.KECCAK_SPONGE,
                                  kernels.POSEIDON2_SPONGE, kernels.QUOTIENT_EVAL, kernels.FRI_FOLD))
    sol_s = time.perf_counter() - t0
    roofs = report["roofs"]
    if sorted(roofs) != ["alu", "hbm", "mul"] or not all(v > 0 for v in roofs.values()):
        raise AssertionError(f"SoL roofs {roofs}: each must be > 0")
    if roofs["hbm"] > HBM_BYTES_PER_S:
        raise AssertionError(f"the stream roof {roofs['hbm']:.4g} B/s is above the data sheet's {HBM_BYTES_PER_S:.4g}")
    names = [k["kernel"] for k in report["kernels"]]
    if len(names) != 9:
        raise AssertionError(f"the SoL report scored {names}, not the 9 kernels of JAX's list")
    for k in report["kernels"]:
        if k["sol_pct"] is None:
            if not k.get("hbm_model_exceeds_roof"):
                raise AssertionError(f"{k['kernel']}: unscored and not flagged")
        elif not (0 < k["sol_pct"] <= 100.0 + 1e-9 and k["binding"] in roofs):
            raise AssertionError(f"{k['kernel']}: sol_pct {k['sol_pct']} on {k['binding']}")
    if [k["kernel"] for k in q_parts] != [f"quotient_{p}_2^20" for p in sol.QUOTIENT_PARTITIONS] or not all(
            k["sol_pct"] is None or 0 < k["sol_pct"] <= 100.0 + 1e-9 for k in q_parts):
        raise AssertionError(f"K7's SoL lines {q_parts}")
    if [k["kernel"] for k in o_parts] != ["fri_fold_2^22"] or not all(
            k["sol_pct"] is None or 0 < k["sol_pct"] <= 100.0 + 1e-9 for k in o_parts):
        raise AssertionError(f"K11's SoL line {o_parts}")
    q_line, o_line = (" | ".join(
        f"{k['kernel']} {k['melems_s']:.1f} Mrows/s, " + (f"{k['sol_pct']:.1f} % ({k['binding']})"
                                                          if k["sol_pct"] is not None else "n/a")
        + f", utils {json.dumps({r: round(v, 2) for r, v in k['utils'].items()})}"
        + (f" (audit: {k['audit']})" if "audit" in k else "") for k in parts)
        for parts in (q_parts, o_parts))
    compact = port.bench_ntt.sol_compact(report)
    probes = _sol_probe_rows(torch, port, dev, report, results)

    with _record_shapes(port, seen, "bench-hash"):
        (_out, hash_lines), hash_launches = _drive(
            kernels, lambda: quiet(port.bench_hash.main, ["--device", str(dev)]),
            (kernels.KECCAK_SPONGE, kernels.POSEIDON2_SPONGE))
    n, r = port.bench_hash.N, port.bench_hash.R
    if len(hash_lines) != 2 or not (hash_lines[0].startswith(f"keccak leaf sponge  (N={n}, 6 u32, R={r}):")
                                    and hash_lines[1].startswith(f"poseidon2-16        (N={n}, R={r}):")):
        raise AssertionError("bench.hash's lines are not bench_hash.py's two:\n" + "\n".join(hash_lines))
    with _record_shapes(port, seen, "bench-narrow-ntt"):
        (_out, narrow_lines), narrow_launches = _drive(
            kernels, lambda: quiet(port.bench_narrow_ntt.main, ["--device", str(dev)]),
            (kernels.NTT_PASS0, kernels.NTT_PASS, kernels.MXU_MM))
    shapes = port.bench_narrow_ntt.SHAPES
    if sum(ln.strip().startswith("speedup") and "bit-identical" in ln for ln in narrow_lines) != len(shapes):
        raise AssertionError("bench.narrow_ntt did not print its seven shapes:\n" + "\n".join(narrow_lines))
    used = {name: c for name, c in launches.items() if c}
    lines = [
        f"[23] the SoL report on {smi} ({sol_s:.1f}s; launches {used}): " + " | ".join(report_lines),
        f"[23] K7 at one keccak-air partition of each DAG, 2^20 rows (sol.run_quotient_partitions): {q_line}",
        f"[23] K11 at 2^22 rows (sol.run_open; K9 is held to its own bound in phase 25): {o_line}",
        f"[23] sol_pct_of_roof {json.dumps(compact)}",
        f"[23] probes == plain (exact): {probes}",
        "[23] bench.hash: " + " | ".join(hash_lines)
        + f"; launches {({k: c for k, c in hash_launches.items() if c})}",
        "[23] bench.narrow_ntt: " + " | ".join(ln.strip() for ln in narrow_lines)
        + f"; launches {({k: c for k, c in narrow_launches.items() if c})}; phase 23 took "
        f"{time.perf_counter() - t_phase:.3f}s",
    ]
    return "\n".join(lines), {"sol": launches, "bench-hash": hash_launches, "bench-narrow-ntt": narrow_launches}


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
    q_texts, q_names = {}, {}
    for label, air_q, npis in (("fib", FibonacciAir(), 3), ("chain", poseidon2_air.Poseidon2ChainAir(), 32),
                               ("keccak-air", keccak_air.KeccakAir(), 0)):
        for prog in port.quotient_kernel.programs(air_q, npis):
            q_texts.setdefault(prog.dag.key, port.quotient_kernel.source(prog.dag))
            q_names.setdefault(prog.dag.key, f"{label} {prog.name}")
    q_builds = {}
    q_thread = threading.Thread(target=lambda: q_builds.update(kernels.build_generated(q_texts, force=True)))
    q_thread.start()  # K7's nvcc processes run beside the library's
    build = kernels.build(force=True)
    q_thread.join()
    if set(q_builds) != set(q_texts):
        raise RuntimeError("K7's generated kernels did not all build")
    kernels.lib()
    if native.get_lib() is None:
        raise RuntimeError("the C host helper (tpu_stark_torch/csrc/host) did not build")
    regs = [ln.strip() for ln in build.log.splitlines() if "registers" in ln]
    q_regs = []
    for key, res in sorted(q_builds.items(), key=lambda kv: q_names[kv[0]]):
        used = [ln.split("Used", 1)[1].strip() for ln in res.log.splitlines() if "Used" in ln]
        spills = [ln.strip() for ln in res.log.splitlines() if "spill" in ln and "0 bytes spill" not in ln]
        q_regs.append(f"{q_names[key]} ({key}) {res.seconds:.1f}s: {'; '.join(used)}{' ' + str(spills) if spills else ''}")
    print(f"[1] device {kind!r}; nvidia-smi: {smi}; nvcc build {build.seconds:.2f}s, K7's {len(q_builds)} generated "
          f"libraries (fib, the chain, keccak-air) beside it, the last done {max(r.seconds for r in q_builds.values()):.2f}s "
          f"(all builds {time.perf_counter() - t0:.2f}s); ptxas: {' | '.join(regs)}; K7 ptxas by DAG: "
          f"{' | '.join(q_regs)}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand_u32(shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    def rand_monty(shape):
        return torch.randint(0, bb.P, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    def misaligned(n, k):
        """(n, k) contiguous Monty rows whose base is 4 bytes past a 16-byte boundary."""
        return rand_monty((n * k + 1,))[1:].view(n, k)

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
    err = 0
    for log_n in range(1, 24):  # the fib prove's trees: 2^23 and 2^22 leaves, FRI 2^23 .. 2^2
        d = rand_u32((1 << log_n, 4, 2))
        got = torch.cat(keccak_kernel.compress_levels(d, log_n))
        want = torch.cat(keccak_kernel.compress_levels_plain(d, log_n))
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(torch, got, want))
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"K1 tree over 2^{log_n} digests: kernel != plain (max_abs_err {err})")
    ms = _cuda_ms(torch, lambda: keccak_kernel.compress_levels(d, log_n), 10)
    plain_ms = _cuda_ms(torch, lambda: keccak_kernel.compress_levels_plain(d, log_n), 1)
    plan = keccak_kernel.tree_plan(log_n, log_n)
    bound_ms, bound_by = _tree_bound(1 << log_n, log_n)
    results["keccak_tree"] = (err, ms, plain_ms, bound_ms, bound_by, {"shape": [1 << log_n, 4, 2], "plan": plan})
    k1_lines.append(f"compress_levels exact at 2^1..2^{log_n} digests; the tree over 2^{log_n} ({len(plan)} "
                    f"launches): {ms:.4f} ms vs plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms")
    del d, got, want
    print("[2] K1 keccak sponge == plain (exact): " + "; ".join(k1_lines), flush=True)

    # -- 3. K2 vs plain --------------------------------------------------------
    print(_phase3_k2(torch, port, rand_monty, results, dev), flush=True)

    # -- 24. K7 and K8 vs plain ------------------------------------------------
    print(_phase24_quotient(torch, port, rand_monty, results), flush=True)

    # -- 25. K9, K10 and K11 vs plain -------------------------------------------
    print(_phase25_open(torch, port, rand_monty, results), flush=True)
    torch.cuda.empty_cache()

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
            kernels, warm_fib, (kernels.KECCAK_SPONGE, kernels.KECCAK_TREE, kernels.NTT_PASS0, kernels.NTT_PASS,
                                kernels.QUOTIENT_EVAL))
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
        ("leaf (4097, 12)", rand_monty((4097, 12)), None),
        ("leaf (4097, 128) on a misaligned base", misaligned(4097, 128), None),
        ("leaf (4097, 127) read through a column slice", rand_monty((4097, 128))[:, 1:], None),
        ("compress 1048576 pairs", rand_monty((1 << 20, 8)), rand_monty((1 << 20, 8))),
        ("compress 4097 pairs, left misaligned", misaligned(4097, 8), rand_monty((4097, 8))),
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
                err, ms, plain_ms, *_bound(a.numel() * 4 + a.shape[0] * 32, perms * POSEIDON2_PERM_OPS),
                {"shape": list(a.shape)})
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
            kernels, warm_chain, (kernels.NTT_PASS0, kernels.NTT_PASS, kernels.POSEIDON2_SPONGE, kernels.QUOTIENT_EVAL))
    chain_peak = torch.cuda.max_memory_allocated(dev)
    blob = serialize_proof(proof)
    chain_len = _check_jax_length("chain 2^18", blob)
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
          f"({phases}); verify {chain_verify_s:.3f}s ok; proof {chain_len}; launches "
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
    # a misaligned chunk and state, chunks 64 + 64 + 20
    mis_chunk, mis_state = misaligned(4097, 148), misaligned(4097, 16)
    mis_want = mis_state.clone()
    off = 0
    for wc in (64, 64, 20):
        poseidon2_kernel.absorb_rows(mis_state, mis_chunk[:, off : off + wc])
        poseidon2_kernel.absorb_rows_plain(mis_want, mis_chunk[:, off : off + wc])
        off += wc
    torch.cuda.synchronize()
    err_b = max(err_b, _max_abs_err(torch, mis_state, mis_want))
    if err_b != 0:
        raise AssertionError(f"K4 (4097, 148) misaligned, in chunks: kernel != plain (max_abs_err {err_b})")
    k4_ms = _cuda_ms(torch, lambda: poseidon2_kernel.absorb_rows(got, chunk), 5)
    k4_plain_ms = _cuda_ms(torch, lambda: poseidon2_kernel.absorb_rows_plain(want, chunk), 1)
    perms = chunk.shape[0] * chunk.shape[1] // poseidon2_kernel.RATE
    results["poseidon2_absorb"] = (
        max(err_a, err_b), k4_ms, k4_plain_ms,
        *_bound(chunk.numel() * 4 + 2 * carried.numel() * 4, perms * POSEIDON2_PERM_OPS),
        {"shape": list(chunk.shape)},
    )
    del a, got, want, chunk, carried, one_shot
    print(f"[10] K4 poseidon2 absorb == plain (exact): (65536, 493) in chunks 128+128+128+109 "
          f"== plain == one-shot K3; (4097, 148) with a misaligned chunk and state in chunks "
          f"64+64+20; (2097152, 128) on a carried state: {k4_ms:.4f} ms vs plain "
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
            kernels.NTT_PASS0, kernels.NTT_PASS, kernels.POSEIDON2_SPONGE, kernels.POSEIDON2_ABSORB,
            kernels.QUOTIENT_EVAL, kernels.PANEL_FOLD))
    k_peak = torch.cuda.max_memory_allocated(dev)
    blob = serialize_proof(proof)
    k_len = _check_jax_length("keccak-air 2^20", blob)
    SINGLE_DEVICE_SHA256["keccak-air 2^20"] = hashlib.sha256(blob).hexdigest()
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
          f"verify {k_verify_s:.3f}s ok; proof {k_len}; launches {k_launches}; peak device memory "
          f"{k_peak / 2**30:.3f} GiB (trace included); on {smi}", flush=True)

    del k_trace, proof, blob

    # -- 14. K5 vs plain, the narrow route vs K2 --------------------------------
    print(_phase14_mxu(torch, port, rand_monty, results), flush=True)

    # -- 15. device rng vs JAX, the grind kernel vs plain ------------------------
    print(_phase15_rng_grind(torch, port, dev, results), flush=True)

    # -- 16. BASELINE config 2 ----------------------------------------------------
    line, c2_launches = _phase16_config2(torch, port, dev, seen, 20)
    print(line, flush=True)

    # -- 17. the app, the DFT harness and the prove twins -------------------------
    line, app_launches = _phase17_app_bench(torch, port, kind, seen)
    print(line, flush=True)

    # -- 18. K1's carried-state absorb vs plain ----------------------------------
    print(_phase18_absorb(torch, port, rand_u32, rand_monty, results), flush=True)

    # -- 19. the zk wide fixture on the card --------------------------------------
    print(_phase19_zk_fixture(torch, port, dev), flush=True)

    # -- 20. keccak-air at 2^20 x 3608 on the reference's stack, zk -----------------
    line, zk_launches = _phase20_zk_wide(torch, port, dev, seen, smi)
    print(line, flush=True)

    # -- 21. config 2 in low-memory mode at 2^24 (levers off and on) and 2^25 ----------
    line, lm_launches = _phase21_lowmem(torch, port, dev, seen, smi)
    print(line, flush=True)

    # -- 22. the sharded prover: config 2 over NCCL, BASELINE config 5 over four ranks, the dry run ------
    line, sharded_launches = _phase22_sharded(torch, port, dev, seen, smi)
    print(line, flush=True)

    # -- 23. the speed-of-light report and the last two bench twins -------------
    line, sol_launches = _phase23_sol(torch, port, dev, seen, smi, results)
    print(line, flush=True)

    # -- 13. every kernel vs plain at every shape of the main paths -------------
    path_launches = {"fib": fib_launches, "chain": chain_launches, "keccak-air": k_launches, **c2_launches,
                     **app_launches, "keccak-air-zk": zk_launches, "config2-lowmem": lm_launches,
                     **sharded_launches, **sol_launches}
    plain_q = sorted(path for key, paths in seen.items() if key[0] == "plain_quotient" for path in paths)
    if plain_q:
        raise AssertionError(f"a plain quotient version ran on the card on the paths {plain_q}")
    plain_o = sorted(path for key, paths in seen.items() if key[0] == "plain_open" for path in paths)
    if plain_o:
        raise AssertionError(f"a plain open version ran on the card on the paths {plain_o}")
    for path, launches in path_launches.items():
        if path not in ("bench-hash", "bench-narrow-ntt") and launches["quotient_eval"] <= 0:
            raise AssertionError(f"{path}: proved without launching K7")
        unopened = [k for k in OPEN_KERNEL_NAMES if launches[k] <= 0]
        if path not in ("bench-hash", "bench-narrow-ntt", "sol") and unopened:
            raise AssertionError(f"{path}: proved without launching {unopened}")
    probe_names = {info.name for info in kernels.SOL_PROBES}  # held to their twins in phase 23
    for path, launches in path_launches.items():
        noted = {name for key, paths in seen.items() if path in paths for name in _SHAPE_KERNELS[key[0]]}
        missing = [name for name, n in launches.items() if n > 0 and name not in noted and name not in probe_names]
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
    noted_levels = {(k[1], k[2], k[3], k[4]) for k in seen if k[0] == "mod_matmul_twiddle_moved"
                    and "config2-mxu" in seen[k]}
    want_levels = {key for key in config2_levels() if key[1] > 1}
    if noted_levels != want_levels:
        raise AssertionError(f"config 2's inner K5 levels {sorted(noted_levels)} are not phase 14's {sorted(want_levels)}")
    mxu_shapes = ", ".join(
        f"({k[1]}, {k[2]})" for k in sorted(seen) if k[0] == "mod_matmul_axis" and "config2-mxu" in seen[k])
    mxu_shapes += "; inner levels (B, A, R): " + ", ".join(
        f"({b}, {a}, {r}){' inv' if inv else ''}" for b, a, r, inv in sorted(noted_levels))
    absorb_shapes = ", ".join(
        f"{k[0][7:]} ({k[1]}, {k[5]} + {k[2]}{' Montgomery' if k[10] else ''}{' natural' if k[11] else ''})"
        for k in sorted(seen) if k[0] in ("keccak_absorb", "keccak_finalize") and "keccak-air-zk" in seen[k])
    print(f"[13] K1's absorb at the zk wide prove's operands (pending + new words, their form): {absorb_shapes}",
          flush=True)
    lowmem_shapes = ", ".join(
        f"{k[0]} {k[1:3]}" for k in sorted(seen) if seen[k] == {"config2-lowmem"} and k[0] != "grind_verdicts")
    print(f"[13] operand shapes that only phase 21's prove gave: {lowmem_shapes}", flush=True)
    sharded_shapes = ", ".join(
        f"{k[0]} {k[1:3]}" for k in sorted(seen) if seen[k] <= set(sharded_launches) and k[0] != "grind_verdicts")
    print(f"[13] operand shapes that only phase 22's ranks gave: {sharded_shapes}", flush=True)
    twin_shapes = ", ".join(f"{k[0]} {k[1:]}" for k in sorted(seen, key=repr)
                            if seen[k] & {"bench-hash", "bench-narrow-ntt"})
    print(f"[13] operand shapes of phase 23's twins (bench-hash, bench-narrow-ntt): {twin_shapes}", flush=True)
    print(f"[13] every kernel == plain (exact) at the {len(seen)} operand shapes of the main paths and phase 17 "
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
            "launches_by_path": {path: launches[info.name] for path, launches in path_launches.items()
                                 if launches[info.name]},
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
