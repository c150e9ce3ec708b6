#!/usr/bin/env python3
"""Timing tools for the PyTorch + CUDA port (``tpu_stark_torch``) on one GPU.

    python3 port_timing.py profile [--workload keccak|keccak-zk|chain|fib|config2] [--log-n N] [--tree DIR] [--reps 4]
                                   [--lowmem-log N]
    python3 port_timing.py warm [--tree DIR | --pcs-from DIR] [--reps 4]
    python3 port_timing.py verify [--log-n 20] [--pcs-from DIR]
    python3 port_timing.py k2 [--tree DIR]
    python3 port_timing.py p2 [--tree DIR]
    python3 port_timing.py k1 [--tree DIR]
    python3 port_timing.py grind [--tree DIR]
    python3 port_timing.py k5 [--tree DIR] [--phases]
    python3 port_timing.py k7 [--tree DIR] [--sass-out DIR]
    python3 port_timing.py k8 [--tree DIR]
    python3 port_timing.py open [--tree DIR]
    python3 port_timing.py sass [--tree DIR | --from FILE]
    python3 port_timing.py probe
    python3 port_timing.py wgmma

Run from the root of a checkout on a machine with a CUDA device.  Each
subcommand prints the card (nvidia-smi name and power limit) first.

* ``profile``: proves BASELINE config 4 (keccak-air, Poseidon2 stack, zk
  off, blowup 2, 100 queries, 16 PoW bits) at 2^log_n rows (``--workload
  chain``: the Poseidon2 chain, BASELINE config 3, at 2^log_n x 493, default
  2^18; ``fib``: fib_air zk at 2^20 on the Keccak stack, cell 1; ``config2``:
  BASELINE config 2 at 2^20 with ``narrow_ntt="mxu"``; ``keccak-zk``:
  keccak-air through ``prove_wide`` on the reference's stack, Keccak trees
  and zk with the device rng, benchmark FRI) once cold (the
  kernels' build included), ``reps`` times warm and
  unprofiled, then once under ``torch.profiler``, and prints every prove's
  wall clock and phase times, the warm proves' median, the profiled prove's
  summed device time and the device's idle share of that wall clock, the
  number of device kernels and copies, each hand-written kernel's device
  time and launches beside the summed bound of those launches (the bound of
  this tree's ``chip_smoke.py``, also with ``--tree``, computed from each
  call's operands) and the loss,
  time minus bound, K1's device time and launches split by rows per launch
  (the profiled prove's K1 kernels in launch order, each matched to the
  rows its launch took, in buckets < 2^12, 2^12-2^16 and >= 2^16 rows;
  beside it the stream time between CUDA events around each launch, which
  also holds the host's launch path where the card waits for it), and the
  20 ops with the most device time, and the device time by phase (every
  device kernel and copy attributed to the phase whose end mark follows
  its start; each phase's 5 costliest ops); K6 (the device rng's sample),
  K7 (the quotient's constraint evaluation and fold), K8 (its panel coset
  fold) and K9-K11 (the open phase's reduced opening, point evaluations
  and FRI fold) are among the hand-written kernels (an older tree without
  them shows 0 launches).  It also times the device rng's samples
  (every ``_sample_monty`` call: the salts, the random codewords and, in zk
  wide proves, the trace randomizer that every pass over the chunks
  regenerates; K6, or in an older tree the plain-torch Threefry) with CUDA
  events around each call on the prove's stream, and prints its calls, its
  stream time and its share of the profiled prove's device time and wall
  clock.  Each prove's proof SHA-256 is printed, so that two trees'
  bytes compare.  The
  profiler's own host cost lengthens the profiled wall clock, so the idle
  share is an upper bound.  Every prove's phases carry the peak device
  memory allocated within each (``max_memory_allocated``, reset at each
  phase boundary), so the phase that sets a prove's peak shows; the cold
  prove runs under ``torch.cuda.memory``'s history, whose allocations
  replayed give the tensors alive at its peak, largest first, with the
  port's lines that allocated them.  ``--lowmem-log N`` passes
  ``create_config(lowmem_log=N)`` to ``fib`` and ``config2`` (0: the
  low-memory levers off).  ``--tree DIR`` profiles DIR's
  ``tpu_stark_torch`` (as for ``warm``).
* ``warm``: one cold and ``reps`` warm proves each of fib_air zk at 2^20
  (Keccak stack) and the Poseidon2 chain at 2^18 x 493 (BASELINE config 3),
  with phase times; the chain's trace generation is timed on its own.  Then
  BASELINE config 2 (fib_air zk at the defaults: device zk rng, blowup 2,
  100 queries, 16 PoW bits) at 2^20 on its two NTT routes, ``narrow_ntt=
  "mxu"`` (K5) and ``None`` (K2): one cold prove each, then ``reps`` rounds
  of warm proves in the order mxu, K2, K2, mxu, and each route's median.
  ``--tree DIR`` imports ``tpu_stark_torch`` from DIR instead (a
  ``git archive`` of another commit), so that two commits are compared in
  one chip call: parent, change, change, parent.  ``--pcs-from DIR`` keeps this
  tree but takes ``TwoAdicFriPcs.open`` from DIR's
  ``tpu_stark_torch/commit/pcs.py``, to tell the open phase's share of a
  difference from the rest.
* ``k2``: times K2 (``ntt_kernel.dft``, CUDA events, L2 flushed before
  each launch where the matrix would fit in it) at the main paths' shapes
  (2^21, 128), (2^20, 128) inverse, (2^18, 257) and (2^23, 2), against the
  whole transform's bound (one HBM read and write of the matrix), under
  the default plan and the alternatives the kernel can run: 16- and 32-word
  tile rows at every stage cap that fits a block's shared memory, each
  held equal to the default's result (``ntt_kernel.split``).  With
  ``--tree DIR`` of an older commit, which has no ``split``, only the
  default.
* ``p2``: times K3 (``poseidon2_kernel.hash_rows`` / ``compress``) and K4
  (``absorb_rows``) with CUDA events at the main paths' shapes: (2^21, 128)
  absorbed on a carried state, leaves (2^16, 493), (2^20, 493) and (2^21,
  16), 2^20 compress pairs; prints each time, the rate in permutations per
  second and the SHA-256 of each output (inputs from a fixed seed, so two
  trees' outputs compare by their hashes), and checks (2^16, 493) and a
  (4096, 128) absorb against the plain versions.  ``--tree DIR`` as for
  ``warm``: run parent, change, change, parent in one chip call.
* ``k1``: times K1 with CUDA events at the main paths' shapes: leaves
  (2^20, 6), (2^23, 6) and (2^22, 8), 2^20 compress pairs (8 + 8 words),
  the compress layers of trees over 2^23, 2^16 and 2^10 digests (one
  ``compress_levels`` call, or in a tree without it one ``hash_rows`` launch
  per layer), and the grind kernel over a 2^17-candidate chunk; prints each
  time beside the issue-rate bound and the SHA-256 of each output (inputs
  from a fixed seed, so two trees' outputs compare by their hashes).  In a
  tree with ``keccak_kernel.run_plan`` it also times the 2^23 and 2^16
  trees under the alternative launch plans ``K1_TREE_PLANS``, each held
  equal to the default's layers.  ``--tree DIR`` as for ``warm``.
* ``grind``: ``k1``'s last step alone: the grind kernel over a
  2^17-candidate chunk of a 100-byte transcript, held equal to the plain
  verdicts, timed as issued and queued behind a spin of the device, each
  the median of ``GRIND_TIMINGS`` timings of 20 launches, beside its bound
  and its ALU-pipe model.  ``--tree DIR`` as for ``warm``.
* ``k5``: K5, the limb-matmul DFT.  nvcc's time and ptxas's report for
  ``mxu_ntt.cu`` alone; one BASELINE config 2 prove at 2^20 on the narrow
  route with its transforms noted; then every level (B, A, R) of those
  transforms (an inner level through ``mod_matmul_twiddle_moved``, or in a
  tree without it the product, ``bb.mul`` by the twiddles and the moved
  axis as a copy; the leaf through ``mod_matmul_axis``) and the leaves of
  ``chip_smoke.py``'s phase 14, each timed with CUDA events beside its
  bound (``chip_smoke.k5_bound``) with the SHA-256 of its output (inputs
  from a fixed seed, so two trees' outputs compare by their hashes); the
  narrow route against K2 at phase 14's five shapes; the prove's route
  transforms (``dft_axis0``, each as often as a prove runs it) under
  ``torch.profiler``: K5's device time and launches, and every other
  kernel or copy they launch; and, as a yardstick only (not K5's
  function), ``torch._int_mm`` at the volume of K5's 16 limb products at
  (256, 65536).  ``--tree DIR`` as for ``warm``.  ``--phases`` also builds
  ``mxu_ntt.cu`` alone with ``-DMXU_PHASE_CLOCKS`` and prints, at
  ``K5_PHASE_SHAPES``, each phase's share of the warpgroups' SM clocks
  (raw wait and split, wgmma products with the next tile's cp.async issue
  inside their window, epilogue and stores).
* ``k7``: where K7's time goes.  Builds, beside each constraint DAG of fib,
  the chain and keccak-air as the tree generates it (``base``), variants of
  its source (``K7_VARIANTS``: the phase functions out of line, the
  constraint code replaced by one fold a phase (staging, ring and store
  left: the staging-only time), the copies into the ring skipped (compute
  on whatever shared memory holds: the evaluation-only time)), prints
  each kernel's plan (row groups x consumer warps + producer warps, one
  row a lane, ring depth, phases and quads a row, shared memory), its
  ptxas registers, its SASS count and its local-memory, shared-memory and
  global loads
  (``cuobjdump``; ``--sass-out DIR`` also writes each DAG's listing as
  generated to DIR/k7_<program>_<key>.sass), the blocks an SM holds (the
  library's ``init``: ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
  and each variant's device time (``torch.profiler``, 10 launches; CUDA
  events around them where the profiler returns no kernel event) beside its
  bound at ``chip_smoke.py`` phase 24's calls (fib and the chain as the
  dense pass, keccak-air's DAGs as a streamed last block); variants that
  compute the same function are held to the plain version first.
  ``--tree DIR`` of an older commit, whose header takes none of the
  variants: its kernels as its generator emits them, through its own
  wrapper, at the same shapes and inputs (parent and change in one chip
  call).
* ``k8``: K8, the panel coset fold, at ``chip_smoke.K8_COSETS`` (phase
  24's four cosets at 2^20 rows): ptxas's registers and stack frame of each
  ``panel_fold_kernel<R, F, V>`` instance, then each coset's fold (one
  launch, or in an older tree one launch a block) timed with CUDA events
  (the launches queued behind a spin of the device) and under
  ``torch.profiler`` beside ``chip_smoke.panel_fold_bound``, with
  the SHA-256 of the (r, m, u) panels (inputs from a fixed seed, so two
  trees' outputs compare by their hashes).  ``--tree DIR`` as for
  ``warm``.
* ``open``: K9 and K10 at ``chip_smoke.py`` phase 25's shapes
  (``chip_smoke.OPEN_ROWS``: config 2 at 2^24, cell 6's chunk and
  division, the chain, a rank block; K9 also at two points), on inputs
  from a fixed seed: each row's time by CUDA events over 10 launches
  queued behind a spin of the device (``chip_smoke._cuda_ms``), the host's
  time to issue them (the wrapper's Python and the launch, no
  synchronize), the device time of the kernels alone (``torch.profiler``,
  the same 10 calls), the bound at that shape
  (``chip_smoke.open_row_bound``), and the SHA-256 of the output, so that
  two trees compare.  A tree whose K9 takes one point a launch (``--tree``
  of an older commit) runs a two-point row as two launches, the second on
  alpha powers scaled on the device first (not timed).
* ``sass``: builds the kernels of this tree (``--tree DIR``: of DIR) with
  nvcc, prints the build time, ptxas's register and spill report, and the
  SASS instruction mix of K4 (``p2_absorb_kernel``) and K3
  (``p2_sponge_kernel<8>``) by class, per permutation: the static count of
  the chunk loop's body, with any loop inside it weighted by its trip count
  (the rolled round loops: 4, 13 and 4); and of K1's kernels
  (``keccak_rows_kernel``, ``keccak_tree_kernel``, ``keccak_absorb_kernel``,
  ``keccak_grind_kernel``)
  per round: the body of the innermost loop with the most LOP3 (the rolled
  round loop, one round a trip), and per permutation 24 rounds.  Then it runs ``probe`` and
  prints each kernel's per-pipe bound at its table shape (K4 absorbing
  (2^21, 128), K3 hashing (2^16, 493) leaves, K1 hashing (2^20, 6)
  leaves): the permutations times the
  larger of the FMA pipe's slots (IMAD.WIDE and IMAD.HI take two) over the
  rate ``IMAD only`` reached and the ALU pipe's instructions over the rate
  ``IADD3 only`` reached, at the card's SM count and the clock the probe
  ran at.  For K1's kernels, whose ALU work is all LOP3 and SHF, it prints
  a per-pipe model instead: the ALU pipe's instructions over the rate
  ``LOP3 + SHF.L.W, even`` reached, at the clock that run measured (a
  model, not a bound: the kernel's own clock is not read).  The whole dump goes to ``tpu_stark_torch/build/sass_<tree>.txt``;
  ``--from FILE`` re-reads such a dump without a card (no bound).
* ``probe``: the integer pipes of the card.  Builds thirteen kernels of long
  independent dependency chains (``IADD3`` only, ``IMAD`` only, an even mix
  of the two, ``IMAD.WIDE`` only, ``IMAD.HI`` only, ``VIADDMNMX`` only,
  the kernels' reduced Montgomery product, ``LOP3`` only (chi's
  a ^ (~b & c)), ``SHF.L.W`` only (funnel shifts), even mixes of LOP3 with
  IMAD, with IMAD.HI and with SHF, and three LOP3 chains beside one chain
  of a 64-bit rotation's half in its FMA-pipe form, hi(l 2^s) + h 2^s by
  IMAD and IMAD.HI with 2^s a kernel argument), runs each with every block
  resident
  at once, and prints what each class reached, in results per SM per SM
  clock (clock64 in the kernel), from each kernel's SASS loop body.
* ``wgmma``: the u8 wgmma's throughput on the card, by shape (m64n16k32,
  m64n32k32, m64n64k32) and operand source (both in shared memory, or A in
  registers), with K5's pattern of 16 products into 7 accumulators (see
  ``wgmma``'s docstring): what bounds K5's product.
* ``verify``: proves config 4 at 2^log_n rows and times the port's
  ``verify`` of it twice; with ``--pcs-from DIR`` it then times it once
  more with ``TwoAdicFriPcs.verify`` taken from DIR's
  ``tpu_stark_torch/commit/pcs.py`` (the PCS verifier of another commit,
  on the same proof).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD_OUT = os.path.join(ROOT, "tpu_stark_torch", "build")  # git-ignored
TOP = 20


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _phases(timings) -> str:
    peak = getattr(timings, "peak", {})
    return ", ".join(f"{k} {v:.3f}s" + (f" {peak[k]:.3f} GiB" if k in peak else "") for k, v in timings.items())


class _PhasePeaks(dict):
    """A prove's ``timings`` whose every entry also notes the peak device
    memory allocated since the previous one (from an emptied cache and a
    reset peak)."""

    def __init__(self, torch, dev):
        import gc

        super().__init__()
        self._torch, self._dev, self.peak = torch, dev, {}
        torch.zeros(1, device=dev)  # the allocator's statistics exist once CUDA is initialized
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def __setitem__(self, phase, seconds):
        super().__setitem__(phase, seconds)
        self.peak[phase] = self._torch.cuda.max_memory_allocated(self._dev) / 2**30
        self._torch.cuda.reset_peak_memory_stats(self._dev)
        with self._torch.profiler.record_function(f"{PHASE_MARK}{phase}"):  # the phase's end, under a profiler
            pass

    def top(self) -> str:
        phase = max(self.peak, key=self.peak.get)
        return f"peak {self.peak[phase]:.3f} GiB in {phase}"


def _timed(torch, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _chip_smoke():
    """This tree's chip_smoke.py (its bounds), whatever --tree put first on
    sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keccak_setup(dev, log_n: int, zk: bool = False):
    """keccak-air at 2^log_n rows: config 4 (Poseidon2, zk off), or with
    ``zk`` the reference's stack (Keccak, zk, the device rng)."""
    from tpu_stark_torch.air import keccak_air
    from tpu_stark_torch.fri.config import create_benchmark_fri_params
    from tpu_stark_torch.prover.config import create_config

    n = 1 << log_n
    air = keccak_air.KeccakAir()
    trace = keccak_air.generate_trace(max(1, n // keccak_air.NUM_ROUNDS), seed=1, device=dev)[:n]

    def config():
        return create_config(create_benchmark_fri_params(1), zk=zk, hash="keccak" if zk else "poseidon2",
                             device=dev)

    return air, trace, config


# the hand-written kernel -> the profiler kernel names that belong to it
KERNEL_KEYS = (
    ("K1 keccak_sponge", ("keccak_rows_kernel", "keccak_tree_kernel")),
    ("K1 keccak_absorb", ("keccak_absorb_kernel",)), ("K2 ntt_pass", ("ntt_pass_kernel",)),
    ("K3 poseidon2_sponge", ("p2_sponge_kernel",)), ("K4 poseidon2_absorb", ("p2_absorb_kernel",)),
    ("K5 mxu_mm", ("mxu_mm_kernel",)), ("grind", ("keccak_grind",)), ("K6 threefry_monty", ("threefry_monty",)),
    ("K7 quotient_eval", ("quotient_kernel",)), ("K8 panel_fold", ("panel_fold_kernel",)),
    ("K9 reduced_opening", ("reduced_opening_kernel",)),
    ("K10 eval_at_points", ("eval_points_kernel", "eval_points_sum_kernel")), ("K11 fri_fold", ("fri_fold_kernel",)),
)


class _Bounds:
    """While open, adds up ``chip_smoke.py``'s bound (ms) of every kernel
    wrapper call, by kernel, from the call's operands.  ``rows``: the
    trace's height, which prices an older tree's K8 call (one row block of
    a coset, --tree) as its share of the coset's bound."""

    def __init__(self, rows: int = 0):
        cs = _chip_smoke()
        from tpu_stark_torch.challenger import grind
        from tpu_stark_torch.compat import device_rng
        from tpu_stark_torch.hash import keccak_kernel, poseidon2_kernel
        from tpu_stark_torch.ntt import mxu_ntt, ntt_kernel

        self.ms = {}
        self.calls = {}

        def k(t):
            return 0 if t is None else int(t.shape[1])

        def keccak(a, b=None):
            n, items = int(a.shape[0]), -(-(k(a) + k(b)) // 2)
            return "K1 keccak_sponge", cs._bound(n * (k(a) + k(b)) * 4 + n * 32,
                                                 n * -(-items // keccak_kernel.RATE) * cs.KECCAK_F_OPS)[0]

        def tree(digests, levels):
            return "K1 keccak_sponge", cs._tree_bound(int(digests.shape[0]), levels)[0]

        def dft(x, inverse=False):
            h, w = int(x.shape[0]), int(x.shape[1])
            p = ntt_kernel.plan(h.bit_length() - 1, w)
            ks = [p.k0] + [kk for _, kk, _ in p.passes]
            return "K2 ntt_pass", sum(cs._bound(2 * h * w * 4, cs._ntt_ops(h * w, kk, i == 0))[0]
                                      for i, kk in enumerate(ks))

        def keccak_absorb(state, mat, first=False, pend=None, monty=False, natural=False):
            return "K1 keccak_absorb", cs.keccak_absorb_bound(int(state.shape[1]), k(pend), k(mat), first, False,
                                                              monty)[0]

        def keccak_finalize(state, pend, first=False, mat=None, monty=False, natural=False):
            return "K1 keccak_absorb", cs.keccak_absorb_bound(int(state.shape[1]), k(pend), k(mat), first, True,
                                                              monty)[0]

        def sponge(a, b=None, rate=poseidon2_kernel.RATE):
            n = int(a.shape[0])
            perms = n * -(-(k(a) + k(b)) // rate)
            return "K3 poseidon2_sponge", cs._bound(n * (k(a) + k(b)) * 4 + n * 32, perms * cs.POSEIDON2_PERM_OPS)[0]

        def absorb(state, chunk, first=False):
            n = int(chunk.shape[0])
            perms = n * -(-k(chunk) // poseidon2_kernel.RATE)
            return "K4 poseidon2_absorb", cs._bound(n * k(chunk) * 4 + 2 * n * 64, perms * cs.POSEIDON2_PERM_OPS)[0]

        def mxu(x, w):
            n = int(x.shape[0])
            return "K5 mxu_mm", cs.k5_bound(n, 1, x.numel() // n)[0]

        def mxu_level(x, w, tw):
            n, a = int(x.shape[0]), int(x.shape[1])
            return "K5 mxu_mm", cs.k5_bound(n, a, x.numel() // (n * a))[0]

        def rng(k, rows, cols, device, sel=None, row0=0, row_idx=None):
            n = rows if row_idx is None else len(row_idx)
            return "K6 threefry_monty", cs.threefry_bound(n * (cols if sel is None else len(sel)))[0]

        def verdicts(start, count, pre, tail, w_off, bits):
            return "grind", cs.grind_bound(count, int(tail.shape[0]))[0]

        def quotient_eval(prog, cur, nxt, nshift, sels, sel_off, sel_stride, pis, alpha, acc, acc_off, acc_stride,
                          add, invz):
            return "K7 quotient_eval", cs.quotient_eval_bound(prog.dag, int(cur.shape[0]), add, invz,
                                                              cs.same_panel(cur, nxt))[0]

        def panel_fold(tf, log_m, shift, r=None):
            n_coef, u, m = int(tf.shape[0]), int(tf.shape[1]), 1 << log_m
            if r is None:  # an older tree: one of the coset's rows // m blocks
                blocks = max(1, rows // m)
                return "K8 panel_fold", cs.panel_fold_bound(n_coef, u, m, blocks)[0] / blocks
            return "K8 panel_fold", cs.panel_fold_bound(n_coef, u, m, r)[0]

        self._wrap = [
            (keccak_kernel, "hash_rows", keccak), (ntt_kernel, "dft", dft),
            (poseidon2_kernel, "hash_rows", sponge),
            (poseidon2_kernel, "compress", lambda a, b: sponge(a, b, poseidon2_kernel.WIDTH)),
            (poseidon2_kernel, "absorb_rows", absorb), (mxu_ntt, "mod_matmul_axis", mxu),
            (mxu_ntt, "mod_matmul_twiddle_moved", mxu_level),
            (grind, "verdicts", verdicts), (keccak_kernel, "compress_levels", tree),
            (keccak_kernel, "absorb_rows", keccak_absorb), (keccak_kernel, "finalize_rows", keccak_finalize),
            (device_rng, "_monty_kernel", rng),
        ]
        if importlib.util.find_spec("tpu_stark_torch.air.quotient_kernel") is not None:  # not in older trees
            from tpu_stark_torch.air import quotient_kernel

            self._wrap += [(quotient_kernel, "eval_fold", quotient_eval), (quotient_kernel, "panel_fold", panel_fold)]
        if importlib.util.find_spec("tpu_stark_torch.commit.open_kernel") is not None:  # not in older trees
            from tpu_stark_torch.commit import open_kernel

            def reduced_opening(acc, mats, apows, log_h, row0=0, points=(), natural=False, ext_in=None, scales=None):
                scaled = sum(tuple(c) != (1, 0, 0, 0) for c in scales or [])
                # an older tree (--tree) passes one (z, s) pair or None
                npts = 0 if not points else 1 if isinstance(points[0][0], int) else len(points)
                return "K9 reduced_opening", cs.reduced_opening_bound(
                    int(acc.shape[0]), log_h, row0, [int(m.shape[1]) for m in mats], npts,
                    ext_in is not None, int(apows.shape[0]) if apows.dim() == 3 else 1, scaled)[0]

            def eval_at_points(coeffs, points, r0=0, out=None):
                return "K10 eval_at_points", cs.eval_at_points_bound(int(coeffs.shape[0]), int(coeffs.shape[1]),
                                                                     len(list(points)))[0]

            def fri_fold(cw, beta, log_h, row0=0, add=None):
                return "K11 fri_fold", cs.fri_fold_bound(int(cw.shape[0]), add is not None)[0]

            self._wrap += [(open_kernel, "reduced_opening", reduced_opening),
                           (open_kernel, "eval_at_points", eval_at_points), (open_kernel, "fri_fold", fri_fold)]
        self._orig = []

    def __enter__(self):
        for mod, name, bound in self._wrap:
            if not hasattr(mod, name):  # an older tree (--tree) without this wrapper
                continue
            orig = getattr(mod, name)
            self._orig.append((mod, name, orig))

            def noted(*args, _orig=orig, _bound=bound, **kw):
                key, ms = _bound(*args, **kw)
                self.ms[key] = self.ms.get(key, 0.0) + ms
                self.calls[key] = self.calls.get(key, 0) + 1
                return _orig(*args, **kw)

            setattr(mod, name, noted)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._orig:
            setattr(mod, name, orig)


PHASE_MARK = "phase_end:"
COMMIT_LABEL = "commit_op:"  # the trace commit's steps (_CommitOps)


def _device_by_phase(torch, prof) -> str:
    """The profiled prove's device time by phase: every device kernel and
    copy whose start lies between the end marks of the phase before and of
    this one (each mark follows a device synchronize, so a phase's work ends
    before its mark), each phase's 5 ops with the most device time and its
    launches of each hand-written kernel (K1 ... K11, grind)."""
    events = list(prof.events())
    marks = sorted((e.time_range.start, e.name[len(PHASE_MARK):]) for e in events if e.name.startswith(PHASE_MARK))
    on_dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith(COMMIT_LABEL)]
    parts, lo = [], float("-inf")
    for end, phase in marks:
        mine = [e for e in on_dev if lo < e.time_range.start <= end]
        by_op = {}
        for e in mine:
            by_op[e.name] = by_op.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:5]
        counts = [(label, sum(1 for e in mine if any(k in e.name for k in keys))) for label, keys in KERNEL_KEYS]
        parts.append(f"{phase} {sum(e.time_range.elapsed_us() for e in mine) / 1e6:.3f}s in {len(mine)} "
                     f"(" + "; ".join(f"{v / 1e3:.1f} ms {k[:60]}" for k, v in top) + "; launches "
                     + ", ".join(f"{k} {c}" for k, c in counts if c) + ")")
        lo = end
    return "device time by phase: " + " | ".join(parts)


K1_BUCKETS = ((0, 1 << 12, "< 2^12"), (1 << 12, 1 << 16, "2^12-2^16"), (1 << 16, 1 << 62, ">= 2^16"))


class _K1Launches:
    """While open, notes the rows of every K1 launch (each ``hash_rows``
    call and each launch of a tree's compress layers: its input digests),
    in launch order, with CUDA events around it."""

    def __init__(self, torch):
        from tpu_stark_torch.hash import keccak_kernel

        self.torch, self.kk, self.noted, self._orig = torch, keccak_kernel, [], []

    def _wrap(self, name, rows):
        orig = getattr(self.kk, name)
        self._orig.append((name, orig))
        torch = self.torch

        def timed(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args, **kw)
            end.record()
            self.noted.append((rows(*args, **kw), start, end))
            return out

        setattr(self.kk, name, timed)

    def __enter__(self):
        self._wrap("hash_rows", lambda a, b=None: int(a.shape[0]))
        if hasattr(self.kk, "_tree_launch"):  # one tree launch: its input digests
            self._wrap("_tree_launch", lambda src, n_in, *rest: int(n_in))
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig:
            setattr(self.kk, name, orig)

    def report(self, kernel_events) -> str:
        """The buckets, from the profiler's K1 kernel events (their device
        time) matched in order to the noted launches."""
        self.torch.cuda.synchronize()
        kernel_events = sorted(kernel_events, key=lambda e: e.time_range.start)
        if len(kernel_events) != len(self.noted):
            return f"K1 by rows per launch: {len(kernel_events)} kernels for {len(self.noted)} launches, not matched"
        parts = []
        for lo, hi, label in K1_BUCKETS:
            idx = [i for i, (rows, _s, _e) in enumerate(self.noted) if lo <= rows < hi]
            device = sum(kernel_events[i].time_range.elapsed_us() for i in idx) / 1e3
            stream = sum(self.noted[i][1].elapsed_time(self.noted[i][2]) for i in idx)
            parts.append(f"{label} rows: {len(idx)} launches, device {device:.3f} ms (stream {stream:.3f} ms)")
        return "K1 by rows per launch: " + "; ".join(parts)


class _RngTime:
    """While open, times every device-rng sample (``_sample_monty``: K6, or
    in an older tree the plain torch Threefry) with CUDA events around it on
    the current stream."""

    def __init__(self, torch):
        from tpu_stark_torch.compat import device_rng
        from tpu_stark_torch.prover import wide

        self.torch, self.mods, self.noted, self._orig = torch, (device_rng, wide), [], []

    def __enter__(self):
        torch = self.torch
        for mod in self.mods:
            orig = getattr(mod, "_sample_monty", None)
            if orig is None:  # an older tree (--tree) whose wide prover draws nothing
                continue
            self._orig.append((mod, orig))

            def timed(*args, _orig=orig, **kw):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = _orig(*args, **kw)
                end.record()
                self.noted.append((start, end, out.numel()))
                return out

            setattr(mod, "_sample_monty", timed)
        return self

    def __exit__(self, *exc):
        for mod, orig in self._orig:
            setattr(mod, "_sample_monty", orig)

    def report(self, device_s: float, wall_s: float) -> str:
        self.torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e, _n in self.noted)
        elems = sum(n for _s, _e, n in self.noted)
        return (f"device rng (_sample_monty): {len(self.noted)} samples, {elems} elements, "
                f"{ms:.3f} ms of stream time: {100 * ms / 1e3 / device_s:.1f}% of the device time, "
                f"{100 * ms / 1e3 / wall_s:.1f}% of the profiled wall clock")


# the streamed trace commit's steps, each wrapper run under a profiler label
# (the innermost label names a kernel): (module, attribute, label); an older
# tree's steps that this tree no longer has (the bit-reversed copy, to_u32)
COMMIT_OPS = (
    ("tpu_stark_torch.prover.wide", "commit_wide", "commit"),
    ("tpu_stark_torch.prover.wide", "WideMatrixSource.lde_chunk", "LDE"),
    ("tpu_stark_torch.prover.wide", "draw_rows", "salts"),
    ("tpu_stark_torch.prover.wide", "reverse_matrix_index_bits", "row gather"),
    ("tpu_stark_torch.matrix", "bit_reversal_perm_device", "permutation build"),
    ("tpu_stark_torch.fields.babybear", "to_u32", "to_u32"),
)


class _CommitOps:
    """While open, runs each step of ``COMMIT_OPS`` under a
    ``record_function`` label.  ``report`` splits the device time of the
    kernels launched inside ``commit_wide`` (the trace commit) by the
    innermost label around their launch and the op that launched them (an
    aten op, or for the port's own kernels the kernel's name)."""

    def __init__(self, torch):
        self.torch, self._orig = torch, []

    def __enter__(self):
        for mod_name, attr, label in COMMIT_OPS:
            owner = importlib.import_module(mod_name)
            *path, name = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            orig = owner.__dict__.get(name) if isinstance(owner, type) else getattr(owner, name, None)
            if orig is None:  # not in this tree
                continue
            self._orig.append((owner, name, orig))

            def labelled(*args, _orig=orig, _label=label, **kw):
                with self.torch.profiler.record_function(COMMIT_LABEL + _label):
                    return _orig(*args, **kw)

            setattr(owner, name, labelled)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._orig):
            setattr(owner, name, orig)

    def report(self, prof) -> str:
        """Host ops' kernels by the labels on their host stack (the
        profiler links a kernel to the aten op that launched it); the
        hand-written kernels, which no aten op launches, by the innermost
        label whose device span holds their start."""
        by_key, linked = {}, 0
        events = list(prof.events())

        def note(label, op, ms):
            t, count = by_key.get((label, op), (0.0, 0))
            by_key[(label, op)] = (t + ms, count + 1)

        for e in events:
            if not e.kernels:
                continue
            labels, up = [], e
            while up is not None:
                if up.name.startswith(COMMIT_LABEL):
                    labels.append(up.name[len(COMMIT_LABEL):])
                up = up.cpu_parent
            linked += len(e.kernels)
            if "commit" not in labels:
                continue
            for k in e.kernels:
                if _hand_written(k.name) is None:
                    note(labels[0], e.name if e.name.startswith("aten::") else k.name[:48], k.duration / 1e3)
        on_dev = [e for e in events if e.device_type == self.torch.autograd.DeviceType.CUDA]
        spans = [(e.time_range.start, e.time_range.end, e.name[len(COMMIT_LABEL):]) for e in on_dev
                 if e.name.startswith(COMMIT_LABEL)]
        for e in on_dev:
            name = _hand_written(e.name)
            if name is None:
                continue
            held = [(end - start, label) for start, end, label in spans if start <= e.time_range.start < end]
            if any(label == "commit" for _, label in held):
                note(min(held)[1], name, e.time_range.elapsed_us() / 1e3)
        if not linked:
            return "trace commit by operation: the profiler linked no device kernel to a host op"
        total = sum(ms for ms, _ in by_key.values())
        rows = sorted(by_key.items(), key=lambda kv: -kv[1][0])
        return (f"trace commit by operation ({total:.3f} ms of device time in commit_wide): "
                + "; ".join(f"{label} / {op}: {ms:.3f} ms in {n}" for (label, op), (ms, n) in rows))


def _hand_written(kernel_name: str):
    """The ``KERNEL_KEYS`` label of a device kernel's name, or None."""
    return next((label for label, keys in KERNEL_KEYS if any(key in kernel_name for key in keys)), None)


def _chain_setup(dev, log_n: int):
    from tpu_stark_torch.air import poseidon2_air
    from tpu_stark_torch.prover.config import create_config

    air = poseidon2_air.Poseidon2ChainAir()
    trace, pis = poseidon2_air.generate_trace(1 << log_n, list(range(16)), device=dev)

    def config():
        return create_config(zk=False, hash="poseidon2", device=dev)

    return air, trace, pis, config


def profile(torch, dev, args) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tpu_stark_torch.prover.proof import serialize_proof
    from tpu_stark_torch.prover.prove import prove
    from tpu_stark_torch.prover.wide import prove_wide

    def sha(proof) -> str:
        return hashlib.sha256(serialize_proof(proof)).hexdigest()

    if args.workload in ("fib", "config2"):
        from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
        from tpu_stark_torch.fri.config import create_benchmark_fri_params
        from tpu_stark_torch.prover.config import create_config

        log_n = args.log_n or 20
        air, n = FibonacciAir(), 1 << log_n
        trace, pis = generate_trace_rows(0, 1, n), [0, 1, fibonacci_value(0, 1, n)]
        levers = {} if args.lowmem_log is None else {"lowmem_log": args.lowmem_log}
        if args.workload == "fib":
            label = f"fib 2^{log_n} zk (Keccak, smallrng) {levers} prove"

            def config():
                return create_config(zk=True, zk_rng="smallrng", zk_layout="tpu", device=dev, **levers)
        else:
            label = f"config 2 2^{log_n} (narrow_ntt='mxu') {levers} prove"

            def config():
                return create_config(create_benchmark_fri_params(1), zk=True, device=dev, narrow_ntt="mxu", **levers)

        def run(timings):
            return prove(config(), air, trace, pis, timings=timings)
    elif args.workload == "chain":
        log_n = args.log_n or 18
        air, trace, pis, config = _chain_setup(dev, log_n)
        label = f"chain 2^{log_n} x {air.width} prove"

        def run(timings):
            return prove(config(), air, trace, pis, timings=timings)
    else:
        log_n = args.log_n or 20
        zk = args.workload == "keccak-zk"
        air, trace, config = _keccak_setup(dev, log_n, zk)
        label = f"keccak-air 2^{log_n} x {air.width} prove_wide{' (Keccak, zk)' if zk else ''}"

        def run(timings):
            return prove_wide(config(), air, trace, [], timings=timings)
    walls = []
    for i in range(1 + args.reps):
        timings = _PhasePeaks(torch, dev)
        if i == 0:
            torch.cuda.memory._record_memory_history(max_entries=1 << 21)
        proof, s = _timed(torch, lambda: run(timings))
        print(f"{label}: {'cold (under the memory history)' if i == 0 else 'warm'} {s:.3f}s, {timings.top()} "
              f"({_phases(timings)}); proof SHA-256 {sha(proof)}", flush=True)
        del proof
        if i == 0:
            snapshot = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            _print_peak_live_set(snapshot)
            del snapshot
        walls.append(s)
    if args.reps:
        print(f"{label}: warm median {sorted(walls[1:])[args.reps // 2]:.3f}s of {args.reps}", flush=True)
    profiled = _PhasePeaks(torch, dev)
    with _Bounds(int(trace.shape[0])) as bounds, _K1Launches(torch) as k1, _RngTime(torch) as rng, \
            _CommitOps(torch) as commit_ops, \
            torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(torch, lambda: run(profiled))
    on_device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith(COMMIT_LABEL)]  # a label's device span is no kernel
    dev_s = sum(e.self_device_time_total for e in on_device) / 1e6
    print(f"profiled {wall:.3f}s ({_phases(profiled)}); device time {dev_s:.3f}s, idle "
          f"{100 * (1 - dev_s / wall):.1f}% of the profiled wall clock; "
          f"{sum(e.count for e in on_device)} device kernels and copies")
    for name, keys in KERNEL_KEYS:
        evs = [e for e in on_device if any(key in e.key for key in keys)]
        ms = sum(e.self_device_time_total for e in evs) / 1e3
        bound = bounds.ms.get(name, 0.0)
        print(f"{name}: {ms:.3f} ms of device time in {sum(e.count for e in evs)} launches "
              f"({bounds.calls.get(name, 0)} wrapper calls); summed bound {bound:.3f} ms; "
              f"loss (time - bound) {ms - bound:.3f} ms", flush=True)
    print(rng.report(dev_s, wall), flush=True)
    print(_device_by_phase(torch, prof), flush=True)
    print(commit_ops.report(prof), flush=True)
    k1_keys = dict(KERNEL_KEYS)["K1 keccak_sponge"]
    print(k1.report([e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and any(key in e.name for key in k1_keys)]), flush=True)
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:10.1f} ms  {e.count:7d}x  {e.key[:90]}")


def _other_pcs(tree: str):
    """``TwoAdicFriPcs`` of ``tree``'s ``tpu_stark_torch/commit/pcs.py``,
    loaded against this package's modules."""
    path = os.path.join(os.path.abspath(tree), "tpu_stark_torch", "commit", "pcs.py")
    spec = importlib.util.spec_from_file_location("tpu_stark_torch.commit._pcs_other", path)
    other = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    print(f"TwoAdicFriPcs from {path}", flush=True)
    return other.TwoAdicFriPcs


def warm(torch, dev, args) -> None:
    from tpu_stark_torch.air import poseidon2_air
    from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
    from tpu_stark_torch.commit import pcs as pcs_mod
    from tpu_stark_torch.fri.config import create_benchmark_fri_params
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.prove import prove

    if args.pcs_from:
        pcs_mod.TwoAdicFriPcs.open = _other_pcs(args.pcs_from).open

    def run(label, make_config, air, trace, pis):
        _, cold = _timed(torch, lambda: prove(make_config(), air, trace, pis))
        walls = []
        for _ in range(args.reps):
            timings = {}
            _, s = _timed(torch, lambda: prove(make_config(), air, trace, pis, timings=timings))
            walls.append(s)
            print(f"  {label} warm {s:.3f}s ({_phases(timings)})", flush=True)
        print(f"{label}: cold {cold:.3f}s; warm {', '.join(f'{s:.3f}' for s in walls)} s; "
              f"median {sorted(walls)[len(walls) // 2]:.3f}s", flush=True)

    n = 1 << 20
    run("fib 2^20 zk (Keccak)",
        lambda: create_config(zk=True, zk_rng="smallrng", zk_layout="tpu", device=dev),
        FibonacciAir(), generate_trace_rows(0, 1, n), [0, 1, fibonacci_value(0, 1, n)])
    (chain_trace, chain_pis), trace_s = _timed(
        torch, lambda: poseidon2_air.generate_trace(1 << 18, list(range(16)), device=dev))
    print(f"chain 2^18 trace generation {trace_s:.3f}s", flush=True)
    run("chain 2^18 x 493 (Poseidon2)",
        lambda: create_config(zk=False, hash="poseidon2", device=dev),
        poseidon2_air.Poseidon2ChainAir(), chain_trace, chain_pis)
    del chain_trace

    fib_trace, fib_pis = generate_trace_rows(0, 1, n), [0, 1, fibonacci_value(0, 1, n)]

    def config2(narrow, timings=None):
        cfg = create_config(create_benchmark_fri_params(1), zk=True, device=dev, narrow_ntt=narrow)
        return prove(cfg, FibonacciAir(), fib_trace, fib_pis, timings=timings)

    walls = {"mxu": [], None: []}
    for narrow in walls:
        _, cold = _timed(torch, lambda: config2(narrow))
        print(f"config 2 2^20 narrow_ntt={narrow!r}: cold {cold:.3f}s", flush=True)
    for _ in range(args.reps):
        for narrow in ("mxu", None, None, "mxu"):
            timings = {}
            _, s = _timed(torch, lambda: config2(narrow, timings))
            walls[narrow].append(s)
            print(f"  config 2 narrow_ntt={narrow!r} warm {s:.3f}s ({_phases(timings)})", flush=True)
    for narrow, ws in walls.items():
        print(f"config 2 2^20 narrow_ntt={narrow!r}: warm median {sorted(ws)[len(ws) // 2]:.3f}s "
              f"of {len(ws)}", flush=True)


def _print_peak_live_set(snapshot, top: int = 14) -> None:
    """Replay a memory-history snapshot's allocations and frees; print the
    tensors alive when the most bytes were, largest first, each with the
    innermost frames of the port (this tree's or ``--tree``'s) that
    allocated it."""
    events = snapshot["device_traces"][0]

    def replay(upto):
        live, total, peak, peak_at = {}, 0, 0, 0
        for i, ev in enumerate(events[:upto]):
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                total += ev["size"]
                if total > peak:
                    peak, peak_at = total, i + 1
            elif ev["action"] in ("free_requested", "free_completed") and ev["addr"] in live:
                total -= live.pop(ev["addr"])["size"]
        return live, peak, peak_at

    _, peak, peak_at = replay(len(events))
    at_peak, _, _ = replay(peak_at)
    print(f"history: {peak / 2**30:.3f} GiB allocated at the peak in {len(at_peak)} blocks; the largest:", flush=True)
    for ev in sorted(at_peak.values(), key=lambda e: -e["size"])[:top]:
        frames = [f"{f['filename'][f['filename'].rindex('tpu_stark_torch'):]}:{f['line']} {f['name']}"
                  for f in ev.get("frames", []) if "tpu_stark_torch" in f["filename"]][:3]
        print(f"  {ev['size'] / 2**30:.3f} GiB  {' < '.join(frames)}", flush=True)


def verify_timing(torch, dev, args) -> None:
    from tpu_stark_torch.commit import pcs as pcs_mod
    from tpu_stark_torch.prover.proof import deserialize_proof, serialize_proof
    from tpu_stark_torch.prover.verify import verify
    from tpu_stark_torch.prover.wide import prove_wide

    log_n = args.log_n or 20
    air, trace, config = _keccak_setup(dev, log_n)
    proof, prove_s = _timed(torch, lambda: prove_wide(config(), air, trace, []))
    del trace
    proof = deserialize_proof(serialize_proof(proof))
    print(f"keccak-air 2^{log_n} x {air.width} proved in {prove_s:.3f}s "
          f"({len(proof.opening_proof.query_proofs)} queries)", flush=True)
    for _ in range(2):
        ok, s = _timed(torch, lambda: verify(config(), air, proof, []))
        print(f"verify {s:.3f}s -> {ok}", flush=True)
        if not ok:
            raise AssertionError("the proof does not verify")
    if args.pcs_from:
        mine = pcs_mod.TwoAdicFriPcs.verify
        pcs_mod.TwoAdicFriPcs.verify = _other_pcs(args.pcs_from).verify
        try:
            ok, s = _timed(torch, lambda: verify(config(), air, proof, []))
        finally:
            pcs_mod.TwoAdicFriPcs.verify = mine
        print(f"verify with that PCS verifier: {s:.3f}s -> {ok}", flush=True)
        if not ok:
            raise AssertionError("the proof does not verify with the other PCS verifier")


K2_SHAPES = (((1 << 21, 128), False), ((1 << 20, 128), True), ((1 << 18, 257), False), ((1 << 23, 2), False))


def k2_timing(torch, dev, args) -> None:
    from tpu_stark_torch.fields import babybear as bb
    from tpu_stark_torch.ntt import ntt_kernel as nk

    alternatives = hasattr(nk, "split")
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def timed(fn, cold, reps=10):
        fn()
        total = 0.0
        for _ in range(reps):
            if cold:
                flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / reps

    def dft_with(x, p, tw):
        out = nk.pass0(x, p, tw)
        for s0, k, j_log in p.passes:
            out = nk.run_pass(out, s0, k, j_log, p, tw)
        return out

    for (h, w), inverse in K2_SHAPES:
        x = torch.randint(0, bb.P, (h, w), generator=gen, device=dev, dtype=torch.int64).to(torch.int32)
        log_h = h.bit_length() - 1
        cold = h * w * 4 < 50 << 20
        bound = h * w * 8 / 3.35e12 * 1e3  # one read and one write of the matrix
        label = f"({h}, {w}){' inv' if inverse else ''}"
        ms = timed(lambda: nk.dft(x, inverse), cold)
        print(f"{label} default plan: dft {ms:.4f} ms, {100 * bound / ms:.1f}% of {bound:.4f} ms", flush=True)
        if not alternatives:
            continue
        want = nk.dft(x, inverse)
        tw = nk.stage_twiddles(log_h, inverse, dev)
        for lanes_log in (4, 5):
            seen = set()
            for max_stages in range(12, 5, -1):
                p = nk.split(log_h, w, lanes_log, max_stages)
                ks = (p.k0,) + tuple(k for _, k, _ in p.passes)
                j_logs = (p.g_log,) + tuple(j for _, _, j in p.passes)
                if ks in seen or any(nk.smem_bytes(k, lanes_log, j, 1) > nk.SMEM_LIMIT
                                     for k, j in zip(ks, j_logs)):
                    continue
                seen.add(ks)
                if not torch.equal(dft_with(x, p, tw), want):
                    raise AssertionError(f"{label} plan {p}: not the default plan's result")
                ms = timed(lambda: dft_with(x, p, tw), cold)
                print(f"  {4 << lanes_log}-byte rows, stages {list(ks)}: dft {ms:.4f} ms, "
                      f"{100 * bound / ms:.1f}% of the bound, {100 * len(ks) * bound / ms:.1f}% of "
                      f"{len(ks)} passes' bound", flush=True)


P2_SHAPES = (("absorb (2097152, 128) on a carried state", "absorb", 1 << 21, 128),
             ("leaf (65536, 493)", "leaf", 1 << 16, 493), ("leaf (1048576, 493)", "leaf", 1 << 20, 493),
             ("leaf (2097152, 16)", "leaf", 1 << 21, 16), ("compress 1048576 pairs", "compress", 1 << 20, 8))


def p2_timing(torch, dev, args) -> None:
    import hashlib

    from tpu_stark_torch.fields import babybear as bb
    from tpu_stark_torch.hash import poseidon2_kernel as pk

    gen = torch.Generator(device=dev)

    def rand(shape, seed):
        gen.manual_seed(seed)
        return torch.randint(0, bb.P, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    a = rand((1 << 16, 493), 1)
    if not torch.equal(pk.hash_rows(a), pk.hash_rows_plain(a)):
        raise AssertionError("K3 (65536, 493) != plain")
    st, ch = rand((4096, 16), 2), rand((4096, 128), 3)
    if not torch.equal(pk.absorb_rows(st.clone(), ch), pk.absorb_rows_plain(st.clone(), ch)):
        raise AssertionError("K4 (4096, 128) != plain")
    print("K3 (65536, 493) and K4 (4096, 128) == plain (exact)", flush=True)
    for label, kind, n, k in P2_SHAPES:
        x = rand((n, k), n + k)
        if kind == "absorb":
            state = rand((n, 16), 7)  # a carried state, absorbed into in place

            def run():
                return pk.absorb_rows(state, x)
        elif kind == "leaf":
            def run():
                return pk.hash_rows(x)
        else:
            y = rand((n, k), 11)

            def run():
                return pk.compress(x, y)
        digest = hashlib.sha256(run().cpu().numpy().tobytes()).hexdigest()
        ms = _chip_smoke()._cuda_ms(torch, run, 10)
        perms = n if kind == "compress" else n * -(-k // pk.RATE)
        print(f"{label}: {ms:.4f} ms, {perms / ms / 1e6:.4f} G perm/s; output sha256 {digest[:16]}", flush=True)
        del x


K1_SHAPES = (("leaf (1048576, 6)", "leaf", 1 << 20, 6), ("leaf (8388608, 6)", "leaf", 1 << 23, 6),
             ("leaf (4194304, 8)", "leaf", 1 << 22, 8), ("compress 1048576 pairs", "compress", 1 << 20, 8),
             ("tree over 8388608 digests", "tree", 1 << 23, 0), ("tree over 65536 digests", "tree", 1 << 16, 0),
             ("tree over 1024 digests", "tree", 1 << 10, 0))


def k1_timing(torch, dev, args) -> None:
    import hashlib

    from tpu_stark_torch.challenger import grind
    from tpu_stark_torch.hash import keccak_kernel as kk

    cs = _chip_smoke()
    gen = torch.Generator(device=dev)

    def rand(shape, seed):
        gen.manual_seed(seed)
        return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    def layers(d, levels):
        if hasattr(kk, "compress_levels"):
            return kk.compress_levels(d, levels)
        out = []
        for _ in range(levels):
            d = kk.hash_rows(d.reshape(-1, 16))
            out.append(d)
        return out

    def sha(out):
        out = out if isinstance(out, (list, tuple)) else [out]
        return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in out)).hexdigest()[:16]

    small, left, right, d = rand((1000, 40), 1), rand((999, 8), 2), rand((999, 8), 3), rand((1 << 12, 4, 2), 4)
    if not torch.equal(kk.hash_rows(small), kk.hash_rows_plain(small)):
        raise AssertionError("K1 (1000, 40) != plain")
    if not torch.equal(kk.hash_rows(left, right), kk.hash_rows_plain(left, right)):
        raise AssertionError("K1 999 compress pairs != plain")
    want = [kk.hash_rows_plain(d.reshape(-1, 16))]
    for _ in range(11):
        want.append(kk.hash_rows_plain(want[-1].reshape(-1, 16)))
    if not all(torch.equal(g, w) for g, w in zip(layers(d, 12), want)):
        raise AssertionError("K1 tree over 4096 digests != plain")
    print("K1 (1000, 40), 999 compress pairs, a tree over 4096 digests == plain (exact)", flush=True)
    for label, kind, n, k in K1_SHAPES:
        if kind == "tree":
            x = rand((n, 4, 2), n)
            levels = n.bit_length() - 1

            def run():
                return layers(x, levels)
            bound = cs._tree_bound(n, levels)
        else:
            x = rand((n, k), n + k)
            y = rand((n, k), 11) if kind == "compress" else None

            def run():
                return kk.hash_rows(x, y)
            k_all = k * (2 if y is not None else 1)
            chunks = -(-(-(-k_all // 2)) // kk.RATE)  # u32 pairs form the items of the rate-17 sponge
            bound = cs._bound(n * k_all * 4 + n * 32, n * chunks * cs.KECCAK_F_OPS)
        digest = sha(run())
        ms = cs._cuda_ms(torch, run, 10)
        print(f"{label}: {ms:.4f} ms, {100 * bound[0] / ms:.1f}% of {bound[0]:.4f} ms ({bound[1]}); "
              f"output sha256 {digest}", flush=True)
        if kind == "tree" and hasattr(kk, "run_plan") and levels in K1_TREE_PLANS:
            want = run()
            for name, plan in K1_TREE_PLANS[levels]:
                got = kk.run_plan(x, plan)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{label} under {name} ({plan}): not the default plan's layers")
                ms = cs._cuda_ms(torch, lambda: kk.run_plan(x, plan), 10)
                print(f"  plan {name}: {len(plan)} launches {plan}: {ms:.4f} ms", flush=True)
        del x
    _k1_absorb(torch, dev, cs, kk, rand, sha)
    grind_timing(torch, dev, args)


GRIND_TIMINGS = 5  # timings of 20 launches each, of which grind_timing prints the median and the least


def grind_timing(torch, dev, args) -> None:
    import hashlib

    from tpu_stark_torch.challenger import grind

    cs = _chip_smoke()
    data = bytes(range(7, 107))  # a 100-byte transcript: one tail block
    prefix, tail, w_off = grind._plan(data)
    pre, tl = grind._operands(prefix, tail, dev)
    flags = grind.verdicts(0, 1 << 17, pre, tl, w_off, 16)
    if not torch.equal(flags, grind.verdicts_plain(0, 1 << 17, pre, tl, w_off, 16)):
        raise AssertionError("grind kernel != plain")
    digest = hashlib.sha256(flags.cpu().numpy().tobytes()).hexdigest()[:16]
    bound = cs.grind_bound(1 << 17, int(tl.shape[0]))
    model_ms = cs.grind_alu_model_ms(1 << 17, int(tl.shape[0]))
    for queued in (False, True):
        times = sorted(cs._cuda_ms(torch, lambda: grind.verdicts(0, 1 << 17, pre, tl, w_off, 16), 20, queued=queued)
                       for _ in range(GRIND_TIMINGS))
        ms = times[len(times) // 2]
        print(f"grind 2^17 candidates, {int(tl.shape[0])} block(s){', queued' if queued else ''}: {ms:.4f} ms "
              f"(median of {GRIND_TIMINGS} timings, least {times[0]:.4f} ms), {100 * bound[0] / ms:.1f}% of "
              f"{bound[0]:.4f} ms ({bound[1]}), {100 * model_ms / ms:.1f}% of the ALU model {model_ms:.4f} ms; "
              f"== plain; output sha256 {digest}", flush=True)


def _k5_level_fn(torch, mx, bb, x, b, a, inverse, dev):
    """One level of the route on x (B, A, R): the leaf's product, or an
    inner level's product, twiddle and moved axis, through the fused wrapper
    where the tree has one, else the parent's composition."""
    limbs = mx.limbs_on(b, inverse, dev)
    if a == 1:
        return lambda: mx.mod_matmul_axis(x, limbs)
    if hasattr(mx, "mod_matmul_twiddle_moved"):
        tw = mx.twiddles_on(a, b, inverse, dev)
        return lambda: mx.mod_matmul_twiddle_moved(x, limbs, tw)
    tw = mx._on_device("twiddle", (a, b), inverse, dev,
                       lambda: bb.to_tensor(mx.twiddle_monty(a, b, inverse).T.copy(), "cpu"))
    return lambda: bb.mul(mx.mod_matmul_axis(x, limbs), tw.view(b, a, 1)).movedim(1, 0).contiguous()


K5_PHASE_SHAPES = ((256, 1, 65536), (128, 1, 131072), (64, 1, 262144), (16, 1, 1048576), (256, 8192, 2),
                   (256, 16384, 4), (64, 128, 2048), (128, 128, 1024))


def _k5_phases(torch, dev, cs, src, rand) -> None:
    """K5 built alone with -DMXU_PHASE_CLOCKS: each shape's SM clocks by
    phase (summed over warpgroups), as shares of their sum."""
    import ctypes

    from tpu_stark_torch import kernels
    from tpu_stark_torch.ntt import mxu_ntt as mx

    if "MXU_PHASE_CLOCKS" not in open(src).read():
        print("phases: this tree's mxu_ntt.cu has no phase clocks", flush=True)
        return
    so = os.path.join(BUILD_OUT, "libk5_phases.so")
    build = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DMXU_PHASE_CLOCKS", "-shared", "-o", so, src],
                           capture_output=True, text=True, timeout=600)
    if build.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} with phase clocks:\n{build.stdout}{build.stderr}")
    lib = ctypes.CDLL(so)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ts_mxu_mm.argtypes = [vp, vp, vp, vp, i32, i64, i64, vp]
    lib.ts_mxu_mm.restype = i32
    lib.ts_mxu_phase_clocks.argtypes = [vp, i32]
    lib.ts_mxu_phase_clocks.restype = i32
    clocks = (ctypes.c_ulonglong * 4)()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for b, a, r in K5_PHASE_SHAPES:
        x = rand((b, a, r), b + a + r)
        w = mx.limbs_on(b, False, dev)
        tw = mx.twiddles_on(a, b, False, dev) if a > 1 else None
        out = torch.empty((a, b, r), dtype=torch.int32, device=dev)

        def run():
            kernels.check(lib.ts_mxu_mm(x.data_ptr(), mx._image_of(w).data_ptr(), None if tw is None else tw.data_ptr(),
                                        out.data_ptr(), b, a, r, stream), "K5 with phase clocks")

        run()
        torch.cuda.synchronize()
        want = mx.mod_matmul_axis(x, w) if a == 1 else mx.mod_matmul_twiddle_moved(x, w, tw)
        if not torch.equal(out.view(want.shape), want):
            raise AssertionError(f"K5 with phase clocks at ({b}, {a}, {r}) != the kernel's result")
        kernels.check(lib.ts_mxu_phase_clocks(None, 1), "phase clock reset")
        ms = cs._cuda_ms(torch, run, 10)
        kernels.check(lib.ts_mxu_phase_clocks(ctypes.addressof(clocks), 0), "phase clock read")
        split, issue, product, units = (float(c) for c in clocks)
        parts = {"raw wait + split": split, "wgmma products": product, "epilogue + stores": units - product}
        total = sum(parts.values())
        print(f"phases ({b}, {a}, {r}), {ms:.4f} ms with clocks: " + ", ".join(
            f"{k} {100 * v / total:.1f}%" for k, v in parts.items())
            + f" (the next tile's cp.async issue, inside the products' window: {100 * issue / total:.1f}%)",
            flush=True)
        del x, out


def k5_timing(torch, dev, args) -> None:
    import hashlib

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tpu_stark_torch import kernels
    from tpu_stark_torch.air.fibonacci import FibonacciAir, fibonacci_value, generate_trace_rows
    from tpu_stark_torch.fields import babybear as bb
    from tpu_stark_torch.fri.config import create_benchmark_fri_params
    from tpu_stark_torch.ntt import mxu_ntt as mx
    from tpu_stark_torch.ntt import radix2
    from tpu_stark_torch.prover.config import create_config
    from tpu_stark_torch.prover.prove import prove

    cs = _chip_smoke()
    src = os.path.join(os.path.dirname(kernels.SRC_DIR), "csrc", "mxu_ntt.cu")
    obj = os.path.join(BUILD_OUT, "k5_alone.o")
    os.makedirs(BUILD_OUT, exist_ok=True)
    t0 = time.perf_counter()
    alone = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-c", "-o", obj, src],
                           capture_output=True, text=True, timeout=600)
    if alone.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{alone.stdout}{alone.stderr}")
    print(f"nvcc of mxu_ntt.cu alone: {time.perf_counter() - t0:.2f}s; ptxas: " + " | ".join(
        ln.strip() for ln in (alone.stdout + alone.stderr).splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln), flush=True)
    kernels.lib()
    gen = torch.Generator(device=dev)

    def rand(shape, seed):
        gen.manual_seed(seed)
        return torch.randint(0, bb.P, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    # the main path's transforms: one config 2 prove at 2^20 on the narrow route
    seen = {}
    originals = {name: getattr(mx, name) for name in ("dft_batch", "idft_batch")}

    def noted(name):
        def call(mat, _orig=originals[name]):
            key = (int(mat.shape[0]), int(mat.shape[1]), name == "idft_batch")
            seen[key] = seen.get(key, 0) + 1
            return _orig(mat)
        return call

    n = 1 << 20
    for name in originals:
        setattr(mx, name, noted(name))
    try:
        prove(create_config(create_benchmark_fri_params(1), zk=True, device=dev, narrow_ntt="mxu"),
              FibonacciAir(), generate_trace_rows(0, 1, n), [0, 1, fibonacci_value(0, 1, n)])
        torch.cuda.synchronize()
    finally:
        for name, orig in originals.items():
            setattr(mx, name, orig)
    levels = {}
    for (h, w, inverse), count in sorted(seen.items()):
        for depth, (b, a, r) in enumerate(cs.k5_levels(h, w)):
            levels.setdefault((b, a, r, inverse), []).append((h, w, depth, count))
    print("config 2 2^20 (narrow_ntt='mxu'): transforms " + "; ".join(
        f"({h}, {w}){' inv' if inv else ''} x{c}" for (h, w, inv), c in sorted(seen.items())), flush=True)
    print(f"K5 levels (B, A, R) of those transforms: {len(levels)} shapes, "
          f"{sum(c for v in levels.values() for *_x, c in v)} launches a prove", flush=True)

    def timed_level(label, b, a, r, inverse, seed):
        x = rand((b, a, r), seed)
        fn = _k5_level_fn(torch, mx, bb, x, b, a, inverse, dev)
        digest = sha(fn())
        ms = cs._cuda_ms(torch, fn, 20)
        bound, by = cs.k5_bound(b, a, r)
        print(f"{label}: {ms:.4f} ms, {100 * bound / ms:.1f}% of {bound:.4f} ms ({by}); "
              f"{32 * b * b * a * r / ms / 1e9:.1f} int8 TOPS; output sha256 {digest}", flush=True)
        del x
        return ms, bound

    for (b, a, r, inverse), where in sorted(levels.items()):
        calls = sum(c for *_x, c in where)
        ms, bound = timed_level(
            f"config 2 level (B={b}, A={a}, R={r}){' inv' if inverse else ''} "
            f"[{', '.join(f'({h}, {w}) depth {d}' for h, w, d, _c in where)}; {calls} a prove]",
            b, a, r, inverse, b + a + r)
        print(f"  a prove's {calls} launches: {calls * ms:.4f} ms against {calls * bound:.4f} ms", flush=True)
    for b, m in cs.K5_TIMED:
        timed_level(f"leaf ({b}, {m})", b, 1, m, False, b + m)
    for h, w in cs.ROUTE_TIMED:
        x = rand((h, w), h + w)
        for inverse in (False, True):
            fn = radix2.idft_batch if inverse else radix2.dft_batch
            if not torch.equal(fn(x, "mxu"), fn(x)):
                raise AssertionError(f"narrow route ({h}, {w}) inverse={inverse} != K2")
        mxu_ms = cs._cuda_ms(torch, lambda: radix2.dft_batch(x, "mxu"), 10)
        k2_ms = cs._cuda_ms(torch, lambda: radix2.dft_batch(x), 10)
        bound = sum(cs.k5_bound(b, a, r)[0] for b, a, r in cs.k5_levels(h, w))
        print(f"route ({h}, {w}) == K2 (dft, idft); dft: route {mxu_ms:.4f} ms vs K2 {k2_ms:.4f} ms; "
              f"the levels' summed bound {bound:.4f} ms; output sha256 {sha(radix2.dft_batch(x, 'mxu'))}",
              flush=True)
        del x
    # what a prove's route transforms launch: dft_axis0 alone (no h^-1 scale)
    inputs = [(rand((h, w), h + w), inverse, count) for (h, w, inverse), count in sorted(seen.items())]
    for x, inverse, _count in inputs:
        mx.dft_axis0(x, inverse)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x, inverse, count in inputs:
            for _ in range(count):
                mx.dft_axis0(x, inverse)
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    k5 = [e for e in on_device if "mxu_mm" in e.key]
    other = [e for e in on_device if "mxu_mm" not in e.key]
    print(f"config 2's route transforms (dft_axis0, each as often as a prove runs it), profiled: K5 "
          f"{sum(e.self_device_time_total for e in k5) / 1e3:.4f} ms in {sum(e.count for e in k5)} launches; "
          f"other device work {sum(e.self_device_time_total for e in other) / 1e3:.4f} ms in "
          f"{sum(e.count for e in other)} kernels and copies", flush=True)
    for e in sorted(other, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:10.4f} ms  {e.count:5d}x  {e.key[:90]}", flush=True)
    if args.phases:
        _k5_phases(torch, dev, cs, src, rand)
    # a yardstick, not the same function: one int8 GEMM of the 16 limb products' volume at (256, 65536)
    a8 = torch.randint(-128, 128, (65536, 4 * 256), dtype=torch.int8, device=dev)
    b8 = torch.randint(-128, 128, (4 * 256, 4 * 256), dtype=torch.int8, device=dev)
    try:
        ms = cs._cuda_ms(torch, lambda: torch._int_mm(a8, b8), 20)
        print(f"yardstick (not K5's function): torch._int_mm (65536, 1024) x (1024, 1024) s8 -> s32, "
              f"the volume of K5's 16 limb products at (256, 65536): {ms:.4f} ms", flush=True)
    except RuntimeError as e:
        print(f"yardstick torch._int_mm: not run ({e})", flush=True)


# alternative launch plans (keccak_kernel.run_plan's (sub_log, lv) launches) of the
# compress layers of a tree over 2^23 and over 2^16 digests; tree_plan's: bands
# of 5 levels above 2^16 digests, then groups of 8
K1_TREE_PLANS = {
    23: (("groups of 8 from the bottom", [(8, 8), (8, 8), (7, 7)]),
         ("bands of 3", [(8, 3), (8, 3), (6, 1), (8, 8), (8, 8)]),
         ("bands of 4", [(9, 4), (8, 3), (8, 8), (8, 8)]),
         ("groups of 6", [(10, 5), (7, 2), (6, 6), (6, 6), (4, 4)]),
         ("groups of 7", [(10, 5), (7, 2), (7, 7), (7, 7), (2, 2)]),
         ("bands to 2^14", [(10, 5), (9, 4), (8, 8), (6, 6)]),
         ("bands to 2^18", [(10, 5), (8, 8), (8, 8), (2, 2)])),
    16: (("groups of 6", [(6, 6), (6, 6), (4, 4)]),
         ("groups of 7", [(7, 7), (7, 7), (2, 2)]),
         ("bands to 2^14", [(7, 2), (8, 8), (6, 6)])),
}

SASS_KERNELS = (("K4 p2_absorb_kernel", "p2_absorb_kernel"), ("K3 p2_sponge_kernel<8>", "p2_sponge_kernelILi8E"))
# SASS opcode classes (prefix match in this order) and the pipe each runs on
SASS_CLASSES = (
    ("IMAD.WIDE", ("IMAD.WIDE",)), ("IMAD.HI", ("IMAD.HI",)), ("IMAD other", ("IMAD", "IMUL")),
    ("IADD3", ("IADD3",)), ("ISETP", ("ISETP",)), ("SEL", ("SEL",)),
    ("IMNMX", ("IMNMX", "VIMNMX", "VIADDMNMX")), ("VIADD", ("VIADD",)),
    ("LOP3", ("LOP3",)), ("SHF", ("SHF", "SHL", "SHR")), ("LEA", ("LEA",)), ("LDC", ("LDC",)),
    ("LDG", ("LDG",)), ("STG", ("STG",)), ("LDS/STS", ("LDS", "STS", "LDGSTS")),
    ("uniform", ("U",)), ("MOV", ("MOV",)), ("BRA", ("BRA",)),
)
FMA_PIPE = ("IMAD.WIDE", "IMAD.HI", "IMAD other")
# the ALU pipe: integer add, compare, min/max, logic and shift (VIADDMNMX is
# Hopper's fused add-then-min, as in min(x, x - P))
ALU_PIPE = ("IADD3", "ISETP", "SEL", "IMNMX", "VIADD", "LOP3", "SHF", "LEA")


def _sass_functions(text: str) -> dict:
    """{mangled name: [[address, opcode, branch target or None]]} of a
    ``cuobjdump -sass`` listing (targets given as addresses or .L_x labels)."""
    import re

    ins = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
    funcs, labels, cur, pending = {}, {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            labels[m.group(1)], pending = {}, []
            name = m.group(1)
            continue
        if cur is None:
            continue
        lab = re.match(r"\s*\.L_x_(\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = ins.search(line)
        if m:
            addr, op = int(m.group(1), 16), m.group(2)
            for lb in pending:
                labels[name][lb] = addr
            pending = []
            target = None
            if op.startswith("BRA"):
                t = re.search(r"\.L_x_(\d+)|(0x[0-9a-f]+)", m.group(3))
                if t:
                    target = t.group(1) if t.group(1) else int(t.group(2), 16)
            cur.append([addr, op, target])
    for name, code in funcs.items():
        for item in code:
            if isinstance(item[2], str):
                item[2] = labels[name].get(item[2])
    return funcs


def _sass_class(op: str) -> str:
    for name, prefixes in SASS_CLASSES:
        if op.startswith(prefixes):
            return name
    return "other"


def _mix(ops) -> dict:
    out = {}
    for op in ops:
        c = _sass_class(op)
        out[c] = out.get(c, 0) + 1
    return out


def _loops(code):
    """Backward branches as loops (start address, last branch address)."""
    ends = {}
    for addr, _op, target in code:
        if isinstance(target, int) and target <= addr:
            ends[target] = max(ends.get(target, 0), addr)
    return sorted(ends.items())


def _per_permutation(code, trips=(4, 13, 4)):
    """The chunk loop's instruction mix per pass (one permutation), with
    the loops inside it weighted by ``trips`` in address order (the
    parent's rolled round loops); (mix, note)."""
    loops = _loops(code)
    if not loops:
        return _mix(op for _a, op, _t in code), "no loop: the whole function"
    lo, hi = max(loops, key=lambda l: l[1] - l[0])
    inner = [(s, e) for s, e in loops if lo <= s and e <= hi and (s, e) != (lo, hi)]
    top = [(s, e) for s, e in inner if not any(s2 <= s and e <= e2 and (s2, e2) != (s, e) for s2, e2 in inner)]
    weights = {}
    if top and len(top) != len(trips):
        return _mix(op for a, op, _t in code if lo <= a <= hi), f"{len(top)} inner loops (trip counts unknown): static body"
    for (s, e), n in zip(top, trips if top else ()):
        weights[(s, e)] = n
    mix = {}
    for addr, op, _t in code:
        if not lo <= addr <= hi:
            continue
        w = 1
        for (s, e), n in weights.items():
            if s <= addr <= e:
                w = n
        c = _sass_class(op)
        mix[c] = mix.get(c, 0) + w
    note = f"chunk loop 0x{lo:x}-0x{hi:x}" + (f", inner loops x{list(trips)}" if top else ", no inner loop")
    return mix, note


def _pipes(mix) -> tuple:
    """(FMA-pipe slots, ALU-pipe instructions) of a mix: IMAD.WIDE and
    IMAD.HI take two FMA slots each."""
    fma = sum(mix.get(c, 0) for c in FMA_PIPE) + mix.get("IMAD.WIDE", 0) + mix.get("IMAD.HI", 0)
    return fma, sum(mix.get(c, 0) for c in ALU_PIPE)


def _mix_line(mix) -> str:
    fma = sum(mix.get(c, 0) for c in FMA_PIPE)
    alu = sum(mix.get(c, 0) for c in ALU_PIPE)
    parts = ", ".join(f"{c} {mix[c]:g}" for c, _ in SASS_CLASSES + (("other", ()),) if mix.get(c))
    return f"total {sum(mix.values()):g}: FMA pipe {fma:g}, ALU pipe {alu:g}; {parts}"


# (label, the mangled names that may hold it, the first found): the absorb's
# main-path instance, <!FIN, REV, MONTY>, or an older tree's <!FIN>
K1_SASS_KERNELS = (("K1 keccak_rows_kernel", ("keccak_rows_kernel",)), ("K1 keccak_tree_kernel", ("keccak_tree_kernel",)),
                   ("K1 keccak_absorb_kernel", ("keccak_absorb_kernelILb0ELb1ELb1E", "keccak_absorb_kernelILb0E")),
                   ("grind keccak_grind_kernel", ("keccak_grind_kernel",)))


def _k1_absorb(torch, dev, cs, kk, rand, sha) -> None:
    """The streamed Keccak commit's absorb step at ``chip_smoke.
    K1_ABSORB_TIMED`` (cell 6: 30 pending words and a natural-order (2^22,
    64) Montgomery chunk on a carried state): one launch in a tree whose
    absorb reads such a chunk (``monty``), else the older tree's step, the
    canonical bit-reversed copy (``to_u32`` of the reversed rows), the
    absorb of the whole blocks and the copy of the words after them (and
    that absorb alone).  Events, queued behind a spin of the device; the
    carried state's and pending words' SHA-256, so that two trees compare."""
    import inspect

    from tpu_stark_torch.fields import babybear as bb
    from tpu_stark_torch.matrix import reverse_matrix_index_bits

    n, p, k = cs.K1_ABSORB_TIMED
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    chunk = torch.randint(0, bb.P, (n, k), generator=gen, device=dev, dtype=torch.int64).to(torch.int32)
    state0, pend = rand((2 * 25, n), 6), rand((p, n), 7).t()  # the pending words as the kernel leaves them
    fused = "monty" in inspect.signature(kk.absorb_rows).parameters
    take = (p + k) // kk.BLOCK_WORDS * kk.BLOCK_WORDS - p

    def step(state):
        if fused:
            return kk.absorb_rows(state, chunk, False, pend, True, True)
        canon = bb.to_u32(reverse_matrix_index_bits(chunk))
        kk.absorb_rows(state, canon[:, :take], pend=pend.contiguous())
        return canon[:, take:].contiguous()

    state = state0.clone()
    rest = step(state)
    digest = sha([state, rest.contiguous()])
    ms = cs._cuda_ms(torch, lambda: step(state), 10, queued=True)
    bound_ms, bound_by = cs.keccak_absorb_bound(n, p, k, False, False, True)
    model_ms = cs.keccak_alu_model_ms(n * ((p + k) // kk.BLOCK_WORDS))
    what = "one launch" if fused else "to_u32 of the reversed rows, the absorb, the rest's copy"
    print(f"absorb step ({n}, {p} pending + natural Monty {k}) on a carried state ({what}): {ms:.4f} ms, "
          f"{100 * bound_ms / ms:.1f}% of {bound_ms:.4f} ms ({bound_by}), {100 * model_ms / ms:.1f}% of the ALU "
          f"model {model_ms:.4f} ms; state and rest sha256 {digest}", flush=True)
    if fused:  # the launch in each operand form, and at the older tree's 30 + 38 canonical words
        forms = [(k, True, False), (k, False, False), (take, False, False)]
        for kk_, monty, natural in forms:
            mat = chunk[:, :kk_].contiguous()
            ms = cs._cuda_ms(torch, lambda: kk.absorb_rows(state, mat, False, pend, monty, natural), 10, queued=True)
            model_ms = cs.keccak_alu_model_ms(n * ((p + kk_) // kk.BLOCK_WORDS))
            print(f"  ({n}, {p} + {kk_}) Montgomery {monty}, natural {natural}: {ms:.4f} ms, "
                  f"{100 * model_ms / ms:.1f}% of the ALU model", flush=True)
    if not fused:
        canon, pend_c = bb.to_u32(reverse_matrix_index_bits(chunk)), pend.contiguous()
        ms = cs._cuda_ms(torch, lambda: kk.absorb_rows(state, canon[:, :take], pend=pend_c), 10, queued=True)
        print(f"  its absorb alone ({n}, {p} + {take}): {ms:.4f} ms, {100 * model_ms / ms:.1f}% of the ALU model",
              flush=True)


ROUNDS = 24


def _per_round(code):
    """K1's rolled round loop (``#pragma unroll 1``: one round a trip):
    (mix per round, note), from the innermost loop with the most LOP3."""
    loops = _loops(code)
    inner = [(s, e) for s, e in loops if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e) for s2, e2 in loops)]
    best, best_lop3 = None, 0
    for s_, e in inner:
        n = sum(1 for a, op, _t in code if s_ <= a <= e and op.startswith("LOP3"))
        if n > best_lop3:
            best, best_lop3 = (s_, e), n
    if best is None:
        return None, "no round loop (unrolled): not read"
    mix = _mix(op for a, op, _t in code if best[0] <= a <= best[1])
    return mix, f"round loop 0x{best[0]:x}-0x{best[1]:x}"


def sass_report(text: str, digest_round: bool = True) -> dict:
    """Prints and returns {kernel label: mix per permutation}.
    ``digest_round``: the grind's last round computes lanes 0-3 only
    (``chip_smoke.KECCAK_DIGEST_ROUND_OPS`` ALU instructions, counted as
    LOP3) after 23 rounds of its loop; an older tree's runs 24."""
    funcs = _sass_functions(text)
    mixes = {}
    for label, keys in K1_SASS_KERNELS:
        names = next(([n for n in funcs if key in n] for key in keys if any(key in n for n in funcs)), [])
        if not names:
            print(f"{label}: not in the listing", flush=True)
            continue
        code = funcs[names[0]]
        mix, note = _per_round(code)
        if mix is None:
            print(f"{label}: {len(code)} instructions in the function; {note}", flush=True)
            continue
        print(f"{label}: {len(code)} instructions in the function; per round ({note}): {_mix_line(mix)}", flush=True)
        if label.startswith("grind") and digest_round:
            mixes[label] = {c: n * (ROUNDS - 1) for c, n in mix.items()}
            mixes[label]["LOP3"] = mixes[label].get("LOP3", 0) + _chip_smoke().KECCAK_DIGEST_ROUND_OPS
        else:
            mixes[label] = {c: n * ROUNDS for c, n in mix.items()}
    for label, key in SASS_KERNELS:
        names = [n for n in funcs if key in n]
        if not names:
            print(f"{label}: not in the listing", flush=True)
            continue
        code = funcs[names[0]]
        mix, note = _per_permutation(code)
        print(f"{label}: {len(code)} instructions in the function; per permutation ({note}): "
              f"{_mix_line(mix)}", flush=True)
        if "unknown" not in note:
            mixes[label] = mix
    return mixes


def k5_sass_report(text: str) -> None:
    """K5's instantiations (``mxu_mm_kernel<NW, TW>``): instructions in
    the function, the integer wgmma products (IGMMA; HGMMA is the
    placeholder ptxas adds for a wait), the warpgroup fences and waits, and
    the rest by class."""
    kinds = ("IGMMA", "HGMMA", "IMMA", "WARPGROUP")
    for name, code in _sass_functions(text).items():
        if "mxu_mm_kernel" not in name:
            continue
        ops = [op for _a, op, _t in code]
        count = {k: sum(op.startswith(k) for op in ops) for k in kinds}
        rest = _mix(op for op in ops if not op.startswith(kinds))
        print(f"K5 {name[-40:]}: {len(ops)} instructions; " + ", ".join(f"{k} {count[k]}" for k in kinds)
              + f"; the rest {_mix_line(rest)}", flush=True)


# each kernel's table shape: (kernel label, shape, permutations)
PIPE_BOUND_SHAPES = (("K4 p2_absorb_kernel", "absorb (2097152, 128)", (1 << 21) * 128 // 8),
                     ("K3 p2_sponge_kernel<8>", "leaf (65536, 493)", (1 << 16) * -(-493 // 8)),
                     ("K1 keccak_rows_kernel", "leaf (1048576, 6)", 1 << 20),
                     ("K1 keccak_tree_kernel", "a tree over 8388608 digests", (1 << 23) - 1),
                     ("K1 keccak_absorb_kernel", "absorb 30 + 64 words x 4194304 rows (two blocks)", 2 << 22),
                     ("grind keccak_grind_kernel", "2^17 candidates, one block", 1 << 17))


# K7's source variants (``k7``): name -> (what it changes, whether it still
# computes K7's function)
K7_VARIANTS = {
    "base": ("as generated", True),
    "noinline": ("the phase functions out of line", True),
    "nocompute": ("each phase one fold of one staged word (staging, ring and store left)", False),
    "nostage": ("no copies into the ring (compute on whatever shared memory holds)", False),
}


def _k7_source(qk, header: str, dag, kind: str) -> str:
    """The DAG's K7 source with ``kind``'s change and the header inlined.
    Raises if a change finds nothing to change."""
    import re

    text = qk.source(dag)
    h = header.replace("#pragma once", "")
    old_text, old_h = text, h
    if kind == "noinline":
        text = text.replace("__device__ __forceinline__ static void phase", "__device__ __noinline__ static void phase")
    elif kind == "nocompute":
        text = re.sub(r"(static void phase\d+_\d+\([^)]*\) \{\n)(.*?)(\n  \})",
                      lambda m: m.group(1) + "    (void)a; (void)t; tsq::fold(acc, al[0], lc[0]);" + m.group(3), text,
                      flags=re.S)
    elif kind == "nostage":
        anchor = "  uint32_t* st = smem + slot * L::kStage;\n"
        h = h.replace(anchor, anchor + "  if (a.rows > 0) return;\n", 1)
    if kind in ("noinline", "nocompute", "nostage") and (text, h) == (old_text, old_h):
        raise AssertionError(f"k7 variant {kind}: its change matched nothing in the generated source or header")
    return text.replace(f'#include "{qk.HEADER}"', h)


def k7_timing(torch, dev, args) -> None:
    import ctypes
    import re

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from tpu_stark_torch import kernels
    from tpu_stark_torch.air import keccak_air, poseidon2_air
    from tpu_stark_torch.air import quotient_kernel as qk
    from tpu_stark_torch.air.fibonacci import FibonacciAir
    from tpu_stark_torch.prover import wide

    cs = _chip_smoke()
    kernels.lib()
    with open(os.path.join(kernels.SRC_DIR, qk.HEADER)) as f:
        header = f.read()
    progs = {}
    for air, npis in ((FibonacciAir(), 3), (poseidon2_air.Poseidon2ChainAir(), 32), (keccak_air.KeccakAir(), 0)):
        for p in qk.programs(air, npis):
            progs.setdefault(p.dag.key, (p, npis))
    # an older tree (``--tree``) builds its own kernel as its wrapper would, the base variant alone
    ring = hasattr(qk, "Plan")
    variants = K7_VARIANTS if ring else {"base": K7_VARIANTS["base"]}
    texts = {f"{kind}_{key}": _k7_source(qk, header, p.dag, kind) if ring else qk.source(p.dag)
             for kind in variants for key, (p, _n) in progs.items()}
    t0 = time.perf_counter()
    built = kernels.build_generated(texts)
    print(f"k7: built {len(built)} libraries in {time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(*shape):
        return torch.randint(0, 0x78000001, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.int32)

    n = 1 << 20
    for kind, (what, same) in variants.items():
        parts = []
        for key, (prog, npis) in progs.items():
            plan = prog.dag.plan() if ring else None
            res = built[f"{kind}_{key}"]
            lib = ctypes.CDLL(res.path)
            blocks = ctypes.c_int(0)
            if ring:
                kernels.check(getattr(lib, f"ts_q_init_{key}")(ctypes.byref(blocks)), f"k7 {kind} init")
            fn = getattr(lib, f"ts_q_{key}")
            fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
            qk._FNS[key] = fn
            listing = subprocess.run([_cuobjdump(), "-sass", res.path], capture_output=True, text=True).stdout
            code = [c for name, c in _sass_functions(listing).items() if "quotient_kernel" in name][0]
            if args.sass_out and kind == "base":
                os.makedirs(args.sass_out, exist_ok=True)
                with open(os.path.join(args.sass_out, f"k7_{prog.name}_{key}.sass"), "w") as f:
                    f.write(listing)
            ops = [op.split(".")[0] for _a, op, _t in code]
            regs = re.findall(r"Used (\d+) registers", res.log)
            u = len(prog.cols)
            if prog.name == "air":  # the dense pass (phase 24): next rows 2 on in the same panel, times 1/Z_H
                rows = n if u == 2 else n // 2
                cur = rand(rows, u)
                sels = {name: rand(rows) for name in qk.SELECTORS}
                call = (prog, cur, cur, 2, sels, 0, 1, rand(npis), rand(prog.count, 4))
                tail, acc = (0, 1, False, True), rand(rows, 4)
            else:  # the streamed pass's last block (phase 24)
                r = wide.block_count(n, u, len(prog.next_cols) > 0, wide.PANEL_BUDGET, wide.MIN_BLOCK_LOG)
                rows = n // r
                cur = rand(rows, u)
                sels = {name: rand(rows * r) for name in qk.SELECTORS}
                call = (prog, cur, rand(rows, u), 0, sels, r - 1, r, rand(npis), rand(prog.count, 4))
                tail, acc = (r - 1, r, True, False), rand(rows * r, 4)
            if same:
                want = qk.eval_fold_plain(*call, acc.clone(), *tail)
                if not torch.equal(qk.eval_fold(*call, acc.clone(), *tail), want):
                    raise AssertionError(f"k7 {kind} {prog.name}: kernel != plain")
            qk.eval_fold(*call, acc, *tail)
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    qk.eval_fold(*call, acc, *tail)
                torch.cuda.synchronize()
            ms = sum(e.self_device_time_total for e in prof.key_averages() if "quotient_kernel" in e.key) / 1e4
            if ms == 0.0:  # the profiler returned no kernel event: CUDA events around the launches instead
                ms = cs._cuda_ms(torch, lambda: qk.eval_fold(*call, acc, *tail), 10)
            bound = cs.quotient_eval_bound(prog.dag, rows, tail[2], tail[3], cs.same_panel(call[1], call[2]))[0]
            label = prog.name if prog.name != "air" else ("fib" if u == 2 else "chain")
            shape = (f"{plan.warps} x {plan.subs} + {plan.producers} warps, one row a lane, ring {plan.stages}, "
                     f"{len(plan.phases)} phases of <= {plan.width} quads, "
                     f"{prog.dag.smem_bytes(plan)} B" if ring
                     else f"one 32-row tile a block, {prog.dag.parts} warps, {prog.dag.smem_bytes()} B")
            parts.append(f"{label} ({rows}, {u}) {ms:.4f} ms ({100 * bound / ms:.1f} % of {bound:.4f}); {shape}; "
                         f"{regs[-1] if regs else '?'} regs, {blocks.value if ring else '?'} blocks/SM, "
                         f"{len(ops)} SASS, LDL "
                         f"{ops.count('LDL')} STL {ops.count('STL')} LDS {ops.count('LDS')} LDG {ops.count('LDG')}")
            del cur, sels, acc, call
        qk._FNS.clear()
        print(f"k7 {kind} ({what}): " + " | ".join(parts), flush=True)


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "cuobjdump")


def sass(torch, dev, args) -> None:
    import re

    if args.from_file:
        with open(args.from_file) as f:
            text = f.read()
        k5_sass_report(text)
        sass_report(text)
        return
    from tpu_stark_torch import kernels

    build = kernels.build(force=True)
    print(f"nvcc build {build.seconds:.2f}s", flush=True)
    entry = None
    for line in build.log.splitlines():  # ptxas -v: each entry's spills and registers
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if m:
            entry = m.group(1)
        elif entry and ("p2_" in entry or "keccak" in entry or "mxu" in entry) and "(C75" not in line and (
                "registers" in line or "spill" in line or "smem" in line):
            print(f"  {entry}: {line.strip()}", flush=True)
    text = subprocess.run([_cuobjdump(), "-sass", build.path], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    tag = os.path.basename(os.path.normpath(args.tree)) if args.tree else "this"
    os.makedirs(BUILD_OUT, exist_ok=True)
    path = os.path.join(BUILD_OUT, f"sass_{tag}.txt")
    with open(path, "w") as f:  # the listing of the Poseidon2 and Keccak kernels only
        keep = False
        for line in text.splitlines(keepends=True):
            if "Function :" in line:
                keep = "p2_" in line or "keccak" in line or "mxu" in line
            if keep:
                f.write(line)
    print(f"SASS of {build.path}'s Poseidon2, Keccak and K5 kernels in {path}", flush=True)
    k5_sass_report(text)
    from tpu_stark_torch.challenger import grind

    mixes = sass_report(text, hasattr(grind, "witness_lanes"))
    rates = probe(torch, dev, args)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, shape, perms in PIPE_BOUND_SHAPES:
        if label not in mixes:
            print(f"{label}: no per-pipe bound (no permutation read off the SASS)", flush=True)
            continue
        fma, alu = _pipes(mixes[label])
        if "keccak" in label:  # all LOP3 and SHF: their mix's rate, at the clock it ran at
            name, alu_rate, ghz = "per-pipe model", rates["lop3_shf"], rates["lop3_shf_ghz"]
        else:
            name, alu_rate, ghz = "per-pipe bound", rates["alu"], rates["ghz"]
        ms = perms * max(fma / rates["fma"], alu / alu_rate) / (sms * ghz * 1e9) * 1e3
        print(f"{label} {name} at {shape}: {ms:.4f} ms ({fma:g} FMA slots / {rates['fma']:.2f} and "
              f"{alu:g} ALU / {alu_rate:.2f} per SM per clock, {sms} SMs at {ghz:.3f} GHz)", flush=True)


PROBE_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
// Long dependent chains, CH independent ones per thread, so that the
// schedulers always have a ready instruction.  KIND 0: IADD3 (a + b + c),
// 1: IMAD (a * b + c), 2: chains 0 and 2 IADD3, 1 and 3 IMAD, 3: IMAD.WIDE.U32
// with a 64-bit addend (lo * hi + w), 4: IMAD.HI.U32 (hi(a * b) + c),
// 5: VIADDMNMX.U32 (min(a - P, b)), 6: the kernels' Montgomery product
// a = min(r, r - P) with r = hi(a b) - hi(m P) + P, m = lo(a b) P^-1,
// 7: LOP3 (chi's a ^ (~b & c)), 8: SHF.L.W (funnel shifts), 9: chains 0
// and 2 LOP3, 1 and 3 IMAD, 10: 0 and 2 LOP3, 1 and 3 IMAD.HI, 11: 0 and 2
// LOP3, 1 and 3 SHF.L.W, 12: chains 0-2 LOP3, chain 3 a rotation half in
// its FMA-pipe form hi(l mul) + h mul (IMAD, IMAD.HI; mul = 2^s, an
// argument, so that ptxas cannot turn the products into shifts).
constexpr int STEPS = 8;
constexpr int CH = 4;
__device__ __forceinline__ uint32_t rot_half(uint32_t l, uint32_t h, uint32_t mul) {
  uint32_t d;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(l), "r"(mul), "r"(h * mul));
  return d;
}
template <int KIND>
__global__ void probe_kernel(uint32_t* out, long long* cyc, int iters, uint32_t seed, uint32_t mul) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t a[CH], b[CH], c[CH];
  uint64_t w[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    a[j] = seed ^ (t * 0x9e3779b9u + j);
    b[j] = a[j] * 3u + 1u;
    c[j] = a[j] ^ 0x5bd1e995u;
    w[j] = ((uint64_t)b[j] << 32) | a[j];
  }
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        if (KIND == 7 || (KIND >= 9 && KIND <= 11 && j % 2 == 0) || (KIND == 12 && j < 3)) {
          a[j] = a[j] ^ (~b[j] & c[j]);
          b[j] = b[j] ^ (~c[j] & a[j]);
          c[j] = c[j] ^ (~a[j] & b[j]);
        } else if (KIND == 8 || KIND == 11) {
          a[j] = __funnelshift_l(a[j], b[j], 7);
          b[j] = __funnelshift_l(b[j], c[j], 13);
          c[j] = __funnelshift_l(c[j], a[j], 19);
        } else if (KIND == 12) {
          a[j] = rot_half(b[j], a[j], mul);
          b[j] = rot_half(c[j], b[j], mul);
          c[j] = rot_half(a[j], c[j], mul);
        } else if (KIND == 10) {
          a[j] = __umulhi(a[j], b[j]) + c[j];
          b[j] = __umulhi(b[j], c[j]) + a[j];
          c[j] = __umulhi(c[j], a[j]) + b[j];
        } else if (KIND == 0 || (KIND == 2 && j % 2 == 0)) {
          a[j] = a[j] + b[j] + c[j];
          b[j] = b[j] + c[j] + a[j];
          c[j] = c[j] + a[j] + b[j];
        } else if (KIND == 1 || KIND == 2 || KIND == 9) {
          a[j] = a[j] * b[j] + c[j];
          b[j] = b[j] * c[j] + a[j];
          c[j] = c[j] * a[j] + b[j];
        } else if (KIND == 5) {
          a[j] = min(a[j] - 0x78000001u, b[j]);
          b[j] = min(b[j] - 0x78000001u, c[j]);
          c[j] = min(c[j] - 0x78000001u, a[j]);
        } else if (KIND == 6) {
          const uint64_t t = (uint64_t)a[j] * b[j];
          const uint32_t m = (uint32_t)t * 0x88000001u;
          const uint32_t r = (uint32_t)(t >> 32) - __umulhi(m, 0x78000001u) + 0x78000001u;
          a[j] = min(r, r - 0x78000001u);
        } else if (KIND == 4) {
          a[j] = __umulhi(a[j], b[j]) + c[j];
          b[j] = __umulhi(b[j], c[j]) + a[j];
          c[j] = __umulhi(c[j], a[j]) + b[j];
        } else {
          w[j] = (uint64_t)(uint32_t)w[j] * (uint32_t)(w[j] >> 32) + w[j];
        }
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < CH; ++j) acc ^= a[j] ^ b[j] ^ c[j] ^ (uint32_t)w[j] ^ (uint32_t)(w[j] >> 32);
  out[t] = acc;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

template <int KIND>
void launch(int blocks, int threads, int iters, uint32_t seed, uint32_t* out, long long* cyc, cudaStream_t s) {
  probe_kernel<KIND><<<blocks, threads, 0, s>>>(out, cyc, iters, seed, 1u << 7);
}

extern "C" int probe_run(int kind, int blocks, int threads, int iters, uint32_t seed, uint32_t* out,
                         long long* cyc, cudaStream_t s) {
  using L = void (*)(int, int, int, uint32_t, uint32_t*, long long*, cudaStream_t);
  static const L kinds[] = {launch<0>, launch<1>, launch<2>, launch<3>, launch<4>, launch<5>, launch<6>,
                            launch<7>, launch<8>, launch<9>, launch<10>, launch<11>, launch<12>};
  kinds[kind](blocks, threads, iters, seed, out, cyc, s);
  return (int)cudaGetLastError();
}
"""
PROBE_KINDS = ("IADD3 only", "IMAD only", "IADD3 + IMAD, even", "IMAD.WIDE only", "IMAD.HI only",
               "VIADDMNMX only", "the kernels' reduced Montgomery product", "LOP3 only", "SHF.L.W only",
               "LOP3 + IMAD, even", "LOP3 + IMAD.HI, even", "LOP3 + SHF.L.W, even",
               "3 LOP3 chains + 1 FMA-pipe rotation-half chain")


def probe(torch, dev, args) -> dict:
    """Prints each kind's rates; returns {"fma": the FMA pipe's results per
    SM per clock under ``IMAD only``, "alu": the ALU pipe's under ``IADD3
    only``, "ghz": the slowest SM clock of the runs, "lop3_shf": the ALU
    pipe's under ``LOP3 + SHF.L.W, even``, "lop3_shf_ghz": that run's SM
    clock}."""
    import ctypes

    from tpu_stark_torch import kernels

    out_dir = os.path.join(BUILD_OUT, "probe")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "int_probe.cu"), os.path.join(out_dir, "libint_probe.so")
    with open(cu, "w") as f:
        f.write(PROBE_SRC)
    build = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", so, cu],
                           capture_output=True, text=True, timeout=600)
    if build.returncode != 0:
        raise RuntimeError(f"nvcc failed on the probe:\n{build.stdout}{build.stderr}")
    print("ptxas: " + " | ".join(ln.strip() for ln in (build.stdout + build.stderr).splitlines()
                                 if "registers" in ln), flush=True)
    text = subprocess.run([_cuobjdump(), "-sass", so], capture_output=True, text=True, check=True,
                          timeout=600).stdout
    with open(os.path.join(out_dir, "sass_probe.txt"), "w") as f:
        f.write(text)
    funcs = _sass_functions(text)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_run.argtypes = [i32, i32, i32, i32, ctypes.c_uint32, vp, vp, vp]
    lib.probe_run.restype = i32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads, per_sm, iters = 256, 4, 4096
    blocks = sms * per_sm
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    cyc = torch.empty(blocks, dtype=torch.int64, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    print(f"{sms} SMs, {per_sm} blocks of {threads} threads on each (all resident), {iters} iterations", flush=True)
    pipe_rates = {"ghz": float("inf")}
    for kind, label in enumerate(PROBE_KINDS):
        name = [n for n in funcs if f"probe_kernelILi{kind}E" in n][0]
        loops = _loops(funcs[name])
        lo, hi = max(loops, key=lambda l: l[1] - l[0])
        body = _mix(op for a, op, _t in funcs[name] if lo <= a <= hi)
        for _ in range(2):  # the first run warms up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            kernels.check(lib.probe_run(kind, blocks, threads, iters, 1, out.data_ptr(), cyc.data_ptr(), stream),
                          "the integer probe")
            end.record()
            torch.cuda.synchronize()
        cycles = int(cyc.max())
        ms = start.elapsed_time(end)
        per = threads * per_sm * iters / cycles  # loop bodies per SM per clock, times 1 thread
        rates = ", ".join(f"{c} {n * per:.2f}" for c, n in sorted(body.items()))
        print(f"{label}: loop body {_mix_line(body)}; {cycles} SM clocks ({ms:.3f} ms, "
              f"{cycles / ms / 1e6:.3f} GHz); results per SM per clock: {rates}; all "
              f"{sum(body.values()) * per:.2f}", flush=True)
        fma, alu = _pipes(body)
        pipe_rates["ghz"] = min(pipe_rates["ghz"], cycles / ms / 1e6)
        if kind == 0:
            pipe_rates["alu"] = alu * per
        elif kind == 1:
            pipe_rates["fma"] = fma * per
        elif kind == 11:
            pipe_rates["lop3_shf"], pipe_rates["lop3_shf_ghz"] = alu * per, cycles / ms / 1e6
    return pipe_rates


WGMMA_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
template <int N> struct W;
template <> struct W<16> {
  static __device__ __forceinline__ void ss(int32_t* d, uint64_t a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 {%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p;\n}\n"
      : "+r"(d[0]),"+r"(d[1]),"+r"(d[2]),"+r"(d[3]),"+r"(d[4]),"+r"(d[5]),"+r"(d[6]),"+r"(d[7]) : "l"(a), "l"(b));
  }
  static __device__ __forceinline__ void rs(int32_t* d, const uint32_t* a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 {%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p;\n}\n"
      : "+r"(d[0]),"+r"(d[1]),"+r"(d[2]),"+r"(d[3]),"+r"(d[4]),"+r"(d[5]),"+r"(d[6]),"+r"(d[7]) : "r"(a[0]),"r"(a[1]),"r"(a[2]),"r"(a[3]), "l"(b));
  }
};
#define R16(X) X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15)
template <> struct W<32> {
  static __device__ __forceinline__ void ss(int32_t* d, uint64_t a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]),"+r"(d[1]),"+r"(d[2]),"+r"(d[3]),"+r"(d[4]),"+r"(d[5]),"+r"(d[6]),"+r"(d[7]),"+r"(d[8]),"+r"(d[9]),"+r"(d[10]),"+r"(d[11]),"+r"(d[12]),"+r"(d[13]),"+r"(d[14]),"+r"(d[15]) : "l"(a), "l"(b));
  }
  static __device__ __forceinline__ void rs(int32_t* d, const uint32_t* a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p;\n}\n"
      : "+r"(d[0]),"+r"(d[1]),"+r"(d[2]),"+r"(d[3]),"+r"(d[4]),"+r"(d[5]),"+r"(d[6]),"+r"(d[7]),"+r"(d[8]),"+r"(d[9]),"+r"(d[10]),"+r"(d[11]),"+r"(d[12]),"+r"(d[13]),"+r"(d[14]),"+r"(d[15]) : "r"(a[0]),"r"(a[1]),"r"(a[2]),"r"(a[3]), "l"(b));
  }
};
template <> struct W<64> {
  static __device__ __forceinline__ void ss(int32_t* d, uint64_t a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p;\n}\n"
      : "+r"(d[0]),"+r"(d[1]),"+r"(d[2]),"+r"(d[3]),"+r"(d[4]),"+r"(d[5]),"+r"(d[6]),"+r"(d[7]),"+r"(d[8]),"+r"(d[9]),"+r"(d[10]),"+r"(d[11]),"+r"(d[12]),"+r"(d[13]),"+r"(d[14]),"+r"(d[15]),
        "+r"(d[16]),"+r"(d[17]),"+r"(d[18]),"+r"(d[19]),"+r"(d[20]),"+r"(d[21]),"+r"(d[22]),"+r"(d[23]),"+r"(d[24]),"+r"(d[25]),"+r"(d[26]),"+r"(d[27]),"+r"(d[28]),"+r"(d[29]),"+r"(d[30]),"+r"(d[31]) : "l"(a), "l"(b));
  }
  static __device__ __forceinline__ void rs(int32_t* d, const uint32_t* a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\nwgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p;\n}\n"
      : "+r"(d[0]),"+r"(d[1]),"+r"(d[2]),"+r"(d[3]),"+r"(d[4]),"+r"(d[5]),"+r"(d[6]),"+r"(d[7]),"+r"(d[8]),"+r"(d[9]),"+r"(d[10]),"+r"(d[11]),"+r"(d[12]),"+r"(d[13]),"+r"(d[14]),"+r"(d[15]),
        "+r"(d[16]),"+r"(d[17]),"+r"(d[18]),"+r"(d[19]),"+r"(d[20]),"+r"(d[21]),"+r"(d[22]),"+r"(d[23]),"+r"(d[24]),"+r"(d[25]),"+r"(d[26]),"+r"(d[27]),"+r"(d[28]),"+r"(d[29]),"+r"(d[30]),"+r"(d[31]) : "r"(a[0]),"r"(a[1]),"r"(a[2]),"r"(a[3]), "l"(b));
  }
};
// NACC accumulators, 16 wgmmas a group (acc[(i + j) % NACC], K5's pattern at NACC = 7), GROUPS
// groups between waits; operands at fixed shared-memory addresses (their values do not matter)
template <int N, int NACC, bool RS, int GROUPS>
__global__ void __launch_bounds__(256, 1) bench(int iters, long long* cyc, int* sink) {
  __shared__ __align__(128) uint8_t sm[40 * 1024];
  for (int e = threadIdx.x; e < 10240; e += blockDim.x) reinterpret_cast<uint32_t*>(sm)[e] = e * 2654435761u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  int32_t acc[NACC][N / 2];
  for (int s = 0; s < NACC; ++s) for (int k = 0; k < N / 2; ++k) acc[s][k] = 0;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sm);
  uint32_t a[4][4];
  for (int i = 0; i < 4; ++i) for (int k = 0; k < 4; ++k) a[i][k] = reinterpret_cast<uint32_t*>(sm)[threadIdx.x * 4 + k + i];
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint64_t da = make_desc(base + i * 2048 + g * 256, 128, 256);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint64_t db = make_desc(base + 16384 + j * 4096 + g * 256, 128, 256);
          if (RS) W<N>::rs(acc[(i + j) % NACC], a[i], db); else W<N>::ss(acc[(i + j) % NACC], da, db);
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  int x = 0;
  for (int s = 0; s < NACC; ++s) for (int k = 0; k < N / 2; ++k) x ^= acc[s][k];
  const long long t1 = clock64();
  sink[blockIdx.x * blockDim.x + threadIdx.x] = x;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
template <int N, int NACC, bool RS, int GROUPS>
void run(int blocks, int threads, int iters, long long* cyc, int* sink) { bench<N, NACC, RS, GROUPS><<<blocks, threads>>>(iters, cyc, sink); }
extern "C" int wg_run(int kind, int blocks, int threads, int iters, long long* cyc, int* sink) {
  using F = void (*)(int, int, int, long long*, int*);
  static const F f[] = {run<16, 7, false, 8>, run<32, 7, false, 8>, run<64, 4, false, 8>, run<32, 1, false, 8>,
                        run<32, 7, true, 8>};
  f[kind](blocks, threads, iters, cyc, sink);
  return (int)cudaGetLastError();
}
"""
WGMMA_KINDS = (("m64n16k32 SS, 7 accumulators", 16), ("m64n32k32 SS, 7 accumulators", 32),
               ("m64n64k32 SS, 4 accumulators", 64), ("m64n32k32 SS, 1 accumulator", 32),
               ("m64n32k32 RS (A in registers), 7 accumulators", 32))


def wgmma(torch, dev, args) -> None:
    """u8 x u8 -> s32 wgmma throughput by shape and operand source: a
    kernel issuing groups of 16 wgmmas (K5's limb products) back to back,
    one and two warpgroups a block, one block a SM; prints clocks per
    wgmma and the SM's int8 multiply-adds per clock against the data
    sheet's 4,096 (1,979 TOPS over 132 SMs at 1.83 GHz), and ptxas's
    serialization notes (C7511/C7512)."""
    import ctypes

    from tpu_stark_torch import kernels

    out_dir = os.path.join(BUILD_OUT, "wgmma")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "wgmma_bench.cu"), os.path.join(out_dir, "libwgmma_bench.so")
    with open(cu, "w") as f:
        f.write(WGMMA_SRC)
    build = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", so, cu],
                           capture_output=True, text=True, timeout=600)
    if build.returncode != 0:
        raise RuntimeError(f"nvcc failed on the wgmma bench:\n{build.stdout}{build.stderr}")
    for ln in (build.stdout + build.stderr).splitlines():
        if "C7511" in ln or "C7512" in ln:
            print("ptxas: " + ln.strip()[:200], flush=True)
    lib = ctypes.CDLL(so)
    lib.wg_run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.wg_run.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cyc = torch.zeros(sms, dtype=torch.int64, device=dev)
    sink = torch.zeros(sms * 256, dtype=torch.int32, device=dev)
    iters, groups = 200, 8
    for kind, (label, n) in enumerate(WGMMA_KINDS):
        for threads in (128, 256):
            for _ in range(2):  # the first run warms up
                kernels.check(lib.wg_run(kind, sms, threads, iters, cyc.data_ptr(), sink.data_ptr()), "the wgmma bench")
                torch.cuda.synchronize()
            clocks = int(cyc.max())
            per_wg = iters * groups * 16
            macs = 64 * n * 32 * per_wg * (threads // 128)
            print(f"{label}, {threads // 128} warpgroup(s): {clocks / per_wg:.1f} clocks a wgmma a warpgroup; "
                  f"{macs / clocks:.0f} int8 MAC per SM per clock ({100 * macs / clocks / 4096:.0f}% of 4,096)",
                  flush=True)

def open_timing(torch, dev, args) -> None:
    """K9 and K10 at phase 25's shapes; see the module docstring."""
    import hashlib
    import time

    from tpu_stark_torch.commit import open_kernel as ok
    from tpu_stark_torch.fields import babybear as bb
    from tpu_stark_torch.fields import extension as ext4

    cs = _chip_smoke()
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)

    def rand(shape):
        return torch.randint(0, bb.P, shape, generator=gen, dtype=torch.int32, device=dev)

    def point():
        return tuple(int(v) for v in rand((4,)).cpu().tolist())

    one_launch = hasattr(ok, "division_poly")  # K9 takes a list of points, all in one launch
    for spec in cs.OPEN_ROWS:
        kind, label, n, log_h, row0, w, npts, natural, with_ext = spec
        if kind == "K9":
            mats = [rand(((1 << log_h) if natural else n, w))] if w else []
            apows, acc = rand((w, 4)), rand((n, 4))
            ext = rand((n, 4)) if with_ext else None
            pts = [(point(), point()) for _ in range(npts)]
            scales = [(1, 0, 0, 0), point()] if npts == 2 else None
            if one_launch:
                def call(acc=acc, mats=mats, apows=apows, pts=pts, ext=ext, scales=scales):
                    return ok.reduced_opening(acc, mats, apows, log_h, row0, pts, natural, ext, scales)
            elif npts < 2:
                def call(acc=acc, mats=mats, apows=apows, pts=pts, ext=ext):
                    return ok.reduced_opening(acc, mats, apows, log_h, row0, pts[0] if pts else None, natural, ext)
            else:
                scaled = [ext4.mul(apows, ext4.scalar(c, dev)[None, :]) for c in scales]
                ext_s = [None if ext is None else ext4.mul(ext, ext4.scalar(c, dev)[None, :]) for c in scales]

                def call(acc=acc, mats=mats, scaled=scaled, pts=pts, ext_s=ext_s):
                    for ap, pt, ex in zip(scaled, pts, ext_s):
                        ok.reduced_opening(acc, mats, ap, log_h, row0, pt, natural, ex)
                    return acc
            names = ("reduced_opening",)
        else:
            coeffs = rand((n, w))
            zs = [point() for _ in range(npts)]

            def call(coeffs=coeffs, zs=zs, r0=row0):
                return ok.eval_at_points(coeffs, zs, r0)
            names = ("eval_points",)
        bound = cs.open_row_bound(spec)
        out = call()
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        ms = cs._cuda_ms(torch, call, 10, queued=True)
        t0 = time.perf_counter()
        for _ in range(10):
            call()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and any(k in e.name for k in names))
        print(f"open {kind} {label} ({n}, {w}, {npts} point(s)): {ms:.4f} ms (events), host {host_ms:.4f} ms a call, "
              f"kernels {dev_us / 1e4:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}, {100 * bound[0] / ms:.1f} %); "
              f"output {digest}", flush=True)
        del out



def k8_timing(torch, dev, args) -> None:
    """K8 at phase 24's cosets; see the module docstring."""
    import hashlib
    import inspect
    import re

    from tpu_stark_torch import kernels
    from tpu_stark_torch.air import quotient_kernel as qk
    from tpu_stark_torch.fields import babybear as bb

    cs = _chip_smoke()
    build = kernels.build(force=True)
    source = build.log.split("== quotient.cu", 1)[-1].split("\n== ", 1)[0]
    inst, lines = None, []
    for ln in source.splitlines():
        m = re.search(r"panel_fold_kernelILi(\d+)ELi(\d+)ELi(\d+)E", ln)
        if m and "Compiling entry" in ln:
            inst = "<{}, {}, {}>".format(*m.groups())
        elif inst and ("stack frame" in ln or "Used" in ln):
            lines.append(f"{inst} {ln.split(':', 1)[-1].strip()}")
    print(f"nvcc build {build.seconds:.2f}s; panel_fold_kernel<R, F, V> ptxas: " + " | ".join(lines), flush=True)
    one_pass = "r" in inspect.signature(qk.panel_fold).parameters
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    log_n = 20
    for label, runs, u, r in cs.K8_COSETS:
        n_coef, log_m = runs << log_n, log_n - (r.bit_length() - 1)
        tf = torch.randint(0, bb.P, (n_coef, u), generator=gen, dtype=torch.int32, device=dev)
        shift = 31 * pow(bb.two_adic_generator(22), 3, bb.P) % bb.P
        g = bb.two_adic_generator(log_n)
        if one_pass:
            def call(tf=tf, log_m=log_m, shift=shift, r=r):
                return qk.panel_fold(tf, log_m, shift, r)
        else:  # an older tree: one launch a block
            def call(tf=tf, log_m=log_m, shift=shift, r=r, g=g):
                return [qk.panel_fold(tf, log_m, shift * pow(g, k, bb.P) % bb.P) for k in range(r)]
        out = call()
        out = torch.stack(out) if isinstance(out, list) else out
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        del out
        ms = cs._cuda_ms(torch, call, 10, queued=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and "panel_fold_kernel" in e.name]
        bound, by = cs.panel_fold_bound(n_coef, u, 1 << log_m, r)
        print(f"k8 {label} ({n_coef}, {u}) -> {r} x {1 << log_m} rows: {ms:.4f} ms (events), kernels "
              f"{sum(e.time_range.elapsed_us() for e in evs) / 1e4:.4f} ms in {len(evs) // 10} launch(es) a coset; "
              f"bound {bound:.4f} ms ({by}, {100 * bound / ms:.1f} %); output {digest}", flush=True)
        del tf


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", choices=("profile", "warm", "verify", "k2", "p2", "k1", "grind", "k5", "k7", "k8",
                                         "open", "sass", "probe", "wgmma"))
    parser.add_argument("--log-n", type=int, help="rows, log2 (profile: 20 for keccak-air, 18 for the chain; verify: 20)")
    parser.add_argument("--workload", choices=("keccak", "keccak-zk", "chain", "fib", "config2"), default="keccak",
                        help="what profile proves")
    parser.add_argument("--reps", type=int, default=4, help="warm proves per configuration (warm, profile)")
    parser.add_argument("--tree", help="import tpu_stark_torch from this directory "
                        "(warm, profile, k2, p2, k1, grind, k5, k7, k8, open, sass)")
    parser.add_argument("--from", dest="from_file", help="sass: read a saved cuobjdump -sass listing (no card)")
    parser.add_argument("--phases", action="store_true", help="k5: also the kernel's SM clocks by phase")
    parser.add_argument("--sass-out", help="k7: write each DAG's kernel SASS to this directory")
    parser.add_argument("--lowmem-log", type=int,
                        help="profile (fib, config2): create_config(lowmem_log=N); 0 switches the levers off")
    parser.add_argument("--pcs-from", help="take TwoAdicFriPcs.open (warm) or also time .verify (verify) "
                        "from this directory's tree")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else ROOT)
    if args.from_file:
        sass(None, None, args)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("port_timing: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import tpu_stark_torch

    print(f"card: {_smi_line()}; tpu_stark_torch from {os.path.dirname(tpu_stark_torch.__file__)}", flush=True)
    dev = torch.device("cuda", 0)
    {"profile": profile, "warm": warm, "verify": verify_timing, "k2": k2_timing, "p2": p2_timing,
     "k1": k1_timing, "grind": grind_timing, "k5": k5_timing, "k7": k7_timing, "k8": k8_timing,
     "open": open_timing, "sass": sass, "probe": probe, "wgmma": wgmma}[args.what](torch, dev, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
