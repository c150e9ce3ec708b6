"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface (no PyTorch headers: seconds, not minutes), at
first use, into ``tpu_stark_torch/build/``: one ``nvcc -c`` per source, all
started together, then one link.  The library is loaded with
ctypes; each entry point launches on the stream it is given and returns the
launch's ``cudaGetLastError()`` status, which ``check`` turns into an
exception.

K7's sources are generated from the AIRs' constraint DAGs
(``air/quotient_kernel.py``): ``build_generated`` writes each text to
``BUILD_DIR`` under the SHA-256 of the text, its headers and the flags, and
compiles each into a shared library of its own, all at once; a library
whose hash is built already is reused.

``KernelInfo`` records what each kernel replaces and counts its launches:
a wrapper adds one where it launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("keccak_sponge.cu", "ntt.cu", "poseidon2_sponge.cu", "mxu_ntt.cu", "sol_probes.cu", "threefry.cu",
           "quotient.cu", "open.cu")
HEADERS = ("babybear.cuh", "ext4.cuh")
GENERATED_HEADERS = ("babybear.cuh", "quotient_eval.cuh")  # what K7's generated sources include
LIB_PATH = os.path.join(BUILD_DIR, "libtpu_stark_torch_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class KernelInfo:
    name: str
    source: str  # path in the repo
    replaces: str  # file:line of the TPU kernel
    launches: int = 0


KECCAK_SPONGE = KernelInfo(
    "keccak_sponge", "tpu_stark_torch/csrc/keccak_sponge.cu",
    "tpu_stark/hash/pallas_keccak.py:56",
)
# the compress layers of a Merkle tree, several levels a launch
KECCAK_TREE = KernelInfo(
    "keccak_tree", "tpu_stark_torch/csrc/keccak_sponge.cu",
    "tpu_stark/hash/pallas_keccak.py:56",
)
# the carried-state absorb of the streamed Keccak commit; its JAX
# counterpart is XLA (no Pallas kernel)
KECCAK_ABSORB = KernelInfo(
    "keccak_absorb", "tpu_stark_torch/csrc/keccak_sponge.cu",
    "tpu_stark/hash/sponge.py:99",
)
NTT_PASS0 = KernelInfo(
    "ntt_pass0", "tpu_stark_torch/csrc/ntt.cu",
    "tpu_stark/ntt/pallas_ntt.py:114",
)
NTT_PASS = KernelInfo(
    "ntt_pass", "tpu_stark_torch/csrc/ntt.cu",
    "tpu_stark/ntt/pallas_ntt.py:142",
)
POSEIDON2_SPONGE = KernelInfo(
    "poseidon2_sponge", "tpu_stark_torch/csrc/poseidon2_sponge.cu",
    "tpu_stark/hash/pallas_poseidon2.py:68",
)
POSEIDON2_ABSORB = KernelInfo(
    "poseidon2_absorb", "tpu_stark_torch/csrc/poseidon2_sponge.cu",
    "tpu_stark/hash/pallas_poseidon2.py:167",
)
MXU_MM = KernelInfo(
    "mxu_mm", "tpu_stark_torch/csrc/mxu_ntt.cu",
    "tpu_stark/ntt/mxu_ntt.py:167",
)
# no Pallas counterpart: it replaces the JAX package's XLA grind program
KECCAK_GRIND = KernelInfo(
    "keccak_grind", "tpu_stark_torch/csrc/keccak_sponge.cu",
    "tpu_stark/challenger/grind.py:74",
)
# K6, the device zk rng's Monty sample; its JAX counterpart is XLA (no
# Pallas kernel): the sample program of the JAX package's device rng
THREEFRY_MONTY = KernelInfo(
    "threefry_monty", "tpu_stark_torch/csrc/threefry.cu",
    "tpu_stark/compat/device_rng.py:41",
)
# K7, the quotient pass's constraint evaluation and alpha fold, generated
# per constraint DAG around csrc/quotient_eval.cuh; its JAX counterparts are
# XLA (no Pallas kernel): the class program tpu_stark/prover/wide.py:700
# _class_eval_fn and the dense tpu_stark/prover/prove.py:47 _quotient_fn
QUOTIENT_EVAL = KernelInfo(
    "quotient_eval", "tpu_stark_torch/csrc/quotient_eval.cuh",
    "tpu_stark/prover/wide.py:700",
)
# K8, the streamed quotient's panel coset fold, all row blocks of a coset in
# one pass; its JAX counterpart is the fold and scale of the XLA program
# tpu_stark/prover/wide.py:646, once a block
PANEL_FOLD = KernelInfo(
    "panel_fold", "tpu_stark_torch/csrc/quotient.cu",
    "tpu_stark/prover/wide.py:646",
)
# K9-K11, the open phase's PCS arithmetic (commit/open_kernel.py); their
# JAX counterparts are XLA (no Pallas kernel): K9 the reduced opening,
# tpu_stark/commit/pcs.py:1005 _reduced_quotient with :976 _combine_columns
# (streamed: tpu_stark/prover/wide.py:341 reduced_contrib), K10 the
# out-of-domain evaluation, :227 _eval_at_point (streamed: wide.py:329), K11
# the FRI fold, :1042 _fold_codeword (:1094 _fold_eo_jit)
REDUCED_OPENING = KernelInfo(
    "reduced_opening", "tpu_stark_torch/csrc/open.cu",
    "tpu_stark/commit/pcs.py:1005",
)
EVAL_AT_POINTS = KernelInfo(
    "eval_at_points", "tpu_stark_torch/csrc/open.cu",
    "tpu_stark/commit/pcs.py:227",
)
FRI_FOLD = KernelInfo(
    "fri_fold", "tpu_stark_torch/csrc/open.cu",
    "tpu_stark/commit/pcs.py:1042",
)
OPEN_KERNELS = (REDUCED_OPENING, EVAL_AT_POINTS, FRI_FOLD)
# the speed-of-light probes of bench/sol.py; they replace its XLA probes
SOL_MUL = KernelInfo(
    "sol_mul_probe", "tpu_stark_torch/csrc/sol_probes.cu",
    "tpu_stark/bench/sol.py:235",
)
SOL_ALU = KernelInfo(
    "sol_alu_probe", "tpu_stark_torch/csrc/sol_probes.cu",
    "tpu_stark/bench/sol.py:268",
)
SOL_HBM = KernelInfo(
    "sol_hbm_probe", "tpu_stark_torch/csrc/sol_probes.cu",
    "tpu_stark/bench/sol.py:301",
)
SOL_PROBES = (SOL_MUL, SOL_ALU, SOL_HBM)
ALL = (KECCAK_SPONGE, KECCAK_TREE, KECCAK_ABSORB, NTT_PASS0, NTT_PASS, POSEIDON2_SPONGE, POSEIDON2_ABSORB, MXU_MM,
       KECCAK_GRIND, THREEFRY_MONTY, QUOTIENT_EVAL, PANEL_FOLD) + OPEN_KERNELS + SOL_PROBES


def reset_launch_counts() -> None:
    for k in ALL:
        k.launches = 0


@dataclasses.dataclass
class BuildResult:
    path: str
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str  # nvcc's output (ptxas register / shared-memory report)


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def up_to_date() -> bool:
    """Whether LIB_PATH exists and is newer than every source."""
    newest = max(os.path.getmtime(os.path.join(SRC_DIR, f)) for f in SOURCES + HEADERS)
    return os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest


def _nvcc_all(jobs, what: str, timeout: int = 1200) -> Dict[str, tuple]:
    """Run one nvcc for each job (label, arguments, output file), all
    started together, each writing a temporary of its own that replaces
    ``output`` when that nvcc succeeds.  Returns label -> (seconds from the
    start to its end, nvcc's output); raises, naming every job that failed.
    A compile still running when it returns or raises is killed, and the
    temporaries are removed."""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs, done, failed = [], {}, []
    try:
        for label, args, out in jobs:
            stem, ext = os.path.splitext(out)
            tmp = f"{stem}.{os.getpid()}.tmp{ext}"
            procs.append((label, out, tmp, subprocess.Popen(
                [nvcc, *args, "-o", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for label, out, tmp, proc in procs:
            log, _ = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                failed.append(f"== {label}\n{log}")
                continue
            os.replace(tmp, out)
            done[label] = (time.perf_counter() - t0, log)
        if failed:
            raise RuntimeError(f"nvcc failed on {what}:\n" + "\n".join(failed))
    finally:
        for _label, _out, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return done


def build(force: bool = False) -> BuildResult:
    """Compile csrc/*.cu into LIB_PATH unless an up-to-date library exists:
    every source to an object in parallel, then one shared-library link."""
    if not force and up_to_date():
        return BuildResult(LIB_PATH, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    objs = [os.path.join(BUILD_DIR, f"{s}.{os.getpid()}.o") for s in SOURCES]
    t0 = time.perf_counter()
    try:
        compiled = _nvcc_all([(s, [*NVCC_FLAGS, "-c", os.path.join(SRC_DIR, s)], o) for s, o in zip(SOURCES, objs)],
                             "the kernel sources", 600)
        linked = _nvcc_all([("link", ["-gencode", "arch=compute_90a,code=sm_90a", "-shared", *objs], LIB_PATH)],
                           "the link", 600)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    log = "".join(f"== {s}\n{compiled[s][1]}" for s in SOURCES) + linked["link"][1]
    return BuildResult(LIB_PATH, time.perf_counter() - t0, log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build().path)
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            so.ts_keccak_rows.argtypes = [vp, i64, vp, i64, vp, vp]
            so.ts_keccak_rows.restype = i32
            so.ts_keccak_tree.argtypes = [vp, i64, i32, i32, vp, vp]
            so.ts_keccak_tree.restype = i32
            so.ts_keccak_absorb.argtypes = [vp, i64, i32, vp, i64, i64, i64, vp, i64, i64, i32, i32, i32, i32, vp, vp]
            so.ts_keccak_absorb.restype = i32
            so.ts_ntt_pass.argtypes = [vp, vp, i64, i32, i32, i32, i32, i32, i32, i32, vp, vp]
            so.ts_ntt_pass.restype = i32
            so.ts_poseidon2_rows.argtypes = [vp, i64, i64, vp, i64, i64, i64, i32, vp, vp]
            so.ts_poseidon2_rows.restype = i32
            so.ts_poseidon2_absorb.argtypes = [vp, vp, i64, i64, i64, i32, vp]
            so.ts_poseidon2_absorb.restype = i32
            so.ts_mxu_mm.argtypes = [vp, vp, vp, vp, i32, i64, i64, vp]
            so.ts_mxu_mm.restype = i32
            so.ts_keccak_grind.argtypes = [vp, vp] + [i32] * 8 + [ctypes.c_uint64, i64, vp, vp]
            so.ts_keccak_grind.restype = i32
            u32 = ctypes.c_uint32
            so.ts_threefry_monty.argtypes = [u32, u32, u32, u32, i64, vp, i64, i64, vp, i64, vp, vp]
            so.ts_threefry_monty.restype = i32
            for entry in (so.ts_panel_fold, so.ts_reduced_opening, so.ts_eval_at_points, so.ts_fri_fold):
                entry.argtypes = [vp, vp, vp]  # the words, the u32 constants, the stream
                entry.restype = i32
            so.ts_sol_mul.argtypes = [vp, vp, vp, i64, i32, vp]
            so.ts_sol_mul.restype = i32
            so.ts_sol_alu.argtypes = [vp, vp, i64, i32, vp]
            so.ts_sol_alu.restype = i32
            so.ts_sol_stream.argtypes = [vp, i64, vp]
            so.ts_sol_stream.restype = i32
            _lib = so
        return _lib


def _generated_paths(key: str, text: str):
    h = hashlib.sha256(text.encode())
    for name in GENERATED_HEADERS:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = f"{key}_{h.hexdigest()[:16]}"
    return os.path.join(BUILD_DIR, f"q_{tag}.cu"), os.path.join(BUILD_DIR, f"libts_q_{tag}.so")


def build_generated(texts: Dict[str, str], force: bool = False) -> Dict[str, BuildResult]:
    """Compile each generated source (key -> text) into a shared library of
    its own unless one of the same hash exists: the texts are written to
    BUILD_DIR and every nvcc is started together.  Returns key ->
    BuildResult (seconds from the start of the compiles to this one's end;
    0.0 for a reused library)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, jobs = {}, []
    for key, text in texts.items():
        src, so = _generated_paths(key, text)
        if not force and os.path.exists(so):
            out[key] = BuildResult(so, 0.0, "")
            continue
        tmp_src = f"{src}.{os.getpid()}.tmp.cu"
        with open(tmp_src, "w") as f:
            f.write(text)
        os.replace(tmp_src, src)
        jobs.append((key, src, so))
    if jobs:
        built = _nvcc_all([(key, [*NVCC_FLAGS, "-I", SRC_DIR, "-shared", src], so) for key, src, so in jobs],
                          "the generated quotient kernels")
        for key, _src, so in jobs:
            out[key] = BuildResult(so, *built[key])
    return out


_generated: Dict[str, ctypes.CDLL] = {}


def generated_lib(key: str, text: str) -> ctypes.CDLL:
    """The loaded library of a generated source (built on first call)."""
    with _lock:
        so = _generated.get(key)
        if so is None:
            so = _generated[key] = ctypes.CDLL(build_generated({key: text})[key].path)
        return so


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {status}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
