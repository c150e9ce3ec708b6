"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface (no PyTorch headers: seconds, not minutes), at
first use, into ``tpu_stark_torch/build/``: one ``nvcc -c`` per source, all
started together, then one link.  The library is loaded with
ctypes; each entry point launches on the stream it is given and returns the
launch's ``cudaGetLastError()`` status, which ``check`` turns into an
exception.

``KernelInfo`` records what each kernel replaces and counts its launches:
a wrapper adds one where it launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("keccak_sponge.cu", "ntt.cu", "poseidon2_sponge.cu", "mxu_ntt.cu")
HEADERS = ("babybear.cuh",)
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
ALL = (KECCAK_SPONGE, NTT_PASS0, NTT_PASS, POSEIDON2_SPONGE, POSEIDON2_ABSORB, MXU_MM, KECCAK_GRIND)


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


def build(force: bool = False) -> BuildResult:
    """Compile csrc/*.cu into LIB_PATH unless an up-to-date library exists:
    every source to an object in parallel, then one shared-library link."""
    srcs = [os.path.join(SRC_DIR, s) for s in SOURCES]
    newest = max(os.path.getmtime(os.path.join(SRC_DIR, f)) for f in SOURCES + HEADERS)
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= newest):
        return BuildResult(LIB_PATH, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    t0 = time.perf_counter()
    procs = []
    log = ""
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)
        ]
        failed = []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate(timeout=600)
            log += f"== {src}\n{out}"
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = f"{LIB_PATH}.{tag}"
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs],
            capture_output=True, text=True, timeout=600,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
        os.replace(tmp, LIB_PATH)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return BuildResult(LIB_PATH, time.perf_counter() - t0, log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build().path)
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            so.ts_keccak_rows.argtypes = [vp, i64, vp, i64, i64, vp, vp]
            so.ts_keccak_rows.restype = i32
            so.ts_ntt_pass.argtypes = [vp, vp, i64, i32, i32, i32, i32, i32, i32, i32, vp, vp]
            so.ts_ntt_pass.restype = i32
            so.ts_poseidon2_rows.argtypes = [vp, i64, i64, vp, i64, i64, i64, i32, vp, vp]
            so.ts_poseidon2_rows.restype = i32
            so.ts_poseidon2_absorb.argtypes = [vp, vp, i64, i64, i64, i32, vp]
            so.ts_poseidon2_absorb.restype = i32
            so.ts_mxu_mm.argtypes = [vp, vp, vp, i32, i64, vp]
            so.ts_mxu_mm.restype = i32
            so.ts_keccak_grind.argtypes = [vp, vp, i32, i32, i32, ctypes.c_uint64, i64, vp, vp]
            so.ts_keccak_grind.restype = i32
            _lib = so
        return _lib


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {status}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
