"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface (no PyTorch headers: seconds, not minutes), at
first use, into ``tpu_stark_torch/build/``.  The library is loaded with
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
SOURCES = ("keccak_sponge.cu", "ntt.cu")
LIB_PATH = os.path.join(BUILD_DIR, "libtpu_stark_torch_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
ALL = (KECCAK_SPONGE, NTT_PASS0, NTT_PASS)


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
    """Compile csrc/*.cu into LIB_PATH unless an up-to-date library exists."""
    srcs = [os.path.join(SRC_DIR, s) for s in SOURCES]
    newest = max(os.path.getmtime(s) for s in srcs)
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= newest):
        return BuildResult(LIB_PATH, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
        capture_output=True, text=True, timeout=600,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, LIB_PATH)
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
            so.ts_ntt_pass0.argtypes = [vp, vp, i64, i32, i32, i32, i32, vp, vp, vp]
            so.ts_ntt_pass0.restype = i32
            so.ts_ntt_pass.argtypes = [vp, i64, i32, i32, i32, i32, i32, vp, vp, vp]
            so.ts_ntt_pass.restype = i32
            _lib = so
        return _lib


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {status}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
