"""Build a kernel source of ``tpu_stark_torch/csrc`` as a host library:
the CUDA-only spellings become plain C++ under a small ``cuda_runtime.h``
shim (``__device__`` and ``__global__`` vanish, ``__ldg`` reads, the
intrinsics are emulated), and each test writes host entry points with the
card's C names that loop over the kernel's per-item device functions.  So
the kernels' index and field logic runs on the CPU through the port's own
wrappers."""

import ctypes
import pathlib
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "tpu_stark_torch" / "csrc"

SHIM = """#pragma once
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __grid_constant__
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return uint4{x, y, z, w}; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
template <class T> inline T __ldg(const T* p) { return *p; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return uint32_t((uint64_t(a) * b) >> 32); }
inline uint32_t __shfl_down_sync(uint32_t, uint32_t v, int) { return v; }  // host entries never shuffle
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i, x >>= 1) r = (r << 1) | (x & 1);
  return r;
}
"""


def shim_dir(tmp: pathlib.Path) -> pathlib.Path:
    """``tmp`` with the shim as ``shim/cuda_runtime.h``; returns ``tmp``."""
    (tmp / "shim").mkdir(exist_ok=True)
    (tmp / "shim" / "cuda_runtime.h").write_text(SHIM)
    return tmp


def gxx(tmp: pathlib.Path, name: str, text: str) -> ctypes.CDLL:
    """Compile ``text`` (C++ that may include csrc's sources) with g++ into
    a shared library under ``tmp`` (made by ``shim_dir``) and load it."""
    src = tmp / f"{name}.cpp"
    src.write_text(text)
    so = tmp / f"lib{name}.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{tmp / 'shim'}", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))
