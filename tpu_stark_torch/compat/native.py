"""ctypes bridge to the port's C host helper (``csrc/host/tpu_stark_native.c``):
bulk SmallRng sampling, Keccak-256, the Keccak sponge over u64 items and the
width-16 Poseidon2 permutation and row hash.

The library is built with the system C compiler at first use into
``tpu_stark_torch/build/`` (written to a temporary name and renamed, so
concurrent first uses do not race).  Every function returns ``None`` when
no compiler is available; each caller then runs its pure-Python version.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "host", "tpu_stark_native.c")
SO = os.path.join(_PKG, "build", "libtpu_stark_torch_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    if os.path.exists(SO) and os.path.getmtime(SO) >= os.path.getmtime(SRC):
        return True
    os.makedirs(os.path.dirname(SO), exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.tmp"
    for flags in (["-O3", "-march=native"], ["-O3"]):
        try:
            subprocess.run(["cc", *flags, "-shared", "-fPIC", "-o", tmp, SRC],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, SO)
        return True
    return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        lib = ctypes.CDLL(SO)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.ts_xoshiro_seed.argtypes = [ctypes.c_uint64, u64p]
        lib.ts_xoshiro_fill_babybear.argtypes = [u64p, u32p, ctypes.c_size_t]
        lib.ts_xoshiro_next_u64.argtypes = [u64p]
        lib.ts_xoshiro_next_u64.restype = ctypes.c_uint64
        lib.ts_keccak256.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint8)]
        lib.ts_keccakf.argtypes = [u64p]
        lib.ts_sponge_u64.argtypes = [u64p, ctypes.c_size_t, u64p]
        lib.ts_p2_permute16.argtypes = [u32p, u32p, u32p, ctypes.c_int, u32p]
        lib.ts_p2_hash_row.argtypes = [u32p, ctypes.c_size_t, u32p, u32p, ctypes.c_int, u32p, u32p]
        _lib = lib
        return _lib


def keccak256_native(data: bytes) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    out = (ctypes.c_uint8 * 32)()
    lib.ts_keccak256(data, len(data), out)
    return bytes(out)


def sponge_u64_native(items) -> Optional[tuple]:
    """PaddingFreeSponge<KeccakF, 25, 17, 4> over u64 items."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(items)
    arr = (ctypes.c_uint64 * max(n, 1))(*[v & ((1 << 64) - 1) for v in items])
    out = (ctypes.c_uint64 * 4)()
    lib.ts_sponge_u64(arr, n, out)
    return tuple(out)


def p2_permute16_native(state, ext_rc, int_rc, diag) -> Optional[list]:
    """Width-16 Poseidon2 permutation of canonical ints; the caller passes
    its round constants as ctypes arrays."""
    lib = get_lib()
    if lib is None:
        return None
    st = (ctypes.c_uint32 * 16)(*[int(x) % 0x78000001 for x in state])
    lib.ts_p2_permute16(st, ext_rc, int_rc, len(int_rc), diag)
    return list(st)


def p2_hash_row_native(vals, ext_rc, int_rc, diag) -> Optional[tuple]:
    """PaddingFreeSponge<Poseidon2_16, 16, 8, 8> over one row of canonical ints."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(vals)
    arr = (ctypes.c_uint32 * max(n, 1))(*[int(v) % 0x78000001 for v in vals])
    out = (ctypes.c_uint32 * 8)()
    lib.ts_p2_hash_row(arr, n, ext_rc, int_rc, len(int_rc), diag, out)
    return tuple(out)
