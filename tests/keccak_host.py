"""``csrc/keccak_sponge.cu`` as a host library (``cuda_host``'s shim and
the intrinsics K1 adds): the card's C entry points ``ts_keccak_absorb`` and
``ts_keccak_grind`` take the source's own operand checks (``absorb_args``,
``grind_args``) and loop the carried-state absorb's and the grind's device
functions over every row (the absorb's rows are independent) or every
candidate, so that their index and field logic runs on the CPU through the
port's wrappers."""

import ctypes
import pathlib

from cuda_host import gxx, shim_dir

HOST = """
#include <cstdint>
#include <vector>
#define __constant__
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (uint64_t(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= uint32_t((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
#include "keccak_sponge.cu"
// the absorb: each row's thread alone (a row is one thread's: no barrier)
extern "C" int ts_keccak_absorb(uint32_t* state, int64_t n, int log_n, const uint32_t* pend, int64_t p, int64_t prs,
                                int64_t pcs, const uint32_t* mat, int64_t k, int64_t ms, int first, int rev, int monty,
                                int fin, uint32_t* out, void*) {
  AbsorbArgs a;
  if (const int status = absorb_args(state, n, log_n, pend, p, prs, pcs, mat, k, ms, first, rev, monty, fin, out, a))
    return status;
  std::vector<uint32_t> row(kStageStride);
  absorb_flags(fin, rev, monty, [&](auto f, auto r, auto m) {
    for (int64_t i = 0; i < n; ++i)
      absorb_row<decltype(f)::value, decltype(r)::value, decltype(m)::value>(a, row.data(), i);
  });
  return 0;
}
// the grind: a block's constants, then every candidate
extern "C" int ts_keccak_grind(const uint64_t* prefix, const uint64_t* tail, int n_blocks, int wb0, int wl0, int ws0,
                               int wb1, int wl1, int ws1, int bits, uint64_t start, int64_t count, uint8_t* out,
                               void*) {
  GrindArgs a;
  if (const int status = grind_args(prefix, tail, n_blocks, wb0, wl0, ws0, wb1, wl1, ws1, bits, start, count, out, a))
    return status;
  uint32_t sm[kGrindConsts];
  for (int t = 0; t < kGrindThreads; ++t) grind_prologue(a, sm, t);
  for (int64_t c = 0; c < count; ++c) out[c] = grind_verdict(a, sm, uint32_t(start + uint64_t(c)));
  return 0;
}
"""


def build(tmp: pathlib.Path) -> ctypes.CDLL:
    """The host library, its entries typed as ``kernels.lib`` types the
    card's."""
    lib = gxx(shim_dir(tmp), "keccak_host", HOST)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ts_keccak_absorb.argtypes = [vp, i64, i32, vp, i64, i64, i64, vp, i64, i64, i32, i32, i32, i32, vp, vp]
    lib.ts_keccak_grind.argtypes = [vp, vp] + [i32] * 8 + [ctypes.c_uint64, i64, vp, vp]
    lib.ts_keccak_absorb.restype = lib.ts_keccak_grind.restype = i32
    return lib
