// K6: the device zk rng's Monty sample (compat/device_rng.py), JAX's
// Threefry-2x32 stream bit for bit.
//
// Replaces no Pallas kernel: the JAX package runs this sample as one XLA
// program (tpu_stark/compat/device_rng.py:41 _sample_monty: split the key,
// two jax.random.bits draws, from_u32(hi) plus lo reduced by two
// conditional subtracts).  Output element (r, c) of a (rows, n_out) sample
// hashes the u64 flat index i = row * cols + col of the whole (.., cols)
// sample, where row is row0 + r (or row0 + rows_idx[r]) and col is c (or
// sel[c]): the counter pair (i >> 32, i & 0xFFFFFFFF) goes through
// Threefry-2x32 (20 rounds) under k_hi and under k_lo, each pair's output
// words are xored into hi and lo, and the value is (hi * 2^32 + lo) mod P in
// Montgomery form:
// monty_mul(hi, R^2 mod P) = hi * 2^32 mod P (hi < 2^32 and R^2 < P keep the
// product below P * 2^32), lo mod P by two conditional subtracts (2^32 <
// 3P), and a modular add.
//
// Bound: operations.  About 165 int32 instructions an element (two
// Threefry evaluations of 20 rounds of IADD3 + SHF.L.W + LOP3 and 6
// injections, the xors, one Montgomery product, the reductions) against a
// 4-byte store: 41 instructions a byte, four times the card's ratio of issue
// rate to HBM rate.  The design feeds the ALU pipe: the rotations are
// compile-time funnel shifts (one SHF.L.W each), each key injection is one
// IADD3 with its round constant, a thread carries four elements (eight
// independent round chains beside each other), and a whole sample is one
// launch with 64-bit grid-stride indices.  A contiguous sample (no sel, no
// row indices) is a run of consecutive flat indices: four of them a thread,
// stored with one 16-byte store.  A gathered sample (sel or row indices)
// takes a row and four of its output columns a thread.
#include <cuda_runtime.h>

#include <cstdint>

#include "babybear.cuh"

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr uint64_t kR1 = (uint64_t(1) << 32) % ts::P;
constexpr uint32_t kR2 = uint32_t(kR1 * kR1 % ts::P);  // R^2 mod P, R = 2^32
constexpr int kThreads = 256;
constexpr int kElems = 4;  // output elements a thread

struct Key {
  uint32_t k0, k1, k2;  // the two key words and their parity word
};

template <int R>
__device__ __forceinline__ uint32_t rotl(uint32_t x) {
  return __funnelshift_l(x, x, R);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl<R0>(x1) ^ x0;
  x0 += x1; x1 = rotl<R1>(x1) ^ x0;
  x0 += x1; x1 = rotl<R2>(x1) ^ x0;
  x0 += x1; x1 = rotl<R3>(x1) ^ x0;
}

// Threefry-2x32, 20 rounds, of the counter pair (x0, x1); returns x0 ^ x1 of
// the output pair, the u32 that jax.random.bits draws at that counter.
__device__ __forceinline__ uint32_t threefry_bits(const Key& k, uint32_t x0, uint32_t x1) {
  x0 += k.k0; x1 += k.k1;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k.k1; x1 += k.k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k.k2; x1 += k.k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k.k0; x1 += k.k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k.k1; x1 += k.k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k.k2; x1 += k.k0 + 5u;
  return x0 ^ x1;
}

// The Monty residue (hi * 2^32 + lo) mod P of the two draws at flat index i.
__device__ __forceinline__ uint32_t monty_at(const Key& kh, const Key& kl, uint64_t i) {
  const uint32_t c0 = uint32_t(i >> 32), c1 = uint32_t(i);
  const uint32_t hi = threefry_bits(kh, c0, c1);
  uint32_t lo = threefry_bits(kl, c0, c1);
  lo = lo >= ts::P ? lo - ts::P : lo;
  lo = lo >= ts::P ? lo - ts::P : lo;
  return ts::add_mod(ts::monty_mul(hi, kR2), lo);
}

// A contiguous sample: output element o hashes flat index base + o.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) threefry_monty_flat_kernel(Key kh, Key kl, uint64_t base,
                                                                       uint64_t total, uint32_t* __restrict__ out) {
  const uint64_t stride = uint64_t(gridDim.x) * kThreads * kElems;
  for (uint64_t o = (uint64_t(blockIdx.x) * kThreads + threadIdx.x) * kElems; o < total; o += stride) {
    uint32_t v[kElems];
#pragma unroll
    for (int j = 0; j < kElems; ++j) v[j] = monty_at(kh, kl, base + o + j);
    if (VEC && o + kElems <= total) {
      *reinterpret_cast<uint4*>(out + o) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kElems; ++j)
        if (o + j < total) out[o + j] = v[j];
    }
  }
}

// A gathered sample: item t is row t / groups, output columns
// 4 (t % groups) .. + 3 of it; row = row0 + (rows_idx[r] or r), col =
// sel[c] or c.
template <bool VEC>
__global__ void __launch_bounds__(kThreads) threefry_monty_gather_kernel(
    Key kh, Key kl, uint64_t cols, const int64_t* __restrict__ sel, uint64_t n_out, uint64_t row0,
    const int64_t* __restrict__ rows_idx, uint64_t items, uint64_t groups, uint32_t* __restrict__ out) {
  const uint64_t stride = uint64_t(gridDim.x) * kThreads;
  for (uint64_t t = uint64_t(blockIdx.x) * kThreads + threadIdx.x; t < items; t += stride) {
    uint64_t r, g;
    if (groups == 1) {
      r = t, g = 0;
    } else if (items <= 0xFFFFFFFFull) {
      r = uint32_t(t) / uint32_t(groups), g = t - r * groups;
    } else {
      r = t / groups, g = t - r * groups;
    }
    const uint64_t row = row0 + (rows_idx != nullptr ? uint64_t(rows_idx[r]) : r);
    const uint64_t c0 = g * kElems;
    uint32_t v[kElems];
#pragma unroll
    for (int j = 0; j < kElems; ++j) {
      const uint64_t c = c0 + j < n_out ? c0 + j : n_out - 1;  // a ragged group repeats its last column
      const uint64_t col = sel != nullptr ? uint64_t(sel[c]) : c;
      v[j] = monty_at(kh, kl, row * cols + col);
    }
    uint32_t* dst = out + r * n_out + c0;
    if (VEC) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kElems; ++j)
        if (c0 + j < n_out) dst[j] = v[j];
    }
  }
}

Key make_key(uint32_t k0, uint32_t k1) { return Key{k0, k1, k0 ^ k1 ^ kParity}; }

unsigned grid_for(uint64_t work_items) {
  const uint64_t blocks = (work_items + kThreads - 1) / kThreads;
  return unsigned(blocks < (uint64_t(1) << 31) - 1 ? blocks : (uint64_t(1) << 31) - 1);
}

}  // namespace

// The (rows, n_out) int32 Monty sample under the split keys (hi0, hi1) and
// (lo0, lo1) of a sample of cols columns: output columns sel[0 .. n_out) of
// the sample (all cols of them when sel is null, n_out == cols), rows
// row0 + rows_idx[0 .. rows) (row0 .. row0 + rows when rows_idx is null).
// sel and rows_idx are device int64 arrays.  Returns the CUDA error status of
// the launch.
extern "C" int ts_threefry_monty(uint32_t hi0, uint32_t hi1, uint32_t lo0, uint32_t lo1, int64_t cols,
                                 const int64_t* sel, int64_t n_out, int64_t row0, const int64_t* rows_idx,
                                 int64_t rows, uint32_t* out, cudaStream_t stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  if (cols <= 0 || row0 < 0 || (sel == nullptr && n_out != cols)) return (int)cudaErrorInvalidValue;
  const Key kh = make_key(hi0, hi1), kl = make_key(lo0, lo1);
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (sel == nullptr && rows_idx == nullptr) {
    const uint64_t total = uint64_t(rows) * uint64_t(cols);
    const unsigned grid = grid_for((total + kElems - 1) / kElems);
    if (aligned)
      threefry_monty_flat_kernel<true><<<grid, kThreads, 0, stream>>>(kh, kl, uint64_t(row0) * uint64_t(cols),
                                                                      total, out);
    else
      threefry_monty_flat_kernel<false><<<grid, kThreads, 0, stream>>>(kh, kl, uint64_t(row0) * uint64_t(cols),
                                                                       total, out);
    return (int)cudaGetLastError();
  }
  const uint64_t groups = (uint64_t(n_out) + kElems - 1) / kElems;
  const uint64_t items = uint64_t(rows) * groups;
  const unsigned grid = grid_for(items);
  if (aligned && n_out % kElems == 0)
    threefry_monty_gather_kernel<true><<<grid, kThreads, 0, stream>>>(kh, kl, uint64_t(cols), sel, uint64_t(n_out),
                                                                      uint64_t(row0), rows_idx, items, groups, out);
  else
    threefry_monty_gather_kernel<false><<<grid, kThreads, 0, stream>>>(kh, kl, uint64_t(cols), sel, uint64_t(n_out),
                                                                       uint64_t(row0), rows_idx, items, groups, out);
  return (int)cudaGetLastError();
}
