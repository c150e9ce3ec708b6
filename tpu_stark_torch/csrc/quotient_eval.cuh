// K7: the quotient pass's constraint evaluation and alpha fold, the fixed
// part of the kernels that air/quotient_kernel.py generates from an AIR's
// constraint DAG (one struct of row functions a DAG; see that module).
//
// Replaces the JAX package's XLA programs tpu_stark/prover/wide.py:700
// _class_eval_fn (one partition class's constraints and alpha fold,
// jitted per class at :733) with :686 _acc_add_block_fn (the block's
// rows added into the coset accumulator), and tpu_stark/prover/prove.py:47
// _quotient_fn (the dense pass, times 1/Z_H).
//
// A block takes kRows = 32 consecutive output rows t and S warps.  Phase 0
// stages the rows' columns [LO0, LO0 + W0) of the current panel and
// [LO1, LO1 + W1) of the next panel in shared memory: one coalesced copy
// by all threads, kBatch loads in flight a thread, row r at r * (W | 1) words (an odd stride: the 32 lanes
// of a warp, one row each, read 32 banks).  The next row of t is
// (t + nshift) mod nrows_nxt of the next panel.  Phase 1: warp p evaluates
// the p-th slice of the constraints on its lane's row (D::part, generated
// straight-line code) and folds each one as soon as it exists into four
// 64-bit sums of Montgomery products alpha^k * C_k (each below P, so no
// sum overflows), reduced mod P once a row.  Phase 2: lane r of warp 0 adds
// the S partial sums, adds the accumulator's row (add), multiplies by
// inv_zeroifier (invz), and stores row acc_off + t * acc_stride of the
// (N, 4) accumulator.
//
// Bound: bytes for the panels' columns read once, the four selector words,
// the 16-byte accumulator row read and written; the generated code adds a
// few dozen int32 instructions a constraint, a Montgomery product a
// multiply and four a fold.  What the design does about it: one read of
// each panel word from device memory, coalesced, and no intermediate in
// device memory (the eager torch pass wrote int64 temporaries a node).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "babybear.cuh"

namespace tsq {

constexpr int kRows = 32;  // output rows a block, one a lane

struct Args {
  const uint32_t* cur;
  int64_t ld_cur;
  const uint32_t* nxt;
  int64_t ld_nxt, nrows_nxt, nshift;
  const uint32_t* sel[4];  // is_first_row, is_last_row, is_transition, inv_zeroifier
  int64_t sel_off, sel_stride;
  const uint32_t* pis;
  const uint4* alpha;  // (C, 4) Monty alpha powers of this program's constraints
  uint32_t* acc;
  int64_t acc_off, acc_stride, add, invz, rows;
};

// The launch's 20 argument words (quotient_kernel.eval_fold builds them).
inline Args unpack(const int64_t* w) {
  Args a;
  a.cur = reinterpret_cast<const uint32_t*>(w[0]);
  a.ld_cur = w[1];
  a.nxt = reinterpret_cast<const uint32_t*>(w[2]);
  a.ld_nxt = w[3];
  a.nrows_nxt = w[4];
  a.nshift = w[5];
  for (int i = 0; i < 4; ++i) a.sel[i] = reinterpret_cast<const uint32_t*>(w[6 + i]);
  a.sel_off = w[10];
  a.sel_stride = w[11];
  a.pis = reinterpret_cast<const uint32_t*>(w[12]);
  a.alpha = reinterpret_cast<const uint4*>(w[13]);
  a.acc = reinterpret_cast<uint32_t*>(w[14]);
  a.acc_off = w[15];
  a.acc_stride = w[16];
  a.add = w[17];
  a.invz = w[18];
  a.rows = w[19];
  return a;
}

__device__ __forceinline__ uint32_t sel_at(const Args& a, int k, int64_t t) {
  return __ldg(a.sel[k] + a.sel_off + t * a.sel_stride);
}

// acc += alpha^k * c, componentwise (a base value times an extension value)
__device__ __forceinline__ void fold(uint64_t acc[4], const Args& a, int k, uint32_t c) {
  const uint4 al = __ldg(a.alpha + k);
  acc[0] += ts::monty_mul(al.x, c);
  acc[1] += ts::monty_mul(al.y, c);
  acc[2] += ts::monty_mul(al.z, c);
  acc[3] += ts::monty_mul(al.w, c);
}

__host__ __device__ constexpr int stride_of(int w) { return w == 0 ? 0 : (w | 1); }

template <class D>
struct Layout {
  static constexpr int kCur = stride_of(D::W0);
  static constexpr int kNxt = stride_of(D::W1);
  static constexpr int kNxtOff = kRows * kCur;
  static constexpr int kPartOff = kRows * (kCur + kNxt);
  static constexpr int kWordsTotal = kPartOff + D::S * kRows * 4;
};

// Phase 0: the tile's panel columns into shared memory (all threads), kBatch
// loads in flight a thread before their stores.
constexpr int kBatch = 16;

template <int LO, int W>
__device__ __forceinline__ void stage_rows(const uint32_t* src, int64_t ld, int64_t t0, int64_t rows, int64_t shift,
                                           int64_t nrows, uint32_t* dst, int tid, int nthreads) {
  constexpr int kTotal = kRows * W;
  for (int i0 = tid; i0 < kTotal; i0 += nthreads * kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * nthreads, r = i / W;
      const int64_t t = t0 + r;
      v[j] = 0;
      if (i < kTotal && t < rows) {
        int64_t row = t + shift;
        if (row >= nrows) row -= nrows;
        v[j] = __ldg(src + row * ld + LO + (i - r * W));
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * nthreads, r = i / W;
      if (i < kTotal) dst[r * stride_of(W) + (i - r * W)] = v[j];
    }
  }
}

// One phase of a block's work for the thread tid of nthreads (S * 32).
template <class D>
__device__ __forceinline__ void phase(const Args& a, uint32_t* smem, int64_t block, int tid, int nthreads, int ph) {
  using L = Layout<D>;
  const int64_t t0 = block * kRows;
  if (ph == 0) {
    if constexpr (D::W0 > 0) stage_rows<D::LO0, D::W0>(a.cur, a.ld_cur, t0, a.rows, 0, a.rows, smem, tid, nthreads);
    if constexpr (D::W1 > 0)
      stage_rows<D::LO1, D::W1>(a.nxt, a.ld_nxt, t0, a.rows, a.nshift, a.nrows_nxt, smem + L::kNxtOff, tid,
                                nthreads);
  } else if (ph == 1) {
    const int part = tid / kRows, r = tid % kRows;
    const int64_t t = t0 + r;
    if (t >= a.rows) return;
    uint64_t acc[4] = {0, 0, 0, 0};
    D::part(part, a, t, smem + r * L::kCur, smem + L::kNxtOff + r * L::kNxt, acc);
    uint32_t* out = smem + L::kPartOff + (part * kRows + r) * 4;
    for (int i = 0; i < 4; ++i) out[i] = uint32_t(acc[i] % ts::P);
  } else {
    if (tid >= kRows) return;
    const int64_t t = t0 + tid;
    if (t >= a.rows) return;
    const uint32_t* parts = smem + L::kPartOff;
    uint32_t v[4];
    for (int i = 0; i < 4; ++i) v[i] = parts[tid * 4 + i];
    for (int p = 1; p < D::S; ++p)
      for (int i = 0; i < 4; ++i) v[i] = ts::add_mod(v[i], parts[(p * kRows + tid) * 4 + i]);
    uint32_t* o = a.acc + (a.acc_off + t * a.acc_stride) * 4;
    if (a.add)
      for (int i = 0; i < 4; ++i) v[i] = ts::add_mod(v[i], o[i]);
    if (a.invz) {
      const uint32_t z = sel_at(a, 3, t);
      for (int i = 0; i < 4; ++i) v[i] = ts::monty_mul(v[i], z);
    }
    for (int i = 0; i < 4; ++i) o[i] = v[i];
  }
}

#ifdef __CUDACC__
template <class D>
__global__ void __launch_bounds__(D::S * 32) quotient_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  phase<D>(a, smem, blockIdx.x, threadIdx.x, blockDim.x, 0);
  __syncthreads();
  phase<D>(a, smem, blockIdx.x, threadIdx.x, blockDim.x, 1);
  __syncthreads();
  phase<D>(a, smem, blockIdx.x, threadIdx.x, blockDim.x, 2);
}

// Launch D's kernel on the argument words w; returns the CUDA status.
template <class D>
int launch(const int64_t* w, cudaStream_t stream) {
  const Args a = unpack(w);
  if (a.rows <= 0) return 0;
  const int bytes = Layout<D>::kWordsTotal * 4;
  const cudaError_t e = cudaFuncSetAttribute(quotient_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (a.rows + kRows - 1) / kRows;
  quotient_kernel<D><<<unsigned(blocks), D::S * 32, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}
#endif

}  // namespace tsq
