// The speed-of-light probes of bench/sol.py, for Hopper.
//
// They replace the XLA probes of tpu_stark/bench/sol.py (mul_roof, alu_roof,
// hbm_roof), which are jitted fori_loops; no Pallas kernel.  Each computes
// exactly what its plain torch twin in tpu_stark_torch/bench/sol.py computes,
// and bench/sol.py audits that twin's integer ops with the same counter as
// the kernels it scores, so a roof is a rate in the twins' currency.
//
// * sol_mul_kernel: x is (ILP, n) BabyBear Montgomery residues, tw (n,) one
//   more (a vector operand, like an NTT twiddle column: a constant would let
//   the compiler fold the reduction); each thread takes one column j and
//   runs reps x INNER dependent Montgomery products v = v * tw[j] on each of
//   its ILP values, interleaved, then stores all ILP results to out.
// * sol_alu_kernel: the same shape of work with the Keccak-mix step
//   v ^ (~rotl(v, 13) & rotl(v, 7)) on u32 words: two funnel shifts and one
//   LOP3 a step, all on the ALU pipe.
// * sol_stream_kernel: x[i] += 1 over n u32 words in place, 16 bytes a
//   thread: one read and one write of every word, bound by device memory.
//
// What bounds the first two is the integer issue rate: ILP = 16 independent
// chains a thread keep every scheduler's next instruction ready, and each
// value lives in a register from load to store, so nothing but the chain
// touches memory.  Every chain's result is stored, so none is dead code.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int kIlp = 16;    // independent chains a thread (sol.py's _ILP)
constexpr int kInner = 16;  // dependent steps a rep (sol.py's _INNER)
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) sol_mul_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
    uint32_t* __restrict__ out, int64_t n, int reps) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const uint32_t t = tw[j];
  uint32_t v[kIlp];
#pragma unroll
  for (int i = 0; i < kIlp; ++i) v[i] = x[i * n + j];
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < kInner; ++k) {
#pragma unroll
      for (int i = 0; i < kIlp; ++i) v[i] = ts::monty_mul(v[i], t);
    }
  }
#pragma unroll
  for (int i = 0; i < kIlp; ++i) out[i * n + j] = v[i];
}

__device__ __forceinline__ uint32_t mix(uint32_t v) {
  const uint32_t r = __funnelshift_l(v, v, 13);  // rotl(v, 13)
  const uint32_t s = __funnelshift_l(v, v, 7);   // rotl(v, 7)
  return v ^ (~r & s);
}

__global__ void __launch_bounds__(kThreads) sol_alu_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n, int reps) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  uint32_t v[kIlp];
#pragma unroll
  for (int i = 0; i < kIlp; ++i) v[i] = x[i * n + j];
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < kInner; ++k) {
#pragma unroll
      for (int i = 0; i < kIlp; ++i) v[i] = mix(v[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kIlp; ++i) out[i * n + j] = v[i];
}

// x is 16-byte aligned; words [4 * n4, n) are the scalar tail, taken by the
// first threads
__global__ void __launch_bounds__(kThreads) sol_stream_kernel(uint32_t* __restrict__ x, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t n4 = n / 4;
  if (i < n4) {
    uint4 v = reinterpret_cast<uint4*>(x)[i];
    v.x += 1u;
    v.y += 1u;
    v.z += 1u;
    v.w += 1u;
    reinterpret_cast<uint4*>(x)[i] = v;
  }
  if (i < n - 4 * n4) x[4 * n4 + i] += 1u;
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int ts_sol_mul(const uint32_t* x, const uint32_t* tw, uint32_t* out, int64_t n, int reps,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  sol_mul_kernel<<<blocks_for(n), kThreads, 0, stream>>>(x, tw, out, n, reps);
  return (int)cudaGetLastError();
}

extern "C" int ts_sol_alu(const uint32_t* x, uint32_t* out, int64_t n, int reps, cudaStream_t stream) {
  if (n <= 0) return 0;
  sol_alu_kernel<<<blocks_for(n), kThreads, 0, stream>>>(x, out, n, reps);
  return (int)cudaGetLastError();
}

extern "C" int ts_sol_stream(uint32_t* x, int64_t n, cudaStream_t stream) {
  if (n <= 0) return 0;
  sol_stream_kernel<<<blocks_for(n / 4 > 3 ? n / 4 : 3), kThreads, 0, stream>>>(x, n);
  return (int)cudaGetLastError();
}
