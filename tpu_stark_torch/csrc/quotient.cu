// K8: the panel coset fold of the streamed quotient (air/quotient_kernel.py
// panel_fold), out[i, c] = s^i * sum_q tf[q m + i, c] * (s^m)^q for the
// (npan m, u) int32 Monty coefficient columns tf of a partition: the
// columns evaluated on the coset s * <g_m> are an NTT of this fold, since
// x^m = s^m on the coset.  The output is the NTT's (m, u) int32 Monty input.
//
// Replaces the fold and the shift scale of the JAX package's XLA program
// tpu_stark/prover/wide.py:646 _panel_eval_fn (its NTT stays K2's), which
// the port ran as npan + 1 int64 torch passes (_panel_on_coset).
//
// Bound: bytes, each coefficient read once and each output written once,
// (npan + 1) * 4 bytes an output against about 2 npan + 2 Montgomery
// products.  A thread takes one column of a run of kRun rows: neighbouring
// threads take neighbouring columns, so every read and write is coalesced
// along a row; s^i is one square-and-multiply at the run's first row and one
// product a row after it, (s^m)^q one product a term.  No int64 temporaries.
#include <cuda_runtime.h>

#include <cstdint>

#include "babybear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 32;  // rows a thread

__device__ __forceinline__ uint32_t monty_pow(uint32_t base, uint64_t e) {
  uint32_t acc = uint32_t((uint64_t(1) << 32) % ts::P);  // Monty form of 1
  while (e) {
    if (e & 1) acc = ts::monty_mul(acc, base);
    base = ts::monty_mul(base, base);
    e >>= 1;
  }
  return acc;
}

// Work item g of ceil(m / kRun) * u: column g % u of the rows
// [(g / u) * kRun, + kRun) of the output.
__device__ __forceinline__ void fold_item(const uint32_t* tf, int64_t npan, int64_t m, int64_t u, uint32_t s,
                                          uint32_t s_m, uint32_t* out, int64_t g) {
  const int64_t c = g % u, i0 = (g / u) * kRun;
  const int64_t i1 = i0 + kRun < m ? i0 + kRun : m;
  uint32_t s_i = monty_pow(s, uint64_t(i0));
  for (int64_t i = i0; i < i1; ++i) {
    uint32_t acc = __ldg(tf + i * u + c);
    uint32_t w = s_m;
    for (int64_t q = 1; q < npan; ++q) {
      acc = ts::add_mod(acc, ts::monty_mul(__ldg(tf + (q * m + i) * u + c), w));
      w = ts::monty_mul(w, s_m);
    }
    out[i * u + c] = ts::monty_mul(acc, s_i);
    s_i = ts::monty_mul(s_i, s);
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kThreads) panel_fold_kernel(const uint32_t* tf, int64_t npan, int64_t m, int64_t u,
                                                              uint32_t s, uint32_t s_m, uint32_t* out,
                                                              int64_t items) {
  for (int64_t g = int64_t(blockIdx.x) * kThreads + threadIdx.x; g < items; g += int64_t(gridDim.x) * kThreads)
    fold_item(tf, npan, m, u, s, s_m, out, g);
}
#endif

}  // namespace

#ifdef __CUDACC__
// The (m, u) fold of the (npan * m, u) contiguous Monty matrix tf; s and s_m
// are the Montgomery forms of the shift and its m-th power.  Returns the
// CUDA error status of the launch.
extern "C" int ts_panel_fold(const uint32_t* tf, int64_t npan, int64_t m, int64_t u, uint32_t s, uint32_t s_m,
                             uint32_t* out, cudaStream_t stream) {
  if (m <= 0 || u <= 0) return 0;
  if (npan <= 0) return (int)cudaErrorInvalidValue;
  const int64_t items = (m + kRun - 1) / kRun * u;
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  const unsigned grid = unsigned(blocks < (int64_t(1) << 30) ? blocks : (int64_t(1) << 30));
  panel_fold_kernel<<<grid, kThreads, 0, stream>>>(tf, npan, m, u, s, s_m, out, items);
  return (int)cudaGetLastError();
}
#endif
