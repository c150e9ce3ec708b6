// K5: exact modular matmul by a <= 256-point DFT matrix on the integer
// tensor cores, for Hopper.
//
// Replaces tpu_stark/ntt/mxu_ntt.py::_mm_kernel (driven by
// _mod_matmul_axis_pallas).  Computes, for x of shape (n, M) (u32 Monty
// residues, row-major) and the DFT matrix W (n, n) stored with an extra
// Montgomery factor R = 2^32:
//
//     out[c, m] = REDC( sum_b x[b, m] * W[b, c] )      (Monty in, Monty out)
//
// Both operands are split into four 8-bit limbs, x = sum_i 2^(8i) x_i and
// W = sum_j 2^(8j) W_j, and the 16 limb products x_i . W_j run as
// u8 x u8 -> s32 tensor-core products (mma.sync m16n8k32), the exact
// counterpart of the TPU kernel's bf16 limb matmuls with f32 accumulation.
// Products are summed per diagonal s = i + j in s32, exactly: a diagonal
// holds at most 4 * 256 * 255^2 < 2^27.  The epilogue recombines the 7
// diagonals into V = sum_s 2^(8s) d_s < 2^77 (one 32-bit word plus a 45-bit
// high part), divides by 2^32 with one Montgomery REDC step and reduces mod
// P, in registers, with one store per output.
//
// GEMM view: D (n x M) = Wt (n x K) . X (K x M), K = max(n, 32).  The host
// passes the limb table transposed, wt[j][c][b] (K columns per row, zero
// past n), so an A fragment is four 4-byte loads through the read-only
// cache (the whole table is at most 256 KB and stays in L1/L2).  A block of
// 128 threads owns 32 columns of x: it loads the (n, 32) tile once,
// coalesced along m, splits it into four limb planes in shared memory,
// stored m-major with b contiguous so that a B fragment is one 4-byte
// shared load per register (row stride 4 words mod 32: conflict-free), and
// its 4 warps walk the (16-row, 16-column) output units.  Any M: columns
// past M load as zero and are not stored.
//
// Bound on the H100: 16 * 2 * n^2 * M int8 tensor operations against
// 8 * n * M bytes; at n = 256 the tensor cores bound it.  This first
// version uses mma.sync without a pipeline (no wgmma, no TMA).

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 32;                  // columns of x per block
constexpr int kStrideWords = 64 + 4;  // a limb row: K <= 256 bytes, stride 4 mod 32 words

__device__ __forceinline__ void mma_u8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// V = lo + 2^32 * hi_part with lo = sum_{s<4} 2^(8s) d_s and
// hi_part = sum_{s>=4} 2^(8(s-4)) d_s; returns V * 2^-32 mod P in [0, P).
__device__ __forceinline__ uint32_t reduce_diagonals(const uint32_t (&d)[7]) {
  const uint64_t lo = (uint64_t)d[0] + ((uint64_t)d[1] << 8) + ((uint64_t)d[2] << 16) +
                      ((uint64_t)d[3] << 24);
  const uint64_t hi = (uint64_t)d[4] + ((uint64_t)d[5] << 8) + ((uint64_t)d[6] << 16);
  const uint32_t w0 = (uint32_t)lo;
  const uint64_t mid = hi + (lo >> 32);  // V = w0 + 2^32 * mid, mid < 2^46
  // REDC: t * P has the low word w0, so (V - t*P) / 2^32 = mid - hi32(t*P)
  const uint32_t t = w0 * ts::MU;
  const uint32_t u_hi = __umulhi(t, ts::P);
  return (uint32_t)((mid + ts::P - u_hi) % ts::P);
}

__global__ void __launch_bounds__(kThreads)
mxu_mm_kernel(const uint32_t* __restrict__ x, const uint8_t* __restrict__ wt, uint32_t* __restrict__ out,
              int n, int K, int64_t M) {
  __shared__ uint32_t xs[4][kCols][kStrideWords];
  const int kw = K / 4;  // words of a limb row
  const int64_t m0 = (int64_t)blockIdx.x * kCols;
  const int tid = threadIdx.x;

  // x tile -> limb planes: thread task (q, col) packs rows 4q..4q+3 of one
  // column, limb i of the four words into one u32
  for (int task = tid; task < kw * kCols; task += kThreads) {
    const int col = task % kCols, q = task / kCols;
    const int64_t m = m0 + col;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = 4 * q + e;
      v[e] = (b < n && m < M) ? x[(int64_t)b * M + m] : 0u;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t sel = (uint32_t)i | ((uint32_t)(4 + i) << 4);
      const uint32_t p01 = __byte_perm(v[0], v[1], sel);
      const uint32_t p23 = __byte_perm(v[2], v[3], sel);
      xs[i][col][q] = __byte_perm(p01, p23, 0x5410);
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int units = (n / 16) * 2;  // (16 output rows, 16 columns) each
  for (int u = warp; u < units; u += kThreads / 32) {
    const int c0 = (u / 2) * 16;
    const int nc0 = (u % 2) * 16;  // first local column of the unit
    int32_t acc[7][2][4];
#pragma unroll
    for (int s = 0; s < 7; ++s)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[s][f][r] = 0;

    for (int k0 = 0; k0 < K; k0 += 32) {
      uint32_t bf[4][2][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const uint32_t* row = xs[i][nc0 + f * 8 + g];
          bf[i][f][0] = row[k0 / 4 + t];
          bf[i][f][1] = row[k0 / 4 + 4 + t];
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* w = wt + ((int64_t)j * n + c0 + g) * K + k0 + 4 * t;
        uint32_t a[4];
        a[0] = __ldg(reinterpret_cast<const uint32_t*>(w));
        a[1] = __ldg(reinterpret_cast<const uint32_t*>(w + 8 * K));
        a[2] = __ldg(reinterpret_cast<const uint32_t*>(w + 16));
        a[3] = __ldg(reinterpret_cast<const uint32_t*>(w + 8 * K + 16));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int f = 0; f < 2; ++f) mma_u8(acc[i + j][f], a, bf[i][f][0], bf[i][f][1]);
      }
    }

#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = c0 + g + (r >= 2 ? 8 : 0);
        const int64_t m = m0 + nc0 + f * 8 + 2 * t + (r & 1);
        uint32_t d[7];
#pragma unroll
        for (int s = 0; s < 7; ++s) d[s] = (uint32_t)acc[s][f][r];
        const uint32_t v = reduce_diagonals(d);
        if (m < M) out[(int64_t)c * M + m] = v;
      }
  }
}

}  // namespace

// out (n, M) = the Monty matmul of x (n, M) by the limb table wt (4, n, K),
// K = max(n, 32), n in {16, 32, 64, 128, 256}.  Returns the CUDA error
// status of the launch (cudaErrorInvalidValue for an unsupported n).
extern "C" int ts_mxu_mm(const uint32_t* x, const uint8_t* wt, uint32_t* out, int n, int64_t M,
                         cudaStream_t stream) {
  if (n < 16 || n > 256 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const int K = n < 32 ? 32 : n;
  const int64_t blocks = (M + kCols - 1) / kCols;
  mxu_mm_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(x, wt, out, n, K, M);
  return (int)cudaGetLastError();
}
