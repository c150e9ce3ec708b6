// K2: fused-stage radix-2 DIT NTT over BabyBear, for Hopper.
//
// Replaces tpu_stark/ntt/pallas_ntt.py::_pass0_kernel (pass 1) and
// ::_pass_kernel (later passes).  Data is an (h, w) row-major matrix of
// Montgomery residues (< P) stored as u32; each column is one transform.
// Stage s butterflies rows that differ by 2^s with the twiddle
// w_{2^(s+1)}^p (p = row mod 2^s), read from per-stage tables `tw` (canonical)
// and `twp` (Shoup companions floor(w*2^32/P)) at offset 2^s - 1 + p: the same
// values as tpu_stark/ntt/radix2.py::_stage_twiddles_np.  Multiplying a Monty
// value by a canonical twiddle keeps it in Monty form, and every output is
// reduced to [0, P), so results are bit-identical to the JAX radix-2 NTT.
//
// Pass structure (planned by ntt/ntt_kernel.py::plan):
//   pass 0   reads rows in bit-reversed order and runs stages 0..k0-1 inside a
//            shared-memory tile of 2^k0 rows; a block holds G tiles whose
//            bit-reversed source rows are adjacent, so narrow matrices still
//            read whole 128-byte lines.
//   pass s0  runs stages s0..s0+k-1 in place: a block holds 2^k rows at
//            stride 2^s0 for J adjacent stride offsets (again whole lines).
// A block also tiles columns (at most wc per block, masked at the edge), so
// a tile never exceeds the planned shared-memory budget at any width.
//
// Bound on the H100: each pass streams the matrix once from and to HBM, and
// the butterflies (one 32x32 high multiply and two low multiplies each) are
// far below the ALU roof, so the roof is passes x 8 bytes per element at
// 3.35 TB/s.  The design fuses as many stages per pass as the tile holds (8),
// so a 2^23-row transform takes 3 passes instead of 23.  This first version
// reaches about a tenth of that roof (PERF.md); the cause is not measured.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

using ts::P;
using ts::add_mod;
using ts::sub_mod;

// x * w mod P for a canonical constant w (Shoup): q = hi32(x * wp) and
// r = x*w - q*P lies in [0, 2P) for any x < 2^32.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t w, uint32_t wp) {
  const uint32_t q = __umulhi(x, wp);
  const uint32_t r = x * w - q * P;
  return r >= P ? r - P : r;
}

__device__ __forceinline__ uint32_t rev_bits(uint32_t v, int bits) {
  return bits == 0 ? 0u : (__brev(v) >> (32 - bits));
}

__global__ void ntt_pass0_kernel(const uint32_t* __restrict__ in,
                                 uint32_t* __restrict__ out, int64_t w,
                                 int log_h, int k, int g_log, int wc,
                                 const uint32_t* __restrict__ tw,
                                 const uint32_t* __restrict__ twp) {
  extern __shared__ uint32_t sm[];
  const int T = 1 << k;
  const int G = 1 << g_log;
  const int64_t col0 = (int64_t)blockIdx.y * wc;
  const int wcur = w - col0 < wc ? (int)(w - col0) : wc;
  const int64_t c0 = (int64_t)blockIdx.x * G;  // bit-reversed tile index
  const int rest = log_h - k;
  const int n_el = T * G * wc;

  // load: element (r, g, c), c fastest then g, so adjacent threads read
  // adjacent source rows; sm layout [g][r][c]
  for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
    const int c = e % wc;
    const int g = (e / wc) & (G - 1);
    const int r = e / (wc * G);
    if (c < wcur) {
      const int64_t src = ((int64_t)rev_bits(r, k) << rest) | (c0 + g);
      sm[(g * T + r) * wc + c] = in[src * w + col0 + c];
    }
  }
  __syncthreads();

  const int n_bf = (T / 2) * G * wc;
  for (int l = 0; l < k; ++l) {
    const int m = 1 << l;
    for (int e = threadIdx.x; e < n_bf; e += blockDim.x) {
      const int c = e % wc;
      const int u = (e / wc) & (T / 2 - 1);
      const int g = e / (wc * (T / 2));
      const int j = u & (m - 1);
      const int i = ((u >> l) << (l + 1)) | j;
      uint32_t* base = sm + g * T * wc + c;
      const uint32_t lo = base[i * wc];
      uint32_t hi = base[(i + m) * wc];
      if (l > 0) hi = shoup_mul(hi, tw[m - 1 + j], twp[m - 1 + j]);
      base[i * wc] = add_mod(lo, hi);
      base[(i + m) * wc] = sub_mod(lo, hi);
    }
    __syncthreads();
  }

  // store: tile g is output rows [b*T, b*T + T) with b = rev(c0 + g);
  // element (g, r, c), c fastest then r, so each tile writes one
  // contiguous run when wc == w
  for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
    const int c = e % wc;
    const int r = (e / wc) & (T - 1);
    const int g = e / (wc * T);
    if (c < wcur) {
      const int64_t b = rev_bits((uint32_t)(c0 + g), rest);
      out[((b << k) + r) * w + col0 + c] = sm[(g * T + r) * wc + c];
    }
  }
}

__global__ void ntt_pass_kernel(uint32_t* __restrict__ data, int64_t w, int s0,
                                int k, int j_log, int wc,
                                const uint32_t* __restrict__ tw,
                                const uint32_t* __restrict__ twp) {
  extern __shared__ uint32_t sm[];
  const int T = 1 << k;
  const int J = 1 << j_log;
  const int64_t col0 = (int64_t)blockIdx.y * wc;
  const int wcur = w - col0 < wc ? (int)(w - col0) : wc;
  const int64_t n_jblocks = (int64_t)1 << (s0 - j_log);
  const int64_t a = (int64_t)blockIdx.x / n_jblocks;
  const int64_t j0 = ((int64_t)blockIdx.x % n_jblocks) << j_log;
  const int64_t base_row = (a << (s0 + k)) + j0;
  const int n_el = T * J * wc;

  // element (t, jj, c) is row base_row + t*2^s0 + jj; sm layout [t][jj][c]
  for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
    const int c = e % wc;
    const int jj = (e / wc) & (J - 1);
    const int t = e / (wc * J);
    if (c < wcur) {
      const int64_t row = base_row + ((int64_t)t << s0) + jj;
      sm[e] = data[row * w + col0 + c];
    }
  }
  __syncthreads();

  const int n_bf = (T / 2) * J * wc;
  for (int l = 0; l < k; ++l) {
    const int m = 1 << l;
    const int64_t tw_off = ((int64_t)1 << (s0 + l)) - 1;
    for (int e = threadIdx.x; e < n_bf; e += blockDim.x) {
      const int c = e % wc;
      const int jj = (e / wc) & (J - 1);
      const int u = e / (wc * J);
      const int j = u & (m - 1);
      const int i = ((u >> l) << (l + 1)) | j;
      // row mod 2^(s0+l+1) of the low element = j*2^s0 + (j0 + jj)
      const int64_t p = tw_off + ((int64_t)j << s0) + j0 + jj;
      uint32_t* lo_p = sm + (i * J + jj) * wc + c;
      uint32_t* hi_p = sm + ((i + m) * J + jj) * wc + c;
      const uint32_t lo = *lo_p;
      const uint32_t hi = shoup_mul(*hi_p, tw[p], twp[p]);
      *lo_p = add_mod(lo, hi);
      *hi_p = sub_mod(lo, hi);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
    const int c = e % wc;
    const int jj = (e / wc) & (J - 1);
    const int t = e / (wc * J);
    if (c < wcur) {
      const int64_t row = base_row + ((int64_t)t << s0) + jj;
      data[row * w + col0 + c] = sm[e];
    }
  }
}

constexpr int kThreads = 256;

}  // namespace

// Pass 0: out = stages 0..k-1 of bit-reversed `in` (h = 2^log_h rows).
extern "C" int ts_ntt_pass0(const uint32_t* in, uint32_t* out, int64_t w,
                            int log_h, int k, int g_log, int wc,
                            const uint32_t* tw, const uint32_t* twp,
                            cudaStream_t stream) {
  const int64_t tiles = (int64_t)1 << (log_h - k);
  const int64_t col_tiles = (w + wc - 1) / wc;
  const size_t smem = sizeof(uint32_t) * ((size_t)wc << (k + g_log));
  dim3 grid((unsigned)(tiles >> g_log), (unsigned)col_tiles);
  ntt_pass0_kernel<<<grid, kThreads, smem, stream>>>(in, out, w, log_h, k, g_log,
                                                     wc, tw, twp);
  return (int)cudaGetLastError();
}

// Later pass: stages s0..s0+k-1 of `data` in place (h = 2^log_h rows).
extern "C" int ts_ntt_pass(uint32_t* data, int64_t w, int log_h, int s0, int k,
                           int j_log, int wc, const uint32_t* tw,
                           const uint32_t* twp, cudaStream_t stream) {
  const int64_t blocks = ((int64_t)1 << (log_h - k)) >> j_log;
  const int64_t col_tiles = (w + wc - 1) / wc;
  const size_t smem = sizeof(uint32_t) * ((size_t)wc << (k + j_log));
  dim3 grid((unsigned)blocks, (unsigned)col_tiles);
  ntt_pass_kernel<<<grid, kThreads, smem, stream>>>(data, w, s0, k, j_log, wc,
                                                    tw, twp);
  return (int)cudaGetLastError();
}
