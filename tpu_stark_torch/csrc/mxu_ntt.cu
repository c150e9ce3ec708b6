// K5: exact modular matmul by a <= 256-point DFT matrix on the integer
// tensor cores, for Hopper, with the 4-step NTT's twiddle product and moved
// axis in its epilogue.
//
// Replaces tpu_stark/ntt/mxu_ntt.py::_mm_kernel (driven by
// _mod_matmul_axis_pallas), and with it the elementwise twiddle product and
// the moveaxis copy that _dft_axis0 runs after each inner level.  For x
// viewed as (B, A, R) (u32 Monty residues, row-major; B = n <= 256 the DFT
// size, M = A * R columns) it computes
//
//     y[a, c, r] = REDC( sum_b x[b, a, r] * W[b, c] ) * tw[a, c]   (Monty)
//
// stored at a*(B*R) + c*R + r: the (A, B, R) tensor the next level of the
// 4-step recursion transforms along its first axis.  The leaf level is the
// same kernel with A = 1 and no twiddle: out[c, m] at c*M + m.
//
// Exact arithmetic.  Both operands are split into four 8-bit limbs and the
// 16 limb products x_i . W_j run as u8 x u8 -> s32 tensor-core products,
// summed per diagonal s = i + j in s32 (at most 4 * 256 * 255^2 < 2^27).
// The table the kernel reads is W * R (the JAX package's W times one more
// Montgomery factor, made by the wrapper), so that V = sum_s 2^(8s) d_s
// (below 2^76) needs two Montgomery steps, V * 2^-64, and one conditional
// subtract to land in [0, P): no 64-bit remainder.  The twiddle is one
// more Montgomery product.
//
// GEMM view: D (M x n) = X^T (M x K) . W (K x n), K = max(n, 32), columns m
// of x on the MMA's M side (64 rows a warpgroup), so every n fills the
// tensor core's M; a unit is 64 columns by NW = min(n, 32) outputs c, its 7
// diagonals 7 * NW / 2 registers a thread.  Both operands are K-major in
// shared memory, in the canonical no-swizzle layout of 8-row x 16-byte core
// matrices (each 128 contiguous bytes): element (row, k) of a plane at
// (row / 8) * SBO + (k / 16) * 128 + (row % 8) * 16 + k % 16, SBO = 8K,
// every core matrix on a 128-byte bank row.  The product is wgmma
// m64nNWk32 with both operands read through descriptors (LBO = 128, the
// K-adjacent core matrix; SBO, the next 8 rows).
//
// A persistent block of two warpgroups keeps its slice of the table in
// shared memory for its whole life (n <= 128: the whole (4, n, K) table,
// at most 64 KB; n = 256: a quarter, 64 output rows c, so that a block's
// table, data and staging fit, and x is read four times, once per slice,
// mostly from L2), and walks column tiles of TM = max(64, 8192 / n)
// columns: the next tile's raw words arrive by cp.async (issued while the
// first wgmmas run) while this one is multiplied; the threads split a tile
// into limb planes (TMA cannot split bytes); the two warpgroups take its
// 64-column x NW-output units in turn.  The epilogue reduces each output
// in registers and applies its twiddle (loaded before the products); a
// tile of one a's columns (R >= TM) stores from the fragments (runs of 8
// columns: 32-byte sectors), a tile of whole a's (R < TM) through a shared
// staging tile in output order, copied out 16 bytes at a time.
//
// What binds it (port_timing.py k5 --phases and wgmma, PERF.md): the
// tensor work runs at the rate of m64n32k32 with both operands in shared
// memory (about two thirds of the int8 peak: each wgmma reads its 64 x 32
// A operand again), and the split and the epilogue do not overlap it.
//
// Bound on the H100: 16 * 2 * n^2 * M int8 tensor operations against
// 8 * n * M bytes (plus the twiddle table, 4 * A * B, at an inner level);
// n = 256 is bound by the tensor cores, n <= 128 by the bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

// Built with -DMXU_PHASE_CLOCKS (port_timing.py k5 --phases, never the
// package's build), each warpgroup's first thread adds the SM clocks of the
// kernel's phases to mxu_phase_clocks: 0 waiting for a tile's raw words and
// splitting it, 1 issuing the next tile's cp.async (inside the first
// products' window), 2 the wgmma products (issue to completion, the
// cp.async issue included), 3 the units and the stores, products included.
#ifdef MXU_PHASE_CLOCKS
__device__ unsigned long long mxu_phase_clocks[4];
#define PHASE_MARK(v) const long long v = clock64()
#define PHASE_ADD(i, a, b) \
  if (threadIdx.x % 128 == 0) atomicAdd(&mxu_phase_clocks[i], (unsigned long long)((b) - (a)))
extern "C" int ts_mxu_phase_clocks(unsigned long long* host, int reset) {
  if (reset) {
    const unsigned long long zero[4] = {0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(mxu_phase_clocks, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(host, mxu_phase_clocks, 4 * sizeof(unsigned long long));
}
#else
#define PHASE_MARK(v)
#define PHASE_ADD(i, a, b)
#endif

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kSmemLimit = 227 * 1024;

// The launch's shapes: the tile plan and where each shared region starts.
struct Geo {
  int n, K, TM, NC, slices;
  int64_t A, R, M;
  int64_t n_mtiles;
  int64_t per_a;  // R >= TM: column tiles per a; else TA, the whole a's a tile
  bool by_a;      // R < TM: a tile is TA whole a's
  int kcs_log;    // log2(n / 16): core matrices along K that hold data
  bool aligned;   // every tile's raw rows start on a 16-byte boundary
  int plane;      // bytes of a data plane
  int off_planes, off_raw, off_stage;
  int smem;
};

struct Tile {
  int64_t a_first, m_start;
  int64_t r0;
  int na, nr, rows;
};

__device__ __forceinline__ Tile tile_of(const Geo& g, int64_t mt) {
  Tile t;
  if (g.by_a) {
    t.a_first = mt * g.per_a;
    t.na = (int)min(g.per_a, g.A - t.a_first);
    t.nr = (int)g.R;
    t.r0 = 0;
  } else {
    t.a_first = mt / g.per_a;
    t.r0 = (mt % g.per_a) * g.TM;
    t.na = 1;
    t.nr = (int)min((int64_t)g.TM, g.R - t.r0);
  }
  t.m_start = t.a_first * g.R + t.r0;
  t.rows = t.na * t.nr;
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

// Word of raw row b (TM words), column i: 16-byte chunks XOR-swizzled by
// bits 2-3 of b, so that the split's reads (8 columns x 4 b-quads a warp)
// hit 32 banks.
__device__ __forceinline__ int raw_word(int b, int i, int tm) {
  return b * tm + 4 * ((i >> 2) ^ (2 * ((b >> 2) & 3))) + (i & 3);
}

// cp.async the n raw rows of a tile (zeros past its columns): each thread
// keeps one 16-byte column chunk and walks rows.
__device__ __forceinline__ void issue_raw(const uint32_t* __restrict__ x, uint32_t* s_raw, const Geo& g,
                                          const Tile& t, int tid) {
  const int chunks = g.TM / 4;  // a power of two, at most 128
  const int c = tid & (chunks - 1), step = kThreads / chunks;
  const int valid = t.rows - 4 * c;
  const int bytes = valid >= 4 ? 16 : valid > 0 ? 4 * valid : 0;
  const int64_t src_step = step * g.M;
  const uint32_t* src = x + tid / chunks * g.M + t.m_start + 4 * c;
#pragma unroll 4
  for (int b = tid / chunks; b < g.n; b += step, src += src_step) {
    uint32_t* dst = s_raw + b * g.TM + 4 * (c ^ (2 * ((b >> 2) & 3)));
    if (g.aligned) {
      cp_async16(dst, bytes ? src : x, bytes);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async4(dst + k, k < valid ? src + k : x, k < valid ? 4 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A raw tile -> four limb planes in the core-matrix layout.  A warp task
// is one core matrix of every plane (128 contiguous bytes, so its stores
// are conflict-free): 8 columns x 4 b-quads; each thread packs limb l of 4
// consecutive b of one column into a word.
__device__ __forceinline__ void split_tile(const uint32_t* s_raw, uint8_t* s_planes, const Geo& g, int warp,
                                           int lane) {
  const int kcs_log = g.kcs_log;  // core matrices along K that hold data: n / 16
  const int plane_w = g.plane / 4;
  uint32_t* planes = reinterpret_cast<uint32_t*>(s_planes);
#pragma unroll 2
  for (int task = warp; task < (g.TM / 8) << kcs_log; task += kThreads / 32) {
    const int rg = task >> kcs_log, kc = task & ((1 << kcs_log) - 1);
    const int i = rg * 8 + (lane & 7), q = kc * 4 + (lane >> 3);
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = s_raw[raw_word(4 * q + e, i, g.TM)];
    const int w = rg * 2 * g.K + kc * 32 + (lane & 7) * 4 + (lane >> 3);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const uint32_t sel = (uint32_t)l | ((uint32_t)(4 + l) << 4);
      const uint32_t p01 = __byte_perm(v[0], v[1], sel);
      const uint32_t p23 = __byte_perm(v[2], v[3], sel);
      planes[l * plane_w + w] = __byte_perm(p01, p23, 0x5410);
    }
  }
}

// ---------------------------------------------------------------------------
// the limb products of one unit: 64 columns (rows of D) x NW outputs c
// ---------------------------------------------------------------------------
template <int NW>
struct Acc {
  int32_t d[7][NW / 2];
};

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo) {
  constexpr uint32_t kLbo = 128;  // the K-adjacent core matrix
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_u8(int32_t (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db));
}

__device__ __forceinline__ void wgmma_u8(int32_t (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db));
}

template <int NW>
__device__ __forceinline__ void fence_acc(Acc<NW>& acc) {
#pragma unroll
  for (int s = 0; s < 7; ++s)
#pragma unroll
    for (int k = 0; k < NW / 2; ++k) asm volatile("" : "+r"(acc.d[s][k])::"memory");
}

// The warpgroup's 64 columns from row0 of the tile by NW outputs from c0 of
// the slice: K / 32 k-steps of the 16 limb products, each a wgmma with both
// operands read through descriptors, accumulated per diagonal i + j.
// Issued asynchronously; product_wait completes them.
template <int NW>
__device__ __forceinline__ void product_issue(Acc<NW>& acc, uint32_t planes, uint32_t tab, int row0, int c0,
                                              const Geo& g) {
#pragma unroll
  for (int s = 0; s < 7; ++s)
#pragma unroll
    for (int k = 0; k < NW / 2; ++k) acc.d[s][k] = 0;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint32_t sbo = (uint32_t)(8 * g.K), tab_plane = (uint32_t)(g.NC * g.K);
  const uint32_t a0 = planes + (row0 / 8) * sbo, b0 = tab + (c0 / 8) * sbo;
  for (int ks = 0; ks < g.K / 32; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint64_t da = make_desc(a0 + i * g.plane + ks * 256, sbo);
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_u8(acc.d[i + j], da, make_desc(b0 + j * tab_plane + ks * 256, sbo));
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int NW>
__device__ __forceinline__ void product_wait(Acc<NW>& acc) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
}

// V = sum_s 2^(8s) d_s (< 2^76) -> V * 2^-64 mod P in [0, P): two
// Montgomery steps (each an exact division by 2^32 of V - t*P, t chosen to
// clear the low word) and one conditional subtract.
__device__ __forceinline__ uint32_t reduce_diagonals(const uint32_t (&d)[7]) {
  uint64_t lo = mad_wide(d[1], 1u << 8, d[0]);
  lo = mad_wide(d[2], 1u << 16, lo);
  lo = mad_wide(d[3], 1u << 24, lo);
  uint64_t v = mad_wide(d[5], 1u << 8, d[4]);
  v = mad_wide(d[6], 1u << 16, v) + (lo >> 32);  // V = lo32 + 2^32 v, v < 2^45
  const uint32_t t1 = (uint32_t)lo * ts::MU;
  const uint64_t v1 = v + (ts::P - __umulhi(t1, ts::P));  // V * 2^-32 (+ P), < 2^46
  const uint32_t t2 = (uint32_t)v1 * ts::MU;
  const uint32_t v2 = (uint32_t)(v1 >> 32) + (ts::P - __umulhi(t2, ts::P));  // in (0, 2^14 + P]
  return min(v2, v2 - ts::P);
}

template <int NW, bool TW>
__global__ void __launch_bounds__(kThreads, 1)
mxu_mm_kernel(const uint32_t* __restrict__ x, const uint8_t* __restrict__ image, const uint32_t* __restrict__ tw,
              uint32_t* __restrict__ out, const Geo g) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_tab = smem;
  uint8_t* s_planes = smem + g.off_planes;  // 4 limb planes
  uint32_t* s_raw = reinterpret_cast<uint32_t*>(smem + g.off_raw);
  uint32_t* s_stage = reinterpret_cast<uint32_t*>(smem + g.off_stage);
  const int tid = threadIdx.x;
  const int slice = (int)(blockIdx.x % g.slices);
  const int64_t mt_step = gridDim.x / g.slices;
  int64_t mt = blockIdx.x / g.slices;
  if (mt >= g.n_mtiles) return;

  // the block's table slice, already in the core-matrix layout; zeroed data
  // planes (K > n leaves rows of K that the split never writes)
  const int tab_bytes = 4 * g.NC * g.K;
  const uint4* src = reinterpret_cast<const uint4*>(image + (int64_t)slice * tab_bytes);
  for (int e = tid; e < tab_bytes / 16; e += kThreads) reinterpret_cast<uint4*>(s_tab)[e] = __ldg(src + e);
  for (int e = tid; e < 4 * g.plane / 16; e += kThreads) reinterpret_cast<uint4*>(s_planes)[e] = make_uint4(0, 0, 0, 0);

  const int wg = tid / 128, wl = (tid / 32) % 4, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int chunks = g.NC / NW;
  const int units = (g.TM / 64) * chunks;  // a WG takes units wg, wg + 2, ... (units is even)
  const int c_slice = slice * g.NC;
  // tile t + 1's raw words arrive by cp.async while tile t is multiplied;
  // tile t is split at the top of its iteration
  Tile t = tile_of(g, mt);
  issue_raw(x, s_raw, g, t, tid);
  for (; mt < g.n_mtiles; mt += mt_step) {
    PHASE_MARK(c0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    split_tile(s_raw, s_planes, g, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    PHASE_MARK(c1);
    PHASE_ADD(0, c0, c1);
    const Tile cur = t;
    const bool more = mt + mt_step < g.n_mtiles;
    if (more) t = tile_of(g, mt + mt_step);

    // an a's whole tile (R >= TM) stores from the fragments: per register,
    // 8 consecutive columns of 4 outputs c, four 32-byte sectors a warp;
    // R < TM (whole a's a tile) goes through the staging tile
    uint32_t* const out_tile = out + (cur.a_first * g.n + c_slice) * g.R + cur.r0;
    const uint32_t* const tw_tile = TW ? tw + cur.a_first * g.n + c_slice : nullptr;  // row a_first
    for (int u = wg; u < units; u += 2) {
      const int row0 = 64 * (u / chunks), c0 = NW * (u % chunks);
      // register k holds column i0 + 8 * ((k >> 1) & 1), output c0 + 8 * (k >> 2) + 2 * tq + (k & 1);
      // a column's a (whole a's) and place in it
      const int i0 = row0 + 16 * wl + gq;
      const bool ok[2] = {i0 < cur.rows, i0 + 8 < cur.rows};  // columns past the tile are not stored
      int ia[2] = {0, 0}, ir[2] = {i0, i0 + 8};
      if (g.by_a) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ia[h] = ok[h] ? ir[h] / cur.nr : 0;
          ir[h] -= ia[h] * cur.nr;
        }
      }
      // the twiddles, loaded before the product so that their latency hides behind it
      uint32_t twv[NW / 2];
      if (TW) {
#pragma unroll
        for (int k = 0; k < NW / 2; ++k)
          twv[k] = __ldg(tw_tile + ia[(k >> 1) & 1] * g.n + c0 + 8 * (k >> 2) + 2 * tq + (k & 1));
      }
      Acc<NW> acc;
      PHASE_MARK(p0);
      product_issue<NW>(acc, smem_addr(s_planes), smem_addr(s_tab), row0, c0, g);
      if (u == wg && more) {  // the next tile's raw words, issued while the first products run
        issue_raw(x, s_raw, g, t, tid);
        PHASE_MARK(i1);
        PHASE_ADD(1, p0, i1);
      }
      product_wait<NW>(acc);
#ifdef MXU_PHASE_CLOCKS
      uint32_t dep = (uint32_t)acc.d[0][0] ^ (uint32_t)acc.d[6][NW / 2 - 1];  // the clock after the results
      asm volatile("mov.b32 %0, %0;" : "+r"(dep));
      const long long p1 = clock64() + (dep == 0x9e3779b9u);
      PHASE_ADD(2, p0, p1);
#endif
      uint32_t v[NW / 2];
#pragma unroll
      for (int k = 0; k < NW / 2; ++k) {
        uint32_t d[7];
#pragma unroll
        for (int s = 0; s < 7; ++s) d[s] = (uint32_t)acc.d[s][k];
        v[k] = reduce_diagonals(d);
        if (TW) v[k] = ts::monty_mul(v[k], twv[k]);
      }
      if (g.by_a) {  // the staging tile in output order: (ia, cl, ir) at (ia * NC + cl) * R + ir
#pragma unroll
        for (int k = 0; k < NW / 2; ++k) {
          const int h = (k >> 1) & 1, cl = c0 + 8 * (k >> 2) + 2 * tq + (k & 1);
          if (ok[h]) s_stage[(ia[h] * g.NC + cl) * cur.nr + ir[h]] = v[k];
        }
      } else {
        uint32_t* const o = out_tile + (c0 + 2 * tq) * g.R + i0;
#pragma unroll
        for (int k = 0; k < NW / 2; ++k)
          if (ok[(k >> 1) & 1]) o[(8 * (k >> 2) + (k & 1)) * g.R + 8 * ((k >> 1) & 1)] = v[k];
      }
    }
    if (g.by_a) {
      __syncthreads();
      // whole a's: each a's NC * R outputs are contiguous in the output,
      // (ia * B + cl) * R + ir from the tile's start; 16-byte copies
      const uint32_t per_a = (uint32_t)(g.NC * cur.nr), m_a = 0xFFFFFFFFu / per_a + 1;
      const uint32_t total = per_a * (uint32_t)cur.na, a_stride = (uint32_t)(g.n * g.R);
#pragma unroll 4
      for (uint32_t idx = 4 * tid; idx < total; idx += 4 * kThreads) {
        const uint32_t ia = __umulhi(idx, m_a);
        *reinterpret_cast<uint4*>(out_tile + ia * a_stride + (idx - ia * per_a)) =
            *reinterpret_cast<const uint4*>(s_stage + idx);
      }
    }
    PHASE_MARK(c3);
    PHASE_ADD(3, c1, c3);
  }
}

int g_sms = 0;

template <int NW, bool TW>
int launch(const uint32_t* x, const uint8_t* image, const uint32_t* tw, uint32_t* out, const Geo& g,
           cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(mxu_mm_kernel<NW, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return (int)e;
  int64_t per_slice = g.n_mtiles < g_sms / g.slices ? g.n_mtiles : g_sms / g.slices;
  if (per_slice < 1) per_slice = 1;
  mxu_mm_kernel<NW, TW><<<(unsigned)(per_slice * g.slices), kThreads, g.smem, stream>>>(x, image, tw, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// y = the level's product (see the top of this file) of x viewed as
// (n, A, R) by the table image, times tw (an (A, n) Monty table; null: no
// twiddle, the leaf, with A = 1), into out (the (A, n, R) tensor).
// n in {16, 32, 64, 128, 256}.  Returns the CUDA error status of the
// launch.
extern "C" int ts_mxu_mm(const uint32_t* x, const uint8_t* image, const uint32_t* tw, uint32_t* out, int n,
                         int64_t A, int64_t R, cudaStream_t stream) {
  if (n < 16 || n > 256 || (n & (n - 1)) != 0 || A <= 0 || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    const cudaError_t e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  Geo g{};
  g.n = n;
  g.K = n < 32 ? 32 : n;
  g.TM = 8192 / n < 64 ? 64 : 8192 / n;
  g.NC = n <= 128 ? n : 64;
  g.slices = n / g.NC;
  g.A = A;
  g.R = R;
  g.M = A * R;
  g.by_a = R < g.TM;
  if (g.by_a) {
    g.per_a = g.TM / R;
    g.n_mtiles = (A + g.per_a - 1) / g.per_a;
  } else {
    g.per_a = (R + g.TM - 1) / g.TM;
    g.n_mtiles = A * g.per_a;
  }
  const bool starts4 = g.by_a ? (g.per_a * R % 4 == 0 || g.n_mtiles == 1) : (A == 1 || R % 4 == 0);
  g.aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && g.M % 4 == 0 && starts4;
  g.kcs_log = __builtin_ctz(n / 16);
  g.plane = g.TM * g.K;
  const int tab = 4 * g.NC * g.K;
  const int stage = g.by_a ? 4 * g.NC * g.TM : 0;  // staging: whole a's only
  g.off_planes = (tab + 127) & ~127;
  g.off_raw = (g.off_planes + 4 * g.plane + 127) & ~127;
  g.off_stage = (g.off_raw + 4 * n * g.TM + 127) & ~127;
  g.smem = g.off_stage + stage;
  if (g.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (n == 16) return tw ? launch<16, true>(x, image, tw, out, g, stream) : launch<16, false>(x, image, tw, out, g, stream);
  return tw ? launch<32, true>(x, image, tw, out, g, stream) : launch<32, false>(x, image, tw, out, g, stream);
}
