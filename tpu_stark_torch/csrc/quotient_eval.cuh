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
// What bounds it on the H100: the bytes of the panels' columns read once
// (keccak-air's partitions, 1-3 KB a row), or for the narrow DAGs the
// Montgomery products of the constraint code.  What held its first design
// back (port_timing.py k7) was the instruction stream: the generated code
// is long (up to ~16k SASS instructions a row), each warp ran its own slice
// of it on the same 32 rows, so an SM fetched the whole program for every
// 32 rows, and more warps (more slices in flight) made it slower; and the
// staging, by the same threads, did not overlap the evaluation.
//
// The design.  The generator cuts the constraints into G phases by the
// 64-byte chunks of a row they read (constraints on the same chunks meet),
// each phase at most Q quads (16 bytes) a row.  A tile is kRows = 32 NW
// rows in NW row groups of 32.  S consumer warps a row group each run a
// share of every phase's constraints, one row a thread; all consumer warps
// run the same phase at once, so they share its instructions.  A
// persistent grid of at most SMs x occupancy blocks walks the tiles with a
// stride of gridDim.x, unit by unit (a unit: one phase of one tile),
// through a ring of NS stages in shared memory.  NP producer warps stage
// the units ahead (cp.async: 16-byte copies, cp.async.cg, which skips L1,
// where both panels' pointer and leading dimension allow them, else 4-byte
// ones) and signal each slot's mbarrier when its copies land; the
// consumers wait on it, evaluate, and release the slot on a second
// mbarrier.  A staged row holds the phase's quads in the order of its
// table (current panel; next panel, whose row for t is (t + nshift) mod
// nrows_nxt) at a stride of 4 * odd words: the code reads a quad at a time
// (LDS.128), and eight lanes of a quarter-warp then hit distinct bank
// quads.  A thread folds each constraint as soon as it exists into four
// 64-bit sums, held across the phases: the alpha powers sit in shared
// memory, staged once a block, and a fold is four multiply-adds acc +=
// alpha * C of raw products (alpha < P and C < P, so each is below P^2 <
// 2^61.82).  Every fourth fold settles the sums, acc = hi * (2^32 mod P) +
// lo < 2^60, so four more products keep them below 2^60 + 4 P^2 < 2^64.
// After the last phase the thread settles once more (< 2^60 < P 2^32), and
// one Montgomery reduction gives its share's sum of alpha_k C_k in Monty
// form, canonical.  Shares 1.. S-1 leave theirs in shared memory; after a
// barrier of the consumers, share 0 adds them, the accumulator's row
// (add), multiplies by inv_zeroifier (invz) and stores row acc_off + t *
// acc_stride of the (N, 4) accumulator.
//
// The device functions (stage_consts, stage_unit, eval_unit, store_row) and
// the unit arithmetic (units_of, unit_t0) are plain C++ off the card: the CPU tests
// compile this header with g++ under a shim and drive them thread by
// thread, with plain copies for cp.async.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "babybear.cuh"

namespace tsq {

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
  int64_t vec;  // bit 0: the current panel takes 16-byte copies, bit 1: the next panel
};

// The launch's 21 argument words (quotient_kernel.eval_fold builds them).
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
  a.vec = w[20];
  return a;
}

__device__ __forceinline__ uint32_t sel_at(const Args& a, int k, int64_t t) {
  return __ldg(a.sel[k] + a.sel_off + t * a.sel_stride);
}

// 2^32 mod P: x = hi 2^32 + lo is congruent to hi * kTwo32 + lo
constexpr uint32_t kTwo32 = 0x0FFFFFFEu;

// acc += alpha^k * c, componentwise, as raw products (a base value times an
// extension value); at most four between two settles
__device__ __forceinline__ void fold(uint64_t acc[4], const uint4 al, uint32_t c) {
  acc[0] += uint64_t(al.x) * c;
  acc[1] += uint64_t(al.y) * c;
  acc[2] += uint64_t(al.z) * c;
  acc[3] += uint64_t(al.w) * c;
}

__device__ __forceinline__ uint64_t settle1(uint64_t x) { return uint64_t(uint32_t(x >> 32)) * kTwo32 + uint32_t(x); }

__device__ __forceinline__ void settle(uint64_t acc[4]) {
  for (int i = 0; i < 4; ++i) acc[i] = settle1(acc[i]);
}

// x * 2^-32 mod P for x < P 2^32, canonical (monty_mul's reduction)
__device__ __forceinline__ uint32_t monty_reduce(uint64_t x) {
  const uint32_t m = uint32_t(x) * ts::MU;
  const uint32_t u = __umulhi(m, ts::P);
  const uint32_t hi = uint32_t(x >> 32);
  const uint32_t r = hi - u;
  return hi < u ? r + ts::P : r;
}

// a thread's sums, settled and reduced: its share of sum alpha_k C_k, Monty
__device__ __forceinline__ uint4 finish(const uint64_t acc[4]) {
  uint4 v;
  v.x = monty_reduce(settle1(acc[0]));
  v.y = monty_reduce(settle1(acc[1]));
  v.z = monty_reduce(settle1(acc[2]));
  v.w = monty_reduce(settle1(acc[3]));
  return v;
}

__device__ __forceinline__ uint4 add4(uint4 v, const uint4 p) {
  v.x = ts::add_mod(v.x, p.x);
  v.y = ts::add_mod(v.y, p.y);
  v.z = ts::add_mod(v.z, p.z);
  v.w = ts::add_mod(v.w, p.w);
  return v;
}

// the staged quad in slot s of a row
__device__ __forceinline__ uint4 quad(const uint32_t* row, int s) { return reinterpret_cast<const uint4*>(row)[s]; }

// a thread's four sums
struct Acc {
  uint64_t v[4];
};

// the words of a staged row of w words: a multiple of 4 whose quotient by
// 4 is odd
__host__ __device__ constexpr int stride_of(int w) { return w == 0 ? 0 : (((w + 3) / 4) | 1) * 4; }

// kNone: an unused slot of a phase's quad table; kNext: a next-panel quad
constexpr uint16_t kNone = 0xFFFF, kNext = 0x8000;

template <class D>
struct Layout {
  static constexpr int kRows = 32 * D::NW;  // output rows a tile
  static constexpr int kConsumers = kRows * D::S;  // threads: S a row, one a share of each phase
  static constexpr int kStride = stride_of(4 * D::Q);
  static constexpr int kStage = kRows * kStride;
  static constexpr int kAlphaOff = D::NS * kStage;
  static constexpr int kTableOff = kAlphaOff + 4 * D::C;
  static constexpr int kPartOff = (kTableOff + (D::G * D::Q + 1) / 2 + 3) / 4 * 4;  // shares 1.. S-1's sums, 2 buffers
  static constexpr int kWordsTotal = kPartOff + 2 * (D::S - 1) * kRows * 4;  // the dynamic buffer
  // a block's shared memory (Dag.smem_bytes): the dynamic buffer and the
  // ring's mbarriers, full[NS] and empty[NS], static in quotient_kernel
  static constexpr int kBytes = kWordsTotal * 4 + 2 * 8 * D::NS;
};

// ---------------------------------------------------------------------------
// copies into shared memory: cp.async on the card, plain copies on the host
// ---------------------------------------------------------------------------
__device__ __forceinline__ void copy16(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDACC__
  const uint32_t d = uint32_t(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  std::memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void copy4(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDACC__
  const uint32_t d = uint32_t(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
#else
  *dst = *src;
#endif
}

// The program's alpha powers (cp.async) and its phases' quad tables into
// shared memory (all threads, once a block).
template <class D>
__device__ __forceinline__ void stage_consts(const Args& a, uint32_t* smem, int tid, int nt) {
  using L = Layout<D>;
  for (int k = tid; k < D::C; k += nt)
    copy16(smem + L::kAlphaOff + 4 * k, reinterpret_cast<const uint32_t*>(a.alpha + k));
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem + L::kTableOff);
  for (int i = tid; i < D::G * D::Q; i += nt) tab[i] = D::quads()[i];
}

// The source row of table entry e (q, or q | kNext) for row t: the current
// panel's row t, or the next panel's row (t + nshift) mod nrows_nxt.
__device__ __forceinline__ const uint32_t* unit_src(const Args& a, int64_t t, uint32_t e) {
  if (!(e & kNext)) return a.cur + t * a.ld_cur;
  int64_t row = t + a.nshift;
  if (row >= a.nrows_nxt) row -= a.nrows_nxt;
  return a.nxt + row * a.ld_nxt;
}

// Phase g of the tile at row t0 into ring slot `slot`, by the thread `lane`
// of nl: row r's slot s holds the quad of table entry s (columns [4q, 4q +
// 4) of its source row).  16-byte copies where both panels allow them,
// else 4-byte copies of the quad's columns inside [lo, hi).  Rows past
// `rows` are not copied.
template <class D>
__device__ __forceinline__ void stage_unit(const Args& a, uint32_t* smem, int64_t t0, int g, int slot, int lane,
                                           int nl) {
  using L = Layout<D>;
  constexpr int Q = D::Q;
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem + L::kTableOff) + g * Q;
  uint32_t* st = smem + slot * L::kStage;
  if ((a.vec & 1) && ((a.vec & 2) || D::hi1 == D::lo1)) {
    for (int i = lane; i < L::kRows * Q; i += nl) {
      const int r = i / Q, s = i - r * Q;
      const int64_t t = t0 + r;
      if (t >= a.rows) break;
      const uint32_t e = tab[s];
      if (e == kNone) continue;
      copy16(st + r * L::kStride + 4 * s, unit_src(a, t, e) + 4 * (e & ~uint32_t(kNext)));
    }
  } else {
    for (int i = lane; i < L::kRows * Q; i += nl) {
      const int r = i / Q, s = i - r * Q;
      const int64_t t = t0 + r;
      if (t >= a.rows) break;
      const uint32_t e = tab[s];
      if (e == kNone) continue;
      const uint32_t* src = unit_src(a, t, e);
      const int lo = e & kNext ? D::lo1 : D::lo0, hi = e & kNext ? D::hi1 : D::hi0;
      const int c0 = 4 * int(e & ~uint32_t(kNext));
      for (int w = 0; w < 4; ++w)
        if (c0 + w >= lo && c0 + w < hi) copy4(st + r * L::kStride + 4 * s + w, src + c0 + w);
    }
  }
}

// Phase g of the tile at t0 from ring slot `slot` for the consumer thread
// tid: share j = tid / kRows of the phase's constraints on row t0 + tid %
// kRows (past the last row it computes on the last row's selectors and
// whatever its staged row holds).  After the last phase a share j > 0
// leaves its row's sum, canonical, in part buffer `buf` for store_row.
template <class D>
__device__ __forceinline__ void eval_unit(const Args& a, uint32_t* smem, int64_t t0, int g, int slot, int tid,
                                          Acc& acc, int buf) {
  using L = Layout<D>;
  const int r = tid % L::kRows, j = tid / L::kRows;
  if (g == 0)
    for (int i = 0; i < 4; ++i) acc.v[i] = 0;
  const int64_t t = t0 + r;
  D::phase(g, j, a, smem + slot * L::kStage + r * L::kStride, t < a.rows ? t : a.rows - 1, acc.v,
           reinterpret_cast<const uint4*>(smem + L::kAlphaOff));
  if (g == D::G - 1 && j > 0)
    reinterpret_cast<uint4*>(smem + L::kPartOff)[(buf * (D::S - 1) + j - 1) * L::kRows + r] = finish(acc.v);
}

// After the last phase of the tile at t0 (and, with S > 1, a barrier of the
// consumers): share 0 of row t0 + tid adds the other shares' sums from part
// buffer `buf`, the accumulator's row (add), multiplies by inv_zeroifier
// (invz) and stores row acc_off + t * acc_stride of the (N, 4) accumulator.
template <class D>
__device__ __forceinline__ void store_row(const Args& a, const uint32_t* smem, int64_t t0, int tid, const Acc& acc,
                                          int buf) {
  using L = Layout<D>;
  const int64_t t = t0 + tid;
  if (tid >= L::kRows || t >= a.rows) return;
  uint4 v = finish(acc.v);
  for (int j = 1; j < D::S; ++j)
    v = add4(v, reinterpret_cast<const uint4*>(smem + L::kPartOff)[(buf * (D::S - 1) + j - 1) * L::kRows + tid]);
  uint4* o = reinterpret_cast<uint4*>(a.acc) + (a.acc_off + t * a.acc_stride);
  if (a.add) v = add4(v, *o);
  if (a.invz) {
    const uint32_t z = sel_at(a, 3, t);
    v.x = ts::monty_mul(v.x, z);
    v.y = ts::monty_mul(v.y, z);
    v.z = ts::monty_mul(v.z, z);
    v.w = ts::monty_mul(v.w, z);
  }
  *o = v;
}

// The tiles of a launch.
template <class D>
__host__ __device__ __forceinline__ int64_t tiles_of(const Args& a) {
  return (a.rows + Layout<D>::kRows - 1) / Layout<D>::kRows;
}

// Block b of nb walks its tiles b, b + nb, ... phase by phase: its unit u is
// phase u % G of tile b + (u / G) nb, staged in ring slot u % NS.
template <class D>
__host__ __device__ __forceinline__ int64_t units_of(int64_t tiles, int64_t b, int64_t nb) {
  return b < tiles ? ((tiles - 1 - b) / nb + 1) * D::G : 0;
}

template <class D>
__host__ __device__ __forceinline__ int64_t unit_t0(int64_t b, int64_t nb, int64_t u) {
  return (b + u / D::G * nb) * Layout<D>::kRows;
}

#ifdef __CUDACC__
__device__ __forceinline__ uint32_t smem_addr(const void* p) { return uint32_t(__cvta_generic_to_shared(p)); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// one arrival on the barrier
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];\n" : "=l"(state) : "r"(smem_addr(bar)) : "memory");
  (void)state;
}

// one arrival once this thread's cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The ring: full[s] completes when the producers' copies of slot s have
// landed (one arrival a producer thread), empty[s] when the consumer warps
// have evaluated it (one arrival a warp).  The k-th use of slot s is phase
// k of both barriers.
template <class D>
__global__ void __launch_bounds__(Layout<D>::kConsumers + D::NP * 32) quotient_kernel(const Args a) {
  using L = Layout<D>;
  constexpr int NS = D::NS, G = D::G, kConsumers = L::kConsumers;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint64_t full[NS], empty[NS];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x, nb = gridDim.x;
  const int64_t units = units_of<D>(tiles_of<D>(a), b, nb);
  stage_consts<D>(a, smem, tid, blockDim.x);
  if (tid == 0)
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], D::NP * 32);
      mbar_init(&empty[s], kConsumers / 32);
    }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // alpha, the quad tables and the barriers
  if (tid >= kConsumers) {
    const int lane = tid - kConsumers;
    for (int64_t u = 0; u < units; ++u) {
      const int s = int(u % NS);
      if (u >= NS) mbar_wait(&empty[s], uint32_t(u / NS - 1) & 1);
      stage_unit<D>(a, smem, unit_t0<D>(b, nb, u), int(u % G), s, lane, D::NP * 32);
      mbar_arrive_copies(&full[s]);
    }
  } else {
    Acc acc;
    for (int64_t u = 0; u < units; ++u) {
      const int s = int(u % NS);
      mbar_wait(&full[s], uint32_t(u / NS) & 1);
      const int64_t t0 = unit_t0<D>(b, nb, u);
      const int buf = int(u / G) & 1;
      eval_unit<D>(a, smem, t0, int(u % G), s, tid, acc, buf);
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&empty[s]);
      if (u % G == G - 1) {
        if (D::S > 1) asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");  // the shares' sums
        store_row<D>(a, smem, t0, tid, acc, buf);
      }
    }
  }
}

// Blocks of D's persistent grid (SMs x blocks an SM), set by init<D>.
template <class D>
struct Grid {
  static int blocks;
};
template <class D>
int Grid<D>::blocks = 0;

// Once a library, at load: D's shared memory attribute and its grid;
// blocks_per_sm gets the occupancy.  Returns the CUDA status.
template <class D>
int init(int* blocks_per_sm) {
  const int bytes = Layout<D>::kWordsTotal * 4;
  cudaError_t e = cudaFuncSetAttribute(quotient_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, quotient_kernel<D>, Layout<D>::kConsumers + D::NP * 32,
                                                            bytes)) != cudaSuccess)
    return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  Grid<D>::blocks = sms * occ;
  if (blocks_per_sm) *blocks_per_sm = occ;
  return 0;
}

// Launch D's kernel on the argument words w; returns the CUDA status.
template <class D>
int launch(const int64_t* w, cudaStream_t stream) {
  const Args a = unpack(w);
  if (a.rows <= 0) return 0;
  if (Grid<D>::blocks <= 0) return (int)cudaErrorInitializationError;
  const int64_t tiles = tiles_of<D>(a);
  const int64_t blocks = tiles < Grid<D>::blocks ? tiles : Grid<D>::blocks;
  quotient_kernel<D><<<unsigned(blocks), Layout<D>::kConsumers + D::NP * 32, Layout<D>::kWordsTotal * 4,
                                     stream>>>(a);
  return (int)cudaGetLastError();
}
#endif

}  // namespace tsq
