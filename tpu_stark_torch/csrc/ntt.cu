// K2: fused-stage radix-2 DIT NTT over BabyBear, for Hopper.
//
// Replaces tpu_stark/ntt/pallas_ntt.py::_pass0_kernel (pass 0) and
// ::_pass_kernel (later passes).  Data is an (h, w) row-major matrix of
// Montgomery residues (< P) stored as u32; each column is one transform.
// Stage s butterflies rows that differ by 2^s with the twiddle
// w_{2^(s+1)}^e (e = row mod 2^s), read from one concatenated table `tw` of
// Montgomery forms at offset 2^s - 1 + e (ntt/ntt_kernel.py::stage_twiddles:
// the values of tpu_stark/ntt/radix2.py::_stage_twiddles_np, times 2^32).
// A Montgomery product by a Montgomery-form twiddle keeps data in Montgomery
// form and every output is reduced to [0, P), so results are bit-identical
// to the JAX radix-2 NTT.
//
// Pass structure (planned by ntt/ntt_kernel.py::plan):
//   pass 0   stages 0..k-1 of the bit-reversed rows;
//   pass s0  stages s0..s0+k-1 in place.
// A block owns a tile of 2^k positions x 2^LG lanes: position t is 2^k rows
// at stride 2^s0 (pass 0: the bit-reversed rows rev(t) << (log_h - k)), and
// its lanes are contiguous words of the matrix: 2^LG columns of a column
// tile when w > 2^LG, or J = 2^j_log adjacent rows of every column when w is
// smaller.  LG = 5 (one 128-byte line) for w >= 8, LG = 4 below, and the
// tile is at most 64 KB, so three blocks share an SM.  Column tiles split
// the columns evenly (w = 257 gives 9 tiles of 28-29).
//
// Inside a block the k stages run in rounds of up to R stages (R = 3, 4, 5
// for vectors of V = 4, 2, 1 lanes): each thread holds 2^R positions x V
// lanes (32 words) in registers and runs its R stages there with no barrier.
// The first round loads straight from global memory (V-word vector loads,
// 2^R of them in flight per thread), the last stores straight to global
// memory, and the rounds between exchange through the shared-memory tile,
// one __syncthreads() each.  Where the tile row is under 128 bytes its rows
// are XOR-swizzled within each bank row so the first round's strided writes
// hit distinct banks.  Twiddles come from shared memory, filled once per
// block: pass 0 copies the first 2^k - 1 entries of `tw`; a later pass with
// one stride offset j per block stores w_{2^(l+1)}^t' * w_{2^(s0+l+1)}^j (=
// the stage-(s0+l) twiddle of row t'*2^s0 + j); with J > 1 offsets it keeps
// the 2^k - 1 inner values and k*J twists and multiplies the two per
// twiddle.  Tile widths and round sizes are template parameters: the inner
// loops have no division, and the per-element index work is a shift, an or
// and (narrow tiles) a swizzle.
//
// Bound on the H100: a pass streams the matrix once from and to HBM (8 bytes
// per element at 3.35 TB/s); the whole transform's bound is one such round
// trip, or its butterflies' int32 instructions where those take longer.
// What decides a pass's speed is the length of the contiguous run each
// position reads and writes and how many blocks share an SM: a tile of
// 128-byte rows that fits three to an SM holds 2^9 rows, so h = 2^19..2^27
// takes three passes.  Two passes of 11 and 10 stages need 2^11-row tiles:
// with 64-byte rows (one 128 KB tile per SM) they were slower than three
// passes of 128-byte rows.  PERF.md has the times of the plan and of the
// alternatives (port_timing.py k2).

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

using ts::add_mod;
using ts::monty_mul;
using ts::sub_mod;

constexpr int kThreads = 256;

template <int V> struct Rounds;  // the most stages a thread runs in registers
template <> struct Rounds<4> { static constexpr int R = 3; };
template <> struct Rounds<2> { static constexpr int R = 4; };
template <> struct Rounds<1> { static constexpr int R = 5; };

template <int V> struct Vec;
template <> struct Vec<4> { using T = uint4; };
template <> struct Vec<2> { using T = uint2; };
template <> struct Vec<1> { using T = uint32_t; };

template <int V>
__device__ __forceinline__ void load_v(uint32_t (&x)[V], const uint32_t* p) {
  const typename Vec<V>::T v = *reinterpret_cast<const typename Vec<V>::T*>(p);
  if constexpr (V == 4) { x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w; }
  else if constexpr (V == 2) { x[0] = v.x; x[1] = v.y; }
  else { x[0] = v; }
}

template <int V>
__device__ __forceinline__ void store_v(uint32_t* p, const uint32_t (&x)[V]) {
  typename Vec<V>::T v;
  if constexpr (V == 4) { v.x = x[0]; v.y = x[1]; v.z = x[2]; v.w = x[3]; }
  else if constexpr (V == 2) { v.x = x[0]; v.y = x[1]; }
  else { v = x[0]; }
  *reinterpret_cast<typename Vec<V>::T*>(p) = v;
}

__device__ __forceinline__ uint32_t rev_bits(uint32_t v, int bits) {
  return bits == 0 ? 0u : (__brev(v) >> (32 - bits));
}

struct PassArgs {
  const uint32_t* in;
  uint32_t* out;  // == in for a later pass (in place)
  const uint32_t* tw;
  int64_t w;
  int log_h, s0, k, j_log, n_ct;
};

// What one thread needs to address its lanes, fixed for the whole block.
struct Lane {
  int lo;           // word offset of the thread's V lanes in a tile row
  bool valid;       // lanes past the tile's width are computed, not moved
  int jj;           // stride offset (row within the J adjacent rows)
  int64_t src0;     // word address of the tile row t = 0 (plus lo)
  int64_t row_w;    // later pass: words between positions (2^s0 * w)
  int64_t out0;     // pass 0: word address of output row 0 of this lane
  int rest;         // pass 0: log_h - k
  uint32_t* tile;   // shared tile, 2^k x 2^LG words
  const uint32_t* s_tw;
  const uint32_t* s_twist;
  int swz;          // first round's size: the swizzle's shift
};

// Physical word of tile row t (2^LG words): rows sit 32 >> LG to a 128-byte
// bank row; the slot is XORed with the row's bits above the first round's
// stride so that the rows one shared-memory access phase touches are in
// distinct banks in every round.
template <int LG>
__device__ __forceinline__ int tile_row(int t, int swz) {
  constexpr int slots = (32 >> LG) - 1;
  if constexpr (slots == 0) return t << LG;
  else return (t ^ ((t >> swz) & slots)) << LG;
}

template <int V, int LG>  // log2 vectors per tile row
struct NvLog { static constexpr int value = LG - (V == 4 ? 2 : V == 2 ? 1 : 0); };

template <bool PASS0>
__device__ __forceinline__ int64_t src_addr(const Lane& ln, int t, int k) {
  if constexpr (PASS0) return ln.src0 + ((int64_t)rev_bits(t, k) << ln.rest) * ln.row_w;
  else return ln.src0 + (int64_t)t * ln.row_w;
}

template <bool PASS0>
__device__ __forceinline__ int64_t dst_addr(const Lane& ln, int t, int64_t w) {
  if constexpr (PASS0) return ln.out0 + (int64_t)t * w;
  else return ln.src0 + (int64_t)t * ln.row_w;
}

// One round: stages l0..l0+RS-1 of the pass for every unit of this thread.
template <int V, int LG, int RS, bool PASS0, bool TWIST>
__device__ __forceinline__ void run_round(const PassArgs& a, const Lane& ln, int l0,
                                          bool first, bool last) {
  constexpr int NV_LOG = NvLog<V, LG>::value;
  constexpr int N = 1 << RS;
  const int k = a.k;
  const int n_units = 1 << (NV_LOG + k - RS);
  const int lo_mask = (1 << l0) - 1;
  for (int u = threadIdx.x; u < n_units; u += blockDim.x) {
    const int g = u >> NV_LOG;
    const int g_lo = g & lo_mask;
    const int tbase = ((g >> l0) << (l0 + RS)) | g_lo;
    uint32_t x[N][V];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int t = tbase | (i << l0);
      if (first) {
        if (ln.valid) {
          load_v<V>(x[i], a.in + src_addr<PASS0>(ln, t, k));
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) x[i][v] = 0;
        }
      } else {
        load_v<V>(x[i], ln.tile + tile_row<LG>(t, ln.swz) + ln.lo);
      }
    }
#pragma unroll
    for (int m = 0; m < RS; ++m) {
      const int l = l0 + m;
      const int half = 1 << m;
      if (PASS0 && m == 0 && l0 == 0) {  // stage 0: every twiddle is 1
#pragma unroll
        for (int i = 0; i < N; i += 2) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const uint32_t lo = x[i][v], hi = x[i + 1][v];
            x[i][v] = add_mod(lo, hi);
            x[i + 1][v] = sub_mod(lo, hi);
          }
        }
        continue;
      }
      uint32_t twist = 0;
      if constexpr (TWIST) twist = ln.s_twist[(l << a.j_log) + ln.jj];
#pragma unroll
      for (int ip = 0; ip < half; ++ip) {
        uint32_t tw = ln.s_tw[(1 << l) - 1 + ((ip << l0) | g_lo)];
        if constexpr (TWIST) tw = monty_mul(tw, twist);
#pragma unroll
        for (int b = 0; b < N; b += 2 * half) {
          const int i = b + ip;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const uint32_t lo = x[i][v];
            const uint32_t hi = monty_mul(x[i + half][v], tw);
            x[i][v] = add_mod(lo, hi);
            x[i + half][v] = sub_mod(lo, hi);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int t = tbase | (i << l0);
      if (last) {
        if (ln.valid) store_v<V>(a.out + dst_addr<PASS0>(ln, t, a.w), x[i]);
      } else {
        store_v<V>(ln.tile + tile_row<LG>(t, ln.swz) + ln.lo, x[i]);
      }
    }
  }
}

template <int V, int LG, bool PASS0, bool TWIST>
__device__ __forceinline__ void round_of(int rs, const PassArgs& a, const Lane& ln,
                                         int l0, bool first, bool last) {
  switch (rs) {
    case 1: run_round<V, LG, 1, PASS0, TWIST>(a, ln, l0, first, last); break;
    case 2: run_round<V, LG, 2, PASS0, TWIST>(a, ln, l0, first, last); break;
    case 3: run_round<V, LG, 3, PASS0, TWIST>(a, ln, l0, first, last); break;
    case 4:
      if constexpr (Rounds<V>::R >= 4) run_round<V, LG, 4, PASS0, TWIST>(a, ln, l0, first, last);
      break;
    case 5:
      if constexpr (Rounds<V>::R >= 5) run_round<V, LG, 5, PASS0, TWIST>(a, ln, l0, first, last);
      break;
  }
}

template <int V, int LG, bool PASS0, bool TWIST>
__global__ void __launch_bounds__(kThreads)
ntt_pass_kernel(const PassArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int NV_LOG = NvLog<V, LG>::value;
  const int k = a.k;
  const int T = 1 << k;
  const int J = 1 << a.j_log;
  uint32_t* s_tw = sm;                                   // 2^k words
  uint32_t* s_twist = sm + ((T + 3) & ~3);               // k * J words
  uint32_t* tile = s_twist + ((k * J + 3) & ~3);         // 2^k * 2^LG words

  // block -> (row block, column tile); one division per block
  const int ct = blockIdx.x % a.n_ct;
  const int64_t rb = blockIdx.x / a.n_ct;
  const int64_t wv = a.w / V;  // vector columns
  const int64_t v0 = ct * wv / a.n_ct, v1 = (ct + 1) * wv / a.n_ct;
  const int64_t col0 = v0 * V;
  const int tile_w = a.n_ct > 1 ? (int)((v1 - v0) * V) : (int)(a.w << a.j_log);

  Lane ln;
  ln.lo = (threadIdx.x & ((1 << NV_LOG) - 1)) * V;
  ln.valid = ln.lo < tile_w;
  ln.jj = a.n_ct > 1 || !ln.valid ? 0 : (int)(ln.lo / a.w);  // once per thread
  ln.tile = tile;
  ln.s_tw = s_tw;
  ln.s_twist = s_twist;
  int64_t j0;
  if constexpr (PASS0) {
    // G = J adjacent source sub-rows c0.. ; position t is source row
    // (rev_k(t) << rest) + c0 + jj; output row (rev_rest(c0 + jj) << k) + t
    ln.rest = a.log_h - k;
    const int64_t c0 = rb << a.j_log;
    ln.row_w = a.w;
    ln.src0 = c0 * a.w + col0 + ln.lo;
    const int64_t c = ln.lo - (int64_t)ln.jj * a.w;
    ln.out0 = ((int64_t)rev_bits((uint32_t)(c0 + ln.jj), ln.rest) << k) * a.w + col0 + c;
    j0 = 0;
  } else {
    // rows base + t*2^s0 + jj, base = a_blk*2^(s0+k) + j0
    const int jb_log = a.s0 - a.j_log;
    const int64_t a_blk = rb >> jb_log;
    j0 = (rb & (((int64_t)1 << jb_log) - 1)) << a.j_log;
    ln.rest = 0;
    ln.row_w = a.w << a.s0;
    ln.src0 = ((a_blk << (a.s0 + k)) + j0) * a.w + col0 + ln.lo;
    ln.out0 = 0;
  }

  // twiddles for the block: inner w_{2^(l+1)}^t' at 2^l - 1 + t'
  for (int e = threadIdx.x; e < T - 1; e += blockDim.x) {
    uint32_t v = a.tw[e];
    if constexpr (!PASS0 && !TWIST) {
      const int l = 31 - __clz(e + 1);
      v = monty_mul(v, a.tw[((int64_t)1 << (a.s0 + l)) - 1 + j0]);
    }
    s_tw[e] = v;
  }
  if constexpr (TWIST) {
    for (int e = threadIdx.x; e < k * J; e += blockDim.x) {
      const int l = e >> a.j_log;
      s_twist[e] = a.tw[((int64_t)1 << (a.s0 + l)) - 1 + j0 + (e & (J - 1))];
    }
  }
  __syncthreads();

  constexpr int R = Rounds<V>::R;
  const int n_rounds = (k + R - 1) / R;
  const int big = k % n_rounds;  // the first `big` rounds take one stage more
  const int base = k / n_rounds;
  ln.swz = base + (big > 0);
  int l0 = 0;
  for (int r = 0; r < n_rounds; ++r) {
    const int rs = base + (r < big);
    if (r > 0) __syncthreads();
    round_of<V, LG, PASS0, TWIST>(rs, a, ln, l0, r == 0, r == n_rounds - 1);
    l0 += rs;
  }
}

template <int V, int LG, bool PASS0, bool TWIST>
int launch(const PassArgs& a, size_t smem, int64_t blocks, cudaStream_t stream) {
  // threads: the units of the round with the most stages (a multiple of the
  // lane vectors per tile row), at most kThreads
  constexpr int NV_LOG = NvLog<V, LG>::value;
  const int r = a.k < Rounds<V>::R ? a.k : Rounds<V>::R;
  const int units_log = NV_LOG + a.k - r;
  const int threads = units_log >= 8 ? kThreads : units_log <= 5 ? 32 : 1 << units_log;
  // above 48 KB the launch needs the opt-in, which is per device: set on
  // every launch (a host-side write), to the most a block may have
  const cudaError_t e = cudaFuncSetAttribute(
      ntt_pass_kernel<V, LG, PASS0, TWIST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      227 * 1024);
  if (e != cudaSuccess) return (int)e;
  ntt_pass_kernel<V, LG, PASS0, TWIST><<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int V, int LG>
int launch_v(const PassArgs& a, size_t smem, int64_t blocks, cudaStream_t stream) {
  if (a.s0 == 0) return launch<V, LG, true, false>(a, smem, blocks, stream);
  if (a.j_log > 0) return launch<V, LG, false, true>(a, smem, blocks, stream);
  return launch<V, LG, false, false>(a, smem, blocks, stream);
}

template <int LG>
int launch_lg(int v, const PassArgs& a, size_t smem, int64_t blocks, cudaStream_t stream) {
  if (v == 4) return launch_v<4, LG>(a, smem, blocks, stream);
  if (v == 2) return launch_v<2, LG>(a, smem, blocks, stream);
  return launch_v<1, LG>(a, smem, blocks, stream);
}

}  // namespace

// One pass: stages s0..s0+k-1 (s0 == 0: pass 0, out-of-place from the
// bit-reversed rows of `in`; otherwise in place, in == out) of an (h, w)
// matrix, h = 2^log_h.  lanes_log: log2 words per tile row (4 or 5);
// j_log: log2 of the adjacent rows per tile row (w below the row), n_ct:
// column tiles (w above it), v: words per vector access (4, 2 or 1; the
// caller checks the alignment).  Returns cudaGetLastError().
extern "C" int ts_ntt_pass(const uint32_t* in, uint32_t* out, int64_t w, int log_h,
                           int s0, int k, int lanes_log, int j_log, int n_ct, int v,
                           const uint32_t* tw, cudaStream_t stream) {
  const PassArgs a{in, out, tw, w, log_h, s0, k, j_log, n_ct};
  const int64_t blocks = ((int64_t)1 << (log_h - k - j_log)) * n_ct;
  const int T = 1 << k;
  const int r = v == 4 ? Rounds<4>::R : v == 2 ? Rounds<2>::R : Rounds<1>::R;
  const size_t words = ((T + 3) & ~3) + ((k * (1 << j_log) + 3) & ~3) +
                       (k > r ? (size_t)T << lanes_log : 0);
  const size_t smem = words * sizeof(uint32_t);
  if (lanes_log == 4) return launch_lg<4>(v, a, smem, blocks, stream);
  if (lanes_log == 5) return launch_lg<5>(v, a, smem, blocks, stream);
  return (int)cudaErrorInvalidValue;
}
