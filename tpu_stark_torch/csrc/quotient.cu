// K8: the panel coset fold of the streamed quotient (air/quotient_kernel.py
// panel_fold).  A quotient coset S * <g> (g of order n = r m) is cut into r
// row blocks, block k the points S g^k * <g_m>; on it x^m = S^m w^k with
// w = g^m of order r, so the (npan m, u) Monty coefficient columns tf of a
// partition evaluated on block k are an NTT (K2) of
//
//   out[k][i, c] = (S g^k)^i * sum_q tf[q m + i, c] * S^(m q) * w^(k q),
//
// an r-point DFT across the blocks of the scaled coefficients (q and q + r
// join: w^r = 1).  One pass reads tf once and writes all r (m, u) panels.
//
// Replaces the fold and the shift scale of the JAX package's XLA program
// tpu_stark/prover/wide.py:646 _panel_eval_fn (its NTT stays K2's), which
// the JAX package runs once a block.
//
// Bound: bytes, each coefficient read once and each output written once,
// 4 (npan + r) bytes a row and column against ~2 Montgomery products and
// ~2 modular adds an output.  A block takes a segment of rows [i0, i0 +
// seg) at a time: in each of the npan + r planes that is one contiguous run
// of seg u words, which the block's threads stream in 16-byte groups (V =
// 4: seg and m multiples of 4 and u >= 4 keep every group aligned, whatever
// u is, for r <= 8; else single words, V = 1), RB groups' loads issued
// before they are computed, every read and write coalesced.  A group may
// straddle two rows.
// The scales (S g^k)^i of the segment's rows are a table in shared memory
// (one power a row and block, computed by the block before the segment,
// double-buffered), read by each output; S^(m q) and w^j are per-launch
// constants.  The DFT is a radix-2 decimation in frequency in registers,
// every index a template constant (natural order in, bit-reversed order
// out, read back in natural order).  No int64 temporaries (babybear.cuh).
// The grid is the card's SMs times the kernel's occupancy, the blocks
// striding over the segments.
#include <cuda_runtime.h>

#include <cstdint>

#include "babybear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 32;         // row blocks a coset (prover/wide.py block_count)
constexpr int kMaxPan = 2 * kMaxR;  // coefficient runs of m rows: r, or 2 r (zk)
constexpr int kTableWords = 4096;  // a segment's scale table (seg R words), one buffer

struct PanelArgs {
  const uint32_t* tf;  // (npan m, u)
  uint32_t* out;       // (r, m, u)
  int64_t npan, m, u;
  int log_r, vec;          // vec: 16-byte groups (V = 4)
  uint32_t sk[kMaxR];      // S g^k, Monty
  uint32_t w[kMaxR / 2];   // w^j, j < r / 2, Monty
  uint32_t sq[kMaxPan];    // S^(m q), Monty
};

// words: tf, out, npan, m, u, log_r, vec; consts: sk[kMaxR], w[kMaxR / 2],
// sq[kMaxPan]
inline PanelArgs unpack_panel(const int64_t* w, const uint32_t* k) {
  PanelArgs a{};
  a.tf = reinterpret_cast<const uint32_t*>(w[0]);
  a.out = reinterpret_cast<uint32_t*>(w[1]);
  a.npan = w[2];
  a.m = w[3];
  a.u = w[4];
  a.log_r = int(w[5]);
  a.vec = int(w[6]);
  for (int j = 0; j < kMaxR; ++j) a.sk[j] = k[j];
  for (int j = 0; j < kMaxR / 2; ++j) a.w[j] = k[kMaxR + j];
  for (int j = 0; j < kMaxPan; ++j) a.sq[j] = k[kMaxR + kMaxR / 2 + j];
  return a;
}

__host__ __device__ constexpr int log2_of(int r) { return r <= 1 ? 0 : 1 + log2_of(r >> 1); }

template <int K, int LOG>
struct BitRev {
  static constexpr int value = ((K & 1) << (LOG - 1)) | BitRev<(K >> 1), LOG - 1>::value;
};
template <int K>
struct BitRev<K, 0> {
  static constexpr int value = 0;
};

// groups a thread loads before it computes them: about 32 words in flight
__host__ __device__ constexpr int groups_of(int words) { return words >= 32 ? 1 : words >= 16 ? 2 : 4; }

// Rows a segment: about 8 groups a thread, a multiple of 4, its table in
// kTableWords, at most m.
template <int R, int V>
inline int64_t panel_seg(const PanelArgs& a) {
  int64_t seg = (int64_t(8) * kThreads * V + a.u - 1) / a.u;
  seg = (seg + 3) / 4 * 4;
  const int64_t cap = kTableWords / R / 4 * 4;
  if (seg > cap) seg = cap;
  return seg < a.m ? seg : a.m;
}

__device__ __forceinline__ uint32_t monty_pow(uint32_t base, uint64_t e) {
  uint32_t acc = uint32_t((uint64_t(1) << 32) % ts::P);  // Monty form of 1
  while (e) {
    if (e & 1) acc = ts::monty_mul(acc, base);
    base = ts::monty_mul(base, base);
    e >>= 1;
  }
  return acc;
}

template <int V>
__device__ __forceinline__ void load_group(const uint32_t* p, uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_group(uint32_t* p, const uint32_t (&x)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
  else
    p[0] = x[0];
}

// One stage (butterfly span LEN) of the r-point DFT y_k = sum_t y_t w^(k t)
// in place, decimation in frequency, then the stages below it: the result
// in bit-reversed order.
template <int R, int LEN, int V>
struct Dif {
  static __device__ __forceinline__ void run(const PanelArgs& a, uint32_t (&y)[R][V]) {
    constexpr int half = LEN / 2, step = R / LEN;
#pragma unroll
    for (int s0 = 0; s0 < R; s0 += LEN)
#pragma unroll
      for (int j = 0; j < half; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const uint32_t x0 = y[s0 + j][v], x1 = y[s0 + j + half][v];
          y[s0 + j][v] = ts::add_mod(x0, x1);
          const uint32_t d = ts::sub_mod(x0, x1);
          y[s0 + j + half][v] = j == 0 ? d : ts::monty_mul(d, a.w[j * step]);
        }
    Dif<R, LEN / 2, V>::run(a, y);
  }
};
template <int R, int V>
struct Dif<R, 1, V> {
  static __device__ __forceinline__ void run(const PanelArgs&, uint32_t (&)[R][V]) {}
};

// Writes block K's group (and the blocks after it): the DFT's output
// bitrev(K) times the scale of each word's row, from the segment's table:
// row t's scales for the group's first vw words, the next row's after them
// (the group crosses a row's end).
template <int R, int K, int V>
struct Store {
  static __device__ __forceinline__ void run(const uint32_t (&y)[R][V], const uint32_t* t, int64_t vw,
                                             uint32_t* dst, int64_t plane) {
    uint32_t o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = ts::monty_mul(y[BitRev<K, log2_of(R)>::value][v], (v < vw ? t : t + R)[K]);
    store_group<V>(dst + K * plane, o);
    Store<R, K + 1, V>::run(y, t, vw, dst, plane);
  }
};
template <int R, int V>
struct Store<R, R, V> {
  static __device__ __forceinline__ void run(const uint32_t (&)[R][V], const uint32_t*, int64_t, uint32_t*, int64_t) {}
};

// The scales of rows [i0, i0 + rows) into tab: tab[d R + k] = (S g^k)^(i0 + d).
template <int R>
__device__ __forceinline__ void seg_table(const PanelArgs& a, uint32_t* tab, int64_t i0, int64_t rows, int tid,
                                          int nthr) {
  for (int64_t x = tid; x < rows * R; x += nthr) tab[x] = monty_pow(a.sk[x % R], uint64_t(i0 + x / R));
}

// Where a thread's groups lie in every segment: its first word (row d0,
// column c0 of the segment) and how far (dq rows, dr columns) the next is.
struct Walk {
  int64_t e0, step, d0, c0, dq, dr;
};

__device__ __forceinline__ Walk walk_of(int64_t u, int v, int tid, int nthr) {
  Walk w;
  w.e0 = int64_t(v) * tid;
  w.step = int64_t(v) * nthr;
  w.d0 = w.e0 / u;
  w.c0 = w.e0 - w.d0 * u;
  w.dq = w.step / u;
  w.dr = w.step - w.dq * u;
  return w;
}

// A thread's groups of the segment [i0, i0 + rows): the groups at words
// e0 + step j of the segment's rows u words.  F: npan = F R, 1 or 2 (zk).
template <int R, int F, int V>
__device__ __forceinline__ void seg_rows(const PanelArgs& a, const uint32_t* tab, int64_t i0, int64_t rows,
                                         const Walk& w) {
  const int64_t u = a.u, plane = a.m * u, end = rows * u, step = w.step, dq = w.dq, dr = w.dr;
  int64_t e = w.e0, d = w.d0, col = w.c0;
  const uint32_t* src = a.tf + i0 * u;
  uint32_t* dst = a.out + i0 * u;
  constexpr int NQ = F * R, RB = groups_of(F * R * V);
  while (e < end) {
    uint32_t x[RB][NQ][V];
    int64_t eb[RB], db[RB], cb[RB];
    int nb = 0;
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      if (e < end) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) load_group<V>(src + q * plane + e, x[rb][q]);
        eb[rb] = e;
        db[rb] = d;
        cb[rb] = col;
        nb = rb + 1;
        e += step;
        d += dq;
        col += dr;
        if (col >= u) {
          col -= u;
          ++d;
        }
      }
    }
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      if (rb >= nb) break;
      uint32_t b[R][V];
#pragma unroll
      for (int t = 0; t < R; ++t)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          uint32_t acc = t == 0 ? x[rb][0][v] : ts::monty_mul(x[rb][t][v], a.sq[t]);
          if constexpr (F == 2) acc = ts::add_mod(acc, ts::monty_mul(x[rb][R + t][v], a.sq[R + t]));
          b[t][v] = acc;
        }
      Dif<R, R, V>::run(a, b);
      Store<R, 0, V>::run(b, tab + db[rb] * R, u - cb[rb], dst + eb[rb], plane);
    }
  }
}

// Calls l.run<R, F, V>() for the launch's shape; cudaErrorInvalidValue for
// one the kernel does not take.
template <int F, int V, class L>
int by_blocks(const PanelArgs& a, const L& l) {
  switch (a.log_r) {
    case 0: return l.template run<1, F, V>();
    case 1: return l.template run<2, F, V>();
    case 2: return l.template run<4, F, V>();
    case 3: return l.template run<8, F, V>();
    default: break;
  }
  if constexpr (V == 1) {  // 16 and 32 blocks: one word a group (registers)
    if (a.log_r == 4) return l.template run<16, F, V>();
    if (a.log_r == 5) return l.template run<32, F, V>();
  }
  return (int)cudaErrorInvalidValue;
}

template <class L>
int panel_dispatch(const PanelArgs& a, const L& l) {
  const int64_t r = int64_t(1) << a.log_r;
  if (a.log_r < 0 || a.log_r > log2_of(kMaxR) || (a.npan != r && a.npan != 2 * r) ||
      (a.vec && (a.m % 4 || a.u < 4 || a.log_r > 3)))
    return (int)cudaErrorInvalidValue;
  if (a.vec) return a.npan == r ? by_blocks<1, 4>(a, l) : by_blocks<2, 4>(a, l);
  return a.npan == r ? by_blocks<1, 1>(a, l) : by_blocks<2, 1>(a, l);
}

#ifdef __CUDACC__
template <int R, int F, int V>
__global__ void __launch_bounds__(kThreads) panel_fold_kernel(const __grid_constant__ PanelArgs a, int64_t seg) {
  extern __shared__ uint32_t tabs[];  // two tables of seg R words
  const int64_t nseg = (a.m + seg - 1) / seg;
  const Walk w = walk_of(a.u, V, threadIdx.x, kThreads);
  int p = 0;
  for (int64_t s = blockIdx.x; s < nseg; s += gridDim.x, p ^= 1) {
    const int64_t i0 = s * seg, rows = a.m - i0 < seg ? a.m - i0 : seg;
    uint32_t* tab = tabs + p * seg * R;
    seg_table<R>(a, tab, i0, rows, threadIdx.x, kThreads);
    __syncthreads();  // the table written; the other buffer's readers are past the previous barrier
    seg_rows<R, F, V>(a, tab, i0, rows, w);
  }
}

// the card's SMs (the current device's, read once)
inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

struct Launch {
  const PanelArgs& a;
  cudaStream_t stream;
  template <int R, int F, int V>
  int run() const {
    static int occ = 0;  // blocks an SM at the largest table, read once an instance
    constexpr size_t kSmem = size_t(2) * kTableWords * 4;
    if (!occ) {
      const cudaError_t e =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, panel_fold_kernel<R, F, V>, kThreads, kSmem);
      if (e != cudaSuccess) return (int)e;
      if (occ < 1) occ = 1;
    }
    const int64_t seg = panel_seg<R, V>(a), nseg = (a.m + seg - 1) / seg, cap = int64_t(sm_count()) * occ;
    panel_fold_kernel<R, F, V>
        <<<unsigned(nseg < cap ? nseg : cap), kThreads, size_t(2) * seg * R * 4, stream>>>(a, seg);
    return (int)cudaGetLastError();
  }
};
#endif

}  // namespace

#ifdef __CUDACC__
// The r (m, u) panels of one coset from the (npan m, u) contiguous Monty
// matrix tf (see the top of this file).  Returns the CUDA error status of
// the launch.
extern "C" int ts_panel_fold(const int64_t* words, const uint32_t* consts, cudaStream_t stream) {
  const PanelArgs a = unpack_panel(words, consts);
  if (a.m <= 0 || a.u <= 0) return 0;
  return panel_dispatch(a, Launch{a, stream});
}
#endif
