// The open phase's PCS arithmetic (commit/open_kernel.py), on the
// BabyBear^4 device functions of ext4.cuh.  Three kernels:
//
// K9 reduced_opening: for each row i of a height-2^log_h codeword held
// from global row row0, acc[i] += (sum_c alpha^(off+c) m[i, c] - s) /
// (y_i - z), y_i = g_H^bitrev(row0 + i); with no point it adds the column
// sum alone.  The matrices of a group are operands (pointer, width, row
// stride) whose alpha powers follow one another; a codeword may be read in
// natural row order (row bitrev(row0 + i) of the full-height matrix); an
// (rows, 4) ext sum may stand in for or join the columns.  Replaces
// tpu_stark/commit/pcs.py:1005 _reduced_quotient with :976
// _combine_columns (streamed: tpu_stark/prover/wide.py:341).
//   A thread takes R rows i0 + 32 r of a tile of 32 R rows (a warp's lanes
// take neighbouring rows), so y = y_0 g_H^bitrev(32 r): one power a thread
// and one product a row, the 2^log_h-row table of the plain version never
// built; its R inverses are one ext inverse (by the norm and one Fermat
// base inverse) and three ext products a row (Montgomery's batch trick).
//   Bound: bytes, or operations at narrow widths and in the dividing mode:
// an element 4 Montgomery products and 4 modular adds; a dividing row y
// and y - z (a product and an add) and 4 ext products (Karatsuba: 12
// Montgomery products, 27 modular adds), and 1/R of a power and an inverse.
//
// K10 eval_at_points: sum_r c[r, col] z^(r0 + r) for one or two points, in
// one read of the (h, w) coefficients.  Replaces tpu_stark/commit/pcs.py:227
// _eval_at_point (streamed: tpu_stark/prover/wide.py:329).  A block takes a
// tile of cw columns over a range of rows, 256 rows at a time: each thread
// steps the power of one row of the 256 by z^256 (one ext product a row for
// all the tile's columns) into shared memory, then adds the products of its
// column's rows; the block's sums are reduced in shared memory into an
// (nrb, P, w, 4) scratch that a second kernel sums over its row blocks, a
// warp an output word.
//
// K11 fri_fold: one arity-2 FRI fold in the bit-reversed plain frame,
// out[j] = (e + o)/2 + beta (e - o)/(2 y_j), e = cw[2 j], o = cw[2 j + 1],
// y_j = g_lh^bitrev_{lh-1}(j0 + j), plus the next height's reduced opening
// when given.  Replaces tpu_stark/commit/pcs.py:1042 _fold_codeword
// (:1094 _fold_eo_jit, :1055 _fold_inv2y_build).  1/(2 y) is made as K9
// makes y, from g_lh^-1.  Bound: bytes (32 read and 16, or 32 with the add,
// moved an output).
//
// Every value is a Montgomery form; every sum is exact mod p in any order.
#include <cuda_runtime.h>

#include <cstdint>

#include "ext4.cuh"

namespace {

using ts::Ext;

constexpr int kThreads = 256;
constexpr int kMaxOps = 32;  // operands of one K9 launch
constexpr int kTab = 8;      // the most rows a thread takes (R)

__device__ __forceinline__ Ext ldg_ext(const uint32_t* p) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  return Ext{{v.x, v.y, v.z, v.w}};
}

__device__ __forceinline__ Ext ld_ext(const uint32_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  return Ext{{v.x, v.y, v.z, v.w}};
}

__device__ __forceinline__ void st_ext(uint32_t* p, const Ext& a) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a.c[0], a.c[1], a.c[2], a.c[3]);
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------
struct OpeningArgs {
  int64_t rows, row0;
  int log_h, natural, has_point, log_r;
  const uint32_t* apows;   // (sum of widths, 4), 16-byte aligned
  const uint32_t* ext_in;  // (rows, 4) or null
  uint32_t* acc;           // (rows, 4), 16-byte aligned
  int nops;
  const uint32_t* ptr[kMaxOps];
  int64_t width[kMaxOps], ld[kMaxOps];  // a negative width: read 16 bytes at a time (width and stride multiples of 4)
  uint32_t g;  // g_H
  Ext z, s;
  uint32_t tab[kTab];  // g_H^bitrev_{log_h}(32 r)
};

// words: rows, row0, log_h, natural, has_point, log_r, apows, ext_in, acc,
// nops, then (pointer, width, row stride) an operand; consts: g, z, s, tab
inline OpeningArgs unpack_opening(const int64_t* w, const uint32_t* k) {
  OpeningArgs a{};
  a.rows = w[0];
  a.row0 = w[1];
  a.log_h = int(w[2]);
  a.natural = int(w[3]);
  a.has_point = int(w[4]);
  a.log_r = int(w[5]);
  a.apows = reinterpret_cast<const uint32_t*>(w[6]);
  a.ext_in = reinterpret_cast<const uint32_t*>(w[7]);
  a.acc = reinterpret_cast<uint32_t*>(w[8]);
  a.nops = int(w[9]);
  for (int i = 0; i < a.nops && i < kMaxOps; ++i) {
    a.ptr[i] = reinterpret_cast<const uint32_t*>(w[10 + 3 * i]);
    a.width[i] = w[11 + 3 * i];
    a.ld[i] = w[12 + 3 * i];
  }
  a.g = k[0];
  for (int c = 0; c < 4; ++c) {
    a.z.c[c] = k[1 + c];
    a.s.c[c] = k[5 + c];
  }
  for (int r = 0; r < kTab; ++r) a.tab[r] = k[9 + r];
  return a;
}

// sum_c alpha^(off+c) m[row, c] over the operands, plus ext_in[i]; an
// operand of 16-byte aligned rows (a negative width) is read 4 words a load
__device__ __forceinline__ Ext combined(const OpeningArgs& a, int64_t i) {
  Ext acc = a.ext_in ? ldg_ext(a.ext_in + 4 * i) : ts::ext_zero();
  const int64_t row = a.natural ? int64_t(ts::bitrev(uint32_t(a.row0 + i), a.log_h)) : i;
  const uint32_t* ap = a.apows;
  for (int k = 0; k < a.nops; ++k) {
    const uint32_t* m = a.ptr[k] + row * a.ld[k];
    if (a.width[k] < 0) {
      for (int64_t c = 0; c < -a.width[k]; c += 4, ap += 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(m + c));
        acc = ts::ext_add(acc, ts::ext_mul_base(ldg_ext(ap), v.x));
        acc = ts::ext_add(acc, ts::ext_mul_base(ldg_ext(ap + 4), v.y));
        acc = ts::ext_add(acc, ts::ext_mul_base(ldg_ext(ap + 8), v.z));
        acc = ts::ext_add(acc, ts::ext_mul_base(ldg_ext(ap + 12), v.w));
      }
      continue;
    }
    for (int64_t c = 0; c < a.width[k]; ++c, ap += 4)
      acc = ts::ext_add(acc, ts::ext_mul_base(ldg_ext(ap), __ldg(m + c)));
  }
  return acc;
}

// y - z for y in the base field
__device__ __forceinline__ Ext y_minus_z(const OpeningArgs& a, uint32_t y) {
  return Ext{{ts::sub_mod(y, a.z.c[0]), ts::sub_mod(0u, a.z.c[1]), ts::sub_mod(0u, a.z.c[2]),
              ts::sub_mod(0u, a.z.c[3])}};
}

// Work item g: rows i0 + 32 r (r < R) of the tile g / 32, i0 = tile 32 R + g % 32.
template <int R>
__device__ __forceinline__ void opening_item(const OpeningArgs& a, int64_t g) {
  const int64_t i0 = (g >> 5) * 32 * R + (g & 31);
  if (i0 >= a.rows) return;
  if (!a.has_point) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t i = i0 + 32 * r;
      if (i < a.rows) st_ext(a.acc + 4 * i, ts::ext_add(ld_ext(a.acc + 4 * i), combined(a, i)));
    }
    return;
  }
  const uint32_t y0 = ts::base_pow(a.g, ts::bitrev(uint32_t(a.row0 + i0), a.log_h));
  Ext pre[R];  // running products of the nonzero (y - z) of rows 0..r
  Ext run = ts::ext_one();
  unsigned zero = 0;  // rows whose y - z is 0: the plain inverse of 0 is 0
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (i0 + 32 * r < a.rows) {
      const Ext d = y_minus_z(a, R == 1 ? y0 : ts::monty_mul(y0, a.tab[r]));
      if (ts::ext_is_zero(d))
        zero |= 1u << r;
      else
        run = ts::ext_mul(run, d);
    }
    pre[r] = run;
  }
  Ext inv = ts::ext_inv(run);
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int64_t i = i0 + 32 * r;
    if (i >= a.rows) continue;
    Ext inv_r = ts::ext_zero();
    if (!((zero >> r) & 1u)) {
      inv_r = r > 0 ? ts::ext_mul(inv, pre[r > 0 ? r - 1 : 0]) : inv;
      inv = ts::ext_mul(inv, y_minus_z(a, R == 1 ? y0 : ts::monty_mul(y0, a.tab[r])));
    }
    const Ext q = ts::ext_mul(ts::ext_sub(combined(a, i), a.s), inv_r);
    st_ext(a.acc + 4 * i, ts::ext_add(ld_ext(a.acc + 4 * i), q));
  }
}

inline int64_t opening_items(const OpeningArgs& a) {
  const int64_t tile = int64_t(32) << a.log_r;
  return (a.rows + tile - 1) / tile * 32;
}

// ---------------------------------------------------------------------------
// K10
// ---------------------------------------------------------------------------
struct PointsArgs {
  const uint32_t* c;  // (h, w), row stride ld
  int64_t h, w, ld;
  int npts;
  int64_t cw, nct, rb_rows, nrb;  // tile width (a power of two <= 32), tiles, rows a block, row blocks
  uint32_t* partial;              // (nrb, npts, w, 4)
  uint32_t* out;                  // (npts, w, 4), point stride out_ld
  int64_t out_ld;
  int accumulate;
  Ext z[2], zr0[2], zstep[2];  // z, z^r0, z^256
};

// words: c, h, w, ld, npts, cw, nct, rb_rows, nrb, partial, out, out_ld,
// accumulate; consts: z, z^r0, z^256 of each point
inline PointsArgs unpack_points(const int64_t* w, const uint32_t* k) {
  PointsArgs a{};
  a.c = reinterpret_cast<const uint32_t*>(w[0]);
  a.h = w[1];
  a.w = w[2];
  a.ld = w[3];
  a.npts = int(w[4]);
  a.cw = w[5];
  a.nct = w[6];
  a.rb_rows = w[7];
  a.nrb = w[8];
  a.partial = reinterpret_cast<uint32_t*>(w[9]);
  a.out = reinterpret_cast<uint32_t*>(w[10]);
  a.out_ld = w[11];
  a.accumulate = int(w[12]);
  for (int p = 0; p < 2; ++p)
    for (int c = 0; c < 4; ++c) {
      a.z[p].c[c] = k[4 * p + c];
      a.zr0[p].c[c] = k[8 + 4 * p + c];
      a.zstep[p].c[c] = k[16 + 4 * p + c];
    }
  return a;
}

// z^(r0 + row)
__device__ __forceinline__ Ext point_power(const PointsArgs& a, int p, int64_t row) {
  return ts::ext_mul(a.zr0[p], ts::ext_pow(a.z[p], uint64_t(row)));
}

// Thread t's share of the 256 rows from ``chunk`` (the block's rows end at
// ``end``) of tile ct: the rows chunk + ty + k rl of its column ct cw + tx,
// against the chunk's powers pows[p][256][4].
template <int NP>
__device__ __forceinline__ void points_chunk(const PointsArgs& a, const uint32_t* pows, int64_t chunk, int64_t end,
                                             int64_t ct, int t, Ext acc[NP]) {
  const int64_t tx = t % a.cw, ty = t / a.cw, rl = kThreads / a.cw, col = ct * a.cw + tx;
  if (col >= a.w) return;
  for (int64_t rr = ty; rr < kThreads && chunk + rr < end; rr += rl) {
    const uint32_t v = __ldg(a.c + (chunk + rr) * a.ld + col);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      acc[p] = ts::ext_add(acc[p], ts::ext_mul_base(ts::ext_load(pows + (p * kThreads + rr) * 4), v));
  }
}

// the second pass, a warp an output word g of (npts, w, 4): lane's share
// of its sum over the row blocks (rb = lane, lane + 32, ...)
__device__ __forceinline__ uint32_t points_sum_lane(const PointsArgs& a, int64_t g, int lane) {
  const int64_t per = a.w * 4, p = g / per, rem = g % per;
  uint32_t s = 0;
  for (int64_t rb = lane; rb < a.nrb; rb += 32) s = ts::add_mod(s, a.partial[(rb * a.npts + p) * per + rem]);
  return s;
}

// output word g takes the sum s of its row blocks (added with accumulate)
__device__ __forceinline__ void points_store(const PointsArgs& a, int64_t g, uint32_t s) {
  const int64_t per = a.w * 4;
  uint32_t* o = a.out + (g / per) * a.out_ld + g % per;
  *o = a.accumulate ? ts::add_mod(*o, s) : s;
}

// ---------------------------------------------------------------------------
// K11
// ---------------------------------------------------------------------------
struct FoldArgs {
  const uint32_t* cw;   // (2 half, 4)
  uint32_t* out;        // (half, 4)
  const uint32_t* add;  // (half, 4) or null
  int64_t half, j0;
  int log_h, log_r;
  uint32_t ginv, inv2;  // g_lh^-1; 1/2
  Ext beta;
  uint32_t tab[kTab];  // (1/2) g_lh^-bitrev_{lh-1}(32 r)
};

// words: cw, out, add, half, j0, log_h, log_r; consts: ginv, inv2, beta, tab
inline FoldArgs unpack_fold(const int64_t* w, const uint32_t* k) {
  FoldArgs a{};
  a.cw = reinterpret_cast<const uint32_t*>(w[0]);
  a.out = reinterpret_cast<uint32_t*>(w[1]);
  a.add = reinterpret_cast<const uint32_t*>(w[2]);
  a.half = w[3];
  a.j0 = w[4];
  a.log_h = int(w[5]);
  a.log_r = int(w[6]);
  a.ginv = k[0];
  a.inv2 = k[1];
  for (int c = 0; c < 4; ++c) a.beta.c[c] = k[2 + c];
  for (int r = 0; r < kTab; ++r) a.tab[r] = k[6 + r];
  return a;
}

template <int R>
__device__ __forceinline__ void fold_item(const FoldArgs& a, int64_t g) {
  const int64_t j_first = (g >> 5) * 32 * R + (g & 31);
  if (j_first >= a.half) return;
  const uint32_t y0 = ts::base_pow(a.ginv, ts::bitrev(uint32_t(a.j0 + j_first), a.log_h - 1));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t j = j_first + 32 * r;
    if (j >= a.half) break;
    const uint32_t inv2y = ts::monty_mul(y0, a.tab[r]);
    const Ext e = ldg_ext(a.cw + 8 * j), o = ldg_ext(a.cw + 8 * j + 4);
    const Ext hs = ts::ext_mul_base(ts::ext_add(e, o), a.inv2);
    const Ext hd = ts::ext_mul_base(ts::ext_sub(e, o), inv2y);
    Ext v = ts::ext_add(hs, ts::ext_mul(a.beta, hd));
    if (a.add) v = ts::ext_add(v, ldg_ext(a.add + 4 * j));
    st_ext(a.out + 4 * j, v);
  }
}

inline int64_t fold_items(const FoldArgs& a) {
  const int64_t tile = int64_t(32) << a.log_r;
  return (a.half + tile - 1) / tile * 32;
}

#ifdef __CUDACC__
inline unsigned grid_of(int64_t items) {
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  return unsigned(blocks < (int64_t(1) << 30) ? blocks : (int64_t(1) << 30));
}

template <int R>
__global__ void __launch_bounds__(kThreads) reduced_opening_kernel(const __grid_constant__ OpeningArgs a,
                                                                   int64_t items) {
  for (int64_t g = int64_t(blockIdx.x) * kThreads + threadIdx.x; g < items; g += int64_t(gridDim.x) * kThreads)
    opening_item<R>(a, g);
}

template <int NP>
__global__ void __launch_bounds__(kThreads) eval_points_kernel(const __grid_constant__ PointsArgs a) {
  __shared__ uint32_t pows[2 * kThreads * 4];
  __shared__ uint32_t red[2 * kThreads * 4];
  const int t = threadIdx.x;
  const int64_t rl = kThreads / a.cw, tx = t % a.cw, ty = t / a.cw;
  for (int64_t blk = blockIdx.x; blk < a.nrb * a.nct; blk += gridDim.x) {
    const int64_t rb = blk / a.nct, ct = blk % a.nct;
    const int64_t begin = rb * a.rb_rows, end = begin + a.rb_rows < a.h ? begin + a.rb_rows : a.h;
    Ext zp[NP], acc[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      zp[p] = point_power(a, p, begin + t);
      acc[p] = ts::ext_zero();
    }
    for (int64_t chunk = begin; chunk < end; chunk += kThreads) {
      __syncthreads();
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        ts::ext_store(pows + (p * kThreads + t) * 4, zp[p]);
        zp[p] = ts::ext_mul(zp[p], a.zstep[p]);
      }
      __syncthreads();
      points_chunk<NP>(a, pows, chunk, end, ct, t, acc);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) ts::ext_store(red + (p * kThreads + t) * 4, acc[p]);
    __syncthreads();
    for (int64_t s = rl / 2; s > 0; s >>= 1) {
      if (ty < s) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          uint32_t* mine = red + (p * kThreads + t) * 4;
          ts::ext_store(mine, ts::ext_add(ts::ext_load(mine), ts::ext_load(mine + s * a.cw * 4)));
        }
      }
      __syncthreads();
    }
    const int64_t col = ct * a.cw + tx;
    if (ty == 0 && col < a.w) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
        ts::ext_store(a.partial + ((rb * NP + p) * a.w + col) * 4, ts::ext_load(red + (p * kThreads + t) * 4));
    }
  }
}

__global__ void __launch_bounds__(kThreads) eval_points_sum_kernel(const __grid_constant__ PointsArgs a,
                                                                   int64_t items) {
  const int lane = threadIdx.x & 31;
  for (int64_t g = (int64_t(blockIdx.x) * kThreads + threadIdx.x) >> 5; g < items;
       g += (int64_t(gridDim.x) * kThreads) >> 5) {
    uint32_t s = points_sum_lane(a, g, lane);
    for (int d = 16; d > 0; d >>= 1) s = ts::add_mod(s, __shfl_down_sync(0xffffffffu, s, d));
    if (lane == 0) points_store(a, g, s);
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads) fri_fold_kernel(const __grid_constant__ FoldArgs a, int64_t items) {
  for (int64_t g = int64_t(blockIdx.x) * kThreads + threadIdx.x; g < items; g += int64_t(gridDim.x) * kThreads)
    fold_item<R>(a, g);
}
#endif

}  // namespace

#ifdef __CUDACC__
// K9 (see the top of this file for ``words`` and ``consts``).  Returns the
// CUDA error status of the launch.
extern "C" int ts_reduced_opening(const int64_t* words, const uint32_t* consts, cudaStream_t stream) {
  const OpeningArgs a = unpack_opening(words, consts);
  if (a.rows <= 0) return 0;
  if (a.nops > kMaxOps || (a.log_r != 0 && a.log_r != 3)) return (int)cudaErrorInvalidValue;
  const int64_t items = opening_items(a);
  if (a.log_r == 3)
    reduced_opening_kernel<8><<<grid_of(items), kThreads, 0, stream>>>(a, items);
  else
    reduced_opening_kernel<1><<<grid_of(items), kThreads, 0, stream>>>(a, items);
  return (int)cudaGetLastError();
}

// K10: the block pass, then the sum over the row blocks.
extern "C" int ts_eval_at_points(const int64_t* words, const uint32_t* consts, cudaStream_t stream) {
  const PointsArgs a = unpack_points(words, consts);
  if (a.h <= 0 || a.w <= 0) return 0;
  if (a.npts < 1 || a.npts > 2 || a.cw < 1 || a.cw > 32 || (a.cw & (a.cw - 1)) || a.rb_rows % kThreads)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = a.nrb * a.nct;
  const unsigned grid = unsigned(blocks < (int64_t(1) << 30) ? blocks : (int64_t(1) << 30));
  if (a.npts == 2)
    eval_points_kernel<2><<<grid, kThreads, 0, stream>>>(a);
  else
    eval_points_kernel<1><<<grid, kThreads, 0, stream>>>(a);
  const int status = (int)cudaGetLastError();
  if (status) return status;
  const int64_t items = a.npts * a.w * 4;
  eval_points_sum_kernel<<<grid_of(32 * items), kThreads, 0, stream>>>(a, items);
  return (int)cudaGetLastError();
}

// K11.
extern "C" int ts_fri_fold(const int64_t* words, const uint32_t* consts, cudaStream_t stream) {
  const FoldArgs a = unpack_fold(words, consts);
  if (a.half <= 0) return 0;
  if (a.log_r != 0 && a.log_r != 3) return (int)cudaErrorInvalidValue;
  const int64_t items = fold_items(a);
  if (a.log_r == 3)
    fri_fold_kernel<8><<<grid_of(items), kThreads, 0, stream>>>(a, items);
  else
    fri_fold_kernel<1><<<grid_of(items), kThreads, 0, stream>>>(a, items);
  return (int)cudaGetLastError();
}
#endif
