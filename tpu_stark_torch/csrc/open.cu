// The open phase's PCS arithmetic (commit/open_kernel.py), on the
// BabyBear^4 device functions of ext4.cuh.  Three kernels:
//
// K9 reduced_opening: for each row i of a height-2^log_h codeword held from
// global row row0, acc[i] += sum_p (C_p[i] - s_p) / (y_i - z_p) over one or
// two points p, y_i = g_H^bitrev(row0 + i); with no point it adds the
// column sums alone.  C_p[i] = sum_c alpha_p,c m[i, c] over a group's
// matrices, operands (pointer, width, row stride) whose alpha powers follow
// one another: a table a point, or one table for every point (a scaled
// point's scale is folded into its q_z and s on the host: a lone matrix at
// z and g z, alpha^w).  A codeword may be read in
// natural row order (row bitrev(row0 + i) of the full-height matrix); an
// (rows, 4) ext sum may join the columns.  Replaces
// tpu_stark/commit/pcs.py:1005 _reduced_quotient with :976
// _combine_columns (streamed: tpu_stark/prover/wide.py:341).
//   Bound: bytes for wide groups (each element read once for all the
// points), operations for narrow dividing groups.  Design:
// - A block of 256 threads walks tiles of TR = 256 R rows (a persistent
//   grid).  The tile's rows of each column slab (a unit: at most the staged
//   width of one operand) go to shared memory by cp.async, 16 bytes a copy
//   where the operand's rows allow it, into a double buffer: the next unit
//   is in flight while the threads sum this one.  Neighbouring threads copy
//   neighbouring words of a row, so a natural-order tile (bit-reversed
//   rows) is read a row at a time, not a word a row.
// - The group's alpha powers (one plane a sum) sit in shared memory, quad-
//   padded by unit, once a block; a thread sums its R rows of a unit, a
//   staged quad at a time (a stride of 4 odd words: LDS.128 without bank
//   conflicts), into 64-bit sums of raw products settled every four terms
//   (ext4.cuh's fold), then one Montgomery reduction a row and unit.
// - The division in the base field: 1/(y - z) = q_z(y) / chi_z(y), chi_z
//   the monic quartic with base coefficients whose roots are z's
//   conjugates (chi_z(y) is the norm of y - z) and q_z = chi_z / (Y - z), a
//   cubic over the extension (monic, or times a point's scale); both come
//   from the host.  A thread
//   batch-inverts the chi_z(y) of its R rows and P points (Montgomery's
//   trick in the base field; a zero, y = z, is skipped and gives 0, as the
//   plain inverse of 0), one base inverse a run.  y = A[x mod 256] H[x /
//   256], x = row0 + i: A a 256-entry table of the block, H the tile's R +
//   1 values, made as g_H^bitrev by products over x's bits.
// The per-row and per-unit functions are plain device functions; the
// staging copies and barriers alone sit under __CUDACC__ (the CPU tests
// loop the functions over the threads under a g++ shim).
//
// K10 eval_at_points: sum_r c[r, col] z^(r0 + r) for one or two points, in
// one read of the (h, w) coefficients.  Replaces tpu_stark/commit/pcs.py:227
// _eval_at_point (streamed: tpu_stark/prover/wide.py:329).  Bound: bytes.
// A warp takes a range of 32 K rows and CB columns (1, 2 or 4, loaded as
// one 8- or 16-byte word a row where aligned); lane l sums the rows base +
// l + 32 k, coalesced, against Z^k, Z = z^32, from a table the block builds
// once: every lane reads the same k, a broadcast, and no barrier follows
// it.  The sums are raw 64-bit products settled every four terms; at the
// end one ext product a lane and column by z^(r0 + base + l), a warp's
// shuffles, and a second kernel sums the ranges (a warp an output word).
//
// K11 fri_fold: one arity-2 FRI fold in the bit-reversed plain frame,
// out[j] = (e + o)/2 + beta (e - o)/(2 y_j), e = cw[2 j], o = cw[2 j + 1],
// y_j = g_lh^bitrev_{lh-1}(j0 + j), plus the next height's reduced opening
// when given.  Replaces tpu_stark/commit/pcs.py:1042 _fold_codeword
// (:1094 _fold_eo_jit, :1055 _fold_inv2y_build).  1/(2 y) is one power a
// thread times a table of 8, from g_lh^-1.  Bound: bytes (32 read and 16,
// or 32 with the add, moved an output).
//
// Every value is a Montgomery form; every sum is exact mod p in any order.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "ext4.cuh"

namespace {

using ts::Ext;

constexpr int kThreads = 256;
constexpr int kMaxOps = 32;    // operands of one K9 launch
constexpr int kMaxUnits = 64;  // column slabs of one K9 launch
constexpr int kTab = 8;        // the most rows a K11 thread takes

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
struct Unit {
  int32_t op, c0, ncol, col, slot;  // operand, its first column, columns, that column in the group, first alpha slot
};

// A point's constants, Monty forms unless said: chi_z's c0 (times 2^32
// once more: it joins raw products) and c1..c3; q_z's q0 (times 2^32 once
// more), q1, q2, q3; the opened sum s.
struct PointConsts {
  uint32_t chi[4];
  Ext q0r, q1, q2, q3, s;
};

struct OpeningArgs {
  int64_t rows, row0;
  int log_h, natural, npts, nsum, log_r, swp, nops, nunits, slots;
  const uint32_t* apows;  // plane k at apows + k ap_stride: (group width, 4), 16-byte aligned
  int64_t ap_stride;
  const uint32_t* ext_in;  // plane k at ext_in + k ext_stride: (rows, 4), or null
  int64_t ext_stride;
  uint32_t* acc;  // (rows, 4); with no point, plane k at acc + k acc_stride
  int64_t acc_stride;
  const uint32_t* ptr[kMaxOps];
  int64_t ld[kMaxOps];
  int vec[kMaxOps];  // the operand's rows take 16-byte copies
  Unit unit[kMaxUnits];
  uint32_t gpow[32];  // g_H^(2^j)
  PointConsts pt[2];
};

constexpr int kPointWords = 24;  // a PointConsts in the consts array

// words: rows, row0, log_h, natural, npts, nsum, log_r, swp, nops, nunits,
// slots, apows, ap_stride, ext_in, ext_stride, acc, acc_stride, then
// (pointer, row stride, 16-byte copies) an operand and (op, c0, ncol, col,
// slot) a unit; consts: gpow[32], then a point's chi[4], q0r[4], q1[4],
// q2[4], q3[4], s[4]
inline OpeningArgs unpack_opening(const int64_t* w, const uint32_t* k) {
  OpeningArgs a;
  std::memset(&a, 0, sizeof a);
  a.rows = w[0];
  a.row0 = w[1];
  a.log_h = int(w[2]);
  a.natural = int(w[3]);
  a.npts = int(w[4]);
  a.nsum = int(w[5]);
  a.log_r = int(w[6]);
  a.swp = int(w[7]);
  a.nops = int(w[8]);
  a.nunits = int(w[9]);
  a.slots = int(w[10]);
  a.apows = reinterpret_cast<const uint32_t*>(w[11]);
  a.ap_stride = w[12];
  a.ext_in = reinterpret_cast<const uint32_t*>(w[13]);
  a.ext_stride = w[14];
  a.acc = reinterpret_cast<uint32_t*>(w[15]);
  a.acc_stride = w[16];
  const int64_t* o = w + 17;
  for (int i = 0; i < a.nops && i < kMaxOps; ++i, o += 3) {
    a.ptr[i] = reinterpret_cast<const uint32_t*>(o[0]);
    a.ld[i] = o[1];
    a.vec[i] = int(o[2]);
  }
  o = w + 17 + 3 * int64_t(a.nops);
  for (int u = 0; u < a.nunits && u < kMaxUnits; ++u, o += 5)
    a.unit[u] = Unit{int32_t(o[0]), int32_t(o[1]), int32_t(o[2]), int32_t(o[3]), int32_t(o[4])};
  for (int j = 0; j < 32; ++j) a.gpow[j] = k[j];
  for (int p = 0; p < 2; ++p) {
    const uint32_t* c = k + 32 + kPointWords * p;
    PointConsts& pc = a.pt[p];
    for (int i = 0; i < 4; ++i) {
      pc.chi[i] = c[i];
      pc.q0r.c[i] = c[4 + i];
      pc.q1.c[i] = c[8 + i];
      pc.q2.c[i] = c[12 + i];
      pc.q3.c[i] = c[16 + i];
      pc.s.c[i] = c[20 + i];
    }
  }
  return a;
}

// The shared memory of a K9 block, in words: the alpha planes (nsum x slots
// quads), the table A (256), two tiles' H values (16 each), two staging
// buffers of TR rows at a stride of swp words.
__host__ __device__ __forceinline__ int64_t k9_tile_rows(const OpeningArgs& a) { return int64_t(256) << a.log_r; }
__host__ __device__ __forceinline__ int64_t k9_off_a(const OpeningArgs& a) { return int64_t(4) * a.nsum * a.slots; }
__host__ __device__ __forceinline__ int64_t k9_off_h(const OpeningArgs& a) { return k9_off_a(a) + 256; }
__host__ __device__ __forceinline__ int64_t k9_off_stage(const OpeningArgs& a) { return k9_off_h(a) + 32; }
__host__ __device__ __forceinline__ int64_t k9_smem_words(const OpeningArgs& a) {
  return k9_off_stage(a) + 2 * k9_tile_rows(a) * a.swp;
}

__host__ __device__ __forceinline__ int64_t k9_tiles(const OpeningArgs& a) {
  return (a.rows + k9_tile_rows(a) - 1) / k9_tile_rows(a);
}

// block b of nb: its tiles b, b + nb, ..., each a unit at a time
__host__ __device__ __forceinline__ int64_t k9_items(const OpeningArgs& a, int64_t b, int64_t nb) {
  const int64_t tiles = k9_tiles(a);
  return b < tiles ? ((tiles - 1 - b) / nb + 1) * a.nunits : 0;
}

// the item after (seq, u): the next unit, or the block's next tile's first
__host__ __device__ __forceinline__ void k9_next(const OpeningArgs& a, int64_t& seq, int& u) {
  if (++u == a.nunits) {
    u = 0;
    ++seq;
  }
}

// g_H^bitrev(x) (the low log_h bits of x) as a product over x's bits
__device__ __forceinline__ uint32_t pow_bitrev(const OpeningArgs& a, uint64_t x) {
  uint32_t r = ts::MONTY_ONE;
  for (int b = 0; b < a.log_h; ++b)
    if ((x >> b) & 1) r = ts::monty_mul(r, a.gpow[a.log_h - 1 - b]);
  return r;
}

// A block's constants: the alpha planes, quad-padded by unit (a pad slot 0),
// and A[t] = g_H^bitrev(t), t < 256.  Thread tid of kThreads.
__device__ __forceinline__ void k9_prologue(const OpeningArgs& a, uint32_t* sm, int tid) {
  uint4* ap = reinterpret_cast<uint4*>(sm);
  for (int u = 0; u < a.nunits; ++u) {
    const Unit un = a.unit[u];
    const int padded = (un.ncol + 3) & ~3;
    for (int j = tid; j < padded; j += kThreads)
      for (int k = 0; k < a.nsum; ++k)
        ap[k * a.slots + un.slot + j] =
            j < un.ncol ? *reinterpret_cast<const uint4*>(a.apows + k * a.ap_stride + 4 * int64_t(un.col + j))
                        : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int t = tid; t < 256; t += kThreads) sm[k9_off_a(a) + t] = pow_bitrev(a, uint32_t(t));
}

#ifdef __CUDACC__
__device__ __forceinline__ void copy16(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(uint32_t(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(uint32_t(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
#else
inline void copy16(uint32_t* dst, const uint32_t* src) { std::memcpy(dst, src, 16); }
inline void copy4(uint32_t* dst, const uint32_t* src) { *dst = *src; }
#endif

// Stage unit u of the block's seq-th tile into buffer buf; with a tile's
// first unit, threads 0..R also write its H values, g_H^bitrev(256 (x0 /
// 256 + t)), x0 = row0 + its first row.
__device__ __forceinline__ void k9_stage(const OpeningArgs& a, uint32_t* sm, int64_t b, int64_t nb, int64_t seq,
                                         int u, int buf, int tid) {
  const int64_t tr = k9_tile_rows(a);
  const int64_t t0 = (b + seq * nb) * tr;
  const int64_t rows = a.rows - t0 < tr ? a.rows - t0 : tr;
  if (u == 0 && a.npts && tid <= (1 << a.log_r))
    sm[k9_off_h(a) + 16 * (seq & 1) + tid] = pow_bitrev(a, (uint64_t((a.row0 + t0) >> 8) + tid) << 8);
  const Unit un = a.unit[u];
  if (un.ncol == 0) return;
  uint32_t* dst = sm + k9_off_stage(a) + buf * tr * a.swp;
  const uint32_t* src = a.ptr[un.op] + un.c0;
  const int64_t ld = a.ld[un.op];
  const int vec = a.vec[un.op];
  const int n = vec ? un.ncol >> 2 : un.ncol;  // copies a row
  // item it = tid + kThreads k is copy cc of row rr: stepped without a division
  int64_t rr = tid / n;
  int cc = tid % n;
  const int64_t dr = kThreads / n;
  const int dc = kThreads % n;
  if (dc == 0 && !a.natural) {  // a thread's copies: one column, every dr-th row
    const int64_t step = dr * ld;
    const uint32_t* from = src + (t0 + rr) * ld + (vec ? 4 * cc : cc);
    uint32_t* to = dst + rr * a.swp + (vec ? 4 * cc : cc);
    for (; rr < rows; rr += dr, from += step, to += dr * a.swp) {
      if (vec)
        copy16(to, from);
      else
        copy4(to, from);
    }
    return;
  }
  for (; rr < rows; rr += dr) {
    const int64_t i = t0 + rr;
    const int64_t row = a.natural ? int64_t(ts::bitrev(uint32_t(a.row0 + i), a.log_h)) : i;
    if (vec)
      copy16(dst + rr * a.swp + 4 * cc, src + row * ld + 4 * cc);
    else
      copy4(dst + rr * a.swp + cc, src + row * ld + cc);
    cc += dc;
    if (cc >= n) {
      cc -= n;
      ++rr;
    }
  }
}

// A thread's running column sums: R rows, NS planes.
template <int R, int NS>
struct K9Sums {
  Ext c[R][NS];
};

// chi_z(y) = y^4 + c3 y^3 + c2 y^2 + c1 y + c0: raw products, one reduction
__device__ __forceinline__ uint32_t chi_at(const PointConsts& pc, uint32_t y, uint32_t y2, uint32_t y3) {
  const uint64_t v = uint64_t(y2) * y2 + uint64_t(pc.chi[3]) * y3 + uint64_t(pc.chi[2]) * y2 +
                     uint64_t(pc.chi[1]) * y + pc.chi[0];
  return ts::monty_reduce(ts::settle1(v));
}

// q(y) = q3 y^3 + q2 y^2 + q1 y + q0: raw products (three below 2^63.5),
// settled, a reduction a coefficient
__device__ __forceinline__ Ext q_at(const PointConsts& pc, uint32_t y, uint32_t y2, uint32_t y3) {
  Ext v;
  for (int c = 0; c < 4; ++c)
    v.c[c] = ts::monty_reduce(ts::settle1(uint64_t(pc.q3.c[c]) * y3 + uint64_t(pc.q2.c[c]) * y2 +
                                          uint64_t(pc.q1.c[c]) * y + pc.q0r.c[c]));
  return v;
}

// The end of a tile (first row t0, the block's seq-th): the ext sum joins,
// then with no point each plane's sums add into its accumulator plane, else
// each row adds sum_p (C_p - s_p) q_p(y) / chi_p(y), the chi_p(y) of the
// thread's rows and points inverted together; the two points' products
// are summed raw.  The sums are reset.
template <int R, int NS, int NP>
__device__ __forceinline__ void k9_finish(const OpeningArgs& a, const uint32_t* sm, int64_t seq, int64_t t0, int tid,
                                          K9Sums<R, NS>& st) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = t0 + tid + 256 * r;
    if (i < a.rows && a.ext_in)
#pragma unroll
      for (int k = 0; k < NS; ++k) st.c[r][k] = ts::ext_add(st.c[r][k], ldg_ext(a.ext_in + k * a.ext_stride + 4 * i));
  }
  if (NP == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t i = t0 + tid + 256 * r;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        if (i < a.rows) {
          uint32_t* o = a.acc + k * a.acc_stride + 4 * i;
          st_ext(o, ts::ext_add(ld_ext(o), st.c[r][k]));
        }
        st.c[r][k] = ts::ext_zero();
      }
    }
    return;
  }
  const uint32_t* A = sm + k9_off_a(a);
  const uint32_t* H = sm + k9_off_h(a) + 16 * (seq & 1);
  const int64_t h0 = (a.row0 + t0) >> 8;
  uint32_t y[R], chi[R][NP > 0 ? NP : 1], pre[R][NP > 0 ? NP : 1];
  uint32_t run = ts::MONTY_ONE;
  unsigned skip = 0;  // (row, point) entries with no inverse: chi = 0 or a row past the end
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t i = t0 + tid + 256 * r;
    const int64_t x = a.row0 + i;
    y[r] = i < a.rows ? ts::monty_mul(A[x & 255], H[(x >> 8) - h0]) : 0u;
    const uint32_t y2 = ts::monty_mul(y[r], y[r]), y3 = ts::monty_mul(y2, y[r]);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      chi[r][p] = i < a.rows ? chi_at(a.pt[p], y[r], y2, y3) : 0u;
      if (chi[r][p] == 0)
        skip |= 1u << (NP * r + p);
      else
        run = ts::monty_mul(run, chi[r][p]);
      pre[r][p] = run;
    }
  }
  uint32_t inv = ts::base_inv(run);
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int64_t i = t0 + tid + 256 * r;
    const uint32_t y2 = ts::monty_mul(y[r], y[r]), y3 = ts::monty_mul(y2, y[r]);
    uint64_t tot[4] = {0, 0, 0, 0};
#pragma unroll
    for (int p = NP - 1; p >= 0; --p) {
      const int e = NP * r + p;
      if ((skip >> e) & 1u) continue;
      const uint32_t before = e == 0 ? ts::MONTY_ONE : (p ? pre[r][p - 1] : pre[r > 0 ? r - 1 : 0][NP - 1]);
      const uint32_t inv_e = ts::monty_mul(inv, before);
      inv = ts::monty_mul(inv, chi[r][p]);
      const PointConsts& pc = a.pt[p];
      const Ext u = ts::ext_mul_base(q_at(pc, y[r], y2, y3), inv_e);
      uint32_t wu[3];
      ts::times_w(u, wu);
      ts::settle(tot);
      ts::ext_mul_acc(tot, ts::ext_sub(st.c[r][NS > 1 ? p : 0], pc.s), u, wu);
    }
    if (i < a.rows) st_ext(a.acc + 4 * i, ts::ext_add(ld_ext(a.acc + 4 * i), ts::finish(tot)));
#pragma unroll
    for (int k = 0; k < NS; ++k) st.c[r][k] = ts::ext_zero();
  }
}

// Sum unit u (staged in buffer buf) of the block's seq-th tile into the
// thread's rows (tid + 256 r of the tile), and end the tile after its last
// unit.
template <int R, int NS, int NP>
__device__ __forceinline__ void k9_compute(const OpeningArgs& a, const uint32_t* sm, int64_t b, int64_t nb,
                                           int64_t seq, int u, int buf, int tid, K9Sums<R, NS>& st) {
  const int64_t tr = k9_tile_rows(a);
  const int64_t t0 = (b + seq * nb) * tr;
  const Unit un = a.unit[u];
  if (un.ncol) {
    const uint32_t* stage = sm + k9_off_stage(a) + buf * tr * a.swp;
    const uint4* ap = reinterpret_cast<const uint4*>(sm) + un.slot;
    const int nq = (un.ncol + 3) >> 2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t rr = tid + 256 * r;
      if (t0 + rr >= a.rows) break;
      const uint4* row = reinterpret_cast<const uint4*>(stage + rr * a.swp);
      uint64_t acc[NS][4];
#pragma unroll
      for (int k = 0; k < NS; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0;
      for (int qq = 0; qq < nq; ++qq) {
        const uint4 v = row[qq];
        const uint32_t e[4] = {v.x, v.y, v.z, v.w};
        const int live = un.ncol - 4 * qq;  // a short last quad: its pad slots are skipped
#pragma unroll
        for (int k = 0; k < NS; ++k) {
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            if (d == 0 || live >= 4 || d < live) {
              const uint4 al = ap[k * a.slots + 4 * qq + d];
              ts::fold(acc[k], Ext{{al.x, al.y, al.z, al.w}}, e[d]);
            }
          }
          ts::settle(acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) st.c[r][k] = ts::ext_add(st.c[r][k], ts::finish(acc[k]));
    }
  }
  if (u == a.nunits - 1) k9_finish<R, NS, NP>(a, sm, seq, t0, tid, st);
}

// ---------------------------------------------------------------------------
// K10
// ---------------------------------------------------------------------------
constexpr int kMaxLogK = 8;  // K10's rows a lane a range: 2^3 to 2^8

struct PointsArgs {
  const uint32_t* c;  // (h, w), row stride ld
  int64_t h, w, ld;
  int npts, cb, log_k, vec;  // columns a lane, log2 of its rows a range, one 8- or 16-byte load a row
  int64_t ncg, nrange;       // column groups, ranges of 32 K rows
  uint32_t* partial;         // (npts w 4, nrange)
  uint32_t* out;             // (npts, w, 4), point stride out_ld
  int64_t out_ld;
  int accumulate;
  Ext zr0[2];       // z^r0
  Ext zpow2[2][32];  // z^(2^j)
};

// words: c, h, w, ld, npts, cb, log_k, vec, ncg, nrange, partial, out,
// out_ld, accumulate; consts: z^r0 and z^(2^j), j < 32, of each point
inline PointsArgs unpack_points(const int64_t* w, const uint32_t* k) {
  PointsArgs a;
  std::memset(&a, 0, sizeof a);
  a.c = reinterpret_cast<const uint32_t*>(w[0]);
  a.h = w[1];
  a.w = w[2];
  a.ld = w[3];
  a.npts = int(w[4]);
  a.cb = int(w[5]);
  a.log_k = int(w[6]);
  a.vec = int(w[7]);
  a.ncg = w[8];
  a.nrange = w[9];
  a.partial = reinterpret_cast<uint32_t*>(w[10]);
  a.out = reinterpret_cast<uint32_t*>(w[11]);
  a.out_ld = w[12];
  a.accumulate = int(w[13]);
  for (int p = 0; p < 2; ++p)
    for (int c = 0; c < 4; ++c) {
      a.zr0[p].c[c] = k[132 * p + c];
      for (int j = 0; j < 32; ++j) a.zpow2[p][j].c[c] = k[132 * p + 4 + 4 * j + c];
    }
  return a;
}

// z^e for e < 2^32 - 2^(32 - from) as a product of z^(2^(j + from)) over e's bits j
__device__ __forceinline__ Ext pow_bits(const PointsArgs& a, int p, uint64_t e, int from) {
  Ext r = ts::ext_one();
  for (int j = 0; e; ++j, e >>= 1)
    if (e & 1) r = ts::ext_mul(r, a.zpow2[p][j + from]);
  return r;
}

// A block's tables (shared words): (z^32)^k, k < 2^kMaxLogK, then z^l, l <
// 32, each point's after the other.  Thread tid of kThreads.
__device__ __forceinline__ void k10_prologue(const PointsArgs& a, uint32_t* sm, int tid) {
  for (int p = 0; p < a.npts; ++p) {
    for (int k = tid; k < (1 << a.log_k); k += kThreads)
      ts::ext_store(sm + 4 * ((p << kMaxLogK) + k), pow_bits(a, p, k, 5));
    if (tid < 32) ts::ext_store(sm + 4 * ((2 << kMaxLogK) + 32 * p + tid), pow_bits(a, p, tid, 0));
  }
}

// Lane ``lane``'s share of warp item it (range it / ncg, column group it %
// ncg): sum_k c[base + lane + 32 k, col] Z^k times z^(r0 + base + lane),
// for each point and its CB columns (0 past w).
template <int NP, int CB>
__device__ __forceinline__ void points_lane(const PointsArgs& a, const uint32_t* sm, int64_t it, int lane,
                                            Ext out[NP][CB]) {
  const int64_t range = it / a.ncg, col0 = (it - range * a.ncg) * CB;
  const int64_t base = range << (5 + a.log_k);
  const bool full = col0 + CB <= a.w;
  const uint32_t* src = a.c + col0;
  uint64_t acc[NP][CB][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < CB; ++j) acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0;
  // eight rows' loads in flight before their products (log_k >= 3); a
  // range wholly inside the height loads without a bound check
  const bool inside = base + (int64_t(32) << a.log_k) <= a.h;
  const int64_t step = 32 * a.ld;
  const uint32_t* r = src + (base + lane) * a.ld;
  int64_t row = base + lane;
  for (int k0 = 0; k0 < (1 << a.log_k); k0 += 8) {
    uint32_t v[8][CB];
#pragma unroll
    for (int g = 0; g < 8; ++g, r += step, row += 32) {
#pragma unroll
      for (int j = 0; j < CB; ++j) v[g][j] = 0;
      if (inside || row < a.h) {
        if (CB == 4 && a.vec && full) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(r));
          v[g][0] = q.x;
          v[g][CB > 1 ? 1 : 0] = q.y;
          v[g][CB > 2 ? 2 : 0] = q.z;
          v[g][CB > 3 ? 3 : 0] = q.w;
        } else if (CB == 2 && a.vec && full) {
          const uint2 q = __ldg(reinterpret_cast<const uint2*>(r));
          v[g][0] = q.x;
          v[g][CB > 1 ? 1 : 0] = q.y;
        } else {
#pragma unroll
          for (int j = 0; j < CB; ++j)
            if (col0 + j < a.w) v[g][j] = __ldg(r + j);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 8; ++g) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint4 z = reinterpret_cast<const uint4*>(sm)[(p << kMaxLogK) + k0 + g];
        const Ext zk{{z.x, z.y, z.z, z.w}};
#pragma unroll
        for (int j = 0; j < CB; ++j) ts::fold(acc[p][j], zk, v[g][j]);
      }
      if ((g & 3) == 3) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < CB; ++j) ts::settle(acc[p][j]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const Ext zl = ts::ext_load(sm + 4 * ((2 << kMaxLogK) + 32 * p + lane));
    const Ext wgt = ts::ext_mul(ts::ext_mul(a.zr0[p], pow_bits(a, p, uint64_t(range), 5 + a.log_k)), zl);
#pragma unroll
    for (int j = 0; j < CB; ++j) out[p][j] = ts::ext_mul(ts::finish(acc[p][j]), wgt);
  }
}

// the warp's sum v of item it's point p, column col0 + j, into the partials:
// (npts w 4, nrange), an output word's ranges contiguous
__device__ __forceinline__ void points_partial(const PointsArgs& a, int64_t it, int p, int j, const Ext& v) {
  const int64_t range = it / a.ncg, col = (it - range * a.ncg) * a.cb + j;
  if (col < a.w)
    for (int c = 0; c < 4; ++c) a.partial[((p * a.w + col) * 4 + c) * a.nrange + range] = v.c[c];
}

// the second pass, a warp an output word g of (npts, w, 4): lane's share
// of its sum over the ranges (lane, lane + 32, ...: coalesced, eight loads
// in flight)
__device__ __forceinline__ uint32_t points_sum_lane(const PointsArgs& a, int64_t g, int lane) {
  const uint32_t* src = a.partial + g * a.nrange;
  uint32_t s = 0;
#pragma unroll 8
  for (int64_t rb = lane; rb < a.nrange; rb += 32) s = ts::add_mod(s, src[rb]);
  return s;
}

// output word g takes the sum s of its ranges (added with accumulate)
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

template <int R, int NS, int NP>
__global__ void __launch_bounds__(kThreads, 2) reduced_opening_kernel(const __grid_constant__ OpeningArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x, nb = gridDim.x;
  const int64_t items = k9_items(a, b, nb);
  k9_prologue(a, sm, tid);
  K9Sums<R, NS> st;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < NS; ++k) st.c[r][k] = ts::ext_zero();
  int64_t s_seq = 0, c_seq = 0;  // the item to stage next, the item to sum next
  int s_u = 0, c_u = 0;
  if (items > 0) {
    k9_stage(a, sm, b, nb, s_seq, s_u, 0, tid);
    k9_next(a, s_seq, s_u);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int64_t j = 0; j < items; ++j) {
    if (j + 1 < items) {
      k9_stage(a, sm, b, nb, s_seq, s_u, int((j + 1) & 1), tid);
      k9_next(a, s_seq, s_u);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // item j staged (and, the first time, the block's constants)
    k9_compute<R, NS, NP>(a, sm, b, nb, c_seq, c_u, int(j & 1), tid, st);
    k9_next(a, c_seq, c_u);
    __syncthreads();  // buffer j mod 2 free for item j + 2
  }
}

template <int R, int NS, int NP>
int launch_opening(const OpeningArgs& a, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(reduced_opening_kernel<R, NS, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int64_t tiles = k9_tiles(a), cap = 2 * int64_t(sm_count());
  reduced_opening_kernel<R, NS, NP>
      <<<unsigned(tiles < cap ? tiles : cap), kThreads, size_t(k9_smem_words(a)) * 4, stream>>>(a);
  return (int)cudaGetLastError();
}

// K9's kernel for (R, NS, NP): the plans that open_kernel._k9_plan makes
template <int NS, int NP>
int dispatch_rows(const OpeningArgs& a, cudaStream_t stream) {
  switch (1 << a.log_r) {
    case 8:
      if (NS == 1) return launch_opening<8, 1, NP>(a, stream);
      break;
    case 4:
      return launch_opening<4, NS, NP>(a, stream);
    case 2:
      return launch_opening<2, NS, NP>(a, stream);
    case 1:
      return launch_opening<1, NS, NP>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int NP, int CB>
__global__ void __launch_bounds__(kThreads, 2) eval_points_kernel(const __grid_constant__ PointsArgs a) {
  __shared__ __align__(16) uint32_t sm[4 * ((2 << kMaxLogK) + 64)];
  k10_prologue(a, sm, threadIdx.x);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t items = a.nrange * a.ncg;
  for (int64_t it = int64_t(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5); it < items;
       it += int64_t(gridDim.x) * (kThreads / 32)) {
    Ext v[NP][CB];
    points_lane<NP, CB>(a, sm, it, lane, v);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < CB; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          for (int d = 16; d > 0; d >>= 1)
            v[p][j].c[c] = ts::add_mod(v[p][j].c[c], __shfl_xor_sync(0xffffffffu, v[p][j].c[c], d));
        if (lane == 0) points_partial(a, it, p, j, v[p][j]);
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

template <int NP, int CB>
int launch_points(const PointsArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.nrange * a.ncg + kThreads / 32 - 1) / (kThreads / 32), cap = 2 * int64_t(sm_count());
  eval_points_kernel<NP, CB><<<unsigned(blocks < cap ? blocks : cap), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int R>
__global__ void __launch_bounds__(kThreads) fri_fold_kernel(const __grid_constant__ FoldArgs a, int64_t items) {
  for (int64_t g = int64_t(blockIdx.x) * kThreads + threadIdx.x; g < items; g += int64_t(gridDim.x) * kThreads)
    fold_item<R>(a, g);
}
#endif

}  // namespace

#ifdef __CUDACC__
// K9 (see unpack_opening for ``words`` and ``consts``).  Returns the CUDA
// error status of the launch.
extern "C" int ts_reduced_opening(const int64_t* words, const uint32_t* consts, cudaStream_t stream) {
  const OpeningArgs a = unpack_opening(words, consts);
  if (a.rows <= 0) return 0;
  if (a.nops > kMaxOps || a.nunits < 1 || a.nunits > kMaxUnits || a.log_r < 0 || a.log_r > 3 || a.nsum < 1 ||
      a.nsum > 2 || (1 << a.log_r) * a.nsum > 8 || a.npts < 0 || a.npts > 2 || (a.nsum == 2 && a.npts == 1) ||
      (a.npts == 0 && a.log_r != 0) || a.swp % 4 || k9_smem_words(a) * 4 > 232448)
    return (int)cudaErrorInvalidValue;
  if (a.npts == 0) return a.nsum == 2 ? launch_opening<1, 2, 0>(a, stream) : launch_opening<1, 1, 0>(a, stream);
  if (a.nsum == 2) return dispatch_rows<2, 2>(a, stream);
  return a.npts == 2 ? dispatch_rows<1, 2>(a, stream) : dispatch_rows<1, 1>(a, stream);
}

// K10: the warp pass, then the sum over the ranges.
extern "C" int ts_eval_at_points(const int64_t* words, const uint32_t* consts, cudaStream_t stream) {
  const PointsArgs a = unpack_points(words, consts);
  if (a.h <= 0 || a.w <= 0) return 0;
  if (a.npts < 1 || a.npts > 2 || (a.cb != 1 && a.cb != 2 && a.cb != 4) || a.log_k < 3 || a.log_k > kMaxLogK ||
      a.ncg * a.cb < a.w || (a.nrange << (5 + a.log_k)) < a.h)
    return (int)cudaErrorInvalidValue;
  int status;
  if (a.npts == 2)
    status = a.cb == 4 ? launch_points<2, 4>(a, stream) : a.cb == 2 ? launch_points<2, 2>(a, stream)
                                                         : launch_points<2, 1>(a, stream);
  else
    status = a.cb == 4 ? launch_points<1, 4>(a, stream) : a.cb == 2 ? launch_points<1, 2>(a, stream)
                                                         : launch_points<1, 1>(a, stream);
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
