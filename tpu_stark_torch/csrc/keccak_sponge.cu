// K1: Keccak sponge over Merkle leaf rows, digest pairs and whole runs of
// a tree's compress layers, for Hopper.
//
// Replaces tpu_stark/hash/pallas_keccak.py::_sponge_kernel.  Computes
// PaddingFreeSponge<Keccak-f[1600], 25, 17, 4> per row: consecutive u32
// pairs form little-endian u64 items (an odd tail gets a zero high half);
// each rate-17 chunk overwrites the first items of the state, then all 24
// rounds run, including after the final partial chunk; the first 4 lanes are
// the digest, written as 8 u32 (lo, hi per word).
//
// Bound: the ALU pipe.  A round is 180 int32 instructions at least
// (theta's column sums 20 LOP3, its five rotations by one 10 SHF, D folded
// into the 50 LOP3 that apply it, rho's 24 rotations 48 SHF, chi 50 LOP3,
// iota 2), against 8 u32 of input per item pair, and LOP3 and the funnel
// shift (SHF) run on the ALU pipe only, at half an SM's issue rate.  Moving
// rotation halves to the FMA pipe (hi(y 2^s) + x 2^s by IMAD and IMAD.HI)
// measured slower on the H100 at every share tried: the two pipes do not
// issue at the sum of their rates, and IMAD.HI beside LOP3 slows LOP3.  So
// the design cuts the ALU work to the count:
//
// * one thread per row (per node of a tree), the state as 25 (lo, hi) u32
//   pairs in registers, the round loop rolled (an unrolled permutation costs
//   instruction fetch) with every rotation an immediate funnel shift;
// * theta's D is folded into the 3-input XOR that applies it (lop3), which
//   the compiler does not do for a separate D (136 LOP3 a round, not 122);
// * the absorb has no per-item selects: full chunks load unchecked, a
//   compress row is specialised (8 + 8 words), and only a row's last chunk
//   checks its length;
// * keccak_tree_kernel builds several levels of a Merkle tree in one
//   launch: a block takes a subtree of 2^sub_log digests, level 1 reads its
//   pairs from HBM, later levels from shared memory, and every level's
//   digests go to their layer in HBM (openings read every layer).
//
// The grind kernel and the carried-state absorb of the streamed commit
// (keccak_absorb_kernel) use the same permutation.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

__constant__ uint32_t kRC[24][2] = {  // (lo, hi) of iota's round constants
    {0x00000001u, 0x00000000u}, {0x00008082u, 0x00000000u}, {0x0000808Au, 0x80000000u},
    {0x80008000u, 0x80000000u}, {0x0000808Bu, 0x00000000u}, {0x80000001u, 0x00000000u},
    {0x80008081u, 0x80000000u}, {0x00008009u, 0x80000000u}, {0x0000008Au, 0x00000000u},
    {0x00000088u, 0x00000000u}, {0x80008009u, 0x00000000u}, {0x8000000Au, 0x00000000u},
    {0x8000808Bu, 0x00000000u}, {0x0000008Bu, 0x80000000u}, {0x00008089u, 0x80000000u},
    {0x00008003u, 0x80000000u}, {0x00008002u, 0x80000000u}, {0x00000080u, 0x80000000u},
    {0x0000800Au, 0x00000000u}, {0x8000000Au, 0x80000000u}, {0x80008081u, 0x80000000u},
    {0x00008080u, 0x80000000u}, {0x80000001u, 0x00000000u}, {0x80008008u, 0x80000000u},
};

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// (olo, ohi) = rotl64((hi:lo), R), R in 1..63 but 32: for R >= 32 the
// halves swap and rotate by R - 32.  A half is (x << s) | (y >> (32 - s)),
// one funnel shift.
template <int R>
__device__ __forceinline__ void rotl64(uint32_t lo, uint32_t hi, uint32_t& olo, uint32_t& ohi) {
  static_assert(R > 0 && R < 64 && R != 32, "rotation amount");
  constexpr int S = R & 31;
  const uint32_t l = R < 32 ? lo : hi;
  const uint32_t h = R < 32 ? hi : lo;
  olo = __funnelshift_l(h, l, S);
  ohi = __funnelshift_l(l, h, S);
}

// rho + pi for destination lane J: b[J] = rotl(a[SRC], R)
template <int J, int SRC, int R>
__device__ __forceinline__ void rho(const uint32_t (&lo)[25], const uint32_t (&hi)[25], uint32_t (&bl)[25],
                                    uint32_t (&bh)[25]) {
  rotl64<R>(lo[SRC], hi[SRC], bl[J], bh[J]);
}

// Keccak-f[1600] over lanes x + 5y as (lo, hi) halves
__device__ __forceinline__ void keccak_f(uint32_t (&lo)[25], uint32_t (&hi)[25]) {
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    uint32_t cl[5], ch[5], rl[5], rh[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      cl[x] = xor3(xor3(lo[x], lo[x + 5], lo[x + 10]), lo[x + 15], lo[x + 20]);
      ch[x] = xor3(xor3(hi[x], hi[x + 5], hi[x + 10]), hi[x + 15], hi[x + 20]);
    }
#pragma unroll
    for (int x = 0; x < 5; ++x) rotl64<1>(cl[(x + 1) % 5], ch[(x + 1) % 5], rl[x], rh[x]);
    // a ^= D[x] = C[x - 1] ^ rotl(C[x + 1], 1), one 3-input XOR a half
#pragma unroll
    for (int i = 0; i < 25; ++i) {
      lo[i] = xor3(lo[i], cl[(i + 4) % 5], rl[i % 5]);
      hi[i] = xor3(hi[i], ch[(i + 4) % 5], rh[i % 5]);
    }
    // rho + pi: b[y + 5((2x + 3y) % 5)] = rotl(a[x + 5y], ROT[x + 5y])
    uint32_t bl[25], bh[25];
    bl[0] = lo[0];
    bh[0] = hi[0];
    rho<1, 6, 44>(lo, hi, bl, bh);
    rho<2, 12, 43>(lo, hi, bl, bh);
    rho<3, 18, 21>(lo, hi, bl, bh);
    rho<4, 24, 14>(lo, hi, bl, bh);
    rho<5, 3, 28>(lo, hi, bl, bh);
    rho<6, 9, 20>(lo, hi, bl, bh);
    rho<7, 10, 3>(lo, hi, bl, bh);
    rho<8, 16, 45>(lo, hi, bl, bh);
    rho<9, 22, 61>(lo, hi, bl, bh);
    rho<10, 1, 1>(lo, hi, bl, bh);
    rho<11, 7, 6>(lo, hi, bl, bh);
    rho<12, 13, 25>(lo, hi, bl, bh);
    rho<13, 19, 8>(lo, hi, bl, bh);
    rho<14, 20, 18>(lo, hi, bl, bh);
    rho<15, 4, 27>(lo, hi, bl, bh);
    rho<16, 5, 36>(lo, hi, bl, bh);
    rho<17, 11, 10>(lo, hi, bl, bh);
    rho<18, 17, 15>(lo, hi, bl, bh);
    rho<19, 23, 56>(lo, hi, bl, bh);
    rho<20, 2, 62>(lo, hi, bl, bh);
    rho<21, 8, 55>(lo, hi, bl, bh);
    rho<22, 14, 39>(lo, hi, bl, bh);
    rho<23, 15, 41>(lo, hi, bl, bh);
    rho<24, 21, 2>(lo, hi, bl, bh);
    // chi, one LOP3 a half
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        lo[y + x] = bl[y + x] ^ (~bl[y + (x + 1) % 5] & bl[y + (x + 2) % 5]);
        hi[y + x] = bh[y + x] ^ (~bh[y + (x + 1) % 5] & bh[y + (x + 2) % 5]);
      }
    }
    lo[0] ^= kRC[round][0];
    hi[0] ^= kRC[round][1];
  }
}

__device__ __forceinline__ void zero_state(uint32_t (&lo)[25], uint32_t (&hi)[25]) {
#pragma unroll
  for (int i = 0; i < 25; ++i) lo[i] = hi[i] = 0;
}

// the digest (the first 4 lanes) as 8 u32 at o, 16-byte aligned
__device__ __forceinline__ void store_digest(uint32_t* o, const uint32_t (&lo)[25], const uint32_t (&hi)[25]) {
  reinterpret_cast<uint4*>(o)[0] = make_uint4(lo[0], hi[0], lo[1], hi[1]);
  reinterpret_cast<uint4*>(o)[1] = make_uint4(lo[2], hi[2], lo[3], hi[3]);
}

constexpr int kRowThreads = 128;

// PAIR: row i is the 8 words of a's row i then the 8 of b's (a compress);
// else row i is a's row of k words.  out (n, 8), 16-byte aligned.
template <bool PAIR>
__global__ void __launch_bounds__(kRowThreads)
    keccak_rows_kernel(const uint32_t* __restrict__ a, int64_t k, const uint32_t* __restrict__ b, int64_t n,
                       uint32_t* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  uint32_t lo[25], hi[25];
  zero_state(lo, hi);
  if (PAIR) {
    const uint32_t* ra = a + row * 8;
    const uint32_t* rb = b + row * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[i] = ra[2 * i];
      hi[i] = ra[2 * i + 1];
      lo[4 + i] = rb[2 * i];
      hi[4 + i] = rb[2 * i + 1];
    }
    keccak_f(lo, hi);
  } else {
    const uint32_t* r = a + row * k;
    const int64_t pairs = k / 2;
    int64_t item = 0;
    for (; item + 17 <= pairs; item += 17) {  // full chunks of whole pairs
#pragma unroll
      for (int i = 0; i < 17; ++i) {
        lo[i] = r[2 * (item + i)];
        hi[i] = r[2 * (item + i) + 1];
      }
      keccak_f(lo, hi);
    }
    const int64_t rest = (k + 1) / 2 - item;  // the last chunk's items, the odd half-item included
    if (rest > 0) {
#pragma unroll
      for (int i = 0; i < 17; ++i) {
        if (i >= rest) break;
        const int64_t j = 2 * (item + i);
        lo[i] = r[j];
        hi[i] = j + 1 < k ? r[j + 1] : 0u;
      }
      keccak_f(lo, hi);
    }
  }
  store_digest(out + row * 8, lo, hi);
}

constexpr int kAbsorbThreads = 128;

// The carried-state absorb of the streamed Keccak commit (no Pallas
// counterpart: it replaces tpu_stark/hash/sponge.py::_absorb_full_blocks,
// XLA there).  Row r's input is the p words of pend's row r (a block that
// straddled the previous chunk, p < 34) then the k words of mat's row r,
// each operand read through its row stride: no concatenated copy.  The
// state is lane-major, word 2l + h of lane l (h = 0 lo, 1 hi) of row r at
// state[(2l + h) n + r], so a warp's loads and stores of one word coalesce;
// `first` starts from the zero state without reading it.  !FIN: absorb the
// (p + k) / 34 whole rate blocks (p + k a multiple of 34) and store the
// state.  FIN: absorb them and the last partial block too, permute, and
// write the digest to out (n, 8); the state is not written.  Bound: the ALU
// pipe, as keccak_rows_kernel (one permutation per 34 words against 400 B of
// state and 136 B of input a block).
template <bool FIN>
__global__ void __launch_bounds__(kAbsorbThreads)
    keccak_absorb_kernel(uint32_t* __restrict__ state, int64_t n, const uint32_t* __restrict__ pend, int64_t p,
                         int64_t ps, const uint32_t* __restrict__ mat, int64_t k, int64_t ms, int first,
                         uint32_t* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  uint32_t lo[25], hi[25];
  if (first) {
    zero_state(lo, hi);
  } else {
#pragma unroll
    for (int l = 0; l < 25; ++l) {
      lo[l] = state[(2 * l) * n + row];
      hi[l] = state[(2 * l + 1) * n + row];
    }
  }
  const uint32_t* rp = pend + row * ps;
  const uint32_t* rm = mat + row * ms;
  const int64_t total = p + k;
  const int64_t blocks = total / 34;
  int64_t b = 0;
  if (p > 0 && blocks > 0) {  // the block that holds the pending words
#pragma unroll
    for (int i = 0; i < 34; ++i) {
      const uint32_t v = i < p ? rp[i] : rm[i - p];
      if (i % 2 == 0) lo[i / 2] = v;
      else hi[i / 2] = v;
    }
    keccak_f(lo, hi);
    b = 1;
  }
  for (; b < blocks; ++b) {  // whole blocks of mat alone
    const uint32_t* r = rm + (34 * b - p);
#pragma unroll
    for (int i = 0; i < 17; ++i) {
      lo[i] = r[2 * i];
      hi[i] = r[2 * i + 1];
    }
    keccak_f(lo, hi);
  }
  if (FIN) {
    const int64_t base = 34 * blocks;
    const int64_t rest = total - base;  // words of the last partial block
    if (rest > 0) {
#pragma unroll
      for (int i = 0; i < 17; ++i) {
        const int64_t j = base + 2 * i;
        if (j >= total) break;
        lo[i] = j < p ? rp[j] : rm[j - p];
        hi[i] = j + 1 >= total ? 0u : (j + 1 < p ? rp[j + 1] : rm[j + 1 - p]);
      }
      keccak_f(lo, hi);
    }
    store_digest(out + row * 8, lo, hi);
  } else {
#pragma unroll
    for (int l = 0; l < 25; ++l) {
      state[(2 * l) * n + row] = lo[l];
      state[(2 * l + 1) * n + row] = hi[l];
    }
  }
}

constexpr int kTreeThreads = 128;

// Levels 1..lv above the n_in digests (8 u32 each) at `in`.  Block b takes
// the subtree of input digests [b 2^sub_log, (b + 1) 2^sub_log), so it
// holds 2^(sub_log - j) nodes at level j.  Level j's layer (n_in >> j
// digests) follows level j - 1's in `out`, level 1's first; `out` is
// 16-byte aligned.  Shared memory: level j's nodes for level j + 1, word w
// of node i at buf[w cap + i] (a thread reads word w of a pair as one
// 8-byte load), odd levels in buffer A (cap 2^(sub_log - 1)), even levels
// in buffer B (cap 2^(sub_log - 2)).
__global__ void __launch_bounds__(kTreeThreads)
    keccak_tree_kernel(const uint32_t* __restrict__ in, int64_t n_in, int sub_log, int lv,
                       uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int64_t cap_a = int64_t(1) << (sub_log - 1);
  const int64_t cap_b = cap_a >> 1;
  uint32_t* layer = out;
  for (int j = 1; j <= lv; ++j) {
    const int64_t m = int64_t(1) << (sub_log - j);
    const int64_t base = (int64_t)blockIdx.x * m;
    const uint32_t* src = (j & 1) ? smem + 8 * cap_a : smem;  // level j - 1's buffer
    const int64_t src_cap = (j & 1) ? cap_b : cap_a;
    uint32_t* dst = (j & 1) ? smem : smem + 8 * cap_a;
    const int64_t dst_cap = (j & 1) ? cap_a : cap_b;
    for (int64_t i = threadIdx.x; i < m; i += blockDim.x) {
      uint32_t lo[25], hi[25];
      zero_state(lo, hi);
      if (j == 1) {
        const uint32_t* r = in + (base + i) * 16;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          lo[q] = r[2 * q];
          hi[q] = r[2 * q + 1];
        }
      } else {
#pragma unroll
        for (int w = 0; w < 8; ++w) {  // word w of the left and the right digest
          const uint2 v = *reinterpret_cast<const uint2*>(src + w * src_cap + 2 * i);
          if (w % 2 == 0) {
            lo[w / 2] = v.x;
            lo[4 + w / 2] = v.y;
          } else {
            hi[w / 2] = v.x;
            hi[4 + w / 2] = v.y;
          }
        }
      }
      keccak_f(lo, hi);
      store_digest(layer + (base + i) * 8, lo, hi);
      if (j < lv) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dst[(2 * q) * dst_cap + i] = lo[q];
          dst[(2 * q + 1) * dst_cap + i] = hi[q];
        }
      }
    }
    layer += (n_in >> j) * 8;
    __syncthreads();
  }
}

// FRI proof-of-work verdicts, one thread per candidate witness w = start +
// tid: Keccak-256 of (transcript input || w as 4 LE bytes), of which only
// the tail block(s) holding w run here (the constant prefix blocks were
// absorbed on the host into `prefix`; `tail` holds the padded tail's lanes
// with zero witness bytes).  The challenger's draws pop the digest from the
// end: draw k is digest bytes [28-4k, 32-4k) big-endian, masked to 31 bits,
// rejected if >= P.  out[tid] = 1 if the first accepted draw has its low
// `bits` bits zero, 2 if all 8 draws reject (the host decides those), else
// 0.  No Pallas counterpart: it replaces tpu_stark/challenger/grind.py's XLA
// program (_chunk_fn).  Bound by the integer pipes, like K1: n_blocks
// permutations per candidate, one byte out.
__global__ void keccak_grind_kernel(const uint64_t* __restrict__ prefix, const uint64_t* __restrict__ tail,
                                    int n_blocks, int w_off, int bits, uint64_t start, int64_t count,
                                    uint8_t* __restrict__ out) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= count) return;
  const uint32_t w = (uint32_t)(start + (uint64_t)tid);
  uint32_t lo[25], hi[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) {
    lo[i] = (uint32_t)prefix[i];
    hi[i] = (uint32_t)(prefix[i] >> 32);
  }
  for (int b = 0; b < n_blocks; ++b) {
#pragma unroll
    for (int l = 0; l < 17; ++l) {
      uint64_t add = tail[b * 17 + l];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = w_off + i;
        if (q / 136 == b && (q % 136) / 8 == l) add ^= (uint64_t)((w >> (8 * i)) & 0xFFu) << (8 * (q % 8));
      }
      lo[l] ^= (uint32_t)add;
      hi[l] ^= (uint32_t)(add >> 32);
    }
    keccak_f(lo, hi);
  }
  uint32_t chosen = 0;
  bool taken = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int lane = 3 - k / 2;
    const uint32_t half = (k % 2 == 0) ? hi[lane] : lo[lane];
    const uint32_t v = __byte_perm(half, 0, 0x0123) & 0x7FFFFFFFu;
    if (!taken && v < ts::P) {
      chosen = v;
      taken = true;
    }
  }
  out[tid] = !taken ? 2 : ((chosen & ((1u << bits) - 1u)) == 0 ? 1 : 0);
}

}  // namespace

// Grind verdicts of the witnesses start .. start+count-1 into out (count).
// Returns the CUDA error status of the launch.
extern "C" int ts_keccak_grind(const uint64_t* prefix, const uint64_t* tail, int n_blocks, int w_off, int bits,
                               uint64_t start, int64_t count, uint8_t* out, cudaStream_t stream) {
  if (count <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (count + threads - 1) / threads;
  keccak_grind_kernel<<<(unsigned)blocks, threads, 0, stream>>>(prefix, tail, n_blocks, w_off, bits, start, count,
                                                                out);
  return (int)cudaGetLastError();
}

// Hash n rows into out (n, 8): with b, a compress of a's and b's 8-word
// rows; without, a's rows of k words.  Returns the CUDA error status of the
// launch.
extern "C" int ts_keccak_rows(const uint32_t* a, int64_t k, const uint32_t* b, int64_t n, uint32_t* out,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kRowThreads - 1) / kRowThreads;
  if (b != nullptr)
    keccak_rows_kernel<true><<<(unsigned)blocks, kRowThreads, 0, stream>>>(a, 8, b, n, out);
  else
    keccak_rows_kernel<false><<<(unsigned)blocks, kRowThreads, 0, stream>>>(a, k, b, n, out);
  return (int)cudaGetLastError();
}

// Levels 1..lv above n_in digests (n_in a power of two, 2^sub_log <= n_in,
// 1 <= lv <= sub_log <= 10, keccak_kernel.MAX_SUB_LOG) into out, the layers one after another.  Returns
// the CUDA error status of the launch.
extern "C" int ts_keccak_tree(const uint32_t* in, int64_t n_in, int sub_log, int lv, uint32_t* out,
                              cudaStream_t stream) {
  if (lv < 1 || lv > sub_log || sub_log > 10 || (n_in >> sub_log) < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = n_in >> sub_log;
  const int threads = sub_log - 1 >= 7 ? kTreeThreads : 1 << (sub_log - 1);
  const size_t smem = lv > 1 ? (size_t)32 * ((size_t(1) << (sub_log - 1)) + (size_t(1) << (sub_log - 1) >> 1)) : 0;
  keccak_tree_kernel<<<(unsigned)blocks, threads, smem, stream>>>(in, n_in, sub_log, lv, out);
  return (int)cudaGetLastError();
}

// The carried-state absorb over n rows of a lane-major (50, n) state: the
// rows are pend's p words (row stride ps) then mat's k words (row stride ms).
// Without out: absorb the whole rate blocks, p + k a multiple of 34, p < 34,
// into state.  With out: absorb everything, the last partial block included,
// and write the (n, 8) digests to out, leaving state as it is.  Returns the
// CUDA error status of the launch.
extern "C" int ts_keccak_absorb(uint32_t* state, int64_t n, const uint32_t* pend, int64_t p, int64_t ps,
                                const uint32_t* mat, int64_t k, int64_t ms, int first, uint32_t* out,
                                cudaStream_t stream) {
  if (p < 0 || p >= 34 || k < 0 || (out == nullptr && (p + k) % 34 != 0)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int64_t blocks = (n + kAbsorbThreads - 1) / kAbsorbThreads;
  if (out == nullptr)
    keccak_absorb_kernel<false><<<(unsigned)blocks, kAbsorbThreads, 0, stream>>>(state, n, pend, p, ps, mat, k, ms,
                                                                                first, out);
  else
    keccak_absorb_kernel<true><<<(unsigned)blocks, kAbsorbThreads, 0, stream>>>(state, n, pend, p, ps, mat, k, ms,
                                                                               first, out);
  return (int)cudaGetLastError();
}
