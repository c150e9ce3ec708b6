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
// (keccak_absorb_kernel) use the same permutation.  The kernels, their
// copies into shared memory and their launches sit under __CUDACC__: the
// absorb's and the grind's device functions, and the checks that pack their
// entries' operands (absorb_args, grind_args), also build for the host,
// where the CPU tests loop them over rows and candidates
// (tests/keccak_host.py).

#include <cstdint>
#include <cstring>
#include <type_traits>
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
#ifdef __CUDACC__
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  return a ^ b ^ c;
#endif
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

// Round `round` of Keccak-f[1600] over lanes x + 5y as (lo, hi) halves
__device__ __forceinline__ void keccak_round(uint32_t (&lo)[25], uint32_t (&hi)[25], int round) {
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

// Keccak-f[1600] over lanes x + 5y as (lo, hi) halves
__device__ __forceinline__ void keccak_f(uint32_t (&lo)[25], uint32_t (&hi)[25]) {
#pragma unroll 1
  for (int round = 0; round < 24; ++round) keccak_round(lo, hi, round);
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

#ifdef __CUDACC__
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
#endif

// The carried-state absorb of the streamed Keccak commit (no Pallas
// counterpart: it replaces tpu_stark/hash/sponge.py::_absorb_full_blocks,
// XLA there, and the bit-reversed canonical copy of each chunk that the JAX
// package feeds it).  Row r's words are the p pending words of pend (row r,
// canonical, strided: word j at pend[r prs + j pcs]) then the k words of
// mat's row r, or with REV of mat's row bitrev(r) (a codeword chunk in
// natural order as K2 leaves it: tree row r is its row bitrev(r)), each
// turned from its Montgomery form into the canonical u32 with MONTY.  The
// state is lane-major, word 2l + h of lane l (h = 0 lo, 1 hi) of row r at
// state[(2l + h) n + r], so a warp's loads and stores of one word coalesce;
// `first` starts from the zero state without reading it.  !FIN: absorb the
// (p + k) / 34 whole rate blocks, store the state, and write the words
// after them (fewer than 34) to out, word-major (word j of row r at
// out[j n + r]): the next launch's pending words.  FIN: absorb everything,
// the last partial block too, and write the digest to out (n, 8); the state
// is not written.
//
// Bound: the ALU pipe, as keccak_rows_kernel: one permutation per 34 words
// against 400 B of state and 136 B of input a block.  So the design keeps
// the inputs' work off that pipe and out of the permutations' way.  A
// thread stages each rate block of its row's words into its own row of
// shared memory with cp.async, 16-byte copies of mat's contiguous row
// whatever the row order (4-byte copies where mat is not 16-byte aligned)
// and 4-byte copies of the pending words, which a warp reads coalesced
// (word-major, as the kernel writes them back).  The next block's copies
// go out once the first round of this block's permutation has read every
// lane, so they land while its other 23 rounds run; no thread waits for
// another (a row is one thread's alone: no barrier), and one row buffer a
// thread leaves room for 6 blocks an SM.  A word's Montgomery reduction is
// an IMAD and an IMAD.HI, on the FMA pipe; the thread's reads of its row
// cost a 4-way bank conflict each, against some 4,400 ALU instructions a
// block.
constexpr int kAbsorbThreads = 128;
// a staged row: a rate block's words, 16-byte aligned, at most 40; 44, not
// 40, so that a warp's reads of one word meet 8 banks (4-way), not 4
constexpr int kStageStride = 44;

struct AbsorbArgs {
  uint32_t* state;
  int64_t n;
  int log_n;
  const uint32_t* pend;
  int64_t p, prs, pcs;
  const uint32_t* mat;
  int64_t k, ms;
  int vec;  // 16-byte copies: mat, its row stride and k all multiples of 16 bytes
  int first;
  uint32_t* out;
};

// x * 2^-32 mod P of a Montgomery form x in [0, P): ts::monty_mul(x, 1) is
// P - hi32(m P), m = x P^-1 mod 2^32, for x != 0; that is hi32(m' P) for
// m' = (P - x) P^-1 = 1 - x P^-1 mod 2^32, whose form also maps 0 to 0
// (m' = 1): two instructions of the FMA pipe, the result in [0, P)
__device__ __forceinline__ uint32_t from_monty(uint32_t x) { return __umulhi(1u - x * ts::MU, ts::P); }

template <bool MONTY>
__device__ __forceinline__ uint32_t mat_word(uint32_t v) {
  return MONTY ? from_monty(v) : v;
}

// Rate block b holds a row's words [34 b, 34 b + 34), pending ones first.
// Its staged row: the pending words (block 0) at [0, p), then from `moff`
// (a multiple of 4) mat's words [s0, s1), s0 16-byte aligned with vec.
struct Span {
  int64_t s0, s1;
  int moff;
};

__device__ __forceinline__ Span block_span(const AbsorbArgs& a, int64_t b) {
  int64_t s0 = 34 * b - a.p, s1 = s0 + 34;
  s0 = s0 < 0 ? 0 : s0;
  s1 = s1 > a.k ? a.k : s1;
  s1 = s1 < s0 ? s0 : s1;
  if (a.vec) {  // k is a multiple of 4
    s0 &= ~int64_t(3);
    s1 = (s1 + 3) & ~int64_t(3);
  }
  return Span{s0, s1, b == 0 ? int(a.p + 3) & ~3 : 0};
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
// the thread's copies so far as a group; wait for all its groups
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
#else
inline void copy16(uint32_t* dst, const uint32_t* src) { std::memcpy(dst, src, 16); }
inline void copy4(uint32_t* dst, const uint32_t* src) { *dst = *src; }
inline void commit_copies() {}
inline void wait_copies() {}
#endif

// row r's rate block b into its staged row; mat's row `src` holds its words
__device__ __forceinline__ void absorb_stage(const AbsorbArgs& a, uint32_t* row, int64_t r, int64_t src, int64_t b) {
  const Span sp = block_span(a, b);
  if (b == 0)
    for (int64_t j = 0; j < a.p; ++j) copy4(row + j, a.pend + r * a.prs + j * a.pcs);
  const uint32_t* from = a.mat + src * a.ms;
  uint32_t* to = row + sp.moff;
  if (a.vec)
    for (int64_t m = sp.s0; m < sp.s1; m += 4) copy16(to + (m - sp.s0), from + m);
  else
    for (int64_t m = sp.s0; m < sp.s1; ++m) copy4(to + (m - sp.s0), from + m);
}

// word q of rate block b's staged row (q < p + k): pending, or mat's
template <bool MONTY>
__device__ __forceinline__ uint32_t row_word(const AbsorbArgs& a, const uint32_t* row, const Span& sp, int64_t q) {
  return q < a.p ? row[q] : mat_word<MONTY>(row[sp.moff + (q - a.p - sp.s0)]);
}

// the items of words [q0, q1) (q1 - q0 <= 34) into the rate lanes; an odd
// last word gets a zero high half, lanes past the words keep theirs
template <bool MONTY>
__device__ __forceinline__ void load_words(const AbsorbArgs& a, const uint32_t* row, const Span& sp, int64_t q0,
                                           int64_t q1, uint32_t (&lo)[25], uint32_t (&hi)[25]) {
#pragma unroll
  for (int i = 0; i < 17; ++i) {
    const int64_t j = q0 + 2 * i;
    if (j < q1) {
      lo[i] = row_word<MONTY>(a, row, sp, j);
      hi[i] = j + 1 < q1 ? row_word<MONTY>(a, row, sp, j + 1) : 0u;
    }
  }
}

// Row r's staged rate block b: a whole block's words, or the last partial
// block's (FIN), into the rate lanes, or the words after the last whole
// block written to out (!FIN); returns whether a permutation follows
template <bool FIN, bool MONTY>
__device__ __forceinline__ bool absorb_consume(const AbsorbArgs& a, const uint32_t* row, int64_t r, int64_t b,
                                               uint32_t (&lo)[25], uint32_t (&hi)[25]) {
  const Span sp = block_span(a, b);
  const int64_t total = a.p + a.k, base = 34 * b;
  if (base + 34 <= total) {
    if (base >= a.p) {  // mat's words alone
      const uint32_t* w = row + sp.moff + (base - a.p - sp.s0);
#pragma unroll
      for (int i = 0; i < 17; ++i) {
        lo[i] = mat_word<MONTY>(w[2 * i]);
        hi[i] = mat_word<MONTY>(w[2 * i + 1]);
      }
    } else {  // the block that holds the pending words
      load_words<MONTY>(a, row, sp, base, base + 34, lo, hi);
    }
    return true;
  }
  if (FIN) {
    load_words<MONTY>(a, row, sp, base, total, lo, hi);
    return true;
  }
#pragma unroll
  for (int j = 0; j < 33; ++j)
    if (base + j < total) a.out[j * a.n + r] = row_word<MONTY>(a, row, sp, base + j);
  return false;
}

// row r's state before the launch's first block: zero (first), the carried
// state, or none when the launch permutes nothing
template <bool FIN>
__device__ __forceinline__ void absorb_begin(const AbsorbArgs& a, int64_t r, uint32_t (&lo)[25], uint32_t (&hi)[25]) {
  if (!FIN && a.p + a.k < 34) return;
  if (a.first) {
    zero_state(lo, hi);
    return;
  }
#pragma unroll
  for (int l = 0; l < 25; ++l) {
    lo[l] = a.state[(2 * l) * a.n + r];
    hi[l] = a.state[(2 * l + 1) * a.n + r];
  }
}

// row r's digest (FIN) or carried state
template <bool FIN>
__device__ __forceinline__ void absorb_end(const AbsorbArgs& a, int64_t r, const uint32_t (&lo)[25],
                                           const uint32_t (&hi)[25]) {
  if (FIN) {
    store_digest(a.out + r * 8, lo, hi);
  } else if (a.p + a.k >= 34) {
#pragma unroll
    for (int l = 0; l < 25; ++l) {
      a.state[(2 * l) * a.n + r] = lo[l];
      a.state[(2 * l + 1) * a.n + r] = hi[l];
    }
  }
}

// mat's row that holds tree row r's words
template <bool REV>
__device__ __forceinline__ int64_t source_row(const AbsorbArgs& a, int64_t r) {
  return REV ? int64_t(a.log_n == 0 ? 0u : __brev(uint32_t(r)) >> (32 - a.log_n)) : r;
}

// Row r's blocks, one after another, staged in `row` (this thread's):
// block b + 1's copies go out while block b permutes
template <bool FIN, bool REV, bool MONTY>
__device__ __forceinline__ void absorb_row(const AbsorbArgs& a, uint32_t* row, int64_t r) {
  const int64_t src = source_row<REV>(a, r);
  uint32_t lo[25], hi[25];
  absorb_begin<FIN>(a, r, lo, hi);
  const int64_t blocks = (a.p + a.k + 33) / 34;  // the last one partial
  if (blocks > 0) absorb_stage(a, row, r, src, 0);
  commit_copies();
  for (int64_t b = 0; b < blocks; ++b) {
    wait_copies();
    const bool permute = absorb_consume<FIN, MONTY>(a, row, r, b, lo, hi);
    // round 0 reads every lane, so every staged word has left the row
    // before the copies below refill it
    if (permute) keccak_round(lo, hi, 0);
    if (b + 1 < blocks) absorb_stage(a, row, r, src, b + 1);
    commit_copies();
    if (permute) {
#pragma unroll 1
      for (int round = 1; round < 24; ++round) keccak_round(lo, hi, round);
    }
  }
  absorb_end<FIN>(a, r, lo, hi);
}

// ts_keccak_absorb's operands (see there) checked and packed into a:
// cudaErrorInvalidValue where they are not valid, else 0.  A natural-order
// chunk is a codeword of Montgomery forms: rev needs monty.
inline int absorb_args(uint32_t* state, int64_t n, int log_n, const uint32_t* pend, int64_t p, int64_t prs,
                       int64_t pcs, const uint32_t* mat, int64_t k, int64_t ms, int first, int rev, int monty,
                       int fin, uint32_t* out, AbsorbArgs& a) {
  if (p < 0 || p >= 34 || k < 0 || (rev && (!monty || log_n < 0 || log_n > 31 || n != (int64_t(1) << log_n))) ||
      ((fin || (p + k) % 34) && out == nullptr) || (p > 0 && pend == nullptr) || (k > 0 && mat == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vec = reinterpret_cast<uintptr_t>(mat) % 16 == 0 && ms % 4 == 0 && k % 4 == 0;
  a = AbsorbArgs{state, n, log_n, pend, p, prs, pcs, mat, k, ms, vec, first, out};
  return 0;
}

template <bool FIN, class F>
void absorb_forms(int rev, int monty, F& f) {
  using Fin = std::integral_constant<bool, FIN>;
  if (rev)
    f(Fin{}, std::true_type{}, std::true_type{});
  else if (monty)
    f(Fin{}, std::false_type{}, std::true_type{});
  else
    f(Fin{}, std::false_type{}, std::false_type{});
}

// f(FIN, REV, MONTY), each an std::integral_constant<bool>: the flags'
// instantiation of absorb_row (absorb_args has checked them)
template <class F>
void absorb_flags(int fin, int rev, int monty, F&& f) {
  if (fin)
    absorb_forms<true>(rev, monty, f);
  else
    absorb_forms<false>(rev, monty, f);
}

#ifdef __CUDACC__
// 6 blocks an SM: at most 80 registers (the round's 50 lanes and its 50
// rho-pi outputs overlap), 22.5 KB of shared memory a block
template <bool FIN, bool REV, bool MONTY>
__global__ void __launch_bounds__(kAbsorbThreads, 6) keccak_absorb_kernel(const __grid_constant__ AbsorbArgs a) {
  __shared__ __align__(16) uint32_t sm[kAbsorbThreads * kStageStride];
  const int64_t r = (int64_t)blockIdx.x * kAbsorbThreads + threadIdx.x;
  if (r < a.n) absorb_row<FIN, REV, MONTY>(a, sm + threadIdx.x * kStageStride, r);
}
#endif

#ifdef __CUDACC__
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
#endif

// FRI proof-of-work verdicts of the candidate witnesses w = start + c, c <
// count: Keccak-256 of (transcript input || w as 4 LE bytes), of which only
// the tail block(s) holding w run here (the constant prefix blocks were
// absorbed on the host into `prefix`; `tail` holds the padded tail's lanes
// with zero witness bytes).  The challenger's draws pop the digest from the
// end: draw k is digest bytes [28-4k, 32-4k) big-endian, masked to 31 bits,
// rejected if >= P.  out[c] = 1 if the first accepted draw has its low
// `bits` bits zero, 2 if all 8 draws reject (the host decides those), else
// 0.  No Pallas counterpart: it replaces tpu_stark/challenger/grind.py's XLA
// program (_chunk_fn).
//
// Bound by the ALU pipe, like K1: n_blocks permutations per candidate, one
// byte out.  So a candidate does the least ALU work: the host works out
// where w's bytes go (at most two lanes: challenger/grind.py::witness_lanes)
// and each lane takes w shifted into place (a switch on the warp-uniform
// lane, no per-lane compare); a block stages prefix ^ tail block 0 in shared
// memory once; the last round computes only the 4 lanes the draws read (58
// of a round's 180 ALU instructions).  One thread a candidate: a grid of
// whole waves, each thread looping over candidates, measured no faster.
constexpr int kGrindThreads = 128;
// a block's constants: the (lo, hi) words of tail block 0's 25 lanes, then
// of block 1's 17
constexpr int kGrindConsts = 2 * (25 + 17);

struct GrindArgs {
  const uint64_t* prefix;
  const uint64_t* tail;
  int n_blocks;          // 1 or 2
  int wb[2], wl[2], ws[2];  // w's parts: block, lane (-1: none), shift (< 0: right by -shift)
  int bits;
  uint64_t start;
  int64_t count;
  uint8_t* out;
};

// lane ^= v; `lane` is the same for every candidate of a launch
__device__ __forceinline__ void xor_lane(uint32_t (&lo)[25], uint32_t (&hi)[25], int lane, uint64_t v) {
  switch (lane) {
#define TS_XOR_LANE(L)         \
  case L:                      \
    lo[L] ^= uint32_t(v);      \
    hi[L] ^= uint32_t(v >> 32); \
    break;
    TS_XOR_LANE(0) TS_XOR_LANE(1) TS_XOR_LANE(2) TS_XOR_LANE(3) TS_XOR_LANE(4) TS_XOR_LANE(5) TS_XOR_LANE(6)
    TS_XOR_LANE(7) TS_XOR_LANE(8) TS_XOR_LANE(9) TS_XOR_LANE(10) TS_XOR_LANE(11) TS_XOR_LANE(12)
    TS_XOR_LANE(13) TS_XOR_LANE(14) TS_XOR_LANE(15) TS_XOR_LANE(16)
#undef TS_XOR_LANE
    default:
      break;
  }
}

// w's parts that lie in tail block b, xored into their lanes
__device__ __forceinline__ void xor_witness(const GrindArgs& a, int b, uint32_t w, uint32_t (&lo)[25],
                                           uint32_t (&hi)[25]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (a.wl[i] >= 0 && a.wb[i] == b)
      xor_lane(lo, hi, a.wl[i], a.ws[i] >= 0 ? uint64_t(w) << a.ws[i] : uint64_t(w) >> -a.ws[i]);
  }
}

// Keccak-f[1600] with a last round that computes lanes 0-3 only: theta's
// column sums and D whole, rho and pi for plane 0's five sources (lanes 0,
// 6, 12, 18, 24), chi for its first four lanes, iota
__device__ __forceinline__ void keccak_f_digest(uint32_t (&lo)[25], uint32_t (&hi)[25]) {
#pragma unroll 1
  for (int round = 0; round < 23; ++round) keccak_round(lo, hi, round);
  uint32_t cl[5], ch[5], rl[5], rh[5], bl[25], bh[25];
#pragma unroll
  for (int x = 0; x < 5; ++x) {
    cl[x] = xor3(xor3(lo[x], lo[x + 5], lo[x + 10]), lo[x + 15], lo[x + 20]);
    ch[x] = xor3(xor3(hi[x], hi[x + 5], hi[x + 10]), hi[x + 15], hi[x + 20]);
  }
#pragma unroll
  for (int x = 0; x < 5; ++x) rotl64<1>(cl[(x + 1) % 5], ch[(x + 1) % 5], rl[x], rh[x]);
#pragma unroll
  for (int x = 0; x < 5; ++x) {  // plane 0's source lanes 6x (x + 5x), theta applied
    lo[6 * x] = xor3(lo[6 * x], cl[(x + 4) % 5], rl[x]);
    hi[6 * x] = xor3(hi[6 * x], ch[(x + 4) % 5], rh[x]);
  }
  bl[0] = lo[0];
  bh[0] = hi[0];
  rho<1, 6, 44>(lo, hi, bl, bh);
  rho<2, 12, 43>(lo, hi, bl, bh);
  rho<3, 18, 21>(lo, hi, bl, bh);
  rho<4, 24, 14>(lo, hi, bl, bh);
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    lo[x] = bl[x] ^ (~bl[(x + 1) % 5] & bl[(x + 2) % 5]);
    hi[x] = bh[x] ^ (~bh[(x + 1) % 5] & bh[(x + 2) % 5]);
  }
  lo[0] ^= kRC[23][0];
  hi[0] ^= kRC[23][1];
}

// A block's constants in shared memory: the state after tail block 0's
// constant lanes (prefix ^ tail[0], as (lo, hi)), then block 1's lanes
__device__ __forceinline__ void grind_prologue(const GrindArgs& a, uint32_t* sm, int tid) {
  if (tid < 25) {
    const uint64_t v = a.prefix[tid] ^ (tid < 17 ? a.tail[tid] : 0u);
    sm[2 * tid] = uint32_t(v);
    sm[2 * tid + 1] = uint32_t(v >> 32);
  } else if (tid < 42 && a.n_blocks > 1) {
    const uint64_t v = a.tail[17 + tid - 25];
    sm[50 + 2 * (tid - 25)] = uint32_t(v);
    sm[50 + 2 * (tid - 25) + 1] = uint32_t(v >> 32);
  }
}

// ts_keccak_grind's operands (see there) checked and packed into a:
// cudaErrorInvalidValue where they are not valid, else 0
inline int grind_args(const uint64_t* prefix, const uint64_t* tail, int n_blocks, int wb0, int wl0, int ws0, int wb1,
                      int wl1, int ws1, int bits, uint64_t start, int64_t count, uint8_t* out, GrindArgs& a) {
  if (n_blocks < 1 || n_blocks > 2 || bits < 1 || bits > 31 || wl0 < 0) return (int)cudaErrorInvalidValue;
  a = GrindArgs{prefix, tail, n_blocks, {wb0, wb1}, {wl0, wl1}, {ws0, ws1}, bits, start, count, out};
  for (int i = 0; i < 2; ++i)
    if (a.wl[i] > 16 || (a.wl[i] >= 0 && (a.wb[i] < 0 || a.wb[i] >= n_blocks || a.ws[i] <= -32 || a.ws[i] > 56)))
      return (int)cudaErrorInvalidValue;
  return 0;
}

// candidate w's verdict (sm: grind_prologue's constants)
__device__ __forceinline__ uint8_t grind_verdict(const GrindArgs& a, const uint32_t* sm, uint32_t w) {
  uint32_t lo[25], hi[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) {
    lo[i] = sm[2 * i];
    hi[i] = sm[2 * i + 1];
  }
  xor_witness(a, 0, w, lo, hi);
  if (a.n_blocks > 1) {
    keccak_f(lo, hi);
#pragma unroll
    for (int i = 0; i < 17; ++i) {
      lo[i] ^= sm[50 + 2 * i];
      hi[i] ^= sm[50 + 2 * i + 1];
    }
    xor_witness(a, 1, w, lo, hi);
  }
  keccak_f_digest(lo, hi);
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
  return !taken ? 2 : ((chosen & ((1u << a.bits) - 1u)) == 0 ? 1 : 0);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kGrindThreads) keccak_grind_kernel(const __grid_constant__ GrindArgs a) {
  __shared__ uint32_t sm[kGrindConsts];
  grind_prologue(a, sm, threadIdx.x);
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * kGrindThreads + threadIdx.x;
  if (c < a.count) a.out[c] = grind_verdict(a, sm, uint32_t(a.start + uint64_t(c)));
}
#endif

}  // namespace

#ifdef __CUDACC__
// Grind verdicts of the witnesses start .. start+count-1 into out (count);
// w's two parts (block, lane, shift), the second's lane -1 when w lies in
// one lane.  Returns the CUDA error status of the launch.
extern "C" int ts_keccak_grind(const uint64_t* prefix, const uint64_t* tail, int n_blocks, int wb0, int wl0, int ws0,
                               int wb1, int wl1, int ws1, int bits, uint64_t start, int64_t count, uint8_t* out,
                               cudaStream_t stream) {
  GrindArgs a;
  if (const int status = grind_args(prefix, tail, n_blocks, wb0, wl0, ws0, wb1, wl1, ws1, bits, start, count, out, a))
    return status;
  if (count <= 0) return 0;
  keccak_grind_kernel<<<unsigned((count + kGrindThreads - 1) / kGrindThreads), kGrindThreads, 0, stream>>>(a);
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
// rows are pend's p < 34 words (word j of row r at pend[r prs + j pcs]) then
// mat's k words (row stride ms; with monty, Montgomery forms; with rev,
// which needs monty, tree row r is mat's row bitrev(r), n = 2^log_n).
// !fin: absorb the whole rate blocks into state (only when there is one)
// and write the rest, (p + k) % 34 words a row, to out word-major.  fin:
// absorb everything, the last partial block included, and write the (n, 8)
// digests to out, leaving state as it is.  Returns the CUDA error status of
// the launch.
extern "C" int ts_keccak_absorb(uint32_t* state, int64_t n, int log_n, const uint32_t* pend, int64_t p, int64_t prs,
                                int64_t pcs, const uint32_t* mat, int64_t k, int64_t ms, int first, int rev, int monty,
                                int fin, uint32_t* out, cudaStream_t stream) {
  AbsorbArgs a;
  if (const int status = absorb_args(state, n, log_n, pend, p, prs, pcs, mat, k, ms, first, rev, monty, fin, out, a))
    return status;
  if (n <= 0) return 0;
  const unsigned blocks = unsigned((n + kAbsorbThreads - 1) / kAbsorbThreads);
  absorb_flags(fin, rev, monty, [&](auto f, auto r, auto m) {
    keccak_absorb_kernel<decltype(f)::value, decltype(r)::value, decltype(m)::value>
        <<<blocks, kAbsorbThreads, 0, stream>>>(a);
  });
  return (int)cudaGetLastError();
}
#endif
