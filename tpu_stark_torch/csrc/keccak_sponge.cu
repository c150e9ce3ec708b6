// K1: Keccak sponge over Merkle leaf rows and digest pairs, for Hopper.
//
// Replaces tpu_stark/hash/pallas_keccak.py::_sponge_kernel.  Computes
// PaddingFreeSponge<Keccak-f[1600], 25, 17, 4> per row: consecutive u32
// pairs form little-endian u64 items (an odd tail gets a zero high half);
// each rate-17 chunk overwrites the first items of the state, then all 24
// rounds run, including after the final partial chunk; the first 4 lanes are
// the digest, written as 8 u32 (lo, hi per word).
//
// A row is the concatenation of row i of `a` (ka u32) and row i of `b`
// (kb u32, may be 0): a leaf hash passes one matrix, a compress passes the
// left and right digest arrays with no concatenated copy.
//
// Design: one thread per row, the 25-lane state as native uint64_t in
// registers, the round function fully unrolled so every rotation is an
// immediate.  On the H100 the permutation is integer-ALU bound (about 24 x
// 150 64-bit logic ops per permutation against 8 u32 of input per item
// pair), so the row-major input reads are not the limit; coalescing through
// shared memory is later work.  Any N (the tail block masks) and any k.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], d[5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
    // rho + pi: b[y + 5*((2x+3y)%5)] = rotl(a[x + 5y], ROT[x + 5y])
    uint64_t b[25];
    b[0] = a[0];
    b[1] = rotl64(a[6], 44);
    b[2] = rotl64(a[12], 43);
    b[3] = rotl64(a[18], 21);
    b[4] = rotl64(a[24], 14);
    b[5] = rotl64(a[3], 28);
    b[6] = rotl64(a[9], 20);
    b[7] = rotl64(a[10], 3);
    b[8] = rotl64(a[16], 45);
    b[9] = rotl64(a[22], 61);
    b[10] = rotl64(a[1], 1);
    b[11] = rotl64(a[7], 6);
    b[12] = rotl64(a[13], 25);
    b[13] = rotl64(a[19], 8);
    b[14] = rotl64(a[20], 18);
    b[15] = rotl64(a[4], 27);
    b[16] = rotl64(a[5], 36);
    b[17] = rotl64(a[11], 10);
    b[18] = rotl64(a[17], 15);
    b[19] = rotl64(a[23], 56);
    b[20] = rotl64(a[2], 62);
    b[21] = rotl64(a[8], 55);
    b[22] = rotl64(a[14], 39);
    b[23] = rotl64(a[15], 41);
    b[24] = rotl64(a[21], 2);
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
    }
    a[0] ^= kRC[round];
  }
}

__global__ void keccak_rows_kernel(const uint32_t* __restrict__ a, int64_t ka,
                                   const uint32_t* __restrict__ b, int64_t kb,
                                   int64_t n, uint32_t* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint32_t* ra = a + row * ka;
  const uint32_t* rb = b + row * kb;
  const int64_t k = ka + kb;
  const int64_t n_items = (k + 1) / 2;
  uint64_t st[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) st[i] = 0;
  for (int64_t base = 0; base < n_items; base += 17) {
#pragma unroll
    for (int i = 0; i < 17; ++i) {
      const int64_t item = base + i;
      if (item < n_items) {
        const int64_t j = 2 * item;
        const uint32_t lo = j < ka ? ra[j] : rb[j - ka];
        const uint32_t hi = j + 1 < ka ? ra[j + 1] : (j + 1 < k ? rb[j + 1 - ka] : 0u);
        st[i] = (uint64_t)lo | ((uint64_t)hi << 32);
      }
    }
    keccak_f(st);
  }
  uint32_t* o = out + row * 8;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    o[2 * w] = (uint32_t)st[w];
    o[2 * w + 1] = (uint32_t)(st[w] >> 32);
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
// program (_chunk_fn).  Bound by the integer ALU, like K1: n_blocks
// permutations per candidate, one byte out.
__global__ void keccak_grind_kernel(const uint64_t* __restrict__ prefix,
                                    const uint64_t* __restrict__ tail, int n_blocks,
                                    int w_off, int bits, uint64_t start, int64_t count,
                                    uint8_t* __restrict__ out) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= count) return;
  const uint32_t w = (uint32_t)(start + (uint64_t)tid);
  uint64_t st[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) st[i] = prefix[i];
  for (int b = 0; b < n_blocks; ++b) {
#pragma unroll
    for (int l = 0; l < 17; ++l) {
      uint64_t add = tail[b * 17 + l];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = w_off + i;
        if (p / 136 == b && (p % 136) / 8 == l)
          add ^= (uint64_t)((w >> (8 * i)) & 0xFFu) << (8 * (p % 8));
      }
      st[l] ^= add;
    }
    keccak_f(st);
  }
  uint32_t chosen = 0;
  bool taken = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint64_t lane = st[3 - k / 2];
    const uint32_t half = (k % 2 == 0) ? (uint32_t)(lane >> 32) : (uint32_t)lane;
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
extern "C" int ts_keccak_grind(const uint64_t* prefix, const uint64_t* tail, int n_blocks,
                               int w_off, int bits, uint64_t start, int64_t count,
                               uint8_t* out, cudaStream_t stream) {
  if (count <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (count + threads - 1) / threads;
  keccak_grind_kernel<<<(unsigned)blocks, threads, 0, stream>>>(prefix, tail, n_blocks, w_off,
                                                                bits, start, count, out);
  return (int)cudaGetLastError();
}

// Hash n rows of (a_row || b_row) into out (n, 8).  Returns the CUDA error
// status of the launch.
extern "C" int ts_keccak_rows(const uint32_t* a, int64_t ka, const uint32_t* b,
                              int64_t kb, int64_t n, uint32_t* out,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  keccak_rows_kernel<<<(unsigned)blocks, threads, 0, stream>>>(a, ka, b, kb, n, out);
  return (int)cudaGetLastError();
}
