// K3: Poseidon2-16 sponge over Merkle leaf rows and digest pairs, for Hopper.
//
// Replaces tpu_stark/hash/pallas_poseidon2.py::_sponge_kernel.  Computes
// PaddingFreeSponge<Poseidon2_16, 16, RATE, 8> per row over BabyBear
// Montgomery residues: each RATE-element chunk of the row overwrites the
// first lanes of the state (a final partial chunk only its own lanes), the
// full permutation runs after every chunk, and the first 8 lanes are the
// digest.  RATE 8 is the leaf hash; RATE 16 with one 16-element row is
// TruncatedPermutation, the 2-to-1 compress.
//
// A row is row i of `a` (ka elements, row stride lda) followed by row i of
// `b` (kb elements, row stride ldb; kb may be 0): a salted leaf passes the
// matrix and its salts, and a compress passes the left and right digests
// (or the even and odd rows of one layer, through the strides) with no
// concatenated copy.
//
// Design: one thread per row holds the 16-lane state in registers; the
// rounds read their constants from __constant__ memory (every thread of a
// warp reads the same word, a broadcast).  A permutation is about 800
// Montgomery products, so the kernel is integer-ALU bound at every width.
// Row-major input means a warp's reads are strided by the row length
// (1972 B at k = 493); coalescing them through shared memory is later work.
//
// K4 (p2_absorb_kernel, below) replaces
// tpu_stark/hash/pallas_poseidon2.py::_absorb_kernel: the same sponge, but
// the (N, 16) state comes in from device memory (or starts at zero when
// `first` is set) and goes back out, so one row's absorb spans several
// launches, one per column chunk of a matrix too wide to hold at once (the
// streamed wide commit).  One thread per row again: the state is loaded
// once, every rate-8 block of the chunk overwrites the front lanes (a final
// partial block only its own lanes) and is permuted by poseidon2_permute16,
// and the state is stored once.  The Pallas kernel's transposed,
// zero-padded (k_pad, N) block and 128-lane tiling are TPU layout needs
// and have no counterpart.  It is integer-ALU bound like K3; at k = 128 a
// warp's chunk reads are 512 B apart (uncoalesced, as in K3).

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

using ts::add_mod;
using ts::monty_mul;

constexpr int kWidth = 16;
constexpr int kOut = 8;
constexpr int kRoundsF = 8;
constexpr int kRoundsP = 13;

// Round constants and internal diagonal in Montgomery form: the Grain LFSR
// constants of tpu_stark_torch/hash/poseidon2.py::consts_monty(16), which
// tests/test_torch_poseidon2.py holds this table against.
// BEGIN POSEIDON2 CONSTANTS
__constant__ uint32_t kExtRC[kRoundsF][kWidth] = {
  {
    0x5e4d6938u, 0x71385defu, 0x61ddbd3au, 0x1b941180u,
    0x4d20d77du, 0x52478027u, 0x732e57c3u, 0x10e63112u,
    0x3c99be27u, 0x0221857au, 0x4bbe9ab7u, 0x32c46133u,
    0x2f62cc76u, 0x37682266u, 0x1f3714e3u, 0x5f01dd7du},
  {
    0x35678506u, 0x67da0d24u, 0x36b3008au, 0x5a6765ccu,
    0x45c068bdu, 0x2ed4b9ecu, 0x249392d3u, 0x150a571cu,
    0x287549eau, 0x3bedb1b8u, 0x659e048eu, 0x46023d70u,
    0x1e55a92du, 0x1f9c528fu, 0x4f1ad620u, 0x547fa880u},
  {
    0x44c19b36u, 0x22c2f11au, 0x17b67671u, 0x55dddeb4u,
    0x1b18a7edu, 0x0a66840eu, 0x0a3cd409u, 0x771e5548u,
    0x53aaba92u, 0x6bbfe070u, 0x1ad7c512u, 0x56f4fbf9u,
    0x2ee93eacu, 0x3f67bc14u, 0x766f3f66u, 0x1cb5555cu},
  {
    0x496b4856u, 0x4ee52289u, 0x0e351627u, 0x77f2fa2bu,
    0x3d176cccu, 0x42103ad7u, 0x4c8a5ba9u, 0x242cfe16u,
    0x3ce22e52u, 0x2ae0610au, 0x2751c80bu, 0x2ddefdb7u,
    0x3003796eu, 0x234c77ebu, 0x687881f7u, 0x278ad903u},
  {
    0x0eee3c46u, 0x1f803700u, 0x57cbade6u, 0x3a3d3472u,
    0x706866bdu, 0x413da073u, 0x08ca8f35u, 0x279652bbu,
    0x17c601dau, 0x140a84a1u, 0x6113337bu, 0x34f6e216u,
    0x22f9b8b2u, 0x3b98331au, 0x1225b500u, 0x20f18724u},
  {
    0x1add1eadu, 0x27c8bae0u, 0x67810938u, 0x4f2405e1u,
    0x44bd103fu, 0x30ad7b47u, 0x4025183au, 0x7222068fu,
    0x6376b2e5u, 0x5165184au, 0x3a2811d0u, 0x3d7d5b9cu,
    0x530c569du, 0x5caada1cu, 0x3d06627du, 0x5ffc6e6cu},
  {
    0x14ba29f8u, 0x71d1c1e9u, 0x2c0fb8f7u, 0x198b65e1u,
    0x25bcff06u, 0x07427c35u, 0x059b1122u, 0x519ea061u,
    0x4a81a536u, 0x06cf9aa9u, 0x1eb2ca04u, 0x02ec7cacu,
    0x74f6c733u, 0x524ebfdeu, 0x6edd9d09u, 0x03db6b21u},
  {
    0x0094e6fcu, 0x643ed13bu, 0x2a5eb829u, 0x3ccf7585u,
    0x544a7136u, 0x5b49128fu, 0x0227bd55u, 0x2a88bdadu,
    0x055c4d17u, 0x6f822c4au, 0x179a43f2u, 0x42ec1895u,
    0x68f3d82fu, 0x30dcf522u, 0x0806ab72u, 0x689d63dbu},
};
__constant__ uint32_t kIntRC[kRoundsP] = {
    0x011943f8u, 0x65709ccdu, 0x6a3c56e1u, 0x5871ed94u,
    0x395e47bdu, 0x6eb895c4u, 0x0d422bd9u, 0x03c4b679u,
    0x1eb56ddeu, 0x505e67b5u, 0x3a05211eu, 0x5ed5c104u,
    0x2a1275f1u,
};
__constant__ uint32_t kDiag[kWidth] = {
    0x58000005u, 0x0ffffffeu, 0x1ffffffcu, 0x07ffffffu,
    0x2ffffffau, 0x3ffffff8u, 0x70000002u, 0x48000007u,
    0x38000009u, 0x01000000u, 0x40000000u, 0x20000000u,
    0x00000020u, 0x77000001u, 0x68000001u, 0x77ffffe1u,
};
// END POSEIDON2 CONSTANTS

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint32_t x2 = monty_mul(x, x);
  const uint32_t x4 = monty_mul(x2, x2);
  return monty_mul(monty_mul(x4, x2), x);
}

__device__ __forceinline__ uint32_t dbl(uint32_t x) { return add_mod(x, x); }

// M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by the paper's add chain.
__device__ __forceinline__ void m4(uint32_t& x0, uint32_t& x1, uint32_t& x2,
                                   uint32_t& x3) {
  const uint32_t t0 = add_mod(x0, x1);
  const uint32_t t1 = add_mod(x2, x3);
  const uint32_t t2 = add_mod(dbl(x1), t1);
  const uint32_t t3 = add_mod(dbl(x3), t0);
  const uint32_t t4 = add_mod(dbl(dbl(t1)), t3);
  const uint32_t t5 = add_mod(dbl(dbl(t0)), t2);
  x0 = add_mod(t3, t5);
  x1 = t5;
  x2 = add_mod(t2, t4);
  x3 = t4;
}

// M_E = circ(2*M4, M4, M4, M4): M4 on each block of 4 lanes, then each
// lane plus the sum of its position over the 4 blocks.
__device__ __forceinline__ void external_mds(uint32_t s[kWidth]) {
#pragma unroll
  for (int b = 0; b < kWidth; b += 4) m4(s[b], s[b + 1], s[b + 2], s[b + 3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t sum = add_mod(add_mod(s[j], s[4 + j]), add_mod(s[8 + j], s[12 + j]));
#pragma unroll
    for (int b = 0; b < kWidth; b += 4) s[b + j] = add_mod(s[b + j], sum);
  }
}

__device__ __forceinline__ void external_round(uint32_t s[kWidth], int r) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = sbox(add_mod(s[i], kExtRC[r][i]));
  external_mds(s);
}

__device__ __forceinline__ void internal_round(uint32_t s[kWidth], int r) {
  s[0] = sbox(add_mod(s[0], kIntRC[r]));
  uint32_t sum = s[0];
#pragma unroll
  for (int i = 1; i < kWidth; ++i) sum = add_mod(sum, s[i]);
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = add_mod(monty_mul(s[i], kDiag[i]), sum);
}

}  // namespace

namespace ts {

// The width-16 Poseidon2 permutation on a register state of Montgomery
// residues: M_E, 4 external rounds, 13 internal, 4 external.
__device__ __forceinline__ void poseidon2_permute16(uint32_t s[kWidth]) {
  external_mds(s);
#pragma unroll 1
  for (int r = 0; r < kRoundsF / 2; ++r) external_round(s, r);
#pragma unroll 1
  for (int r = 0; r < kRoundsP; ++r) internal_round(s, r);
#pragma unroll 1
  for (int r = kRoundsF / 2; r < kRoundsF; ++r) external_round(s, r);
}

}  // namespace ts

namespace {

template <int RATE>
__global__ void p2_sponge_kernel(const uint32_t* __restrict__ a, int64_t lda,
                                 int64_t ka, const uint32_t* __restrict__ b,
                                 int64_t ldb, int64_t kb, int64_t n,
                                 uint32_t* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint32_t* ra = a + row * lda;
  const uint32_t* rb = kb > 0 ? b + row * ldb : nullptr;
  const int64_t k = ka + kb;
  uint32_t st[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) st[i] = 0;
  for (int64_t base = 0; base < k; base += RATE) {
#pragma unroll
    for (int i = 0; i < RATE; ++i) {
      const int64_t j = base + i;
      if (j < k) st[i] = j < ka ? ra[j] : rb[j - ka];
    }
    ts::poseidon2_permute16(st);
  }
  uint32_t* o = out + row * kOut;
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = st[i];
}

// K4: continue (or start, `first`) the rate-8 sponge of each row over the
// k elements of its chunk row (row stride ldc); state is (n, 16) contiguous.
__global__ void p2_absorb_kernel(uint32_t* __restrict__ state,
                                 const uint32_t* __restrict__ chunk,
                                 int64_t ldc, int64_t k, int64_t n, int first) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  uint32_t* s = state + row * kWidth;
  const uint32_t* r = chunk + row * ldc;
  uint32_t st[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) st[i] = first ? 0u : s[i];
  for (int64_t base = 0; base < k; base += 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t j = base + i;
      if (j < k) st[i] = r[j];
    }
    ts::poseidon2_permute16(st);
  }
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = st[i];
}

}  // namespace

// Hash n rows of (a_row || b_row) with the given rate (8 or 16) into out
// (n, 8).  Returns the CUDA error status of the launch.
extern "C" int ts_poseidon2_rows(const uint32_t* a, int64_t lda, int64_t ka,
                                 const uint32_t* b, int64_t ldb, int64_t kb,
                                 int64_t n, int rate, uint32_t* out,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (rate == 8) {
    p2_sponge_kernel<8><<<blocks, threads, 0, stream>>>(a, lda, ka, b, ldb, kb, n, out);
  } else if (rate == 16) {
    p2_sponge_kernel<16><<<blocks, threads, 0, stream>>>(a, lda, ka, b, ldb, kb, n, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K4: absorb the k-element rows of `chunk` (row stride ldc) into the (n, 16)
// sponge states in place; `first` starts from the zero state.  Returns the
// CUDA error status of the launch.
extern "C" int ts_poseidon2_absorb(uint32_t* state, const uint32_t* chunk,
                                   int64_t ldc, int64_t k, int64_t n, int first,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  p2_absorb_kernel<<<blocks, threads, 0, stream>>>(state, chunk, ldc, k, n, first);
  return (int)cudaGetLastError();
}
