// BabyBear (P = 2^31 - 2^27 + 1) arithmetic on u32 residues in [0, P),
// shared by the kernels of this directory.  Values are Montgomery forms
// (x * 2^32 mod P) exactly as the JAX package and the port store them.
#pragma once

#include <cstdint>

namespace ts {

constexpr uint32_t P = 0x78000001u;
constexpr uint32_t MU = 0x88000001u;  // P^-1 mod 2^32

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2^32: both < P < 2^31
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + P - b;
}

// Montgomery product a * b * 2^-32 mod P of two residues, in [0, P).
// With t = a*b and m = lo32(t) * P^-1 mod 2^32, m*P has the low word of t,
// so (t - m*P) / 2^32 = hi32(t) - hi32(m*P) exactly, and lies in (-P, P).
__device__ __forceinline__ uint32_t monty_mul(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t m = (uint32_t)t * MU;
  const uint32_t u = __umulhi(m, P);
  const uint32_t hi = (uint32_t)(t >> 32);
  const uint32_t r = hi - u;
  return hi < u ? r + P : r;
}

}  // namespace ts
