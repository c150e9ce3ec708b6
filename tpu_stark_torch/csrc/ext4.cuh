// BabyBear^4 = F_p[X] / (X^4 - 11) on Montgomery residues: the device
// counterpart of fields/extension.py, for the open phase's kernels (open.cu).
// An element is four u32 coefficients a0..a3 (little-endian in X), each a
// Montgomery form in [0, P); every function returns the canonical bits of
// its field value, so any formula gives the plain version's bits.
#pragma once

#include <cstdint>

#include "babybear.cuh"

namespace ts {

constexpr uint32_t MONTY_ONE = 0x0ffffffeu;  // 2^32 mod P: the Montgomery form of 1
constexpr uint32_t MONTY_W = 0x37ffffe9u;    // the Montgomery form of W = 11

struct Ext {
  uint32_t c[4];
};

__device__ __forceinline__ Ext ext_zero() { return Ext{{0u, 0u, 0u, 0u}}; }

__device__ __forceinline__ Ext ext_one() { return Ext{{MONTY_ONE, 0u, 0u, 0u}}; }

__device__ __forceinline__ Ext ext_load(const uint32_t* p) { return Ext{{p[0], p[1], p[2], p[3]}}; }

__device__ __forceinline__ void ext_store(uint32_t* p, const Ext& a) {
  p[0] = a.c[0];
  p[1] = a.c[1];
  p[2] = a.c[2];
  p[3] = a.c[3];
}

__device__ __forceinline__ Ext ext_add(const Ext& a, const Ext& b) {
  return Ext{{add_mod(a.c[0], b.c[0]), add_mod(a.c[1], b.c[1]), add_mod(a.c[2], b.c[2]), add_mod(a.c[3], b.c[3])}};
}

__device__ __forceinline__ Ext ext_sub(const Ext& a, const Ext& b) {
  return Ext{{sub_mod(a.c[0], b.c[0]), sub_mod(a.c[1], b.c[1]), sub_mod(a.c[2], b.c[2]), sub_mod(a.c[3], b.c[3])}};
}

// a * b for a base element b: coefficientwise
__device__ __forceinline__ Ext ext_mul_base(const Ext& a, uint32_t b) {
  return Ext{{monty_mul(a.c[0], b), monty_mul(a.c[1], b), monty_mul(a.c[2], b), monty_mul(a.c[3], b)}};
}

struct Lin {
  uint32_t p0, p1, p2;
};

// (u0 + u1 X)(v0 + v1 X) = p0 + p1 X + p2 X^2 by Karatsuba: 3 products
__device__ __forceinline__ Lin lin_mul(uint32_t u0, uint32_t u1, uint32_t v0, uint32_t v1) {
  const uint32_t p0 = monty_mul(u0, v0), p2 = monty_mul(u1, v1);
  return Lin{p0, sub_mod(monty_mul(add_mod(u0, u1), add_mod(v0, v1)), add_mod(p0, p2)), p2};
}

// The product with X^4 = W, two-level Karatsuba as fields/extension.py:
// A = AL + AH Y with Y = X^2, Y^2 = W, each half linear in X; 9 base
// products and 3 by W.
__device__ __forceinline__ Ext ext_mul(const Ext& a, const Ext& b) {
  const Lin l = lin_mul(a.c[0], a.c[1], b.c[0], b.c[1]);
  const Lin h = lin_mul(a.c[2], a.c[3], b.c[2], b.c[3]);
  const Lin q = lin_mul(add_mod(a.c[0], a.c[2]), add_mod(a.c[1], a.c[3]), add_mod(b.c[0], b.c[2]),
                        add_mod(b.c[1], b.c[3]));
  const uint32_t p10 = sub_mod(q.p0, add_mod(l.p0, h.p0));
  const uint32_t p11 = sub_mod(q.p1, add_mod(l.p1, h.p1));
  const uint32_t p12 = sub_mod(q.p2, add_mod(l.p2, h.p2));
  return Ext{{add_mod(l.p0, monty_mul(add_mod(p12, h.p0), MONTY_W)), add_mod(l.p1, monty_mul(h.p1, MONTY_W)),
              add_mod(add_mod(l.p2, p10), monty_mul(h.p2, MONTY_W)), p11}};
}

// x^e of a base element by square-and-multiply (Montgomery forms throughout)
__device__ __forceinline__ uint32_t base_pow(uint32_t x, uint64_t e) {
  uint32_t acc = MONTY_ONE;
  while (e) {
    if (e & 1) acc = monty_mul(acc, x);
    x = monty_mul(x, x);
    e >>= 1;
  }
  return acc;
}

// x^-1 = x^(P - 2) (Fermat; 0 -> 0) by an addition chain: P - 2 = 0x77FFFFFF
// is 111 0 111 and then eight runs of 111, so 30 squarings and 11 products
// (41 Montgomery products, square-and-multiply's 58)
__device__ __forceinline__ uint32_t base_inv(uint32_t x) {
  const uint32_t x3 = monty_mul(monty_mul(x, x), x);
  const uint32_t x7 = monty_mul(monty_mul(x3, x3), x);
  uint32_t r = x7;
  for (int i = 0; i < 4; ++i) r = monty_mul(r, r);
  r = monty_mul(r, x7);
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    r = monty_mul(r, r);
    r = monty_mul(r, r);
    r = monty_mul(r, r);
    r = monty_mul(r, x7);
  }
  return r;
}

// Lazy sums of raw products (K7's fold, csrc/quotient_eval.cuh): a product
// of two residues is below P^2 < 2^61.82, so four of them fit a u64; a
// settle folds the high word back, hi * (2^32 mod P) + lo < 2^60 + 2^32, so
// four more fit again; a settled sum is below P 2^32 and one Montgomery
// reduction gives sum a_k b_k 2^-32 mod P: the Monty form of sum a_k b_k
// for Monty a_k, b_k, canonical.
constexpr uint32_t TWO32_MOD_P = 0x0ffffffeu;

// acc += a * b componentwise, a an extension value, b a base value
__device__ __forceinline__ void fold(uint64_t acc[4], const Ext& a, uint32_t b) {
  acc[0] += uint64_t(a.c[0]) * b;
  acc[1] += uint64_t(a.c[1]) * b;
  acc[2] += uint64_t(a.c[2]) * b;
  acc[3] += uint64_t(a.c[3]) * b;
}

__device__ __forceinline__ uint64_t settle1(uint64_t x) {
  return uint64_t(uint32_t(x >> 32)) * TWO32_MOD_P + uint32_t(x);
}

__device__ __forceinline__ void settle(uint64_t acc[4]) {
  for (int i = 0; i < 4; ++i) acc[i] = settle1(acc[i]);
}

// x * 2^-32 mod P for x < P 2^32, canonical
__device__ __forceinline__ uint32_t monty_reduce(uint64_t x) {
  const uint32_t m = uint32_t(x) * MU;
  const uint32_t u = __umulhi(m, P);
  const uint32_t hi = uint32_t(x >> 32);
  const uint32_t r = hi - u;
  return hi < u ? r + P : r;
}

// the settled and reduced sums, zeroed for the next four terms' run
__device__ __forceinline__ Ext finish(uint64_t acc[4]) {
  Ext v;
  for (int i = 0; i < 4; ++i) {
    v.c[i] = monty_reduce(settle1(acc[i]));
    acc[i] = 0;
  }
  return v;
}

// acc += a * b, the 16 products raw: coefficient k takes sum_{i+j=k} a_i b_j
// + sum_{i+j=k+4} a_i (W b_j), four products, so a settled acc keeps below
// 2^64; wb = the Monty forms of W b_1, W b_2, W b_3
__device__ __forceinline__ void ext_mul_acc(uint64_t acc[4], const Ext& a, const Ext& b, const uint32_t wb[3]) {
  const uint64_t a0 = a.c[0], a1 = a.c[1], a2 = a.c[2], a3 = a.c[3];
  acc[0] += a0 * b.c[0] + a1 * wb[2] + a2 * wb[1] + a3 * wb[0];
  acc[1] += a0 * b.c[1] + a1 * b.c[0] + a2 * wb[2] + a3 * wb[1];
  acc[2] += a0 * b.c[2] + a1 * b.c[1] + a2 * b.c[0] + a3 * wb[2];
  acc[3] += a0 * b.c[3] + a1 * b.c[2] + a2 * b.c[1] + a3 * b.c[0];
}

// W b_1, W b_2, W b_3 for ext_mul_acc
__device__ __forceinline__ void times_w(const Ext& b, uint32_t wb[3]) {
  wb[0] = monty_mul(b.c[1], MONTY_W);
  wb[1] = monty_mul(b.c[2], MONTY_W);
  wb[2] = monty_mul(b.c[3], MONTY_W);
}

// bitrev_bits(i): the low ``bits`` bits of i reversed (bits <= 32)
__device__ __forceinline__ uint32_t bitrev(uint32_t i, int bits) { return bits == 0 ? 0u : __brev(i) >> (32 - bits); }

}  // namespace ts
