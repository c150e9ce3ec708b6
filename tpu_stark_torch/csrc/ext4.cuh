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

// the Montgomery forms of FROB^k, FROB = W^((P - 1) / 4), k = 0..3: the
// Frobenius a -> a^(p^j) scales coefficient i by FROB^(i j mod 4)
struct FrobTwist {
  static __device__ __forceinline__ uint32_t at(int k) {
    return k == 0 ? 0x0ffffffeu : k == 1 ? 0x1c38d511u : k == 2 ? 0x68000003u : 0x5bc72af0u;
  }
};

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

__device__ __forceinline__ bool ext_is_zero(const Ext& a) { return (a.c[0] | a.c[1] | a.c[2] | a.c[3]) == 0u; }

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

// a -> a^(p^j)
__device__ __forceinline__ Ext ext_frobenius(const Ext& a, int j) {
  return Ext{{a.c[0], monty_mul(a.c[1], FrobTwist::at(j & 3)), monty_mul(a.c[2], FrobTwist::at((2 * j) & 3)),
              monty_mul(a.c[3], FrobTwist::at((3 * j) & 3))}};
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

// x^-1 = x^(P - 2) (Fermat); 0 -> 0
__device__ __forceinline__ uint32_t base_inv(uint32_t x) { return base_pow(x, uint64_t(P) - 2); }

// a^e by square-and-multiply
__device__ __forceinline__ Ext ext_pow(Ext a, uint64_t e) {
  Ext acc = ext_one();
  while (e) {
    if (e & 1) acc = ext_mul(acc, a);
    e >>= 1;
    if (e) a = ext_mul(a, a);
  }
  return acc;
}

// The inverse by the norm, as fields/extension.py: b = the product of the
// three conjugates, N = (a b)[0] in F_p, a^-1 = b / N; 0 -> 0.
__device__ __forceinline__ Ext ext_inv(const Ext& a) {
  const Ext b = ext_mul(ext_frobenius(a, 1), ext_mul(ext_frobenius(a, 2), ext_frobenius(a, 3)));
  const uint32_t norm = ext_mul(a, b).c[0];
  return ext_mul_base(b, base_inv(norm));
}

// bitrev_bits(i): the low ``bits`` bits of i reversed (bits <= 32)
__device__ __forceinline__ uint32_t bitrev(uint32_t i, int bits) { return bits == 0 ? 0u : __brev(i) >> (32 - bits); }

}  // namespace ts
