// GF(2^128) = GF(2)[x] / (x^128 + x^7 + x^2 + x + 1) behind the interface
// of Fp<C> (fp.cuh), so that the bodies of K1-K3 instantiate over it
// unchanged: an element Fp<G128> is its polynomial-basis bits in 4
// little-endian 32-bit words (one uint4), with no Montgomery form.
//
//   add, sub, neg   XOR (neg is the identity)
//   mul             the product mod x^128 + x^7 + x^2 + x + 1
//   one             the polynomial 1
//   fp_acc          XOR into the 64-bit accumulators, acc_add is XOR, and
//                   fp_reduce_acc keeps the low 32 bits of each
//
// Replaces the JAX package's GF2_128 device ops (longfellow_zk_tpu/fields/
// gf2.py:281 add/sub, :290 _hw_clmul, :310 _clmul_columns, :330 _fold,
// :351 mul) and its bitplane XOR reductions (:407-:436), which a GPU does
// not need: a XOR accumulator is exact.
//
// The product.  Hopper has no carry-less multiply instruction.  This one
// is a branch-free shift-and-XOR (Horner over the 128 bits of b, top bit
// first): r = r * x mod P, with the bit shifted out of x^127 folded back
// as x^7 + x^2 + x + 1, then r ^= a where b's bit is set.  About 16
// 32-bit operations a bit (funnel shifts, masks, XORs that the compiler
// fuses into LOP3), about 2,000 a product: a simple exact product; the
// spaced-multiply or a windowed table would be faster.
#pragma once

#include "fp.cuh"

struct G128 {
  static constexpr int N = 4;
  __device__ static __forceinline__ uint32_t one(int j) {
    return j == 0 ? 1u : 0u;
  }
};

template <>
__device__ __forceinline__ u64 acc_add<G128>(u64 a, u64 b) {
  return a ^ b;
}

template <>
__device__ __forceinline__ Fp<G128> fp_add<G128>(const Fp<G128>& a,
                                                 const Fp<G128>& b) {
  Fp<G128> r;
#pragma unroll
  for (int j = 0; j < 4; j++) r.l[j] = a.l[j] ^ b.l[j];
  return r;
}

template <>
__device__ __forceinline__ Fp<G128> fp_sub<G128>(const Fp<G128>& a,
                                                 const Fp<G128>& b) {
  return fp_add<G128>(a, b);
}

template <>
__device__ __forceinline__ Fp<G128> fp_neg<G128>(const Fp<G128>& a) {
  return a;
}

template <>
__device__ __forceinline__ Fp<G128> fp_mul<G128>(const Fp<G128>& a,
                                                 const Fp<G128>& b) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u;
#pragma unroll
  for (int w = 3; w >= 0; w--) {
    const uint32_t bw = b.l[w];
#pragma unroll 8
    for (int i = 31; i >= 0; i--) {
      const uint32_t top = 0u - (r3 >> 31);
      r3 = __funnelshift_l(r2, r3, 1);
      r2 = __funnelshift_l(r1, r2, 1);
      r1 = __funnelshift_l(r0, r1, 1);
      r0 = (r0 << 1) ^ (top & 0x87u);
      const uint32_t m = 0u - ((bw >> i) & 1u);
      r0 ^= a.l[0] & m;
      r1 ^= a.l[1] & m;
      r2 ^= a.l[2] & m;
      r3 ^= a.l[3] & m;
    }
  }
  Fp<G128> r;
  r.l[0] = r0;
  r.l[1] = r1;
  r.l[2] = r2;
  r.l[3] = r3;
  return r;
}

// The square: squaring is linear over GF(2), so each word's bits spread
// to the even positions of 64 (a 255-bit product with no cross terms),
// then the high 128 bits H fold back as H (1 + x + x^2 + x^7), and the
// at most 7 bits that fold spills past x^127 fold once more.  About 60
// operations, against the product's 2,000 (the JAX package's GF2_128.sqr,
// fields/gf2.py:361, spreads and folds halfwords the same way).
__device__ __forceinline__ u64 g128_spread(uint32_t x) {
  u64 v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  v = (v | (v << 1)) & 0x5555555555555555ull;
  return v;
}

template <>
__device__ __forceinline__ Fp<G128> fp_sqr<G128>(const Fp<G128>& a) {
  uint32_t t[8];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const u64 v = g128_spread(a.l[k]);
    t[2 * k] = (uint32_t)v;
    t[2 * k + 1] = (uint32_t)(v >> 32);
  }
  const uint32_t* h = t + 4;
  Fp<G128> r;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    uint32_t x = t[j] ^ h[j] ^ (h[j] << 1) ^ (h[j] << 2) ^ (h[j] << 7);
    if (j > 0)
      x ^= (h[j - 1] >> 31) ^ (h[j - 1] >> 30) ^ (h[j - 1] >> 25);
    r.l[j] = x;
  }
  const uint32_t spill = (h[3] >> 31) ^ (h[3] >> 30) ^ (h[3] >> 25);
  r.l[0] ^= spill ^ (spill << 1) ^ (spill << 2) ^ (spill << 7);
  return r;
}

template <>
__device__ __forceinline__ void fp_acc<G128>(u64* acc, const Fp<G128>& x) {
#pragma unroll
  for (int j = 0; j < 4; j++) acc[j] ^= x.l[j];
}

template <>
__device__ __forceinline__ Fp<G128> fp_reduce_acc<G128>(const u64* acc) {
  Fp<G128> r;
#pragma unroll
  for (int j = 0; j < 4; j++) r.l[j] = (uint32_t)acc[j];
  return r;
}
