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
// is the spaced multiply (the JAX package's _hw_clmul, fields/gf2.py:290,
// at 32 bits): a 32 x 32 carry-less product is 16 integer 32 x 32 -> 64
// multiplies of the operands masked to the four residue classes of bit
// positions mod 4 (a column of such an integer product receives at most 8
// one-bit addends, whose count stays inside the 4-bit gap to the next
// column of its class, so the count's low bit there is the carry-less
// bit), and two levels of Karatsuba make the 256-bit product of two
// elements from nine of them: 144 multiplies, then one fold
// (g128_fold).  About 500 32-bit operations a product, against about
// 2,000 for a shift-and-XOR over b's bits (tools/gf2_diag.cu times
// both).  A product by an element that serves
// many (g128_split) makes that operand's 36 class words once, and a sum
// of products may stay unreduced (g128_clmul, 8 words) and be folded once:
// the fold is GF(2)-linear.
//
// A product by one element r that a whole block shares (K1's bind, hv and
// products by one element a lane, fp_ops.cu) reads a table of r's
// multiples in shared memory instead (g128_tab_build, g128_tab_mul): for
// each byte v at byte position k of x the reduced product (v x^(8 k)) r,
// so that x r is the XOR of 16 table entries (a table by nibbles, 8 KB,
// read 32 entries and was slower: tools/gf2_diag.cu).
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

// -- the spaced-multiply Karatsuba product ----------------------------

__device__ __forceinline__ void g128_split4(uint32_t x, uint32_t m[4]) {
  m[0] = x & 0x11111111u;
  m[1] = x & 0x22222222u;
  m[2] = x & 0x44444444u;
  m[3] = x & 0x88888888u;
}

// The 64-bit carry-less product of a 32-bit a (as its four classes) and b:
// the products of class i of a and class j of b land in class i + j mod 4.
__device__ __forceinline__ u64 g128_clmul32(const uint32_t a[4], uint32_t b) {
  uint32_t c[4];
  g128_split4(b, c);
  const u64 r0 = (u64)a[0] * c[0] ^ (u64)a[1] * c[3] ^ (u64)a[2] * c[2] ^
                 (u64)a[3] * c[1];
  const u64 r1 = (u64)a[0] * c[1] ^ (u64)a[1] * c[0] ^ (u64)a[2] * c[3] ^
                 (u64)a[3] * c[2];
  const u64 r2 = (u64)a[0] * c[2] ^ (u64)a[1] * c[1] ^ (u64)a[2] * c[0] ^
                 (u64)a[3] * c[3];
  const u64 r3 = (u64)a[0] * c[3] ^ (u64)a[1] * c[2] ^ (u64)a[2] * c[1] ^
                 (u64)a[3] * c[0];
  return (r0 & 0x1111111111111111ull) | (r1 & 0x2222222222222222ull) |
         (r2 & 0x4444444444444444ull) | (r3 & 0x8888888888888888ull);
}

// An operand of the product made once: the nine 32-bit words that its
// Karatsuba levels multiply (a0, a1, a0 ^ a1 of the low half; the same of
// the high half; of the halves' sum), each as its four classes.
struct G128Split {
  uint32_t m[9][4];
};

__device__ __forceinline__ void g128_split(const Fp<G128>& a, G128Split& s) {
  const uint32_t w[9] = {a.l[0],          a.l[1],          a.l[0] ^ a.l[1],
                         a.l[2],          a.l[3],          a.l[2] ^ a.l[3],
                         a.l[0] ^ a.l[2], a.l[1] ^ a.l[3],
                         a.l[0] ^ a.l[1] ^ a.l[2] ^ a.l[3]};
#pragma unroll
  for (int k = 0; k < 9; k++) g128_split4(w[k], s.m[k]);
}

// The 128-bit carry-less product of 64 bits of a (three split words) and
// b1:b0, by one level of Karatsuba.
__device__ __forceinline__ void g128_clmul64(const uint32_t (*am)[4],
                                             uint32_t b0, uint32_t b1,
                                             uint32_t r[4]) {
  const u64 lo = g128_clmul32(am[0], b0), hi = g128_clmul32(am[1], b1);
  const u64 mid = g128_clmul32(am[2], b0 ^ b1) ^ lo ^ hi;
  r[0] = (uint32_t)lo;
  r[1] = (uint32_t)(lo >> 32) ^ (uint32_t)mid;
  r[2] = (uint32_t)hi ^ (uint32_t)(mid >> 32);
  r[3] = (uint32_t)(hi >> 32);
}

// The 256-bit carry-less product t (8 words) of a (split) and b.
__device__ __forceinline__ void g128_clmul(const G128Split& s,
                                           const Fp<G128>& b, uint32_t t[8]) {
  uint32_t L[4], H[4], M[4];
  g128_clmul64(s.m + 0, b.l[0], b.l[1], L);
  g128_clmul64(s.m + 3, b.l[2], b.l[3], H);
  g128_clmul64(s.m + 6, b.l[0] ^ b.l[2], b.l[1] ^ b.l[3], M);
#pragma unroll
  for (int j = 0; j < 4; j++) M[j] ^= L[j] ^ H[j];
  t[0] = L[0];
  t[1] = L[1];
  t[2] = L[2] ^ M[0];
  t[3] = L[3] ^ M[1];
  t[4] = H[0] ^ M[2];
  t[5] = H[1] ^ M[3];
  t[6] = H[2];
  t[7] = H[3];
}

// The 256-bit carry-less product t mod x^128 + x^7 + x^2 + x + 1: the
// high half H folds back as H (1 + x + x^2 + x^7), and the at most 7 bits
// that spill past x^127 fold once more.
__device__ __forceinline__ Fp<G128> g128_fold(const uint32_t t[8]) {
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
__device__ __forceinline__ Fp<G128> fp_mul<G128>(const Fp<G128>& a,
                                                 const Fp<G128>& b) {
  G128Split s;
  g128_split(a, s);
  uint32_t t[8];
  g128_clmul(s, b, t);
  return g128_fold(t);
}

// The square: squaring is linear over GF(2), so each word's bits spread
// to the even positions of 64 (a 255-bit product with no cross terms),
// then the fold.  About 60 operations (the JAX package's GF2_128.sqr,
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
  return g128_fold(t);
}

// -- the product by one element through a table of its multiples -------
//
// The table: entry v of byte position k at tab[256 k + v] (16 x 256
// entries of 16 bytes, 64 KB), then the 128 basis elements r x^j that
// build it.
constexpr int G128_TAB_BYTES = (16 * 256 + 128) * 16;

// r x^j mod P (0 <= j < 128)
__device__ __forceinline__ Fp<G128> g128_mul_xj(const Fp<G128>& r, int j) {
  const int q = j >> 5;
  const uint32_t sh = (uint32_t)j & 31u;
  uint32_t t[8];
#pragma unroll
  for (int w = 0; w < 8; w++) {
    uint32_t hi = 0u, lo = 0u;
#pragma unroll
    for (int c = 0; c < 4; c++) {
      hi = w - q == c ? r.l[c] : hi;
      lo = w - q - 1 == c ? r.l[c] : lo;
    }
    t[w] = __funnelshift_l(lo, hi, sh);
  }
  return g128_fold(t);
}

__host__ __device__ constexpr int g128_ctz(int g) {
  return (g & 1) ? 0 : 1 + g128_ctz(g >> 1);
}

__device__ __forceinline__ uint4 g128_xor4(const uint4& a, const uint4& b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// Every thread of the block calls it: the basis r x^j (one a thread),
// then each of 256 threads fills the 16 entries l + 16 g of one byte
// position (l its low nibble): the first is the XOR of the basis
// elements of l's bits, the rest follow a Gray code over g, one XOR an
// entry.  A warp's threads hold consecutive l, so each store of the warp
// writes consecutive 16-byte entries (no bank conflict).  Ends with
// __syncthreads().
__device__ __forceinline__ void g128_tab_build(const Fp<G128>& r,
                                               uint4* tab) {
  uint4* basis = tab + 16 * 256;
  for (int j = threadIdx.x; j < 128; j += blockDim.x) {
    const Fp<G128> v = g128_mul_xj(r, j);
    basis[j] = make_uint4(v.l[0], v.l[1], v.l[2], v.l[3]);
  }
  __syncthreads();
  for (int u = threadIdx.x; u < 256; u += blockDim.x) {
    const int k = u >> 4, l = u & 15;
    const uint4* bk = basis + 8 * k;
    uint4 e = make_uint4(0u, 0u, 0u, 0u), high[4];
#pragma unroll
    for (int i = 0; i < 4; i++) {
      if ((l >> i) & 1) e = g128_xor4(e, bk[i]);
      high[i] = bk[4 + i];
    }
    uint4* out = tab + 256 * k + l;
    out[0] = e;
#pragma unroll
    for (int g = 1; g < 16; g++) {
      e = g128_xor4(e, high[g128_ctz(g)]);
      out[(g ^ (g >> 1)) << 4] = e;
    }
  }
  __syncthreads();
}

// x r from r's table: the XOR of one entry a byte of x
__device__ __forceinline__ Fp<G128> g128_tab_mul(const uint4* tab,
                                                 const Fp<G128>& x) {
  uint32_t a0 = 0u, a1 = 0u, a2 = 0u, a3 = 0u;
#pragma unroll
  for (int k = 0; k < 16; k++) {
    const uint4 e = tab[256 * k + ((x.l[k >> 2] >> (8 * (k & 3))) & 255u)];
    a0 ^= e.x;
    a1 ^= e.y;
    a2 ^= e.z;
    a3 ^= e.w;
  }
  Fp<G128> p;
  p.l[0] = a0;
  p.l[1] = a1;
  p.l[2] = a2;
  p.l[3] = a3;
  return p;
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
