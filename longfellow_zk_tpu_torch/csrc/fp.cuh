// Prime-field arithmetic shared by the port's kernels, templated on the
// field.  A field is a constants struct: its word count N, p, n0inv =
// -p^-1 mod 2^32, R mod p and R^2 mod p, with R = 2^(32 N):
//
//   P128  p = 2^128 - 2^108 + 1                    N = 4, n0inv = 2^32 - 1
//   P256  p = 2^256 - 2^224 + 2^192 + 2^96 - 1     N = 8, n0inv = 1
//         (the NIST P-256 base field; p = -1 mod 2^32)
//   P256K1  p = 2^256 - 2^32 - 977                  N = 8,
//         n0inv = 0xD2253531 (the secp256k1 base field; p = -977 mod 2^32)
//   FP24  p = 2^23 - 2^13 + 1 = 8,380,417          N = 1 (the ML-DSA prime)
//   FP64  p = 2^64 - 2^32 + 1                      N = 2 (Goldilocks)
//   P256N   the P-256 group order                  N = 8
//   P256K1N the secp256k1 group order              N = 8
//   P384  p = 2^384 - 2^128 - 2^96 + 2^32 - 1      N = 12, n0inv = 1
//   P521  p = 2^521 - 1                            N = 17, n0inv = 1
//
// An element Fp<C> is C::N little-endian 32-bit limbs (C::N / 4 uint4
// vectors, 16, 32 or 48 bytes; one uint2 at N = 2, one word at N = 1,
// and 17 words read and written one by one at N = 17: 68 bytes are no
// whole number of uint4s; K1 moves 17-word elements through shared
// memory instead, fp_ops.cu), in Montgomery form with R = 2^(32 N), and
// every function here returns it canonical (< p).  Up to N = 12, R is
// also the JAX package's R (2N 16-bit limbs), so both hold the same
// integers; only n0inv differs: mod 2^32 here, mod 2^16 there.  At P-521
// the JAX package's R is 2^528 (33 limbs; fields/bridge.py converts).  The multiply is plain CIOS with 64-bit products and
// carries; it uses no special form of p.
//
// P-256's p exceeds 2^255, so a + b and the CIOS result can carry out of
// 2^(32 N): fp_cond_sub takes that carry as a top word.  secp256k1's p
// lies within 2^32 + 977 of R, so no code here may lean on headroom below
// R: every sum, product and accumulator reduction assumes only a value
// below 2p, never below R - p.  fp_cond_sub, fp_add, fp_sub and the CIOS
// need nothing more, whatever p's size: their inputs are canonical (a
// sum below 2p, a CIOS sum below (a b + m p) / R < 2p for a < R, b < p).
// Only fp_reduce_acc starts from a value that is merely below R, which
// is below 2p only where p > R / 2 (every prime above but FP24, whose p
// lies below 2^23 with R = 2^32, and P521, p < 2^521 with R = 2^544:
// C::SMALL marks them, and that sum is reduced by a product instead).
//
// Sums are exact: each 32-bit limb is added into a 64-bit accumulator
// (fewer than 2^31 addends, so no accumulator overflows) and the N
// accumulators are reduced once at the end (fp_reduce_acc); acc_add
// combines two accumulators.  gf2.cuh puts GF(2^128) behind the same
// interface (Fp<G128>, sums by XOR).
//
// Fp2<C> = Fp<C>[i] / (i^2 + 1) is a pair (re, im) of Fp<C>, stored re
// first (2 N limbs); it is what the Reed-Solomon NTT over P-256 runs on.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

struct P128 {
  static constexpr int N = 4;
  static constexpr uint32_t N0INV = 0xFFFFFFFFu;  // p = 1 mod 2^32
  static constexpr bool SMALL = false;  // p > R / 2
  __device__ static __forceinline__ uint32_t p(int j) {
    return j == 0 ? 0x00000001u : (j == 3 ? 0xFFFFF000u : 0u);
  }
  __device__ static __forceinline__ uint32_t one(int j) {  // R mod p
    const uint32_t v[4] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                           0x00000FFFu};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t r2(int j) {  // R^2 mod p
    const uint32_t v[4] = {0xEFFFFF01u, 0xFFFEFFFFu, 0xFEFFFFEFu,
                           0x000FDFFFu};
    return v[j];
  }
};

struct P256 {
  static constexpr int N = 8;
  static constexpr uint32_t N0INV = 0x00000001u;  // p = -1 mod 2^32
  static constexpr bool SMALL = false;
  __device__ static __forceinline__ uint32_t p(int j) {
    const uint32_t v[8] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                           0x00000000u, 0x00000000u, 0x00000000u,
                           0x00000001u, 0xFFFFFFFFu};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t one(int j) {  // R mod p
    const uint32_t v[8] = {0x00000001u, 0x00000000u, 0x00000000u,
                           0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                           0xFFFFFFFEu, 0x00000000u};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t r2(int j) {  // R^2 mod p
    const uint32_t v[8] = {0x00000003u, 0x00000000u, 0xFFFFFFFFu,
                           0xFFFFFFFBu, 0xFFFFFFFEu, 0xFFFFFFFFu,
                           0xFFFFFFFDu, 0x00000004u};
    return v[j];
  }
};

struct P256K1 {
  static constexpr int N = 8;
  static constexpr uint32_t N0INV = 0xD2253531u;  // -p^-1 mod 2^32
  static constexpr bool SMALL = false;
  __device__ static __forceinline__ uint32_t p(int j) {
    const uint32_t v[8] = {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu,
                           0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                           0xFFFFFFFFu, 0xFFFFFFFFu};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t one(int j) {  // R mod p
    const uint32_t v[8] = {0x000003D1u, 0x00000001u, 0x00000000u,
                           0x00000000u, 0x00000000u, 0x00000000u,
                           0x00000000u, 0x00000000u};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t r2(int j) {  // R^2 mod p
    const uint32_t v[8] = {0x000E90A1u, 0x000007A2u, 0x00000001u,
                           0x00000000u, 0x00000000u, 0x00000000u,
                           0x00000000u, 0x00000000u};
    return v[j];
  }
};

// p < R / 2: fp_reduce_acc reduces its low part by a product.
struct FP24 {
  static constexpr int N = 1;
  static constexpr uint32_t N0INV = 0xFC7FDFFFu;
  static constexpr bool SMALL = true;
  __device__ static __forceinline__ uint32_t p(int j) { return 0x007FE001u; }
  __device__ static __forceinline__ uint32_t one(int j) {  // R mod p
    return 0x003FFE00u;
  }
  __device__ static __forceinline__ uint32_t r2(int j) {  // R^2 mod p
    return 0x002419FFu;
  }
};

struct FP64 {
  static constexpr int N = 2;
  static constexpr uint32_t N0INV = 0xFFFFFFFFu;  // p = 1 mod 2^32
  static constexpr bool SMALL = false;
  __device__ static __forceinline__ uint32_t p(int j) {
    return j == 0 ? 0x00000001u : 0xFFFFFFFFu;
  }
  __device__ static __forceinline__ uint32_t one(int j) {  // R mod p
    return j == 0 ? 0xFFFFFFFFu : 0x00000000u;
  }
  __device__ static __forceinline__ uint32_t r2(int j) {  // R^2 mod p
    return j == 0 ? 0x00000001u : 0xFFFFFFFEu;
  }
};

// the P-256 group order n (the ECDSA scalars)
struct P256N {
  static constexpr int N = 8;
  static constexpr uint32_t N0INV = 0xEE00BC4Fu;
  static constexpr bool SMALL = false;
  __device__ static __forceinline__ uint32_t p(int j) {
    const uint32_t v[8] = {0xFC632551u, 0xF3B9CAC2u, 0xA7179E84u,
                           0xBCE6FAADu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                           0x00000000u, 0xFFFFFFFFu};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t one(int j) {  // R mod p
    const uint32_t v[8] = {0x039CDAAFu, 0x0C46353Du, 0x58E8617Bu,
                           0x43190552u, 0x00000000u, 0x00000000u,
                           0xFFFFFFFFu, 0x00000000u};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t r2(int j) {  // R^2 mod p
    const uint32_t v[8] = {0xBE79EEA2u, 0x83244C95u, 0x49BD6FA6u,
                           0x4699799Cu, 0x2B6BEC59u, 0x2845B239u,
                           0xF3D95620u, 0x66E12D94u};
    return v[j];
  }
};

// the secp256k1 group order n
struct P256K1N {
  static constexpr int N = 8;
  static constexpr uint32_t N0INV = 0x5588B13Fu;
  static constexpr bool SMALL = false;
  __device__ static __forceinline__ uint32_t p(int j) {
    const uint32_t v[8] = {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu,
                           0xBAAEDCE6u, 0xFFFFFFFEu, 0xFFFFFFFFu,
                           0xFFFFFFFFu, 0xFFFFFFFFu};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t one(int j) {  // R mod p
    const uint32_t v[8] = {0x2FC9BEBFu, 0x402DA173u, 0x50B75FC4u,
                           0x45512319u, 0x00000001u, 0x00000000u,
                           0x00000000u, 0x00000000u};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t r2(int j) {  // R^2 mod p
    const uint32_t v[8] = {0x67D7D140u, 0x896CF214u, 0x0E7CF878u,
                           0x741496C2u, 0x5BCD07C6u, 0xE697F5E4u,
                           0x81C69BC5u, 0x9D671CD5u};
    return v[j];
  }
};

// the NIST P-384 base field
struct P384 {
  static constexpr int N = 12;
  static constexpr uint32_t N0INV = 0x00000001u;  // p = -1 mod 2^32
  static constexpr bool SMALL = false;
  __device__ static __forceinline__ uint32_t p(int j) {
    const uint32_t v[12] = {0xFFFFFFFFu, 0x00000000u, 0x00000000u,
                            0xFFFFFFFFu, 0xFFFFFFFEu, 0xFFFFFFFFu,
                            0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                            0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t one(int j) {  // R mod p
    const uint32_t v[12] = {0x00000001u, 0xFFFFFFFFu, 0xFFFFFFFFu,
                            0x00000000u, 0x00000001u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t r2(int j) {  // R^2 mod p
    const uint32_t v[12] = {0x00000001u, 0xFFFFFFFEu, 0x00000000u,
                            0x00000002u, 0x00000000u, 0xFFFFFFFEu,
                            0x00000000u, 0x00000002u, 0x00000001u,
                            0x00000000u, 0x00000000u, 0x00000000u};
    return v[j];
  }
};

// the NIST P-521 base field: p < R / 2 (R = 2^544), so fp_reduce_acc
// reduces its low part by a product
struct P521 {
  static constexpr int N = 17;
  static constexpr uint32_t N0INV = 0x00000001u;  // p = -1 mod 2^32
  static constexpr bool SMALL = true;
  __device__ static __forceinline__ uint32_t p(int j) {
    const uint32_t v[17] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                            0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                            0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                            0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                            0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                            0xFFFFFFFFu, 0x000001FFu};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t one(int j) {  // R mod p
    const uint32_t v[17] = {0x00800000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u};
    return v[j];
  }
  __device__ static __forceinline__ uint32_t r2(int j) {  // R^2 mod p
    const uint32_t v[17] = {0x00000000u, 0x00004000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u, 0x00000000u,
                            0x00000000u, 0x00000000u};
    return v[j];
  }
};

template <class C>
struct Fp {
  static_assert(C::N == 1 || C::N == 2 || C::N % 4 == 0 || C::N == 17,
                "an element is one word, a uint2, uint4 vectors or 17 "
                "words");
  static constexpr int V = C::N / 4;  // uint4 vectors per element
  uint32_t l[C::N];

  // Element i of an array of them (the pointer's type names the array,
  // not the element: one word or a uint2 where N < 4, words at N = 17).
  __device__ static __forceinline__ Fp load(const uint4* a, long long i) {
    Fp r;
    if constexpr (C::N == 1) {
      r.l[0] = ((const uint32_t*)a)[i];
    } else if constexpr (C::N == 2) {
      uint2 v = ((const uint2*)a)[i];
      r.l[0] = v.x;
      r.l[1] = v.y;
    } else if constexpr (C::N % 4 != 0) {
      const uint32_t* w = (const uint32_t*)a + i * C::N;
#pragma unroll
      for (int j = 0; j < C::N; j++) r.l[j] = w[j];
    } else {
#pragma unroll
      for (int k = 0; k < V; k++) {
        uint4 v = a[i * V + k];
        r.l[4 * k] = v.x;
        r.l[4 * k + 1] = v.y;
        r.l[4 * k + 2] = v.z;
        r.l[4 * k + 3] = v.w;
      }
    }
    return r;
  }

  __device__ __forceinline__ void store(uint4* a, long long i) const {
    if constexpr (C::N == 1) {
      ((uint32_t*)a)[i] = l[0];
    } else if constexpr (C::N == 2) {
      ((uint2*)a)[i] = make_uint2(l[0], l[1]);
    } else if constexpr (C::N % 4 != 0) {
      uint32_t* w = (uint32_t*)a + i * C::N;
#pragma unroll
      for (int j = 0; j < C::N; j++) w[j] = l[j];
    } else {
#pragma unroll
      for (int k = 0; k < V; k++)
        a[i * V + k] = make_uint4(l[4 * k], l[4 * k + 1], l[4 * k + 2],
                                  l[4 * k + 3]);
    }
  }
};

template <class C>
__device__ __forceinline__ Fp<C> fp_zero() {
  Fp<C> r;
#pragma unroll
  for (int j = 0; j < C::N; j++) r.l[j] = 0u;
  return r;
}

// R mod p: the Montgomery form of 1.
template <class C>
__device__ __forceinline__ Fp<C> fp_one() {
  Fp<C> r;
#pragma unroll
  for (int j = 0; j < C::N; j++) r.l[j] = C::one(j);
  return r;
}

// R^2 mod p: fp_mul(x, R^2) = x * R mod p.
template <class C>
__device__ __forceinline__ Fp<C> fp_r2() {
  Fp<C> r;
#pragma unroll
  for (int j = 0; j < C::N; j++) r.l[j] = C::r2(j);
  return r;
}

template <class C>
__device__ __forceinline__ bool fp_is_zero(const Fp<C>& a) {
  uint32_t o = 0u;
#pragma unroll
  for (int j = 0; j < C::N; j++) o |= a.l[j];
  return o == 0u;
}

// top * R + t, a value below 2p, to its canonical value.
template <class C>
__device__ __forceinline__ Fp<C> fp_cond_sub(const Fp<C>& t, uint32_t top) {
  Fp<C> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < C::N; j++) {
    u64 s = (u64)t.l[j] - C::p(j) - borrow;
    d.l[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  return (top != 0u || borrow == 0u) ? d : t;
}

template <class C>
__device__ __forceinline__ Fp<C> fp_add(const Fp<C>& a, const Fp<C>& b) {
  Fp<C> s;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < C::N; j++) {
    c += (u64)a.l[j] + b.l[j];
    s.l[j] = (uint32_t)c;
    c >>= 32;
  }
  return fp_cond_sub(s, (uint32_t)c);
}

template <class C>
__device__ __forceinline__ Fp<C> fp_sub(const Fp<C>& a, const Fp<C>& b) {
  Fp<C> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < C::N; j++) {
    u64 s = (u64)a.l[j] - b.l[j] - borrow;
    d.l[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  if (borrow) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < C::N; j++) {
      c += (u64)d.l[j] + C::p(j);
      d.l[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

template <class C>
__device__ __forceinline__ Fp<C> fp_neg(const Fp<C>& a) {
  return fp_sub(fp_zero<C>(), a);
}

// Montgomery product a * b * R^-1 mod p (CIOS over 32-bit words).
// Needs a < R and b < p; the result is canonical.  The running sum stays
// below a + p < 2R: N words and a top bit.
template <class C>
__device__ __forceinline__ Fp<C> fp_mul(const Fp<C>& a, const Fp<C>& b) {
  constexpr int N = C::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; j++) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < N; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      u64 s = (u64)t[j] + (u64)a.l[j] * b.l[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    u64 s = (u64)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * C::N0INV;
    s = (u64)t[0] + (u64)m * C::p(0);
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (u64)t[j] + (u64)m * C::p(j) + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (u64)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  Fp<C> r;
#pragma unroll
  for (int j = 0; j < N; j++) r.l[j] = t[j];
  return fp_cond_sub(r, t[N]);
}

// a * a (GF(2^128): spread and fold, gf2.cuh)
template <class C>
__device__ __forceinline__ Fp<C> fp_sqr(const Fp<C>& a) {
  return fp_mul(a, a);
}

template <class C>
__device__ __forceinline__ bool fp_eq(const Fp<C>& a, const Fp<C>& b) {
  uint32_t o = 0u;
#pragma unroll
  for (int j = 0; j < C::N; j++) o |= a.l[j] ^ b.l[j];
  return o == 0u;
}

template <class C>
__device__ __forceinline__ void fp_acc(u64* acc, const Fp<C>& x) {
#pragma unroll
  for (int j = 0; j < C::N; j++) acc[j] += x.l[j];
}

// sum_k acc[k] * 2^(32k), every acc[k] < 2^63, to its canonical value.
template <class C>
__device__ __forceinline__ Fp<C> fp_reduce_acc(const u64* acc) {
  Fp<C> lo;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < C::N; j++) {
    c += acc[j];
    lo.l[j] = (uint32_t)c;
    c >>= 32;
  }
  // lo < R, below 2p unless C::SMALL; there lo * (R mod p) * R^-1 = lo
  // mod p.  The carry c < 2^32 stands for c * R.
  Fp<C> low;
  if constexpr (C::SMALL)
    low = fp_mul(lo, fp_one<C>());
  else
    low = fp_cond_sub(lo, 0u);
  Fp<C> top = fp_zero<C>();
  top.l[0] = (uint32_t)c;
  return fp_add(low, fp_mul(top, fp_r2<C>()));
}

// Combines two accumulators of fp_acc: a sum for a prime field (XOR for
// GF(2^128), gf2.cuh).
template <class C>
__device__ __forceinline__ u64 acc_add(u64 a, u64 b) {
  return a + b;
}

template <class C>
__device__ __forceinline__ void warp_sum(u64* acc) {
#pragma unroll
  for (int j = 0; j < C::N; j++) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] = acc_add<C>(acc[j], __shfl_down_sync(0xFFFFFFFFu, acc[j], off));
  }
}

// ---------------------------------------------------------------------
// Fp2<C> = Fp<C>[i] / (i^2 + 1)
// ---------------------------------------------------------------------

template <class C>
struct Fp2 {
  Fp<C> re, im;

  __device__ static __forceinline__ Fp2 load(const uint4* a, long long i) {
    Fp2 r;
    r.re = Fp<C>::load(a, 2 * i);
    r.im = Fp<C>::load(a, 2 * i + 1);
    return r;
  }

  __device__ __forceinline__ void store(uint4* a, long long i) const {
    re.store(a, 2 * i);
    im.store(a, 2 * i + 1);
  }
};

template <class C>
__device__ __forceinline__ Fp2<C> fp_add(const Fp2<C>& a, const Fp2<C>& b) {
  Fp2<C> r;
  r.re = fp_add(a.re, b.re);
  r.im = fp_add(a.im, b.im);
  return r;
}

template <class C>
__device__ __forceinline__ Fp2<C> fp_sub(const Fp2<C>& a, const Fp2<C>& b) {
  Fp2<C> r;
  r.re = fp_sub(a.re, b.re);
  r.im = fp_sub(a.im, b.im);
  return r;
}

// Karatsuba: three base products.  p0 = a0 b0, p1 = a1 b1;
// re = p0 - p1 (i^2 = -1), im = (a0 + a1)(b0 + b1) - p0 - p1.
template <class C>
__device__ __forceinline__ Fp2<C> fp_mul(const Fp2<C>& a, const Fp2<C>& b) {
  Fp<C> p0 = fp_mul(a.re, b.re);
  Fp<C> p1 = fp_mul(a.im, b.im);
  Fp<C> s = fp_mul(fp_add(a.re, a.im), fp_add(b.re, b.im));
  Fp2<C> r;
  r.re = fp_sub(p0, p1);
  r.im = fp_sub(fp_sub(s, p0), p1);
  return r;
}

template <class C>
__device__ __forceinline__ Fp2<C> fp_mul_base(const Fp2<C>& a,
                                              const Fp<C>& s) {
  Fp2<C> r;
  r.re = fp_mul(a.re, s);
  r.im = fp_mul(a.im, s);
  return r;
}

extern "C" const char* lfzk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
