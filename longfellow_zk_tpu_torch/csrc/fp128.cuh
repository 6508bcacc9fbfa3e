// Fp128 arithmetic shared by the port's four kernels.
//
// p = 2^128 - 2^108 + 1.  An element is four little-endian 32-bit limbs
// (one uint4, 16 bytes), in Montgomery form with R = 2^128, and every
// function here returns it canonical (< p).  R = 2^128 is also the JAX
// package's R (eight 16-bit limbs), so both hold the same integers; only
// n0inv differs: -p^-1 mod 2^32 here, mod 2^16 there.
//
// Sums are exact: each 32-bit limb is added into a 64-bit accumulator
// (fewer than 2^31 addends, so no accumulator overflows) and the four
// accumulators are reduced once at the end (fp_reduce_acc).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define FP_N0INV 0xFFFFFFFFu  // -p^-1 mod 2^32 (p = 1 mod 2^32)

struct Fp {
  uint32_t l[4];
};

__device__ __forceinline__ uint32_t fp_p(int j) {
  return j == 0 ? 0x00000001u : (j == 3 ? 0xFFFFF000u : 0u);
}

__device__ __forceinline__ Fp fp_load(const uint4* a, long long i) {
  uint4 v = a[i];
  Fp r = {{v.x, v.y, v.z, v.w}};
  return r;
}

__device__ __forceinline__ void fp_store(uint4* a, long long i, const Fp& x) {
  a[i] = make_uint4(x.l[0], x.l[1], x.l[2], x.l[3]);
}

__device__ __forceinline__ Fp fp_zero() {
  Fp r = {{0u, 0u, 0u, 0u}};
  return r;
}

// R mod p: the Montgomery form of 1.
__device__ __forceinline__ Fp fp_one() {
  Fp r = {{0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000FFFu}};
  return r;
}

// R^2 mod p: fp_mul(x, R^2) = x * R mod p.
__device__ __forceinline__ Fp fp_r2() {
  Fp r = {{0xEFFFFF01u, 0xFFFEFFFFu, 0xFEFFFFEFu, 0x000FDFFFu}};
  return r;
}

__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  return (a.l[0] | a.l[1] | a.l[2] | a.l[3]) == 0u;
}

// top * 2^128 + t, a value below 2p, to its canonical value.
__device__ __forceinline__ Fp fp_cond_sub(const Fp& t, uint32_t top) {
  Fp d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    u64 s = (u64)t.l[j] - fp_p(j) - borrow;
    d.l[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  return (top != 0u || borrow == 0u) ? d : t;
}

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  Fp s;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    c += (u64)a.l[j] + b.l[j];
    s.l[j] = (uint32_t)c;
    c >>= 32;
  }
  return fp_cond_sub(s, (uint32_t)c);
}

__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    u64 s = (u64)a.l[j] - b.l[j] - borrow;
    d.l[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  if (borrow) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      c += (u64)d.l[j] + fp_p(j);
      d.l[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

__device__ __forceinline__ Fp fp_neg(const Fp& a) { return fp_sub(fp_zero(), a); }

// Montgomery product a * b * R^-1 mod p (CIOS over 32-bit words).
// Needs a < R and b < p; the result is canonical.
__device__ __forceinline__ Fp fp_mul(const Fp& a, const Fp& b) {
  uint32_t t[6] = {0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      u64 s = (u64)t[j] + (u64)a.l[j] * b.l[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    u64 s = (u64)t[4] + c;
    t[4] = (uint32_t)s;
    t[5] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * FP_N0INV;
    s = (u64)t[0] + (u64)m * fp_p(0);
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 4; j++) {
      s = (u64)t[j] + (u64)m * fp_p(j) + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (u64)t[4] + c;
    t[3] = (uint32_t)s;
    t[4] = t[5] + (uint32_t)(s >> 32);
  }
  Fp r = {{t[0], t[1], t[2], t[3]}};
  return fp_cond_sub(r, t[4]);
}

__device__ __forceinline__ void fp_acc(u64 acc[4], const Fp& x) {
#pragma unroll
  for (int j = 0; j < 4; j++) acc[j] += x.l[j];
}

// sum_k acc[k] * 2^(32k), every acc[k] < 2^63, to its canonical value.
__device__ __forceinline__ Fp fp_reduce_acc(const u64 acc[4]) {
  Fp lo;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    c += acc[j];
    lo.l[j] = (uint32_t)c;
    c >>= 32;
  }
  // lo < 2^128 < 2p; the carry c < 2^32 stands for c * 2^128 = c * R.
  Fp low = fp_cond_sub(lo, 0u);
  Fp top = {{(uint32_t)c, 0u, 0u, 0u}};
  return fp_add(low, fp_mul(top, fp_r2()));
}

__device__ __forceinline__ void warp_sum4(u64 acc[4]) {
#pragma unroll
  for (int j = 0; j < 4; j++) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_down_sync(0xFFFFFFFFu, acc[j], off);
  }
}

extern "C" const char* lfzk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
