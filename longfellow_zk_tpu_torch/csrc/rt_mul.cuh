// rt_mul: the field products on K10's chain (round_tail.cu, which alone
// includes this header, so that no other kernel moves with them), and
// its halving.  For a prime field fs.cuh's fs_mul
// (fp.cuh's fp_mul, a call where it is long).  At GF(2^128) the warp's product (below): K10 runs its
// algebra on all 32 threads of its block, the same values on each.
// tests/test_torch_fs_words.py holds it to the host product on the CPU.
#pragma once

#include "fs.cuh"

template <class C>
__device__ __forceinline__ Fp<C> rt_mul(const Fp<C>& a, const Fp<C>& b) {
  return fs_mul(a, b);
}

// a / 2 in a prime field (K10's Newton denominators 1/2): a + p (a odd)
// or a, shifted right, the carry of the sum its top bit.
template <class C>
__device__ __forceinline__ Fp<C> rt_half(const Fp<C>& a) {
  const uint32_t odd = 0u - (a.l[0] & 1u);
  Fp<C> s;
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < C::N; j++) {
    c += (u64)a.l[j] + (C::p(j) & odd);
    s.l[j] = (uint32_t)c;
    c >>= 32;
  }
  Fp<C> r;
#pragma unroll
  for (int j = 0; j < C::N; j++)
    r.l[j] = __funnelshift_r(s.l[j], j + 1 < C::N ? s.l[j + 1] : (uint32_t)c,
                             1);
  return r;
}

// (never called: K10 takes the small constants at a prime field alone)
template <>
__device__ __forceinline__ Fp<G128> rt_half<G128>(const Fp<G128>& a) {
  return a;
}

// Lane l's part of a b at GF(2^128) (the warp's product below): a times
// the 4 bits of b at 4l .. 4l + 3, carry-less, moved up 4l bits into the
// 256-bit product's 8 words.
__device__ __forceinline__ void g128_lane_part(const Fp<G128>& a,
                                               const Fp<G128>& b, int l,
                                               uint32_t W[8]) {
  const uint32_t bw = l < 8 ? b.l[0] : l < 16 ? b.l[1] : l < 24 ? b.l[2]
                                                                : b.l[3];
  const uint32_t nib = (bw >> (4 * (l & 7))) & 0xFu;
  uint32_t P[5] = {0u, 0u, 0u, 0u, 0u};  // a nib, 131 bits
#pragma unroll
  for (int j = 0; j < 4; j++) {
    const uint32_t m = 0u - ((nib >> j) & 1u);
    P[0] ^= (a.l[0] << j) & m;
#pragma unroll
    for (int k = 1; k < 4; k++) P[k] ^= __funnelshift_l(a.l[k - 1], a.l[k], j) & m;
    P[4] ^= __funnelshift_l(a.l[3], 0u, j) & m;
  }
  const uint32_t sh = 4u * (uint32_t)(l & 7), q = (uint32_t)l >> 3;
  uint32_t Q[5];  // P sh bits up (the word above is zero: degree < 159)
  Q[0] = P[0] << sh;
#pragma unroll
  for (int k = 1; k < 5; k++) Q[k] = __funnelshift_l(P[k - 1], P[k], sh);
  const uint32_t top = __funnelshift_l(P[4], 0u, sh);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint32_t w = 0u;
#pragma unroll
    for (int d = 0; d < 4; d++) {
      const int src = k - d;
      const uint32_t v = src >= 0 && src < 5 ? Q[src] : src == 5 ? top : 0u;
      w = q == (uint32_t)d ? v : w;
    }
    W[k] = w;
  }
}

// a b at GF(2^128) by the warp: every lane of it calls this with the same
// a and b, lane l multiplies by 4 bits of b (g128_lane_part), an XOR over
// the lanes (5 shuffle steps) sums the 256-bit product, and each lane
// folds it (gf2.cuh's g128_fold); about 200 instructions a lane and a
// chain of about 400 cycles, against about 1,400 cycles for gf2.cuh's
// product in one thread (tools/gf2_diag.cu).  Compiled
// for the host (tests/test_torch_fs_words.py), one thread sums the 32
// lanes' parts itself.
template <>
__device__ __forceinline__ Fp<G128> rt_mul<G128>(const Fp<G128>& a,
                                                 const Fp<G128>& b) {
  uint32_t W[8];
#ifdef __CUDA_ARCH__
  g128_lane_part(a, b, threadIdx.x & 31, W);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < 8; k++)
      W[k] ^= __shfl_xor_sync(0xFFFFFFFFu, W[k], off);
#else
#pragma unroll
  for (int k = 0; k < 8; k++) W[k] = 0u;
  for (int l = 0; l < 32; l++) {
    uint32_t P[8];
    g128_lane_part(a, b, l, P);
#pragma unroll
    for (int k = 0; k < 8; k++) W[k] ^= P[k];
  }
#endif
  return g128_fold(W);
}
