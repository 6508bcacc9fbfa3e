// K21 fp_inv: the field inverse, one element per thread, with an instance
// for each prime field of fp.cuh, one for GF(2^128) and one for Fp2 over
// the P-256 base field.  The inverse of 0 is 0 (as a^(p - 2) gives it).
//
//   prime fields  a^(p - 2), left to right over the bits of p - 2: a square
//                 a bit, a product where the bit is set.  p is public and
//                 fixed per instance, so the bits are compile-time
//                 constants (fp.cuh's C::p) and every thread of a warp
//                 takes the same branch.
//   gf2_128       a^(2^128 - 2) = a^2 a^4 ... a^(2^127): 127 squares (the
//                 spread and fold of gf2.cuh) and 126 products.
//   fp256x2       (re, im)^-1 = (re d, -im d) with d = 1 / (re^2 + im^2),
//                 one base inverse (i^2 = -1).
//
// Replaces the JAX package's PrimeField.inv and batch_inverse (the
// lax.scan of a^(p - 2), longfellow_zk_tpu/fields/fp.py:466, :488),
// GF2_128.inv (fields/gf2.py:378) and Fp2.inv (fields/fp2.py:181); no
// proof path calls them.  The inverse is unique, so any exact method
// gives the JAX package's integers.
//
// Bound on the H100: operations.  A prime-field inverse is about 1.5
// log2 p products of 2 N^2 32-bit multiplies each (382 products, 49,000
// multiplies, for P-256) on 8 N bytes of traffic.  The design keeps it
// simple: one element a thread, the exponent's words unrolled and its
// bits looped (so the code holds N squares and N products, not 256), no
// shared memory.  A windowed exponent, or an addition chain, would save
// a third of the products.
#include "gf2.cuh"

template <class C>
__device__ __forceinline__ Fp<C> fp_inv(const Fp<C>& a) {
  uint32_t e[C::N];  // p - 2
  uint32_t borrow = 2u;
#pragma unroll
  for (int j = 0; j < C::N; j++) {
    const u64 s = (u64)C::p(j) - borrow;
    e[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  Fp<C> r = fp_one<C>();
#pragma unroll
  for (int w = C::N - 1; w >= 0; w--) {
    const uint32_t ew = e[w];
#pragma unroll 1
    for (int k = 31; k >= 0; k--) {
      r = fp_sqr(r);
      if ((ew >> k) & 1u) r = fp_mul(r, a);
    }
  }
  return r;
}

template <>
__device__ __forceinline__ Fp<G128> fp_inv<G128>(const Fp<G128>& a) {
  Fp<G128> base = fp_sqr(a);
  Fp<G128> r = base;
#pragma unroll 1
  for (int k = 1; k < 127; k++) {
    base = fp_sqr(base);
    r = fp_mul(r, base);
  }
  return r;
}

template <class C>
__global__ void k_fp_inv(uint4* __restrict__ out,
                         const uint4* __restrict__ a, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp_inv(Fp<C>::load(a, i)).store(out, i);
}

template <class C>
__global__ void k_fp2_inv(uint4* __restrict__ out,
                          const uint4* __restrict__ a, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp2<C> x = Fp2<C>::load(a, i);
  const Fp<C> d = fp_inv(fp_add(fp_sqr(x.re), fp_sqr(x.im)));
  Fp2<C> r;
  r.re = fp_mul(x.re, d);
  r.im = fp_neg(fp_mul(x.im, d));
  r.store(out, i);
}

// 128 threads a block: an 8-word inverse holds its exponent, a, r and the
// CIOS row in registers
template <class K>
static int launch_inv(K kernel, void* out, const void* a, long long n,
                      void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint4*)out, (const uint4*)a, n);
  return (int)cudaGetLastError();
}

#define LFZK_INV(inst, kern, C)                                          \
  extern "C" int fp_inv_##inst(void* out, const void* a, long long n,   \
                               void* stream) {                          \
    return launch_inv(kern<C>, out, a, n, stream);                      \
  }
LFZK_INV(fp24, k_fp_inv, FP24)
LFZK_INV(fp64, k_fp_inv, FP64)
LFZK_INV(fp128, k_fp_inv, P128)
LFZK_INV(fp256, k_fp_inv, P256)
LFZK_INV(fp256k1, k_fp_inv, P256K1)
LFZK_INV(p256n, k_fp_inv, P256N)
LFZK_INV(p256k1n, k_fp_inv, P256K1N)
LFZK_INV(gf2_128, k_fp_inv, G128)
LFZK_INV(fp256x2, k_fp2_inv, P256)
