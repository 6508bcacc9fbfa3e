// K22 fp24x6_elementwise: the product, square and inverse of Fp24_6 =
// F_p[x] / (x^6 - 7) over the ML-DSA prime p = 8,380,417 (fp.cuh FP24),
// one element per thread.  An element is its six coefficients, each one
// 32-bit word in Montgomery form with R = 2^32 (24 bytes, coefficient 0
// first), and every result is canonical.
//
// Replaces the JAX package's Fp24_6 device ops longfellow_zk_tpu/fields/
// fp24.py:227 mul, :242 sqr and :245 inv; no proof path calls them (the
// Fp24 circuits run in the evaluation backend).  Add, sub, neg, eq,
// is_zero and select act on each coefficient alone: fields/fp24.py runs
// them through K1 `[fp24]` on the six words.
//
// The product keeps the JAX package's schoolbook of 36 base products and
// the fold x^6 = 7, but sums lazily: p < 2^23, so a base product of two
// Montgomery words is below 2^46 and each output coefficient's 36 or
// fewer products (the fold's times 7) sum below 2^52 < p R in a 64-bit
// word, which one Montgomery reduction (redc24) brings to the canonical
// coefficient: 36 32x32->64 multiplies and 6 reductions a product,
// against the JAX package's 36 + 5 Montgomery products and 30 additions
// modulo p.  Field arithmetic is exact, so the result equals theirs.
// The inverse is a^(p^6 - 2) (138 bits, 75 of them set), left to right.
//
// Modes (the numbers of K1, fp_ops.cu):
//   0 mul   out[i] = a[i] * b[(i / bdiv) % bmod]
//   5 sqr   out[i] = a[i]^2
//   10 inv  out[i] = a[i]^-1, 0 for 0
#include "fp.cuh"

struct E6 {
  uint32_t c[6];

  __device__ static __forceinline__ E6 load(const uint2* a, long long i) {
    E6 r;
#pragma unroll
    for (int k = 0; k < 3; k++) {
      const uint2 v = a[3 * i + k];
      r.c[2 * k] = v.x;
      r.c[2 * k + 1] = v.y;
    }
    return r;
  }

  __device__ __forceinline__ void store(uint2* a, long long i) const {
#pragma unroll
    for (int k = 0; k < 3; k++)
      a[3 * i + k] = make_uint2(c[2 * k], c[2 * k + 1]);
  }
};

// t R^-1 mod p for t < p R, canonical
__device__ __forceinline__ uint32_t redc24(u64 t) {
  const uint32_t p = FP24::p(0);
  const uint32_t m = (uint32_t)t * FP24::N0INV;
  const uint32_t r = (uint32_t)((t + (u64)m * p) >> 32);  // < 2p
  return r >= p ? r - p : r;
}

__device__ __forceinline__ E6 e6_mul(const E6& a, const E6& b) {
  u64 m[11];
#pragma unroll
  for (int k = 0; k < 11; k++) m[k] = 0;
#pragma unroll
  for (int i = 0; i < 6; i++) {
#pragma unroll
    for (int j = 0; j < 6; j++) m[i + j] += (u64)a.c[i] * b.c[j];
  }
  E6 r;
#pragma unroll
  for (int k = 0; k < 5; k++) r.c[k] = redc24(m[k] + 7 * m[k + 6]);
  r.c[5] = redc24(m[5]);
  return r;
}

// the exponent p^6 - 2, low word first
__device__ __forceinline__ uint32_t e6_exp(int w) {
  const uint32_t v[5] = {0x3EFF3FFFu, 0x216BB420u, 0xE1918C63u, 0x03EE845Au,
                         0x000003FAu};
  return v[w];
}

__device__ __forceinline__ E6 e6_inv(const E6& a) {
  E6 r;
  r.c[0] = FP24::one(0);
#pragma unroll
  for (int k = 1; k < 6; k++) r.c[k] = 0u;
#pragma unroll
  for (int w = 4; w >= 0; w--) {
    const uint32_t ew = e6_exp(w);
#pragma unroll 1
    for (int k = 31; k >= 0; k--) {
      r = e6_mul(r, r);
      if ((ew >> k) & 1u) r = e6_mul(r, a);
    }
  }
  return r;
}

__global__ void k_fp24x6_elementwise(int mode, uint2* __restrict__ out,
                                     const uint2* __restrict__ a,
                                     const uint2* __restrict__ b,
                                     long long n, long long bdiv,
                                     long long bmod) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long j = (i / bdiv) % bmod;
  const E6 x = E6::load(a, i);
  E6 r;
  switch (mode) {
    case 0:
      r = e6_mul(x, E6::load(b, j));
      break;
    case 5:
      r = e6_mul(x, x);
      break;
    default:  // 10
      r = e6_inv(x);
      break;
  }
  r.store(out, i);
}

extern "C" int fp24x6_elementwise_fp24x6(int mode, void* out, const void* a,
                                         const void* b, long long n,
                                         long long bdiv, long long bmod,
                                         void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  k_fp24x6_elementwise<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      mode, (uint2*)out, (const uint2*)a, (const uint2*)b, n, bdiv, bmod);
  return (int)cudaGetLastError();
}
