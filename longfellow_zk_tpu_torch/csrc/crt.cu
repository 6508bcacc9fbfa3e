// The CRT convolution's conversions and its per-lane products: the
// Reed-Solomon code of a prime field without a large 2-adic root of unity
// runs its NTTs over VS 32-bit primes (K4 [crt], ntt.cu) between these
// kernels.  K13 and K15 have an instance for each such field, with the
// basis size of fields/multiprime.py basis_size_for compiled in:
//
//   fp256k1  the secp256k1 base field   VS = 18  (the bitaddr proof)
//   p256n    the P-256 group order      VS = 18
//   fp256    the P-256 base field       VS = 18  (its NTT route runs over
//            Fp2; the CRT route gives the same code, checked on the ECDSA
//            proof)
//   p384     the P-384 base field       VS = 26
//   p521     the P-521 base field       VS = 35
//
// The residues are one Montgomery word each (R = 2^32), lane-major
// [VS, n] (mp.cuh); the target field's elements Fp<C> as everywhere
// (fp.cuh).  K14 and K4 [crt] take any VS up to MP_MAX.
//
//   K13 crt_to[<field>]     x [n] (Montgomery, target field) -> its
//       residues [VS, n]: the natural words w_i of x (one Montgomery
//       product by 1), then per lane sum_i mont(w_i, C_i,b) with
//       C_i,b = 2^(32 i) * 2^64 mod p_b, which is w_i 2^(32 i) 2^32 mod p_b.
//       Replaces transforms/crt_conv.py:86 CRTContext.to_crt (16-bit limbs
//       there, 32-bit words here: the same residues).
//   K14 mp_elementwise[crt] out[b, i] = a[b, i] op b[b * blane +
//       (i / bdiv) % bmod] modulo p_b, op the Montgomery product (mode 0),
//       sum (1) or difference (2): the pointwise product of the
//       convolution by the transform of its fixed kernel, broadcast over
//       the rows without being materialised.  Replaces
//       fields/multiprime.py:233 MultiPrimeField.mul, :211 add, :220 sub
//       (:201 _cond_sub_p inside them).
//   K15 crt_from[<field>]   residues [VS, n] (Montgomery) -> x [n]: the
//       natural residues (a product by 1), Garner's mixed-radix digits
//       (v_i <- (v_i - v_{j-1}) * p_{j-1}^-1 mod p_i for i >= j, in
//       registers, VS (VS - 1) / 2 products: 153 at VS = 18, 325 at 26,
//       595 at 35; the triangle is unrolled whole), then
//       x = sum_j v_j * (prod_{k<j} p_k) in the target field: VS
//       Montgomery products by G_j = (prod_{k<j} p_k) R^2 mod p.
//       Replaces transforms/crt_conv.py:101 CRTContext.from_crt.
//
// Bound on the H100: bytes for K13 and K14 (at secp256k1 K13 reads 32
// bytes and writes 72 an element for 144 one-word products and one
// reduction; K14 moves 12 bytes a product), operations for K15: VS +
// VS (VS - 1) / 2 one-word products (the natural residues and Garner) and
// the dot at its least, VS digits times N-word constants summed before
// one reduction (at secp256k1 171 products and 558 multiplies in all on
// 104 bytes; at P-521, 630 products and 2,161 multiplies on 208 bytes).
// This K15 spends a full N-word product on each term of the dot instead
// (about 2,300 multiplies at 8 words, 20,000 at 17), several times its
// bound: a lazy dot is the next step.  Design:
// one thread an element; K15 keeps its VS digits in registers (VS is a
// template parameter, its loops unrolled), the lane constants come from
// the __constant__ table of mp.cuh, the per-basis tables (C_i,b, the
// Garner inverses, G_j) from small device arrays read by every thread
// alike.
#include "fp.cuh"
#include "mp.cuh"

template <class C, int VS>
__global__ void k_crt_to(uint32_t* __restrict__ out,
                         const uint4* __restrict__ x,
                         const uint32_t* __restrict__ ci, long long n) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  Fp<C> one = fp_zero<C>();
  one.l[0] = 1u;
  Fp<C> w = fp_mul(Fp<C>::load(x, e), one);  // the natural words
#pragma unroll 1
  for (int b = 0; b < VS; b++) {
    MpPrime c = MP_PRIMES[b];
    uint32_t acc = 0u;
#pragma unroll
    for (int i = 0; i < C::N; i++)
      acc = mp_add(acc, mp_mul(w.l[i], __ldg(ci + i * VS + b), c.p, c.n0inv),
                   c.p);
    out[b * n + e] = acc;
  }
}

__global__ void k_mp_elementwise(int mode, uint32_t* __restrict__ out,
                                 const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b, long long n,
                                 long long lane_n, long long blane,
                                 long long bdiv, long long bmod) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long lane = i / lane_n, j = i - lane * lane_n;
  MpPrime c = MP_PRIMES[lane];
  uint32_t x = a[i], y = b[lane * blane + (j / bdiv) % bmod];
  out[i] = mode == 0 ? mp_mul(x, y, c.p, c.n0inv)
                     : (mode == 1 ? mp_add(x, y, c.p) : mp_sub(x, y, c.p));
}

// gar[(j - 1) * VS + i] = p_{j-1}^-1 2^32 mod p_i (i >= j); g: VS target
// field elements, g[j] = (prod_{k<j} p_k) R^2 mod p.
template <class C, int VS>
__global__ void k_crt_from(uint4* __restrict__ out,
                           const uint32_t* __restrict__ z,
                           const uint32_t* __restrict__ gar,
                           const uint4* __restrict__ g, long long n) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t v[VS];
#pragma unroll
  for (int b = 0; b < VS; b++)
    v[b] = mp_mul(z[b * n + e], 1u, MP_PRIMES[b].p, MP_PRIMES[b].n0inv);
#pragma unroll
  for (int j = 1; j < VS; j++) {
#pragma unroll
    for (int i = j; i < VS; i++) {
      uint32_t p = MP_PRIMES[i].p;
      // v_{j-1} < p_{j-1} < 2^32 < 2 p_i
      uint32_t d = mp_sub(v[i], mp_reduce(v[j - 1], p), p);
      v[i] = mp_mul(d, __ldg(gar + (j - 1) * VS + i), p, MP_PRIMES[i].n0inv);
    }
  }
  Fp<C> acc = fp_zero<C>();
#pragma unroll 1
  for (int j = 0; j < VS; j++) {
    Fp<C> d = fp_zero<C>();
    d.l[0] = v[j];
    acc = fp_add(acc, fp_mul(d, Fp<C>::load(g, j)));
  }
  acc.store(out, e);
}

static unsigned blocks_of(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// n elements of x to their vs residues; vs must be the instance's VS.
template <class C, int VS>
static int crt_to(void* out, const void* x, const void* ci, long long n,
                  int vs, void* stream) {
  if (vs != VS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  k_crt_to<C, VS><<<blocks_of(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint4*)x, (const uint32_t*)ci, n);
  return (int)cudaGetLastError();
}

template <class C, int VS>
static int crt_from(void* out, const void* z, const void* gar, const void* g,
                    long long n, int vs, void* stream) {
  if (vs != VS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  k_crt_from<C, VS><<<blocks_of(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (uint4*)out, (const uint32_t*)z, (const uint32_t*)gar,
      (const uint4*)g, n);
  return (int)cudaGetLastError();
}

extern "C" int mp_elementwise_crt(int mode, void* out, const void* a,
                                  const void* b, long long n, int vs,
                                  long long blane, long long bdiv,
                                  long long bmod, void* stream) {
  if (vs <= 0 || vs > MP_MAX || n % vs) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  k_mp_elementwise<<<blocks_of(n, 256), 256, 0, (cudaStream_t)stream>>>(
      mode, (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n,
      n / vs, blane, bdiv, bmod);
  return (int)cudaGetLastError();
}

// tag, the target field, its basis size (basis_size_for(bits of p))
#define LFZK_CRT(tag, C, VS)                                                \
  extern "C" int crt_to_##tag(void* out, const void* x, const void* ci,    \
                              long long n, int vs, void* stream) {         \
    return crt_to<C, VS>(out, x, ci, n, vs, stream);                       \
  }                                                                         \
  extern "C" int crt_from_##tag(void* out, const void* z, const void* gar, \
                                const void* g, long long n, int vs,        \
                                void* stream) {                            \
    return crt_from<C, VS>(out, z, gar, g, n, vs, stream);                 \
  }
LFZK_CRT(fp256k1, P256K1, 18)
LFZK_CRT(p256n, P256N, 18)
LFZK_CRT(fp256, P256, 18)
LFZK_CRT(p384, P384, 26)
LFZK_CRT(p521, P521, 35)
