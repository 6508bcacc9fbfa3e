// K5 fp2_elementwise: elementwise ops of Fp2 = Fp[i] / (i^2 + 1) over the
// P-256 base field, one element per thread.  An element is (re, im), 64
// bytes, re first.
//
// Replaces the JAX package's Fp2.mul (Karatsuba, three base products),
// Fp2.mul_base, Fp2.add, Fp2.sub and Fp2.from_mont_device
// (longfellow_zk_tpu/fields/fp2.py:159, :171, :150, :153, :202), which the
// FFTExtConvolution of the P-256 Reed-Solomon encoder runs: the product
// of the transformed rows with the transformed kernel y.  Modes 5-9 are
// the rest of the Fp2 API, which no proof path calls: Fp2.sqr, neg, eq,
// is_zero, select (fp2.py:175, :156, :193-199) and mul_const (:178, mode
// 0 by the constant's limbs).
//
// Bound on the H100: bytes.  A product is three P-256 Montgomery products,
// 384 32-bit multiplies on 192 bytes of traffic: 2 per byte, below the
// card's balance of about 5 (16.75 T int32 multiplies/s over 3.35 TB/s).
// So the design only keeps the traffic minimal: four uint4 loads per
// operand, neighbouring threads on neighbouring elements.  The second
// operand may be broadcast by index arithmetic (i / bdiv) % bmod instead
// of being materialised.
//
// Modes:
//   0 mul       out[i] = a[i] * b[(i / bdiv) % bmod]
//   1 add       out[i] = a[i] + b[...]
//   2 sub       out[i] = a[i] - b[...]
//   3 mul_base  out[i] = a[i] * s[...], s a base-field element (32 bytes);
//               from_mont is mul_base by the natural 1
//   5 sqr       out[i] = a[i]^2 (Karatsuba's product of a by a)
//   6 neg       out[i] = -a[i]
//   7 eq        outb[i] = (a[i] == b[...]), one byte (0 or 1)
//   8 is_zero   outb[i] = (a[i] == 0), one byte
//   9 select    out[i] = cond[i] ? a[i] : b[...], cond one byte an element
#include "fp.cuh"

template <class C>
__global__ void k_fp2_elementwise(int mode, uint4* __restrict__ out,
                                  const uint4* __restrict__ a,
                                  const uint4* __restrict__ b,
                                  const unsigned char* __restrict__ cond,
                                  long long n, long long bdiv,
                                  long long bmod) {
  typedef Fp2<C> E;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long j = (i / bdiv) % bmod;
  E x = E::load(a, i);
  if (mode == 7 || mode == 8) {
    bool z;
    if (mode == 7) {
      const E y = E::load(b, j);
      z = fp_eq(x.re, y.re) && fp_eq(x.im, y.im);
    } else {
      z = fp_is_zero(x.re) && fp_is_zero(x.im);
    }
    ((unsigned char*)out)[i] = z;
    return;
  }
  E r;
  switch (mode) {
    case 5:
      r = fp_mul(x, x);
      break;
    case 6:
      r.re = fp_neg(x.re);
      r.im = fp_neg(x.im);
      break;
    case 9:
      r = cond[i] ? x : E::load(b, j);
      break;
    case 0:
      r = fp_mul(x, E::load(b, j));
      break;
    case 1:
      r = fp_add(x, E::load(b, j));
      break;
    case 2:
      r = fp_sub(x, E::load(b, j));
      break;
    default:
      r = fp_mul_base(x, Fp<C>::load(b, j));
      break;
  }
  r.store(out, i);
}

extern "C" int fp2_elementwise_fp256x2(int mode, void* out, const void* a,
                                       const void* b, const void* cond,
                                       long long n, long long bdiv,
                                       long long bmod, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  k_fp2_elementwise<P256>
      <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
          mode, (uint4*)out, (const uint4*)a, (const uint4*)b,
          (const unsigned char*)cond, n, bdiv, bmod);
  return (int)cudaGetLastError();
}
