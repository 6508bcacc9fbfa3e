// K1 fp_elementwise: field elementwise ops, one element per thread, with an
// instance for each prime field of fp.cuh (Fp128, the P-256 and secp256k1
// base fields, the ML-DSA prime, Goldilocks, the P-256 and secp256k1 group
// orders) and one for GF(2^128) (gf2.cuh: add = sub = XOR, neg the
// identity, 1 - r = 1 ^ r, the square by spread and fold).
//
// Replaces the JAX package's limb-unrolled field ops inside its jitted
// programs: PrimeField.add / sub / _mont_mul_limbs / from_mont_device
// (longfellow_zk_tpu/fields/fp.py:245, :255, :277, :187), the wire-round
// bind _bind_fixed (sumcheck/prover_device.py:139) and the hv update of
// _wire_scan.one_hand (prover_device.py:595); for GF(2^128) the JAX
// package's GF2_128.add / sub / mul (fields/gf2.py:281, :351) in the
// same places; with lanes, those inside the jax.vmap of the batch prover
// (zk/batch.py:301, :344).  Modes 5-9 are the rest of the field API,
// which no proof path calls: PrimeField.sqr, neg, eq, is_zero, select
// (fields/fp.py:457, :274, :500-507) and mul_const (:460, mode 0 by the
// constant's limbs), GF2_128.sqr, neg, eq, is_zero, select, mul_const
// (fields/gf2.py:361, :286, :392-398, :358).
//
// Bound on the H100: bytes.  A multiply is 32 (Fp128) or 128 (P-256)
// 32-bit multiplies on 48 or 96 bytes of traffic, below the card's
// balance of about 5 multiplies per byte, so the design only keeps the
// traffic minimal: uint4 loads and stores (one or two per element; one
// word or a uint2 for the one- and two-word fields), neighbouring threads
// on neighbouring elements.  The second operand may be broadcast by index
// arithmetic (i / bdiv) % bmod instead of being materialised.  The
// GF(2^128) product of gf2.cuh spends about 2,000 32-bit operations on 48
// bytes, so that instance is bound by its own operations: no instruction
// of the card computes a carry-less product.
//
// Modes:
//   0 mul   out[i] = a[i] * b[(i / bdiv) % bmod]
//   1 add   out[i] = a[i] + b[...]
//   2 sub   out[i] = a[i] - b[...]
//   3 bind  the bound half of each row of a (rows of length `row`): out
//           has row / 2 elements a row, out[j] = lo + (hi - lo) * r for the
//           pair (a[2j], a[2j+1]) of its row
//   4 hv    out[i] = a[i] * (h[i % bdiv] odd ? r : 1 - r)
//   5 sqr   out[i] = a[i]^2
//   6 neg   out[i] = -a[i]
//   7 eq    outb[i] = (a[i] == b[...]), one byte (0 or 1)
//   8 is_zero  outb[i] = (a[i] == 0), one byte
//   9 select   out[i] = cond[i] ? a[i] : b[...], cond one byte an element
//           (passed as h)
// In modes 3 and 4 the outputs come in lanes of bdiv elements (one proof
// of a batch each, or one lane), each with its own challenge: lane i /
// bdiv reads r = b[(i / bdiv) * bmod], bmod being the lane stride of b in
// elements, and in mode 4 the lanes share h.  The lanes add no launch: a
// batch of proofs binds in the one launch of a single proof.
#include "gf2.cuh"

template <class C>
__global__ void k_fp_elementwise(int mode, uint4* __restrict__ out,
                                 const uint4* __restrict__ a,
                                 const uint4* __restrict__ b,
                                 const int* __restrict__ h, long long n,
                                 long long row, long long bdiv,
                                 long long bmod) {
  typedef Fp<C> E;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (mode == 7 || mode == 8) {
    const E x = E::load(a, i);
    ((unsigned char*)out)[i] =
        mode == 7 ? fp_eq(x, E::load(b, (i / bdiv) % bmod)) : fp_is_zero(x);
    return;
  }
  E r;
  switch (mode) {
    case 5:
      r = fp_sqr(E::load(a, i));
      break;
    case 6:
      r = fp_neg(E::load(a, i));
      break;
    case 9:
      r = ((const unsigned char*)h)[i] ? E::load(a, i)
                                      : E::load(b, (i / bdiv) % bmod);
      break;
    case 0:
      r = fp_mul(E::load(a, i), E::load(b, (i / bdiv) % bmod));
      break;
    case 1:
      r = fp_add(E::load(a, i), E::load(b, (i / bdiv) % bmod));
      break;
    case 2:
      r = fp_sub(E::load(a, i), E::load(b, (i / bdiv) % bmod));
      break;
    case 3: {
      const long long half = row / 2;
      const long long k = i / half, j = i - k * half;
      E lo = E::load(a, k * row + 2 * j);
      E hi = E::load(a, k * row + 2 * j + 1);
      r = fp_add(lo, fp_mul(fp_sub(hi, lo), E::load(b, (i / bdiv) * bmod)));
      break;
    }
    default: {
      E rr = E::load(b, (i / bdiv) * bmod);
      E f = (h[i % bdiv] & 1) ? rr : fp_sub(fp_one<C>(), rr);
      r = fp_mul(E::load(a, i), f);
      break;
    }
  }
  r.store(out, i);
}

template <class C>
static int fp_elementwise(int mode, void* out, const void* a, const void* b,
                          const void* h, long long n, long long row,
                          long long bdiv, long long bmod, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  k_fp_elementwise<C><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      mode, (uint4*)out, (const uint4*)a, (const uint4*)b, (const int*)h, n,
      row, bdiv, bmod);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                          \
  int mode, void *out, const void *a, const void *b, const void *h,       \
      long long n, long long row, long long bdiv, long long bmod,         \
      void *stream
extern "C" int fp_elementwise_fp128(LFZK_ARGS) {
  return fp_elementwise<P128>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_fp256(LFZK_ARGS) {
  return fp_elementwise<P256>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_fp256k1(LFZK_ARGS) {
  return fp_elementwise<P256K1>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_fp24(LFZK_ARGS) {
  return fp_elementwise<FP24>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_fp64(LFZK_ARGS) {
  return fp_elementwise<FP64>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_p256n(LFZK_ARGS) {
  return fp_elementwise<P256N>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_p256k1n(LFZK_ARGS) {
  return fp_elementwise<P256K1N>(mode, out, a, b, h, n, row, bdiv, bmod,
                                 stream);
}
extern "C" int fp_elementwise_gf2_128(LFZK_ARGS) {
  return fp_elementwise<G128>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
