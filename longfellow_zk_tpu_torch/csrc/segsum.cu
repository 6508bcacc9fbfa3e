// K2 fp_segment_sum: field sums over contiguous term ranges, with an instance
// for Fp128, one each for the P-256 and secp256k1 base fields, one for
// GF(2^128) (sums by XOR, gf2.cuh) and one for the ML-DSA prime (FP24, the
// per-coefficient sums of Fp24_6; fp_reduce_acc reduces its sums, which
// may pass 2p, by a product).
//
// out[s] = sum over t in [starts[s], ends[s]) of term(t), where term(t) is
//   mode 0: x[t]                      (_contig_fold, lazy_segment_sum)
//   mode 1: v[t] * W[h1[t]] * W[h0[t]], or 0 where bmask[t] is set; a
//           masked term whose product W[h1] * W[h0] is nonzero sets *bad
//           (the beta-mask zero check of _eval_layer)
// An empty range sums to zero.
//
// Replaces sumcheck/prover_device.py:157 _contig_fold and :372
// _eval_layer (prime branch), and fields/fp.py:561 lazy_segment_sum
// (byte-split columns + segment_sum + renormalise) of the JAX package;
// for GF(2^128) its char-2 branches (prover_device.py:167-178, :383-402,
// bitplane cumsums) and fields/gf2.py:429 lazy_segment_sum.
//
// Bound on the H100: bytes of the gathers.  Mode 1 reads per term two
// random rows of W, v and three indices; the layer's W (at most 2^15
// elements, 1 MiB at P-256) stays in L2.  One warp per segment: the lanes
// stride over the segment's terms with coalesced reads of the term
// arrays, keep N 64-bit limb accumulators (exact, no carries), reduce
// them by shuffles and lane 0 reduces the sum modulo p once.  The terms
// are g-sorted, so a warp's segment is contiguous.  GF(2^128) runs the
// same body with XOR accumulators; its two shift-and-XOR products a term
// (gf2.cuh) make that instance bound by operations.
#include "gf2.cuh"

template <class C>
__global__ void k_fp_segment_sum(int mode, uint4* __restrict__ out,
                                 int* __restrict__ bad,
                                 const uint4* __restrict__ x,
                                 const uint4* __restrict__ W,
                                 const int* __restrict__ h0,
                                 const int* __restrict__ h1,
                                 const uint4* __restrict__ v,
                                 const unsigned char* __restrict__ bmask,
                                 const int* __restrict__ starts,
                                 const int* __restrict__ ends, int nseg) {
  typedef Fp<C> E;
  int seg = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  int lane = threadIdx.x & 31;
  if (seg >= nseg) return;  // the whole warp leaves together
  u64 acc[C::N];
#pragma unroll
  for (int j = 0; j < C::N; j++) acc[j] = 0;
  int e = ends[seg];
  for (int t = starts[seg] + lane; t < e; t += 32) {
    if (mode == 0) {
      fp_acc(acc, E::load(x, t));
    } else {
      E prod = fp_mul(E::load(W, h1[t]), E::load(W, h0[t]));
      if (bmask[t]) {
        if (!fp_is_zero(prod)) *bad = 1;
      } else {
        fp_acc(acc, fp_mul(prod, E::load(v, t)));
      }
    }
  }
  warp_sum<C>(acc);
  if (lane == 0) fp_reduce_acc<C>(acc).store(out, seg);
}

template <class C>
static int fp_segment_sum(int mode, void* out, void* bad, const void* x,
                          const void* W, const void* h0, const void* h1,
                          const void* v, const void* bmask, const void* starts,
                          const void* ends, int nseg, void* stream) {
  if (nseg <= 0) return 0;
  const int threads = 256;
  long long blocks = ((long long)nseg * 32 + threads - 1) / threads;
  k_fp_segment_sum<C><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      mode, (uint4*)out, (int*)bad, (const uint4*)x, (const uint4*)W,
      (const int*)h0, (const int*)h1, (const uint4*)v,
      (const unsigned char*)bmask, (const int*)starts, (const int*)ends,
      nseg);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                          \
  int mode, void *out, void *bad, const void *x, const void *W,           \
      const void *h0, const void *h1, const void *v, const void *bmask,   \
      const void *starts, const void *ends, int nseg, void *stream
extern "C" int fp_segment_sum_fp128(LFZK_ARGS) {
  return fp_segment_sum<P128>(mode, out, bad, x, W, h0, h1, v, bmask, starts,
                              ends, nseg, stream);
}
extern "C" int fp_segment_sum_fp256(LFZK_ARGS) {
  return fp_segment_sum<P256>(mode, out, bad, x, W, h0, h1, v, bmask, starts,
                              ends, nseg, stream);
}
extern "C" int fp_segment_sum_fp256k1(LFZK_ARGS) {
  return fp_segment_sum<P256K1>(mode, out, bad, x, W, h0, h1, v, bmask, starts,
                                ends, nseg, stream);
}
extern "C" int fp_segment_sum_fp24(LFZK_ARGS) {
  return fp_segment_sum<FP24>(mode, out, bad, x, W, h0, h1, v, bmask, starts,
                              ends, nseg, stream);
}
extern "C" int fp_segment_sum_gf2_128(LFZK_ARGS) {
  return fp_segment_sum<G128>(mode, out, bad, x, W, h0, h1, v, bmask, starts,
                              ends, nseg, stream);
}
