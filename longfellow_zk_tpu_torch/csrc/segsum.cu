// K2 fp_segment_sum: field sums over contiguous term ranges, with an instance
// for Fp128, one each for the P-256 and secp256k1 base fields, one for
// GF(2^128) (sums by XOR, gf2.cuh), one for the ML-DSA prime (FP24, the
// per-coefficient sums of Fp24_6) and, for lazy_segment_sum alone, one
// each for Goldilocks, the P-256 and secp256k1 group orders and the P-384
// and P-521 base fields (FP24's and P521's sums may pass 2p below R, and
// fp_reduce_acc reduces them by a product).
//
// out[s] = sum over t in [starts[s], ends[s]) of term(t), where term(t) is
//   mode 0: x[t]                      (_contig_fold, lazy_segment_sum)
//   mode 1: v[t] * W[h1[t]] * W[h0[t]], or 0 where bmask[t] is set; a
//           masked term whose product W[h1] * W[h0] is nonzero sets *bad
//           (the beta-mask zero check of _eval_layer)
// over the n terms of the table (x's rows, or h0's); an empty range sums
// to zero.  Ranges may be any, in any order.
//
// Replaces sumcheck/prover_device.py:157 _contig_fold and :372
// _eval_layer (prime branch), and fields/fp.py:561 lazy_segment_sum
// (byte-split columns + segment_sum + renormalise) of the JAX package;
// for GF(2^128) its char-2 branches (prover_device.py:167-178, :383-402,
// bitplane cumsums) and fields/gf2.py:429 lazy_segment_sum.
//
// Two routes, the caller's k picks one.  The scan (k = 1 to SEG_K): the
// work does not depend on the segments' lengths; the sums are
// differences of prefix sums, as the JAX package's char-2 _eval_layer
// (an XOR prefix, gathers at the boundaries) and the plain version (limb
// cumsums) take them.  A prefix is kept exact as N 64-bit limb sums
// (fp_acc: each 32-bit limb added in; GF(2^128) XORs 32-bit words), so the
// difference of two prefixes is the segment's limb sums, which
// fp_reduce_acc reduces modulo p once.  Two launches:
//
//   k_seg_scan    thread c computes the k consecutive terms of chunk c
//                 (mode 1 also stores them, tv), the block scans its
//                 chunks' sums and stores each chunk's prefix from the
//                 block's start (cp) and its total (bt); the last block
//                 to finish (an atomic count in the call's scratch, set
//                 to zero on the call's stream before the launch) scans
//                 the totals into each block's prefix from term 0 (bp).
//   k_seg_gather  thread s: where the range lies in one chunk, the sum of
//                 its terms; else prefix(e) - prefix(s) from bp and cp,
//                 with at most k - 1 terms at each end re-read.
//
// k (1 to SEG_K) is the caller's: about n / 2^18, so that a large table
// takes few prefixes and a small one still fills the card (the H100 holds
// about 2^18 threads; fields/fp.py _k2_route).
//
// The wrapper counts the launches made: two (one where the table is
// empty) on the scan, one on the warp route.
//
// A warp a segment (k = 0), one launch: k_seg_warp, the lanes stride over
// the segment's terms, reduced by shuffles.  Where segments are short and
// bytes set the time (mode 0), or the table is small (mode 1 below 2^16
// terms a lane of a batch), it reads each term once and needs no scratch: the two passes
// and the prefixes cost more there (1.2-3.9x, tools/k2k10_bench.py).  But
// one long segment holds its warp while the card idles (a merge fold of
// 525,422 terms: 7.0 ms, against 0.074 by the scan).  The caller picks
// from what it knows: the table's size and, for mode 0, the longest
// segment (the prover knows it from its merge plan; a caller that does
// not passes none and takes this route).
//
// The prefixes are sums modulo 2^64 limb by limb: a difference is exact,
// since each limb's true sum over a range of fewer than 2^31 terms is
// below 2^63.  No sum goes through an atomic.  Mode 1 skips the product
// by v[t] where v[t] is one (a public circuit constant: 44 % of the mdoc
// hash circuit's terms); it branches on nothing of W.
//
// Bound on the H100: the bytes of the terms (mode 0; mode 1 at prime
// fields) or the products of GF(2^128) (gf2.cuh's Karatsuba: 144
// integer multiplies each).
#include <type_traits>

#include "gf2.cuh"

constexpr int SEG_K = 8;     // the most terms a thread (a chunk)
constexpr int SEG_NT = 256;  // threads a block of k_seg_scan

// A stored prefix limb: 64 bits for a prime field, 32 for GF(2^128),
// whose XOR sums never leave the low word.
template <class C>
using SegWord =
    typename std::conditional<std::is_same<C, G128>::value, uint32_t,
                              u64>::type;

template <class C>
__device__ __forceinline__ u64 acc_sub(u64 a, u64 b) {
  return a - b;
}
template <>
__device__ __forceinline__ u64 acc_sub<G128>(u64 a, u64 b) {
  return a ^ b;
}

template <class C>
__device__ __forceinline__ void seg_load(u64* acc, const SegWord<C>* p,
                                         long long i) {
#pragma unroll
  for (int j = 0; j < C::N; j++) acc[j] = __ldcg(p + i * C::N + j);
}

template <class C>
__device__ __forceinline__ void seg_store(const u64* acc, SegWord<C>* p,
                                          long long i) {
#pragma unroll
  for (int j = 0; j < C::N; j++) p[i * C::N + j] = (SegWord<C>)acc[j];
}

// The exclusive prefix of acc over the block's threads in thread order
// (into acc) and the block's total (into tot, every thread).
template <class C>
__device__ __forceinline__ void block_excl_scan(u64* acc, u64* tot) {
  constexpr int N = C::N, NW = SEG_NT / 32;
  __shared__ u64 wsum[NW][N];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  u64 own[N];
#pragma unroll
  for (int j = 0; j < N; j++) {
    own[j] = acc[j];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const u64 y = __shfl_up_sync(0xFFFFFFFFu, acc[j], off);
      if (lane >= off) acc[j] = acc_add<C>(acc[j], y);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < N; j++) wsum[w][j] = acc[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; j++) {
    u64 before = 0, all = 0;
#pragma unroll
    for (int k = 0; k < NW; k++) {
      if (k < w) before = acc_add<C>(before, wsum[k][j]);
      all = acc_add<C>(all, wsum[k][j]);
    }
    acc[j] = acc_sub<C>(acc_add<C>(acc[j], before), own[j]);
    tot[j] = all;
  }
  __syncthreads();  // wsum is reused by the next call
}

template <class C>
__device__ __forceinline__ Fp<C> seg_term(int mode, long long t,
                                          int* __restrict__ bad,
                                          const uint4* __restrict__ x,
                                          const uint4* __restrict__ W,
                                          const int* __restrict__ h0,
                                          const int* __restrict__ h1,
                                          const uint4* __restrict__ v,
                                          const unsigned char* __restrict__
                                              bmask) {
  typedef Fp<C> E;
  if (mode == 0) return E::load(x, t);
  E prod = fp_mul(E::load(W, h1[t]), E::load(W, h0[t]));
  if (bmask[t]) {
    if (!fp_is_zero(prod)) *bad = 1;
    return fp_zero<C>();
  }
  const E vt = E::load(v, t);
  if (!fp_eq(vt, fp_one<C>())) prod = fp_mul(prod, vt);
  return prod;
}

template <class C>
__global__ void __launch_bounds__(SEG_NT)
    k_seg_scan(int mode, long long n, int k, int* __restrict__ bad,
               const uint4* __restrict__ x, const uint4* __restrict__ W,
               const int* __restrict__ h0, const int* __restrict__ h1,
               const uint4* __restrict__ v,
               const unsigned char* __restrict__ bmask,
               uint4* __restrict__ tv, SegWord<C>* __restrict__ cp,
               SegWord<C>* __restrict__ bt, SegWord<C>* __restrict__ bp,
               unsigned* __restrict__ done) {
  constexpr int N = C::N;
  const long long c = (long long)blockIdx.x * SEG_NT + threadIdx.x;
  const long long t0 = c * k;
  u64 acc[N], tot[N];
#pragma unroll
  for (int j = 0; j < N; j++) acc[j] = 0;
#pragma unroll
  for (int i = 0; i < SEG_K; i++) {
    const long long t = t0 + i;
    if (i < k && t < n) {
      const Fp<C> e = seg_term<C>(mode, t, bad, x, W, h0, h1, v, bmask);
      if (mode != 0) e.store(tv, t);
      fp_acc(acc, e);
    }
  }
  block_excl_scan<C>(acc, tot);
  if (t0 < n) seg_store<C>(acc, cp, c);
  if (threadIdx.x == 0) seg_store<C>(tot, bt, blockIdx.x);

  // the last block to finish scans the blocks' totals
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1u;
  __syncthreads();
  if (!last) return;
  const int nblk = gridDim.x;
  const int per = (nblk + SEG_NT - 1) / SEG_NT;
  const int b0 = threadIdx.x * per, b1 = min(nblk, b0 + per);
#pragma unroll
  for (int j = 0; j < N; j++) acc[j] = 0;
  for (int b = b0; b < b1; b++) {
    u64 y[N];
    seg_load<C>(y, bt, b);
#pragma unroll
    for (int j = 0; j < N; j++) acc[j] = acc_add<C>(acc[j], y[j]);
  }
  block_excl_scan<C>(acc, tot);
  for (int b = b0; b < b1; b++) {
    seg_store<C>(acc, bp, b);
    u64 y[N];
    seg_load<C>(y, bt, b);
#pragma unroll
    for (int j = 0; j < N; j++) acc[j] = acc_add<C>(acc[j], y[j]);
  }
}

// acc +=, or -= (sign < 0), the terms [a, b), all in one chunk.
template <class C>
__device__ __forceinline__ void seg_add_terms(u64* acc, const uint4* terms,
                                              long long a, long long b,
                                              int sign) {
  for (long long t = a; t < b; t++) {
    const Fp<C> e = Fp<C>::load(terms, t);
#pragma unroll
    for (int j = 0; j < C::N; j++)
      acc[j] = sign > 0 ? acc_add<C>(acc[j], (u64)e.l[j])
                        : acc_sub<C>(acc[j], (u64)e.l[j]);
  }
}

// acc +=, or -=, the prefix of chunk c (the terms [0, c k)).
template <class C>
__device__ __forceinline__ void seg_add_prefix(u64* acc,
                                               const SegWord<C>* cp,
                                               const SegWord<C>* bp,
                                               long long c, int sign) {
  u64 y[C::N], z[C::N];
  seg_load<C>(y, cp, c);
  if (bp != nullptr) {
    seg_load<C>(z, bp, c / SEG_NT);
#pragma unroll
    for (int j = 0; j < C::N; j++) y[j] = acc_add<C>(y[j], z[j]);
  }
#pragma unroll
  for (int j = 0; j < C::N; j++)
    acc[j] = sign > 0 ? acc_add<C>(acc[j], y[j]) : acc_sub<C>(acc[j], y[j]);
}

template <class C>
__global__ void k_seg_gather(uint4* __restrict__ out,
                             const uint4* __restrict__ terms,
                             const SegWord<C>* __restrict__ cp,
                             const SegWord<C>* __restrict__ bp,
                             const int* __restrict__ starts,
                             const int* __restrict__ ends, int nseg,
                             int k) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  const long long a = starts[s], b = ends[s];
  u64 acc[C::N];
#pragma unroll
  for (int j = 0; j < C::N; j++) acc[j] = 0;
  if (b > a) {
    const long long ca = a / k, cb = (b - 1) / k;
    if (ca == cb) {
      seg_add_terms<C>(acc, terms, a, b, 1);
    } else {
      // prefix(b) - prefix(a), each from its chunk's prefix and the
      // chunk's terms before it (cb's chunk holds b - 1)
      seg_add_prefix<C>(acc, cp, bp, cb, 1);
      seg_add_terms<C>(acc, terms, cb * k, b, 1);
      seg_add_prefix<C>(acc, cp, bp, ca, -1);
      seg_add_terms<C>(acc, terms, ca * k, a, -1);
    }
  }
  fp_reduce_acc<C>(acc).store(out, s);
}

template <class C>
__global__ void k_seg_warp(int mode, uint4* __restrict__ out,
                           int* __restrict__ bad, const uint4* __restrict__ x,
                           const uint4* __restrict__ W,
                           const int* __restrict__ h0,
                           const int* __restrict__ h1,
                           const uint4* __restrict__ v,
                           const unsigned char* __restrict__ bmask,
                           const int* __restrict__ starts,
                           const int* __restrict__ ends, int nseg) {
  const long long seg = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (seg >= nseg) return;  // the whole warp leaves together
  u64 acc[C::N];
#pragma unroll
  for (int j = 0; j < C::N; j++) acc[j] = 0;
  const int e = ends[seg];
  for (int t = starts[seg] + lane; t < e; t += 32)
    fp_acc(acc, seg_term<C>(mode, t, bad, x, W, h0, h1, v, bmask));
  warp_sum<C>(acc);
  if (lane == 0) fp_reduce_acc<C>(acc).store(out, seg);
}

template <class C>
static int fp_segment_sum(int mode, void* out, void* bad, const void* x,
                          const void* W, const void* h0, const void* h1,
                          const void* v, const void* bmask, const void* starts,
                          const void* ends, int nseg, long long n, int k,
                          void* scratch, void* stream) {
  if (nseg <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (k == 0) {
    k_seg_warp<C><<<(unsigned)(((long long)nseg * 32 + 255) / 256), 256, 0,
                    st>>>(mode, (uint4*)out, (int*)bad, (const uint4*)x,
                          (const uint4*)W, (const int*)h0, (const int*)h1,
                          (const uint4*)v, (const unsigned char*)bmask,
                          (const int*)starts, (const int*)ends, nseg);
    return (int)cudaGetLastError();
  }
  if (k < 1 || k > SEG_K) return (int)cudaErrorInvalidValue;
  const long long nchunk = (n + k - 1) / k;
  const long long nblk = (nchunk + SEG_NT - 1) / SEG_NT;
  // scratch (fields/fp.py _segsum_scratch): cp [nchunk], bt [nblk], bp
  // [nblk] prefixes of N words, the block counter (16 bytes), then mode
  // 1's terms tv [n] at the next 16 bytes
  SegWord<C>* cp = (SegWord<C>*)scratch;
  SegWord<C>* bt = cp + nchunk * C::N;
  SegWord<C>* bp = bt + nblk * C::N;
  unsigned* done = (unsigned*)(bp + nblk * C::N);
  uint4* tv = (uint4*)((((uintptr_t)done + 16) + 15) & ~(uintptr_t)15);
  if (nblk > 0) {
    // the counter is this call's, zeroed on its stream: scans on other
    // streams do not share it
    cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return (int)err;
    k_seg_scan<C><<<(unsigned)nblk, SEG_NT, 0, st>>>(
        mode, n, k, (int*)bad, (const uint4*)x, (const uint4*)W,
        (const int*)h0, (const int*)h1, (const uint4*)v,
        (const unsigned char*)bmask, tv, cp, bt, bp, done);
  }
  k_seg_gather<C><<<(unsigned)((nseg + 255) / 256), 256, 0, st>>>(
      (uint4*)out, mode == 0 ? (const uint4*)x : tv, cp,
      nblk > 1 ? bp : nullptr, (const int*)starts, (const int*)ends, nseg,
      k);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                          \
  int mode, void *out, void *bad, const void *x, const void *W,           \
      const void *h0, const void *h1, const void *v, const void *bmask,   \
      const void *starts, const void *ends, int nseg, long long n, int k, \
      void *scratch, void *stream
#define LFZK_SEGSUM(tag, C)                                                \
  extern "C" int fp_segment_sum_##tag(LFZK_ARGS) {                        \
    return fp_segment_sum<C>(mode, out, bad, x, W, h0, h1, v, bmask,      \
                             starts, ends, nseg, n, k, scratch, stream);  \
  }
LFZK_SEGSUM(fp128, P128)
LFZK_SEGSUM(fp256, P256)
LFZK_SEGSUM(fp256k1, P256K1)
LFZK_SEGSUM(fp24, FP24)
LFZK_SEGSUM(gf2_128, G128)
LFZK_SEGSUM(fp64, FP64)
LFZK_SEGSUM(p256n, P256N)
LFZK_SEGSUM(p256k1n, P256K1N)
LFZK_SEGSUM(p384, P384)
LFZK_SEGSUM(p521, P521)
