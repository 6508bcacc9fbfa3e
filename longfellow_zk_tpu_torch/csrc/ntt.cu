// K4 fp_ntt: radix-2 number-theoretic transform on a batch of rows of
// length n = 2^logn, with an instance over Fp128, one over Fp2 on the
// P-256 base field (Fp2 twiddles and Fp2 butterflies in the same body)
// and one over the multi-prime field of the CRT convolution ([crt],
// mp.cuh), whose rows come in lanes of `lane_rows` rows, lane b a row of
// residues modulo the basis prime p_b with its own twiddle table.
//
// Replaces NTT._transform of the JAX package
// (longfellow_zk_tpu/transforms/ntt.py:94): bit reversal, then logn
// butterfly stages; stage s (half-size m = 2^s) pairs x[2m*blk + j] with
// x[2m*blk + j + m] under the twiddle tw[m - 1 + j] (the stage tables of
// NTT._stage_tables, concatenated).  It serves FFTConvolution and, over
// Fp2, FFTExtConvolution (ntt.py:178, :284): the Reed-Solomon extend of
// the Ligero commit (rows of n = 2048).
//
// Bound on the H100: launch latency at the slices' sizes (18 rows of 2048
// Fp128 elements are 576 KiB, 14 rows of 2048 Fp2 elements 1.75 MiB:
// 0.2-0.5 us of memory traffic per stage).  The design is the simple
// one: one launch per stage, one butterfly per thread, the whole array in
// device memory (it stays in L2).  The first launch folds the bit
// reversal (by __brev, no table) into stage 0, which needs no twiddle.
//
// [crt] replaces the same _transform run over MultiPrimeField
// (longfellow_zk_tpu/fields/multiprime.py): the forward and backward
// transforms of transforms/crt_conv.py CRTConvolution, 4,096-point on each
// of 18 residue lanes of the secp256k1 tableau's 25 rows (7.4 MB).  A
// butterfly is one 32 x 32-bit Montgomery product (2 multiplies and a
// high half) on 16 bytes, so it is bound by its bytes like the others;
// the lane's p and n0inv come from the __constant__ table of mp.cuh,
// indexed by row / lane_rows (one lane a warp, in practice).
#include "fp.cuh"
#include "mp.cuh"

template <class E>
__global__ void k_ntt_first(uint4* __restrict__ y, const uint4* __restrict__ x,
                            long long rows, int logn) {
  long long half = 1LL << (logn - 1);
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * half) return;
  long long r = idx / half, k = idx - r * half;
  long long base = r * (half * 2);
  unsigned j0 = __brev((unsigned)(2 * k)) >> (32 - logn);
  unsigned j1 = __brev((unsigned)(2 * k + 1)) >> (32 - logn);
  E lo = E::load(x, base + j0);
  E hi = E::load(x, base + j1);
  fp_add(lo, hi).store(y, base + 2 * k);
  fp_sub(lo, hi).store(y, base + 2 * k + 1);
}

template <class E>
__global__ void k_ntt_stage(uint4* __restrict__ y, const uint4* __restrict__ tw,
                            long long rows, int logn, int s) {
  long long half = 1LL << (logn - 1);
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * half) return;
  long long r = idx / half, k = idx - r * half;
  long long m = 1LL << s;
  long long blk = k >> s, j = k & (m - 1);
  long long i0 = r * (half * 2) + blk * 2 * m + j;
  long long i1 = i0 + m;
  E lo = E::load(y, i0);
  E t = fp_mul(E::load(y, i1), E::load(tw, m - 1 + j));
  fp_add(lo, t).store(y, i0);
  fp_sub(lo, t).store(y, i1);
}

__global__ void k_ntt_first_mp(uint32_t* __restrict__ y,
                               const uint32_t* __restrict__ x, long long rows,
                               int logn, long long lane_rows) {
  long long half = 1LL << (logn - 1);
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * half) return;
  long long r = idx / half, k = idx - r * half;
  uint32_t p = MP_PRIMES[r / lane_rows].p;
  long long base = r * (half * 2);
  unsigned j0 = __brev((unsigned)(2 * k)) >> (32 - logn);
  unsigned j1 = __brev((unsigned)(2 * k + 1)) >> (32 - logn);
  uint32_t lo = x[base + j0], hi = x[base + j1];
  y[base + 2 * k] = mp_add(lo, hi, p);
  y[base + 2 * k + 1] = mp_sub(lo, hi, p);
}

__global__ void k_ntt_stage_mp(uint32_t* __restrict__ y,
                               const uint32_t* __restrict__ tw, long long rows,
                               int logn, int s, long long lane_rows) {
  long long half = 1LL << (logn - 1);
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * half) return;
  long long r = idx / half, k = idx - r * half;
  long long lane = r / lane_rows;
  MpPrime c = MP_PRIMES[lane];
  long long m = 1LL << s;
  long long blk = k >> s, j = k & (m - 1);
  long long i0 = r * (half * 2) + blk * 2 * m + j;
  long long i1 = i0 + m;
  uint32_t lo = y[i0];
  uint32_t t = mp_mul(y[i1], tw[lane * (2 * half - 1) + m - 1 + j], c.p,
                      c.n0inv);
  y[i0] = mp_add(lo, t, c.p);
  y[i1] = mp_sub(lo, t, c.p);
}

// y, x: [rows, 2^logn] elements (y != x); tw: 2^logn - 1 elements a lane
// (the rows come in lanes of lane_rows rows; one lane but for [crt]).
// Returns the first nonzero cudaGetLastError() of the logn launches.
template <class E>
static int ntt(void* y, const void* x, const void* tw, long long rows,
               int logn, void* stream) {
  if (logn <= 0 || rows <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  long long work = rows * (1LL << (logn - 1));
  unsigned blocks = (unsigned)((work + threads - 1) / threads);
  k_ntt_first<E><<<blocks, threads, 0, st>>>((uint4*)y, (const uint4*)x,
                                             rows, logn);
  int e = (int)cudaGetLastError();
  for (int s = 1; s < logn && e == 0; s++) {
    k_ntt_stage<E><<<blocks, threads, 0, st>>>((uint4*)y, (const uint4*)tw,
                                               rows, logn, s);
    e = (int)cudaGetLastError();
  }
  return e;
}

#define LFZK_ARGS                                                        \
  void *y, const void *x, const void *tw, long long rows, int logn,     \
      long long lane_rows, void *stream

extern "C" int fp_ntt_fp128(LFZK_ARGS) {
  return ntt<Fp<P128> >(y, x, tw, rows, logn, stream);
}

extern "C" int fp_ntt_fp256x2(LFZK_ARGS) {
  return ntt<Fp2<P256> >(y, x, tw, rows, logn, stream);
}

extern "C" int fp_ntt_crt(LFZK_ARGS) {
  if (logn <= 0 || rows <= 0) return 0;
  if (lane_rows <= 0 || rows > lane_rows * MP_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  long long work = rows * (1LL << (logn - 1));
  unsigned blocks = (unsigned)((work + threads - 1) / threads);
  k_ntt_first_mp<<<blocks, threads, 0, st>>>(
      (uint32_t*)y, (const uint32_t*)x, rows, logn, lane_rows);
  int e = (int)cudaGetLastError();
  for (int s = 1; s < logn && e == 0; s++) {
    k_ntt_stage_mp<<<blocks, threads, 0, st>>>(
        (uint32_t*)y, (const uint32_t*)tw, rows, logn, s, lane_rows);
    e = (int)cudaGetLastError();
  }
  return e;
}
