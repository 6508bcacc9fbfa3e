// K6 gf2_lch14: the LCH14 additive FFT over GF(2^128) and the Reed-Solomon
// extend of the hash half's Ligero tableau, one CTA per row.
//
// Replaces the JAX package's transforms/lch14.py: LCH14._stage (:148),
// fft (:195), ifft (:205), bidirectional_fft (:216), _butterflies (:228),
// _bidir (:254), LCH14ReedSolomon.interpolate (:298), mul_const_bits
// (:96) and the bit packing (:43, :60).  On the TPU a stage is one int8
// parity matmul by the bits of the twiddles (a product by a constant is
// GF(2)-linear); here a butterfly takes the general GF(2^128) product of
// gf2.cuh:
//   kind 0 forward   lo ^= tw * hi;  hi ^= lo
//   kind 1 backward  hi ^= lo;       lo ^= tw * hi
//   kind 2 diagonal  lo ^= tw * hi;  hi ^= lo (old lo)
//
// The host flattens the transform (transforms/lch14.py Schedule): passes
// of independent butterflies (lo, hi, twiddle index), each of one kind,
// and a twiddle table.  The CTA holds its row in shared memory through
// every pass (__syncthreads between passes):
//   mode 0 (transform)  the fftn-element row; every pass; written back.
//   mode 1 (extend)     the row's n values, zero-padded to fftn; passes
//                       [0, nfirst) are the bidirectional FFT; out[0, n)
//                       is the input, out[n, min(m, fftn)) the new values;
//                       the n coefficients (zero-padded) are copied to
//                       ncos more segments of fftn, whose coset FFTs are
//                       passes [nfirst, npass), all cosets in each pass;
//                       segment c gives out[c fftn, ...).
// Shared memory: (1 + ncos) * fftn * 16 bytes (73,728 at n = 461 and
// 81,920 at n = 921 for m = 4151).
//
// Bound on the H100: operations.  The bytes are one read of the rows and
// one write of the code words; each row's roughly (1 + ncos) (fftn / 2)
// log2(fftn) butterflies cost a product (gf2.cuh's Karatsuba: 144
// integer multiplies) each.  266 rows give 266 CTAs on 132 SMs.
#include "gf2.cuh"

typedef Fp<G128> E;

__device__ __forceinline__ void run_pass(uint4* sm, const int4* bf,
                                         const uint4* tw, int4 ps) {
  for (int t = ps.x + threadIdx.x; t < ps.y; t += blockDim.x) {
    int4 r = bf[t];
    E lo = E::load(sm, r.x), hi = E::load(sm, r.y), w = E::load(tw, r.z);
    if (ps.z == 0) {
      lo = fp_add(lo, fp_mul(w, hi));
      hi = fp_add(hi, lo);
    } else if (ps.z == 1) {
      hi = fp_add(hi, lo);
      lo = fp_add(lo, fp_mul(w, hi));
    } else {
      E t2 = fp_mul(w, hi);
      hi = fp_add(hi, lo);
      lo = fp_add(lo, t2);
    }
    lo.store(sm, r.x);
    hi.store(sm, r.y);
  }
}

__global__ void k_lch14(int mode, uint4* __restrict__ out,
                        const uint4* __restrict__ y,
                        const int4* __restrict__ bf,
                        const uint4* __restrict__ tw,
                        const int4* __restrict__ passes, int nfirst,
                        int npass, int n, int m, int fftn, int ncos) {
  extern __shared__ uint4 sm[];
  const long long row = blockIdx.x;
  const uint4* yr = y + row * n;
  uint4* outr = out + row * m;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int j = threadIdx.x; j < fftn; j += blockDim.x) {
    uint4 v = zero;
    if (j < n) {
      v = yr[j];
      if (mode == 1) outr[j] = v;
    }
    sm[j] = v;
  }
  __syncthreads();
  for (int p = 0; p < nfirst; p++) {
    run_pass(sm, bf, tw, passes[p]);
    __syncthreads();
  }
  if (mode == 0) {
    for (int j = threadIdx.x; j < fftn; j += blockDim.x) outr[j] = sm[j];
    return;
  }
  const int e0 = min(m, fftn);
  for (int j = threadIdx.x; j < fftn; j += blockDim.x) {
    uint4 c = sm[j];
    if (j >= n && j < e0) outr[j] = c;
    if (j >= n) c = zero;
    for (int k = 1; k <= ncos; k++) sm[k * fftn + j] = c;
  }
  __syncthreads();
  for (int p = nfirst; p < npass; p++) {
    run_pass(sm, bf, tw, passes[p]);
    __syncthreads();
  }
  for (int k = 1; k <= ncos; k++) {
    const int b = k * fftn, take = min(fftn, m - b);
    for (int j = threadIdx.x; j < take; j += blockDim.x)
      outr[b + j] = sm[b + j];
  }
}

extern "C" int gf2_lch14_gf2_128(int mode, void* out, const void* y,
                                 const void* bf, const void* tw,
                                 const void* passes, int nfirst, int npass,
                                 int rows, int n, int m, int fftn, int ncos,
                                 void* stream) {
  if (rows <= 0) return 0;
  const int threads = 512;
  const size_t smem = (size_t)(1 + ncos) * fftn * sizeof(uint4);
  cudaError_t e = cudaFuncSetAttribute(
      k_lch14, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k_lch14<<<rows, threads, smem, (cudaStream_t)stream>>>(
      mode, (uint4*)out, (const uint4*)y, (const int4*)bf, (const uint4*)tw,
      (const int4*)passes, nfirst, npass, n, m, fftn, ncos);
  return (int)cudaGetLastError();
}
