// K4 fp_ntt: radix-2 number-theoretic transform on a batch of rows of
// length n = 2^logn, with an instance over Fp128, one over Fp2 on the
// P-256 base field (Fp2 twiddles and Fp2 butterflies in the same body)
// and one over the multi-prime field of the CRT convolution ([crt],
// mp.cuh), whose rows come in lanes of `lane_rows` rows, lane b a row of
// residues modulo the basis prime p_b with its own twiddle table.
//
// Replaces NTT._transform of the JAX package
// (longfellow_zk_tpu/transforms/ntt.py:94): bit reversal, then logn
// butterfly stages; stage s (half-size h = 2^s) pairs x[2h blk + j] with
// x[2h blk + j + h] under the twiddle tw[h - 1 + j] (the stage tables of
// NTT._stage_tables, concatenated: tw[n/2 - 1 + e] = w^e for e < n/2).
// It serves FFTConvolution and, over Fp2, FFTExtConvolution (ntt.py:178,
// :284): the Reed-Solomon extend of the Ligero commit (rows of n =
// 2048); [crt] the same _transform over MultiPrimeField
// (fields/multiprime.py) in transforms/crt_conv.py CRTConvolution, 4,096
// points on each of 18 residue lanes of the secp256k1 tableau's 25 rows.
//
// Bound on the H100: the bytes (each row read and written once) at the
// slices' sizes, and launch latency: 18 rows of 2,048 Fp128 elements are
// 576 KiB, 14 rows of 2,048 Fp2 elements 1.75 MiB, the [crt] tableau
// 7.4 MB.  The design keeps a row on chip through all of its stages, one
// launch a transform (two where a row does not fit), with the row's
// n = n1 n2 points seen as an n1 x n2 matrix, x[n2 k1 + k2] (the
// four-step split):
//
//   A. each column k2: its n1-point transform over k1 (root w^n2), times
//      the twiddle w^(j1 k2): Z[j1, k2];
//   B. each row j1 of Z: its n2-point transform over k2 (root w^n1),
//      written to y[j1 + n1 j2].
//
// Route 1, one launch: a row a thread block cluster of cs = 2^lcs blocks
// (cs = 1: a row a block, l1 = 0, and step A vanishes).  Block c of the
// cluster runs step A on columns [c n2 / cs, (c + 1) n2 / cs) into its
// shared memory, the cluster syncs, and the block runs step B on rows
// [c n1 / cs, (c + 1) n1 / cs), reading Z from the cluster's blocks
// (distributed shared memory).  Route 2, two launches through a scratch
// Z in device memory (a row that a cluster cannot hold): k_ntt_cols runs
// step A on 2^lta columns a block, k_ntt_rows step B on 2^ltb rows a
// block.  transforms/ntt.py ntt_plan picks the route and its sizes.
//
// Within a block the transforms run on tiles in shared memory: the load
// puts element k of a sequence of 2^l at brev_l(k) (bit reversal folded
// into the load, __brev), then l radix-2 stages with __syncthreads()
// between them, a butterfly a thread at a time in block-strided loops;
// 32-bit indices and no division (two stages a pass in registers, with
// the reversal on the read side, ran 2.1x slower at 14 x 2,048 Fp2
// points on the H100: PERF.md section 6).  The stage twiddles of a
// sub-transform of 2^l points are tw[0 .. 2^l - 1) (its stage h reads
// tw[h - 1 + j] = w^(j n / 2h)), copied once a block into shared memory
// where they fit (tw_smem), else read through L1/L2; step A's twiddles
// w^(j1 k2) are read from tw[n/2 - 1 ..] (negated past n/2).
#include <cooperative_groups.h>

#include "fp.cuh"
#include "mp.cuh"

namespace cg = cooperative_groups;

constexpr int NTT_THREADS = 256;
// the dynamic shared memory a block may opt into on the H100
constexpr int NTT_SMEM_OPTIN = 232448;

// A field as the transform sees it: Fp<C> or Fp2<C> (fp.cuh) ...
template <class E>
struct NttF {
  typedef E T;
  static constexpr int BYTES = sizeof(E);
  __device__ static NttF lane(long long) { return NttF(); }
  __device__ static E ld(const void* a, uint32_t i) {
    return E::load((const uint4*)a, i);
  }
  __device__ static void st(void* a, uint32_t i, const E& v) {
    v.store((uint4*)a, i);
  }
  __device__ E add(const E& a, const E& b) const { return fp_add(a, b); }
  __device__ E sub(const E& a, const E& b) const { return fp_sub(a, b); }
  __device__ E mul(const E& a, const E& b) const { return fp_mul(a, b); }
};

// ... or one 32-bit prime lane of the multi-prime field (mp.cuh)
struct NttMp {
  typedef uint32_t T;
  static constexpr int BYTES = 4;
  uint32_t p, n0inv;
  __device__ static NttMp lane(long long b) {
    const MpPrime c = MP_PRIMES[b];
    NttMp o;
    o.p = c.p;
    o.n0inv = c.n0inv;
    return o;
  }
  __device__ static T ld(const void* a, uint32_t i) {
    return ((const uint32_t*)a)[i];
  }
  __device__ static void st(void* a, uint32_t i, T v) {
    ((uint32_t*)a)[i] = v;
  }
  __device__ T add(T a, T b) const { return mp_add(a, b, p); }
  __device__ T sub(T a, T b) const { return mp_sub(a, b, p); }
  __device__ T mul(T a, T b) const { return mp_mul(a, b, p, n0inv); }
};

__device__ __forceinline__ uint32_t brev(uint32_t k, int l) {
  return l ? __brev(k) >> (32 - l) : 0u;
}

// The radix-2 stages of `count` transforms of 2^lm points in shared
// memory, each loaded in bit-reversed order; element k of transform d at
// buf[k se + d sd].  Ends with a __syncthreads().
template <class O>
__device__ void ntt_stages(const O& o, void* buf, int lm, uint32_t count,
                           uint32_t se, uint32_t sd, const void* tw) {
  if (lm == 0) return;
  const uint32_t hm = 1u << (lm - 1), nb = count << (lm - 1);
  for (int s = 0; s < lm; s++) {
    const uint32_t h = 1u << s;
    for (uint32_t b = threadIdx.x; b < nb; b += blockDim.x) {
      const uint32_t d = b >> (lm - 1), q = b & (hm - 1), j = q & (h - 1);
      const uint32_t a0 = (((q >> s) << (s + 1)) + j) * se + d * sd;
      const uint32_t a1 = a0 + h * se;
      const typename O::T lo = O::ld(buf, a0);
      typename O::T t = O::ld(buf, a1);
      if (s) t = o.mul(t, O::ld(tw, h - 1 + j));
      O::st(buf, a0, o.add(lo, t));
      O::st(buf, a1, o.sub(lo, t));
    }
    __syncthreads();
  }
}

// Step A on the 2^lcol columns from k2base of row xr (the n1 x n2 view,
// n1 = 2^l1, n2 = 2^l2): into A [n1][2^lcol], element (j1, kl) at
// j1 2^lcol + kl, each column's transform times w^(j1 k2).  tws: the
// sub-transforms' stage twiddles; twg: the lane's whole table.
template <class O>
__device__ void ntt_cols(const O& o, void* A, const void* xr, int l1, int l2,
                         int lcol, uint32_t k2base, const void* tws,
                         const void* twg) {
  const uint32_t ncol = 1u << lcol, ne = ncol << l1;
  const uint32_t hn = 1u << (l1 + l2 - 1);
  for (uint32_t e = threadIdx.x; e < ne; e += blockDim.x) {
    const uint32_t k1 = e >> lcol, kl = e & (ncol - 1);
    O::st(A, (brev(k1, l1) << lcol) + kl,
          O::ld(xr, (k1 << l2) + k2base + kl));
  }
  __syncthreads();
  ntt_stages(o, A, l1, ncol, ncol, 1u, tws);
  for (uint32_t e = threadIdx.x; e < ne; e += blockDim.x) {
    const uint32_t ex = (e >> lcol) * (k2base + (e & (ncol - 1)));  // < n
    if (ex == 0) continue;
    typename O::T v =
        o.mul(O::ld(A, e), O::ld(twg, hn - 1 + (ex & (hn - 1))));
    if (ex >= hn) v = o.sub(o.sub(v, v), v);  // w^(n/2) = -1
    O::st(A, e, v);
  }
  __syncthreads();
}

// Step B on B [2^lrow][n2], rows loaded bit-reversed: each row's
// transform, written to yr[j1 + n1 j2] for the block's rows j1 = j1base +
// jl.
template <class O>
__device__ void ntt_rows_out(const O& o, void* B, void* yr, int l1, int l2,
                             int lrow, uint32_t j1base, const void* tws) {
  const uint32_t nrow = 1u << lrow, ne = nrow << l2;
  ntt_stages(o, B, l2, nrow, 1u, 1u << l2, tws);
  for (uint32_t e = threadIdx.x; e < ne; e += blockDim.x) {
    const uint32_t jl = e & (nrow - 1), j2 = e >> lrow;
    O::st(yr, j1base + jl + (j2 << l1), O::ld(B, (jl << l2) + j2));
  }
}

// Copies the first m - 1 stage twiddles into T (shared memory); the
// caller's next __syncthreads() publishes them.
template <class O>
__device__ void twiddles_to_smem(void* T, const void* twg, uint32_t m) {
  for (uint32_t i = threadIdx.x; i + 1 < m; i += blockDim.x)
    O::st(T, i, O::ld(twg, i));
}

__host__ __device__ inline size_t ntt_align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// Route 1: grid rows << lcs, clusters of 2^lcs blocks; block c of row r.
template <class O>
__global__ void __launch_bounds__(NTT_THREADS)
    k_ntt_row(uint4* __restrict__ y, const uint4* __restrict__ x,
              const uint4* __restrict__ tw, long long lane_rows, int logn,
              int l1, int lcs, int tw_smem) {
  extern __shared__ uint4 sm[];
  const int l2 = logn - l1;
  const uint32_t n = 1u << logn, blk = n >> lcs;
  const uint32_t c = blockIdx.x & ((1u << lcs) - 1);
  const long long r = blockIdx.x >> lcs, lane = r / lane_rows;
  const O o = O::lane(lane);
  const char* twg = (const char*)tw + (size_t)lane * (n - 1) * O::BYTES;
  const char* xr = (const char*)x + (size_t)r * n * O::BYTES;
  char* yr = (char*)y + (size_t)r * n * O::BYTES;
  char* A = (char*)sm;  // lcs > 0: [n1][n2 / cs]
  char* B = A + (lcs ? ntt_align16((size_t)blk * O::BYTES) : 0);
  const void* tws = twg;
  if (tw_smem) {
    char* T = B + ntt_align16((size_t)blk * O::BYTES);
    twiddles_to_smem<O>(T, twg, 1u << (l1 > l2 ? l1 : l2));
    tws = T;
  }
  if (lcs == 0) {  // a row a block (l1 = 0)
    for (uint32_t e = threadIdx.x; e < n; e += blockDim.x)
      O::st(B, brev(e, logn), O::ld(xr, e));
    __syncthreads();
    ntt_rows_out(o, B, yr, 0, logn, 0, 0u, tws);
    return;
  }
  const int lcol = l2 - lcs, lrow = l1 - lcs;
  ntt_cols(o, A, xr, l1, l2, lcol, c << lcol, tws, twg);
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const uint32_t j1base = c << lrow, cmask = (1u << lcol) - 1;
  for (uint32_t e = threadIdx.x; e < blk; e += blockDim.x) {
    const uint32_t jl = e >> l2, k2 = e & ((1u << l2) - 1);
    const char* Ao = cl.map_shared_rank(A, k2 >> lcol);
    O::st(B, (jl << l2) + brev(k2, l2),
          O::ld(Ao, ((j1base + jl) << lcol) + (k2 & cmask)));
  }
  // every block's reads of the others' A done before any block moves on
  // (and exits)
  cl.sync();
  ntt_rows_out(o, B, yr, l1, l2, lrow, j1base, tws);
}

// Route 2, launch 1: grid rows << (l2 - lta); block g of row r takes
// columns [g 2^lta, (g + 1) 2^lta) into z.
template <class O>
__global__ void __launch_bounds__(NTT_THREADS)
    k_ntt_cols(uint4* __restrict__ z, const uint4* __restrict__ x,
               const uint4* __restrict__ tw, long long lane_rows, int logn,
               int l1, int lta, int tw_smem) {
  extern __shared__ uint4 sm[];
  const int l2 = logn - l1, lg = l2 - lta;
  const uint32_t n = 1u << logn, g = blockIdx.x & ((1u << lg) - 1);
  const long long r = blockIdx.x >> lg, lane = r / lane_rows;
  const O o = O::lane(lane);
  const char* twg = (const char*)tw + (size_t)lane * (n - 1) * O::BYTES;
  char* A = (char*)sm;
  const void* tws = twg;
  if (tw_smem) {
    char* T = A + ntt_align16((size_t)O::BYTES << (l1 + lta));
    twiddles_to_smem<O>(T, twg, 1u << l1);
    tws = T;
  }
  ntt_cols(o, A, (const char*)x + (size_t)r * n * O::BYTES, l1, l2, lta,
           g << lta, tws, twg);
  char* zr = (char*)z + (size_t)r * n * O::BYTES;
  const uint32_t ncol = 1u << lta;
  for (uint32_t e = threadIdx.x; e < (ncol << l1); e += blockDim.x)
    O::st(zr, ((e >> lta) << l2) + (g << lta) + (e & (ncol - 1)),
          O::ld(A, e));
}

// Route 2, launch 2: grid rows << (l1 - ltb); block g of row r takes rows
// j1 in [g 2^ltb, (g + 1) 2^ltb) of z.
template <class O>
__global__ void __launch_bounds__(NTT_THREADS)
    k_ntt_rows(uint4* __restrict__ y, const uint4* __restrict__ z,
               const uint4* __restrict__ tw, long long lane_rows, int logn,
               int l1, int ltb, int tw_smem) {
  extern __shared__ uint4 sm[];
  const int l2 = logn - l1, lg = l1 - ltb;
  const uint32_t n = 1u << logn, g = blockIdx.x & ((1u << lg) - 1);
  const long long r = blockIdx.x >> lg, lane = r / lane_rows;
  const O o = O::lane(lane);
  const char* twg = (const char*)tw + (size_t)lane * (n - 1) * O::BYTES;
  char* B = (char*)sm;
  const void* tws = twg;
  if (tw_smem) {
    char* T = B + ntt_align16((size_t)O::BYTES << (ltb + l2));
    twiddles_to_smem<O>(T, twg, 1u << l2);
    tws = T;
  }
  const char* zr = (const char*)z + (size_t)r * n * O::BYTES;
  const uint32_t j1base = g << ltb, ne = 1u << (ltb + l2);
  for (uint32_t e = threadIdx.x; e < ne; e += blockDim.x) {
    const uint32_t jl = e >> l2, k2 = e & ((1u << l2) - 1);
    O::st(B, (jl << l2) + brev(k2, l2),
          O::ld(zr, ((j1base + jl) << l2) + k2));
  }
  __syncthreads();
  ntt_rows_out(o, B, (char*)y + (size_t)r * n * O::BYTES, l1, l2, ltb,
               j1base, tws);
}

template <class K>
static int ntt_optin(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, NTT_SMEM_OPTIN);
}

// y, x (and the scratch z, route 2): [rows, 2^logn] elements, y != x; tw:
// 2^logn - 1 elements a lane (the rows come in lanes of lane_rows rows;
// one lane but for [crt]).  The plan (transforms/ntt.py ntt_plan): route
// 1 with l1 and lcs (one launch), route 2 with l1, lta and ltb (two);
// threads a block; tw_smem: the stage twiddles in shared memory.
// Returns the first nonzero CUDA error.
template <class O>
static int ntt(void* y, const void* x, const void* tw, void* z,
               long long rows, int logn, long long lane_rows, int route,
               int l1, int la, int lb, int threads, int tw_smem,
               void* stream) {
  const int l2 = logn - l1;
  if (logn < 1 || logn > 30 || rows <= 0 || lane_rows <= 0 || l1 < 0 ||
      l2 < 0 || threads < 32 || threads > NTT_THREADS ||
      rows > ((long long)1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t B = O::BYTES;
  if (route == 1) {
    const int lcs = la;
    if (lcs < 0 || lcs > 3 || (lcs == 0 && l1 != 0) ||
        (lcs > 0 && (l1 < lcs || l2 < lcs)))
      return (int)cudaErrorInvalidValue;
    const size_t blk = ntt_align16((B << logn) >> lcs);
    const size_t smem = (lcs ? 2 : 1) * blk +
        (tw_smem ? ((size_t)1 << (l1 > l2 ? l1 : l2)) * B : 0);
    int e = ntt_optin(k_ntt_row<O>, smem);
    if (e) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(rows << lcs));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1u << lcs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = lcs ? 1 : 0;
    e = (int)cudaLaunchKernelEx(&cfg, k_ntt_row<O>, (uint4*)y,
                                (const uint4*)x, (const uint4*)tw, lane_rows,
                                logn, l1, lcs, tw_smem);
    return e ? e : (int)cudaGetLastError();
  }
  if (route != 2 || la < 0 || la > l2 || lb < 0 || lb > l1 || z == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t sa = ntt_align16(B << (l1 + la)) +
                    (tw_smem ? ((size_t)1 << l1) * B : 0);
  const size_t sb = ntt_align16(B << (lb + l2)) +
                    (tw_smem ? ((size_t)1 << l2) * B : 0);
  int e = ntt_optin(k_ntt_cols<O>, sa);
  if (e) return e;
  e = ntt_optin(k_ntt_rows<O>, sb);
  if (e) return e;
  k_ntt_cols<O><<<(unsigned)(rows << (l2 - la)), threads, sa, st>>>(
      (uint4*)z, (const uint4*)x, (const uint4*)tw, lane_rows, logn, l1, la,
      tw_smem);
  e = (int)cudaGetLastError();
  if (e) return e;
  k_ntt_rows<O><<<(unsigned)(rows << (l1 - lb)), threads, sb, st>>>(
      (uint4*)y, (const uint4*)z, (const uint4*)tw, lane_rows, logn, l1, lb,
      tw_smem);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                         \
  void *y, const void *x, const void *tw, void *z, long long rows,        \
      int logn, long long lane_rows, int route, int l1, int la, int lb,   \
      int threads, int tw_smem, void *stream
#define LFZK_PASS                                                         \
  y, x, tw, z, rows, logn, lane_rows, route, l1, la, lb, threads, tw_smem, \
      stream

extern "C" int fp_ntt_fp128(LFZK_ARGS) {
  return ntt<NttF<Fp<P128> > >(LFZK_PASS);
}

extern "C" int fp_ntt_fp256x2(LFZK_ARGS) {
  return ntt<NttF<Fp2<P256> > >(LFZK_PASS);
}

extern "C" int fp_ntt_crt(LFZK_ARGS) {
  if (rows > lane_rows * MP_MAX) return (int)cudaErrorInvalidValue;
  return ntt<NttMp>(LFZK_PASS);
}
