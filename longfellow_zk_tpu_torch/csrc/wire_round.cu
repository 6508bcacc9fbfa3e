// K3 fp_wire_round: the sums of one sumcheck wire round, and field sums along
// an axis, with an instance for Fp128, one each for the P-256 and secp256k1
// base fields, one for GF(2^128) (sums by XOR, -1 = 1; gf2.cuh), one
// for the ML-DSA prime (FP24: Fp24_6.lazy_sum, fields/fp24.py:270, is
// mode 1 over its six coefficient planes) and, for lazy_sum (mode 1)
// alone, one each for Goldilocks, the P-256 and secp256k1 group orders
// and the P-384 and P-521 base fields.
//
// mode 0 (wire): for one hand, with z = hv[t] * Wo[ho[t]],
//   out[0] = a0 = sum over t with h[t] even of z * Wh[h[t]]
//   out[1] = a2 = sum over t of (h[t] odd ? 1 : -1) * z * (Wh[h|1] - Wh[h&~1])
//   in A lanes (the proofs of a batch): hv [A, T], Wh [A, R], Wo [A, B]
//   and out [A, 2] per lane, h and ho shared; the grid is (nblk, A), the
//   partials are per (lane, block) and k_finish sums each lane's own;
// mode 1 (sum): x viewed as [A, R, B]; out[a, b] = sum over r of x[a, r, b].
//
// Replaces the JAX package's _wire_scan.one_hand round sums
// (sumcheck/prover_device.py:571-584) and PrimeField.lazy_sum
// (fields/fp.py:555, byte-split columns + _renormalize), which also
// computes bound_quad (prover_device.py:692) and the Ligero row sums;
// for GF(2^128) the same functions over it and fields/gf2.py:424
// lazy_sum; with lanes, the jax.vmap of the batch prover over them
// (zk/batch.py:301, :344).
//
// Bound on the H100: bytes (per term three indices' worth of gathers and
// one hv read), at sizes where launch latency dominates; at GF(2^128) the
// products (below).  The reduction is the two-pass one of reduce.cuh
// (per-block partials, then k_finish): exact and without atomics.
//
// GF(2^128), mode 0 (k_wire_g128): -1 = 1, so with u = Wh[h] and its
// sibling v = Wh[h ^ 1], a2 sums z (u ^ v) over every term and a0 sums
// z u over the terms whose h is even.  A term takes z = hv[t] Wo[ho[t]],
// the one product that is reduced, and splits z once (gf2.cuh
// g128_split) for the two products z Wh[h & ~1] and z Wh[h | 1], which
// stay unreduced (8 words) in the thread's XOR accumulators: a0 gets the
// first where h is even, a2 both.  Each thread folds its two sums once at
// the end (the fold is GF(2)-linear), then the block sums them.  The
// even-h product runs for every term: where a warp's terms mix even and
// odd h, a branch would run it all the same.  Two blocks an SM (128
// registers a thread): the wrapper's nblk of 264 fills the card.
#include <type_traits>

#include "reduce.cuh"

// One term of k_wire_g128 into the unreduced sums s0 (a0) and s2 (a2).
__device__ __forceinline__ void g128_wire_term(const Fp<G128>& hv,
                                               const Fp<G128>& wo,
                                               const Fp<G128>& wlo,
                                               const Fp<G128>& whi, int hh,
                                               uint32_t s0[8],
                                               uint32_t s2[8]) {
  G128Split zs;
  g128_split(fp_mul(hv, wo), zs);
  uint32_t plo[8], phi[8];
  g128_clmul(zs, wlo, plo);
  g128_clmul(zs, whi, phi);
  const uint32_t even = (hh & 1) ? 0u : 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    s0[j] ^= plo[j] & even;
    s2[j] ^= plo[j] ^ phi[j];
  }
}

// grid (nblk, lanes): block (x, lane) takes a slice of lane's terms.
template <class C>
__global__ void k_wire_partial(const uint4* __restrict__ hv,
                               const uint4* __restrict__ Wh,
                               const uint4* __restrict__ Wo,
                               const int* __restrict__ h,
                               const int* __restrict__ ho, long long T,
                               long long nh, long long no,
                               u64* __restrict__ partial) {
  typedef Fp<C> E;
  constexpr int N = C::N;
  const long long lane = blockIdx.y;
  const long long hv0 = lane * T, wh0 = lane * nh, wo0 = lane * no;
  u64 a0[N], a2[N];
#pragma unroll
  for (int j = 0; j < N; j++) a0[j] = a2[j] = 0;
  for (long long t = (long long)blockIdx.x * NT + threadIdx.x; t < T;
       t += (long long)gridDim.x * NT) {
    int hh = h[t];
    E z = fp_mul(E::load(hv, hv0 + t), E::load(Wo, wo0 + ho[t]));
    E whi = E::load(Wh, wh0 + (hh | 1));
    E wlo = E::load(Wh, wh0 + (hh & ~1));
    E zd = fp_mul(z, fp_sub(whi, wlo));
    if (hh & 1) {
      fp_acc(a2, zd);
    } else {
      fp_acc(a0, fp_mul(z, wlo));
      fp_acc(a2, fp_neg(zd));
    }
  }
  // lane's outputs are 2 lane and 2 lane + 1 (k_finish: output o's
  // partials at o * nblk)
  const long long o = 2 * lane * gridDim.x;
  block_sum<C>(a0, partial + N * (o + blockIdx.x));
  block_sum<C>(a2, partial + N * (o + gridDim.x + blockIdx.x));
}

// grid (nblk, lanes), as k_wire_partial at GF(2^128)
__global__ void __launch_bounds__(NT, 2)
    k_wire_g128(const uint4* __restrict__ hv, const uint4* __restrict__ Wh,
                const uint4* __restrict__ Wo, const int* __restrict__ h,
                const int* __restrict__ ho, long long T, long long nh,
                long long no, u64* __restrict__ partial) {
  typedef Fp<G128> E;
  const long long lane = blockIdx.y;
  const long long hv0 = lane * T, wh0 = lane * nh, wo0 = lane * no;
  uint32_t s0[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; j++) s0[j] = s2[j] = 0u;
  for (long long t = (long long)blockIdx.x * NT + threadIdx.x; t < T;
       t += (long long)gridDim.x * NT) {
    const int hh = h[t];
    g128_wire_term(E::load(hv, hv0 + t), E::load(Wo, wo0 + ho[t]),
                   E::load(Wh, wh0 + (hh & ~1)), E::load(Wh, wh0 + (hh | 1)),
                   hh, s0, s2);
  }
  const E f0 = g128_fold(s0), f2 = g128_fold(s2);
  u64 a0[4], a2[4];
#pragma unroll
  for (int j = 0; j < 4; j++) {
    a0[j] = f0.l[j];
    a2[j] = f2.l[j];
  }
  const long long o = 2 * lane * gridDim.x;
  block_sum<G128>(a0, partial + 4 * (o + blockIdx.x));
  block_sum<G128>(a2, partial + 4 * (o + gridDim.x + blockIdx.x));
}

// grid (A * B, nblk): output o = a * B + b, block y takes a slice of R.
template <class C>
__global__ void k_sum_partial(const uint4* __restrict__ x, long long R,
                              long long B, u64* __restrict__ partial) {
  typedef Fp<C> E;
  constexpr int N = C::N;
  long long o = blockIdx.x;
  long long a = o / B, b = o - a * B;
  u64 acc[N];
#pragma unroll
  for (int j = 0; j < N; j++) acc[j] = 0;
  for (long long r = (long long)blockIdx.y * NT + threadIdx.x; r < R;
       r += (long long)gridDim.y * NT)
    fp_acc(acc, E::load(x, (a * R + r) * B + b));
  block_sum<C>(acc, partial + N * (o * gridDim.y + blockIdx.y));
}

// scratch: at least N * nout * nblk 64-bit words; nout = 2 A (wire: A
// lanes, R and B the lengths of a lane of Wh and Wo) or A * B (sum).
template <class C>
static int fp_wire_round(int mode, void* out, void* scratch, const void* hv,
                         const void* Wh, const void* Wo, const void* h,
                         const void* ho, long long T, long long A, long long R,
                         long long B, int nblk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  u64* partial = (u64*)scratch;
  long long nout;
  if (mode == 0) {
    nout = 2 * A;
    if (A <= 0 || A > 65535) return (int)cudaErrorInvalidValue;
    if constexpr (std::is_same<C, G128>::value) {
      k_wire_g128<<<dim3((unsigned)nblk, (unsigned)A), NT, 0, st>>>(
          (const uint4*)hv, (const uint4*)Wh, (const uint4*)Wo,
          (const int*)h, (const int*)ho, T, R, B, partial);
    } else {
      dim3 grid((unsigned)nblk, (unsigned)A);
      k_wire_partial<C><<<grid, NT, 0, st>>>(
          (const uint4*)hv, (const uint4*)Wh, (const uint4*)Wo,
          (const int*)h, (const int*)ho, T, R, B, partial);
    }
  } else {
    nout = A * B;
    if (nout == 0) return 0;
    dim3 grid((unsigned)nout, (unsigned)nblk);
    k_sum_partial<C><<<grid, NT, 0, st>>>((const uint4*)hv, R, B, partial);
  }
  int e = (int)cudaGetLastError();
  if (e) return e;
  k_finish<C><<<(unsigned)nout, NT, 0, st>>>(partial, nblk, (uint4*)out);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                          \
  int mode, void *out, void *scratch, const void *hv, const void *Wh,     \
      const void *Wo, const void *h, const void *ho, long long T,         \
      long long A, long long R, long long B, int nblk, void *stream
extern "C" int fp_wire_round_fp128(LFZK_ARGS) {
  return fp_wire_round<P128>(mode, out, scratch, hv, Wh, Wo, h, ho, T, A, R,
                             B, nblk, stream);
}
extern "C" int fp_wire_round_fp256(LFZK_ARGS) {
  return fp_wire_round<P256>(mode, out, scratch, hv, Wh, Wo, h, ho, T, A, R,
                             B, nblk, stream);
}
extern "C" int fp_wire_round_fp256k1(LFZK_ARGS) {
  return fp_wire_round<P256K1>(mode, out, scratch, hv, Wh, Wo, h, ho, T, A, R,
                               B, nblk, stream);
}
extern "C" int fp_wire_round_fp24(LFZK_ARGS) {
  return fp_wire_round<FP24>(mode, out, scratch, hv, Wh, Wo, h, ho, T, A, R,
                             B, nblk, stream);
}
extern "C" int fp_wire_round_gf2_128(LFZK_ARGS) {
  return fp_wire_round<G128>(mode, out, scratch, hv, Wh, Wo, h, ho, T, A, R,
                             B, nblk, stream);
}

#define LFZK_WIRE(tag, C)                                                  \
  extern "C" int fp_wire_round_##tag(LFZK_ARGS) {                         \
    return fp_wire_round<C>(mode, out, scratch, hv, Wh, Wo, h, ho, T, A,  \
                            R, B, nblk, stream);                          \
  }
LFZK_WIRE(fp64, FP64)
LFZK_WIRE(p256n, P256N)
LFZK_WIRE(p256k1n, P256K1N)
LFZK_WIRE(p384, P384)
LFZK_WIRE(p521, P521)
