// K3 fp_wire_round: the sums of one sumcheck wire round, and field sums along
// an axis, with an instance for Fp128, one each for the P-256 and secp256k1
// base fields, one for GF(2^128) (sums by XOR, -1 = 1; gf2.cuh), one
// for the ML-DSA prime (FP24: Fp24_6.lazy_sum, fields/fp24.py:270, is
// mode 1 over its six coefficient planes) and, for lazy_sum (mode 1)
// alone, one each for Goldilocks, the P-256 and secp256k1 group orders
// and the P-384 and P-521 base fields (mode 0 is compiled up to 8 words).
//
// mode 0 (wire): for one hand of round s, with the hand's indices h and
// the other hand's ho as uploaded (the round's shift an argument: hh =
// h[t] >> s, oo = ho[t] >> so) and z = hv[t] * Wo[oo],
//   out[0] = a0 = sum over t with hh even of z * Wh[hh]
//   out[1] = a2 = sum over t of (hh odd ? 1 : -1) * z * (Wh[hh|1] - Wh[hh&~1])
//   in A lanes (the proofs of a batch): hv [A, T], Wh [A, R], Wo [A, B]
//   and out [A, 2] per lane, h and ho shared; the grid is (nblk, A);
// mode 1 (sum): x viewed as [A, R, B]; out[a, b] = sum over r of x[a, r, b].
//
// Replaces the JAX package's _wire_scan.one_hand round sums
// (sumcheck/prover_device.py:571-584, with its `h >> 1` of :596) and
// PrimeField.lazy_sum (fields/fp.py:555, byte-split columns +
// _renormalize), which also computes bound_quad (prover_device.py:692)
// and the Ligero row sums; for GF(2^128) the same functions over it and
// fields/gf2.py:424 lazy_sum; with lanes, the jax.vmap of the batch
// prover over them (zk/batch.py:301, :344).
//
// One launch a call.  Each block writes its partial sums, and the last
// block of a group (a lane in mode 0, an output in mode 1) to finish, by
// an atomic ticket a group that it resets for the next launch, sums the
// group's partials in block order and reduces once (reduce.cuh
// sum_group): exact, and the result does not depend on the order in
// which blocks run.  The tickets are zero before the first launch (the
// wrapper keeps them with the stream).  A group of one block (up to 256
// terms a lane in the wire mode) reduces its sums and writes them
// directly.
//
// Bound on the H100: bytes (per term hv and the two indices, Wh and Wo
// once), at sizes where launch latency dominates; at GF(2^128) the
// products (below).
//
// The prime body (k_wire): the sign of a2's term goes into the
// difference, d = Wh[hh|1] - Wh[hh&~1] where hh is odd and its negation
// Wh[hh&~1] - Wh[hh|1] where hh is even, so a2 sums z d and a0 z
// Wh[hh&~1] (even hh only), z = hv Wo.  Two bodies, chosen by the
// wrapper by the terms of a launch (fields/fp.py _K3_WIDE_MIN):
//   - short (most hand-rounds, whose time is latency): one term a
//     thread, the three products reduced, their sums 64-bit limb
//     accumulators (fp_acc);
//   - wide (from _K3_WIDE_MIN terms, the batch prover's lanes, whose
//     time is the multiplies): z is the one product a term that is
//     reduced, and a thread keeps its two sums of products unreduced as
//     2N 64-bit column accumulators (mul_acc_wide) and Montgomery-reduces
//     them once (redc_wide; the reduction is linear): a product costs N^2
//     multiplies instead of 2 N^2, over _K3_WIDE_TERMS terms a thread at
//     least.  A thread's two wide reductions cost about four products,
//     so at one or a few terms a thread the short body is faster
//     (measured by tools/k3hv_bench.py).
//
// GF(2^128), mode 0 (k_wire_g128): -1 = 1, so with u = Wh[hh] and its
// sibling v = Wh[hh ^ 1], a2 sums z (u ^ v) over every term and a0 sums
// z u over the terms whose hh is even.  A term takes z = hv[t] Wo[oo],
// the one product that is reduced, and splits z once (gf2.cuh
// g128_split) for the two products z Wh[hh & ~1] and z Wh[hh | 1], which
// stay unreduced (8 words) in the thread's XOR accumulators: a0 gets the
// first where hh is even, a2 both.  Each thread folds its two sums once at
// the end (the fold is GF(2)-linear), then the block sums them.  The
// even-hh product runs for every term: where a warp's terms mix even and
// odd hh, a branch would run it all the same.  Two blocks an SM (128
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

// acc (2 N column accumulators) += a * b, the 2N-word product unreduced:
// each 32 x 32 -> 64 partial product's halves go to columns i + j and
// i + j + 1 (2 N addends a column a product, each below 2^32: a thread
// could add 2^30 / N products before a column overflowed).
template <class C>
__device__ __forceinline__ void mul_acc_wide(u64* acc, const Fp<C>& a,
                                             const Fp<C>& b) {
  constexpr int N = C::N;
#pragma unroll
  for (int i = 0; i < N; i++) {
#pragma unroll
    for (int j = 0; j < N; j++) {
      const u64 p = (u64)a.l[j] * b.l[i];
      acc[i + j] += (uint32_t)p;
      acc[i + j + 1] += p >> 32;
    }
  }
}

// X R^-1 mod p, canonical, for X = sum_k acc[k] 2^(32k) (2 N columns,
// each below 2^63): X = hi R + lo with lo < R, so X R^-1 = hi + lo R^-1
// (the Montgomery product of lo by the integer 1; hi is reduced as an
// accumulator, fp.cuh fp_reduce_acc).  A sum of products of Montgomery
// forms a R, b R is a sum of a b R^2: this is its Montgomery form.
template <class C>
__device__ __forceinline__ Fp<C> redc_wide(const u64* acc) {
  constexpr int N = C::N;
  Fp<C> lo = fp_zero<C>(), unit = fp_zero<C>();
  u64 c = 0, hi[N];
#pragma unroll
  for (int j = 0; j < N; j++) {
    c += acc[j];
    lo.l[j] = (uint32_t)c;
    c >>= 32;
  }
#pragma unroll
  for (int j = 0; j < N; j++) hi[j] = acc[N + j] + (j == 0 ? c : 0);
  unit.l[0] = 1u;
  return fp_add(fp_reduce_acc<C>(hi), fp_mul(lo, unit));
}

// One term of k_wire into the unreduced sums w0 (a0) and w2 (a2), 2 N
// columns each: z = hv wo, then z wlo where hh is even, and z (whi - wlo)
// where hh is odd, z (wlo - whi) where it is even.
template <class C>
__device__ __forceinline__ void prime_wire_term(const Fp<C>& hv,
                                                const Fp<C>& wo,
                                                const Fp<C>& wlo,
                                                const Fp<C>& whi, int hh,
                                                u64* w0, u64* w2) {
  const Fp<C> z = fp_mul(hv, wo);
  const bool odd = hh & 1;
  mul_acc_wide(w2, z, odd ? fp_sub(whi, wlo) : fp_sub(wlo, whi));
  if (!odd) mul_acc_wide(w0, z, wlo);
}

// grid (nblk, lanes): block (x, lane) sums a slice of lane's terms into
// out[2 lane] and out[2 lane + 1], finished by lane's last block
// (reduce.cuh sum_group).
template <class C, bool WIDE>
__global__ void k_wire(uint4* __restrict__ out, u64* __restrict__ partial,
                       unsigned int* __restrict__ tickets,
                       const uint4* __restrict__ hv,
                       const uint4* __restrict__ Wh,
                       const uint4* __restrict__ Wo,
                       const int* __restrict__ h,
                       const int* __restrict__ ho, uint32_t T, long long nh,
                       long long no, int s, int so) {
  typedef Fp<C> E;
  constexpr int N = C::N;
  const unsigned lane = blockIdx.y;
  const long long hv0 = (long long)lane * T, wh0 = lane * nh, wo0 = lane * no;
  u64 acc[2][N];  // a0's and a2's
  if constexpr (WIDE) {
    u64 w0[2 * N], w2[2 * N];
#pragma unroll
    for (int j = 0; j < 2 * N; j++) w0[j] = w2[j] = 0;
    for (uint32_t t = blockIdx.x * NT + threadIdx.x; t < T;
         t += gridDim.x * NT) {
      const int hh = h[t] >> s;
      prime_wire_term<C>(
          E::load(hv, hv0 + t), E::load(Wo, wo0 + (ho[t] >> so)),
          E::load(Wh, wh0 + (hh & ~1)), E::load(Wh, wh0 + (hh | 1)), hh, w0,
          w2);
    }
    const E f0 = redc_wide<C>(w0), f2 = redc_wide<C>(w2);
#pragma unroll
    for (int j = 0; j < N; j++) {
      acc[0][j] = f0.l[j];
      acc[1][j] = f2.l[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; j++) acc[0][j] = acc[1][j] = 0;
    for (uint32_t t = blockIdx.x * NT + threadIdx.x; t < T;
         t += gridDim.x * NT) {
      const int hh = h[t] >> s;
      const E z =
          fp_mul(E::load(hv, hv0 + t), E::load(Wo, wo0 + (ho[t] >> so)));
      const E wlo = E::load(Wh, wh0 + (hh & ~1));
      const E whi = E::load(Wh, wh0 + (hh | 1));
      const bool odd = hh & 1;
      fp_acc(acc[1], fp_mul(z, odd ? fp_sub(whi, wlo) : fp_sub(wlo, whi)));
      if (!odd) fp_acc(acc[0], fp_mul(z, wlo));
    }
  }
  sum_group<C, 2>(acc, partial, gridDim.x, 2 * lane, blockIdx.x,
                  tickets + lane, out);
}

// grid (nblk, lanes), as k_wire at GF(2^128)
__global__ void __launch_bounds__(NT, 2)
    k_wire_g128(uint4* __restrict__ out, u64* __restrict__ partial,
                unsigned int* __restrict__ tickets,
                const uint4* __restrict__ hv, const uint4* __restrict__ Wh,
                const uint4* __restrict__ Wo, const int* __restrict__ h,
                const int* __restrict__ ho, uint32_t T, long long nh,
                long long no, int s, int so) {
  typedef Fp<G128> E;
  const unsigned lane = blockIdx.y;
  const long long hv0 = (long long)lane * T, wh0 = lane * nh, wo0 = lane * no;
  uint32_t s0[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; j++) s0[j] = s2[j] = 0u;
  for (uint32_t t = blockIdx.x * NT + threadIdx.x; t < T;
       t += gridDim.x * NT) {
    const int hh = h[t] >> s;
    g128_wire_term(E::load(hv, hv0 + t), E::load(Wo, wo0 + (ho[t] >> so)),
                   E::load(Wh, wh0 + (hh & ~1)), E::load(Wh, wh0 + (hh | 1)),
                   hh, s0, s2);
  }
  const E f0 = g128_fold(s0), f2 = g128_fold(s2);
  u64 acc[2][4];
#pragma unroll
  for (int j = 0; j < 4; j++) {
    acc[0][j] = f0.l[j];
    acc[1][j] = f2.l[j];
  }
  sum_group<G128, 2>(acc, partial, gridDim.x, 2 * lane, blockIdx.x,
                     tickets + lane, out);
}

// grid (A * B, nblk): output o = a * B + b, block y takes a slice of R;
// the output's last block finishes it (its one block, where nblk is 1).
template <class C>
__global__ void k_axis_sum(uint4* __restrict__ out,
                           u64* __restrict__ partial,
                           unsigned int* __restrict__ tickets,
                           const uint4* __restrict__ x, long long R,
                           long long B) {
  typedef Fp<C> E;
  constexpr int N = C::N;
  const long long o = blockIdx.x;
  const long long a = o / B, b = o - a * B;
  u64 acc[1][N];
#pragma unroll
  for (int j = 0; j < N; j++) acc[0][j] = 0;
  for (long long r = (long long)blockIdx.y * NT + threadIdx.x; r < R;
       r += (long long)gridDim.y * NT)
    fp_acc(acc[0], E::load(x, (a * R + r) * B + b));
  sum_group<C, 1>(acc, partial, gridDim.y, o, blockIdx.y, tickets + o, out);
}

// the instances whose wire mode (0) is compiled: up to 8 words
template <class C>
constexpr bool has_wire() {
  return std::is_same<C, G128>::value || C::N <= 8;
}

// scratch: N * nout * nblk 64-bit words of partials; tickets: one
// unsigned int a group (A in mode 0; A * B in mode 1), zero before the
// launch and left zero by it.  nout = 2 A (wire: A lanes, R and B the
// lengths of a lane of Wh and Wo) or A * B (sum).  Wire mode: `wide`
// picks the wide prime body.
template <class C>
static int fp_wire_round(int mode, void* out, void* scratch, const void* hv,
                         const void* Wh, const void* Wo, const void* h,
                         const void* ho, long long T, long long A, long long R,
                         long long B, int nblk, int s, int so, int wide,
                         void* tickets, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  u64* partial = (u64*)scratch;
  unsigned int* tk = (unsigned int*)tickets;
  if (nblk <= 0 || nblk > 65535) return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    if (A <= 0 || A > 65535 || T < 0 || T >= (1ll << 32) || s < 0 ||
        s > 31 || so < 0 || so > 31)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)nblk, (unsigned)A);
    const uint4 *ph = (const uint4*)hv, *pw = (const uint4*)Wh,
                *po = (const uint4*)Wo;
    const int *ih = (const int*)h, *io = (const int*)ho;
    if constexpr (std::is_same<C, G128>::value) {
      k_wire_g128<<<grid, NT, 0, st>>>((uint4*)out, partial, tk, ph, pw, po,
                                       ih, io, (uint32_t)T, R, B, s, so);
    } else if constexpr (has_wire<C>()) {
      if (wide)
        k_wire<C, true><<<grid, NT, 0, st>>>((uint4*)out, partial, tk, ph,
                                             pw, po, ih, io, (uint32_t)T, R,
                                             B, s, so);
      else
        k_wire<C, false><<<grid, NT, 0, st>>>((uint4*)out, partial, tk, ph,
                                              pw, po, ih, io, (uint32_t)T, R,
                                              B, s, so);
    } else {
      return (int)cudaErrorNotSupported;
    }
  } else {
    const long long nout = A * B;
    if (nout == 0) return 0;
    dim3 grid((unsigned)nout, (unsigned)nblk);
    k_axis_sum<C><<<grid, NT, 0, st>>>((uint4*)out, partial, tk,
                                       (const uint4*)hv, R, B);
  }
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                          \
  int mode, void *out, void *scratch, const void *hv, const void *Wh,     \
      const void *Wo, const void *h, const void *ho, long long T,         \
      long long A, long long R, long long B, int nblk, int s, int so,     \
      int wide, void *tickets, void *stream
#define LFZK_PASS                                                          \
  mode, out, scratch, hv, Wh, Wo, h, ho, T, A, R, B, nblk, s, so, wide,   \
      tickets, stream
#define LFZK_WIRE(tag, C)                                                  \
  extern "C" int fp_wire_round_##tag(LFZK_ARGS) {                         \
    return fp_wire_round<C>(LFZK_PASS);                                    \
  }
LFZK_WIRE(fp128, P128)
LFZK_WIRE(fp256, P256)
LFZK_WIRE(fp256k1, P256K1)
LFZK_WIRE(fp24, FP24)
LFZK_WIRE(gf2_128, G128)
LFZK_WIRE(fp64, FP64)
LFZK_WIRE(p256n, P256N)
LFZK_WIRE(p256k1n, P256K1N)
LFZK_WIRE(p384, P384)
LFZK_WIRE(p521, P521)
