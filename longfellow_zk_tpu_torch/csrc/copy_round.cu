// K16 copy_round_sums: the sums of one cubic copy round of the plain
// sumcheck (prover_layers.h:415-496), with an instance for Fp128, one each
// for the P-256 and secp256k1 base fields and one for GF(2^128) (sums by
// XOR; gf2.cuh).  With EQ [C] (the copy EQ array, bound so far), W [nw, C]
// (a layer's inputs, copies inner), the term indices h0, h1 [T] and hv [T]
// (the terms' values with g bound), for each term t and copy pair j:
//
//   wr = W[h0[t]], wl = W[h1[t]] at copies 2j and 2j + 1 (0 and 1 below)
//   d0 = eq0 wr0,  d2 = (eq1 - eq0)(wr1 - wr0),  d1 = eq1 wr1 - d0 - d2
//   l0 = d0 wl0,   l2 = d1 (wl1 - wl0) + d2 wl0,  l3 = d2 (wl1 - wl0)
//
// and out = (c0, c2, c3) = sum over t of hv[t] times the sums over j of l0,
// l2 and l3: the round polynomial's coefficients but the linear one.  C is
// even (the wrapper pads the copies to a power of two with zeros, so a pad
// pair adds nothing).
//
// Replaces the sums of the JAX package's sumcheck/prover_device.py:519-542
// _copy_scan (and of its host-round twin, sumcheck/prover.py:272
// _evaluations_c).  The JAX scan gathers wr and wl once a layer, [T, C],
// and binds all four arrays every round; a gather over wires commutes with
// a bind over copies, so this kernel gathers W[h0[t]] and W[h1[t]] itself
// each round and only EQ and W are bound (K1): the same sums, bit for bit,
// with neither [T, C] array in device memory.
//
// One thread a term (a grid-stride loop): it folds its term's pairs into
// three 64-bit limb accumulators (fp_acc, exact), reduces them, multiplies
// by hv[t] and folds the products into its block's three sums.  The
// two-pass sum of reduce.cuh runs in this one launch: each block writes
// its partials, and the last block to finish (an atomic count of the
// blocks done) sums them in block order and writes out.  Bound on the
// H100 at round 1 of the SHA-256 circuit's largest layer (72,534 terms, C
// = 64, Fp128): bytes, the two gathered hands (2 x T x C elements), about
// 0.044 ms; the 7 products a pair and 3 a term (2 N^2 32-bit multiplies
// each) about 0.031 ms.  A term's two rows are contiguous (copies inner),
// so each thread reads 2 C elements in order; neighbouring threads read
// unrelated rows.
#include "reduce.cuh"

template <class C>
__global__ void k_copy_round(uint4* __restrict__ out,
                             u64* __restrict__ partial,
                             unsigned int* __restrict__ done,
                             const uint4* __restrict__ EQ,
                             const uint4* __restrict__ W,
                             const int* __restrict__ h0,
                             const int* __restrict__ h1,
                             const uint4* __restrict__ hv, long long T,
                             long long ncopy) {
  typedef Fp<C> E;
  constexpr int N = C::N;
  const long long npair = ncopy / 2;
  u64 sums[3][N];  // c0, c2, c3
#pragma unroll
  for (int k = 0; k < N; k++) sums[0][k] = sums[1][k] = sums[2][k] = 0;
  for (long long t = (long long)blockIdx.x * NT + threadIdx.x; t < T;
       t += (long long)gridDim.x * NT) {
    const long long wr = (long long)h0[t] * ncopy;
    const long long wl = (long long)h1[t] * ncopy;
    u64 p0[N], p2[N], p3[N];
#pragma unroll
    for (int k = 0; k < N; k++) p0[k] = p2[k] = p3[k] = 0;
    for (long long j = 0; j < npair; j++) {
      const E eq0 = E::load(EQ, 2 * j), eq1 = E::load(EQ, 2 * j + 1);
      const E wr0 = E::load(W, wr + 2 * j), wr1 = E::load(W, wr + 2 * j + 1);
      const E wl0 = E::load(W, wl + 2 * j), wl1 = E::load(W, wl + 2 * j + 1);
      const E d0 = fp_mul(eq0, wr0);
      const E d2 = fp_mul(fp_sub(eq1, eq0), fp_sub(wr1, wr0));
      const E d1 = fp_sub(fp_sub(fp_mul(eq1, wr1), d0), d2);
      const E c1m = fp_sub(wl1, wl0);
      fp_acc(p0, fp_mul(d0, wl0));
      fp_acc(p2, fp_mul(d1, c1m));
      fp_acc(p2, fp_mul(d2, wl0));
      fp_acc(p3, fp_mul(d2, c1m));
    }
    const E h = E::load(hv, t);
    fp_acc(sums[0], fp_mul(fp_reduce_acc<C>(p0), h));
    fp_acc(sums[1], fp_mul(fp_reduce_acc<C>(p2), h));
    fp_acc(sums[2], fp_mul(fp_reduce_acc<C>(p3), h));
  }
  sum_group<C, 3>(sums, partial, gridDim.x, 0, blockIdx.x, done, out);
}

// scratch: 3 N nblk 64-bit words of partials, then the count of blocks
// done (zero before the launch; the last block sets it to zero again).
template <class C>
static int copy_round_sums(void* out, void* scratch, const void* EQ,
                           const void* W, const void* h0, const void* h1,
                           const void* hv, long long T, long long ncopy,
                           int nblk, void* stream) {
  if (nblk <= 0 || ncopy < 2 || ncopy % 2) return (int)cudaErrorInvalidValue;
  u64* partial = (u64*)scratch;
  unsigned int* done = (unsigned int*)(partial + 3LL * C::N * nblk);
  k_copy_round<C><<<(unsigned)nblk, NT, 0, (cudaStream_t)stream>>>(
      (uint4*)out, partial, done, (const uint4*)EQ, (const uint4*)W,
      (const int*)h0, (const int*)h1, (const uint4*)hv, T, ncopy);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                         \
  void *out, void *scratch, const void *EQ, const void *W, const void *h0, \
      const void *h1, const void *hv, long long T, long long ncopy,       \
      int nblk, void *stream
#define LFZK_PASS out, scratch, EQ, W, h0, h1, hv, T, ncopy, nblk, stream
extern "C" int copy_round_sums_fp128(LFZK_ARGS) {
  return copy_round_sums<P128>(LFZK_PASS);
}
extern "C" int copy_round_sums_fp256(LFZK_ARGS) {
  return copy_round_sums<P256>(LFZK_PASS);
}
extern "C" int copy_round_sums_fp256k1(LFZK_ARGS) {
  return copy_round_sums<P256K1>(LFZK_PASS);
}
extern "C" int copy_round_sums_gf2_128(LFZK_ARGS) {
  return copy_round_sums<G128>(LFZK_PASS);
}
