// K11 zk_constraints: the Ligero linear-constraint coefficients of the ZK
// prover's sumcheck layers, with an instance for Fp128, one each for the
// P-256 and secp256k1 base fields and one for GF(2^128).  The twin of the
// symbolic replay of the sumcheck verifier (zk/common.py
// verifier_constraints; reference zk_common.h:49-136): per layer, a
// coefficient vector sym over the layer's nvar = 4 logw + 6 pad variables
//
//   [claim pad of the layer before (3) | poly pads (2 a hand-round) |
//    the layer's claim pad (3)]
//
// starts as (1, alpha, 0, ...) and, for each of the 2 logw hand-rounds
// with challenge r (K10 wrote it at rows[round, hand, 3]),
//
//   sym[p0] -= 1;  sym *= L1(r);  sym[p0] += L0(r);  sym[p2] += L2(r)
//
// with p0, p2 = 3 + 2 round', 4 + 2 round' and L_k the degree-2 Lagrange
// basis over the evaluation points x_0, x_1, x_2:
// L_k(r) = inv_d_k * prod_{j != k} (r - x_j).  After the rounds, with the
// bound quad bq and the layer's claims wc and their pad,
//
//   sym[c0] -= bq (wc1 - pad1);  sym[c0+1] -= bq (wc0 - pad0);
//   sym[c0+2] -= bq                              (c0 = 3 + 4 logw)
//
// and sym[i0:] goes to k[koff:], where i0 = 3 for layer 0 (it has no
// claim before it) and 0 for the others.
//
// Replaces the JAX package's zk/fused.py:139 constraints_dev (its layer
// loop) with :124 lagrange3_dev and :110 _lagrange3_consts; the input
// binding that follows it there runs in K9 (alpha_b) and K1 (the EQ
// arrays), zk/fused.py.
//
// Lanes: the grid is (nl, nlanes), block (ly, b) builds layer ly of
// proof b of a batch from its own rows, scal, wcpad into its own k (lane
// strides: nrounds 2 x 4 elements of rows, 4 nl of scal, 2 nl of wcpad,
// nk of k), with the table lay and the constants shared; with lanes it
// replaces the jax.vmap of the batch prover over constraints_dev
// (zk/batch.py:301).
//
// Design: one block a layer, one thread a coefficient.  Every update of
// sym is elementwise, so the threads never exchange a value: each reads
// r, computes the three L_k itself (6 products, the same in every
// thread) and updates its one coefficient.  Bound on the H100: the chain
// through sym, a difference, one product (the scaling) and a sum each of
// the 2 logw hand-rounds, after the first round's L_k; the L_k of a round
// depend on its r alone and need not wait for sym (here each thread forms
// them in the round's turn, which puts about 3 products a round on the
// chain unless the compiler overlaps them); the bytes are a few KB.
#include "gf2.cuh"

// lay[4 ly .. 4 ly + 3] = (logw, i0, first round in rows, koff).
template <class C>
__global__ void k_constraints(const int* __restrict__ lay,
                              const uint4* __restrict__ rows,
                              const uint4* __restrict__ scal,
                              const uint4* __restrict__ wcpad,
                              const uint4* __restrict__ lag,
                              uint4* __restrict__ k, long long nrounds,
                              long long nk) {
  typedef Fp<C> E;
  const int ly = blockIdx.x;
  const long long lane = blockIdx.y, nl = gridDim.x;
  const int logw = lay[4 * ly], i0 = lay[4 * ly + 1];
  const long long roff = lay[4 * ly + 2], koff = lay[4 * ly + 3];
  const int nvar = 4 * logw + 6;
  const int t = threadIdx.x;
  if (t >= nvar) return;
  const E one = fp_one<C>();
  const E x0 = E::load(lag, 0), x1 = E::load(lag, 1), x2 = E::load(lag, 2);
  const E d0 = E::load(lag, 3), d1 = E::load(lag, 4), d2 = E::load(lag, 5);
  // scal[ly] = (alpha, bq, wc0, wc1)
  const long long sc = 4 * (lane * nl + ly), rw = lane * nrounds * 8;
  E sym = t == 0 ? one : (t == 1 ? E::load(scal, sc) : fp_zero<C>());
  for (int rnd = 0; rnd < 2 * logw; rnd++) {
    // round rnd is hand rnd % 2 of sumcheck round rnd / 2
    const E r = E::load(rows, rw + (roff * 2 + rnd) * 4 + 3);
    const E a = fp_sub(r, x0), b = fp_sub(r, x1), c = fp_sub(r, x2);
    const int p0 = 3 + 2 * rnd;
    if (t == p0) sym = fp_sub(sym, one);
    sym = fp_mul(sym, fp_mul(fp_mul(d1, a), c));
    if (t == p0) sym = fp_add(sym, fp_mul(fp_mul(d0, b), c));
    if (t == p0 + 1) sym = fp_add(sym, fp_mul(fp_mul(d2, a), b));
  }
  const int c0 = 3 + 4 * logw;
  if (t >= c0) {
    const E bq = E::load(scal, sc + 1);
    if (t == c0 + 2) {
      sym = fp_sub(sym, bq);
    } else {
      // t = c0 takes wc1, t = c0 + 1 takes wc0
      const int h = c0 + 1 - t;
      const E tt = fp_sub(E::load(scal, sc + 2 + h),
                          E::load(wcpad, 2 * (lane * nl + ly) + h));
      sym = fp_sub(sym, fp_mul(bq, tt));
    }
  }
  if (t >= i0) sym.store(k, lane * nk + koff + t - i0);
}

template <class C>
static int zk_constraints(const void* lay, int nl, int nthreads,
                          const void* rows, const void* scal,
                          const void* wcpad, const void* lag, void* k,
                          int nlanes, long long nrounds, long long nk,
                          void* stream) {
  if (nl <= 0 || nthreads <= 0 || nthreads > 1024 || nlanes <= 0 ||
      nlanes > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)nl, (unsigned)nlanes);
  k_constraints<C><<<grid, nthreads, 0, (cudaStream_t)stream>>>(
      (const int*)lay, (const uint4*)rows, (const uint4*)scal,
      (const uint4*)wcpad, (const uint4*)lag, (uint4*)k, nrounds, nk);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                        \
  const void *lay, int nl, int nthreads, const void *rows,              \
      const void *scal, const void *wcpad, const void *lag, void *k,    \
      int nlanes, long long nrounds, long long nk, void *stream
#define LFZK_PASS                                                    \
  lay, nl, nthreads, rows, scal, wcpad, lag, k, nlanes, nrounds, nk, \
      stream
extern "C" int zk_constraints_fp128(LFZK_ARGS) {
  return zk_constraints<P128>(LFZK_PASS);
}
extern "C" int zk_constraints_fp256(LFZK_ARGS) {
  return zk_constraints<P256>(LFZK_PASS);
}
extern "C" int zk_constraints_fp256k1(LFZK_ARGS) {
  return zk_constraints<P256K1>(LFZK_PASS);
}
extern "C" int zk_constraints_gf2_128(LFZK_ARGS) {
  return zk_constraints<G128>(LFZK_PASS);
}
