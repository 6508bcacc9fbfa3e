// K12 ligero_inner_product: the Ligero prover's grand inner-product vector A,
// laid out as the rows the dot test encodes, with an instance for Fp128, one
// each for the P-256 and secp256k1 base fields and one for GF(2^128):
//
//   A[w] = sum over the linear terms t at w of k[t] * alphal[c_t]
//        + sum over the quadratic entries e at w of +-alphaq[q_e]
//
// (reference ligero_param.h:382-421 inner_product_vector: a + entry at
// each quadratic row position, a - entry at the witness position it
// copies), written as out[row, col] with row = w / wd and
// col = r + w % wd, and zeros in the first r columns of each row
// (layout_Aext, ligero_param.h:425-430): out is [nrow, block], block =
// r + wd.
//
// The plan is a CSR by position w, built once per (circuit, parameters)
// on the host (zk/fused.py FusedStatic): ptr[w] .. ptr[w + 1] index ent,
// whose entries are (t, c) for a linear term and (-1 - q, sign) for a
// quadratic one (sign 1 subtracts: the neg/select of the JAX package).
//
// Replaces the A build of the JAX package's zk/fused.py:198
// ligero_finish_dev (:211-219: F.mul, the gathers, F.select of F.neg and
// one F.lazy_segment_sum, then the layout_Aext concatenation).
//
// Lanes: the grid's y dimension runs the proofs of a batch, each with its
// own k, alphal and alphaq (lane strides nk, nlc, nq3 elements) into its
// own [nrow, block] of out, the plan shared; with lanes it replaces the
// jax.vmap of the batch prover over this step (zk/batch.py:344).
//
// Design: one thread an output element, each summing its few entries
// (one to three at most positions) in order; no two threads write one
// element, so no atomics and no second pass.  Bound on the H100: bytes
// (the output and the plan are read or written once; k, alphal and
// alphaq are small and stay in L2).
#include "gf2.cuh"

template <class C>
__global__ void k_inner_product(const int* __restrict__ ptr,
                                const int2* __restrict__ ent,
                                const uint4* __restrict__ k,
                                const uint4* __restrict__ alphal,
                                const uint4* __restrict__ alphaq,
                                uint4* __restrict__ out, long long nout,
                                int block, int r, int wd, long long nk,
                                long long nlc, long long nq3) {
  typedef Fp<C> E;
  const long long lane = blockIdx.y;
  const long long ko = lane * nk, lo = lane * nlc, qo = lane * nq3,
                  oo = lane * nout;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       o < nout; o += (long long)gridDim.x * blockDim.x) {
    const long long row = o / block;
    const int col = (int)(o - row * block);
    E acc = fp_zero<C>();
    if (col >= r) {
      const long long w = row * wd + (col - r);
      for (int e = ptr[w]; e < ptr[w + 1]; e++) {
        const int2 en = ent[e];
        if (en.x >= 0) {
          acc = fp_add(acc, fp_mul(E::load(k, ko + en.x),
                                   E::load(alphal, lo + en.y)));
        } else {
          const E q = E::load(alphaq, qo - 1 - en.x);
          acc = en.y ? fp_sub(acc, q) : fp_add(acc, q);
        }
      }
    }
    acc.store(out, oo + o);
  }
}

template <class C>
static int ligero_inner_product(const void* ptr, const void* ent,
                                const void* k, const void* alphal,
                                const void* alphaq, void* out,
                                long long nrow, int block, int r, int wd,
                                int nlanes, long long nk, long long nlc,
                                long long nq3, void* stream) {
  if (nrow <= 0 || block != r + wd || nlanes <= 0 || nlanes > 65535)
    return (int)cudaErrorInvalidValue;
  const long long nout = nrow * block;
  const int nt = 256;
  long long nb = (nout + nt - 1) / nt;
  if (nb > 65535) nb = 65535;
  dim3 grid((unsigned)nb, (unsigned)nlanes);
  k_inner_product<C><<<grid, nt, 0, (cudaStream_t)stream>>>(
      (const int*)ptr, (const int2*)ent, (const uint4*)k,
      (const uint4*)alphal, (const uint4*)alphaq, (uint4*)out, nout, block,
      r, wd, nk, nlc, nq3);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                           \
  const void *ptr, const void *ent, const void *k, const void *alphal,     \
      const void *alphaq, void *out, long long nrow, int block, int r,     \
      int wd, int nlanes, long long nk, long long nlc, long long nq3,      \
      void *stream
#define LFZK_PASS                                                         \
  ptr, ent, k, alphal, alphaq, out, nrow, block, r, wd, nlanes, nk, nlc, \
      nq3, stream
extern "C" int ligero_inner_product_fp128(LFZK_ARGS) {
  return ligero_inner_product<P128>(LFZK_PASS);
}
extern "C" int ligero_inner_product_fp256(LFZK_ARGS) {
  return ligero_inner_product<P256>(LFZK_PASS);
}
extern "C" int ligero_inner_product_fp256k1(LFZK_ARGS) {
  return ligero_inner_product<P256K1>(LFZK_PASS);
}
extern "C" int ligero_inner_product_gf2_128(LFZK_ARGS) {
  return ligero_inner_product<G128>(LFZK_PASS);
}
