// K7 fp_quad_bind: the fully bound quad of one sumcheck layer, the verifier's
// one O(terms) step, with an instance for Fp128, one each for the P-256 and
// secp256k1 base fields and one for GF(2^128) (sums by XOR, gf2.cuh):
//
//   out = sum over t of (bmask[t] ? beta : v[t]) * dot[g[t]]
//                       * eqh0[h0[t]] * eqh1[h1[t]]
//
// where dot = EQ(G0, .) + alpha EQ(G1, .) over the layer's outputs and
// eqh0, eqh1 = EQ(H0, .), EQ(H1, .) over its inputs (built by K1).  A
// beta-masked term takes beta itself: its v is stored as 1 (the prover's
// upload, sumcheck/prover.py quad_tensors), never multiplied by beta.
//
// Replaces the JAX package's bind_quad_device (sumcheck/verifier.py:55-96:
// F.select, three jnp.take gathers, three products and lazy_sum, jitted
// for the TPU).
//
// Bound on the H100: bytes for the prime fields (per term an 8-byte g, two
// 4-byte h, one bmask byte and v, plus three random element reads that
// the tables of at most 2^20 elements keep mostly in L2); for GF(2^128)
// the three shift-and-XOR products (about 6,000 32-bit operations a term,
// gf2.cuh) set the time.  A simple design: one thread per term,
// grid-stride, then the two-pass sum of reduce.cuh in the same launch
// (per-block 64-bit limb partials, the last block to finish sums them and
// reduces once: sum_group): exact, deterministic, no atomic in a sum.
// 3.58M terms of 32-bit limbs stay below 2^54 in each accumulator.
#include "reduce.cuh"

template <class C>
__global__ void k_quad_bind(const long long* __restrict__ g,
                            const int* __restrict__ h0,
                            const int* __restrict__ h1,
                            const uint4* __restrict__ v,
                            const unsigned char* __restrict__ bmask,
                            const uint4* __restrict__ dot,
                            const uint4* __restrict__ eqh0,
                            const uint4* __restrict__ eqh1,
                            const uint4* __restrict__ beta, long long T,
                            u64* __restrict__ partial,
                            unsigned int* __restrict__ ticket,
                            uint4* __restrict__ out) {
  typedef Fp<C> E;
  constexpr int N = C::N;
  u64 acc[1][N];
#pragma unroll
  for (int j = 0; j < N; j++) acc[0][j] = 0;
  const E b = E::load(beta, 0);
  for (long long t = (long long)blockIdx.x * NT + threadIdx.x; t < T;
       t += (long long)gridDim.x * NT) {
    E x = bmask[t] ? b : E::load(v, t);
    x = fp_mul(x, E::load(dot, g[t]));
    x = fp_mul(x, E::load(eqh0, h0[t]));
    fp_acc(acc[0], fp_mul(x, E::load(eqh1, h1[t])));
  }
  sum_group<C, 1>(acc, partial, gridDim.x, 0, blockIdx.x, ticket, out);
}

// scratch: at least N * nblk 64-bit words; ticket: one count, zero before
// the launch and left zero by it.
template <class C>
static int fp_quad_bind(void* out, void* scratch, const void* g,
                        const void* h0, const void* h1, const void* v,
                        const void* bmask, const void* dot, const void* eqh0,
                        const void* eqh1, const void* beta, long long T,
                        int nblk, void* ticket, void* stream) {
  if (nblk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  k_quad_bind<C><<<nblk, NT, 0, st>>>(
      (const long long*)g, (const int*)h0, (const int*)h1, (const uint4*)v,
      (const unsigned char*)bmask, (const uint4*)dot, (const uint4*)eqh0,
      (const uint4*)eqh1, (const uint4*)beta, T, (u64*)scratch,
      (unsigned int*)ticket, (uint4*)out);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                          \
  void *out, void *scratch, const void *g, const void *h0, const void *h1, \
      const void *v, const void *bmask, const void *dot, const void *eqh0, \
      const void *eqh1, const void *beta, long long T, int nblk,           \
      void *ticket, void *stream
extern "C" int fp_quad_bind_fp128(LFZK_ARGS) {
  return fp_quad_bind<P128>(out, scratch, g, h0, h1, v, bmask, dot, eqh0,
                            eqh1, beta, T, nblk, ticket, stream);
}
extern "C" int fp_quad_bind_fp256(LFZK_ARGS) {
  return fp_quad_bind<P256>(out, scratch, g, h0, h1, v, bmask, dot, eqh0,
                            eqh1, beta, T, nblk, ticket, stream);
}
extern "C" int fp_quad_bind_fp256k1(LFZK_ARGS) {
  return fp_quad_bind<P256K1>(out, scratch, g, h0, h1, v, bmask, dot, eqh0,
                              eqh1, beta, T, nblk, ticket, stream);
}
extern "C" int fp_quad_bind_gf2_128(LFZK_ARGS) {
  return fp_quad_bind<G128>(out, scratch, g, h0, h1, v, bmask, dot, eqh0,
                            eqh1, beta, T, nblk, ticket, stream);
}
