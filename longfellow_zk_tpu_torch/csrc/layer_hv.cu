// K23 layer_hv: the layer prologue of the sumcheck, the terms' values
// with the layer's output wire bound, with an instance for Fp128, one
// each for the P-256 and secp256k1 base fields and one for GF(2^128)
// (gf2.cuh's Karatsuba product): for each lane b (a proof of a batch)
// and term j,
//
//   hv[b, j] = (bmask[j] ? beta[b] : v[j]) * dot[b, g[j]]
//
// with dot [B, nv] the layer's EQ(G0, .) + alpha EQ(G1, .) over its output
// wires, g (int32), v and bmask (one byte) the terms' output wire,
// coefficient and beta flag, and beta [B] one element a lane (lane b's at
// beta[b * bstride]).  The caller passes the terms in the order its wire
// rounds take them: the term-merge plan's permutation is applied to g, v
// and bmask once, at upload (sumcheck/prover.py _hv_terms), so that the
// plan's gather of hv disappears.
//
// Replaces the JAX package's hv = F.mul(vq, jnp.take(dot, qd["g"])) with
// vq = F.select(qd["bmask"], beta, qd["v"]) in _layer_fn
// (sumcheck/prover_device.py:667-671) and the merge plan's
// jnp.take(hv, qd["wm_perm"]) in _wire_rounds (:623), which XLA fused
// into one pass; with lanes, the jax.vmap of the batch prover over them
// (zk/batch.py:301).
//
// One term a thread of a grid-stride loop over a lane (blockIdx.y the
// lane), 32-bit indices.  Bound on the H100: bytes (per term g, v, bmask,
// one element of dot gathered and one of hv written a lane), at
// GF(2^128) the products.
#include <algorithm>

#include "gf2.cuh"

constexpr int HV_THREADS = 256;
// blocks a lane, at most: about the card's resident blocks (132 SMs x 8)
constexpr long long HV_MAX_BLOCKS = 1056;

template <class C>
__global__ void __launch_bounds__(HV_THREADS)
    k_layer_hv(uint4* __restrict__ out, const uint4* __restrict__ dot,
               const int* __restrict__ g, const uint4* __restrict__ v,
               const unsigned char* __restrict__ bmask,
               const uint4* __restrict__ beta, uint32_t T, long long nv,
               long long bstride) {
  typedef Fp<C> E;
  const unsigned lane = blockIdx.y;
  const E b = E::load(beta, lane * bstride);
  const long long d0 = lane * nv, o0 = (long long)lane * T;
  for (uint32_t j = blockIdx.x * HV_THREADS + threadIdx.x; j < T;
       j += gridDim.x * HV_THREADS) {
    const E c = bmask[j] ? b : E::load(v, j);
    fp_mul(c, E::load(dot, d0 + g[j])).store(out, o0 + j);
  }
}

// out [lanes, T]; dot [lanes, nv]; beta's lane b at beta[b * bstride].
template <class C>
static int layer_hv(void* out, const void* dot, const void* g, const void* v,
                    const void* bmask, const void* beta, long long T,
                    long long lanes, long long nv, long long bstride,
                    void* stream) {
  if (T < 0 || T >= (1ll << 32) || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const long long need = (T + HV_THREADS - 1) / HV_THREADS;
  const long long per = std::max(1ll, HV_MAX_BLOCKS / lanes);
  k_layer_hv<C><<<dim3((unsigned)std::min(need, per), (unsigned)lanes),
                  HV_THREADS, 0, (cudaStream_t)stream>>>(
      (uint4*)out, (const uint4*)dot, (const int*)g, (const uint4*)v,
      (const unsigned char*)bmask, (const uint4*)beta, (uint32_t)T, nv,
      bstride);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                        \
  void *out, const void *dot, const void *g, const void *v,             \
      const void *bmask, const void *beta, long long T, long long lanes, \
      long long nv, long long bstride, void *stream
#define LFZK_PASS out, dot, g, v, bmask, beta, T, lanes, nv, bstride, stream
extern "C" int layer_hv_fp128(LFZK_ARGS) { return layer_hv<P128>(LFZK_PASS); }
extern "C" int layer_hv_fp256(LFZK_ARGS) { return layer_hv<P256>(LFZK_PASS); }
extern "C" int layer_hv_fp256k1(LFZK_ARGS) {
  return layer_hv<P256K1>(LFZK_PASS);
}
extern "C" int layer_hv_gf2_128(LFZK_ARGS) {
  return layer_hv<G128>(LFZK_PASS);
}
