// K10 sumcheck_round_tail: everything of one sumcheck hand-round after its
// sums (K3), in one thread, with an instance for Fp128, one each for the
// P-256 and secp256k1 base fields and one for GF(2^128).  With a = [a0, a2]
// from K3, the copy weight eq0 and the running claim:
//
//   c0 = eq0 a0,  c2 = eq0 a2,  c1 = claim - 2 c0 - c2
//   raw_k = c0 + c1 x_k + c2 x_k^2 at the points x_0, x_1, x_2
//   ev_k = raw_k - pad_k                (what the proof carries)
//   absorb ev_0 and ev_2, each tagged   (Transcript.write_elt)
//   r = a sample from a fresh PRF stream keyed by the transcript
//   claim = raw interpolated at r        (Newton form)
//
// and writes row = [ev_0, ev_1, ev_2, r]; fs and claim are updated in
// place.  consts = [x_0, x_1, x_2, 1/(x_1-x_0), 1/(x_2-x_1), 1/(x_2-x_0)]
// in the kernels' form (0, 1, 2 for a prime field; 0, 1, g for
// GF(2^128)), from the host field (fields/fp.py round_consts).
//
// Replaces the oracle part of the JAX package's
// sumcheck/prover_device.py:571-597 _wire_scan.one_hand: _FieldDev.
// evals_of_coefs (:70) and eval_lagrange (:94), _write_tagged_elts (:248)
// and dev_sample_elt(fs_squeeze(fs)) (device_fs.py:296, :212).
//
// Lanes: one launch runs the round of nlanes proofs (a batch), one block
// of one thread each, with eq0 and consts shared: block b takes fs[b],
// claim[b], a[b, 0..1] and the row and pad at b row_stride and
// b pad_stride elements (views into per-layer tensors), so no lane waits
// on another's rejection sampling.  With lanes it replaces the jax.vmap
// of the batch prover over one_hand (zk/batch.py:301).
//
// Bound on the H100: the dependent chain of one thread (fs.cuh): 1-2
// SHA-256 compressions to absorb, 1-2 to finalize the key, the AES-256
// key schedule and 2 blocks, about 12 field products.
#include "fs.cuh"

template <class C>
__global__ void k_round_tail(FsState* __restrict__ fs,
                             uint4* __restrict__ claim,
                             uint4* __restrict__ row,
                             const uint4* __restrict__ a,
                             const uint4* __restrict__ eq0,
                             const uint4* __restrict__ pad,
                             const uint4* __restrict__ consts,
                             long long row_stride, long long pad_stride) {
  typedef Fp<C> E;
  const long long lane = blockIdx.x;
  const long long rowo = lane * row_stride, pado = lane * pad_stride;
  fs += lane;
  const E e = E::load(eq0, 0);
  const E c0 = fp_mul(e, E::load(a, 2 * lane));
  const E c2 = fp_mul(e, E::load(a, 2 * lane + 1));
  const E c1 = fp_sub(fp_sub(fp_sub(E::load(claim, lane), c0), c0), c2);
  const E x0 = E::load(consts, 0), x1 = E::load(consts, 1),
          x2 = E::load(consts, 2);
  const E r0 = c0;
  const E r1 = fp_add(fp_add(c0, c1), c2);
  const E r2 = fp_add(fp_mul(fp_add(fp_mul(c2, x2), c1), x2), c0);
  const E ev0 = fp_sub(r0, E::load(pad, pado));
  const E ev1 = fp_sub(r1, E::load(pad, pado + 1));
  const E ev2 = fp_sub(r2, E::load(pad, pado + 2));

  FsState s = *fs;
  fs_absorb_byte(s, TAG_FIELD_ELEM);
  fs_absorb_elt(s, ev0);
  fs_absorb_byte(s, TAG_FIELD_ELEM);
  fs_absorb_elt(s, ev2);
  PrfState p;
  fs_squeeze(s, p);
  const E r = prf_sample<C>(p);

  const E t1 = fp_mul(fp_sub(r1, r0), E::load(consts, 3));
  E t2 = fp_mul(fp_sub(r2, r1), E::load(consts, 4));
  t2 = fp_mul(fp_sub(t2, t1), E::load(consts, 5));
  const E nc = fp_add(
      fp_mul(fp_add(fp_mul(t2, fp_sub(r, x1)), t1), fp_sub(r, x0)), r0);

  ev0.store(row, rowo);
  ev1.store(row, rowo + 1);
  ev2.store(row, rowo + 2);
  r.store(row, rowo + 3);
  nc.store(claim, lane);
  *fs = s;
}

template <class C>
static int round_tail(void* fs, void* claim, void* row, const void* a,
                      const void* eq0, const void* pad, const void* consts,
                      int nlanes, long long row_stride, long long pad_stride,
                      void* stream) {
  if (nlanes <= 0) return (int)cudaErrorInvalidValue;
  k_round_tail<C><<<nlanes, 1, 0, (cudaStream_t)stream>>>(
      (FsState*)fs, (uint4*)claim, (uint4*)row, (const uint4*)a,
      (const uint4*)eq0, (const uint4*)pad, (const uint4*)consts,
      row_stride, pad_stride);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                          \
  void *fs, void *claim, void *row, const void *a, const void *eq0,       \
      const void *pad, const void *consts, int nlanes,                    \
      long long row_stride, long long pad_stride, void *stream
#define LFZK_PASS                                                      \
  fs, claim, row, a, eq0, pad, consts, nlanes, row_stride, pad_stride, \
      stream
extern "C" int sumcheck_round_tail_fp128(LFZK_ARGS) {
  return round_tail<P128>(LFZK_PASS);
}
extern "C" int sumcheck_round_tail_fp256(LFZK_ARGS) {
  return round_tail<P256>(LFZK_PASS);
}
extern "C" int sumcheck_round_tail_fp256k1(LFZK_ARGS) {
  return round_tail<P256K1>(LFZK_PASS);
}
extern "C" int sumcheck_round_tail_gf2_128(LFZK_ARGS) {
  return round_tail<G128>(LFZK_PASS);
}
