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
// place.  consts = [x_0, x_1, x_2, 1/(x_1-x_0), 1/(x_2-x_1), 1/(x_2-x_0),
// x_3, 1/(x_3-x_2), 1/(x_3-x_1), 1/(x_3-x_0)] in the kernels' form (0, 1,
// 2, 3 for a prime field; 0, 1, g, g^2 for GF(2^128)), from the host field
// (fields/fp.py round_consts); x_0 = 0 and x_1 = 1 in every field.
//
// The cubic mode (sumcheck_round_tail_cubic, entry points of its own so
// that its launches are counted apart) is the tail of one copy round of
// the plain sumcheck, after its sums (c0, c2, c3) from K16 (copy_round.cu,
// which weighs by the copy EQ itself):
//
//   c1 = claim - 2 c0 - c2 - c3
//   raw_k = c0 + c1 x_k + c2 x_k^2 + c3 x_k^3 at x_0 .. x_3
//   ev_k = raw_k - pad_k; absorb ev_0, ev_2 and ev_3, each tagged
//   r as above; claim = raw interpolated at r (4-point Newton form)
//
// and writes row = [ev_0, ev_1, ev_2, ev_3, r].  It replaces the oracle
// part of sumcheck/prover_device.py:543-553 _copy_scan (evals_of_coefs
// over 4 coefficients, _write_tagged_elts of 3, dev_sample_elt,
// eval_lagrange over 4 points).
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
// Both modes are one kernel (one instance a field, so that the unrolled
// SHA-256 and AES-256 of fs.cuh compile once), the point count npts = 3
// or 4 a launch argument.
//
// Bound on the H100: the dependent chain of one thread (fs.cuh): 1-2
// SHA-256 compressions to absorb, 1-2 to finalize the key, the AES-256
// key schedule and 2 blocks, about 12 field products (the cubic mode 2-3
// compressions to absorb and about 18 products).
#include "fs.cuh"

// npts = 3 (a hand-round: a = [a0, a2] a lane, eq0 shared) or 4 (a copy
// round: a = [c0, c2, c3] a lane, eq0 unused); row [npts + 1] and pad
// [npts] a lane.
template <class C>
__global__ void k_round_tail(FsState* __restrict__ fs,
                             uint4* __restrict__ claim,
                             uint4* __restrict__ row,
                             const uint4* __restrict__ a,
                             const uint4* __restrict__ eq0,
                             const uint4* __restrict__ pad,
                             const uint4* __restrict__ consts,
                             long long row_stride, long long pad_stride,
                             int npts) {
  typedef Fp<C> E;
  const long long lane = blockIdx.x;
  const long long rowo = lane * row_stride, pado = lane * pad_stride;
  const bool cubic = npts == 4;
  fs += lane;
  E c0, c2, c3 = fp_zero<C>();
  if (cubic) {
    c0 = E::load(a, 3 * lane);
    c2 = E::load(a, 3 * lane + 1);
    c3 = E::load(a, 3 * lane + 2);
  } else {
    const E e = E::load(eq0, 0);
    c0 = fp_mul(e, E::load(a, 2 * lane));
    c2 = fp_mul(e, E::load(a, 2 * lane + 1));
  }
  const E c1 =
      fp_sub(fp_sub(fp_sub(fp_sub(E::load(claim, lane), c0), c0), c2), c3);
  const E x0 = E::load(consts, 0), x1 = E::load(consts, 1),
          x2 = E::load(consts, 2), x3 = E::load(consts, 6);
  E raw[4];
  raw[0] = c0;
  raw[1] = fp_add(fp_add(fp_add(c0, c1), c2), c3);
  raw[2] = fp_add(fp_mul(fp_add(fp_mul(c2, x2), c1), x2), c0);
  raw[3] = fp_zero<C>();
  if (cubic) {
    raw[2] = fp_add(
        fp_mul(fp_add(fp_mul(fp_add(fp_mul(c3, x2), c2), x2), c1), x2), c0);
    raw[3] = fp_add(
        fp_mul(fp_add(fp_mul(fp_add(fp_mul(c3, x3), c2), x3), c1), x3), c0);
  }
  E ev[4];
#pragma unroll
  for (int k = 0; k < 4; k++)
    if (k < npts) ev[k] = fp_sub(raw[k], E::load(pad, pado + k));

  FsState s = *fs;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    if (k == 1 || k >= npts) continue;  // p(1) follows from the claim
    fs_absorb_byte(s, TAG_FIELD_ELEM);
    fs_absorb_elt(s, ev[k]);
  }
  PrfState p;
  fs_squeeze(s, p);
  const E r = prf_sample<C>(p);

  // Newton's divided differences, then the nested form at r
  const E t1 = fp_mul(fp_sub(raw[1], raw[0]), E::load(consts, 3));
  E t2 = fp_mul(fp_sub(raw[2], raw[1]), E::load(consts, 4));
  E e = fp_zero<C>();
  if (cubic) {
    E t3 = fp_mul(fp_sub(raw[3], raw[2]), E::load(consts, 7));
    t3 = fp_mul(fp_sub(t3, t2), E::load(consts, 8));
    t2 = fp_mul(fp_sub(t2, t1), E::load(consts, 5));
    t3 = fp_mul(fp_sub(t3, t2), E::load(consts, 9));
    e = fp_add(fp_mul(t3, fp_sub(r, x2)), t2);
  } else {
    t2 = fp_mul(fp_sub(t2, t1), E::load(consts, 5));
    e = t2;
  }
  e = fp_add(fp_mul(e, fp_sub(r, x1)), t1);
  e = fp_add(fp_mul(e, fp_sub(r, x0)), raw[0]);

#pragma unroll
  for (int k = 0; k < 4; k++)
    if (k < npts) ev[k].store(row, rowo + k);
  r.store(row, rowo + npts);
  e.store(claim, lane);
  *fs = s;
}

template <class C>
static int round_tail(void* fs, void* claim, void* row, const void* a,
                      const void* eq0, const void* pad, const void* consts,
                      int nlanes, long long row_stride, long long pad_stride,
                      int npts, void* stream) {
  if (nlanes <= 0) return (int)cudaErrorInvalidValue;
  k_round_tail<C><<<nlanes, 1, 0, (cudaStream_t)stream>>>(
      (FsState*)fs, (uint4*)claim, (uint4*)row, (const uint4*)a,
      (const uint4*)eq0, (const uint4*)pad, (const uint4*)consts,
      row_stride, pad_stride, npts);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                          \
  void *fs, void *claim, void *row, const void *a, const void *eq0,       \
      const void *pad, const void *consts, int nlanes,                    \
      long long row_stride, long long pad_stride, void *stream
#define LFZK_PASS(npts)                                                \
  fs, claim, row, a, eq0, pad, consts, nlanes, row_stride, pad_stride, \
      npts, stream
#define LFZK_CARGS                                                       \
  void *fs, void *claim, void *row, const void *c, const void *pad,     \
      const void *consts, int nlanes, long long row_stride,             \
      long long pad_stride, void *stream
#define LFZK_CPASS                                                      \
  fs, claim, row, c, nullptr, pad, consts, nlanes, row_stride, pad_stride, \
      4, stream
extern "C" int sumcheck_round_tail_fp128(LFZK_ARGS) {
  return round_tail<P128>(LFZK_PASS(3));
}
extern "C" int sumcheck_round_tail_fp256(LFZK_ARGS) {
  return round_tail<P256>(LFZK_PASS(3));
}
extern "C" int sumcheck_round_tail_fp256k1(LFZK_ARGS) {
  return round_tail<P256K1>(LFZK_PASS(3));
}
extern "C" int sumcheck_round_tail_gf2_128(LFZK_ARGS) {
  return round_tail<G128>(LFZK_PASS(3));
}
extern "C" int sumcheck_round_tail_cubic_fp128(LFZK_CARGS) {
  return round_tail<P128>(LFZK_CPASS);
}
extern "C" int sumcheck_round_tail_cubic_fp256(LFZK_CARGS) {
  return round_tail<P256>(LFZK_CPASS);
}
extern "C" int sumcheck_round_tail_cubic_fp256k1(LFZK_CARGS) {
  return round_tail<P256K1>(LFZK_CPASS);
}
extern "C" int sumcheck_round_tail_cubic_gf2_128(LFZK_CARGS) {
  return round_tail<G128>(LFZK_CPASS);
}
