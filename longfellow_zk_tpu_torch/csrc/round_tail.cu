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
// (one warp) each, with eq0 and consts shared: block b takes fs[b],
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
// key schedule and one block (a 32-byte draw's two blocks side by side),
// about 8 field products on the chain (the cubic mode 2-3 compressions to
// absorb and about 10).  The block is one warp: its 32 threads run the
// round side by side on the same values, fill the AES table in shared
// memory after the absorbs (the S-box loads issued first), and multiply
// in GF(2^128) together (rt_mul.cuh); thread 0 stores.  The transcript
// state, the round keys and the draws stay in registers.
#include "fs.cuh"

#include "rt_mul.cuh"

// The round of lane `lane`, run by the block's 32 threads, each
// computing the same values (the GF(2^128) products take the warp,
// rt_mul.cuh); thread 0 stores them.  Shared memory: T the AES table, RK
// the round keys, Q the compression queue (fs.cuh).  npts = 3 (a
// hand-round: a = [a0, a2] a lane, eq0 shared) or 4 (a copy round: a =
// [c0, c2, c3] a lane, eq0 unused); row [npts + 1] and pad [npts] a lane.
//
// A prime field's points are 0, 1, 2, 3 (fields/fp.py round_consts, the
// only constants the port passes), so the products by x_2, x_3 and the
// Newton denominators 1 and 1/2 are adds and a halving; of its consts
// only 1/3 is read, a product off the chain.  At GF(2^128) every step is
// a product by consts.
template <class C>
__device__ __forceinline__ void round_tail_lane(
    long long lane, FsState* __restrict__ fs, uint4* __restrict__ claim,
    uint4* __restrict__ row, const uint4* __restrict__ a,
    const uint4* __restrict__ eq0, const uint4* __restrict__ pad,
    const uint4* __restrict__ consts, long long row_stride,
    long long pad_stride, int npts, uint32_t* T, uint32_t* RK,
    uint32_t* Q) {
  typedef Fp<C> E;
  const long long rowo = lane * row_stride, pado = lane * pad_stride;
  const bool cubic = npts == 4;
  // the S-box words for the table, loaded first and used after the
  // absorbs (threads 0 and 32 of the 64 words)
  const uint32_t sw0 = __ldg((const uint32_t*)AES_SBOX + threadIdx.x);
  const uint32_t sw1 = __ldg((const uint32_t*)AES_SBOX + 32 + threadIdx.x);
  FsW s;
  uint32_t key[8];
  E raw[4], ev[4], t1, t2, t3 = fp_zero<C>();
  // the points 0, 1, 2, 3 of a prime field
  constexpr bool small = !Oracle<C>::RAW;
  {
    E c0, c2, c3 = fp_zero<C>();
    if (cubic) {
      c0 = E::load(a, 3 * lane);
      c2 = E::load(a, 3 * lane + 1);
      c3 = E::load(a, 3 * lane + 2);
    } else {
      const E e = E::load(eq0, 0);
      c0 = rt_mul(e, E::load(a, 2 * lane));
      c2 = rt_mul(e, E::load(a, 2 * lane + 1));
    }
    const E cl = E::load(claim, lane);
    const E c1 = fp_sub(fp_sub(fp_sub(fp_sub(cl, c0), c0), c2), c3);
    raw[0] = c0;
    raw[1] = fp_sub(cl, c0);
    raw[3] = fp_zero<C>();
    if constexpr (small) {
      // p(2) = c0 + 2 (c1 + 2 (c2 + 2 c3)), p(3) = c0 + 3 (c1 + 3 (c2 +
      // 3 c3))
      E u = fp_add(fp_add(c3, c3), c2);
      u = fp_add(fp_add(u, u), c1);
      raw[2] = fp_add(fp_add(u, u), c0);
      if (cubic) {
        u = fp_add(fp_add(fp_add(c3, c3), c3), c2);
        u = fp_add(fp_add(fp_add(u, u), u), c1);
        raw[3] = fp_add(fp_add(fp_add(u, u), u), c0);
      }
    } else {
      const E x2 = E::load(consts, 2), x3 = E::load(consts, 6);
      if (cubic) {
        raw[2] = fp_add(
            rt_mul(fp_add(rt_mul(fp_add(rt_mul(c3, x2), c2), x2), c1), x2),
            c0);
        raw[3] = fp_add(
            rt_mul(fp_add(rt_mul(fp_add(rt_mul(c3, x3), c2), x3), c1), x3),
            c0);
      } else {
        raw[2] = fp_add(rt_mul(fp_add(rt_mul(c2, x2), c1), x2), c0);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; k++)
      if (k < npts) ev[k] = fp_sub(raw[k], E::load(pad, pado + k));

    // the absorbs' and the key's blocks to the queue, then one loop
    // compresses them
    fsw_load(s, fs + lane);
    int nq = 0;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      if (k == 1 || k >= npts) continue;  // p(1) follows from the claim
      fsw_absorb_tagged_q<C>(s, ev[k], Q, &nq);
    }
    const int nabs = nq;
    fsw_key_blocks(s, Q, &nq);
    __syncwarp();
    fsw_run_queue(s, Q, nq, nabs, key);

    // Newton's divided differences: all but the last steps need no r
    if constexpr (small) {
      t1 = fp_sub(raw[1], raw[0]);
      t2 = fp_sub(raw[2], raw[1]);
      if (cubic) {
        t3 = rt_half(fp_sub(fp_sub(raw[3], raw[2]), t2));
        t2 = rt_half(fp_sub(t2, t1));
        t3 = rt_mul(fp_sub(t3, t2), E::load(consts, 9));
      } else {
        t2 = rt_half(fp_sub(t2, t1));
      }
    } else {
      t1 = rt_mul(fp_sub(raw[1], raw[0]), E::load(consts, 3));
      t2 = rt_mul(fp_sub(raw[2], raw[1]), E::load(consts, 4));
      if (cubic) {
        t3 = rt_mul(fp_sub(raw[3], raw[2]), E::load(consts, 7));
        t3 = rt_mul(fp_sub(t3, t2), E::load(consts, 8));
        t2 = rt_mul(fp_sub(t2, t1), E::load(consts, 5));
        t3 = rt_mul(fp_sub(t3, t2), E::load(consts, 9));
      } else {
        t2 = rt_mul(fp_sub(t2, t1), E::load(consts, 5));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; k++) {
    T[4 * threadIdx.x + k] = aes_t_entry(sw0, k);
    T[128 + 4 * threadIdx.x + k] = aes_t_entry(sw1, k);
  }
  __syncwarp();

  aes_expand(key, RK, T);
  __syncwarp();
  const E r = fresh_sample<C>(RK, T);

  // the nested form at r (x_0 = 0, x_1 = 1)
  E e = t2;
  if (cubic) {
    const E x2 = small ? fp_add(fp_one<C>(), fp_one<C>())
                       : E::load(consts, 2);
    e = fp_add(rt_mul(t3, fp_sub(r, x2)), t2);
  }
  e = fp_add(rt_mul(e, fp_sub(r, fp_one<C>())), t1);
  e = fp_add(rt_mul(e, r), raw[0]);

  if (threadIdx.x != 0) return;
#pragma unroll
  for (int k = 0; k < 4; k++)
    if (k < npts) ev[k].store(row, rowo + k);
  r.store(row, rowo + npts);
  e.store(claim, lane);
  fsw_store(fs + lane, s);
}

template <class C>
__global__ void __launch_bounds__(32)
    k_round_tail(FsState* __restrict__ fs, uint4* __restrict__ claim,
                 uint4* __restrict__ row, const uint4* __restrict__ a,
                 const uint4* __restrict__ eq0, const uint4* __restrict__ pad,
                 const uint4* __restrict__ consts, long long row_stride,
                 long long pad_stride, int npts) {
  __shared__ uint32_t T[256], RK[60], Q[16 * FS_QUEUE];
  round_tail_lane<C>(blockIdx.x, fs, claim, row, a, eq0, pad, consts,
                     row_stride, pad_stride, npts, T, RK, Q);
}

template <class C>
static int round_tail(void* fs, void* claim, void* row, const void* a,
                      const void* eq0, const void* pad, const void* consts,
                      int nlanes, long long row_stride, long long pad_stride,
                      int npts, void* stream) {
  if (nlanes <= 0) return (int)cudaErrorInvalidValue;
  k_round_tail<C><<<nlanes, 32, 0, (cudaStream_t)stream>>>(
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
