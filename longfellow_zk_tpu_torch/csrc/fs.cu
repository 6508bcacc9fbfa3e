// K9 fs_oracle: the Fiat-Shamir oracle's steps on the card (fs.cuh), one
// launch a step, with an instance for Fp128, one each for the P-256 and
// secp256k1 base fields and one for GF(2^128).  The states fs (104 bytes) and
// prf (272 bytes) live in device memory and are updated in place.
//
//   mode 0 ABSORB          fs absorbs the n bytes of in
//   mode 1 GETKEY          out[32] = the key of fs (fork and finalize)
//   mode 2 PRF_FRESH       prf = a fresh stream keyed by in[32]
//   mode 3 SQUEEZE         prf = a fresh stream keyed by fs
//   mode 4 PRF_BYTES       out[n] = the next n bytes of prf
//   mode 5 WRITE_ARRAY     fs absorbs the n elements of in as one tagged
//                          array (Transcript.write_elts)
//   mode 6 WRITE_TAGGED    fs absorbs the n elements of in, each tagged
//                          (n calls of Transcript.write_elt)
//   mode 7 SAMPLE          out[n] = n elements sampled from prf
//   mode 8 SQUEEZE_SAMPLE  mode 3, then mode 7
//   mode 9 CHOOSE          mode 3, then out[k] = k distinct naturals
//                          below n from prf (Transcript.choose); its own
//                          entry point, fs_choose_<field>
//
// Lanes: a launch runs nlanes independent transcripts (the proofs of a
// batch), one block each: block b takes fs[b], prf[b], in + b in_stride
// and out + b out_stride (bytes; an in_stride of 0 shares in).  No block
// waits on another, so a lane whose samples reject draws more bytes
// without holding the others back.
//
// Replaces the JAX package's random_oracle/device_fs.py:82-411 (mode 9:
// :369 dev_nat, :399 dev_choose, which zk/fused.py:234 runs for the
// Ligero column openings) and
// sumcheck/prover_device.py:248, which its device sumcheck runs at
// begin_circuit (:713, 2 x 40 samples), at each layer's alpha and beta
// (:642-662) and at the layer's closing wc write (:698).
//
// Bound on the H100: the chain of dependent instructions of one thread.
// A SHA-256 compression is 64 rounds of about 30 dependent 32-bit
// operations; an AES-256 block 14 rounds of table loads from shared
// memory and XORs; a Montgomery product 2 N^2 dependent 64-bit
// multiply-adds.  Nothing is parallel across threads: the oracle is one
// hash chain.  One thread a lane runs it on the states in registers
// (fs.cuh: an absorb takes up to 64 bytes at a time), the block's 32
// threads fill the AES table first; one launch a step; with lanes, the
// jax.vmap of the batch prover over these steps (zk/batch.py:301,
// :344).
#include "fs.cuh"

template <class C>
__global__ void k_fs_oracle(int mode, FsState* __restrict__ fs,
                            PrfState* __restrict__ prf,
                            const uint8_t* __restrict__ in,
                            uint8_t* __restrict__ out, long long n,
                            long long in_stride, long long out_stride) {
  typedef Fp<C> E;
  __shared__ uint32_t T[256], RK[60];
  const long long lane = blockIdx.x;
  const bool read_fs = mode == 0 || mode == 1 || mode == 3 || mode == 5 ||
                       mode == 6 || mode == 8;
  const bool write_fs = mode == 0 || mode == 5 || mode == 6;
  const bool read_prf = mode == 4 || mode == 7;
  const bool write_prf = mode >= 2 && mode != 5 && mode != 6;
  if (write_prf) {  // the modes that run AES
    aes_tables(T);
    __syncwarp();
  }
  if (threadIdx.x != 0) return;
  fs += lane;
  prf += lane;
  in += lane * in_stride;
  out += lane * out_stride;
  FsW s;
  PrfW p;
  p.rk = RK;
  uint32_t key[8];
  if (read_fs) fsw_load(s, fs);
  if (read_prf) prfw_load(p, prf);
  const uint4* elts = (const uint4*)in;
  switch (mode) {
    case 0:
      for (long long i = 0; i < n; i += 64)
        fsw_absorb_bytes(s, in + i, (int)(n - i < 64 ? n - i : 64));
      break;
    case 1:
      fsw_getkey(s, key);
#pragma unroll
      for (int i = 0; i < 32; i++) out[i] = (uint8_t)(key[i >> 2] >> (8 * (i & 3)));
      break;
    case 2:
#pragma unroll
      for (int i = 0; i < 8; i++)
        key[i] = (uint32_t)in[4 * i] | ((uint32_t)in[4 * i + 1] << 8) |
                 ((uint32_t)in[4 * i + 2] << 16) |
                 ((uint32_t)in[4 * i + 3] << 24);
      prfw_fresh(p, key, T);
      break;
    case 3:
      fsw_getkey(s, key);
      prfw_fresh(p, key, T);
      break;
    case 4:
      for (long long i = 0; i < n; i++) out[i] = (uint8_t)prfw_byte(p, T);
      break;
    case 5:
      fsw_absorb_array_header(s, (u64)n);
      for (long long i = 0; i < n; i++) fsw_absorb_elt(s, E::load(elts, i));
      break;
    case 6:
      for (long long i = 0; i < n; i++)
        fsw_absorb_tagged(s, E::load(elts, i));
      break;
    case 8:
      fsw_getkey(s, key);
      prfw_fresh(p, key, T);
      // fall through
    case 7:
      for (long long i = 0; i < n; i++)
        prfw_sample<C>(p, T).store((uint4*)out, i);
      break;
  }
  if (write_fs) fsw_store(fs, s);
  if (write_prf) prfw_store(prf, p);
}

// Mode 9 CHOOSE: a fresh squeeze of fs into prf, then the partial
// Fisher-Yates walk of Transcript.choose (reference random.h:57-105),
// which leaves prf where the walk's last draw ended.  Step i draws
// r < m = n - i by rejection: l bytes of the stream, the least l with
// m < 256^l (recomputed each step: it shrinks when m crosses a power of
// 256), little-endian, masked to the bits of m; then swaps A[i] and
// A[i + r] and outputs the new A[i].  The block's threads fill A = 0..n-1
// (in shared memory when it fits, else in out[k..k+n)) and the AES table;
// thread 0 walks, every step depending on the last.  The chain: the
// squeeze, the key schedule, one AES block (the counter blocks do not
// depend on each other), then a few instructions and two dependent
// accesses of A a step.  Lanes: block b walks lane b's own stream (fs[b],
// prf[b]) into out + b (k + n), each with its array in its own shared
// memory.
constexpr long long CHOOSE_SMEM_MAX = 12288;  // 48 KB of int

template <class C>
__global__ void k_fs_choose(const FsState* __restrict__ fs,
                            PrfState* __restrict__ prf, int* __restrict__ out,
                            long long k, long long n) {
  extern __shared__ int smem[];
  __shared__ uint32_t T[256], RK[60];
  const long long lane = blockIdx.x;
  fs += lane;
  prf += lane;
  out += lane * (k + n);
  int* A = n <= CHOOSE_SMEM_MAX ? smem : out + k;
  for (long long j = threadIdx.x; j < n; j += blockDim.x) A[j] = (int)j;
  aes_tables(T);
  __syncthreads();
  if (threadIdx.x != 0) return;
  FsW s;
  PrfW p;
  p.rk = RK;
  uint32_t key[8];
  fsw_load(s, fs);
  fsw_getkey(s, key);
  prfw_fresh(p, key, T);
  for (long long i = 0; i < k; i++) {
    const uint32_t m = (uint32_t)(n - i);
    const int bits = 32 - __clz(m);
    const int l = (bits + 7) / 8;
    const uint32_t msk = bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
    uint32_t r;
    do {
      r = 0u;
      for (int b = 0; b < l; b++) r |= prfw_byte(p, T) << (8 * b);
      r &= msk;
    } while (r >= m);
    const long long j = i + r;
    const int ai = A[i], aj = A[j];
    A[i] = aj;
    A[j] = ai;
    out[i] = aj;
  }
  prfw_store(prf, p);
}

// out: nlanes x (k + n) ints.
template <class C>
static int fs_choose(void* fs, void* prf, void* out, long long k,
                     long long n, int nlanes, void* stream) {
  if (k <= 0 || k > n || n >= (1ll << 31) || nlanes <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = n <= CHOOSE_SMEM_MAX ? (size_t)n * sizeof(int) : 0;
  k_fs_choose<C><<<nlanes, 256, smem, (cudaStream_t)stream>>>(
      (const FsState*)fs, (PrfState*)prf, (int*)out, k, n);
  return (int)cudaGetLastError();
}

template <class C>
static int fs_oracle(int mode, void* fs, void* prf, const void* in,
                     void* out, long long n, int nlanes, long long in_stride,
                     long long out_stride, void* stream) {
  if (mode < 0 || mode > 8 || nlanes <= 0) return (int)cudaErrorInvalidValue;
  k_fs_oracle<C><<<nlanes, 32, 0, (cudaStream_t)stream>>>(
      mode, (FsState*)fs, (PrfState*)prf, (const uint8_t*)in, (uint8_t*)out,
      n, in_stride, out_stride);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                     \
  int mode, void *fs, void *prf, const void *in, void *out, long long n, \
      int nlanes, long long in_stride, long long out_stride, void *stream
#define LFZK_PASS \
  mode, fs, prf, in, out, n, nlanes, in_stride, out_stride, stream
extern "C" int fs_oracle_fp128(LFZK_ARGS) {
  return fs_oracle<P128>(LFZK_PASS);
}
extern "C" int fs_oracle_fp256(LFZK_ARGS) {
  return fs_oracle<P256>(LFZK_PASS);
}
extern "C" int fs_oracle_fp256k1(LFZK_ARGS) {
  return fs_oracle<P256K1>(LFZK_PASS);
}
extern "C" int fs_oracle_gf2_128(LFZK_ARGS) {
  return fs_oracle<G128>(LFZK_PASS);
}

#define LFZK_CHOOSE_ARGS                                                 \
  void *fs, void *prf, void *out, long long k, long long n, int nlanes, \
      void *stream
extern "C" int fs_choose_fp128(LFZK_CHOOSE_ARGS) {
  return fs_choose<P128>(fs, prf, out, k, n, nlanes, stream);
}
extern "C" int fs_choose_fp256(LFZK_CHOOSE_ARGS) {
  return fs_choose<P256>(fs, prf, out, k, n, nlanes, stream);
}
extern "C" int fs_choose_fp256k1(LFZK_CHOOSE_ARGS) {
  return fs_choose<P256K1>(fs, prf, out, k, n, nlanes, stream);
}
extern "C" int fs_choose_gf2_128(LFZK_CHOOSE_ARGS) {
  return fs_choose<G128>(fs, prf, out, k, n, nlanes, stream);
}
