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
// Bound on the H100: the chains.  A write's SHA-256 compressions follow
// one another (64 rounds each, about 6 dependent 32-bit operations a
// round on the path through e and a), a squeeze's key schedule (52
// dependent words) comes before any draw, and mode 9's walk is a chain
// of dependent steps; everything else is independent: the elements'
// Montgomery conversions, the byte layout (array header, tags), the
// message schedules, the counter blocks, the rejection tests and the
// products into Montgomery form.  So a block of K9_THREADS threads runs
// a lane (fs.cuh, the K9 section):
//   - writes (modes 0, 5, 6; k_fs_write): warps 1-7 produce stage k + 1
//     (K9_CHUNK blocks: the elements loaded and converted, the stream
//     laid out as big-endian words, each block's K[t] + W[t]) while lane
//     0 of warp 0 runs the 64 rounds of each block of stage k; the block
//     hands the stages over at a barrier (__syncthreads), the producers
//     share named barrier 1 among themselves;
//   - draws (modes 4, 7, 8; k_fs_draw): the key schedule (mode 8: the
//     squeeze first) in one thread, then windows of up to K9_THREADS
//     candidates: every counter block they touch computed by the block's
//     threads at once, each candidate tested and made Montgomery by its
//     own thread, a block-wide ordered count (warp ballots) keeping the
//     first n accepted; the stream stops after the n-th, where the host
//     Transcript.elt leaves it;
//   - getkey, a fresh stream and a squeeze (modes 1-3; k_fs_step): one
//     thread, the chain itself;
//   - mode 9 (k_fs_choose): the squeeze in one thread, the first
//     K9_PRE counter blocks by the block's threads, then the walk in one
//     thread.
// With lanes, the jax.vmap of the batch prover over these steps
// (zk/batch.py:301, :344).
#include "fs.cuh"

enum { K9_ABSORB, K9_GETKEY, K9_PRF_FRESH, K9_SQUEEZE, K9_PRF_BYTES,
       K9_WRITE_ARRAY, K9_WRITE_TAGGED, K9_SAMPLE, K9_SQUEEZE_SAMPLE };

// Modes 0, 5 and 6: fs absorbs in (MODE 0: n bytes; 5: an array of n
// elements; 6: n tagged elements) as K9Write lays the stream out.
template <class C, int MODE>
__global__ void __launch_bounds__(K9_THREADS)
    k_fs_write(FsState* __restrict__ fs, const uint8_t* __restrict__ in,
               long long n, long long in_stride) {
  __shared__ K9WriteSmem<C> sm;
  const int tid = threadIdx.x;
  fs += blockIdx.x;
  in += blockIdx.x * in_stride;
  const u64 cnt = fs->cnt;
  const K9Write w = k9w_plan<C, MODE>(cnt, (u64)n);
  if (tid < 16) sm.old[tid] = ((const uint32_t*)fs->buf)[tid];
  uint32_t h[8];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 8; i++) h[i] = fs->h[i];
  }
  __syncthreads();
  const u64 nstage = (w.nfull + K9_CHUNK) / K9_CHUNK;  // block nfull too
  for (u64 c = 0; c <= nstage; c++) {
    if (tid < 32) {
      if (tid == 0 && c > 0) k9w_chain(w, sm, c - 1, h);
      __syncwarp();
    } else if (c < nstage) {
      k9w_produce<C, MODE>(w, sm, c, tid - 32, K9_PRODUCERS, in,
                           K9ProducerSync());
    }
    __syncthreads();
  }
  if (tid == 0) k9w_store(fs, h, cnt, w, sm.part);
}

// Modes 4, 7 and 8: the next n bytes of prf (4), n elements sampled from
// prf (7), or a fresh squeeze of fs into prf and then the samples (8).
// A window's blocks, from the one holding the stream position P up to
// the one after its last candidate's last byte: the state's saved block
// where the draws end there.
constexpr int K9_WIN_BLOCKS = (15 + K9_THREADS * 32 + 15) / 16 + 1;

template <class C>
__global__ void __launch_bounds__(K9_THREADS)
    k_fs_draw(int mode, const FsState* __restrict__ fs,
              PrfState* __restrict__ prf, uint8_t* __restrict__ out,
              long long n, long long out_stride) {
  constexpr uint32_t L = Oracle<C>::KBYTES;
  __shared__ uint32_t T[256], RK[60], S[4 * K9_WIN_BLOCKS + 4];
  __shared__ int wcount[K9_THREADS / 32], last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  fs += blockIdx.x;
  prf += blockIdx.x;
  out += blockIdx.x * out_stride;
  aes_tables(T);
  u64 P = 0;
  if (mode == K9_SQUEEZE_SAMPLE) {
    __syncthreads();
    if (tid == 0) {
      FsW s;
      uint32_t key[8];
      fsw_load(s, fs);
      fsw_getkey(s, key);
      aes_expand(key, RK, T);
    }
  } else {
    for (int i = tid; i < 60; i += K9_THREADS) RK[i] = prf->rk[i];
    P = prf_pos(prf);
  }
  __syncthreads();
  if (mode == K9_PRF_BYTES) {
    const u64 b0 = P >> 4, q0 = P & 15;
    const u64 nall = (q0 + (u64)n) / 16 + 1;  // to the block of P + n
    for (u64 i = tid; i < nall; i += K9_THREADS) {
      uint32_t blk[4];
      aes_block(RK, b0 + i, blk, T);
#pragma unroll
      for (int k = 0; k < 16; k++) {
        const long long pos = (long long)(16 * i + k) - (long long)q0;
        if (pos >= 0 && pos < n)
          out[pos] = (uint8_t)(blk[k >> 2] >> (8 * (k & 3)));
      }
      if (i == nall - 1) {
#pragma unroll
        for (int k = 0; k < 4; k++) prf->saved[k] = blk[k];
      }
    }
    if (tid == 0) {
      prf->nb = b0 + nall;
      prf->ptr = (uint32_t)((q0 + (u64)n) & 15);
      prf->pad = 0u;
    }
    return;
  }
  u64 done = 0, b0 = 0;
  int nblk = 0;
  while (done < (u64)n) {
    const int M = (int)k9_min((u64)K9_THREADS, (u64)n - done);
    const uint32_t q0 = (uint32_t)(P & 15);
    b0 = P >> 4;
    nblk = (int)((q0 + (uint32_t)M * L + 15) / 16) + 1;
    k9d_blocks(RK, b0, nblk, S, tid, K9_THREADS, T);
    __syncthreads();
    Fp<C> x;
    bool ok = false;
    if (tid < M) {
      x = k9d_candidate<C>(S, q0 + (uint32_t)tid * L);
      ok = fs_accept(x);
    }
    const uint32_t ball = __ballot_sync(0xFFFFFFFFu, ok);
    if (lane == 0) wcount[warp] = __popc(ball);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int k = 0; k < K9_THREADS / 32; k++) {
      before += k < warp ? wcount[k] : 0;
      total += wcount[k];
    }
    const u64 rank = done + (u64)before +
                     (u64)__popc(ball & ((1u << lane) - 1u));
    if (ok && rank < (u64)n) x.store((uint4*)out, (long long)rank);
    if (ok && rank == (u64)n - 1) last = tid;
    __syncthreads();
    if (done + (u64)total >= (u64)n) {
      P += (u64)(last + 1) * L;
      done = n;
    } else {
      P += (u64)M * L;
      done += (u64)total;
    }
  }
  if (tid == 0) k9d_settle(prf, P, S, b0, nblk, RK, T);
}

// Modes 1-3: the key of fs (1), a fresh stream keyed by in[32] (2) or by
// fs (3): one thread, the chain itself.
template <class C>
__global__ void k_fs_step(int mode, const FsState* __restrict__ fs,
                          PrfState* __restrict__ prf,
                          const uint8_t* __restrict__ in,
                          uint8_t* __restrict__ out, long long in_stride,
                          long long out_stride) {
  __shared__ uint32_t T[256], RK[60];
  fs += blockIdx.x;
  prf += blockIdx.x;
  in += blockIdx.x * in_stride;
  out += blockIdx.x * out_stride;
  if (mode != K9_GETKEY) {
    aes_tables(T);
    __syncwarp();
  }
  if (threadIdx.x != 0) return;
  uint32_t key[8];
  if (mode == K9_PRF_FRESH) {
#pragma unroll
    for (int i = 0; i < 8; i++)
      key[i] = (uint32_t)in[4 * i] | ((uint32_t)in[4 * i + 1] << 8) |
               ((uint32_t)in[4 * i + 2] << 16) |
               ((uint32_t)in[4 * i + 3] << 24);
  } else {
    FsW s;
    fsw_load(s, fs);
    fsw_getkey(s, key);
  }
  if (mode == K9_GETKEY) {
#pragma unroll
    for (int i = 0; i < 32; i++)
      out[i] = (uint8_t)(key[i >> 2] >> (8 * (i & 3)));
    return;
  }
  aes_expand(key, RK, T);
  k9d_settle(prf, 0, nullptr, 0, 0, RK, T);
}

// Mode 9 CHOOSE: a fresh squeeze of fs into prf, then the partial
// Fisher-Yates walk of Transcript.choose (reference random.h:57-105),
// which leaves prf where the walk's last draw ended.  Step i draws
// r < m = n - i by rejection: l bytes of the stream, the least l with
// m < 256^l (recomputed each step: it shrinks when m crosses a power of
// 256), little-endian, masked to the bits of m; then swaps A[i] and
// A[i + r] and outputs the new A[i].  The block's threads fill A = 0..n-1
// (in shared memory when it fits, else in out[k..k+n)) and the AES
// table; after the squeeze (one thread) they compute the stream's first
// K9_PRE counter blocks (1 KB: a walk of 128 steps over 1,367-3,230
// columns reads about 400 bytes), and thread 0 walks, every step
// depending on the last, computing a block itself past them.  The
// chain: the squeeze, the key schedule, one AES block, then a few
// instructions and two dependent accesses of A a step.  Lanes: block b
// walks lane b's own stream (fs[b], prf[b]) into out + b (k + n), each
// with its array in its own shared memory.
constexpr long long CHOOSE_SMEM_MAX = 12288;  // 48 KB of int
constexpr int K9_PRE = 64;

template <class C>
__global__ void __launch_bounds__(K9_THREADS)
    k_fs_choose(const FsState* __restrict__ fs, PrfState* __restrict__ prf,
                int* __restrict__ out, long long k, long long n) {
  extern __shared__ int smem[];
  __shared__ uint32_t T[256], RK[60], S[4 * K9_PRE];
  const long long lane = blockIdx.x;
  fs += lane;
  prf += lane;
  out += lane * (k + n);
  int* A = n <= CHOOSE_SMEM_MAX ? smem : out + k;
  for (long long j = threadIdx.x; j < n; j += blockDim.x) A[j] = (int)j;
  aes_tables(T);
  __syncthreads();
  if (threadIdx.x == 0) {
    FsW s;
    uint32_t key[8];
    fsw_load(s, fs);
    fsw_getkey(s, key);
    aes_expand(key, RK, T);
  }
  __syncthreads();
  k9d_blocks(RK, 0, K9_PRE, S, threadIdx.x, blockDim.x, T);
  __syncthreads();
  if (threadIdx.x != 0) return;
  K9Reader rd;
  rd.S = S;
  rd.rk = RK;
  rd.T = T;
  rd.npre = K9_PRE;
  rd.pos = 0;
  rd.cur = ~0ull;
  for (long long i = 0; i < k; i++) {
    const uint32_t m = (uint32_t)(n - i);
    const int bits = 32 - __clz(m);
    const int l = (bits + 7) / 8;
    const uint32_t msk = bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
    uint32_t r;
    do {
      r = 0u;
      for (int b = 0; b < l; b++) r |= rd.byte() << (8 * b);
      r &= msk;
    } while (r >= m);
    const long long j = i + r;
    const int ai = A[i], aj = A[j];
    A[i] = aj;
    A[j] = ai;
    out[i] = aj;
  }
  k9d_settle(prf, rd.pos, S, 0, K9_PRE, RK, T);
}

// out: nlanes x (k + n) ints.
template <class C>
static int fs_choose(void* fs, void* prf, void* out, long long k,
                     long long n, int nlanes, void* stream) {
  if (k <= 0 || k > n || n >= (1ll << 31) || nlanes <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = n <= CHOOSE_SMEM_MAX ? (size_t)n * sizeof(int) : 0;
  static const cudaError_t set = cudaFuncSetAttribute(
      k_fs_choose<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(CHOOSE_SMEM_MAX * sizeof(int)));
  if (set != cudaSuccess) return (int)set;
  k_fs_choose<C><<<nlanes, K9_THREADS, smem, (cudaStream_t)stream>>>(
      (const FsState*)fs, (PrfState*)prf, (int*)out, k, n);
  return (int)cudaGetLastError();
}

template <class C>
static int fs_oracle(int mode, void* fs, void* prf, const void* in,
                     void* out, long long n, int nlanes, long long in_stride,
                     long long out_stride, void* stream) {
  if (mode < 0 || mode > 8 || nlanes <= 0 || n < 0 || n >= (1ll << 26))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  FsState* f = (FsState*)fs;
  const uint8_t* i = (const uint8_t*)in;
  switch (mode) {
    case K9_ABSORB:
      k_fs_write<C, K9_ABSORB><<<nlanes, K9_THREADS, 0, s>>>(f, i, n,
                                                              in_stride);
      break;
    case K9_WRITE_ARRAY:
      k_fs_write<C, K9_WRITE_ARRAY><<<nlanes, K9_THREADS, 0, s>>>(
          f, i, n, in_stride);
      break;
    case K9_WRITE_TAGGED:
      k_fs_write<C, K9_WRITE_TAGGED><<<nlanes, K9_THREADS, 0, s>>>(
          f, i, n, in_stride);
      break;
    case K9_PRF_BYTES:
    case K9_SAMPLE:
    case K9_SQUEEZE_SAMPLE:
      k_fs_draw<C><<<nlanes, K9_THREADS, 0, s>>>(
          mode, f, (PrfState*)prf, (uint8_t*)out, n, out_stride);
      break;
    default:
      k_fs_step<C><<<nlanes, 32, 0, s>>>(mode, f, (PrfState*)prf, i,
                                         (uint8_t*)out, in_stride,
                                         out_stride);
  }
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
