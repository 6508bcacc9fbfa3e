// Times the parts of one K10 sumcheck_round_tail round (csrc/round_tail.cu)
// in one thread, with the card's cycle counter; tools/k2k10_bench.py builds
// it against each tree's csrc/ (-I) and runs it.  None is a kernel of the
// port.  It builds against both forms of csrc/fs.cuh: the byte-wise oracle
// (an FsState and a PrfState in local memory) and the word-wise one (the
// partial block as 16 words, AES-256 on words with a table in shared
// memory), for which the bench defines FS_WORDS (it finds FsW there).
//
// diag_k10_<field>(part, iters, io, cycles): one block of 32 threads
// runs `iters` iterations of one part, each fed by the last (so that none
// can be hoisted), all threads on the same values as K10 runs them (one
// thread with the byte-wise oracle); thread 0 writes the cycles of the loop to cycles[0] and a value that
// depends on every iteration to io.  Parts:
//
//   0  the two tagged absorbs of a hand-round (tag and ev_0, tag and ev_2)
//   1  fs_getkey (the fork-and-finalize digest)
//   2  the AES-256 key schedule and one counter block
//   3  a squeeze and one sample (getkey, key schedule, the draws)
//   4  the field algebra of a hand-round (the products before the absorb,
//      the natural forms, the Newton form after the sample)
//   5  one field product (the product K10 runs on its chain)
//   6  a whole hand-round (round_tail_lane, the kernel's body: every thread
//      of the block, the table filled each time), points 0-3 at a prime
//      field (the small constants), the state in io
//   7  the same, a copy round (the cubic mode)
// Parts 6 and 7 need the word-wise oracle; without it they time nothing.
#include "round_tail.cu"

#ifdef FS_WORDS
#define DIAG_MUL rt_mul<C>
#else
#define DIAG_MUL fp_mul
#endif

template <class C>
__global__ void k_diag_k10(int part, int iters, uint4* __restrict__ io,
                           long long* __restrict__ cycles) {
  typedef Fp<C> E;
#ifdef FS_WORDS
  __shared__ uint32_t T[256], RK[60], Q[16 * FS_QUEUE];
  aes_tables(T);
  __syncthreads();
#endif
  if (part >= 6) {
#ifdef FS_WORDS
    // io: consts (10 elements), a (3), eq0, pad (4), claim, row (5), then
    // the state at uint4 960
    const int npts = part == 6 ? 3 : 4;
    const int EU = (C::N + 3) / 4;  // uint4s an element
    uint4 *consts = io, *a = io + 10 * EU, *eq0 = io + 13 * EU,
          *pad = io + 14 * EU, *claim = io + 18 * EU, *row = io + 19 * EU;
    FsState* fsp = (FsState*)(io + 960);
    if (threadIdx.x == 0 && !Oracle<C>::RAW) {
      const E one = fp_one<C>(), two = fp_add(one, one);
      const E pts[10] = {fp_zero<C>(), one, two, one, one, rt_half(one),
                         fp_add(two, one), one, rt_half(one), one};
      for (int k = 0; k < 10; k++) pts[k].store(consts, k);
    }
    __syncwarp();
    const long long c0 = clock64();
    for (int it = 0; it < iters; it++)
      round_tail_lane<C>(0, fsp, claim, row, a, eq0, pad, consts, 0, 0,
                         npts, T, RK, Q);
    if (threadIdx.x == 0) cycles[0] = clock64() - c0;
#endif
    return;
  }
  // with the word-wise oracle every thread runs the part (K10's GF(2^128)
  // product takes the warp), else thread 0 alone; thread 0 writes
#ifndef FS_WORDS
  if (threadIdx.x != 0) return;
#endif
  E x = E::load(io, 0), y = E::load(io, 1), z = E::load(io, 2);
  uint32_t fb = 0u;
#ifdef FS_WORDS
  FsW s;
#pragma unroll
  for (int i = 0; i < 8; i++) s.h[i] = x.l[i & 3] ^ (uint32_t)i;
#pragma unroll
  for (int i = 0; i < 16; i++) s.w[i] = 0u;
  s.cnt = 64;
  uint32_t key[8], blk[4];
  uint32_t* rk = RK;
#pragma unroll
  for (int i = 0; i < 8; i++) key[i] = y.l[i & 3] + (uint32_t)i;
#else
  FsState s;
  for (int i = 0; i < 8; i++) s.h[i] = x.l[i & 3] ^ (uint32_t)i;
  for (int i = 0; i < 64; i++) s.buf[i] = 0;
  s.cnt = 64;
  uint8_t key[32], blk[16];
  PrfState p;
  for (int i = 0; i < 32; i++) key[i] = (uint8_t)(y.l[(i >> 2) & 3] >> i);
#endif
  const long long t0 = clock64();
  for (int it = 0; it < iters; it++) {
    switch (part) {
      case 0: {
        x.l[0] ^= fb;
#ifdef FS_WORDS
        fsw_absorb_tagged<C>(s, x);
        fsw_absorb_tagged<C>(s, y);
#else
        fs_absorb_byte(s, TAG_FIELD_ELEM);
        fs_absorb_elt(s, x);
        fs_absorb_byte(s, TAG_FIELD_ELEM);
        fs_absorb_elt(s, y);
#endif
        fb = s.h[0] ^ (uint32_t)s.cnt;
        break;
      }
      case 1: {
#ifdef FS_WORDS
        fsw_getkey(s, key);
        s.h[0] ^= key[0];
        fb ^= key[7];
#else
        fs_getkey(s, key);
        s.h[0] ^= key[0];
        fb ^= key[31];
#endif
        break;
      }
      case 2: {
#ifdef FS_WORDS
        aes_expand(key, rk, T);
        aes_block(rk, (u64)it, blk, T);
        key[0] ^= blk[0];
        fb ^= blk[3];
#else
        aes256_expand(key, p.rk);
        aes256_block(p.rk, (u64)it, blk);
        key[0] ^= blk[0];
        fb ^= blk[15];
#endif
        break;
      }
      case 3: {
#ifdef FS_WORDS
        fsw_getkey(s, key);
        aes_expand(key, rk, T);
        const E r = fresh_sample<C>(rk, T);
#else
        fs_squeeze(s, p);
        const E r = prf_sample<C>(p);
#endif
        s.h[1] ^= r.l[0];
        fb ^= r.l[1];
        break;
      }
      case 4: {
        // c0, c2, c1, raw_2, ev_0 and ev_2 in natural form, then the
        // Newton form at r = z
        const E c0 = DIAG_MUL(y, x), c2 = DIAG_MUL(y, z);
        const E c1 = fp_sub(fp_sub(fp_sub(x, c0), c0), c2);
        const E raw1 = fp_add(fp_add(c0, c1), c2);
        const E raw2 = fp_add(DIAG_MUL(fp_add(DIAG_MUL(c2, z), c1), z), c0);
        const E n0 = fs_natural(fp_sub(c0, y)), n2 = fs_natural(fp_sub(raw2, y));
        const E t1 = DIAG_MUL(fp_sub(raw1, c0), y);
        const E t2 = DIAG_MUL(fp_sub(DIAG_MUL(fp_sub(raw2, raw1), z), t1), y);
        const E r = fp_add(n0, n2);
        E e = fp_add(DIAG_MUL(t2, fp_sub(r, y)), t1);
        e = fp_add(DIAG_MUL(e, fp_sub(r, x)), c0);
        x = e;
        fb = e.l[0];
        break;
      }
      default:
        x = DIAG_MUL(x, y);
        fb = x.l[0];
        break;
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x != 0) return;
  cycles[0] = t1 - t0;
  io[3] = make_uint4(fb, s.h[0] ^ s.h[1], x.l[0], (uint32_t)s.cnt);
}

template <class C>
static int diag_k10(int part, int iters, void* io, void* cycles,
                    void* stream) {
  k_diag_k10<C><<<1, 32, 0, (cudaStream_t)stream>>>(
      part, iters, (uint4*)io, (long long*)cycles);
  return (int)cudaGetLastError();
}

#define LFZK_DIAG(tag, C)                                                 \
  extern "C" int diag_k10_##tag(int part, int iters, void* io,           \
                                void* cycles, void* stream) {            \
    return diag_k10<C>(part, iters, io, cycles, stream);                  \
  }
LFZK_DIAG(fp128, P128)
LFZK_DIAG(fp256, P256)
LFZK_DIAG(fp256k1, P256K1)
LFZK_DIAG(gf2_128, G128)
