// The Fiat-Shamir oracle on the card, byte-exact twin of the host
// Transcript / FSPRF (random_oracle/transcript.py; reference
// lib/random/transcript.h:33-193).  Shared by K9 (fs.cu) and K10
// (round_tail.cu).
//
//   FsState   the host Transcript's export_state blob (104 bytes): the
//             SHA-256 midstate h (native words), the absorbed byte count
//             cnt and the partial block buf (bytes at cnt % 64 and above
//             are zero);
//   PrfState  an FSPRF stream (272 bytes): the AES-256 round keys rk (60
//             little-endian words: the 240 key-schedule bytes in order),
//             the current counter block's output saved, the next counter
//             nb and the read pointer ptr into saved.  A read that ends a
//             block computes the next one at once (as the JAX package's
//             prf_bytes does), so ptr < 16: the stream position is
//             16 (nb - 1) + ptr and saved is block nb - 1.
//
// Replaces the JAX package's random_oracle/device_fs.py:53-357
// (fs_absorb, fs_getkey, aes256_expand, aes256_block, prf_fresh,
// fs_squeeze, prf_bytes, fs_write_elts, dev_elt_bytes, dev_sample_elt(s))
// and sumcheck/prover_device.py:248 _write_tagged_elts.
//
// The oracle works on 32-bit words in registers.  A kernel loads an
// FsState into an FsW: the partial block as 16 big-endian words, as
// SHA-256 reads them.  An absorb places a message of at most 64 bytes,
// given as big-endian words, at the byte offset cnt % 64 with funnel
// shifts and a 4-stage barrel shift over a 32-word window (no register
// is indexed at run time), and queues the block when it fills.
// AES-256 runs on the state's four columns as little-endian words with
// one table T in shared memory, T[x] = (2 S(x), S(x), S(x), 3 S(x)) as a
// word (MixColumns of a column's row-0 byte; rows 1-3 are its rotations,
// S(x) is its byte 1), filled by the block's threads from AES_SBOX in
// global memory (aes_tables); the key schedule's 60 words go to shared
// memory, the middle rounds run as a loop.  K10 draws whole 16-byte
// blocks from a fresh stream (fresh_sample), in one thread, once a
// launch: its time is set by the instructions it issues and fetches, so
// the code is kept short where it repeats (the compression and the AES
// rounds as loops, long products as calls), and K10 compresses its
// blocks in one loop (the queue, fsw_run_queue).  K9 spreads its writes
// and draws over a block of threads (the K9 section at the end): one
// thread runs only the SHA-256 rounds and the key schedule, the chains.
//
// The typed writes take field elements as the kernels hold them
// (Montgomery limbs for a prime field, polynomial bits for GF(2^128))
// and absorb their natural little-endian kBytes; sampling rejects draws
// of exact_bits bits that are not below p, exactly as the host
// Field.sample, and returns the accepted element in the kernels' form.
#pragma once

#include "gf2.cuh"
#include "sha256.cuh"

struct FsState {
  uint32_t h[8];
  u64 cnt;
  uint8_t buf[64];
};

struct PrfState {
  uint32_t rk[60];
  uint32_t saved[4];
  u64 nb;
  uint32_t ptr;
  uint32_t pad;
};

static_assert(sizeof(FsState) == 104, "FsState is the 104-byte host blob");
static_assert(sizeof(PrfState) == 272, "PrfState layout");

enum { TAG_BSTR = 0, TAG_FIELD_ELEM = 1, TAG_ARRAY = 2 };

// Per field: the bytes of an element (kBytes) and the bits of a draw
// (exact_bits, a whole number of bytes, kBytes of them); RAW for
// GF(2^128), whose draws are kBytes raw bytes with no rejection and no
// Montgomery form.
template <class C>
struct Oracle;
template <>
struct Oracle<P128> {
  static constexpr int KBYTES = 16, EXACT_BITS = 128;
  static constexpr bool RAW = false;
};
template <>
struct Oracle<P256> {
  static constexpr int KBYTES = 32, EXACT_BITS = 256;
  static constexpr bool RAW = false;
};
template <>
struct Oracle<P256K1> {
  static constexpr int KBYTES = 32, EXACT_BITS = 256;
  static constexpr bool RAW = false;
};
template <>
struct Oracle<G128> {
  static constexpr int KBYTES = 16, EXACT_BITS = 128;
  static constexpr bool RAW = true;
};

// ---------------------------------------------------------------------
// SHA-256 absorb and the fork-and-finalize key
// ---------------------------------------------------------------------

struct FsW {
  uint32_t h[8];
  u64 cnt;
  uint32_t w[16];  // the partial block, big-endian words
};

__device__ __forceinline__ void fsw_load(FsW& s, const FsState* f) {
  const uint2* b = (const uint2*)f->buf;
#pragma unroll
  for (int i = 0; i < 8; i++) s.h[i] = f->h[i];
  s.cnt = f->cnt;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint2 v = b[i];
    s.w[2 * i] = be32(v.x);
    s.w[2 * i + 1] = be32(v.y);
  }
}

__device__ __forceinline__ void fsw_store(FsState* f, const FsW& s) {
  uint2* b = (uint2*)f->buf;
#pragma unroll
  for (int i = 0; i < 8; i++) f->h[i] = s.h[i];
  f->cnt = s.cnt;
#pragma unroll
  for (int i = 0; i < 8; i++)
    b[i] = make_uint2(be32(s.w[2 * i]), be32(s.w[2 * i + 1]));
}

// One SHA-256 round: the working variables v = (a, b, ..., h) move by one
// (v[(8 - r) & 7] is a at round r: the caller unrolls by 8 or 16, so no
// register is indexed at run time).
#define FS_ROUND(a, b, c, d, e, f, g, h, kw)                             \
  {                                                                     \
    const uint32_t t1 = h + (sha_rotr(e, 6) ^ sha_rotr(e, 11) ^         \
                             sha_rotr(e, 25)) + ((e & f) ^ (~e & g)) +  \
                        (kw);                                           \
    d += t1;                                                            \
    h = t1 + (sha_rotr(a, 2) ^ sha_rotr(a, 13) ^ sha_rotr(a, 22)) +     \
        ((a & b) ^ (a & c) ^ (b & c));                                  \
  }

// h <- compress(h, w), w the 16 big-endian words of one block: the first
// 16 rounds unrolled, the other 48 as a loop of 3 over 16 unrolled ones
// (the schedule's ring of 16 words indexed by constants), so that the
// oracle's one thread runs about 800 instructions from the instruction
// cache, not 1,600 unrolled ones streamed for each of its compressions
// (sha256.cuh's unrolled compression is K8's, many messages a launch).
__device__ __forceinline__ void fs_compress(uint32_t h[8],
                                            const uint32_t* win) {
  uint32_t w[16], v[8];
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = win[i];
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = h[i];
#pragma unroll
  for (int j = 0; j < 16; j++)
    FS_ROUND(v[(8 - j) & 7], v[(9 - j) & 7], v[(10 - j) & 7],
             v[(11 - j) & 7], v[(12 - j) & 7], v[(13 - j) & 7],
             v[(14 - j) & 7], v[(15 - j) & 7], SHA256_K[j] + w[j]);
#pragma unroll 1
  for (int it = 1; it < 4; it++) {
    const uint32_t* K = SHA256_K + 16 * it;
#pragma unroll
    for (int j = 0; j < 16; j++) {
      const uint32_t w15 = w[(j + 1) & 15], w2 = w[(j + 14) & 15];
      w[j] += (sha_rotr(w15, 7) ^ sha_rotr(w15, 18) ^ (w15 >> 3)) +
              w[(j + 9) & 15] +
              (sha_rotr(w2, 17) ^ sha_rotr(w2, 19) ^ (w2 >> 10));
      FS_ROUND(v[(8 - j) & 7], v[(9 - j) & 7], v[(10 - j) & 7],
               v[(11 - j) & 7], v[(12 - j) & 7], v[(13 - j) & 7],
               v[(14 - j) & 7], v[(15 - j) & 7], K[j] + w[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] += v[i];
}

// K10 defers its compressions: the blocks its absorbs and its key fill go
// to a queue in shared memory, which one loop compresses (fsw_run_queue),
// so that the compression's code runs from one place.  FS_QUEUE blocks of
// 16 words: at most 2 absorbed (99 bytes after at most 63) and 2 final,
// and fsw_key_blocks writes a second final block's words even where the
// key takes one.
constexpr int FS_QUEUE = 5;

// s absorbs the first L bytes (L <= 64) of the big-endian words m[0..M),
// whose bytes past L are zero; a block it fills goes to Q[*nq] (every
// thread of the warp writes the same words) and s.h is left as it was
// (K10 compresses its queue in one loop, fsw_run_queue).
template <int M>
__device__ __forceinline__ void fsw_absorb(FsW& s, const uint32_t (&m)[M],
                                           int L, uint32_t* Q, int* nq) {
  static_assert(M <= 16, "a message of at most 64 bytes");
  const uint32_t off = (uint32_t)s.cnt & 63u;
  const uint32_t sh = (off & 3u) * 8u, q = off >> 2;
  // m moved by off bytes into a 32-word window: by sh bits, then by q
  // words
  uint32_t v[32];
#pragma unroll
  for (int k = 0; k < 32; k++) {
    if (k < M)
      v[k] = __funnelshift_r(m[k], k > 0 ? m[k - 1] : 0u, sh);
    else if (k == M)
      v[k] = __funnelshift_r(0u, m[M - 1], sh);
    else
      v[k] = 0u;
  }
#pragma unroll
  for (int b = 1; b < 16; b <<= 1) {
    const bool on = (q & (uint32_t)b) != 0u;
#pragma unroll
    for (int j = 31; j >= 0; j--)
      v[j] = on ? (j >= b ? v[j - b] : 0u) : v[j];
  }
#pragma unroll
  for (int j = 0; j < 16; j++) s.w[j] |= v[j];
  if (off + (uint32_t)L >= 64u) {
#pragma unroll
    for (int j = 0; j < 16; j++) Q[16 * *nq + j] = s.w[j];
    ++*nq;
#pragma unroll
    for (int j = 0; j < 16; j++) s.w[j] = v[16 + j];
  }
  s.cnt += (u64)L;
}

// The padded final block(s) of the state (one, or two when the padding
// does not fit: cnt % 64 >= 56) to the queue Q after *nq: the fork and
// finalize of fsw_getkey.
__device__ __forceinline__ void fsw_key_blocks(const FsW& s, uint32_t* Q,
                                               int* nq) {
  const uint32_t off = (uint32_t)s.cnt & 63u, q = off >> 2;
  const uint32_t bit = 0x80000000u >> (8u * (off & 3u));
  const u64 bits = s.cnt << 3;
  const bool two = off >= 56u;
  uint32_t* b = Q + 16 * *nq;
#pragma unroll
  for (int j = 0; j < 16; j++) {
    const uint32_t w = s.w[j] | ((uint32_t)j == q ? bit : 0u);
    const uint32_t len = j == 14 ? (uint32_t)(bits >> 32)
                                 : j == 15 ? (uint32_t)bits : 0u;
    b[j] = two ? w : w | len;
    b[16 + j] = len;
  }
  *nq += two ? 2 : 1;
}

// The digest of a copy of the state as the key: its 32 bytes as 8
// little-endian words (AES's form).
__device__ __forceinline__ void fsw_getkey(const FsW& s, uint32_t key[8]) {
  uint32_t b[32], h[8];
  int n = 0;
  fsw_key_blocks(s, b, &n);
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] = s.h[i];
  fs_compress(h, b);
  if (n == 2) fs_compress(h, b + 16);
#pragma unroll
  for (int i = 0; i < 8; i++) key[i] = be32(h[i]);
}

// Compresses the queue's nq blocks from s.h: s.h becomes the midstate
// after its first nabs (the absorbs' blocks), key the digest after all
// of them (fsw_getkey's key, where the last blocks are fsw_key_blocks').
__device__ __forceinline__ void fsw_run_queue(FsW& s, const uint32_t* Q,
                                              int nq, int nabs,
                                              uint32_t key[8]) {
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] = s.h[i];
#pragma unroll 1
  for (int b = 0; b < nq; b++) {
    fs_compress(h, Q + 16 * b);
    if (b == nabs - 1) {
#pragma unroll
      for (int i = 0; i < 8; i++) s.h[i] = h[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; i++) key[i] = be32(h[i]);
}

// ---------------------------------------------------------------------
// AES-256 (encryption only) in counter mode: the FSPRF
// ---------------------------------------------------------------------

__device__ const uint8_t AES_SBOX[256] = {
    0x63, 0x7C, 0x77, 0x7B, 0xF2, 0x6B, 0x6F, 0xC5, 0x30, 0x01, 0x67, 0x2B,
    0xFE, 0xD7, 0xAB, 0x76, 0xCA, 0x82, 0xC9, 0x7D, 0xFA, 0x59, 0x47, 0xF0,
    0xAD, 0xD4, 0xA2, 0xAF, 0x9C, 0xA4, 0x72, 0xC0, 0xB7, 0xFD, 0x93, 0x26,
    0x36, 0x3F, 0xF7, 0xCC, 0x34, 0xA5, 0xE5, 0xF1, 0x71, 0xD8, 0x31, 0x15,
    0x04, 0xC7, 0x23, 0xC3, 0x18, 0x96, 0x05, 0x9A, 0x07, 0x12, 0x80, 0xE2,
    0xEB, 0x27, 0xB2, 0x75, 0x09, 0x83, 0x2C, 0x1A, 0x1B, 0x6E, 0x5A, 0xA0,
    0x52, 0x3B, 0xD6, 0xB3, 0x29, 0xE3, 0x2F, 0x84, 0x53, 0xD1, 0x00, 0xED,
    0x20, 0xFC, 0xB1, 0x5B, 0x6A, 0xCB, 0xBE, 0x39, 0x4A, 0x4C, 0x58, 0xCF,
    0xD0, 0xEF, 0xAA, 0xFB, 0x43, 0x4D, 0x33, 0x85, 0x45, 0xF9, 0x02, 0x7F,
    0x50, 0x3C, 0x9F, 0xA8, 0x51, 0xA3, 0x40, 0x8F, 0x92, 0x9D, 0x38, 0xF5,
    0xBC, 0xB6, 0xDA, 0x21, 0x10, 0xFF, 0xF3, 0xD2, 0xCD, 0x0C, 0x13, 0xEC,
    0x5F, 0x97, 0x44, 0x17, 0xC4, 0xA7, 0x7E, 0x3D, 0x64, 0x5D, 0x19, 0x73,
    0x60, 0x81, 0x4F, 0xDC, 0x22, 0x2A, 0x90, 0x88, 0x46, 0xEE, 0xB8, 0x14,
    0xDE, 0x5E, 0x0B, 0xDB, 0xE0, 0x32, 0x3A, 0x0A, 0x49, 0x06, 0x24, 0x5C,
    0xC2, 0xD3, 0xAC, 0x62, 0x91, 0x95, 0xE4, 0x79, 0xE7, 0xC8, 0x37, 0x6D,
    0x8D, 0xD5, 0x4E, 0xA9, 0x6C, 0x56, 0xF4, 0xEA, 0x65, 0x7A, 0xAE, 0x08,
    0xBA, 0x78, 0x25, 0x2E, 0x1C, 0xA6, 0xB4, 0xC6, 0xE8, 0xDD, 0x74, 0x1F,
    0x4B, 0xBD, 0x8B, 0x8A, 0x70, 0x3E, 0xB5, 0x66, 0x48, 0x03, 0xF6, 0x0E,
    0x61, 0x35, 0x57, 0xB9, 0x86, 0xC1, 0x1D, 0x9E, 0xE1, 0xF8, 0x98, 0x11,
    0x69, 0xD9, 0x8E, 0x94, 0x9B, 0x1E, 0x87, 0xE9, 0xCE, 0x55, 0x28, 0xDF,
    0x8C, 0xA1, 0x89, 0x0D, 0xBF, 0xE6, 0x42, 0x68, 0x41, 0x99, 0x2D, 0x0F,
    0xB0, 0x54, 0xBB, 0x16};

// T[x] from the S-box word sw (S(4i) .. S(4i + 3), little-endian), x = 4i
// + k.
__device__ __forceinline__ uint32_t aes_t_entry(uint32_t sw, int k) {
  const uint32_t s = (sw >> (8 * k)) & 0xFFu;
  const uint32_t s2 = ((s << 1) ^ ((s >> 7) * 0x1Bu)) & 0xFFu;
  return s2 | (s << 8) | (s << 16) | ((s2 ^ s) << 24);
}

// Fills T[256] from AES_SBOX; every thread of the block calls it, and the
// block synchronises before the first use.
__device__ __forceinline__ void aes_tables(uint32_t* T) {
  const uint32_t* sb = (const uint32_t*)AES_SBOX;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    const uint32_t sw = __ldg(sb + i);
#pragma unroll
    for (int k = 0; k < 4; k++) T[4 * i + k] = aes_t_entry(sw, k);
  }
}

// S(x) in byte r of a word, from T.
__device__ __forceinline__ uint32_t aes_s(const uint32_t* T, uint32_t x,
                                          int r) {
  const uint32_t t = T[x & 0xFFu];
  return r == 0 ? (t >> 8) & 0xFFu
                : r == 1 ? t & 0xFF00u
                         : r == 2 ? (t << 8) & 0xFF0000u
                                  : (t << 16) & 0xFF000000u;
}

__device__ __forceinline__ uint32_t aes_subword(const uint32_t* T,
                                                uint32_t w) {
  return aes_s(T, w, 0) | aes_s(T, w >> 8, 1) | aes_s(T, w >> 16, 2) |
         aes_s(T, w >> 24, 3);
}

// The 60 round-key words of a 32-byte key (FIPS-197 5.2, Nk = 8) into rk
// (shared memory, which the rounds index by their number; every thread
// that calls it writes the same words).
__device__ __forceinline__ void aes_expand(const uint32_t key[8],
                                           uint32_t* rk, const uint32_t* T) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    w[i] = key[i];
    rk[i] = w[i];
  }
#pragma unroll
  for (int i = 8; i < 60; i++) {
    uint32_t t = w[(i - 1) & 7];
    if (i % 8 == 0)
      t = aes_subword(T, __funnelshift_r(t, t, 8)) ^ (1u << (i / 8 - 1));
    else if (i % 8 == 4)
      t = aes_subword(T, t);
    w[i & 7] ^= t;
    rk[i] = w[i & 7];
  }
}

__device__ __forceinline__ uint32_t aes_col(const uint32_t* T, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  const uint32_t ta = T[a & 0xFFu], tb = T[(b >> 8) & 0xFFu],
                 tc = T[(c >> 16) & 0xFFu], td = T[d >> 24];
  return ta ^ __funnelshift_l(tb, tb, 8) ^ __funnelshift_l(tc, tc, 16) ^
         __funnelshift_l(td, td, 24);
}

__device__ __forceinline__ uint32_t aes_last_col(const uint32_t* T,
                                                 uint32_t a, uint32_t b,
                                                 uint32_t c, uint32_t d) {
  return aes_s(T, a, 0) | aes_s(T, b >> 8, 1) | aes_s(T, c >> 16, 2) |
         aes_s(T, d >> 24, 3);
}

// out[4 b + c] = the encryption of the counter block LE64(ctr + b) || 0^8
// for b < NB, as four little-endian words (column c, rows 0-3 from its low
// byte up): the NB blocks side by side through a loop over the 13 middle
// rounds (one round's code; rk in shared memory).
template <int NB>
__device__ __forceinline__ void aes_ctr(const uint32_t* rk, u64 ctr,
                                        uint32_t* out, const uint32_t* T) {
  uint32_t s[NB][4];
#pragma unroll
  for (int b = 0; b < NB; b++) {
    const u64 c = ctr + (u64)b;
    s[b][0] = (uint32_t)c ^ rk[0];
    s[b][1] = (uint32_t)(c >> 32) ^ rk[1];
    s[b][2] = rk[2];
    s[b][3] = rk[3];
  }
#pragma unroll 1
  for (int r = 1; r < 14; r++) {
    const uint32_t k0 = rk[4 * r], k1 = rk[4 * r + 1], k2 = rk[4 * r + 2],
                   k3 = rk[4 * r + 3];
#pragma unroll
    for (int b = 0; b < NB; b++) {
      const uint32_t t0 = aes_col(T, s[b][0], s[b][1], s[b][2], s[b][3]) ^ k0;
      const uint32_t t1 = aes_col(T, s[b][1], s[b][2], s[b][3], s[b][0]) ^ k1;
      const uint32_t t2 = aes_col(T, s[b][2], s[b][3], s[b][0], s[b][1]) ^ k2;
      const uint32_t t3 = aes_col(T, s[b][3], s[b][0], s[b][1], s[b][2]) ^ k3;
      s[b][0] = t0;
      s[b][1] = t1;
      s[b][2] = t2;
      s[b][3] = t3;
    }
  }
#pragma unroll
  for (int b = 0; b < NB; b++) {
    out[4 * b] = aes_last_col(T, s[b][0], s[b][1], s[b][2], s[b][3]) ^ rk[56];
    out[4 * b + 1] =
        aes_last_col(T, s[b][1], s[b][2], s[b][3], s[b][0]) ^ rk[57];
    out[4 * b + 2] =
        aes_last_col(T, s[b][2], s[b][3], s[b][0], s[b][1]) ^ rk[58];
    out[4 * b + 3] =
        aes_last_col(T, s[b][3], s[b][0], s[b][1], s[b][2]) ^ rk[59];
  }
}

__device__ __forceinline__ void aes_block(const uint32_t* rk, u64 ctr,
                                          uint32_t out[4],
                                          const uint32_t* T) {
  aes_ctr<1>(rk, ctr, out, T);
}

// ---------------------------------------------------------------------
// field elements: serialization and rejection sampling
// ---------------------------------------------------------------------

// The oracle's products: fp.cuh's fp_mul, a call of one copy of it where
// its unrolled code is long (8 words and more: about 500 instructions),
// for the instruction cache's sake (see fs_compress).
template <class C>
__device__ __noinline__ Fp<C> fs_mul_call(Fp<C> a, Fp<C> b) {
  return fp_mul(a, b);
}

template <class C>
__device__ __forceinline__ Fp<C> fs_mul(const Fp<C>& a, const Fp<C>& b) {
  if constexpr (C::N >= 8)
    return fs_mul_call<C>(a, b);
  else
    return fp_mul(a, b);
}

// The natural value of an element as the kernels hold it.
template <class C>
__device__ __forceinline__ Fp<C> fs_natural(const Fp<C>& x) {
  if constexpr (Oracle<C>::RAW) {
    return x;
  } else {
    Fp<C> one = fp_zero<C>();
    one.l[0] = 1u;
    return fs_mul(x, one);
  }
}

// s absorbs x's natural kBytes after the tag byte of a field element
// (Transcript.write_elt), its block deferred to the queue (K10).
template <class C>
__device__ __forceinline__ void fsw_absorb_tagged_q(FsW& s, const Fp<C>& x,
                                                    uint32_t* Q, int* nq) {
  constexpr int KW = Oracle<C>::KBYTES / 4;
  const Fp<C> v = fs_natural(x);
  uint32_t m[KW + 1];
  uint32_t prev = TAG_FIELD_ELEM;
#pragma unroll
  for (int k = 0; k < KW; k++) {
    const uint32_t e = be32(v.l[k]);
    m[k] = __funnelshift_r(e, prev, 8);
    prev = e;
  }
  m[KW] = prev << 24;
  fsw_absorb<KW + 1>(s, m, Oracle<C>::KBYTES + 1, Q, nq);
}

// A draw x of exact_bits bits (kBytes little-endian): the element in the
// kernels' form, or false where a prime field rejects it (x >= p).
template <class C>
__device__ __forceinline__ bool fs_accept(Fp<C>& x) {
  if constexpr (Oracle<C>::RAW) {
    return true;
  } else {
    uint32_t borrow = 0;
#pragma unroll
    for (int j = 0; j < C::N; j++) {
      u64 d = (u64)x.l[j] - C::p(j) - borrow;
      borrow = (uint32_t)(d >> 63);
    }
    if (borrow) x = fs_mul(x, fp_r2<C>());
    return borrow != 0u;
  }
}

// One element from a fresh stream keyed by rk (K10): the draws are whole
// counter blocks from counter 0 (kBytes is 16 or 32), computed side by
// side.
template <class C>
__device__ __forceinline__ Fp<C> fresh_sample(const uint32_t* rk,
                                              const uint32_t* T) {
  constexpr int NBLK = Oracle<C>::KBYTES / 16;
  static_assert(Oracle<C>::EXACT_BITS == 8 * Oracle<C>::KBYTES &&
                    C::N == 4 * NBLK,
                "a draw is NBLK whole blocks");
#pragma unroll 1
  for (u64 d = 0;; d++) {
    Fp<C> x;
    aes_ctr<NBLK>(rk, d * NBLK, x.l, T);
    if (fs_accept(x)) return x;
  }
}


// ---------------------------------------------------------------------
// K9: writes and draws spread over a block of threads (fs.cu)
// ---------------------------------------------------------------------
//
// Of a write only the SHA-256 rounds are a chain: the bytes it absorbs
// (the state's partial block, then the array header or the tags and the
// elements' natural bytes) are all known before the first round, and a
// block's message schedule depends on its own 16 words alone.  So K9's
// producers (every warp but the first) convert the elements, lay the
// byte stream out as big-endian words and expand each block's schedule
// into K[t] + W[t] (k9w_produce, K9_CHUNK blocks a stage), while one
// thread runs the rounds of the stage before from those words
// (k9w_chain, fs_compress_kw); two stages alternate in shared memory.
// Of a draw only the key schedule is a chain: every attempt takes the
// same kBytes, so candidate j lies at stream byte P + j kBytes, and the
// counter blocks (k9d_blocks), the tests x < p and the products into
// Montgomery form are independent; an ordered count keeps the first n
// accepted (fs.cu k_fs_draw).  These functions take a thread's index
// among those that share the work and their number, so that
// tests/test_torch_fs_words.py runs them in one host thread, in turn.

constexpr int K9_THREADS = 256;  // a block, for every write and draw
constexpr int K9_PRODUCERS = K9_THREADS - 32;  // warps 1-7
constexpr int K9_CHUNK = 8;      // SHA-256 blocks a stage
// elements whose bytes a stage's 512 bytes touch, at most (16 a byte)
constexpr int K9_NAT = K9_CHUNK * 64 / 16 + 2;

__device__ __forceinline__ u64 k9_min(u64 a, u64 b) { return a < b ? a : b; }

// h <- compress(h, block) from the block's kw[t] = K[t] + W[t]
// (sha_schedule_kw): the rounds alone, 16 unrolled in a loop of 4.
__device__ __forceinline__ void fs_compress_kw(uint32_t h[8],
                                               const uint32_t* kw) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = h[i];
#pragma unroll 1
  for (int it = 0; it < 4; it++) {
    const uint32_t* k = kw + 16 * it;
#pragma unroll
    for (int j = 0; j < 16; j++)
      FS_ROUND(v[(8 - j) & 7], v[(9 - j) & 7], v[(10 - j) & 7],
               v[(11 - j) & 7], v[(12 - j) & 7], v[(13 - j) & 7],
               v[(14 - j) & 7], v[(15 - j) & 7], k[j]);
  }
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] += v[i];
}
#undef FS_ROUND

// kw[t] = K[t] + W[t], t < 64, of the block of big-endian words m[16].
__device__ __forceinline__ void sha_schedule_kw(const uint32_t* m,
                                                uint32_t* kw) {
  uint32_t w[16];
#pragma unroll
  for (int t = 0; t < 16; t++) {
    w[t] = m[t];
    kw[t] = SHA256_K[t] + w[t];
  }
#pragma unroll
  for (int t = 16; t < 64; t++) {
    const uint32_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
    w[t & 15] += (sha_rotr(w15, 7) ^ sha_rotr(w15, 18) ^ (w15 >> 3)) +
                 w[(t + 9) & 15] +
                 (sha_rotr(w2, 17) ^ sha_rotr(w2, 19) ^ (w2 >> 10));
    kw[t] = SHA256_K[t] + w[t & 15];
  }
}

// A write's byte stream, from the start of the state's partial block:
// its off = cnt % 64 bytes, the body of L bytes, then zeros to the end of
// block nfull (the new partial block).  The body of MODE 0 is the n bytes
// of in, of 5 the array header (TAG_ARRAY, n as 8 little-endian bytes)
// and each element's natural kBytes, of 6 each element after its tag.
struct K9Write {
  uint32_t off;
  u64 n, L, nfull;
};

template <class C, int MODE>
struct K9Body {
  static constexpr int HDR = MODE == 5 ? 9 : 0;
  static constexpr int TAG = MODE == 6 ? 1 : 0;
  static constexpr int STRIDE = MODE == 0 ? 1 : Oracle<C>::KBYTES + TAG;
};

template <class C, int MODE>
__device__ __forceinline__ K9Write k9w_plan(u64 cnt, u64 n) {
  typedef K9Body<C, MODE> B;
  K9Write w;
  w.off = (uint32_t)cnt & 63u;
  w.n = n;
  w.L = B::HDR + n * B::STRIDE;
  w.nfull = (w.off + w.L) / 64;
  return w;
}

// A write's shared memory: the old partial block (little-endian words,
// as FsState.buf holds it), the natural words of a stage's elements, a
// stage's blocks as big-endian words, the schedules of two stages and
// the new partial block.
template <class C>
struct K9WriteSmem {
  uint32_t old[16];
  uint32_t nat[K9_NAT * C::N];
  uint32_t wt[K9_CHUNK * 16];
  uint32_t kw[2][K9_CHUNK][64];
  uint32_t part[16];
};

// The elements [e0, e1) whose bytes lie in blocks [b0, b1).
template <class C, int MODE>
__device__ __forceinline__ void k9w_elts(const K9Write& w, u64 b0, u64 b1,
                                         u64& e0, u64& e1) {
  typedef K9Body<C, MODE> B;
  const u64 base = w.off + B::HDR;
  const u64 lo = 64 * b0 > base ? 64 * b0 - base : 0;
  const u64 hi = 64 * b1 > base ? 64 * b1 - base : 0;
  e0 = lo / B::STRIDE;
  e1 = k9_min(w.n, (hi + B::STRIDE - 1) / B::STRIDE);
  if (e1 < e0) e1 = e0;
}

// Byte q of the stream: from the old partial block, the header, a tag,
// the natural words nat of the stage's elements from e0 on, or the input
// bytes (MODE 0); zero past the body.  The body is below 2^32 bytes.
template <class C, int MODE>
__device__ __forceinline__ uint32_t k9w_byte(const K9Write& w,
                                             const uint32_t* old,
                                             const uint32_t* nat, u64 e0,
                                             const uint8_t* in, u64 q) {
  typedef K9Body<C, MODE> B;
  if (q < w.off) return (old[q >> 2] >> (8 * (q & 3))) & 0xFFu;
  uint32_t u = (uint32_t)(q - w.off);
  if (q - w.off >= w.L) return 0u;
  if constexpr (MODE == 0) {
    return in[u];
  } else {
    if constexpr (B::HDR > 0) {
      if (u < (uint32_t)B::HDR)
        return u == 0 ? (uint32_t)TAG_ARRAY
                      : (uint32_t)(w.n >> (8 * (u - 1))) & 0xFFu;
      u -= B::HDR;
    }
    const uint32_t e = u / B::STRIDE;
    uint32_t j = u - e * B::STRIDE;
    if constexpr (B::TAG > 0) {
      if (j == 0) return (uint32_t)TAG_FIELD_ELEM;
      j--;
    }
    return (nat[(e - (uint32_t)e0) * C::N + (j >> 2)] >> (8 * (j & 3))) &
           0xFFu;
  }
}

// The producers' barrier: named barrier 1 over their warps (a host
// build runs one thread: nothing to wait for).
struct K9ProducerSync {
  __device__ __forceinline__ void operator()() const {
#ifdef __CUDA_ARCH__
    asm volatile("bar.sync 1, %0;" ::"r"(K9_PRODUCERS) : "memory");
#endif
  }
};

// Stage c of a write, by producer p of np: the blocks [K9_CHUNK c,
// K9_CHUNK c + K9_CHUNK) up to block nfull laid out; each whole block's
// schedule into kw[c % 2], the partial block nfull's words into part.
// The elements' loads for the stage are issued here while the chain
// thread hashes the stage before.
template <class C, int MODE, class Sync>
__device__ __forceinline__ void k9w_produce(const K9Write& w,
                                            K9WriteSmem<C>& sm, u64 c,
                                            int p, int np,
                                            const uint8_t* in, Sync sync) {
  const u64 b0 = K9_CHUNK * c, b1 = k9_min(b0 + K9_CHUNK, w.nfull + 1);
  const int nb = (int)(b1 - b0);
  u64 e0 = 0, e1 = 0;
  if constexpr (MODE != 0) {
    k9w_elts<C, MODE>(w, b0, b1, e0, e1);
    for (int k = p; k < (int)(e1 - e0); k += np) {
      const Fp<C> x = fs_natural(Fp<C>::load((const uint4*)in, e0 + k));
#pragma unroll
      for (int j = 0; j < C::N; j++) sm.nat[k * C::N + j] = x.l[j];
    }
    sync();
  }
  for (int i = p; i < 16 * nb; i += np) {
    const u64 q = 64 * b0 + 4 * (u64)i;
    uint32_t x = 0u;
#pragma unroll
    for (int k = 0; k < 4; k++)
      x = (x << 8) |
          k9w_byte<C, MODE>(w, sm.old, sm.nat, e0, in, q + (u64)k);
    sm.wt[i] = x;
  }
  sync();
  for (int k = p; k < nb; k += np) {
    if (b0 + k < w.nfull) {
      sha_schedule_kw(sm.wt + 16 * k, sm.kw[c & 1][k]);
    } else {
#pragma unroll
      for (int j = 0; j < 16; j++) sm.part[j] = sm.wt[16 * k + j];
    }
  }
}

// Stage c's rounds: its whole blocks, by the chain thread.
template <class C>
__device__ __forceinline__ void k9w_chain(const K9Write& w,
                                          const K9WriteSmem<C>& sm, u64 c,
                                          uint32_t h[8]) {
  const u64 b0 = K9_CHUNK * c;
  const int nb = (int)(w.nfull > b0 ? k9_min(K9_CHUNK, w.nfull - b0) : 0);
#pragma unroll 1
  for (int k = 0; k < nb; k++) fs_compress_kw(h, sm.kw[c & 1][k]);
}

// fs after a write: the chain's midstate, the count, the partial block.
__device__ __forceinline__ void k9w_store(FsState* f, const uint32_t h[8],
                                          u64 cnt, const K9Write& w,
                                          const uint32_t* part) {
  uint32_t* b = (uint32_t*)f->buf;
#pragma unroll
  for (int i = 0; i < 8; i++) f->h[i] = h[i];
  f->cnt = cnt + w.L;
#pragma unroll
  for (int j = 0; j < 16; j++) b[j] = be32(part[j]);
}

// The stream position of a prf state: bytes read from the stream's start.
__device__ __forceinline__ u64 prf_pos(const PrfState* f) {
  return 16 * (f->nb - 1) + f->ptr;
}

// Counter blocks b0 .. b0 + nblk - 1 of the stream keyed by rk as the
// little-endian words of S (16 bytes each, in stream order), by thread t
// of nt.
__device__ __forceinline__ void k9d_blocks(const uint32_t* rk, u64 b0,
                                           int nblk, uint32_t* S, int t,
                                           int nt, const uint32_t* T) {
  for (int i = t; i < nblk; i += nt) aes_block(rk, b0 + (u64)i, S + 4 * i, T);
}

// The draw that starts at byte q of the words S: kBytes little-endian
// bytes, the first lowest (S holds a word past them).
template <class C>
__device__ __forceinline__ Fp<C> k9d_candidate(const uint32_t* S,
                                               uint32_t q) {
  static_assert(Oracle<C>::EXACT_BITS == 8 * Oracle<C>::KBYTES &&
                    C::N * 4 == Oracle<C>::KBYTES,
                "a draw is N whole words");
  const uint32_t w0 = q >> 2, sh = 8 * (q & 3);
  Fp<C> x;
#pragma unroll
  for (int i = 0; i < C::N; i++)
    x.l[i] = __funnelshift_r(S[w0 + i], S[w0 + i + 1], sh);
  return x;
}

// The prf state at stream position P under the round keys rk: saved is
// block P / 16 (from S, the blocks b0 .. b0 + nblk - 1, where it is one
// of them), nb = P / 16 + 1, ptr = P % 16.
__device__ __forceinline__ void k9d_settle(PrfState* f, u64 P,
                                           const uint32_t* S, u64 b0,
                                           int nblk, const uint32_t* rk,
                                           const uint32_t* T) {
  const u64 b = P >> 4;
  uint32_t saved[4];
  if (b >= b0 && b - b0 < (u64)nblk) {
#pragma unroll
    for (int k = 0; k < 4; k++) saved[k] = S[4 * (b - b0) + k];
  } else {
    aes_block(rk, b, saved, T);
  }
  for (int i = 0; i < 60; i++) f->rk[i] = rk[i];
#pragma unroll
  for (int k = 0; k < 4; k++) f->saved[k] = saved[k];
  f->nb = b + 1;
  f->ptr = (uint32_t)(P & 15);
  f->pad = 0u;
}

// Stream bytes from position pos on: from the blocks 0 .. npre - 1 in S
// while they last, then a block at a time (K9 mode 9's walk).
struct K9Reader {
  const uint32_t *S, *rk, *T;
  int npre;
  u64 pos, cur;
  uint32_t blk[4];

  __device__ __forceinline__ uint32_t byte() {
    const u64 b = pos >> 4;
    uint32_t w;
    if (b < (u64)npre) {
      w = S[pos >> 2];
    } else {
      if (b != cur) {
        aes_block(rk, b, blk, T);
        cur = b;
      }
      const uint32_t q = (uint32_t)(pos >> 2) & 3u;
      w = q == 0 ? blk[0] : q == 1 ? blk[1] : q == 2 ? blk[2] : blk[3];
    }
    const uint32_t r = (w >> (8 * (pos & 3))) & 0xFFu;
    pos++;
    return r;
  }
};
