// The Fiat-Shamir oracle on the card, byte-exact twin of the host
// Transcript / FSPRF (random_oracle/transcript.py; reference
// lib/random/transcript.h:33-193).  Shared by K9 (fs.cu) and K10
// (round_tail.cu); both run it in one thread, because every step of the
// oracle depends on the one before.
//
//   FsState   the host Transcript's export_state blob (104 bytes): the
//             SHA-256 midstate h (native words), the absorbed byte count
//             cnt and the partial block buf (bytes at cnt % 64 and above
//             are zero);
//   PrfState  an FSPRF stream (272 bytes): the AES-256 round keys rk, the
//             current counter block's output saved, the next counter nb
//             and the read pointer ptr into saved.  A read that ends a
//             block computes the next one at once (as the JAX package's
//             prf_bytes does), so ptr < 16.
//
// Replaces the JAX package's random_oracle/device_fs.py:53-357
// (fs_absorb, fs_getkey, aes256_expand, aes256_block, prf_fresh,
// fs_squeeze, prf_bytes, fs_write_elts, dev_elt_bytes, dev_sample_elt(s))
// and sumcheck/prover_device.py:248 _write_tagged_elts.
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
  uint8_t rk[240];
  uint8_t saved[16];
  u64 nb;
  uint32_t ptr;
  uint32_t pad;
};

static_assert(sizeof(FsState) == 104, "FsState is the 104-byte host blob");
static_assert(sizeof(PrfState) == 272, "PrfState layout");

enum { TAG_BSTR = 0, TAG_FIELD_ELEM = 1, TAG_ARRAY = 2 };

// Per field: the bytes of an element (kBytes) and the bits of a draw
// (exact_bits); RAW for GF(2^128), whose draws are kBytes raw bytes with
// no rejection and no Montgomery form.
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

__device__ __forceinline__ void fs_absorb_byte(FsState& s, uint8_t b) {
  uint32_t off = (uint32_t)(s.cnt & 63u);
  s.buf[off] = b;
  s.cnt++;
  if (off == 63u) {
    sha256_compress_bytes(s.h, s.buf);
#pragma unroll
    for (int i = 0; i < 64; i++) s.buf[i] = 0;
  }
}

__device__ __forceinline__ void fs_absorb_le8(FsState& s, u64 v) {
  for (int i = 0; i < 8; i++) fs_absorb_byte(s, (uint8_t)(v >> (8 * i)));
}

// The digest of a copy of the state: one compression, or two when the
// padding does not fit (cnt % 64 >= 56).
__device__ __forceinline__ void fs_getkey(const FsState& s, uint8_t key[32]) {
  uint32_t h[8];
  uint8_t blk[64];
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] = s.h[i];
  uint32_t off = (uint32_t)(s.cnt & 63u);
  for (int i = 0; i < 64; i++) blk[i] = (uint32_t)i < off ? s.buf[i] : 0;
  blk[off] = 0x80;
  if (off >= 56u) {
    sha256_compress_bytes(h, blk);
    for (int i = 0; i < 64; i++) blk[i] = 0;
  }
  u64 bits = s.cnt << 3;
  for (int i = 0; i < 8; i++) blk[56 + i] = (uint8_t)(bits >> (56 - 8 * i));
  sha256_compress_bytes(h, blk);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    key[4 * i] = (uint8_t)(h[i] >> 24);
    key[4 * i + 1] = (uint8_t)(h[i] >> 16);
    key[4 * i + 2] = (uint8_t)(h[i] >> 8);
    key[4 * i + 3] = (uint8_t)h[i];
  }
}

// ---------------------------------------------------------------------
// AES-256 (encryption only) in counter mode: the FSPRF
// ---------------------------------------------------------------------

__constant__ uint8_t AES_SBOX[256] = {
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

__device__ __forceinline__ uint8_t aes_xt(uint8_t a) {
  return (uint8_t)((a << 1) ^ ((a >> 7) * 0x1B));
}

// The 15 round keys of a 32-byte key (FIPS-197 5.2, Nk = 8).
__device__ __forceinline__ void aes256_expand(const uint8_t key[32],
                                              uint8_t rk[240]) {
  for (int i = 0; i < 32; i++) rk[i] = key[i];
  uint8_t rcon = 1;
  for (int i = 8; i < 60; i++) {
    uint8_t t0 = rk[4 * i - 4], t1 = rk[4 * i - 3], t2 = rk[4 * i - 2],
            t3 = rk[4 * i - 1];
    if (i % 8 == 0) {
      uint8_t u = t0;
      t0 = AES_SBOX[t1] ^ rcon;
      t1 = AES_SBOX[t2];
      t2 = AES_SBOX[t3];
      t3 = AES_SBOX[u];
      rcon = aes_xt(rcon);
    } else if (i % 8 == 4) {
      t0 = AES_SBOX[t0];
      t1 = AES_SBOX[t1];
      t2 = AES_SBOX[t2];
      t3 = AES_SBOX[t3];
    }
    rk[4 * i] = rk[4 * i - 32] ^ t0;
    rk[4 * i + 1] = rk[4 * i - 31] ^ t1;
    rk[4 * i + 2] = rk[4 * i - 30] ^ t2;
    rk[4 * i + 3] = rk[4 * i - 29] ^ t3;
  }
}

// Encrypts the counter block LE64(ctr) || 0^8; the state is column-major
// (byte 4c + r is row r of column c).
__device__ __forceinline__ void aes256_block(const uint8_t rk[240], u64 ctr,
                                             uint8_t out[16]) {
  uint8_t s[16];
#pragma unroll
  for (int i = 0; i < 16; i++)
    s[i] = (i < 8 ? (uint8_t)(ctr >> (8 * i)) : (uint8_t)0) ^ rk[i];
  for (int r = 1; r < 14; r++) {
    uint8_t t[16];
#pragma unroll
    for (int c = 0; c < 4; c++)
#pragma unroll
      for (int rr = 0; rr < 4; rr++)
        t[4 * c + rr] = AES_SBOX[s[4 * ((c + rr) & 3) + rr]];
#pragma unroll
    for (int c = 0; c < 4; c++) {
      uint8_t a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2],
              a3 = t[4 * c + 3];
      s[4 * c] = aes_xt(a0) ^ aes_xt(a1) ^ a1 ^ a2 ^ a3 ^ rk[16 * r + 4 * c];
      s[4 * c + 1] =
          a0 ^ aes_xt(a1) ^ aes_xt(a2) ^ a2 ^ a3 ^ rk[16 * r + 4 * c + 1];
      s[4 * c + 2] =
          a0 ^ a1 ^ aes_xt(a2) ^ aes_xt(a3) ^ a3 ^ rk[16 * r + 4 * c + 2];
      s[4 * c + 3] =
          aes_xt(a0) ^ a0 ^ a1 ^ a2 ^ aes_xt(a3) ^ rk[16 * r + 4 * c + 3];
    }
  }
#pragma unroll
  for (int c = 0; c < 4; c++)
#pragma unroll
    for (int rr = 0; rr < 4; rr++)
      out[4 * c + rr] =
          AES_SBOX[s[4 * ((c + rr) & 3) + rr]] ^ rk[224 + 4 * c + rr];
}

__device__ __forceinline__ void prf_fresh(PrfState& p, const uint8_t key[32]) {
  aes256_expand(key, p.rk);
  aes256_block(p.rk, 0, p.saved);
  p.nb = 1;
  p.ptr = 0;
  p.pad = 0;
}

__device__ __forceinline__ void fs_squeeze(const FsState& s, PrfState& p) {
  uint8_t key[32];
  fs_getkey(s, key);
  prf_fresh(p, key);
}

__device__ __forceinline__ uint8_t prf_byte(PrfState& p) {
  uint8_t b = p.saved[p.ptr];
  if (++p.ptr == 16u) {
    aes256_block(p.rk, p.nb, p.saved);
    p.nb++;
    p.ptr = 0;
  }
  return b;
}

// ---------------------------------------------------------------------
// field elements: serialization and rejection sampling
// ---------------------------------------------------------------------

// The natural value of an element as the kernels hold it.
template <class C>
__device__ __forceinline__ Fp<C> fs_natural(const Fp<C>& x) {
  if constexpr (Oracle<C>::RAW) {
    return x;
  } else {
    Fp<C> one = fp_zero<C>();
    one.l[0] = 1u;
    return fp_mul(x, one);
  }
}

template <class C>
__device__ __forceinline__ void fs_absorb_elt(FsState& s, const Fp<C>& x) {
  Fp<C> v = fs_natural(x);
  for (int j = 0; j < Oracle<C>::KBYTES; j++)
    fs_absorb_byte(s, (uint8_t)(v.l[j >> 2] >> (8 * (j & 3))));
}

// One element from the stream: draws of exact_bits bits until one is
// below p (prime fields, then to Montgomery form by R^2), or kBytes raw
// bytes (GF(2^128)).
template <class C>
__device__ __forceinline__ Fp<C> prf_sample(PrfState& p) {
  constexpr int NB = (Oracle<C>::EXACT_BITS + 7) / 8;
  constexpr int REM = Oracle<C>::EXACT_BITS % 8;
  for (;;) {
    Fp<C> x = fp_zero<C>();
    for (int i = 0; i < NB; i++) {
      uint32_t b = prf_byte(p);
      if (REM != 0 && i == NB - 1) b &= (1u << REM) - 1u;
      x.l[i >> 2] |= b << (8 * (i & 3));
    }
    if constexpr (Oracle<C>::RAW) {
      return x;
    } else {
      uint32_t borrow = 0;
#pragma unroll
      for (int j = 0; j < C::N; j++) {
        u64 d = (u64)x.l[j] - C::p(j) - borrow;
        borrow = (uint32_t)(d >> 63);
      }
      if (borrow) return fp_mul(x, fp_r2<C>());
    }
  }
}
