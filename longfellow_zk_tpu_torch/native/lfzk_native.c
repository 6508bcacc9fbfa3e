/* Native host-side crypto kernels for the longfellow_zk_tpu runtime.
 *
 * The reference wraps OpenSSL for SHA-256 and AES-256 (lib/util/crypto.h);
 * this image has no OpenSSL dev headers, so we carry a small, dependency-
 * free implementation.  The key extra over hashlib is an *exportable*
 * streaming state (H, buffered block, byte count): the Fiat-Shamir
 * transcript is handed between the host control plane and the TPU device
 * program mid-stream, which requires serializing the midstate.
 *
 * Built once at import time by longfellow_zk_tpu/native/__init__.py with
 * `cc -O2 -shared -fPIC`; all entry points use plain C types for ctypes.
 */

#include <stdint.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* SHA-256 (FIPS 180-4)                                                */
/* ------------------------------------------------------------------ */

typedef struct {
  uint32_t h[8];
  uint64_t count;    /* total bytes absorbed */
  uint8_t buf[64];   /* partial block, count % 64 valid bytes */
} sha256_ctx;

static const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROTR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_compress(uint32_t h[8], const uint8_t p[64]) {
  uint32_t w[64];
  uint32_t a, b, c, d, e, f, g, hh;
  int i;
  for (i = 0; i < 16; i++)
    w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
           ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
  for (i = 16; i < 64; i++) {
    uint32_t s0 = ROTR(w[i - 15], 7) ^ ROTR(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = ROTR(w[i - 2], 17) ^ ROTR(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  a = h[0]; b = h[1]; c = h[2]; d = h[3];
  e = h[4]; f = h[5]; g = h[6]; hh = h[7];
  for (i = 0; i < 64; i++) {
    uint32_t S1 = ROTR(e, 6) ^ ROTR(e, 11) ^ ROTR(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = hh + S1 + ch + K[i] + w[i];
    uint32_t S0 = ROTR(a, 2) ^ ROTR(a, 13) ^ ROTR(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

void lfzk_sha256_init(sha256_ctx *ctx) {
  static const uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                 0xa54ff53a, 0x510e527f, 0x9b05688c,
                                 0x1f83d9ab, 0x5be0cd19};
  memcpy(ctx->h, H0, sizeof(H0));
  ctx->count = 0;
  memset(ctx->buf, 0, 64);
}

void lfzk_sha256_update(sha256_ctx *ctx, const uint8_t *data, uint64_t len) {
  uint64_t off = ctx->count % 64;
  ctx->count += len;
  if (off) {
    uint64_t take = 64 - off;
    if (take > len) take = len;
    memcpy(ctx->buf + off, data, take);
    data += take;
    len -= take;
    if (off + take == 64) {
      sha256_compress(ctx->h, ctx->buf);
      memset(ctx->buf, 0, 64);
    } else {
      return;
    }
  }
  while (len >= 64) {
    sha256_compress(ctx->h, data);
    data += 64;
    len -= 64;
  }
  if (len) memcpy(ctx->buf, data, len);
}

/* Absorb `len` zero bytes without materializing them (the transcript's
 * correlation-intractability write0 absorbs nterms zeros). */
void lfzk_sha256_update0(sha256_ctx *ctx, uint64_t len) {
  static const uint8_t Z[64] = {0};
  uint64_t off = ctx->count % 64;
  ctx->count += len;
  if (off) {
    uint64_t take = 64 - off;
    if (take > len) take = len;
    /* buf beyond off is already zero (invariant) */
    len -= take;
    if (off + take == 64) {
      sha256_compress(ctx->h, ctx->buf);
      memset(ctx->buf, 0, 64);
    } else {
      return;
    }
  }
  while (len >= 64) {
    sha256_compress(ctx->h, Z);
    len -= 64;
  }
  /* remaining zeros are already in the zeroed buf */
}

void lfzk_sha256_final(const sha256_ctx *ctx, uint8_t out[32]) {
  sha256_ctx c = *ctx; /* copy: transcript forks the state */
  uint8_t one = 0x80;
  uint64_t bits = c.count * 8;
  uint8_t lenb[8];
  int i;
  lfzk_sha256_update(&c, &one, 1);
  while (c.count % 64 != 56) {
    uint8_t z = 0;
    lfzk_sha256_update(&c, &z, 1);
  }
  for (i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (56 - 8 * i));
  lfzk_sha256_update(&c, lenb, 8);
  for (i = 0; i < 8; i++) {
    out[4 * i] = (uint8_t)(c.h[i] >> 24);
    out[4 * i + 1] = (uint8_t)(c.h[i] >> 16);
    out[4 * i + 2] = (uint8_t)(c.h[i] >> 8);
    out[4 * i + 3] = (uint8_t)(c.h[i]);
  }
}

/* state blob layout (ctypes-friendly): 8*u32 h | u64 count | 64 buf */
void lfzk_sha256_export(const sha256_ctx *ctx, uint8_t out[104]) {
  memcpy(out, ctx->h, 32);
  memcpy(out + 32, &ctx->count, 8);
  memcpy(out + 40, ctx->buf, 64);
}

void lfzk_sha256_import(sha256_ctx *ctx, const uint8_t in[104]) {
  memcpy(ctx->h, in, 32);
  memcpy(&ctx->count, in + 32, 8);
  memcpy(ctx->buf, in + 40, 64);
}

int lfzk_sha256_ctx_size(void) { return (int)sizeof(sha256_ctx); }

/* One-shot batched hashing: n messages of equal length mlen, contiguous. */
void lfzk_sha256_batch(const uint8_t *msgs, uint64_t n, uint64_t mlen,
                       uint8_t *out /* n*32 */) {
  uint64_t i;
  for (i = 0; i < n; i++) {
    sha256_ctx c;
    lfzk_sha256_init(&c);
    lfzk_sha256_update(&c, msgs + i * mlen, mlen);
    lfzk_sha256_final(&c, out + i * 32);
  }
}

/* ------------------------------------------------------------------ */
/* AES-256, encryption only (the Fiat-Shamir PRF in counter mode)      */
/* ------------------------------------------------------------------ */

static const uint8_t SBOX[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16};

static uint8_t xt(uint8_t a) { return (uint8_t)((a << 1) ^ ((a >> 7) * 0x1b)); }

typedef struct { uint8_t rk[15][16]; } aes256_ctx;

void lfzk_aes256_init(aes256_ctx *ctx, const uint8_t key[32]) {
  uint8_t w[60][4];
  static const uint8_t RCON[12] = {0x01, 0x02, 0x04, 0x08, 0x10, 0x20,
                                   0x40, 0x80, 0x1b, 0x36, 0x6c, 0xd8};
  int i, j;
  for (i = 0; i < 8; i++)
    for (j = 0; j < 4; j++) w[i][j] = key[4 * i + j];
  for (i = 8; i < 60; i++) {
    uint8_t t[4];
    for (j = 0; j < 4; j++) t[j] = w[i - 1][j];
    if (i % 8 == 0) {
      uint8_t tmp = t[0];
      t[0] = SBOX[t[1]] ^ RCON[i / 8 - 1];
      t[1] = SBOX[t[2]];
      t[2] = SBOX[t[3]];
      t[3] = SBOX[tmp];
    } else if (i % 8 == 4) {
      for (j = 0; j < 4; j++) t[j] = SBOX[t[j]];
    }
    for (j = 0; j < 4; j++) w[i][j] = w[i - 8][j] ^ t[j];
  }
  for (i = 0; i < 15; i++)
    for (j = 0; j < 16; j++) ctx->rk[i][j] = w[4 * i + j / 4][j % 4];
}

void lfzk_aes256_encrypt(const aes256_ctx *ctx, const uint8_t in[16],
                         uint8_t out[16]) {
  uint8_t s[16];
  int r, i, c;
  for (i = 0; i < 16; i++) s[i] = in[i] ^ ctx->rk[0][i];
  for (r = 1; r <= 14; r++) {
    uint8_t t[16];
    /* SubBytes + ShiftRows: t[c][row] = SBOX[s[(c+row)%4][row]] with
       column-major byte order s[4c+row] */
    for (c = 0; c < 4; c++)
      for (i = 0; i < 4; i++) t[4 * c + i] = SBOX[s[4 * ((c + i) % 4) + i]];
    if (r < 14) {
      for (c = 0; c < 4; c++) {
        uint8_t a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2],
                a3 = t[4 * c + 3];
        s[4 * c] = xt(a0) ^ (xt(a1) ^ a1) ^ a2 ^ a3;
        s[4 * c + 1] = a0 ^ xt(a1) ^ (xt(a2) ^ a2) ^ a3;
        s[4 * c + 2] = a0 ^ a1 ^ xt(a2) ^ (xt(a3) ^ a3);
        s[4 * c + 3] = (xt(a0) ^ a0) ^ a1 ^ a2 ^ xt(a3);
      }
    } else {
      memcpy(s, t, 16);
    }
    for (i = 0; i < 16; i++) s[i] ^= ctx->rk[r][i];
  }
  memcpy(out, s, 16);
}

int lfzk_aes256_ctx_size(void) { return (int)sizeof(aes256_ctx); }
