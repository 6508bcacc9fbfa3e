// K8 sha256_msgs: SHA-256 of n equal-length messages, already padded (the
// 0x80 byte, zeros and the 64-bit big-endian bit length: the wrapper pads
// in torch), one thread a message, its running state in registers.
//
//   padded  uint8 [n, nblk * 64]   (rows 16-byte aligned: 64-byte blocks)
//   out     uint8 [n, 32]          the digests, big-endian words
//
// Replaces the JAX package's merkle/sha256_jax.py:41 _compress and :103
// sha256_words, which merkle/merkle_jax.py:47 sha256_msgs_dev runs over
// the Ligero tableau's columns (ligero/prover.py:268 _commit_full_fn) and
// :57 merkle_root_dev over each level of the Merkle tree.
//
// Bound on the H100: operations.  A block costs about 64 x 30 = 1,920
// 32-bit operations (rotates are funnel shifts, the rest adds and
// LOP3s) against 64 bytes read, about 30 operations a byte, far above
// the card's 5 integer operations a byte of memory rate.  One thread
// per message keeps the chain of 64 dependent rounds in registers; the
// bytes are read as 16-byte vectors (a thread's loads are not coalesced
// with its neighbours': each reads its own row, so L2 and not HBM serves
// most of them at mdoc widths).
#include "fp.cuh"
#include "sha256.cuh"

__global__ void k_sha256_msgs(const uint4* __restrict__ padded, long long n,
                              int nblk, uint4* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t h[8];
  sha256_init(h);
  const uint4* row = padded + i * (long long)nblk * 4;
  for (int b = 0; b < nblk; b++) {
    uint32_t w[16];
#pragma unroll
    for (int k = 0; k < 4; k++) {
      uint4 v = row[4 * b + k];
      w[4 * k] = be32(v.x);
      w[4 * k + 1] = be32(v.y);
      w[4 * k + 2] = be32(v.z);
      w[4 * k + 3] = be32(v.w);
    }
    sha256_compress(h, w);
  }
  out[2 * i] = make_uint4(be32(h[0]), be32(h[1]), be32(h[2]), be32(h[3]));
  out[2 * i + 1] = make_uint4(be32(h[4]), be32(h[5]), be32(h[6]), be32(h[7]));
}

extern "C" int sha256_msgs_bytes(void* out, const void* padded, long long n,
                                 int nblk, void* stream) {
  if (n == 0) return 0;
  const int nt = 128;
  k_sha256_msgs<<<(unsigned)((n + nt - 1) / nt), nt, 0,
                  (cudaStream_t)stream>>>((const uint4*)padded, n, nblk,
                                          (uint4*)out);
  return (int)cudaGetLastError();
}
