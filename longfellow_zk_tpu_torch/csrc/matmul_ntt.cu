// K17 fp_matmul_ntt: the B-point NTT of each block of B Fp128 elements as
// one product of the elements' bytes with a constant u8 matrix, the byte
// carry and the reduction mod p in the same kernel.
//
// Replaces the base case of the JAX package's MatmulNTT
// (longfellow_zk_tpu/transforms/matmul_ntt.py:119 _matmul_ntt_block, with
// :52 halfwords_to_bytes, :62 _carry_fix and :77 bytes_to_halfwords): bf16
// products of the 18 input bytes with the lo and hi nibble matrices
// [B 18, B 16], exact in f32, then the carry, the fold of 2^128 and the
// renormalisation.  Here the 16 bytes of a canonical element multiply the
// u8 matrix M[(n, j), (k, b)] = byte b of (w^(n k) 2^(8 j) mod p) in 32-bit
// integers: a column sum col[k, b] = sum_(n, j) byte_j(x_n) M[(n, j), (k,
// b)] is at most 255^2 16 B < 2^27 (B <= 128), exact.  Then out[k] = sum_b
// col[k, b] 2^(8 b) < 2^156 is carried into four words and a top word T,
// folded by 2^128 = 2^108 - 1 (mod p = 2^128 - 2^108 + 1) until T = 0, and
// reduced to the canonical residue.  Montgomery form passes through: the
// matrix holds natural powers of w, and mont(x) w = mont(x w).
//
// The matrix comes packed for __dp4a: word [4 n + q][c] holds the bytes
// j = 4q .. 4q + 3 of row (n, j) at column c, so the input limbs of x are
// the other operand as they are (row of the product = one NTT block, its
// 4 B limbs).  Columns are grouped in tiles of 16 output elements, byte
// major inside a tile (c = tile 256 + b 16 + e), and padded with zeros to
// whole tiles (rows to a multiple of 16 words); the wrapper builds it once
// per (B, direction) (transforms/matmul_ntt.py block_matrix_words).
//
// Bound on the H100: operations.  At 2^20 points a B = 128 pass reads and
// writes 16 MB (0.01 ms) for 3.4e10 u8 multiply-adds, 0.035 ms on the
// int8 tensor cores (1,979 TOP/s).  This first design is the simple one
// on the CUDA cores: a block of 256 threads computes a tile of 64 NTT
// blocks x 16 output elements (256 columns); each step stages 16 packed
// words of the 64 input rows and of the 256 matrix columns in shared
// memory, and each thread keeps a 4-row x 16-byte-column micro-tile of
// 32-bit sums, four products per __dp4a.  Each thread then owns the 16
// columns of 4 output elements and runs their carry and reduction in
// registers.  The tensor-core design (mma.sync / wgmma on u8) is later
// work.
#include "fp.cuh"

#define MM_ROWS 64  // NTT blocks of a thread block
#define MM_KW 16    // packed words of a reduction step

// sum_b col[b] 2^(8 b) (each col[b] < 2^27) mod p, canonical.
__device__ __forceinline__ Fp<P128> byte_cols_to_fp(const uint32_t* col) {
  uint32_t L[4];
  u64 c = 0;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    c += (u64)col[4 * j] + ((u64)col[4 * j + 1] << 8) +
         ((u64)col[4 * j + 2] << 16) + ((u64)col[4 * j + 3] << 24);
    L[j] = (uint32_t)c;
    c >>= 32;
  }
  // value = L + T 2^128 = L + T 2^108 - T (mod p); T < 2^28 needs four
  // folds at most (T <= 2^8, then <= 1, and a wrap of word 3 happens once)
  uint32_t T = (uint32_t)c;
#pragma unroll
  for (int it = 0; it < 4; it++) {
    u64 s = (u64)L[3] + ((u64)T << 12);
    L[3] = (uint32_t)s;
    uint32_t nt = (uint32_t)(s >> 32);
    u64 d = (u64)L[0] - T;
    L[0] = (uint32_t)d;
    uint32_t bw = (uint32_t)(d >> 63);
#pragma unroll
    for (int j = 1; j < 4; j++) {
      d = (u64)L[j] - bw;
      L[j] = (uint32_t)d;
      bw = (uint32_t)(d >> 63);
    }
    T = nt - bw;
  }
  Fp<P128> r;
#pragma unroll
  for (int j = 0; j < 4; j++) r.l[j] = L[j];
  return fp_cond_sub(r, 0u);  // L < 2^128 < 2p
}

__global__ void __launch_bounds__(256, 1)
    k_matmul_ntt(uint4* __restrict__ y, const uint32_t* __restrict__ x,
                 const uint32_t* __restrict__ g, long long blocks, int B) {
  __shared__ __align__(16) uint32_t xs[MM_KW][MM_ROWS + 4];
  __shared__ uint32_t gs[MM_KW][256];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long r0 = (long long)blockIdx.x * MM_ROWS;
  const int K = 4 * B;                              // words of a block row
  const int Kp = (K + MM_KW - 1) / MM_KW * MM_KW;   // the matrix's rows
  const long long ncols = (long long)((B + 15) / 16) * 256;
  const long long c0 = (long long)blockIdx.y * 256;
  uint32_t acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; i++)
#pragma unroll
    for (int b = 0; b < 16; b++) acc[i][b] = 0u;

  for (int k0 = 0; k0 < Kp; k0 += MM_KW) {
    for (int i = threadIdx.x; i < MM_ROWS * MM_KW; i += 256) {
      int r = i / MM_KW, kk = i % MM_KW;
      long long row = r0 + r;
      int k = k0 + kk;
      xs[kk][r] = (row < blocks && k < K) ? x[row * K + k] : 0u;
    }
    for (int i = threadIdx.x; i < MM_KW * 256; i += 256) {
      int kk = i >> 8, c = i & 255;
      gs[kk][c] = g[(long long)(k0 + kk) * ncols + c0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MM_KW; kk++) {
      uint4 a = *(const uint4*)&xs[kk][ty * 4];
#pragma unroll
      for (int b = 0; b < 16; b++) {
        uint32_t gv = gs[kk][b * 16 + tx];
        acc[0][b] = __dp4a(a.x, gv, acc[0][b]);
        acc[1][b] = __dp4a(a.y, gv, acc[1][b]);
        acc[2][b] = __dp4a(a.z, gv, acc[2][b]);
        acc[3][b] = __dp4a(a.w, gv, acc[3][b]);
      }
    }
    __syncthreads();
  }
  const long long e = (long long)blockIdx.y * 16 + tx;
  if (e >= B) return;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    long long row = r0 + ty * 4 + i;
    if (row < blocks) byte_cols_to_fp(acc[i]).store(y, row * B + e);
  }
}

// y, x: [blocks, B, 4] words (y != x); g: the packed matrix
// [roundup(4 B, 16), roundup(B, 16) 16] words.
extern "C" int fp_matmul_ntt_fp128(void* y, const void* x, const void* g,
                                   long long blocks, int B, void* stream) {
  if (blocks <= 0 || B <= 0) return 0;
  dim3 grid((unsigned)((blocks + MM_ROWS - 1) / MM_ROWS),
            (unsigned)((B + 15) / 16));
  k_matmul_ntt<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (uint4*)y, (const uint32_t*)x, (const uint32_t*)g, blocks, B);
  return (int)cudaGetLastError();
}
