// Microkernels that time candidate GF(2^128) products on the card;
// tools/gf2_bench.py builds this file against each tree's csrc/ (-I) and
// runs it.  None is a kernel of the port.  The candidates are copies kept
// here (namespace cand), so that one build times them beside the tree's
// own fp_mul<G128> (gf2.cuh):
//
//   0 tree      the tree's fp_mul<G128>
//   1 shift     the branch-free shift-and-XOR over b's 128 bits
//   2 kara      spaced-multiply Karatsuba: 9 32 x 32 carry-less products
//               of 16 integer multiplies each (operands masked to the four
//               residue classes of bit positions mod 4), then the fold
//   3 kara_pre  the same with a's 36 class words made once (a product by
//               a fixed a), unreduced (the 256-bit product, no fold)
//   4 window4   a 4-bit window table of a in shared memory, one a thread
//               (16 entries of 132 bits, thread-major), Horner over b's
//               32 nibbles, then the fold
//   5 table8    a product by a fixed r through a block's table of r's
//               multiples in shared memory: 16 byte positions x 256
//               entries of 16 bytes (64 KB), reduced; 16 reads and XORs
//               (the table built as gf2.cuh's g128_tab_build)
//   6 table4    the same with 32 nibble positions x 16 entries (8 KB)
//   7 build8    building table8 (every thread of a block)
//   8 build4    building table4
//
// diag_g128_lat(part, iters, io, cycles): one thread (of a block of 256
// for the table parts, whose table the block builds first) runs `iters`
// dependent products x = x * y; thread 0 writes the cycles of the loop
// and x.  diag_g128_grid(part, iters, io, out, blocks): every thread of
// `blocks` blocks of 256 runs `iters` dependent products on its own
// operands and writes its x (timed by the caller with CUDA events).  A
// part is a kernel of its own (a template argument), so that its
// registers and instructions can be read apart.
#include "gf2.cuh"

namespace cand {

__device__ __forceinline__ void split4(uint32_t x, uint32_t m[4]) {
  m[0] = x & 0x11111111u;
  m[1] = x & 0x22222222u;
  m[2] = x & 0x44444444u;
  m[3] = x & 0x88888888u;
}

// the 64-bit carry-less product of a (as its four classes) and b
__device__ __forceinline__ u64 clmul32s(const uint32_t a[4], uint32_t b) {
  uint32_t c[4];
  split4(b, c);
  const u64 r0 = (u64)a[0] * c[0] ^ (u64)a[1] * c[3] ^ (u64)a[2] * c[2] ^
                 (u64)a[3] * c[1];
  const u64 r1 = (u64)a[0] * c[1] ^ (u64)a[1] * c[0] ^ (u64)a[2] * c[3] ^
                 (u64)a[3] * c[2];
  const u64 r2 = (u64)a[0] * c[2] ^ (u64)a[1] * c[1] ^ (u64)a[2] * c[0] ^
                 (u64)a[3] * c[3];
  const u64 r3 = (u64)a[0] * c[3] ^ (u64)a[1] * c[2] ^ (u64)a[2] * c[1] ^
                 (u64)a[3] * c[0];
  return (r0 & 0x1111111111111111ull) | (r1 & 0x2222222222222222ull) |
         (r2 & 0x4444444444444444ull) | (r3 & 0x8888888888888888ull);
}

struct Split {
  uint32_t m[9][4];
};

__device__ __forceinline__ void split(const Fp<G128>& a, Split& s) {
  const uint32_t w[9] = {a.l[0], a.l[1], a.l[0] ^ a.l[1],
                         a.l[2], a.l[3], a.l[2] ^ a.l[3],
                         a.l[0] ^ a.l[2], a.l[1] ^ a.l[3],
                         a.l[0] ^ a.l[1] ^ a.l[2] ^ a.l[3]};
#pragma unroll
  for (int k = 0; k < 9; k++) split4(w[k], s.m[k]);
}

__device__ __forceinline__ void clmul64s(const uint32_t (*am)[4], uint32_t b0,
                                         uint32_t b1, uint32_t r[4]) {
  const u64 lo = clmul32s(am[0], b0), hi = clmul32s(am[1], b1);
  const u64 mid = clmul32s(am[2], b0 ^ b1) ^ lo ^ hi;
  r[0] = (uint32_t)lo;
  r[1] = (uint32_t)(lo >> 32) ^ (uint32_t)mid;
  r[2] = (uint32_t)hi ^ (uint32_t)(mid >> 32);
  r[3] = (uint32_t)(hi >> 32);
}

__device__ __forceinline__ void clmul(const Split& s, const Fp<G128>& b,
                                      uint32_t t[8]) {
  uint32_t L[4], H[4], M[4];
  clmul64s(s.m + 0, b.l[0], b.l[1], L);
  clmul64s(s.m + 3, b.l[2], b.l[3], H);
  clmul64s(s.m + 6, b.l[0] ^ b.l[2], b.l[1] ^ b.l[3], M);
#pragma unroll
  for (int j = 0; j < 4; j++) M[j] ^= L[j] ^ H[j];
  t[0] = L[0];
  t[1] = L[1];
  t[2] = L[2] ^ M[0];
  t[3] = L[3] ^ M[1];
  t[4] = H[0] ^ M[2];
  t[5] = H[1] ^ M[3];
  t[6] = H[2];
  t[7] = H[3];
}

__device__ __forceinline__ Fp<G128> fold(const uint32_t t[8]) {
  const uint32_t* h = t + 4;
  Fp<G128> r;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    uint32_t x = t[j] ^ h[j] ^ (h[j] << 1) ^ (h[j] << 2) ^ (h[j] << 7);
    if (j > 0) x ^= (h[j - 1] >> 31) ^ (h[j - 1] >> 30) ^ (h[j - 1] >> 25);
    r.l[j] = x;
  }
  const uint32_t spill = (h[3] >> 31) ^ (h[3] >> 30) ^ (h[3] >> 25);
  r.l[0] ^= spill ^ (spill << 1) ^ (spill << 2) ^ (spill << 7);
  return r;
}

__device__ __forceinline__ Fp<G128> shift_mul(const Fp<G128>& a,
                                              const Fp<G128>& b) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u;
#pragma unroll
  for (int w = 3; w >= 0; w--) {
    const uint32_t bw = b.l[w];
#pragma unroll 8
    for (int i = 31; i >= 0; i--) {
      const uint32_t top = 0u - (r3 >> 31);
      r3 = __funnelshift_l(r2, r3, 1);
      r2 = __funnelshift_l(r1, r2, 1);
      r1 = __funnelshift_l(r0, r1, 1);
      r0 = (r0 << 1) ^ (top & 0x87u);
      const uint32_t m = 0u - ((bw >> i) & 1u);
      r0 ^= a.l[0] & m;
      r1 ^= a.l[1] & m;
      r2 ^= a.l[2] & m;
      r3 ^= a.l[3] & m;
    }
  }
  Fp<G128> r;
  r.l[0] = r0;
  r.l[1] = r1;
  r.l[2] = r2;
  r.l[3] = r3;
  return r;
}

__device__ __forceinline__ Fp<G128> kara_mul(const Fp<G128>& a,
                                             const Fp<G128>& b) {
  Split s;
  split(a, s);
  uint32_t t[8];
  clmul(s, b, t);
  return fold(t);
}

// window4: the thread's table in shared memory, word w of entry e at
// (e * 5 + w) * blockDim.x + threadIdx.x (thread-major: no bank conflict)
__device__ __forceinline__ Fp<G128> window4_mul(uint32_t* sm,
                                                const Fp<G128>& a,
                                                const Fp<G128>& b) {
  const int T = blockDim.x, me = threadIdx.x;
  uint32_t e[5] = {0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int w = 0; w < 5; w++) sm[w * T + me] = 0u;
  const uint32_t a5[5] = {a.l[0], a.l[1], a.l[2], a.l[3], 0u};
#pragma unroll
  for (int v = 1; v < 16; v++) {
    // entry v = entry (v >> 1) x ^ (v & 1 ? a : 0)
#pragma unroll
    for (int w = 4; w >= 0; w--) {
      const uint32_t hi = sm[((v >> 1) * 5 + w) * T + me];
      const uint32_t lo = w ? sm[((v >> 1) * 5 + w - 1) * T + me] : 0u;
      e[w] = __funnelshift_l(lo, hi, 1) ^ ((v & 1) ? a5[w] : 0u);
    }
#pragma unroll
    for (int w = 0; w < 5; w++) sm[(v * 5 + w) * T + me] = e[w];
  }
  uint32_t t[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 31; k >= 0; k--) {
#pragma unroll
    for (int w = 7; w > 0; w--) t[w] = __funnelshift_l(t[w - 1], t[w], 4);
    t[0] <<= 4;
    const uint32_t v = (b.l[k >> 3] >> (4 * (k & 7))) & 15u;
#pragma unroll
    for (int w = 0; w < 5; w++) t[w] ^= sm[(v * 5 + w) * T + me];
  }
  return fold(t);
}

// r x^j mod P
__device__ __forceinline__ Fp<G128> mul_xj(const Fp<G128>& r, int j) {
  const int q = j >> 5;
  const uint32_t s = (uint32_t)j & 31u;
  uint32_t t[8];
#pragma unroll
  for (int w = 0; w < 8; w++) {
    uint32_t hi = 0u, lo = 0u;
#pragma unroll
    for (int c = 0; c < 4; c++) {
      hi = w - q == c ? r.l[c] : hi;
      lo = w - q - 1 == c ? r.l[c] : lo;
    }
    t[w] = __funnelshift_l(lo, hi, s);
  }
  return fold(t);
}

__host__ __device__ constexpr int ctz(int g) {
  return (g & 1) ? 0 : 1 + ctz(g >> 1);
}

// the table of r's multiples and, after it, the basis r x^j (as gf2.cuh
// g128_tab_build: 16 entries a thread along a Gray code over v's high 4
// bits)
template <int W>
__device__ __forceinline__ void tab_build(const Fp<G128>& r, uint4* tab) {
  constexpr int NP = 128 / W, NE = 1 << W, LOW = W - 4;
  uint4* basis = tab + NP * NE;
  for (int j = threadIdx.x; j < 128; j += blockDim.x) {
    const Fp<G128> v = mul_xj(r, j);
    basis[j] = make_uint4(v.l[0], v.l[1], v.l[2], v.l[3]);
  }
  __syncthreads();
  for (int u = threadIdx.x; u < NP << LOW; u += blockDim.x) {
    const int k = u >> LOW, l = u & ((1 << LOW) - 1);
    const uint4* bk = basis + W * k;
    uint4 e = make_uint4(0u, 0u, 0u, 0u), high[4];
#pragma unroll
    for (int i = 0; i < LOW; i++)
      if ((l >> i) & 1)
        e = make_uint4(e.x ^ bk[i].x, e.y ^ bk[i].y, e.z ^ bk[i].z,
                       e.w ^ bk[i].w);
#pragma unroll
    for (int i = 0; i < 4; i++) high[i] = bk[LOW + i];
    uint4* out = tab + k * NE + l;
    out[0] = e;
#pragma unroll
    for (int g = 1; g < 16; g++) {
      const uint4 b = high[ctz(g)];
      e = make_uint4(e.x ^ b.x, e.y ^ b.y, e.z ^ b.z, e.w ^ b.w);
      out[(g ^ (g >> 1)) << LOW] = e;
    }
  }
  __syncthreads();
}

template <int W>
__device__ __forceinline__ Fp<G128> tab_mul(const uint4* tab,
                                            const Fp<G128>& x) {
  constexpr int NP = 128 / W, NE = 1 << W, PER = 32 / W;
  uint32_t a0 = 0u, a1 = 0u, a2 = 0u, a3 = 0u;
#pragma unroll
  for (int k = 0; k < NP; k++) {
    const uint32_t v = (x.l[k / PER] >> (W * (k % PER))) & (NE - 1);
    const uint4 e = tab[k * NE + v];
    a0 ^= e.x;
    a1 ^= e.y;
    a2 ^= e.z;
    a3 ^= e.w;
  }
  Fp<G128> r;
  r.l[0] = a0;
  r.l[1] = a1;
  r.l[2] = a2;
  r.l[3] = a3;
  return r;
}

}  // namespace cand

typedef Fp<G128> E;

// one step of PART: x <- x * y (kara_pre: the unreduced product's low
// half, so that the chain goes on)
template <int PART>
__device__ __forceinline__ E step(const E& x, const E& y,
                                  const cand::Split& ys, uint32_t* sm,
                                  const uint4* tab) {
  if constexpr (PART == 0) {
    return fp_mul(x, y);
  } else if constexpr (PART == 1) {
    return cand::shift_mul(x, y);
  } else if constexpr (PART == 2) {
    return cand::kara_mul(x, y);
  } else if constexpr (PART == 3) {
    uint32_t t[8];
    cand::clmul(ys, x, t);
    E r;
#pragma unroll
    for (int j = 0; j < 4; j++) r.l[j] = t[j] ^ t[j + 4];
    return r;
  } else if constexpr (PART == 4) {
    return cand::window4_mul(sm, x, y);
  } else if constexpr (PART == 5) {
    return cand::tab_mul<8>(tab, x);
  } else {
    return cand::tab_mul<4>(tab, x);
  }
}

// shared memory: the window tables (256 threads x 80 words), at least
// table8 and its basis
constexpr int DIAG_SMEM = 256 * 80 * 4;

template <int PART>
__global__ void k_diag_g128_lat(int iters, uint4* io, long long* cycles) {
  extern __shared__ __align__(16) uint4 dsm[];
  E x = E::load(io, 0), y = E::load(io, 1);
  if constexpr (PART >= 5) {
    const long long c0 = clock64();
    if constexpr (PART == 5 || PART == 7)
      cand::tab_build<8>(y, dsm);
    else
      cand::tab_build<4>(y, dsm);
    if constexpr (PART >= 7) {
      if (threadIdx.x == 0) {
        cycles[0] = clock64() - c0;
        x = E::load(dsm, 1 + (iters & 127));
        x.store(io, 2);
      }
      return;
    }
  }
  if (threadIdx.x != 0) return;
  cand::Split ys;
  cand::split(y, ys);
  const long long c0 = clock64();
  for (int it = 0; it < iters; it++)
    x = step<PART>(x, y, ys, (uint32_t*)dsm, dsm);
  cycles[0] = clock64() - c0;
  x.store(io, 2);
}

template <int PART>
__global__ void __launch_bounds__(256)
    k_diag_g128_grid(int iters, const uint4* __restrict__ io,
                     uint4* __restrict__ out) {
  extern __shared__ __align__(16) uint4 dsm[];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  E x = E::load(io, i), y = E::load(io, 0);
  if constexpr (PART == 5)
    cand::tab_build<8>(y, dsm);
  else if constexpr (PART == 6)
    cand::tab_build<4>(y, dsm);
  cand::Split ys;
  cand::split(y, ys);
  for (int it = 0; it < iters; it++)
    x = step<PART>(x, y, ys, (uint32_t*)dsm, dsm);
  x.store(out, i);
}

static size_t smem_of(int part) {
  return part == 4 ? DIAG_SMEM : part == 5 || part == 7 ? (4096 + 128) * 16
                               : part == 6 || part == 8 ? (512 + 128) * 16
                                                        : 0;
}

template <int PART>
static int lat(int iters, void* io, void* cycles, cudaStream_t s) {
  cudaFuncSetAttribute(k_diag_g128_lat<PART>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       DIAG_SMEM);
  k_diag_g128_lat<PART><<<1, PART >= 5 ? 256 : 32, smem_of(PART), s>>>(
      iters, (uint4*)io, (long long*)cycles);
  return (int)cudaGetLastError();
}

template <int PART>
static int grid(int iters, const void* io, void* out, int blocks,
                cudaStream_t s) {
  cudaFuncSetAttribute(k_diag_g128_grid<PART>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       DIAG_SMEM);
  k_diag_g128_grid<PART><<<blocks, 256, smem_of(PART), s>>>(
      iters, (const uint4*)io, (uint4*)out);
  return (int)cudaGetLastError();
}

extern "C" int diag_g128_lat(int part, int iters, void* io, void* cycles,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (part) {
    case 0: return lat<0>(iters, io, cycles, s);
    case 1: return lat<1>(iters, io, cycles, s);
    case 2: return lat<2>(iters, io, cycles, s);
    case 3: return lat<3>(iters, io, cycles, s);
    case 4: return lat<4>(iters, io, cycles, s);
    case 5: return lat<5>(iters, io, cycles, s);
    case 6: return lat<6>(iters, io, cycles, s);
    case 7: return lat<7>(iters, io, cycles, s);
    default: return lat<8>(iters, io, cycles, s);
  }
}

extern "C" int diag_g128_grid(int part, int iters, const void* io, void* out,
                              int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (part) {
    case 0: return grid<0>(iters, io, out, blocks, s);
    case 1: return grid<1>(iters, io, out, blocks, s);
    case 2: return grid<2>(iters, io, out, blocks, s);
    case 3: return grid<3>(iters, io, out, blocks, s);
    case 4: return grid<4>(iters, io, out, blocks, s);
    case 5: return grid<5>(iters, io, out, blocks, s);
    default: return grid<6>(iters, io, out, blocks, s);
  }
}
