// Microkernels that separate the costs of K1 fp_elementwise's old
// layouts (csrc/fp_ops.cu) on the card; tools/k1_bench.py builds and
// times them.  None is a kernel of the port.
//
// diag_copy17(variant, out, in, n): copies n 17-word elements (P-521's
// 68 bytes), one element a thread, reading (variant bit 1) and writing
// (bit 0) either the element's 17 words one by one at its 68-byte stride
// (0) or through a shared tile of 128 elements moved with coalesced
// uint4s (1).  Variant 0 is the access pattern of one element a thread,
// 3 that of the tile path; 1 and 2 tell the loads' cost from the
// stores'.
//
// diag_add1(variant, out, a, b, n, bdiv, bmod): the ML-DSA prime's add,
// out[i] = a[i] + b[...]: variant 0 one element a thread with b at (i /
// bdiv) % bmod in 64 bits (the old index), 1 one element a thread with b
// at i, 2 four elements a thread (uint4) with b at i.
#include "../longfellow_zk_tpu_torch/csrc/fp.cuh"

constexpr int DT = 128;  // elements a tile, threads a block

__global__ void k_diag_copy17(int variant, uint32_t* __restrict__ out,
                              const uint32_t* __restrict__ in, long long n) {
  __shared__ __align__(16) uint32_t s[DT * 17];
  const int t = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * DT;
  const bool full = e0 + DT <= n;
  const long long i = e0 + t;
  uint32_t x[17];
  if (variant & 2) {
    if (full) {
      for (int k = t; k < DT * 17 / 4; k += DT)
        ((uint4*)s)[k] = ((const uint4*)(in + e0 * 17))[k];
    } else {
      for (int k = t; k < (n - e0) * 17; k += DT) s[k] = in[e0 * 17 + k];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 17; j++) x[j] = s[t * 17 + j];
  } else if (i < n) {
#pragma unroll
    for (int j = 0; j < 17; j++) x[j] = in[i * 17 + j];
  }
  if (variant & 1) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 17; j++) s[t * 17 + j] = x[j];
    __syncthreads();
    if (full) {
      for (int k = t; k < DT * 17 / 4; k += DT)
        ((uint4*)(out + e0 * 17))[k] = ((const uint4*)s)[k];
    } else {
      for (int k = t; k < (n - e0) * 17; k += DT) out[e0 * 17 + k] = s[k];
    }
  } else if (i < n) {
#pragma unroll
    for (int j = 0; j < 17; j++) out[i * 17 + j] = x[j];
  }
}

__global__ void k_diag_add1(int variant, uint32_t* __restrict__ out,
                            const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b, long long n,
                            long long bdiv, long long bmod) {
  typedef Fp<FP24> E;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (variant == 2) {
    if (4 * i + 4 > n) return;
    const uint4 x = ((const uint4*)a)[i], y = ((const uint4*)b)[i];
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; j++) {
      E ex, ey;
      ex.l[0] = xs[j];
      ey.l[0] = ys[j];
      r[j] = fp_add(ex, ey).l[0];
    }
    ((uint4*)out)[i] = make_uint4(r[0], r[1], r[2], r[3]);
    return;
  }
  if (i >= n) return;
  E ex, ey;
  ex.l[0] = a[i];
  ey.l[0] = b[variant == 0 ? (i / bdiv) % bmod : i];
  out[i] = fp_add(ex, ey).l[0];
}

extern "C" int diag_copy17(int variant, void* out, const void* in,
                           long long n, void* stream) {
  k_diag_copy17<<<(unsigned)((n + DT - 1) / DT), DT, 0,
                  (cudaStream_t)stream>>>(variant, (uint32_t*)out,
                                          (const uint32_t*)in, n);
  return (int)cudaGetLastError();
}

extern "C" int diag_add1(int variant, void* out, const void* a,
                         const void* b, long long n, long long bdiv,
                         long long bmod, void* stream) {
  const long long threads = variant == 2 ? (n + 3) / 4 : n;
  k_diag_add1<<<(unsigned)((threads + 255) / 256), 256, 0,
                (cudaStream_t)stream>>>(variant, (uint32_t*)out,
                                        (const uint32_t*)a,
                                        (const uint32_t*)b, n, bdiv, bmod);
  return (int)cudaGetLastError();
}
