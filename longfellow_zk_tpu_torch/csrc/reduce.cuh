// The deterministic two-pass field sum shared by K3 (wire_round.cu), K7
// (quad_bind.cu) and K16 (copy_round.cu).  Blocks run in no order, so a
// kernel's first pass folds a grid-stride slice of its terms into N 64-bit
// limb accumulators per output (fp_acc: exact, fp.cuh) and writes them per
// block to scratch with block_sum; the second pass (finish_one: k_finish,
// one block per output, or K16's last block in the same launch) sums the
// partials in block order and reduces modulo p once.  No sum goes through
// an atomic, so the result does not depend on the order in which blocks
// run.  GF(2^128) (gf2.cuh) sums by XOR through acc_add.
#pragma once

#include "gf2.cuh"

#define NT 256

// Sums acc over the block into dst[0..N) (thread 0 writes).
template <class C>
__device__ __forceinline__ void block_sum(u64* acc, u64* dst) {
  constexpr int N = C::N;
  __shared__ u64 sm[NT / 32][N];
  warp_sum<C>(acc);
  int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; j++) sm[w][j] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < N; j++) {
      u64 s = 0;
      for (int k = 0; k < NT / 32; k++) s = acc_add<C>(s, sm[k][j]);
      dst[j] = s;
    }
  }
  __syncthreads();  // sm is reused by the next call
}

// Sums output o's nblk partials and reduces modulo p (thread 0 writes
// out[o]); every thread of the block calls it.  The partials are loaded
// past L1 (__ldcg), so a block may also call it on partials that other
// blocks of its own launch wrote (K16's last block, copy_round.cu).
template <class C>
__device__ __forceinline__ void finish_one(const u64* __restrict__ partial,
                                           int nblk, long long o,
                                           uint4* __restrict__ out) {
  constexpr int N = C::N;
  u64 acc[N];
#pragma unroll
  for (int j = 0; j < N; j++) acc[j] = 0;
  for (int k = threadIdx.x; k < nblk; k += NT) {
#pragma unroll
    for (int j = 0; j < N; j++)
      acc[j] = acc_add<C>(acc[j], __ldcg(partial + N * (o * nblk + k) + j));
  }
  __shared__ u64 tot[N];
  block_sum<C>(acc, tot);
  if (threadIdx.x == 0) fp_reduce_acc<C>(tot).store(out, o);
}

// One block per output: sums its nblk partials and reduces modulo p.
template <class C>
__global__ void k_finish(const u64* __restrict__ partial, int nblk,
                         uint4* __restrict__ out) {
  finish_one<C>(partial, nblk, blockIdx.x, out);
}
