// The deterministic two-pass field sum shared by K3 (wire_round.cu), K7
// (quad_bind.cu) and K16 (copy_round.cu), in one launch.  Blocks run in
// no order, so a kernel's first pass folds a grid-stride slice of its
// terms into N 64-bit limb accumulators per output (fp_acc: exact,
// fp.cuh), sums them over the block (block_sum) and writes them per block
// to scratch; the second pass, in the last block of a group to finish,
// sums the partials in block order and reduces modulo p once (sum_group;
// a group of one block writes its sums itself).  No sum goes through an
// atomic (only the count of a group's blocks done does), so the result
// does not depend on the order in which blocks run.  GF(2^128) (gf2.cuh)
// sums by XOR through acc_add.
#pragma once

#include "gf2.cuh"

#define NT 256

// Sums NOUT accumulators of N limbs each over a block of NT threads into
// res (shared, [NOUT][N]), which every thread may read after: the warps'
// sums, then each limb over the warps in a thread of its own.
template <class C, int NOUT>
__device__ __forceinline__ void block_sum(u64 (&acc)[NOUT][C::N],
                                          u64 (&res)[NOUT][C::N]) {
  constexpr int N = C::N, NW = NT / 32;
  __shared__ u64 sm[NW][NOUT][N];
#pragma unroll
  for (int k = 0; k < NOUT; k++) warp_sum<C>(acc[k]);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < NOUT; k++)
#pragma unroll
      for (int j = 0; j < N; j++) sm[w][k][j] = acc[k][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NOUT * N; i += NT) {
    u64 s = 0;
#pragma unroll
    for (int v = 0; v < NW; v++) s = acc_add<C>(s, sm[v][i / N][i % N]);
    res[i / N][i % N] = s;
  }
  __syncthreads();
}

// atomicAdd(p, 1) with acquire and release semantics at device scope: the
// writes its thread saw (the block's, after a barrier) are visible to the
// thread that reads the count after it, and that thread sees theirs.
__device__ __forceinline__ unsigned ticket_add(unsigned int* p) {
#if defined(__CUDA_ARCH__)
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
#else
  return atomicAdd(p, 1u);  // a host build runs one thread
#endif
}

// The end of a launch whose blocks sum outputs o0 .. o0 + NOUT - 1, nblk
// blocks each, with partials at N (o nblk + block), written before the
// call: the last block to finish, by the count of the group's blocks done
// at *ticket (an acquire-release atomic after a barrier, as a semaphore's
// release and wait), sums the outputs' partials and writes out[o] (the
// limb sums are exact, so their order does not matter), then sets the
// count to zero for the next launch.  Every thread of the block calls it.
template <class C, int NOUT>
__device__ __forceinline__ void finish_group(const u64* partial, unsigned nblk,
                                             long long o0,
                                             unsigned int* ticket,
                                             uint4* __restrict__ out) {
  constexpr int N = C::N;
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = ticket_add(ticket) == nblk - 1u;
  __syncthreads();
  if (!last) return;
  u64 acc[NOUT][N];
#pragma unroll
  for (int k = 0; k < NOUT; k++)
#pragma unroll
    for (int j = 0; j < N; j++) acc[k][j] = 0;
  for (unsigned b = threadIdx.x; b < nblk; b += NT) {
#pragma unroll
    for (int k = 0; k < NOUT; k++)
#pragma unroll
      for (int j = 0; j < N; j++)
        acc[k][j] = acc_add<C>(
            acc[k][j], __ldcg(partial + N * ((o0 + k) * nblk + b) + j));
  }
  __shared__ u64 res[NOUT][N];
  block_sum<C, NOUT>(acc, res);
  if (threadIdx.x < NOUT)
    fp_reduce_acc<C>(res[threadIdx.x]).store(out, o0 + threadIdx.x);
  if (threadIdx.x == 0) *ticket = 0u;
}

// The end of a launch whose nblk blocks a group sum outputs o0 .. o0 +
// NOUT - 1, this block's terms in acc, the block blk of its group: one
// block writes out[o] itself, else each writes its sums as partials at N
// (o nblk + blk) and the group's last block finishes them (finish_group,
// by *ticket).  Every thread of the block calls it.
template <class C, int NOUT>
__device__ __forceinline__ void sum_group(u64 (&acc)[NOUT][C::N],
                                          u64* __restrict__ partial,
                                          unsigned nblk, long long o0,
                                          unsigned blk, unsigned int* ticket,
                                          uint4* __restrict__ out) {
  constexpr int N = C::N;
  __shared__ u64 res[NOUT][N];
  block_sum<C, NOUT>(acc, res);
  if (nblk == 1) {
    if (threadIdx.x < NOUT)
      fp_reduce_acc<C>(res[threadIdx.x]).store(out, o0 + threadIdx.x);
    return;
  }
  if (threadIdx.x < NOUT * N)
    partial[N * ((o0 + threadIdx.x / N) * nblk + blk) + threadIdx.x % N] =
        res[threadIdx.x / N][threadIdx.x % N];
  finish_group<C, NOUT>(partial, nblk, o0, ticket, out);
}
