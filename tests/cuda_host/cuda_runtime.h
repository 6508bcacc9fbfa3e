// A host stand-in for the CUDA runtime header, enough for the port's
// device headers (csrc/fp.cuh, gf2.cuh, sha256.cuh, fs.cuh) to compile
// with a host C++ compiler in one thread: the qualifiers are empty, the
// intrinsics are their definitions in C++, and a "block" is one thread
// (threadIdx 0, blockDim 1).  tests/test_torch_fs_words.py builds the
// Fiat-Shamir oracle of K9 and K10 with it and holds it to the host
// transcript on the CPU; tests/test_torch_gf2_mul.py the GF(2^128)
// products of gf2.cuh and K3's terms (GF(2^128) and prime).
#pragma once
#include <stdint.h>
#include <string.h>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __shared__ static
#define __launch_bounds__(...)
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t sh) {
  sh &= 31; uint64_t v = ((uint64_t)hi << 32) | lo; return (uint32_t)((v << sh) >> 32); }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t sh) {
  sh &= 31; uint64_t v = ((uint64_t)hi << 32) | lo; return (uint32_t)(v >> sh); }
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  uint64_t v = ((uint64_t)y << 32) | x; uint32_t r = 0;
  for (int i = 0; i < 4; i++) { uint32_t sel = (s >> (4 * i)) & 7; r |= (uint32_t)((v >> (8 * sel)) & 0xFF) << (8 * i); }
  return r; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline T __shfl_down_sync(unsigned, T v, int) { return v; }
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx = {0, 0, 0}, blockIdx = {0, 0, 0}, blockDim = {1, 1, 1},
    gridDim = {1, 1, 1};
inline void __syncwarp() {}
inline void __syncthreads() {}
inline void __threadfence() {}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  unsigned o = *p; *p += v; return o; }
typedef int cudaError_t;
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
