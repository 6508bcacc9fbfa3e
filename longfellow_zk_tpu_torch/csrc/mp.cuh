// The multi-prime ("CRT") field shared by K4 [crt] (ntt.cu) and K13-K15
// (crt.cu): VS independent 32-bit prime fields, the residues of one value
// modulo the basis primes p_b = c * 2^22 + 1, the MP_MAX largest below
// 2^32 in descending order (fields/multiprime.py crt_primes; a basis of VS
// primes is the first VS of them).  A residue is one 32-bit word in
// Montgomery form with R = 2^32, canonical (< p_b); a tensor of them lies
// lane-major, [VS, ...], so that a lane's words are contiguous.
//
// Each function takes the lane's prime p and n0inv = -p^-1 mod 2^32 as
// arguments, read once per thread from the __constant__ table MP_PRIMES
// by the lane index.  Every p_b lies in (2^31, 2^32): a value below 2^32
// needs at most one subtraction of p_b, and sums of two residues and the
// Montgomery product below 2 p_b need 33 bits, kept in a 64-bit word.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MP_MAX 40

struct MpPrime {
  uint32_t p, n0inv;
};

// {p_b, -p_b^-1 mod 2^32} for b = 0 .. MP_MAX - 1
__constant__ MpPrime MP_PRIMES[MP_MAX] = {
    {0xFD800001u, 0xFD7FFFFFu}, {0xFA000001u, 0xF9FFFFFFu},
    {0xF4C00001u, 0xF4BFFFFFu}, {0xF3000001u, 0xF2FFFFFFu},
    {0xEF400001u, 0xEF3FFFFFu}, {0xEB000001u, 0xEAFFFFFFu},
    {0xEAC00001u, 0xEABFFFFFu}, {0xE8000001u, 0xE7FFFFFFu},
    {0xE4C00001u, 0xE4BFFFFFu}, {0xDF800001u, 0xDF7FFFFFu},
    {0xDBC00001u, 0xDBBFFFFFu}, {0xDA800001u, 0xDA7FFFFFu},
    {0xD8400001u, 0xD83FFFFFu}, {0xD7800001u, 0xD77FFFFFu},
    {0xD6C00001u, 0xD6BFFFFFu}, {0xD5400001u, 0xD53FFFFFu},
    {0xD3C00001u, 0xD3BFFFFFu}, {0xD1400001u, 0xD13FFFFFu},
    {0xD0000001u, 0xCFFFFFFFu}, {0xCDC00001u, 0xCDBFFFFFu},
    {0xCCC00001u, 0xCCBFFFFFu}, {0xCB800001u, 0xCB7FFFFFu},
    {0xC5800001u, 0xC57FFFFFu}, {0xC1000001u, 0xC0FFFFFFu},
    {0xC0000001u, 0xBFFFFFFFu}, {0xBF400001u, 0xBF3FFFFFu},
    {0xBD400001u, 0xBD3FFFFFu}, {0xB9800001u, 0xB97FFFFFu},
    {0xB7400001u, 0xB73FFFFFu}, {0xB2C00001u, 0xB2BFFFFFu},
    {0xB2800001u, 0xB27FFFFFu}, {0xAD800001u, 0xAD7FFFFFu},
    {0xAC000001u, 0xABFFFFFFu}, {0xAB000001u, 0xAAFFFFFFu},
    {0xA7800001u, 0xA77FFFFFu}, {0xA7400001u, 0xA73FFFFFu},
    {0xA5C00001u, 0xA5BFFFFFu}, {0xA3C00001u, 0xA3BFFFFFu},
    {0xA2400001u, 0xA23FFFFFu}, {0xA2000001u, 0xA1FFFFFFu}};

// v < 2p to its canonical value.
__device__ __forceinline__ uint32_t mp_reduce(unsigned long long v,
                                              uint32_t p) {
  return (uint32_t)(v >= p ? v - p : v);
}

__device__ __forceinline__ uint32_t mp_add(uint32_t a, uint32_t b,
                                           uint32_t p) {
  return mp_reduce((unsigned long long)a + b, p);
}

__device__ __forceinline__ uint32_t mp_sub(uint32_t a, uint32_t b,
                                           uint32_t p) {
  return a >= b ? a - b : (uint32_t)((unsigned long long)a + p - b);
}

// Montgomery product a * b * 2^-32 mod p; needs a < 2^32 and b < p (or
// a < p and b < 2^32).  t = a b < 2^64; m = t n0inv mod 2^32; t + m p is
// a multiple of 2^32 below 2^65, and its quotient is below 2p: the low
// halves sum to 0 or 2^32, a carry exactly when lo(t) != 0.
__device__ __forceinline__ uint32_t mp_mul(uint32_t a, uint32_t b, uint32_t p,
                                           uint32_t n0inv) {
  unsigned long long t = (unsigned long long)a * b;
  uint32_t m = (uint32_t)t * n0inv;
  unsigned long long u = (t >> 32) + __umulhi(m, p) + ((uint32_t)t != 0u);
  return mp_reduce(u, p);
}
