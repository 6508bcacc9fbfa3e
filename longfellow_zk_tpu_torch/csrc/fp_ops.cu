// K1 fp_elementwise: Fp128 elementwise ops, one element per thread.
//
// Replaces the JAX package's limb-unrolled field ops inside its jitted
// programs: PrimeField.add / sub / _mont_mul_limbs / from_mont_device
// (longfellow_zk_tpu/fields/fp.py:245, :255, :277, :187), the wire-round
// bind _bind_fixed (sumcheck/prover_device.py:139) and the hv update of
// _wire_scan.one_hand (prover_device.py:595).
//
// Bound on the H100: bytes.  A multiply is about 50 integer operations
// on 48 bytes of traffic, far below the card's operations-per-byte
// balance, so the design only keeps the traffic minimal: one 16-byte
// (uint4) load per operand, one 16-byte store, neighbouring threads on
// neighbouring elements.  The second operand may be broadcast by index
// arithmetic (i / bdiv) % bmod instead of being materialised.
//
// Modes:
//   0 mul   out[i] = a[i] * b[(i / bdiv) % bmod]
//   1 add   out[i] = a[i] + b[...]
//   2 sub   out[i] = a[i] - b[...]
//   3 bind  rows of length `row`: out[j] = lo + (hi - lo) * r for the pair
//           (a[2j], a[2j+1]) and j < row / 2, zero for the tail; r = b[0]
//   4 hv    out[i] = a[i] * (h[i] odd ? r : 1 - r), r = b[0]
#include "fp128.cuh"

__global__ void k_fp_elementwise(int mode, uint4* __restrict__ out,
                                 const uint4* __restrict__ a,
                                 const uint4* __restrict__ b,
                                 const int* __restrict__ h, long long n,
                                 long long row, long long bdiv,
                                 long long bmod) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp r;
  switch (mode) {
    case 0:
      r = fp_mul(fp_load(a, i), fp_load(b, (i / bdiv) % bmod));
      break;
    case 1:
      r = fp_add(fp_load(a, i), fp_load(b, (i / bdiv) % bmod));
      break;
    case 2:
      r = fp_sub(fp_load(a, i), fp_load(b, (i / bdiv) % bmod));
      break;
    case 3: {
      long long base = (i / row) * row;
      long long j = i - base;
      if (j < row / 2) {
        Fp lo = fp_load(a, base + 2 * j);
        Fp hi = fp_load(a, base + 2 * j + 1);
        r = fp_add(lo, fp_mul(fp_sub(hi, lo), fp_load(b, 0)));
      } else {
        r = fp_zero();
      }
      break;
    }
    default: {
      Fp rr = fp_load(b, 0);
      Fp f = (h[i] & 1) ? rr : fp_sub(fp_one(), rr);
      r = fp_mul(fp_load(a, i), f);
      break;
    }
  }
  fp_store(out, i, r);
}

extern "C" int fp_elementwise(int mode, void* out, const void* a,
                              const void* b, const void* h, long long n,
                              long long row, long long bdiv, long long bmod,
                              void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  k_fp_elementwise<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      mode, (uint4*)out, (const uint4*)a, (const uint4*)b, (const int*)h, n,
      row, bdiv, bmod);
  return (int)cudaGetLastError();
}
