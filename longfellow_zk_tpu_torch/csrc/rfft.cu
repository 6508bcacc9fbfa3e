// K18 rfft_pass: the elementwise passes of the half-complex real FFT over
// Fp2 on the P-256 base field, around the Fp2 NTT (K4 [fp256x2]).  One
// kernel, three modes, one thread per output index j of a row:
//
//   0 split   HC <- Z, after the forward n/2-point NTT of the row packed
//             as complex (re = even, im = odd):
//               Zr = conj Z[(h - j) mod h], E = (Z_j + Zr) / 2,
//               O = (Z_j - Zr) (-i / 2), F_j = E + tab[j] O (tab = w^-j),
//             written as HC[j] = re F_j, HC[n - j] = im F_j (j > 0) and
//             HC[h] = re (E_0 - O_0);
//   1 merge   Z <- HC, before the backward NTT: F_j = (HC[j], HC[n - j]),
//             G = F_(h - j) (imaginary parts 0 at indices 0 and h),
//             E = (F_j + conj G) / 2, D = (F_j - conj G) / 2,
//             Z_j = E + i tab[j] D (tab = w^j);
//   2 hc_mul  HC <- A B, the pointwise product of two half-complex
//             spectra (j in [0, h]); B has the rows of A or one row.
//
// Replaces the JAX package's RFFT.r2hc (the split after the Fp2 fftf),
// RFFT.hc2r (the merge before fftb) and RFFT.hc_mul
// (longfellow_zk_tpu/transforms/rfft.py:74, :102, :132), which
// RFFTExtConvolution runs: the Reed-Solomon encode of the P-256 tableau
// rows (2,048 base elements, 1,024 Fp2 points a row).  The JAX package
// builds the conjugates, reversals and concatenations as whole arrays;
// here each thread gathers its two mirrored inputs and writes its outputs
// in place in the half-complex layout.
//
// Bound on the H100: bytes.  A row of n base elements is read and written
// once a pass (hc_mul reads two), with two or three Fp2 products an index
// (at most 384 32-bit multiplies on about 128 bytes, below the card's
// balance of about 5 a byte).  The design keeps the traffic minimal:
// neighbouring threads on neighbouring indices, the mirrored reads
// coalesced in reverse.  1/2 (inv2) and the tables come from the wrapper.
#include "fp.cuh"

typedef Fp<P256> Fb;
typedef Fp2<P256> E2;

__device__ __forceinline__ E2 conj(E2 a) {
  a.im = fp_neg(a.im);
  return a;
}

// F_i of a half-complex row (i in [0, h]): (hc[i], hc[n - i]), with the
// imaginary part 0 at i = 0 and i = h.
__device__ __forceinline__ E2 hc_at(const uint4* hc, long long base,
                                    long long n, long long i) {
  E2 r;
  r.re = Fb::load(hc, base + i);
  r.im = (i == 0 || 2 * i == n) ? fp_zero<P256>()
                                : Fb::load(hc, base + n - i);
  return r;
}

__global__ void k_rfft_pass(int mode, uint4* __restrict__ out,
                            const uint4* __restrict__ a,
                            const uint4* __restrict__ b,
                            const uint4* __restrict__ tab,
                            const uint4* __restrict__ inv2p, long long rows,
                            long long n, long long brows) {
  const long long h = n / 2;
  const long long per = mode == 2 ? h + 1 : h;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * per) return;
  long long r = idx / per, j = idx - r * per;
  if (mode == 2) {
    long long base = r * n;
    E2 p = fp_mul(hc_at(a, base, n, j), hc_at(b, (r % brows) * n, n, j));
    p.re.store(out, base + j);
    if (j > 0 && j < h) p.im.store(out, base + n - j);
    return;
  }
  Fb inv2 = Fb::load(inv2p, 0);
  if (mode == 0) {
    E2 z = E2::load(a, r * h + j);
    E2 zr = conj(E2::load(a, r * h + (j == 0 ? 0 : h - j)));
    E2 e = fp_mul_base(fp_add(z, zr), inv2);
    E2 d = fp_mul_base(fp_sub(z, zr), inv2);
    E2 o;
    o.re = d.im;
    o.im = fp_neg(d.re);
    E2 f = fp_add(e, fp_mul(E2::load(tab, j), o));
    long long base = r * n;
    f.re.store(out, base + j);
    if (j > 0)
      f.im.store(out, base + n - j);
    else
      fp_sub(e.re, o.re).store(out, base + h);
    return;
  }
  long long base = r * n;
  E2 f = hc_at(a, base, n, j);
  E2 g = conj(hc_at(a, base, n, h - j));
  E2 e = fp_mul_base(fp_add(f, g), inv2);
  E2 d = fp_mul_base(fp_sub(f, g), inv2);
  E2 o = fp_mul(E2::load(tab, j), d);
  E2 z;
  z.re = fp_sub(e.re, o.im);
  z.im = fp_add(e.im, o.re);
  z.store(out, r * h + j);
}

// split: out [rows, n] base, a [rows, n/2] Fp2; merge: out [rows, n/2]
// Fp2, a [rows, n] base; hc_mul: out, a [rows, n], b [brows, n] base;
// tab [n/2] Fp2 (split, merge), inv2 one base element.
extern "C" int rfft_pass_fp256x2(int mode, void* out, const void* a,
                                 const void* b, const void* tab,
                                 const void* inv2, long long rows,
                                 long long n, long long brows,
                                 void* stream) {
  if (rows <= 0 || n < 2) return 0;
  long long work = rows * (mode == 2 ? n / 2 + 1 : n / 2);
  const int threads = 256;
  k_rfft_pass<<<(unsigned)((work + threads - 1) / threads), threads, 0,
                (cudaStream_t)stream>>>(
      mode, (uint4*)out, (const uint4*)a, (const uint4*)b, (const uint4*)tab,
      (const uint4*)inv2, rows, n, brows);
  return (int)cudaGetLastError();
}
