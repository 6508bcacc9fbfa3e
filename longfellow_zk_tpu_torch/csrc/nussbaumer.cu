// K19 nb_butterfly and K20 nb_base_conv: the two kernels of the Nussbaumer
// convolution over a prime field (transforms/nussbaumer.py), one instance
// per field (Fp128, P-256, secp256k1).
//
// K19 replaces one level of the JAX package's block-axis FFT
// (longfellow_zk_tpu/transforms/nussbaumer.py:95 _apply_rot with the
// add/sub butterflies of :135-151, forward DIF, and :155-168, inverse
// DIT).  A [rows, M, r] is viewed [rows, M / 2h, 2, h, r]; row t of a half
// (lo, hi) is multiplied by y^(s_t) in R[y]/(y^r + 1), s_t = step t mod 2r:
// a cyclic shift by s_t mod r with the wrapped part negated, and the whole
// row negated when s_t >= r.  Forward: (lo + hi, y^(s_t) (lo - hi));
// inverse: (lo + y^(s_t) hi, lo - y^(s_t) hi).  The JAX package gathers
// through a host table of indices and signs and negates by select; here
// each thread computes its shift from (t, step), so no table is uploaded:
// forward, a thread takes input column l and writes its rotated
// difference at (l + s) mod r; inverse, a thread takes output column l
// and reads hi at (l - s) mod r.
//
// K20 replaces the base case (nussbaumer.py:63 _base_conv with :54
// _base_tables and :40 _sum_terms): z[k] = sum_j x[j] y[(k - j) mod n],
// negated where k < j for the negacyclic product, n <= 32, batched over
// rows; y has x's rows or fewer (row row % yrows: its leading axes were
// broadcast).  One thread an output element, a product and a sum (or
// difference) a term, reduced every term.
//
// Bounds on the H100: K19 by bytes (a read and a write of A, an add and a
// sub an element); K20 by operations (n products of 2 N^2 32-bit multiplies
// an output).  The designs are the simple ones: one thread a column (K19)
// or an output (K20), neighbouring threads on neighbouring columns.
#include "fp.cuh"

template <class C>
__global__ void k_nb_butterfly(uint4* __restrict__ out,
                               const uint4* __restrict__ a, long long pairs,
                               int h, int r, long long step, int inverse) {
  typedef Fp<C> E;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pairs) return;
  int l = (int)(idx % r);
  long long q = idx / r;
  int t = (int)(q % h);
  q /= h;  // row * (M / 2h) + block
  long long lo_i = (q * 2 * h + t) * r, hi_i = ((q * 2 + 1) * h + t) * r;
  long long twor = 2LL * r;
  long long s = (step * t) % twor;
  if (s < 0) s += twor;
  bool flip = s >= r;
  int sp = (int)(flip ? s - r : s);
  if (!inverse) {
    E lo = E::load(a, lo_i + l), hi = E::load(a, hi_i + l);
    fp_add(lo, hi).store(out, lo_i + l);
    E d = fp_sub(lo, hi);
    int L = l + sp;
    bool wrap = L >= r;
    if (wrap) L -= r;
    (wrap != flip ? fp_neg(d) : d).store(out, hi_i + L);
  } else {
    int L = l - sp;
    bool wrap = L < 0;
    if (wrap) L += r;
    E lo = E::load(a, lo_i + l), hv = E::load(a, hi_i + L);
    E rh = wrap != flip ? fp_neg(hv) : hv;
    fp_add(lo, rh).store(out, lo_i + l);
    fp_sub(lo, rh).store(out, hi_i + l);
  }
}

template <class C>
__global__ void k_nb_base_conv(uint4* __restrict__ z,
                               const uint4* __restrict__ x,
                               const uint4* __restrict__ y, long long rows,
                               int n, long long yrows, int negacyclic) {
  typedef Fp<C> E;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * n) return;
  long long row = idx / n;
  int k = (int)(idx - row * n);
  long long xb = row * n, yb = (row % yrows) * n;
  E acc = fp_zero<C>();
  for (int j = 0; j < n; j++) {
    int i = k - j;
    bool wrap = i < 0;
    if (wrap) i += n;
    E p = fp_mul(E::load(x, xb + j), E::load(y, yb + i));
    acc = (negacyclic && wrap) ? fp_sub(acc, p) : fp_add(acc, p);
  }
  acc.store(z, idx);
}

// out, a: [rows, M, r] elements (out != a), 2h | M; step = +-w 2^k.
template <class C>
static int nb_butterfly(void* out, const void* a, long long rows, int M,
                        int h, int r, long long step, int inverse,
                        void* stream) {
  long long pairs = rows * (M / 2) * (long long)r;
  if (pairs <= 0) return 0;
  const int threads = 256;
  k_nb_butterfly<C><<<(unsigned)((pairs + threads - 1) / threads), threads,
                      0, (cudaStream_t)stream>>>(
      (uint4*)out, (const uint4*)a, pairs, h, r, step, inverse);
  return (int)cudaGetLastError();
}

// z, x: [rows, n]; y: [yrows, n] elements.
template <class C>
static int nb_base_conv(void* z, const void* x, const void* y,
                        long long rows, int n, long long yrows,
                        int negacyclic, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (yrows <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long work = rows * n;
  k_nb_base_conv<C><<<(unsigned)((work + threads - 1) / threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (uint4*)z, (const uint4*)x, (const uint4*)y, rows, n, yrows,
      negacyclic);
  return (int)cudaGetLastError();
}

#define LFZK_NB(tag, C)                                                     \
  extern "C" int nb_butterfly_##tag(void* out, const void* a,              \
                                    long long rows, int M, int h, int r,   \
                                    long long step, int inverse,           \
                                    void* stream) {                        \
    return nb_butterfly<C>(out, a, rows, M, h, r, step, inverse, stream);  \
  }                                                                         \
  extern "C" int nb_base_conv_##tag(void* z, const void* x, const void* y, \
                                    long long rows, int n, long long yrows, \
                                    int negacyclic, void* stream) {        \
    return nb_base_conv<C>(z, x, y, rows, n, yrows, negacyclic, stream);   \
  }

LFZK_NB(fp128, P128)
LFZK_NB(fp256, P256)
LFZK_NB(fp256k1, P256K1)
