// K24 eq_table: the sumcheck's EQ tables in one launch, with an instance
// for Fp128, one each for the P-256 and secp256k1 base fields and one for
// GF(2^128) (gf2.cuh's Karatsuba product).  For each lane b (a proof of a
// batch, or one table of several) and 0 <= i < n <= 2^logn,
//
//   mode 1:  out[b, i] = EQ(q[b], i)
//   mode 2:  out[b, i] = EQ(q[b], i) + alpha[b] EQ(q1[b], i)
//
// with EQ(q, i) = prod_{t < logn} (bit t of i ? q_t : 1 - q_t): the
// canonical values of the interleave steps of the JAX package's _eq_dev
// and _raw_eq2_dev (sumcheck/prover_device.py:107, :124), whose last step
// pairs the lowest bit of i with q_0.  Field products are exact, so the
// order in which the factors meet does not change a word.
//
// Replaces those functions, which ran logn elementwise passes over the
// growing table (a product, a difference and a stack each), at every
// call site of the prover (the layer's dot, the EQ over the copies, the
// input binding), of the constraint build and of the verifiers (dot and
// the two input-wire tables of each layer's bound quad).
//
// Design.  The bits of i split into three parts, i = (top, mid, lo) with
// k, r and top bits; a chunk is the 2^(k + r) entries of one top value.
// Each block builds, by doubling steps in shared memory, the tables
// L[lo] (EQ over q_0 .. q_{k-1}) and M[mid] (over q_k .. q_{k+r-1}), and
// for each of its chunks the product of the top bits' factors (one thread
// a chunk, its chain of top products) folded into M once (Mt = M Top).
// An entry then costs one product a table: L[lo] Mt[mid].  In mode 2 the
// same for q1, with alpha folded into its top product.  A lane is a grid
// row of at most about the card's resident blocks; a block takes its
// lane's chunks bx, bx + G, ...  32-bit indices throughout.
//
// Bound on the H100: the products (one an entry a table, 144 multiplies
// at GF(2^128), 2 N^2 at a prime field) above the bytes written, except
// at Fp128, where the two are near; the tables' products are a block's
// fixed cost, 2^k + 2^r + the chunks' top chains.
#include <algorithm>

#include "gf2.cuh"

constexpr int EQ_THREADS = 256;
// a chunk is 2^c entries: c = logn up to EQ_CHUNK_MIN bits, else at least
// EQ_CHUNK_MIN and at least logn - EQ_TOP_MAX (at most 2^EQ_TOP_MAX chunks)
constexpr int EQ_CHUNK_MIN = 10;
constexpr int EQ_TOP_MAX = 10;
constexpr int EQ_LOGN_MAX = 24;
// blocks a launch, at most (unless a lane's chunks need more): about the
// card's resident blocks (132 SMs x 8)
constexpr long long EQ_MAX_BLOCKS = 1056;

struct EqPlan {
  int logn, c, k, r, top, nq;  // nq: the tables, 1 or 2 (mode 2)
  uint32_t n, chunks, per;     // per: chunks a block, at most
};

// (cmin, tmax: EQ_CHUNK_MIN and EQ_TOP_MAX but where a test asks for
// smaller chunks)
__host__ __device__ inline EqPlan eq_plan(int logn, uint32_t n, int nq,
                                          int cmin = EQ_CHUNK_MIN,
                                          int tmax = EQ_TOP_MAX) {
  EqPlan P;
  P.logn = logn;
  P.nq = nq;
  P.n = n;
  P.c = logn <= cmin ? logn : logn - tmax > cmin ? logn - tmax : cmin;
  P.k = (P.c + 1) / 2;
  P.r = P.c - P.k;
  P.top = logn - P.c;
  P.chunks = (uint32_t)(((unsigned long long)n + (1ull << P.c) - 1) >> P.c);
  P.per = 1;
  return P;
}

// Shared memory, in elements, for each of the nq tables in turn: q_t and
// 1 - q_t (2 logn), L (2^k), M (2^r), Mt (2^r), the top products (per).
__host__ __device__ inline uint32_t eq_smem_elts(const EqPlan& P) {
  return P.nq * (2u * P.logn + (1u << P.k) + (2u << P.r) + P.per);
}

// The work of block bx of the G blocks of lane `lane`, by threads tid of
// nth (a strided loop each, so that one host thread can replay it: see
// tests/test_torch_eq_table.py).  sm: eq_smem_elts(P) elements; q0, q1:
// the lane's logn challenges, qt0 and qt1 elements apart; alpha: its
// element (mode 2); out: the lane's n entries.
template <class C>
__device__ void eq_block(uint4* sm, uint4* out, const uint4* q0,
                         const uint4* q1, const uint4* alpha, long long qt0,
                         long long qt1, const EqPlan& P, uint32_t bx,
                         uint32_t G, unsigned tid, unsigned nth) {
  typedef Fp<C> E;
  const uint32_t nL = 1u << P.k, nM = 1u << P.r, lmask = nL - 1;
  const uint32_t per_q = 2u * P.logn + nL + 2 * nM + P.per;
  // table x (0 or 1): its q_t at Q(x) + t, 1 - q_t at Q(x) + logn + t
  auto Q = [&](int x) { return sm + (size_t)x * per_q * E::V; };
  auto L = [&](int x) { return Q(x) + (size_t)2 * P.logn * E::V; };
  auto M = [&](int x) { return L(x) + (size_t)nL * E::V; };
  auto Mt = [&](int x) { return M(x) + (size_t)nM * E::V; };
  auto Top = [&](int x) { return Mt(x) + (size_t)nM * E::V; };
  const E one = fp_one<C>();

  for (uint32_t w = tid; w < (uint32_t)P.nq * P.logn; w += nth) {
    const int x = w / P.logn, t = w - x * P.logn;
    const E qt = x ? E::load(q1, t * qt1) : E::load(q0, t * qt0);
    qt.store(Q(x), t);
    fp_sub(one, qt).store(Q(x), P.logn + t);
  }
  for (uint32_t w = tid; w < (uint32_t)P.nq; w += nth) {
    one.store(L(w), 0);
    one.store(M(w), 0);
  }
  __syncthreads();

  // doubling: after step t, T[j] for j < 2^(t+1) is EQ over its bits'
  // challenges (entry j + 2^t takes q, entry j takes 1 - q: T - T q)
  for (int t = 0; t < (P.k > P.r ? P.k : P.r); t++) {
    const uint32_t half = 1u << t, items = (uint32_t)(2 * P.nq) << t;
    for (uint32_t w = tid; w < items; w += nth) {
      const uint32_t tab = w >> t, j = w & (half - 1);
      const int x = tab >> 1, isM = tab & 1;
      if (t >= (isM ? P.r : P.k)) continue;
      uint4* T = isM ? M(x) : L(x);
      const E v = E::load(T, j);
      const E hi = fp_mul(v, E::load(Q(x), (isM ? P.k : 0) + t));
      hi.store(T, j + half);
      fp_sub(v, hi).store(T, j);
    }
    __syncthreads();
  }

  // the top products of the block's chunks bx + u G (alpha's in mode 2)
  uint32_t mine = 0;
  if (bx < P.chunks) mine = (P.chunks - 1 - bx) / G + 1;
  for (uint32_t w = tid; w < (uint32_t)P.nq * mine; w += nth) {
    const int x = w / mine;
    const uint32_t u = w - x * mine, j = bx + u * G;
    E v = x ? E::load(alpha, 0) : one;
    for (int t = 0; t < P.top; t++)
      v = fp_mul(v, E::load(Q(x), ((j >> t) & 1 ? 0 : P.logn) + P.c + t));
    v.store(Top(x), u);
  }
  __syncthreads();

  for (uint32_t u = 0; u < mine; u++) {
    const uint32_t base = (bx + u * G) << P.c;
    for (uint32_t w = tid; w < (uint32_t)P.nq * nM; w += nth) {
      const int x = w >> P.r;
      const uint32_t m = w & (nM - 1);
      fp_mul(E::load(M(x), m), E::load(Top(x), u)).store(Mt(x), m);
    }
    __syncthreads();
    const uint32_t cnt = P.n - base < (1u << P.c) ? P.n - base : 1u << P.c;
    for (uint32_t e = tid; e < cnt; e += nth) {
      const uint32_t lo = e & lmask, mid = e >> P.k;
      E v = fp_mul(E::load(L(0), lo), E::load(Mt(0), mid));
      if (P.nq == 2)
        v = fp_add(v, fp_mul(E::load(L(1), lo), E::load(Mt(1), mid)));
      v.store(out, base + e);
    }
    __syncthreads();
  }
}

// grid (G, lanes): block (bx, lane)
template <class C>
__global__ void __launch_bounds__(EQ_THREADS)
    k_eq_table(uint4* __restrict__ out, const uint4* __restrict__ q0,
               const uint4* __restrict__ q1, const uint4* __restrict__ alpha,
               long long qs0, long long qt0, long long qs1, long long qt1,
               long long as, EqPlan P) {
  extern __shared__ uint4 sm[];
  typedef Fp<C> E;
  const unsigned lane = blockIdx.y;
  eq_block<C>(sm, out + (size_t)lane * P.n * E::V, q0 + lane * qs0 * E::V,
              q1 + lane * qs1 * E::V, alpha + lane * as * E::V, qt0, qt1,
              P, blockIdx.x, gridDim.x, threadIdx.x, blockDim.x);
}

// out [lanes, n]; q0 (q1): lane b's challenge t at q0 + b qs0 + t qt0
// elements; alpha: lane b's at alpha + b as (q1, alpha: mode 2).
template <class C>
static int eq_table(void* out, const void* q0, const void* q1,
                    const void* alpha, int mode, long long n, int logn,
                    long long lanes, long long qs0, long long qt0,
                    long long qs1, long long qt1, long long as,
                    void* stream) {
  if ((mode != 1 && mode != 2) || logn < 0 || logn > EQ_LOGN_MAX ||
      n < 1 || n > (1ll << logn) || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  EqPlan P = eq_plan(logn, (uint32_t)n, mode);
  long long G = std::min<long long>(
      P.chunks, std::max<long long>((P.chunks + EQ_THREADS - 1) / EQ_THREADS,
                                    std::max(1ll, EQ_MAX_BLOCKS / lanes)));
  P.per = (uint32_t)((P.chunks + G - 1) / G);
  const size_t smem = (size_t)eq_smem_elts(P) * sizeof(Fp<C>);
  if (smem > 48 * 1024) {
    // never at logn <= 24 (44 KB at most); above the default, opt in
    const cudaError_t e = cudaFuncSetAttribute(
        k_eq_table<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k_eq_table<C><<<dim3((unsigned)G, (unsigned)lanes), EQ_THREADS, smem,
                  (cudaStream_t)stream>>>(
      (uint4*)out, (const uint4*)q0, (const uint4*)(mode == 2 ? q1 : q0),
      (const uint4*)(mode == 2 ? alpha : q0), qs0, qt0, mode == 2 ? qs1 : 0,
      mode == 2 ? qt1 : 0, mode == 2 ? as : 0, P);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                         \
  void *out, const void *q0, const void *q1, const void *alpha, int mode,  \
      long long n, int logn, long long lanes, long long qs0, long long qt0, \
      long long qs1, long long qt1, long long as, void *stream
#define LFZK_PASS \
  out, q0, q1, alpha, mode, n, logn, lanes, qs0, qt0, qs1, qt1, as, stream
extern "C" int eq_table_fp128(LFZK_ARGS) { return eq_table<P128>(LFZK_PASS); }
extern "C" int eq_table_fp256(LFZK_ARGS) { return eq_table<P256>(LFZK_PASS); }
extern "C" int eq_table_fp256k1(LFZK_ARGS) {
  return eq_table<P256K1>(LFZK_PASS);
}
extern "C" int eq_table_gf2_128(LFZK_ARGS) {
  return eq_table<G128>(LFZK_PASS);
}
