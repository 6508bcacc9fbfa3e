// K1 fp_elementwise: field elementwise ops, with an instance for each
// prime field of fp.cuh (Fp128, the P-256 and secp256k1 base fields, the
// ML-DSA prime, Goldilocks, the P-256 and secp256k1 group orders, the
// P-384 and P-521 base fields) and one for GF(2^128) (gf2.cuh: add = sub
// = XOR, neg the identity, 1 - r = 1 ^ r, the square by spread and fold).
//
// Replaces the JAX package's limb-unrolled field ops inside its jitted
// programs: PrimeField.add / sub / _mont_mul_limbs / from_mont_device
// (longfellow_zk_tpu/fields/fp.py:245, :255, :277, :187), the wire-round
// bind _bind_fixed (sumcheck/prover_device.py:139) and the hv update of
// _wire_scan.one_hand (prover_device.py:595); for GF(2^128) the JAX
// package's GF2_128.add / sub / mul (fields/gf2.py:281, :351) in the
// same places; with lanes, those inside the jax.vmap of the batch prover
// (zk/batch.py:301, :344).  Modes 5-9 are the rest of the field API,
// which no proof path calls: PrimeField.sqr, neg, eq, is_zero, select
// (fields/fp.py:457, :274, :500-507) and mul_const (:460, mode 0 by the
// constant's limbs), GF2_128.sqr, neg, eq, is_zero, select, mul_const
// (fields/gf2.py:361, :286, :392-398, :358).
//
// Bound on the H100: bytes, for every prime-field instance.  A multiply
// is 2 N^2 32-bit multiplies on 12 N bytes of traffic (N words an
// element): 32 on 48 bytes at Fp128, 128 on 96 at P-256, 578 on 204 at
// P-521, at or below the card's balance of about 5 multiplies per byte;
// add, sub, neg, eq, is_zero and select do no multiply.  So the design
// keeps the traffic minimal and each load and store of a warp on
// neighbouring addresses, in three layouts:
//   - 2, 4, 8 and 12 words (and GF(2^128)): one element a thread, a
//     uint2 or one to three uint4s an element (k_fp_elementwise, every
//     mode);
//   - one word (the ML-DSA prime): four elements a thread, uint4 loads
//     and stores (k_fp_quad, below);
//   - 17 words (P-521; 68 bytes are no whole number of uint4s, and a
//     thread's own words at a 68-byte stride scatter a warp's stores):
//     a tile of elements a block through shared memory (k_fp_tile17,
//     below).
// The one- and 17-word paths have a kernel a mode (a template argument)
// for the modes other than bind and hv, which take the first layout.
// In every layout b's index needs no division where b is the full
// operand or one element (b_index); the 64-bit division that every
// mode reading b used to run cost the one-word add 1.4 us of 5.0 at
// 2^20 elements (tools/k1_diag.cu).
// The GF(2^128) product of gf2.cuh spends about 2,000 32-bit operations
// on 48 bytes, so that instance is bound by its own operations: no
// instruction of the card computes a carry-less product.
//
// Modes:
//   0 mul   out[i] = a[i] * b[(i / bdiv) % bmod]
//   1 add   out[i] = a[i] + b[...]
//   2 sub   out[i] = a[i] - b[...]
//   3 bind  the bound half of each row of a (rows of length `row`): out
//           has row / 2 elements a row, out[j] = lo + (hi - lo) * r for the
//           pair (a[2j], a[2j+1]) of its row
//   4 hv    out[i] = a[i] * (h[i % bdiv] odd ? r : 1 - r)
//   5 sqr   out[i] = a[i]^2
//   6 neg   out[i] = -a[i]
//   7 eq    outb[i] = (a[i] == b[...]), one byte (0 or 1)
//   8 is_zero  outb[i] = (a[i] == 0), one byte
//   9 select   out[i] = cond[i] ? a[i] : b[...], cond one byte an element
//           (passed as h)
// In modes 3 and 4 the outputs come in lanes of bdiv elements (one proof
// of a batch each, or one lane), each with its own challenge: lane i /
// bdiv reads r = b[(i / bdiv) * bmod], bmod being the lane stride of b in
// elements, and in mode 4 the lanes share h.  The lanes add no launch: a
// batch of proofs binds in the one launch of a single proof.
#include "gf2.cuh"

enum { M_MUL, M_ADD, M_SUB, M_BIND, M_HV, M_SQR, M_NEG, M_EQ, M_IS_ZERO,
       M_SELECT };

// Where b's element of flat index i lies (bkind, from the host): b is
// the full operand (its element i: no division), one element (element
// 0), or broadcast, at (i / bdiv) % bmod in 32 bits while n < 2^32 (a
// software division either way, but a shorter one than in 64 bits).
enum { B_FULL, B_ONE, B_DIV32, B_DIV64 };

__device__ __forceinline__ long long b_index(long long i, long long bdiv,
                                             long long bmod, int bkind) {
  switch (bkind) {
    case B_FULL:
      return i;
    case B_ONE:
      return 0;
    case B_DIV32:
      return ((uint32_t)i / (uint32_t)bdiv) % (uint32_t)bmod;
    default:
      return (i / bdiv) % bmod;
  }
}

template <class C>
__global__ void k_fp_elementwise(int mode, uint4* __restrict__ out,
                                 const uint4* __restrict__ a,
                                 const uint4* __restrict__ b,
                                 const int* __restrict__ h, long long n,
                                 long long row, long long bdiv,
                                 long long bmod, int bkind) {
  typedef Fp<C> E;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (mode == 7 || mode == 8) {
    const E x = E::load(a, i);
    ((unsigned char*)out)[i] =
        mode == 7 ? fp_eq(x, E::load(b, b_index(i, bdiv, bmod, bkind)))
                  : fp_is_zero(x);
    return;
  }
  E r;
  switch (mode) {
    case 5:
      r = fp_sqr(E::load(a, i));
      break;
    case 6:
      r = fp_neg(E::load(a, i));
      break;
    case 9:
      r = ((const unsigned char*)h)[i]
              ? E::load(a, i)
              : E::load(b, b_index(i, bdiv, bmod, bkind));
      break;
    case 0:
      r = fp_mul(E::load(a, i),
                 E::load(b, b_index(i, bdiv, bmod, bkind)));
      break;
    case 1:
      r = fp_add(E::load(a, i),
                 E::load(b, b_index(i, bdiv, bmod, bkind)));
      break;
    case 2:
      r = fp_sub(E::load(a, i),
                 E::load(b, b_index(i, bdiv, bmod, bkind)));
      break;
    case 3: {
      const long long half = row / 2;
      const long long k = i / half, j = i - k * half;
      E lo = E::load(a, k * row + 2 * j);
      E hi = E::load(a, k * row + 2 * j + 1);
      r = fp_add(lo, fp_mul(fp_sub(hi, lo), E::load(b, (i / bdiv) * bmod)));
      break;
    }
    default: {
      E rr = E::load(b, (i / bdiv) * bmod);
      E f = (h[i % bdiv] & 1) ? rr : fp_sub(fp_one<C>(), rr);
      r = fp_mul(E::load(a, i), f);
      break;
    }
  }
  r.store(out, i);
}

// ---------------------------------------------------------------------
// The paths of one mode each (a template argument, so that a mode's
// kernel holds the registers of its own arithmetic only) for the modes
// other than bind and hv: the one-word instance four elements a thread,
// the 17-word one a tile of elements a block through shared memory.
// ---------------------------------------------------------------------

__host__ __device__ constexpr bool reads_b(int mode) {
  return mode == M_MUL || mode == M_ADD || mode == M_SUB || mode == M_EQ ||
         mode == M_SELECT;
}

__host__ __device__ constexpr bool bool_out(int mode) {
  return mode == M_EQ || mode == M_IS_ZERO;
}

// the field value of MODE (not eq, is_zero or select)
template <class C, int MODE>
__device__ __forceinline__ Fp<C> fp_op(const Fp<C>& x, const Fp<C>& y) {
  if constexpr (MODE == M_MUL)
    return fp_mul(x, y);
  else if constexpr (MODE == M_ADD)
    return fp_add(x, y);
  else if constexpr (MODE == M_SUB)
    return fp_sub(x, y);
  else if constexpr (MODE == M_SQR)
    return fp_sqr(x);
  else
    return fp_neg(x);
}

// -- the ML-DSA prime (N = 1): four elements a thread ------------------
//
// One word an element.  One element a thread, as the other instances
// take it, issued a 4-byte load per operand and thread, and every mode
// that reads b computed (i / bdiv) % bmod in 64 bits, a software
// division even where b is the full operand.  tools/k1_diag.cu's add of
// 2^20 elements split the cost (H100 80GB HBM3, 700 W, inputs in the
// L2): 0.00503 ms with that division, 0.00366 without, 0.00249 four
// elements a thread (eight or sixteen a thread, and blocks of 128, 512
// or 1,024 threads, were no faster: tools/k1_bench.py on variant trees).
// So here a thread takes four consecutive elements: one uint4 load of a
// and of a full b, one 32-bit load of the four condition bytes, one
// uint4 store (eq and is_zero: four bytes as one 32-bit store);
// b's index needs no division where b is full or one element, and a
// 32-bit one where it is broadcast.  A thread whose elements pass n, or
// whose operands are not aligned for the vectors (a view at an offset),
// goes word by word.

template <class C, int MODE>
__device__ __forceinline__ uint32_t op1(uint32_t x, uint32_t y, bool c) {
  if constexpr (MODE == M_EQ) {
    return x == y;
  } else if constexpr (MODE == M_IS_ZERO) {
    return x == 0u;
  } else if constexpr (MODE == M_SELECT) {
    return c ? x : y;
  } else {
    Fp<C> ex, ey;
    ex.l[0] = x;
    ey.l[0] = y;
    return fp_op<C, MODE>(ex, ey).l[0];
  }
}

constexpr int QUAD_THREADS = 256;  // threads a block

template <class C, int MODE>
__global__ void __launch_bounds__(QUAD_THREADS)
    k_fp_quad(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
              const uint32_t* __restrict__ b,
              const unsigned char* __restrict__ cond, long long n,
              long long bdiv, long long bmod, int bkind, int vec) {
  static_assert(C::N == 1, "one word an element");
  const long long q = (long long)blockIdx.x * QUAD_THREADS + threadIdx.x;
  const long long i0 = 4 * q;
  if (i0 >= n) return;
  if (vec && i0 + 4 <= n) {
    const uint4 x = ((const uint4*)a)[q];
    uint4 y = x;
    if constexpr (reads_b(MODE)) {
      if (bkind == B_FULL)
        y = ((const uint4*)b)[q];
      else
        y = make_uint4(b[b_index(i0, bdiv, bmod, bkind)],
                       b[b_index(i0 + 1, bdiv, bmod, bkind)],
                       b[b_index(i0 + 2, bdiv, bmod, bkind)],
                       b[b_index(i0 + 3, bdiv, bmod, bkind)]);
    }
    const uint32_t c = MODE == M_SELECT ? ((const uint32_t*)cond)[q] : 0u;
    const uint32_t r0 = op1<C, MODE>(x.x, y.x, c & 0xFFu),
                   r1 = op1<C, MODE>(x.y, y.y, c >> 8 & 0xFFu),
                   r2 = op1<C, MODE>(x.z, y.z, c >> 16 & 0xFFu),
                   r3 = op1<C, MODE>(x.w, y.w, c >> 24);
    if constexpr (bool_out(MODE))
      ((uint32_t*)out)[q] = r0 | r1 << 8 | r2 << 16 | r3 << 24;
    else
      ((uint4*)out)[q] = make_uint4(r0, r1, r2, r3);
    return;
  }
  for (long long i = i0; i < i0 + 4 && i < n; i++) {
    const uint32_t y =
        reads_b(MODE) ? b[b_index(i, bdiv, bmod, bkind)] : 0u;
    const uint32_t r =
        op1<C, MODE>(a[i], y, MODE == M_SELECT ? cond[i] != 0 : false);
    if constexpr (bool_out(MODE))
      ((unsigned char*)out)[i] = (unsigned char)r;
    else
      out[i] = r;
  }
}

// -- P-521 (N = 17): a tile of TILE17 elements a block -----------------
//
// Profiled in the layout of the other instances (one element a thread,
// its 17 words loaded and stored one by one at a 68-byte stride), the
// modes that write an element ran at 3.9-5.6x their bytes bound while
// eq and is_zero, which read the same way and write a byte, ran at
// 1.1-1.2x.  ncu and CUPTI's counters are out of reach on the card's
// machine, so tools/k1_diag.cu's copies of 2^20 such elements split the
// cost (H100 80GB HBM3, 700 W): word loads and word stores 0.240 ms,
// word loads and tile stores 0.049, tile loads and word stores 0.217,
// tiles both ways 0.049, the bytes bound 0.043.  The stores are the
// cost: a warp store writes 32 words into 32 different 32-byte sectors,
// while the L1 takes in the scattered reads.  So a block moves whole
// tiles: TILE17 is a multiple of 4, 4 x 68 = 272 bytes, so a tile starts
// on a 16-byte boundary, and a block copies a, and a full b, into shared
// memory with coalesced uint4 loads; each thread then reads its element
// there at a word stride of 17 (odd: the 32 lanes hit 32 banks),
// computes, writes the result back over its a, and the block stores the
// tile with coalesced uint4 stores.  Plain cooperative loads, not a bulk
// copy (cp.async.bulk): select chooses its operand for each 16 bytes,
// which a copy of the whole tile cannot; the memory-bound modes compute
// nothing that an asynchronous copy could overlap, and the blocks
// resident on an SM hide the latency.  Select reads the conditions first
// and then, for each 16 bytes, only the operand that the elements there
// choose (both where an element boundary inside them separates two
// choices); eq and is_zero write their bytes straight from the threads.
// A broadcast b (one element, a row) is read by index from device
// memory: it is small and stays in the L1.  The ragged last tile and an
// operand that is not 16-byte aligned (a view at an offset) go word by
// word, still coalesced.
constexpr int TILE17 = 128;  // elements a tile, and threads a block

// Copies nw words of a tile from src to dst (one of them in shared
// memory), as uint4s where vec (the device memory side 16-byte aligned,
// a whole tile): every load of a thread is issued before its stores.
__device__ __forceinline__ void tile_copy(uint32_t* dst, const uint32_t* src,
                                          int nw, bool vec) {
  constexpr int NV = TILE17 * 17 / 4, R = (NV + TILE17 - 1) / TILE17;
  if (vec) {
    uint4 v[R];
#pragma unroll
    for (int r = 0; r < R; r++) {
      const int k = r * TILE17 + threadIdx.x;
      if (k < NV) v[r] = ((const uint4*)src)[k];
    }
#pragma unroll
    for (int r = 0; r < R; r++) {
      const int k = r * TILE17 + threadIdx.x;
      if (k < NV) ((uint4*)dst)[k] = v[r];
    }
  } else {
    for (int k = threadIdx.x; k < nw; k += TILE17) dst[k] = src[k];
  }
}

// Select's tile (b full): word w from a where its element's condition
// (tc, the tile's conditions in shared memory) holds, else from b; as
// uint4s where vec, each read from the operand its elements choose, or
// from both where they choose differently.
__device__ __forceinline__ void select_tile_in(uint32_t* s,
                                               const uint32_t* ga,
                                               const uint32_t* gb,
                                               const unsigned char* tc,
                                               int nw, bool vec) {
  constexpr int NV = TILE17 * 17 / 4, R = (NV + TILE17 - 1) / TILE17;
  if (vec) {
    uint4 v[R];
#pragma unroll
    for (int r = 0; r < R; r++) {
      const int k = r * TILE17 + threadIdx.x;
      if (k < NV) {
        // words 4k .. 4k + 3: elements e0 and e1, 17 e1 the first of e1
        const int e0 = 4 * k / 17, e1 = (4 * k + 3) / 17;
        const bool c0 = tc[e0], c1 = tc[e1];
        v[r] = ((const uint4*)(c0 ? ga : gb))[k];
        if (c0 != c1) {
          const uint4 v1 = ((const uint4*)(c1 ? ga : gb))[k];
          const int cut = 17 * e1 - 4 * k;  // words of e0 here: 1 to 3
          if (cut < 2) v[r].y = v1.y;
          if (cut < 3) v[r].z = v1.z;
          v[r].w = v1.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; r++) {
      const int k = r * TILE17 + threadIdx.x;
      if (k < NV) ((uint4*)s)[k] = v[r];
    }
  } else {
    for (int w = threadIdx.x; w < nw; w += TILE17)
      s[w] = tc[w / 17] ? ga[w] : gb[w];
  }
}

template <class C, int MODE>
__global__ void __launch_bounds__(TILE17)
    k_fp_tile17(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b,
                const unsigned char* __restrict__ cond, long long n,
                long long bdiv, long long bmod, int bkind, int vec) {
  static_assert(C::N == 17, "17 words an element");
  constexpr int N = 17;
  typedef Fp<C> E;
  extern __shared__ __align__(16) uint32_t tile[];
  __shared__ unsigned char tc[TILE17];
  uint32_t* ta = tile;               // a's elements, then the results
  uint32_t* tb = tile + TILE17 * N;  // b's, where b is full
  const int t = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * TILE17;
  const int ne = (int)min((long long)TILE17, n - e0), nw = ne * N;
  const bool v = vec && ne == TILE17;
  const bool bfull = bkind == B_FULL;
  if constexpr (MODE == M_SELECT) {
    if (t < ne) tc[t] = cond[e0 + t];
    __syncthreads();
    if (bfull)
      select_tile_in(ta, a + e0 * N, b + e0 * N, tc, nw, v);
    else
      tile_copy(ta, a + e0 * N, nw, v);
  } else {
    tile_copy(ta, a + e0 * N, nw, v);
    if (reads_b(MODE) && bfull) tile_copy(tb, b + e0 * N, nw, v);
  }
  __syncthreads();
  if (t < ne) {
    uint32_t* sx = ta + t * N;
    if constexpr (MODE == M_SELECT) {
      if (!bfull && !tc[t]) {
        const E y =
            E::load((const uint4*)b, b_index(e0 + t, bdiv, bmod, bkind));
#pragma unroll
        for (int j = 0; j < N; j++) sx[j] = y.l[j];
      }
    } else {
      E x, y;
#pragma unroll
      for (int j = 0; j < N; j++) x.l[j] = sx[j];
      if constexpr (reads_b(MODE)) {
        if (bfull) {
#pragma unroll
          for (int j = 0; j < N; j++) y.l[j] = tb[t * N + j];
        } else {
          y = E::load((const uint4*)b, b_index(e0 + t, bdiv, bmod, bkind));
        }
      }
      if constexpr (bool_out(MODE)) {
        ((unsigned char*)out)[e0 + t] =
            MODE == M_EQ ? fp_eq(x, y) : fp_is_zero(x);
      } else {
        const E r = fp_op<C, MODE>(x, y);
#pragma unroll
        for (int j = 0; j < N; j++) sx[j] = r.l[j];
      }
    }
  }
  if constexpr (!bool_out(MODE)) {
    __syncthreads();
    tile_copy(out + e0 * N, ta, nw, v);
  }
}

// Launches MODE's kernel of the one- or 17-word instance; vec: every
// pointer that the vector loads and stores read is aligned for them.
template <class C, int MODE>
static void launch_mode(void* out, const void* a, const void* b,
                        const void* h, long long n, long long bdiv,
                        long long bmod, int bkind, cudaStream_t stream) {
  const bool rb = reads_b(MODE) && bkind == B_FULL;
  if constexpr (C::N == 1) {
    const uintptr_t al16 = (uintptr_t)a | (rb ? (uintptr_t)b : 0) |
                           (bool_out(MODE) ? 0 : (uintptr_t)out);
    const bool vec = (al16 & 15) == 0 &&
                     (!bool_out(MODE) || ((uintptr_t)out & 3) == 0) &&
                     (MODE != M_SELECT || ((uintptr_t)h & 3) == 0);
    const long long quads = (n + 3) / 4;
    k_fp_quad<C, MODE><<<(unsigned)((quads + QUAD_THREADS - 1) /
                                    QUAD_THREADS),
                         QUAD_THREADS, 0, stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b,
        (const unsigned char*)h, n, bdiv, bmod, bkind, vec);
  } else {
    const uintptr_t al16 = (uintptr_t)a | (rb ? (uintptr_t)b : 0) |
                           (bool_out(MODE) ? 0 : (uintptr_t)out);
    const bool two = rb && MODE != M_SELECT;  // b's tile too
    const size_t smem = (two ? 2 : 1) * TILE17 * C::N * sizeof(uint32_t);
    k_fp_tile17<C, MODE><<<(unsigned)((n + TILE17 - 1) / TILE17), TILE17,
                           smem, stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b,
        (const unsigned char*)h, n, bdiv, bmod, bkind, (al16 & 15) == 0);
  }
}

template <class C>
static int fp_elementwise(int mode, void* out, const void* a, const void* b,
                          const void* h, long long n, long long row,
                          long long bdiv, long long bmod, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int bkind = bdiv == 1 && bmod >= n ? B_FULL
                    : bmod == 1            ? B_ONE
                    : n <= 0xFFFFFFFFll    ? B_DIV32
                                           : B_DIV64;
  if constexpr (C::N == 1 || C::N == 17) {
#define LFZK_MODE(M)                                                \
  case M:                                                           \
    launch_mode<C, M>(out, a, b, h, n, bdiv, bmod, bkind, s);       \
    return (int)cudaGetLastError();
    switch (mode) {
      LFZK_MODE(M_MUL)
      LFZK_MODE(M_ADD)
      LFZK_MODE(M_SUB)
      LFZK_MODE(M_SQR)
      LFZK_MODE(M_NEG)
      LFZK_MODE(M_EQ)
      LFZK_MODE(M_IS_ZERO)
      LFZK_MODE(M_SELECT)
      default:
        break;  // bind and hv: one element a thread, below
    }
#undef LFZK_MODE
  }
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  k_fp_elementwise<C><<<(unsigned)blocks, threads, 0, s>>>(
      mode, (uint4*)out, (const uint4*)a, (const uint4*)b, (const int*)h, n,
      row, bdiv, bmod, bkind);
  return (int)cudaGetLastError();
}

#define LFZK_ARGS                                                          \
  int mode, void *out, const void *a, const void *b, const void *h,       \
      long long n, long long row, long long bdiv, long long bmod,         \
      void *stream
extern "C" int fp_elementwise_fp128(LFZK_ARGS) {
  return fp_elementwise<P128>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_fp256(LFZK_ARGS) {
  return fp_elementwise<P256>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_fp256k1(LFZK_ARGS) {
  return fp_elementwise<P256K1>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_fp24(LFZK_ARGS) {
  return fp_elementwise<FP24>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_fp64(LFZK_ARGS) {
  return fp_elementwise<FP64>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_p256n(LFZK_ARGS) {
  return fp_elementwise<P256N>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_p256k1n(LFZK_ARGS) {
  return fp_elementwise<P256K1N>(mode, out, a, b, h, n, row, bdiv, bmod,
                                 stream);
}
extern "C" int fp_elementwise_p384(LFZK_ARGS) {
  return fp_elementwise<P384>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_p521(LFZK_ARGS) {
  return fp_elementwise<P521>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
extern "C" int fp_elementwise_gf2_128(LFZK_ARGS) {
  return fp_elementwise<G128>(mode, out, a, b, h, n, row, bdiv, bmod, stream);
}
