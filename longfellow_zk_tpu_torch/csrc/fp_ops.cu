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
//   - 2, 4 and 8 words: one element a thread, a uint2 or one or two
//     uint4s an element, a kernel a mode (k_fp_ew, k_fp_lane, below);
//   - one word (the ML-DSA prime): four elements a thread, uint4 loads
//     and stores (k_fp_quad, below);
//   - 12 and 17 words (P-384, P-521; 68 bytes are no whole number of
//     uint4s, and a thread's own words at a 48- or 68-byte stride
//     scatter a warp's accesses): a tile of elements a block through
//     shared memory (k_fp_tile, below), a kernel a mode; P-384's bind
//     and hv take k_fp_lane.
// The one- and 17-word instances' bind and hv take k_fp_elementwise.
// In every layout b's index needs no division where b is the full
// operand or one element (b_index); the 64-bit division that every
// mode reading b used to run cost the one-word add 1.4 us of 5.0 at
// 2^20 elements (tools/k1_diag.cu).
// GF(2^128) has kernels of its own (k_g128_ew, k_g128_lane, below): a
// product there is bound by its own operations, since no instruction of
// the card computes a carry-less product (gf2.cuh).
//
// Modes:
//   0 mul   out[i] = a[i] * b[(i / bdiv) % bmod]
//   1 add   out[i] = a[i] + b[...]
//   2 sub   out[i] = a[i] - b[...]
//   3 bind  the bound half of each row of a (rows of length `row`): out
//           has row / 2 elements a row, out[j] = lo + (hi - lo) * r for the
//           pair (a[2j], a[2j+1]) of its row
//   4 hv    out[i] = a[i] * ((h[i % bdiv] >> shift) odd ? r : 1 - r), the
//           round's shift of the hand's indices an argument (0-31)
//   5 sqr   out[i] = a[i]^2
//   6 neg   out[i] = -a[i]
//   7 eq    outb[i] = (a[i] == b[...]), one byte (0 or 1)
//   8 is_zero  outb[i] = (a[i] == 0), one byte
//   9 select   out[i] = cond[i] ? a[i] : b[...], cond one byte an element
//           (passed as h)
//  11 bind_hv  a hand-round's bind of a (mode 3, into out) and hv update
//           of a2 (mode 4, into out2, n2 elements) by the same r, one
//           launch (the 2-12-word instances; the others take the two
//           modes)
// In modes 3, 4 and 11 the outputs come in lanes of bdiv elements (one
// proof of a batch each, or one lane), each with its own challenge: lane
// i / bdiv reads r = b[(i / bdiv) * bmod], bmod being the lane stride of
// b in elements, and in mode 4 the lanes share h.  The lanes add no
// launch: a batch of proofs binds in the one launch of a single proof.
#include <algorithm>
#include <type_traits>

#include "gf2.cuh"

enum { M_MUL, M_ADD, M_SUB, M_BIND, M_HV, M_SQR, M_NEG, M_EQ, M_IS_ZERO,
       M_SELECT, M_BIND_HV = 11 };

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

// Bind and hv at the one- and 17-word instances: one element a thread
// under a run-time mode.
template <class C>
__global__ void k_fp_elementwise(int mode, uint4* __restrict__ out,
                                 const uint4* __restrict__ a,
                                 const uint4* __restrict__ b,
                                 const int* __restrict__ h, long long n,
                                 long long row, long long bdiv,
                                 long long bmod, int bkind, int shift) {
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
      E f = ((h[i % bdiv] >> shift) & 1) ? rr : fp_sub(fp_one<C>(), rr);
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
// the 12- and 17-word ones a tile of elements a block through shared
// memory.
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

// -- P-384 and P-521 (N = 12, 17): a tile of TILE_ELTS elements a block -
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
// tiles: TILE_ELTS is a multiple of 4, 4 x 68 = 272 bytes, so a tile
// starts on a 16-byte boundary, and a block copies a, and a full b, into
// shared memory with coalesced uint4 loads; each thread then reads its
// element there at a word stride of 17 (odd: the 32 lanes hit 32 banks),
// computes, writes the result back over its a, and the block stores the
// tile with coalesced uint4 stores.  P-384's elements, three uint4s each
// at a 48-byte stride, took one a thread (k_fp_ew) 6-21 % longer in its
// memory-bound modes than one kernel of every mode whose registers held
// fewer blocks on an SM (H100 80GB HBM3, 700 W, tools/k9k1_bench.py, in
// turns), so they take tiles too, each thread's element read and written
// there as uint4s (no bank conflict at that stride): every mode within
// 4 % of that kernel, neg and add 18 % and 12 % faster than one element
// a thread.  Plain cooperative loads, not a bulk
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
constexpr int TILE_ELTS = 128;  // elements a tile, and threads a block

// Copies nw words of a tile of N-word elements from src to dst (one of
// them in shared memory), as uint4s where vec (the device memory side
// 16-byte aligned, a whole tile): every load of a thread is issued
// before its stores.
template <int N>
__device__ __forceinline__ void tile_copy(uint32_t* dst, const uint32_t* src,
                                          int nw, bool vec) {
  constexpr int NV = TILE_ELTS * N / 4, R = (NV + TILE_ELTS - 1) / TILE_ELTS;
  if (vec) {
    uint4 v[R];
#pragma unroll
    for (int r = 0; r < R; r++) {
      const int k = r * TILE_ELTS + threadIdx.x;
      if (k < NV) v[r] = ((const uint4*)src)[k];
    }
#pragma unroll
    for (int r = 0; r < R; r++) {
      const int k = r * TILE_ELTS + threadIdx.x;
      if (k < NV) ((uint4*)dst)[k] = v[r];
    }
  } else {
    for (int k = threadIdx.x; k < nw; k += TILE_ELTS) dst[k] = src[k];
  }
}

// Select's tile (b full): word w from a where its element's condition
// (tc, the tile's conditions in shared memory) holds, else from b; as
// uint4s where vec, each read from the operand its elements choose, or
// from both where they choose differently.
template <int N>
__device__ __forceinline__ void select_tile_in(uint32_t* s,
                                               const uint32_t* ga,
                                               const uint32_t* gb,
                                               const unsigned char* tc,
                                               int nw, bool vec) {
  constexpr int NV = TILE_ELTS * N / 4, R = (NV + TILE_ELTS - 1) / TILE_ELTS;
  if (vec) {
    uint4 v[R];
#pragma unroll
    for (int r = 0; r < R; r++) {
      const int k = r * TILE_ELTS + threadIdx.x;
      if (k < NV) {
        // words 4k .. 4k + 3: elements e0 and e1, N e1 the first of e1
        const int e0 = 4 * k / N, e1 = (4 * k + 3) / N;
        const bool c0 = tc[e0], c1 = tc[e1];
        v[r] = ((const uint4*)(c0 ? ga : gb))[k];
        if (c0 != c1) {
          const uint4 v1 = ((const uint4*)(c1 ? ga : gb))[k];
          const int cut = N * e1 - 4 * k;  // words of e0 here: 1 to 3
          if (cut < 2) v[r].y = v1.y;
          if (cut < 3) v[r].z = v1.z;
          v[r].w = v1.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; r++) {
      const int k = r * TILE_ELTS + threadIdx.x;
      if (k < NV) ((uint4*)s)[k] = v[r];
    }
  } else {
    for (int w = threadIdx.x; w < nw; w += TILE_ELTS)
      s[w] = tc[w / N] ? ga[w] : gb[w];
  }
}

// A thread's element in the tile (word by word at 17 words, as uint4s at
// 12).
template <class C>
__device__ __forceinline__ Fp<C> tile_elt(const uint32_t* sx) {
  if constexpr (C::N % 4 == 0) {
    return Fp<C>::load((const uint4*)sx, 0);
  } else {
    Fp<C> x;
#pragma unroll
    for (int j = 0; j < C::N; j++) x.l[j] = sx[j];
    return x;
  }
}

template <class C>
__device__ __forceinline__ void tile_put(uint32_t* sx, const Fp<C>& x) {
  if constexpr (C::N % 4 == 0) {
    x.store((uint4*)sx, 0);
  } else {
#pragma unroll
    for (int j = 0; j < C::N; j++) sx[j] = x.l[j];
  }
}

template <class C, int MODE>
__global__ void __launch_bounds__(TILE_ELTS)
    k_fp_tile(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
              const uint32_t* __restrict__ b,
              const unsigned char* __restrict__ cond, long long n,
              long long bdiv, long long bmod, int bkind, int vec) {
  static_assert(C::N == 12 || C::N == 17, "12 or 17 words an element");
  constexpr int N = C::N;
  typedef Fp<C> E;
  extern __shared__ __align__(16) uint32_t tile[];
  __shared__ unsigned char tc[TILE_ELTS];
  uint32_t* ta = tile;                  // a's elements, then the results
  uint32_t* tb = tile + TILE_ELTS * N;  // b's, where b is full
  const int t = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * TILE_ELTS;
  const int ne = (int)min((long long)TILE_ELTS, n - e0), nw = ne * N;
  const bool v = vec && ne == TILE_ELTS;
  const bool bfull = bkind == B_FULL;
  if constexpr (MODE == M_SELECT) {
    if (t < ne) tc[t] = cond[e0 + t];
    __syncthreads();
    if (bfull)
      select_tile_in<N>(ta, a + e0 * N, b + e0 * N, tc, nw, v);
    else
      tile_copy<N>(ta, a + e0 * N, nw, v);
  } else {
    tile_copy<N>(ta, a + e0 * N, nw, v);
    if (reads_b(MODE) && bfull) tile_copy<N>(tb, b + e0 * N, nw, v);
  }
  __syncthreads();
  if (t < ne) {
    uint32_t* sx = ta + t * N;
    if constexpr (MODE == M_SELECT) {
      if (!bfull && !tc[t]) {
        tile_put<C>(sx, E::load((const uint4*)b,
                                b_index(e0 + t, bdiv, bmod, bkind)));
      }
    } else {
      const E x = tile_elt<C>(sx);
      E y;
      if constexpr (reads_b(MODE)) {
        if (bfull) {
          y = tile_elt<C>(tb + t * N);
        } else {
          y = E::load((const uint4*)b, b_index(e0 + t, bdiv, bmod, bkind));
        }
      }
      if constexpr (bool_out(MODE)) {
        ((unsigned char*)out)[e0 + t] =
            MODE == M_EQ ? fp_eq(x, y) : fp_is_zero(x);
      } else {
        tile_put<C>(sx, fp_op<C, MODE>(x, y));
      }
    }
  }
  if constexpr (!bool_out(MODE)) {
    __syncthreads();
    tile_copy<N>(out + e0 * N, ta, nw, v);
  }
}

// -- GF(2^128): a kernel a mode ----------------------------------------
//
// A GF(2^128) product is bound by its own operations (gf2.cuh), a copy
// (neg) reaches torch.clone only with several elements a thread, and the
// binds and hv updates of a proof run at every size from one element to
// millions.  So:
//   - k_g128_ew<MODE, E>: mul by a full or broadcast b (gf2.cuh's
//     Karatsuba product), add, sub, sqr, neg, eq, is_zero and select, E
//     elements a thread (1 for mul, 2 for sqr, 4 for the memory-bound
//     modes), all of a thread's loads made before its stores, each warp
//     access 512 contiguous bytes;
//   - k_g128_lane<MODE, TAB>: the products by one element r a lane (bind:
//     lo + (hi - lo) r = lo ^ (lo ^ hi) r; hv: x (1 - r) = x ^ x r where
//     h is even; mul by one element, or by one element a row of at least
//     G128_LANE_MIN elements).  The grid is cut at lanes (blockIdx.y), so
//     no index is divided: bind's pair of output i is a[2i], a[2i + 1] in
//     every row layout.  From G128_TAB_MIN elements (TAB) each block first
//     builds its lane's table of r's multiples in shared memory (gf2.cuh
//     g128_tab_build) and the grid holds the blocks that the card keeps
//     resident, each taking many elements; below it each thread splits r
//     once and multiplies by Karatsuba, where building the table would
//     cost more than it saves (tools/gf2_bench.py's hv and bind rows at
//     2^8-2^19 elements).
constexpr int G128_THREADS = 256;
constexpr long long G128_LANE_MIN = 1024;  // elements a row for the lane path
constexpr long long G128_TAB_MIN = 131072;  // elements for the table

template <int MODE>
constexpr int g128_ept() {
  return MODE == M_MUL ? 1 : MODE == M_SQR ? 2 : 4;
}

__device__ __forceinline__ Fp<G128> g128_of(const uint4& v) {
  Fp<G128> r;
  r.l[0] = v.x;
  r.l[1] = v.y;
  r.l[2] = v.z;
  r.l[3] = v.w;
  return r;
}

template <int MODE, int E>
__global__ void __launch_bounds__(G128_THREADS)
    k_g128_ew(uint4* __restrict__ out, const uint4* __restrict__ a,
              const uint4* __restrict__ b,
              const unsigned char* __restrict__ cond, long long n,
              long long bdiv, long long bmod, int bkind) {
  typedef Fp<G128> F;
  const long long i0 =
      (long long)blockIdx.x * (E * G128_THREADS) + threadIdx.x;
  uint4 x[E], y[E];
#pragma unroll
  for (int e = 0; e < E; e++) {
    const long long i = i0 + (long long)e * G128_THREADS;
    if (i < n) {
      if constexpr (MODE == M_SELECT) {
        x[e] = cond[i] ? a[i] : b[b_index(i, bdiv, bmod, bkind)];
      } else {
        x[e] = a[i];
        if constexpr (reads_b(MODE))
          y[e] = b[b_index(i, bdiv, bmod, bkind)];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; e++) {
    const long long i = i0 + (long long)e * G128_THREADS;
    if (i >= n) continue;
    if constexpr (MODE == M_EQ) {
      ((unsigned char*)out)[i] = x[e].x == y[e].x && x[e].y == y[e].y &&
                                 x[e].z == y[e].z && x[e].w == y[e].w;
    } else if constexpr (MODE == M_IS_ZERO) {
      ((unsigned char*)out)[i] = (x[e].x | x[e].y | x[e].z | x[e].w) == 0u;
    } else if constexpr (MODE == M_SELECT || MODE == M_NEG) {
      out[i] = x[e];
    } else if constexpr (MODE == M_ADD || MODE == M_SUB) {
      out[i] = make_uint4(x[e].x ^ y[e].x, x[e].y ^ y[e].y, x[e].z ^ y[e].z,
                          x[e].w ^ y[e].w);
    } else {
      const F ex = g128_of(x[e]);
      if constexpr (MODE == M_SQR)
        fp_sqr(ex).store(out, i);
      else
        fp_mul(ex, g128_of(y[e])).store(out, i);
    }
  }
}

// grid (blocks a lane, lanes): lane l's L outputs, its r at b[l * bmod]
// (bind, hv: bmod the lanes' stride in b) or b[l % bmod] (mul); hv's h is
// shared by the lanes.  Dynamic shared memory: the table (TAB).
template <int MODE, bool TAB>
__global__ void __launch_bounds__(G128_THREADS)
    k_g128_lane(uint4* __restrict__ out, const uint4* __restrict__ a,
                const uint4* __restrict__ b, const int* __restrict__ h,
                long long L, long long bmod, int shift) {
  typedef Fp<G128> F;
  extern __shared__ __align__(16) uint4 g128_tab[];
  const long long lane = blockIdx.y;
  const F r = F::load(b, MODE == M_MUL ? lane % bmod : lane * bmod);
  G128Split rs;
  if constexpr (TAB)
    g128_tab_build(r, g128_tab);
  else
    g128_split(r, rs);
  const long long o0 = lane * L;
  for (long long j = (long long)blockIdx.x * G128_THREADS + threadIdx.x;
       j < L; j += (long long)gridDim.x * G128_THREADS) {
    F x, lo;
    if constexpr (MODE == M_BIND) {
      lo = F::load(a, 2 * (o0 + j));
      const F hi = F::load(a, 2 * (o0 + j) + 1);
      x = fp_add(lo, hi);
    } else {
      x = F::load(a, o0 + j);
    }
    F p;
    if constexpr (TAB) {
      p = g128_tab_mul(g128_tab, x);
    } else {
      uint32_t t[8];
      g128_clmul(rs, x, t);
      p = g128_fold(t);
    }
    if constexpr (MODE == M_BIND)
      p = fp_add(lo, p);
    else if constexpr (MODE == M_HV)
      p = ((h[j] >> shift) & 1) ? p : fp_add(x, p);
    p.store(out, o0 + j);
  }
}

// The SMs and the resident blocks of KERNEL with `smem` bytes, once.
template <class K>
static int g128_resident(K kernel, size_t smem) {
  int dev = 0, nsm = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, G128_THREADS,
                                                smem);
  return std::max(1, nsm * per);
}

template <int MODE>
static void g128_lane_launch(void* out, const void* a, const void* b,
                             const void* h, long long lanes, long long L,
                             long long bmod, int shift, cudaStream_t s) {
  const long long need = (L + G128_THREADS - 1) / G128_THREADS;
  if (lanes * L >= G128_TAB_MIN) {
    static const int resident =
        g128_resident(k_g128_lane<MODE, true>, G128_TAB_BYTES);
    const long long per = std::max(1ll, (long long)resident / lanes);
    k_g128_lane<MODE, true>
        <<<dim3((unsigned)std::min(need, per), (unsigned)lanes), G128_THREADS,
           G128_TAB_BYTES, s>>>((uint4*)out, (const uint4*)a,
                                (const uint4*)b, (const int*)h, L, bmod,
                                shift);
  } else {
    k_g128_lane<MODE, false>
        <<<dim3((unsigned)need, (unsigned)lanes), G128_THREADS, 0, s>>>(
            (uint4*)out, (const uint4*)a, (const uint4*)b, (const int*)h, L,
            bmod, shift);
  }
}

template <int MODE>
static void g128_ew_launch(void* out, const void* a, const void* b,
                           const void* h, long long n, long long bdiv,
                           long long bmod, int bkind, cudaStream_t s) {
  constexpr int E = g128_ept<MODE>();
  const long long blocks = (n + E * G128_THREADS - 1) / (E * G128_THREADS);
  k_g128_ew<MODE, E><<<(unsigned)blocks, G128_THREADS, 0, s>>>(
      (uint4*)out, (const uint4*)a, (const uint4*)b,
      (const unsigned char*)h, n, bdiv, bmod, bkind);
}

// K1 at GF(2^128): the route of a call (bdiv, bmod as in the header; in
// bind and hv bdiv is a lane's outputs and bmod the lanes' stride in b).
static int g128_elementwise(int mode, void* out, const void* a,
                            const void* b, const void* h, long long n,
                            long long bdiv, long long bmod, int bkind,
                            int shift, cudaStream_t s) {
  if (mode == M_BIND || mode == M_HV) {
    const long long lanes = n / bdiv;
    if (lanes > 65535) return (int)cudaErrorInvalidValue;
    if (mode == M_BIND)
      g128_lane_launch<M_BIND>(out, a, b, h, lanes, bdiv, bmod, 0, s);
    else
      g128_lane_launch<M_HV>(out, a, b, h, lanes, bdiv, bmod, shift, s);
    return (int)cudaGetLastError();
  }
  if (mode == M_MUL && (bkind == B_ONE || (bkind != B_FULL &&
                                            bdiv >= G128_LANE_MIN &&
                                            n / bdiv <= 65535))) {
    const long long lanes = bkind == B_ONE ? 1 : n / bdiv;
    g128_lane_launch<M_MUL>(out, a, b, h, lanes, n / lanes, bmod, 0, s);
    return (int)cudaGetLastError();
  }
#define LFZK_G128(M)                                            \
  case M:                                                       \
    g128_ew_launch<M>(out, a, b, h, n, bdiv, bmod, bkind, s);   \
    return (int)cudaGetLastError();
  switch (mode) {
    LFZK_G128(M_MUL)
    LFZK_G128(M_ADD)
    LFZK_G128(M_SUB)
    LFZK_G128(M_SQR)
    LFZK_G128(M_NEG)
    LFZK_G128(M_EQ)
    LFZK_G128(M_IS_ZERO)
    LFZK_G128(M_SELECT)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LFZK_G128
}

// Launches MODE's kernel of the one-, 12- or 17-word instance; vec: every
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
    const size_t smem = (two ? 2 : 1) * TILE_ELTS * C::N * sizeof(uint32_t);
    k_fp_tile<C, MODE><<<(unsigned)((n + TILE_ELTS - 1) / TILE_ELTS),
                         TILE_ELTS, smem, stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b,
        (const unsigned char*)h, n, bdiv, bmod, bkind, (al16 & 15) == 0);
  }
}

// -- 2, 4, 8 and 12 words: a kernel a mode ------------------------------
//
// These instances (Fp128, the P-256 and secp256k1 base fields and
// orders, Goldilocks, P-384) took one kernel for every mode, a run-time
// switch over ten: it held the registers of every mode's arithmetic,
// and bind and hv split the flat index by 64-bit software divisions (i /
// half, (i / bdiv) * bmod, i % bdiv).  Now:
//   - k_fp_ew<C, MODE>: mul, add, sub, sqr, neg, eq, is_zero and select,
//     one element a thread, each mode its own kernel (P-384: k_fp_tile,
//     above);
//   - k_fp_lane<C, MODE>: bind, hv and bind_hv on a grid cut at lanes
//     (blockIdx.y), an output's index within its lane in 32 bits, so no
//     index is divided: bind's pair of output i is a[2i], a[2i + 1] in
//     every row layout, hv's index into h is the index within the lane,
//     a lane's r is b[lane * bmod].  bind_hv runs a hand-round's two
//     updates by one r (sumcheck/prover.py): a lane's first nbw blocks
//     bind W, the rest update hv.
constexpr int EW_THREADS = 256;

template <class C, int MODE>
__global__ void __launch_bounds__(EW_THREADS)
    k_fp_ew(uint4* __restrict__ out, const uint4* __restrict__ a,
            const uint4* __restrict__ b,
            const unsigned char* __restrict__ cond, long long n,
            long long bdiv, long long bmod, int bkind) {
  typedef Fp<C> E;
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= n) return;
  if constexpr (bool_out(MODE)) {
    const E x = E::load(a, i);
    ((unsigned char*)out)[i] =
        MODE == M_EQ ? fp_eq(x, E::load(b, b_index(i, bdiv, bmod, bkind)))
                     : fp_is_zero(x);
  } else if constexpr (MODE == M_SELECT) {
    (cond[i] ? E::load(a, i) : E::load(b, b_index(i, bdiv, bmod, bkind)))
        .store(out, i);
  } else {
    const E x = E::load(a, i);
    const E y = reads_b(MODE) ? E::load(b, b_index(i, bdiv, bmod, bkind))
                              : x;
    fp_op<C, MODE>(x, y).store(out, i);
  }
}

// grid (blocks a lane, lanes): bind's LW outputs a lane from w into
// outw, hv's LH from hv into outh (h shared by the lanes); in M_BIND_HV
// blocks [0, nbw) of a lane bind, the others update hv.
template <class C, int MODE>
__global__ void __launch_bounds__(EW_THREADS)
    k_fp_lane(uint4* __restrict__ outw, const uint4* __restrict__ w,
              uint4* __restrict__ outh, const uint4* __restrict__ hv,
              const int* __restrict__ h, const uint4* __restrict__ r,
              uint32_t LW, uint32_t LH, uint32_t nbw, long long bmod,
              int shift) {
  typedef Fp<C> E;
  const uint32_t lane = blockIdx.y;
  const E rr = E::load(r, (long long)lane * bmod);
  const bool bind =
      MODE == M_BIND || (MODE == M_BIND_HV && blockIdx.x < nbw);
  if (bind) {
    const uint32_t j = blockIdx.x * EW_THREADS + threadIdx.x;
    if (j >= LW) return;
    const u64 i = (u64)lane * LW + j;
    const E lo = E::load(w, (long long)(2 * i));
    const E hi = E::load(w, (long long)(2 * i + 1));
    fp_add(lo, fp_mul(fp_sub(hi, lo), rr)).store(outw, (long long)i);
  } else {
    const uint32_t j =
        (blockIdx.x - (MODE == M_BIND_HV ? nbw : 0u)) * EW_THREADS +
        threadIdx.x;
    if (j >= LH) return;
    const u64 i = (u64)lane * LH + j;
    const E f = ((h[j] >> shift) & 1) ? rr : fp_sub(fp_one<C>(), rr);
    fp_mul(E::load(hv, (long long)i), f).store(outh, (long long)i);
  }
}

template <class C, int MODE>
static int lane_launch(void* outw, const void* w, void* outh,
                       const void* hv, const void* h, const void* r,
                       long long lanes, long long LW, long long LH,
                       long long bmod, int shift, cudaStream_t s) {
  if (lanes <= 0 || lanes > 65535 || LW >= (1ll << 32) ||
      LH >= (1ll << 32))
    return (int)cudaErrorInvalidValue;
  const long long nbw = MODE == M_HV ? 0 : (LW + EW_THREADS - 1) / EW_THREADS;
  const long long nbh =
      MODE == M_BIND ? 0 : (LH + EW_THREADS - 1) / EW_THREADS;
  if (nbw + nbh == 0) return 0;
  k_fp_lane<C, MODE><<<dim3((unsigned)(nbw + nbh), (unsigned)lanes),
                       EW_THREADS, 0, s>>>(
      (uint4*)outw, (const uint4*)w, (uint4*)outh, (const uint4*)hv,
      (const int*)h, (const uint4*)r, (uint32_t)LW, (uint32_t)LH,
      (uint32_t)nbw, bmod, shift);
  return (int)cudaGetLastError();
}

template <class C, int MODE>
static int ew_launch(void* out, const void* a, const void* b,
                     const void* h, long long n, long long bdiv,
                     long long bmod, int bkind, cudaStream_t s) {
  if constexpr (C::N == 12)
    launch_mode<C, MODE>(out, a, b, h, n, bdiv, bmod, bkind, s);
  else
    k_fp_ew<C, MODE><<<(unsigned)((n + EW_THREADS - 1) / EW_THREADS),
                       EW_THREADS, 0, s>>>(
        (uint4*)out, (const uint4*)a, (const uint4*)b,
        (const unsigned char*)h, n, bdiv, bmod, bkind);
  return (int)cudaGetLastError();
}

// K1 at 2-12 words: the kernel of a call's mode (bind, hv, bind_hv: bdiv
// a lane's outputs of bind, or of hv, bmod the lanes' stride in b).
template <class C>
static int words_elementwise(int mode, void* out, const void* a,
                             const void* b, const void* h, long long n,
                             long long bdiv, long long bmod, int bkind,
                             void* out2, const void* a2, long long n2,
                             int shift, cudaStream_t s) {
  const long long lanes = (mode == M_BIND || mode == M_HV ||
                           mode == M_BIND_HV) ? n / bdiv : 0;
  switch (mode) {
    case M_BIND:
      return lane_launch<C, M_BIND>(out, a, nullptr, nullptr, nullptr, b,
                                    lanes, bdiv, 0, bmod, 0, s);
    case M_HV:
      return lane_launch<C, M_HV>(nullptr, nullptr, out, a, h, b, lanes, 0,
                                  bdiv, bmod, shift, s);
    case M_BIND_HV:
      if (n2 % lanes) return (int)cudaErrorInvalidValue;
      return lane_launch<C, M_BIND_HV>(out, a, out2, a2, h, b, lanes, bdiv,
                                       n2 / lanes, bmod, shift, s);
#define LFZK_EW(M) \
  case M:          \
    return ew_launch<C, M>(out, a, b, h, n, bdiv, bmod, bkind, s);
    LFZK_EW(M_MUL)
    LFZK_EW(M_ADD)
    LFZK_EW(M_SUB)
    LFZK_EW(M_SQR)
    LFZK_EW(M_NEG)
    LFZK_EW(M_EQ)
    LFZK_EW(M_IS_ZERO)
    LFZK_EW(M_SELECT)
#undef LFZK_EW
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <class C>
static int fp_elementwise(int mode, void* out, const void* a, const void* b,
                          const void* h, long long n, long long row,
                          long long bdiv, long long bmod, void* out2,
                          const void* a2, long long n2, int shift,
                          void* stream) {
  if (n <= 0) return 0;
  if (shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int bkind = bdiv == 1 && bmod >= n ? B_FULL
                    : bmod == 1            ? B_ONE
                    : n <= 0xFFFFFFFFll    ? B_DIV32
                                           : B_DIV64;
  if constexpr (std::is_same<C, G128>::value) {
    return g128_elementwise(mode, out, a, b, h, n, bdiv, bmod, bkind, shift,
                            s);
  } else if constexpr (C::N == 1 || C::N == 17) {
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
      case M_BIND:
      case M_HV:
        break;  // one element a thread, below
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef LFZK_MODE
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    k_fp_elementwise<C><<<(unsigned)blocks, threads, 0, s>>>(
        mode, (uint4*)out, (const uint4*)a, (const uint4*)b, (const int*)h,
        n, row, bdiv, bmod, bkind, shift);
    return (int)cudaGetLastError();
  } else {
    return words_elementwise<C>(mode, out, a, b, h, n, bdiv, bmod, bkind,
                                out2, a2, n2, shift, s);
  }
}

#define LFZK_ARGS                                                          \
  int mode, void *out, const void *a, const void *b, const void *h,       \
      long long n, long long row, long long bdiv, long long bmod,         \
      void *out2, const void *a2, long long n2, int shift, void *stream
#define LFZK_PASS \
  mode, out, a, b, h, n, row, bdiv, bmod, out2, a2, n2, shift, stream
extern "C" int fp_elementwise_fp128(LFZK_ARGS) {
  return fp_elementwise<P128>(LFZK_PASS);
}
extern "C" int fp_elementwise_fp256(LFZK_ARGS) {
  return fp_elementwise<P256>(LFZK_PASS);
}
extern "C" int fp_elementwise_fp256k1(LFZK_ARGS) {
  return fp_elementwise<P256K1>(LFZK_PASS);
}
extern "C" int fp_elementwise_fp24(LFZK_ARGS) {
  return fp_elementwise<FP24>(LFZK_PASS);
}
extern "C" int fp_elementwise_fp64(LFZK_ARGS) {
  return fp_elementwise<FP64>(LFZK_PASS);
}
extern "C" int fp_elementwise_p256n(LFZK_ARGS) {
  return fp_elementwise<P256N>(LFZK_PASS);
}
extern "C" int fp_elementwise_p256k1n(LFZK_ARGS) {
  return fp_elementwise<P256K1N>(LFZK_PASS);
}
extern "C" int fp_elementwise_p384(LFZK_ARGS) {
  return fp_elementwise<P384>(LFZK_PASS);
}
extern "C" int fp_elementwise_p521(LFZK_ARGS) {
  return fp_elementwise<P521>(LFZK_PASS);
}
extern "C" int fp_elementwise_gf2_128(LFZK_ARGS) {
  return fp_elementwise<G128>(LFZK_PASS);
}
