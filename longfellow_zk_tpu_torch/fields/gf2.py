"""GF(2^128) = GF(2)[x] / (x^128 + x^7 + x^2 + x + 1) with its GF(2^16)
subfield: host ints and PyTorch tensors.

Host side (plain Python ints holding the 128 polynomial bits) is the JAX
package's `GF2_128` host API (longfellow_zk_tpu/fields/gf2.py:56-226),
copied: the subfield basis {1, g, ..., g^15} with
g = x^((2^128-1)/(2^16-1)), `solve`, `of_scalar`, the polynomial
evaluation points 0, 1, g, g^2, ..., and the 2-byte subfield encoding.

Tensor side: an element is its polynomial-basis bits in 4 little-endian
32-bit words, the last axis of an int32 tensor (`[..., 4]`, read as
uint32 by the kernels): the same shape as an Fp128 element, so the
kernels K1-K3 take it through their `[gf2_128]` instances
(csrc/gf2.cuh).  There is no Montgomery form: `from_mont` is the
identity, and the bytes of the words are the element's natural
little-endian bytes.  Sums are XOR.

Every tensor operation is a wrapper of fields/fp.py (K1 fp_elementwise,
K2 fp_segment_sum, K3 fp_wire_round, K21 fp_inv): for a CUDA tensor it
launches the `[gf2_128]` instance, for a CPU tensor it runs the plain
version below (`*_plain`, the same names as fields/fp.py's).  The plain
product works in int64 over 16-bit halfwords with the JAX package's
spaced-multiply carry-less product (gf2.py:290), over chunks of the
element axis, so a layer of millions of terms builds no multi-GB
temporaries.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .fp import (ADD, BIND, EQ, HV, IS_ZERO, MUL, NEG, SELECT, SQR, SUB,
                 FieldOps, _join16, _split16, compare_plain, fp_axis_sum,
                 fp_elementwise, fp_segment_sum,
                 layer_hv_plain)  # K23's plain version, for plain_of(F)

MASK16 = 0xFFFF
M128 = (1 << 128) - 1

# elements per chunk of the plain product ([chunk, 8, 8] int64 temporaries:
# 16 MB on the CPU; 512 MB on the card, where a chunk's 30-odd small ops
# cost launches rather than memory)
_CHUNK = {"cpu": 1 << 15, "cuda": 1 << 20}


def gf_mul_int(a: int, b: int) -> int:
    """The product of two host ints (128-bit polynomials): a carry-less
    product by 4-bit windows of b, then two folds of the bits above
    x^127 by x^128 = x^7 + x^2 + x + 1 (the JAX package's shift loop and
    bit-by-bit reduction give the same value, about 3.5 times slower)."""
    a2, a4, a8 = a << 1, a << 2, a << 3
    t = (0, a, a2, a2 ^ a, a4, a4 ^ a, a4 ^ a2, a4 ^ a2 ^ a, a8, a8 ^ a,
         a8 ^ a2, a8 ^ a2 ^ a, a8 ^ a4, a8 ^ a4 ^ a, a8 ^ a4 ^ a2,
         a8 ^ a4 ^ a2 ^ a)
    r = 0
    for s in range(124, -1, -4):
        r = (r << 4) ^ t[(b >> s) & 15]
    for _ in range(2):
        hi = r >> 128
        r = (r & M128) ^ hi ^ (hi << 1) ^ (hi << 2) ^ (hi << 7)
    return r


class GF2_128(FieldOps):
    """GF(2^128) with the GF(2^16) subfield: host int and tensor ops
    (FieldOps: sqr, neg, mul_const, inv, eq, is_zero, select, the
    natural bytes)."""

    kCharacteristicTwo = True
    kNPolyEvaluationPoints = 6
    kBits = 128
    kBytes = 16
    kSubFieldBits = 16
    kSubFieldBytes = 2

    def __init__(self):
        self.p = None  # not a prime field
        self.name = "GF2_128"
        self.tag = "gf2_128"  # the kernels' instance (kernels.py)
        self.nlimb = 4
        self.elt_shape = (4,)
        # subfield generator g = x^((2^128-1)/(2^16-1)) (gf2_128.h:369-391)
        r = 0b10
        for i in range(4, 7):
            s = r
            for _ in range(1 << i):
                s = gf_mul_int(s, s)
            r = gf_mul_int(r, s)
        self.g = r
        self.beta = [1]
        for _ in range(1, self.kSubFieldBits):
            self.beta.append(gf_mul_int(self.beta[-1], self.g))
        self._beta_ref()
        # evaluation points 0, 1, g, g^2, g^3, g^4 (gf2_128.h:122-127)
        self.poly_evaluation_points = [0, 1]
        while len(self.poly_evaluation_points) < self.kNPolyEvaluationPoints:
            self.poly_evaluation_points.append(
                gf_mul_int(self.poly_evaluation_points[-1], self.g))
        self._newton_denoms = {}
        for k in range(1, self.kNPolyEvaluationPoints):
            for i in range(1, k + 1):
                dx = (self.poly_evaluation_points[k]
                      ^ self.poly_evaluation_points[k - i])
                self._newton_denoms[(k, i)] = self.inv_i(dx)

    # ------------------------------------------------------------------
    # host ops
    # ------------------------------------------------------------------

    def add_i(self, a: int, b: int) -> int:
        return a ^ b

    sub_i = add_i

    def neg_i(self, a: int) -> int:
        return a

    def mul_i(self, a: int, b: int) -> int:
        return gf_mul_int(a, b)

    def inv_i(self, a: int) -> int:
        assert a != 0
        result, base = 1, gf_mul_int(a, a)  # a^(2^128 - 2)
        for _ in range(127):
            result = gf_mul_int(result, base)
            base = gf_mul_int(base, base)
        return result

    def of_scalar(self, u: int) -> int:
        """Subfield coordinates -> field element (gf2_128.h:151-160)."""
        t, k = 0, 0
        while u:
            if u & 1:
                t ^= self.beta[k]
            u >>= 1
            k += 1
            assert k <= self.kSubFieldBits, "of_scalar(u), too many bits"
        return t

    def _beta_ref(self):
        """Row-echelon form of the subfield basis (gf2_128.h:451-494)."""
        u = list(self.beta)
        linv = [1 << i for i in range(self.kSubFieldBits)]
        ldnz = [0] * self.kSubFieldBits
        rnk = 0
        for j in range(self.kBits):
            if rnk >= self.kSubFieldBits:
                break
            piv = next((i for i in range(rnk, self.kSubFieldBits)
                        if (u[i] >> j) & 1), None)
            if piv is None:
                continue
            u[rnk], u[piv] = u[piv], u[rnk]
            linv[rnk], linv[piv] = linv[piv], linv[rnk]
            ldnz[rnk] = j
            for i1 in range(rnk + 1, self.kSubFieldBits):
                if (u[i1] >> j) & 1:
                    u[i1] ^= u[rnk]
                    linv[i1] ^= linv[rnk]
            rnk += 1
        assert rnk == self.kSubFieldBits
        self._u, self._linv, self._ldnz = u, linv, ldnz

    def solve(self, e: int):
        """Inverse of of_scalar: (residual, coordinates)
        (gf2_128.h:496-508)."""
        u, ue = 0, e
        for rnk in range(self.kSubFieldBits):
            if (ue >> self._ldnz[rnk]) & 1:
                ue ^= self._u[rnk]
                u ^= self._linv[rnk]
        return ue, u

    def in_subfield(self, e: int) -> bool:
        return self.solve(e)[0] == 0

    def to_bytes(self, x: int) -> bytes:
        return int(x).to_bytes(self.kBytes, "little")

    def of_bytes(self, b: bytes) -> Optional[int]:
        assert len(b) == self.kBytes
        return int.from_bytes(b, "little")

    def to_bytes_subfield(self, x: int) -> bytes:
        residual, u = self.solve(x)
        assert residual == 0, "element not in subfield"
        return u.to_bytes(self.kSubFieldBytes, "little")

    def of_bytes_subfield(self, b: bytes) -> Optional[int]:
        assert len(b) == self.kSubFieldBytes
        return self.of_scalar(int.from_bytes(b, "little"))

    def sample(self, fill_bytes) -> int:
        return int.from_bytes(fill_bytes(self.kBytes), "little")

    def sample_subfield(self, fill_bytes) -> int:
        return self.of_scalar(
            int.from_bytes(fill_bytes(self.kSubFieldBytes), "little"))

    def poly_evaluation_point(self, i: int) -> int:
        return self.poly_evaluation_points[i]

    def newton_denominator(self, k: int, i: int) -> int:
        return self._newton_denoms[(k, i)]

    # ------------------------------------------------------------------
    # host <-> tensor
    # ------------------------------------------------------------------

    def to_limbs(self, xs: Union[int, Sequence[int]], device) -> torch.Tensor:
        """Ints -> int32 [4] (one int) or [n, 4] words on `device`."""
        one = isinstance(xs, (int, np.integer))
        vals = [int(xs)] if one else xs
        buf = b"".join(int(x).to_bytes(16, "little") for x in vals)
        arr = np.frombuffer(buf, dtype="<i4").reshape(len(vals), 4)
        t = torch.from_numpy(arr.copy()).to(device)
        return t[0] if one else t

    def from_limbs(self, t: torch.Tensor):
        """int32 [..., 4] -> an int ([4]) or a numpy object array of ints
        (shape t.shape[:-1])."""
        a = np.ascontiguousarray(t.detach().cpu().numpy().astype("<i4"))
        assert a.shape[-1] == 4
        raw = a.tobytes()
        vals = [int.from_bytes(raw[j : j + 16], "little")
                for j in range(0, len(raw), 16)]
        if a.ndim == 1:
            return vals[0]
        return np.array(vals, dtype=object).reshape(a.shape[:-1])

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(tuple(shape) + self.elt_shape, dtype=torch.int32,
                           device=device)

    # ------------------------------------------------------------------
    # tensor ops (int32 [..., 4])
    # ------------------------------------------------------------------

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp_elementwise(self, MUL, a, b)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp_elementwise(self, ADD, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp_elementwise(self, SUB, a, b)

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        """No Montgomery form in GF(2^128): the identity."""
        return a

    def bind(self, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """The bound half of x [..., n, 4]: pairs fold to lo + (hi - lo)
        * r, [..., n / 2, 4]; r [4], or [B, 4] for x [B, ..., n, 4]."""
        return fp_elementwise(self, BIND, x, r)

    def hv_update(self, hv: torch.Tensor, h: torch.Tensor,
                  r: torch.Tensor, s: int = 0) -> torch.Tensor:
        """hv[t] * ((h[t] >> s) odd ? r : 1 - r); r [4], or [B, 4] for
        hv [B, T, 4] with h [T] shared."""
        return fp_elementwise(self, HV, hv, r, h=h, shift=s)

    def lazy_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """XOR along element axis `dim` of x [..., 4]."""
        return fp_axis_sum(self, x, dim)

    def lazy_segment_sum(self, x: torch.Tensor, starts: torch.Tensor,
                         ends: torch.Tensor, longest=None) -> torch.Tensor:
        """x [T, 4] -> [S, 4]: out[s] = XOR of x[starts[s]:ends[s]]
        (`longest`: see fields/fp.py fp_segment_sum)."""
        return fp_segment_sum(self, x, starts, ends, longest)


@functools.lru_cache(maxsize=None)
def gf2_128() -> GF2_128:
    return GF2_128()


# ----------------------------------------------------------------------
# plain versions: int64 over 16-bit halfwords
# ----------------------------------------------------------------------

def _clmul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Carry-less 16 x 16 -> 31-bit products of halfwords (int64), by the
    spaced integer multiply: each operand split into the 4 classes of bit
    positions mod 4, so a column of an integer product gets at most 4
    one-bit addends, whose count stays inside the 4-bit gap; the count's
    low bit at each class position is the carry-less bit."""
    r = None
    for m in range(4):
        am = a & (0x1111 << m)
        for n in range(4):
            t = (am * (b & (0x1111 << n))) & \
                ((0x11111111 << ((m + n) & 3)) & 0xFFFFFFFF)
            r = t if r is None else r ^ t
    return r


def _fold16(T: torch.Tensor) -> torch.Tensor:
    """16 halfword columns [..., 16] of a 255-bit product -> the 8
    halfwords of its residue mod x^128 + x^7 + x^2 + x + 1."""
    low, high = T[..., :8], T[..., 8:16]
    acc = torch.zeros(T.shape[:-1] + (9,), dtype=torch.int64,
                      device=T.device)
    acc[..., :8] ^= high
    for sh in (1, 2, 7):
        acc[..., :8] ^= (high << sh) & MASK16
        acc[..., 1:] ^= high >> (16 - sh)
    out = low ^ acc[..., :8]
    spill = acc[..., 8]  # < 2^7
    out[..., 0] ^= spill ^ (spill << 1) ^ (spill << 2) ^ (spill << 7)
    return out


def _mul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Products of halfword elements a, b [n, 8] (int64)."""
    P = _clmul16(a[:, :, None], b[:, None, :])   # [n, 8, 8] < 2^31
    T = torch.zeros((a.shape[0], 17), dtype=torch.int64, device=a.device)
    for i in range(8):
        T[:, i : i + 8] ^= P[:, i] & MASK16
        T[:, i + 1 : i + 9] ^= P[:, i] >> 16
    return _fold16(T[:, :16])


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The GF(2^128) product of int32 [..., 4] tensors (broadcast), in
    chunks of the element axis."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    a2, b2 = a.reshape(-1, 4), b.reshape(-1, 4)
    out = torch.empty_like(a2)
    chunk = _CHUNK.get(a2.device.type, 1 << 15)
    for s in range(0, a2.shape[0], chunk):
        e = s + chunk
        out[s:e] = _join16(_mul16(_split16(a2[s:e]), _split16(b2[s:e])))
    return out.reshape(shape)


def sqr_plain(a: torch.Tensor) -> torch.Tensor:
    """The square of int32 [..., 4] elements: each halfword's bits spread
    to the even positions of 32 (squaring is linear over GF(2)), then the
    fold, as the JAX package's GF2_128.sqr (gf2.py:361)."""
    x = _split16(a)
    for sh, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                  (1, 0x55555555)):
        x = (x | (x << sh)) & m
    T = torch.stack([x & MASK16, x >> 16], dim=-1).reshape(
        x.shape[:-1] + (16,))
    return _join16(_fold16(T))


def inv_plain(F, a: torch.Tensor) -> torch.Tensor:
    """Plain version of K21 [gf2_128]: a^(2^128 - 2) = a^2 a^4 ...
    a^(2^127) (0 for 0)."""
    base = sqr_plain(a)
    r = base
    for _ in range(126):
        base = sqr_plain(base)
        r = mul_plain(r, base)
    return r


def _one_like(r: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(r)
    one[..., 0] = 1
    return one


def elementwise_plain(F, mode: int, a: torch.Tensor, b: torch.Tensor,
                      h: Optional[torch.Tensor] = None,
                      shift: int = 0) -> torch.Tensor:
    """Plain version of K1[gf2_128]; any device.  In bind and hv b holds
    one challenge per lane (lanes = b's elements), lane-major in a; hv
    reads h[t] >> shift; in select h holds the conditions (bool)."""
    if mode in (EQ, IS_ZERO, SELECT):
        return compare_plain(mode, a, b, h)
    if mode == SQR:
        return sqr_plain(a)
    if mode == NEG:
        return a.clone()
    if mode in (BIND, HV):
        nl = b.numel() // 4
        r = b.reshape(nl, 1, 4)
    if mode == BIND:
        row = a.shape[-2]
        a4 = a.reshape(nl, -1, row, 4)
        lo, hi = a4[..., 0::2, :], a4[..., 1::2, :]
        bound = lo ^ mul_plain(hi ^ lo, r[:, None])
        return bound.reshape(a.shape[:-2] + (row // 2, 4))
    if mode == HV:
        f = torch.where(((h.reshape(1, -1) >> shift) & 1).bool()[..., None],
                        r, r ^ _one_like(r))
        return mul_plain(a.reshape(nl, -1, 4), f).reshape(a.shape)
    if mode == MUL:
        return mul_plain(a, b)
    return torch.bitwise_xor(*torch.broadcast_tensors(a, b)).contiguous()


def _prefix_xor(x: torch.Tensor) -> torch.Tensor:
    """[T, 4] -> [T + 1, 4]: P[t] = x[0] ^ ... ^ x[t - 1] (a log-depth
    scan)."""
    y = torch.cat([x.new_zeros((1,) + tuple(x.shape[1:])), x])
    k = 1
    while k < y.shape[0]:
        y[k:] = y[k:] ^ y[:-k]
        k *= 2
    return y


def segment_sum_plain(F, x: torch.Tensor, starts: torch.Tensor,
                      ends: torch.Tensor) -> torch.Tensor:
    """Plain version of K2[gf2_128] mode 0: segment XOR by prefix XOR."""
    P = _prefix_xor(x)
    return P[ends.long()] ^ P[starts.long()]


def eval_layer_plain(F, W: torch.Tensor, h0: torch.Tensor, h1: torch.Tensor,
                     v: torch.Tensor, bmask: torch.Tensor,
                     starts: torch.Tensor, ends: torch.Tensor):
    """Plain version of K2[gf2_128] mode 1: (V, ok) with V[g] = XOR over
    g's terms of v * W[h1] * W[h0] (beta-masked terms excluded; ok says
    their products are all zero)."""
    prod = mul_plain(W[h1.long()], W[h0.long()])
    ok = ~((prod != 0).any(dim=-1) & bmask).any()
    terms = mul_plain(prod, v)
    terms = torch.where(bmask[:, None], torch.zeros_like(terms), terms)
    return segment_sum_plain(F, terms, starts, ends), ok


def axis_sum_plain(F, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Plain version of K3[gf2_128] mode 1: XOR along element axis
    `dim`, by halving."""
    dim = dim % (x.dim() - 1)
    y = x.movedim(dim, 0)
    if y.shape[0] == 0:
        return torch.zeros_like(y[0])
    while y.shape[0] > 1:
        if y.shape[0] % 2:
            y = torch.cat([y, torch.zeros_like(y[:1])])
        y = y[0::2] ^ y[1::2]
    return y[0].contiguous()


def wire_sums_plain(F, hv, Wh, Wo, h, ho, s: int = 0,
                    so: int = 0) -> torch.Tensor:
    """Plain version of K3[gf2_128] mode 0: [a0, a2] as a [2, 4] tensor
    (-1 = 1 in characteristic 2); [B, 2, 4] with a leading lane axis on
    hv, Wh and Wo.  The round's indices are h >> s and ho >> so."""
    h, ax = h.long() >> s, hv.dim() - 2
    z = mul_plain(hv, Wo.index_select(ax, ho.long() >> so))
    whi, wlo = Wh.index_select(ax, h | 1), Wh.index_select(ax, h & ~1)
    odd = (h & 1).bool()[:, None]
    t0 = mul_plain(z, wlo)
    a0 = axis_sum_plain(F, torch.where(odd, torch.zeros_like(t0), t0), ax)
    return torch.stack([a0, axis_sum_plain(F, mul_plain(z, whi ^ wlo), ax)],
                       dim=-2)
