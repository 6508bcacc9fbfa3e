"""Prime-field arithmetic: host ints and PyTorch tensors.

Host side (plain Python ints, natural form) is the JAX package's
`PrimeField` host API, copied.  Tensor side: an element is N
little-endian 32-bit limbs in the last axis of an int32 tensor
(`[..., N]`, read as uint32 by the kernels), N the fewest of 1, 2, 4, 8,
12 and 17 words that hold p (4 for p < 2^128, 8 below 2^256, 12 for
P-384, 17 for P-521), in Montgomery form with R = 2^(32N) and always
canonical (< p).  Up to 12 words R is the JAX package's R (2N 16-bit
limbs), so the two packages hold the same integers
(fields/bridge.py converts the layouts); at P-521 the JAX package's R is
2^528 (33 limbs) and the bridge converts the values.

Every tensor operation is a wrapper over one of the hand-written kernels
(K1 fp_elementwise, K2 fp_segment_sum, K3 fp_wire_round, K16
copy_round_sums, the sums of the plain sumcheck's copy rounds, K21
fp_inv, K23 layer_hv, the sumcheck's layer prologue, and K24 eq_table,
its EQ tables; see kernels.py).  For a CUDA tensor the wrapper launches its
kernel; for a CPU tensor it runs the kernel's plain PyTorch version,
which lives in this module too (`*_plain`) and computes in int64 over
16-bit limbs (CPU PyTorch has no uint32 `+`, `<<` or `>>`).  The kernels
have an instance for each field of `fp_instances.KERNEL_TAGS` (K1-K3
and K21 for all of them, K3's wire mode up to 8 words; K16, K23 and K24
for the sumcheck fields Fp128, P-256 and secp256k1) and one for GF(2^128) (fields/gf2.py, whose plain versions
the wrappers take for it); a CUDA tensor of another field raises.  The
plain versions here take any odd p below 2^544.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import kernels

MASK16 = 0xFFFF
# the element sizes in 32-bit words (csrc/fp.cuh's instances: 12 is
# P-384's, 17 P-521's)
WORDS = (1, 2, 4, 8, 12, 17)

# K1 modes (csrc/fp_ops.cu); K5 and K22 take the same numbers, and K22
# mode 10, the inverse; K1 mode 11, a hand-round's bind and hv update
# (fp_bind_hv)
MUL, ADD, SUB, BIND, HV, SQR, NEG, EQ, IS_ZERO, SELECT, INV, BIND_HV = \
    range(12)
# the element sizes (words) at which K1 runs bind_hv in one launch
BIND_HV_WORDS = (2, 4, 8, 12)
# modes of one operand; modes whose output is one bool an element
UNARY = (SQR, NEG, IS_ZERO, INV)
BOOL_OUT = (EQ, IS_ZERO)

# K3 grid: blocks per output, at most.  The prime wire mode
# (csrc/wire_round.cu k_wire) takes its wide body (products unreduced,
# reduced once a thread) from _K3_WIDE_MIN terms a launch,
# _K3_WIDE_TERMS terms a thread at least: the batch prover's 8 SHA-256
# lanes (8 x 72,534 terms) are the served launches past _K3_WIDE_MIN,
# and on an H100 they ran fastest at 4 terms a thread (PERF.md, PR 18)
_K3_MAX_BLOCKS = 264
_K3_WIDE_MIN = 1 << 19
_K3_WIDE_TERMS = 4
# K16 grid: blocks, at most; copy pairs per chunk of its plain version
# (bounds the plain products' int64 temporaries: about 0.5 GB for a
# P-256 product)
_K16_MAX_BLOCKS = 1024
_PLAIN_PAIRS = 1 << 18


class FieldOps:
    """The field API that K1's modes 5-9 and K21 serve, for PrimeField
    and GF2_128 (fields/gf2.py) alike: the JAX package's sqr, neg,
    mul_const, inv, batch_inverse, eq, is_zero, select and
    natural_limbs_to_bytes_dev (fields/fp.py:457-507, :202; fields/
    gf2.py:358-398, :260).  No proof path calls them."""

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return fp_elementwise(self, SQR, a, a)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        """-a (in GF(2^128) a, which K1 copies)."""
        return fp_elementwise(self, NEG, a, a)

    def mul_const(self, a: torch.Tensor, c: int) -> torch.Tensor:
        """a times the natural-form host constant c (K1's product by c's
        limbs)."""
        return fp_elementwise(self, MUL, a, self.to_limbs(c, a.device))

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """a^(p - 2) (GF(2^128): a^(2^128 - 2)): the inverse, 0 for 0
        (K21)."""
        return fp_inv(self, a)

    # the JAX package's batch_inverse is its inv (fields/fp.py:488)
    batch_inverse = inv

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a == b elementwise: bool [...]."""
        return fp_elementwise(self, EQ, a, b)

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return fp_elementwise(self, IS_ZERO, a, a)

    def select(self, cond: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        """cond ? a : b, cond a bool tensor over the element axes."""
        return fp_elementwise(self, SELECT, a, b, h=cond)

    def bind_hv(self, W: torch.Tensor, hv: torch.Tensor, h: torch.Tensor,
                r: torch.Tensor, s: int = 0):
        """A hand-round's two updates by its challenge r: (bind(W, r),
        hv_update(hv, h, r, s)), one K1 launch where K1 has the mode
        (fp_bind_hv)."""
        return fp_bind_hv(self, W, hv, h, r, s)

    def layer_hv(self, dot: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                 bmask: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        """The layer prologue, hv [B, T, N]: hv[b, j] = (bmask[j] ?
        beta[b] : v[j]) * dot[b, g[j]] for dot [B, nv, N], the terms'
        output wires g (int32 [T]), coefficients v [T, N] and beta flags
        bmask (bool [T]), and beta [B, N] (K23, fp_layer_hv)."""
        return fp_layer_hv(self, dot, g, v, bmask, beta)

    def eq_table(self, q: torch.Tensor, n: int,
                 alpha: Optional[torch.Tensor] = None,
                 q1: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The EQ table over the challenges q [logn, N] (or [B, logn, N],
        a table a lane; views with elements a multiple of N words apart):
        EQ(q, i) for 0 <= i < n, [n, N] (or [B, n, N]); with alpha [N] (or
        [B, N]) and q1 like q, EQ(q, i) + alpha EQ(q1, i) (K24,
        fp_eq_table)."""
        return fp_eq_table(self, q, n, alpha, q1)

    def natural_limbs_to_bytes_dev(self, x: torch.Tensor) -> torch.Tensor:
        """Natural-form limbs [..., N] -> their little-endian bytes, uint8
        [..., kBytes]: a view of the words, no arithmetic."""
        return natural_bytes(x, self.kBytes)


class PrimeField(FieldOps):
    """A prime field Fp, p < 2^544: host int ops and tensor ops."""

    kCharacteristicTwo = False
    kNPolyEvaluationPoints = 6

    def __init__(self, p: int, name: str, nbytes: Optional[int] = None):
        assert p % 2 == 1 and p < (1 << (32 * WORDS[-1]))
        self.p = p
        # 32-bit limbs per element (the tensor layout), 16-bit limbs (the
        # plain versions)
        self.nlimb = next(n for n in WORDS if p < (1 << (32 * n)))
        self.nl16 = 2 * self.nlimb
        self.elt_shape = (self.nlimb,)
        self.char = p
        self.name = name
        self.bits = p.bit_length()
        self.L = (self.bits + 15) // 16
        self.kBytes = nbytes if nbytes is not None else self.L * 2
        # Reference kSubFieldBytes == kBytes for prime fields
        # (fp_generic.h:47); there is no proper subfield.
        self.kSubFieldBytes = self.kBytes
        self.exact_bits = self.bits
        self.R = 1 << (32 * self.nlimb)
        self.Rinv = pow(self.R, -1, p)
        self.R2 = (self.R * self.R) % p
        self.mont_one_int = self.R % p
        # constants of the plain versions (16-bit limbs)
        self.n0inv16 = (-pow(p, -1, 1 << 16)) % (1 << 16)
        self._p16 = [(p >> (16 * i)) & MASK16 for i in range(self.nl16)]
        self._r2_16 = [(self.R2 >> (16 * i)) & MASK16
                       for i in range(self.nl16)]
        self._one16 = [(self.mont_one_int >> (16 * i)) & MASK16
                       for i in range(self.nl16)]
        # p < R / 2: a value below R may pass 2p (the ML-DSA prime, P-521)
        self.small = 2 * p < self.R
        # R^(k + 2) mod p for the base-R digits k of a sum's int64 carry
        # (_renorm16): one digit for N >= 2, two for N = 1
        self._rpow16 = [
            [(pow(self.R, k + 2, p) >> (16 * i)) & MASK16
             for i in range(self.nl16)]
            for k in range(-(-63 // (32 * self.nlimb)))]
        from .fp_instances import KERNEL_TAGS
        # the kernels' instance for this field ("fp128", "fp256"), or None
        self.tag = KERNEL_TAGS.get(p)

    # ------------------------------------------------------------------
    # host scalar (python int, natural form) ops
    # ------------------------------------------------------------------

    def add_i(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub_i(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul_i(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg_i(self, a: int) -> int:
        return (-a) % self.p

    def inv_i(self, a: int) -> int:
        return pow(a, -1, self.p)

    def of_scalar(self, a: int) -> int:
        assert 0 <= a < self.p, "of_scalar must be less than m"
        return a

    def poly_evaluation_point(self, i: int) -> int:
        # Reference: points are 0, 1, ..., 5 (fp_generic.h:114-115)
        assert i < self.kNPolyEvaluationPoints
        return i % self.p

    def newton_denominator(self, k: int, i: int) -> int:
        # (X[k] - X[k-i])^{-1} = 1/i for integer evaluation points
        return pow(i, -1, self.p)

    def to_bytes(self, x: int) -> bytes:
        return int(x).to_bytes(self.kBytes, "little")

    def of_bytes(self, b: bytes) -> Optional[int]:
        assert len(b) == self.kBytes
        v = int.from_bytes(b, "little")
        return v if v < self.p else None

    def of_bytes_subfield(self, b: bytes) -> Optional[int]:
        return self.of_bytes(b)

    def to_bytes_subfield(self, x: int) -> bytes:
        return self.to_bytes(x)

    def sample(self, fill_bytes) -> int:
        """Rejection sampling exactly as the reference (fp_generic.h:360)."""
        total_l = (self.exact_bits + 7) // 8
        mask = (1 << self.exact_bits) - 1
        while True:
            buf = fill_bytes(total_l)
            v = int.from_bytes(buf, "little") & mask
            if v < self.p:
                return v

    sample_subfield = sample

    def in_subfield(self, e: int) -> bool:
        return True

    # ------------------------------------------------------------------
    # host <-> tensor
    # ------------------------------------------------------------------

    def to_mont_int(self, x: int) -> int:
        return (x * self.R) % self.p

    def from_mont_int(self, x: int) -> int:
        return (x * self.Rinv) % self.p

    def to_limbs(self, xs: Union[int, Sequence[int]], device) -> torch.Tensor:
        """Natural-form ints -> int32 [N] (one int) or [n, N] Montgomery
        limbs on `device`."""
        one = isinstance(xs, (int, np.integer))
        vals = [int(xs)] if one else xs
        R, p, nb = self.R, self.p, 4 * self.nlimb
        buf = b"".join(((int(x) * R) % p).to_bytes(nb, "little")
                       for x in vals)
        arr = np.frombuffer(buf, dtype="<i4").reshape(len(vals), self.nlimb)
        t = torch.from_numpy(arr.copy()).to(device)
        return t[0] if one else t

    def from_limbs(self, t: torch.Tensor):
        """int32 [..., N] Montgomery limbs -> natural int ([N]) or a numpy
        object array of ints (shape t.shape[:-1])."""
        a = np.ascontiguousarray(t.detach().cpu().numpy().astype("<i4"))
        assert a.shape[-1] == self.nlimb
        raw = a.tobytes()
        Rinv, p, nb = self.Rinv, self.p, 4 * self.nlimb
        vals = [(int.from_bytes(raw[j : j + nb], "little") * Rinv) % p
                for j in range(0, len(raw), nb)]
        if a.ndim == 1:
            return vals[0]
        return np.array(vals, dtype=object).reshape(a.shape[:-1])

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(tuple(shape) + self.elt_shape, dtype=torch.int32,
                           device=device)

    # ------------------------------------------------------------------
    # tensor ops (int32 [..., N], Montgomery, canonical)
    # ------------------------------------------------------------------

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp_elementwise(self, MUL, a, b)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp_elementwise(self, ADD, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp_elementwise(self, SUB, a, b)

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery limbs -> limbs of the natural value (a * 1 * R^-1)."""
        one = torch.zeros(self.nlimb, dtype=torch.int32, device=a.device)
        one[0] = 1
        return fp_elementwise(self, MUL, a, one)

    def bind(self, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """The bound half of x [..., n, N] along the element axis: pairs
        fold to lo + (hi - lo) * r, [..., n / 2, N].  r is one element [N]
        or one per lane [B, N] (x [B, ..., n, N])."""
        return fp_elementwise(self, BIND, x, r)

    def hv_update(self, hv: torch.Tensor, h: torch.Tensor,
                  r: torch.Tensor, s: int = 0) -> torch.Tensor:
        """hv[t] * ((h[t] >> s) odd ? r : 1 - r); r [N], or [B, N] for hv
        [B, T, N] with h [T] shared by the lanes."""
        return fp_elementwise(self, HV, hv, r, h=h, shift=s)

    def lazy_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Field sum along element axis `dim` of x [..., N]."""
        return fp_axis_sum(self, x, dim)

    def lazy_segment_sum(self, x: torch.Tensor, starts: torch.Tensor,
                         ends: torch.Tensor, longest=None) -> torch.Tensor:
        """x [T, N] -> [S, N]: out[s] = sum of x[starts[s]:ends[s]]
        (`longest`: see fp_segment_sum)."""
        return fp_segment_sum(self, x, starts, ends, longest)


def round_consts(F, device) -> torch.Tensor:
    """The constants of K10 (random_oracle/device_fs.round_tail and its
    cubic mode round_tail_cubic) for field F (prime or GF(2^128)), int32
    [10, N] on `device` in the kernels' form, uploaded once per device: a
    round polynomial's evaluation points x0, x1, x2 (0, 1, 2 for a prime
    field; 0, 1, g for GF(2^128)) and its Newton denominators 1/(x1 - x0),
    1/(x2 - x1), 1/(x2 - x0), then the cubic mode's fourth point x3 (3; g^2)
    and 1/(x3 - x2), 1/(x3 - x1), 1/(x3 - x0), from the host field's
    poly_evaluation_point and newton_denominator (the JAX package's
    _pts_dev and _newton_denoms_dev, prover_device.py:44-58).  The rest
    of what K9 and K10 need of a field, p, R^2, exact_bits and kBytes, is
    compiled into each instance (csrc/fp.cuh, csrc/fs.cuh)."""
    cache = F.__dict__.setdefault("_round_consts", {})
    key = str(device)
    if key not in cache:
        pt, nd = F.poly_evaluation_point, F.newton_denominator
        cache[key] = F.to_limbs(
            [pt(0), pt(1), pt(2), nd(1, 1), nd(2, 1), nd(2, 2),
             pt(3), nd(3, 1), nd(3, 2), nd(3, 3)], device)
    return cache[key]


# ----------------------------------------------------------------------
# plain versions: int64 over 16-bit limbs
# ----------------------------------------------------------------------

def _split16(x: torch.Tensor) -> torch.Tensor:
    """int32 [..., N] -> int64 [..., 2N] 16-bit limbs."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & MASK16, v >> 16], dim=-1).reshape(
        x.shape[:-1] + (2 * x.shape[-1],))


def _join16(l16: torch.Tensor) -> torch.Tensor:
    """int64 [..., 2N] 16-bit limbs -> int32 [..., N]."""
    pairs = l16.reshape(l16.shape[:-1] + (l16.shape[-1] // 2, 2))
    v = pairs[..., 0] | (pairs[..., 1] << 16)
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _const16(vals, ref: torch.Tensor) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.int64, device=ref.device)


def _carry16(T: torch.Tensor):
    """Nonnegative columns [..., n] -> (16-bit limbs [..., n], carry)."""
    c = torch.zeros_like(T[..., 0])
    out = []
    for i in range(T.shape[-1]):
        cur = T[..., i] + c
        out.append(cur & MASK16)
        c = cur >> 16
    return torch.stack(out, dim=-1), c


def _cond_sub16(F: PrimeField, t: torch.Tensor, top: torch.Tensor):
    """top * R + t (< 2p, t in 16-bit limbs) -> canonical limbs."""
    d = t - _const16(F._p16, t)
    borrow = torch.zeros_like(t[..., 0])
    out = []
    for i in range(F.nl16):
        di = d[..., i] - borrow
        borrow = (di < 0).to(torch.int64)
        out.append(di + (borrow << 16))
    ge = (top != 0) | (borrow == 0)
    return torch.where(ge[..., None], torch.stack(out, dim=-1), t)


def _mont_mul16(F: PrimeField, a: torch.Tensor, b: torch.Tensor):
    """Montgomery a * b * R^-1 over 16-bit limbs (a < R, b < p)."""
    n = F.nl16
    p16 = _const16(F._p16, a)
    prod = a[..., :, None] * b[..., None, :]          # [..., n, n] < 2^32
    T = torch.zeros(prod.shape[:-2] + (2 * n + 1,), dtype=torch.int64,
                    device=a.device)
    for i in range(n):
        T[..., i : i + n] += prod[..., i, :]          # columns < 2^37
    for i in range(n):
        m = ((T[..., i] & MASK16) * F.n0inv16) & MASK16
        T[..., i : i + n] += m[..., None] * p16
        T[..., i + 1] += T[..., i] >> 16              # T[i] = 0 mod 2^16
    limbs, c = _carry16(T[..., n : 2 * n])
    return _cond_sub16(F, limbs, T[..., 2 * n] + c)


def _add16(F: PrimeField, a: torch.Tensor, b: torch.Tensor):
    limbs, c = _carry16(a + b)
    return _cond_sub16(F, limbs, c)


def _sub16(F: PrimeField, a: torch.Tensor, b: torch.Tensor):
    d = a - b
    borrow = torch.zeros_like(d[..., 0])
    out = []
    for i in range(F.nl16):
        di = d[..., i] - borrow
        borrow = (di < 0).to(torch.int64)
        out.append(di + (borrow << 16))
    d = torch.stack(out, dim=-1)
    limbs, _ = _carry16(d + borrow[..., None] * _const16(F._p16, d))
    return limbs


def _renorm16(F: PrimeField, cols: torch.Tensor) -> torch.Tensor:
    """Columns [..., 2N] (value = sum cols[k] 2^(16k), each < 2^62) -> the
    canonical value mod p (16-bit limbs)."""
    limbs, top = _carry16(cols)
    if F.small:
        # limbs < R may pass 2p: limbs * (R mod p) * R^-1 = limbs mod p
        low = _mont_mul16(F, limbs, _const16(F._one16, cols).expand_as(
            limbs))
    else:
        low = _cond_sub16(F, limbs, torch.zeros_like(top))
    # the carry (an int64) stands for top * R: its base-R digits d_k,
    # each Montgomery-multiplied by R^(k + 2), give d_k R^(k + 1)
    for k, rk in enumerate(F._rpow16):
        dk = top >> (32 * F.nlimb * k)
        d16 = torch.stack([(dk >> (16 * i)) & MASK16
                           if 32 * F.nlimb * k + 16 * i < 63
                           else torch.zeros_like(top)
                           for i in range(F.nl16)], dim=-1)
        low = _add16(F, low, _mont_mul16(
            F, d16, _const16(rk, cols).expand_as(d16)))
    return low


def compare_plain(mode: int, a: torch.Tensor, b: torch.Tensor,
                  cond: Optional[torch.Tensor], nelt: int = 1):
    """The plain eq, is_zero and select of any field whose elements are
    the last `nelt` axes (canonical limbs, so equal values are equal
    limbs): bool [...] for eq and is_zero, cond ? a : b for select."""
    if mode == SELECT:
        return torch.where(cond.reshape(cond.shape + (1,) * nelt), a, b)
    d = (a == b) if mode == EQ else (a == 0)
    return d.flatten(d.dim() - nelt).all(dim=-1)


def elementwise_plain(F: PrimeField, mode: int, a: torch.Tensor,
                      b: torch.Tensor, h: Optional[torch.Tensor] = None,
                      shift: int = 0):
    """Plain version of K1 (fp_elementwise); any device.  In bind and hv
    b holds one challenge per lane (lanes = b's elements), lane-major in
    a; hv reads h[t] >> shift; in select h holds the conditions
    (bool)."""
    if mode in (EQ, IS_ZERO, SELECT):
        return compare_plain(mode, a, b, h)
    if mode == SQR:
        a16 = _split16(a)
        return _join16(_mont_mul16(F, a16, a16))
    if mode == NEG:
        a16 = _split16(a)
        return _join16(_sub16(F, torch.zeros_like(a16), a16))
    if mode in (BIND, HV):
        nl = b.numel() // F.nlimb
        r = _split16(b).reshape(nl, 1, F.nl16)
    if mode == BIND:
        row = a.shape[-2]
        a16 = _split16(a).reshape(nl, -1, row, F.nl16)
        lo, hi = a16[..., 0::2, :], a16[..., 1::2, :]
        bound = _add16(F, lo, _mont_mul16(F, _sub16(F, hi, lo),
                                          r[:, None].expand_as(lo)))
        return _join16(bound).reshape(a.shape[:-2] + (row // 2, F.nlimb))
    if mode == HV:
        one = _const16(F._one16, r)
        f = torch.where(((h.reshape(1, -1) >> shift) & 1).bool()[..., None],
                        r, _sub16(F, one, r))
        a16 = _split16(a).reshape(nl, -1, F.nl16)
        return _join16(_mont_mul16(F, a16, f.expand_as(a16))).reshape(
            a.shape)
    a16, b16 = torch.broadcast_tensors(_split16(a), _split16(b))
    fn = {MUL: _mont_mul16, ADD: _add16, SUB: _sub16}[mode]
    return _join16(fn(F, a16, b16))


def inv_plain(F: PrimeField, a: torch.Tensor) -> torch.Tensor:
    """Plain version of K21 (fp_inv): a^(p - 2) (0 for 0), left to right
    over the 4-bit digits of p - 2 with the powers a^0 .. a^15 at hand (a
    third fewer products than bit by bit, as the kernel and the JAX
    package's scan go; the inverse is unique, so the integers agree)."""
    a16 = _split16(a)
    pw = [_const16(F._one16, a16).expand_as(a16), a16]
    for _ in range(14):
        pw.append(_mont_mul16(F, pw[-1], a16))
    e = F.p - 2
    shift = 4 * ((e.bit_length() - 1) // 4)
    r = pw[(e >> shift) & 15]
    while shift:
        shift -= 4
        for _ in range(4):
            r = _mont_mul16(F, r, r)
        d = (e >> shift) & 15
        if d:
            r = _mont_mul16(F, r, pw[d])
    return _join16(r)


def natural_bytes(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Natural-form words [..., N] -> uint8 [..., nbytes], their first
    nbytes little-endian bytes: a view (the JAX package's
    natural_limbs_to_bytes_dev, fields/fp.py:202, and what
    ligero/prover.py's commit hashes)."""
    return x.contiguous().view(torch.uint8)[..., :nbytes]


def segment_sum_plain(F: PrimeField, x: torch.Tensor, starts: torch.Tensor,
                      ends: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 mode 0: prefix sums of the limb columns."""
    x16 = _split16(x)
    cs = torch.cat([x16.new_zeros((1,) + tuple(x16.shape[1:])),
                    torch.cumsum(x16, dim=0)])
    return _join16(_renorm16(F, cs[ends.long()] - cs[starts.long()]))


def eval_layer_plain(F: PrimeField, W: torch.Tensor, h0: torch.Tensor,
                     h1: torch.Tensor, v: torch.Tensor, bmask: torch.Tensor,
                     starts: torch.Tensor, ends: torch.Tensor):
    """Plain version of K2 mode 1: (V, ok) with V[g] = sum over g's terms
    of v * W[h1] * W[h0] (beta-masked terms excluded; ok says their
    products are all zero)."""
    prod = elementwise_plain(F, MUL, W[h1.long()], W[h0.long()])
    ok = ~((prod != 0).any(dim=-1) & bmask).any()
    terms = elementwise_plain(F, MUL, prod, v)
    terms = torch.where(bmask[:, None], torch.zeros_like(terms), terms)
    return segment_sum_plain(F, terms, starts, ends), ok


def axis_sum_plain(F: PrimeField, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Plain version of K3 mode 1: field sum along element axis `dim`."""
    dim = dim % (x.dim() - 1)
    return _join16(_renorm16(F, _split16(x).sum(dim=dim)))


def wire_sums_plain(F: PrimeField, hv, Wh, Wo, h, ho, s: int = 0,
                    so: int = 0) -> torch.Tensor:
    """Plain version of K3 mode 0: [a0, a2] as a [2, N] tensor; [B, 2,
    N] with a leading lane axis on hv, Wh and Wo.  The round's indices
    are h >> s and ho >> so."""
    h, ax = h.long() >> s, hv.dim() - 2
    z = elementwise_plain(F, MUL, hv, Wo.index_select(ax, ho.long() >> so))
    whi, wlo = Wh.index_select(ax, h | 1), Wh.index_select(ax, h & ~1)
    odd = (h & 1).bool()[:, None]
    t0 = elementwise_plain(F, MUL, z, wlo)
    a0 = axis_sum_plain(F, torch.where(odd, torch.zeros_like(t0), t0), ax)
    zd = elementwise_plain(F, MUL, z, elementwise_plain(F, SUB, whi, wlo))
    zds = torch.where(odd, zd, elementwise_plain(F, SUB,
                                                 torch.zeros_like(zd), zd))
    return torch.stack([a0, axis_sum_plain(F, zds, ax)], dim=-2)


def copy_round_sums_plain(F, EQ: torch.Tensor, W: torch.Tensor,
                          h0: torch.Tensor, h1: torch.Tensor,
                          hv: torch.Tensor) -> torch.Tensor:
    """Plain version of K16 (csrc/copy_round.cu), for any sumcheck field
    (the products and sums of plain_of(F)): (c0, c2, c3) as a [3, N]
    tensor, from EQ [C, N], W [nw, C, N] (copies inner), h0, h1 [T] and
    hv [T, N], C even; the JAX package's SumcheckProver._evaluations_c
    (sumcheck/prover.py:272) over the gathered rows, in chunks of terms."""
    pm = plain_of(F)

    def mul(a, b):
        return pm.elementwise_plain(F, MUL, a, b)

    def sub(a, b):
        return pm.elementwise_plain(F, SUB, a, b)

    eq0, eq1 = EQ[0::2], EQ[1::2]
    deq = sub(eq1, eq0)
    step = max(1, _PLAIN_PAIRS // eq0.shape[0])
    parts = [[F.zeros((), EQ.device)] for _ in range(3)]
    for s in range(0, h0.shape[0], step):
        wr, wl = W[h0[s : s + step].long()], W[h1[s : s + step].long()]
        wr0, wr1, wl0, wl1 = wr[:, 0::2], wr[:, 1::2], wl[:, 0::2], wl[:, 1::2]
        d0 = mul(eq0, wr0)
        d2 = mul(deq, sub(wr1, wr0))
        d1 = sub(sub(mul(eq1, wr1), d0), d2)
        c1m = sub(wl1, wl0)
        ls = (mul(d0, wl0),
              pm.elementwise_plain(F, ADD, mul(d1, c1m), mul(d2, wl0)),
              mul(d2, c1m))
        for k, lk in enumerate(ls):
            per_term = pm.axis_sum_plain(F, lk, 1)
            parts[k].append(pm.axis_sum_plain(
                F, mul(per_term, hv[s : s + step]), 0))
    return torch.stack([pm.axis_sum_plain(F, torch.stack(p), 0)
                        for p in parts])


def layer_hv_plain(F, dot: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                   bmask: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Plain version of K23 (csrc/layer_hv.cu), for any sumcheck field
    (the product of plain_of(F)): the gather of dot [B, nv, N] by g, the
    select of beta [B, N] or v [T, N] by bmask, their product [B, T,
    N]."""
    vq = torch.where(bmask[None, :, None], beta[:, None],
                     v[None].expand((beta.shape[0],) + tuple(v.shape)))
    return plain_of(F).elementwise_plain(F, MUL, vq,
                                         dot.index_select(1, g.long()))


def eq_table_plain(F, q: torch.Tensor, n: int,
                   alpha: Optional[torch.Tensor] = None,
                   q1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K24 (csrc/eq_table.cu), for any sumcheck field:
    the JAX package's _eq_dev and _raw_eq2_dev (sumcheck/prover_device.py:
    107, :124), logn interleave steps on the products of plain_of(F) (a
    product, a difference and a stack each; the last pairs the lowest bit
    of i with q_0), the table cut to n entries."""
    ew = plain_of(F).elementwise_plain

    def table(q):
        lead, logn, N = tuple(q.shape[:-2]), q.shape[-2], F.nlimb
        eq = F.to_limbs(1, q.device).expand(lead + (1, N))
        sizes = [n]
        for _ in range(logn):
            sizes.append((sizes[-1] + 1) // 2)
        for l in range(logn - 1, -1, -1):
            hi = ew(F, MUL, eq, q[..., l : l + 1, :])
            lo = ew(F, SUB, eq, hi)
            eq = torch.stack([lo, hi], dim=-2).reshape(lead + (-1, N))
            eq = eq[..., : sizes[l], :]
        return eq[..., :n, :].contiguous()

    e0 = table(q)
    if alpha is None:
        return e0
    return ew(F, ADD, e0, ew(F, MUL, table(q1), alpha.unsqueeze(-2)))


# ----------------------------------------------------------------------
# wrappers: the kernel for a CUDA tensor, the plain version for a CPU one
# ----------------------------------------------------------------------

def plain_of(F):
    """The module of F's plain versions: this one for a prime field,
    fields/gf2.py for GF(2^128) (same function names)."""
    if F.kCharacteristicTwo:
        from . import gf2
        return gf2
    return sys.modules[__name__]


def route(kernel: str, F, *ts) -> Optional[str]:
    """None if the tensors lie on the CPU (then the plain version runs);
    the name of `kernel`'s instance for F's tag if they lie on the card.
    Raises for mixed devices and for a field without that instance."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("tensors on different devices: %s, %s"
                             % (dev, t.device))
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    name = "%s[%s]" % (kernel, F.tag)
    if name not in kernels.KERNELS:
        raise NotImplementedError(
            "%s has no CUDA instance for %s" % (kernel, F.name))
    return name


def check_elts(t: torch.Tensor, name: str, elt_shape) -> None:
    """Raises unless t is a contiguous int32 [..., *elt_shape] tensor."""
    k = len(elt_shape)
    if t.dtype != torch.int32 or tuple(t.shape[t.dim() - k:]) != \
            tuple(elt_shape) or not t.is_contiguous():
        raise ValueError("%s must be a contiguous int32 [..., %s] tensor, "
                         "got %s %s" % (name, ", ".join(map(str, elt_shape)),
                                        t.dtype, tuple(t.shape)))


def _bcast_divmod(bshape, shape):
    """(bdiv, bmod) with b's element at flat index (i // bdiv) % bmod of
    the broadcast `shape`, or None if b's broadcast is not of that form."""
    bshape = (1,) * (len(shape) - len(bshape)) + tuple(bshape)
    dims = [i for i, (bs, s) in enumerate(zip(bshape, shape)) if bs != 1]
    if not dims:
        return 1, 1
    lo, hi = dims[0], dims[-1]
    if any(bshape[i] != shape[i] for i in range(lo, hi + 1)):
        return None
    return int(np.prod(shape[hi + 1 :])), int(np.prod(shape[lo : hi + 1]))


def broadcast_operands(a: torch.Tensor, b: torch.Tensor, a_elt, b_elt,
                       swap: bool):
    """(a, b, bdiv, bmod) for a kernel that reads b[(i // bdiv) % bmod]
    beside a[i]: a (elements of shape a_elt) is the operand of the full
    broadcast shape, made contiguous; with swap (a_elt == b_elt), a and b
    trade places when b is the full one.  b (elements of shape b_elt) is
    materialised only where its broadcast is not of that form."""
    ea, eb = a.shape[: a.dim() - len(a_elt)], b.shape[: b.dim() - len(b_elt)]
    shape = tuple(torch.broadcast_shapes(ea, eb))
    if swap and tuple(ea) != shape:
        a, b, eb = b, a, ea
    if tuple(a.shape[: a.dim() - len(a_elt)]) != shape or \
            not a.is_contiguous():
        a = a.expand(shape + tuple(a_elt)).contiguous()
    dm = _bcast_divmod(eb, shape)
    if dm is None:
        b = b.expand(shape + tuple(b_elt))
        dm = (1, int(np.prod(shape)))
    b = b.contiguous()
    check_elts(a, "a", a_elt)
    check_elts(b, "b", b_elt)
    return a, b, dm[0], dm[1]


def _lane_challenges(F, r: torch.Tensor):
    """(lanes, stride): r is one element [N] (one lane) or one per lane
    [B, N], each lane's element contiguous and the lanes `stride` elements
    apart (a view into a larger tensor, such as the sumcheck's rows)."""
    N = F.nlimb
    if r.dtype != torch.int32 or r.shape[-1] != N or r.dim() > 2 or \
            r.stride(-1) != 1:
        raise ValueError("the challenges must be int32 [N] or [B, N] with "
                         "contiguous elements, got %s" % (tuple(r.shape),))
    if r.dim() == 1:
        return 1, 0
    if r.stride(0) % N:
        raise ValueError("the challenges' lane stride must be a multiple "
                         "of N")
    return r.shape[0], r.stride(0) // N


def elementwise_operands(mode: int, a: torch.Tensor, b: torch.Tensor,
                         cond: Optional[torch.Tensor], elt):
    """(out, a, b, cond, n, bdiv, bmod) for an elementwise kernel of
    elements of shape `elt` (K1, K5, K22) in a mode other than bind and
    hv: a contiguous at the broadcast shape of the element axes, b read
    at (i // bdiv) % bmod, cond (select) bool at that shape, out empty
    (bool for eq and is_zero).  A unary mode reads a only (b is a)."""
    k = len(elt)
    if mode in UNARY:
        a = a.contiguous()
        check_elts(a, "a", elt)
        b, bdiv, bmod = a, 1, 1
    elif mode == SELECT:
        if cond is None or cond.dtype != torch.bool:
            raise ValueError("select needs bool conditions")
        shape = tuple(torch.broadcast_shapes(
            cond.shape, a.shape[: a.dim() - k], b.shape[: b.dim() - k]))
        a, b, bdiv, bmod = broadcast_operands(
            a.expand(shape + tuple(elt)), b, elt, elt, False)
        cond = cond.expand(shape).contiguous()
    else:
        a, b, bdiv, bmod = broadcast_operands(a, b, elt, elt, mode != SUB)
    if mode != SELECT:
        cond = None
    n = a.numel() // int(np.prod(elt))
    if mode in BOOL_OUT:
        out = torch.empty(a.shape[: a.dim() - k], dtype=torch.bool,
                          device=a.device)
    else:
        out = torch.empty_like(a)
    return out, a, b, cond, n, bdiv, bmod


def fp_elementwise(F: PrimeField, mode: int, a: torch.Tensor, b: torch.Tensor,
                   h: Optional[torch.Tensor] = None,
                   shift: int = 0) -> torch.Tensor:
    """K1 wrapper.  mul/add/sub/eq broadcast a and b over the element
    axes; sqr, neg and is_zero read a alone; select takes its bool
    conditions as h and broadcasts them with a and b.  bind and hv take
    the challenge r as b: one element [N], or one per lane [B, N], lane b
    of a being its b-th B-th part (a [B, ..., N]); hv's indices h are
    shared by the lanes and read as h >> shift (the round's shift, 0-31);
    bind returns the bound half."""
    if mode not in range(SELECT + 1):
        raise ValueError("K1 has no mode %d" % mode)
    name = route("fp_elementwise", F,
                 *[t for t in (a, b, h) if t is not None])
    if name is None:
        return plain_of(F).elementwise_plain(F, mode, a, b, h, shift)
    if mode in (BIND, HV):
        lanes, rstride = _lane_challenges(F, b)
        if mode == BIND:
            out, row = _bind_out(F, a, lanes), a.shape[-2]
            hp = 0
        else:
            out, row = _hv_out(F, a, h, lanes), 1
            hp = h.data_ptr()
        n = out.numel() // F.nlimb
        kernels.launch(name, 1, mode, out.data_ptr(), a.data_ptr(),
                       b.data_ptr(), hp, n, row, n // lanes, rstride, 0, 0, 0,
                       _shift(shift))
        return out
    # the full operand goes first (sub and select do not commute)
    out, a, b, cond, n, bdiv, bmod = elementwise_operands(
        mode, a, b, h, F.elt_shape)
    kernels.launch(name, 1, mode, out.data_ptr(), a.data_ptr(), b.data_ptr(),
                   0 if cond is None else cond.data_ptr(), n, 1, bdiv, bmod,
                   0, 0, 0, 0)
    return out


def _shift(s: int) -> int:
    """A round's shift of the hand indices (checked: 0-31)."""
    if not 0 <= s <= 31:
        raise ValueError("a shift of the indices must lie in 0-31, got %r"
                         % (s,))
    return int(s)


def _bind_out(F, a: torch.Tensor, lanes: int) -> torch.Tensor:
    """bind's output for a [..., row, N] in `lanes` lanes (checked)."""
    check_elts(a, "a", F.elt_shape)
    if (a.numel() // F.nlimb) % lanes:
        raise ValueError("a's %d elements do not split into %d lanes"
                         % (a.numel() // F.nlimb, lanes))
    row = a.shape[-2]
    if row % 2:
        raise ValueError("bind needs an even length, got %d" % row)
    return torch.empty(a.shape[:-2] + (row // 2,) + F.elt_shape,
                       dtype=torch.int32, device=a.device)


def _hv_out(F, a: torch.Tensor, h, lanes: int) -> torch.Tensor:
    """hv's output for a [..., N] in `lanes` lanes sharing the indices h
    (checked)."""
    check_elts(a, "a", F.elt_shape)
    na = a.numel() // F.nlimb
    if na % lanes:
        raise ValueError("a's %d elements do not split into %d lanes"
                         % (na, lanes))
    if h is None or h.dtype != torch.int32 or h.numel() != na // lanes or \
            not h.is_contiguous() or h.device != a.device:
        raise ValueError("hv needs int32 indices h of a lane's length")
    return torch.empty_like(a)


def fp_bind_hv(F, W: torch.Tensor, hv: torch.Tensor, h: torch.Tensor,
               r: torch.Tensor, s: int = 0):
    """K1 wrapper, a hand-round's two updates by its challenge r (one
    element [N], or one a lane [B, N]): (bind(W, r), hv_update(hv, h, r,
    s)), W [..., row, N] and hv [..., T, N] lane-major as in
    fp_elementwise, h read as h >> s.  One launch (mode BIND_HV) at the
    2-12-word prime instances; at the others (GF(2^128), the one- and
    17-word primes) the launches of bind and hv.  The plain version
    composes the plain bind and hv."""
    name = route("fp_elementwise", F, W, hv, h, r)
    if name is None:
        pm = plain_of(F)
        return (pm.elementwise_plain(F, BIND, W, r),
                pm.elementwise_plain(F, HV, hv, r, h, s))
    if F.kCharacteristicTwo or F.nlimb not in BIND_HV_WORDS:
        return (fp_elementwise(F, BIND, W, r),
                fp_elementwise(F, HV, hv, r, h=h, shift=s))
    lanes, rstride = _lane_challenges(F, r)
    outw, outh = _bind_out(F, W, lanes), _hv_out(F, hv, h, lanes)
    n, n2 = outw.numel() // F.nlimb, outh.numel() // F.nlimb
    kernels.launch(name, 1, BIND_HV, outw.data_ptr(), W.data_ptr(),
                   r.data_ptr(), h.data_ptr(), n, W.shape[-2], n // lanes,
                   rstride, outh.data_ptr(), hv.data_ptr(), n2, _shift(s))
    return outw, outh


def fp_inv(F, a: torch.Tensor, plain=None) -> torch.Tensor:
    """K21 wrapper: the inverse of each element of a (0 for 0), for a
    prime field, GF(2^128) or Fp2 (`plain`: its plain version, by default
    plain_of(F).inv_plain)."""
    name = route("fp_inv", F, a)
    if name is None:
        return (plain or plain_of(F).inv_plain)(F, a)
    a = a.contiguous()
    check_elts(a, "a", F.elt_shape)
    out = torch.empty_like(a)
    kernels.launch(name, 1, out.data_ptr(), a.data_ptr(),
                   a.numel() // int(np.prod(F.elt_shape)))
    return out


# about the threads an H100 holds (132 SMs x 2,048): K2's scan gives a
# thread n / K2_THREADS terms, so that a small table still fills the card
K2_THREADS = 1 << 18
# K2's warp a segment where one lane's mode-1 table is smaller than this,
# or a mode-0 caller knows no segment longer than K2_WARP_LONGEST
K2_TERMS_MIN = 1 << 16
K2_WARP_LONGEST = 4096


def _k2_route(n: int, nseg: int, scan: bool):
    """(k, launches) of a K2 call over n terms and nseg segments: k = 0,
    a warp a segment (one launch), or the terms a thread of its scan
    (k_seg_scan where there are terms, then k_seg_gather;
    csrc/segsum.cu); no launch for no segment."""
    if not scan:
        return 0, 1 if nseg else 0
    k = min(kernels.k2_chunks()[0], max(1, n // K2_THREADS))
    return k, (1 + (n > 0)) if nseg else 0


def _segsum_scratch(F, mode: int, n: int, k: int, device) -> torch.Tensor:
    """K2's scratch for n terms, k a thread (k = 0: none): the chunk and
    block prefixes of N words, 4 bytes each for GF(2^128) and 8 for a
    prime field, the scan's block counter, then mode 1's terms 16-byte
    aligned (csrc/segsum.cu fp_segment_sum).  A call's own scratch, on
    its own stream, so that scans on several streams do not share a
    counter."""
    if k == 0:
        return torch.empty(0, dtype=torch.int64, device=device)
    nt = kernels.k2_chunks()[1]
    nchunk = -(-n // k)
    nblk = -(-nchunk // nt)
    word = 4 if F.kCharacteristicTwo else 8
    nbytes = word * F.nlimb * (nchunk + 2 * nblk) + 32 + \
        (4 * F.nlimb * n if mode else 0)
    return torch.empty(-(-nbytes // 8), dtype=torch.int64, device=device)


def _i32(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError("%s must be a contiguous int32 tensor" % name)


def fp_segment_sum(F: PrimeField, x: torch.Tensor, starts: torch.Tensor,
                   ends: torch.Tensor, longest=None) -> torch.Tensor:
    """K2 wrapper, mode 0: out[s] = sum of x[starts[s]:ends[s]].  `longest`
    (an int the caller knows, or None): no segment is longer; past
    K2_WARP_LONGEST the kernel's scan takes the table, else a warp a
    segment."""
    name = route("fp_segment_sum", F, x, starts, ends)
    if name is None:
        return plain_of(F).segment_sum_plain(F, x, starts, ends)
    check_elts(x, "x", F.elt_shape)
    _i32(starts, "starts")
    _i32(ends, "ends")
    nseg = starts.numel()
    n = x.numel() // F.nlimb
    out = torch.empty((nseg, F.nlimb), dtype=torch.int32, device=x.device)
    k, nl = _k2_route(n, nseg, longest is not None and
                      longest > K2_WARP_LONGEST)
    scratch = _segsum_scratch(F, 0, n, k, x.device)
    kernels.launch(name, nl, 0, out.data_ptr(), 0, x.data_ptr(), 0, 0, 0,
                   0, 0, starts.data_ptr(), ends.data_ptr(), nseg, n, k,
                   scratch.data_ptr())
    return out


def fp_eval_layer(F: PrimeField, W: torch.Tensor, h0: torch.Tensor,
                  h1: torch.Tensor, v: torch.Tensor, bmask: torch.Tensor,
                  starts: torch.Tensor, ends: torch.Tensor, lanes: int = 1):
    """K2 wrapper, mode 1: (V [S, N], ok) for one circuit layer; ok is a
    0-dim bool tensor on W's device (no host sync).  `lanes`: the terms
    are those of so many lanes of one layer (sumcheck/prover.py
    _lane_terms), and the route is one lane's, so that a batch launches
    what one proof launches."""
    name = route("fp_segment_sum", F, W, h0, h1, v, bmask, starts, ends)
    if name is None:
        return plain_of(F).eval_layer_plain(F, W, h0, h1, v, bmask, starts,
                                          ends)
    for t, tname in ((W, "W"), (v, "v")):
        check_elts(t, tname, F.elt_shape)
    for t, tname in ((h0, "h0"), (h1, "h1"), (starts, "starts"),
                     (ends, "ends")):
        _i32(t, tname)
    if bmask.dtype != torch.bool or not bmask.is_contiguous():
        raise ValueError("bmask must be a contiguous bool tensor")
    nseg = starts.numel()
    n = h0.numel()
    if h1.numel() != n or v.numel() != n * F.nlimb or bmask.numel() != n:
        raise ValueError("h0, h1, v and bmask must hold one entry a term")
    out = torch.empty((nseg, F.nlimb), dtype=torch.int32, device=W.device)
    bad = torch.zeros(1, dtype=torch.int32, device=W.device)
    k, nl = _k2_route(n, nseg, n // lanes >= K2_TERMS_MIN)
    scratch = _segsum_scratch(F, 1, n, k, W.device)
    kernels.launch(name, nl, 1, out.data_ptr(), bad.data_ptr(), 0,
                   W.data_ptr(), h0.data_ptr(), h1.data_ptr(), v.data_ptr(),
                   bmask.data_ptr(), starts.data_ptr(), ends.data_ptr(),
                   nseg, n, k, scratch.data_ptr())
    return out, bad[0] == 0


def _k3_blocks(n: int, per_thread: int = 1) -> int:
    """K3's blocks for n terms (or summed rows), per_thread of them a
    thread at least: up to _K3_MAX_BLOCKS, which fill the card."""
    return max(1, min(_K3_MAX_BLOCKS, -(-n // (256 * per_thread))))


def _k3_wire_grid(F, T: int, lanes: int):
    """(nblk, wide) of a K3 wire launch over T terms a lane."""
    if not F.kCharacteristicTwo and T * lanes >= _K3_WIDE_MIN:
        return _k3_blocks(T, _K3_WIDE_TERMS), 1
    return _k3_blocks(T), 0


# the K3 scratch of each (device, stream), which K7 shares: the partial
# sums of a call (int64) and the tickets, one count a group of blocks
# (int32, zero between launches: each launch's last block of a group
# resets its own), grown as calls need; one stream's launches run in
# order, so they can share them
_K3_SCRATCH = {}


def _k3_scratch(device, npartial: int, ntickets: int):
    """(partials, tickets) for one K3 or K7 launch on the current stream of
    `device`: at least npartial int64 words and ntickets zero counts."""
    st = torch.cuda.current_stream(device)
    key = (device.index, st.cuda_stream)
    part, tick = _K3_SCRATCH.get(key, (None, None))
    if part is None or part.numel() < npartial:
        part = torch.empty(max(npartial, 1 << 16), dtype=torch.int64,
                           device=device)
    if tick is None or tick.numel() < ntickets:
        tick = torch.zeros(max(ntickets, 1 << 12), dtype=torch.int32,
                           device=device)
    _K3_SCRATCH[key] = (part, tick)
    return part, tick


def fp_axis_sum(F: PrimeField, x: torch.Tensor, dim: int) -> torch.Tensor:
    """K3 wrapper, mode 1: field sum along element axis `dim` (one
    launch)."""
    name = route("fp_wire_round", F, x)
    if name is None:
        return plain_of(F).axis_sum_plain(F, x, dim)
    check_elts(x, "x", F.elt_shape)
    eshape = x.shape[:-1]
    dim = dim % len(eshape)
    A = int(np.prod(eshape[:dim]))
    R = int(eshape[dim])
    B = int(np.prod(eshape[dim + 1 :]))
    out = torch.empty(tuple(eshape[:dim]) + tuple(eshape[dim + 1 :]) +
                      F.elt_shape, dtype=torch.int32, device=x.device)
    nblk = _k3_blocks(R)
    part, tick = _k3_scratch(x.device, F.nlimb * A * B * nblk, A * B)
    kernels.launch(name, 1, 1, out.data_ptr(), part.data_ptr(),
                   x.data_ptr(), 0, 0, 0, 0, 0, A, R, B, nblk, 0, 0, 0,
                   tick.data_ptr())
    return out


def fp_wire_sums(F: PrimeField, hv: torch.Tensor, Wh: torch.Tensor,
                 Wo: torch.Tensor, h: torch.Tensor, ho: torch.Tensor,
                 s: int = 0, so: int = 0) -> torch.Tensor:
    """K3 wrapper, mode 0: [a0, a2] ([2, N]) of one hand's wire round, its
    indices h >> s and the other hand's ho >> so (the round's shifts,
    0-31); with a leading lane axis on hv [B, T, N], Wh [B, nh, N] and Wo
    [B, no, N] (h and ho shared), [B, 2, N] in the same one launch.  At
    the instances of up to 8 words and GF(2^128)."""
    name = route("fp_wire_round", F, hv, Wh, Wo, h, ho)
    if name is None:
        return plain_of(F).wire_sums_plain(F, hv, Wh, Wo, h, ho, s, so)
    if F.nlimb > 8:
        raise NotImplementedError("K3's wire mode has no CUDA instance for "
                                  "%s" % F.name)
    for t, tname in ((hv, "hv"), (Wh, "Wh"), (Wo, "Wo")):
        check_elts(t, tname, F.elt_shape)
    _i32(h, "h")
    _i32(ho, "ho")
    lanes = hv.dim() == 3
    B = hv.shape[0] if lanes else 1
    if Wh.dim() != hv.dim() or Wo.dim() != hv.dim() or \
            (lanes and (Wh.shape[0] != B or Wo.shape[0] != B)):
        raise ValueError("hv, Wh and Wo need the same lanes")
    T = hv.shape[-2]
    out = torch.empty((B, 2, F.nlimb), dtype=torch.int32, device=hv.device)
    nblk, wide = _k3_wire_grid(F, T, B)
    part, tick = _k3_scratch(hv.device, 2 * B * F.nlimb * nblk, B)
    kernels.launch(name, 1, 0, out.data_ptr(), part.data_ptr(),
                   hv.data_ptr(), Wh.data_ptr(), Wo.data_ptr(), h.data_ptr(),
                   ho.data_ptr(), T, B, Wh.shape[-2], Wo.shape[-2], nblk,
                   _shift(s), _shift(so), wide, tick.data_ptr())
    return out if lanes else out[0]


def fp_layer_hv(F, dot: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                bmask: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """K23 wrapper: the layer prologue hv [B, T, N] (FieldOps.layer_hv),
    one launch; beta [B, N] may be a view whose lanes lie a multiple of N
    words apart (the sumcheck's draws)."""
    name = route("layer_hv", F, dot, g, v, bmask, beta)
    if name is None:
        return plain_of(F).layer_hv_plain(F, dot, g, v, bmask, beta)
    check_elts(dot, "dot", F.elt_shape)
    check_elts(v, "v", F.elt_shape)
    _i32(g, "g")
    if bmask.dtype != torch.bool or not bmask.is_contiguous():
        raise ValueError("bmask must be a contiguous bool tensor")
    T = g.numel()
    if dot.dim() != 3 or v.shape[0] != T or bmask.numel() != T:
        raise ValueError("dot must be [B, nv, N] and g, v, bmask hold one "
                         "entry a term")
    if beta.dim() != 2 or beta.shape[0] != dot.shape[0]:
        raise ValueError("beta must hold one element a lane of dot")
    lanes, bstride = _lane_challenges(F, beta)
    out = torch.empty((lanes, T) + F.elt_shape, dtype=torch.int32,
                      device=dot.device)
    kernels.launch(name, 1, out.data_ptr(), dot.data_ptr(), g.data_ptr(),
                   v.data_ptr(), bmask.data_ptr(), beta.data_ptr(), T, lanes,
                   dot.shape[1], bstride)
    return out


# K24: the most challenges a table (2^24 entries; its shared memory at
# that size is 44 KB at P-256 in mode 2)
EQ_LOGN_MAX = 24


def _eq_challenges(F, q: torch.Tensor, name: str):
    """(lanes, lane stride, challenge stride), the strides in elements,
    of K24's challenges q [logn, N] or [B, logn, N]: each element's words
    contiguous, the challenges and the lanes any multiple of N words
    apart (views of the sumcheck's rows of draws)."""
    N = F.nlimb
    if q.dtype != torch.int32 or q.dim() not in (2, 3) or \
            q.shape[-1] != N or q.stride(-1) != 1 or \
            any(q.stride(d) % N for d in range(q.dim() - 1)):
        raise ValueError("%s must be int32 [logn, N] or [B, logn, N], each "
                         "element's words contiguous and the elements a "
                         "multiple of N words apart, got %s %s %s"
                         % (name, q.dtype, tuple(q.shape), q.stride()))
    qt = q.stride(-2) // N
    if q.dim() == 2:
        return 1, 0, qt
    return q.shape[0], q.stride(0) // N, qt


def fp_eq_table(F, q: torch.Tensor, n: int,
                alpha: Optional[torch.Tensor] = None,
                q1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K24 wrapper: the EQ table (FieldOps.eq_table), one launch; with
    alpha and q1, EQ(q, .) + alpha EQ(q1, .)."""
    if (alpha is None) != (q1 is None):
        raise ValueError("mode 2 takes both alpha and q1")
    ts = (q,) if alpha is None else (q, alpha, q1)
    name = route("eq_table", F, *ts)
    if name is None:
        return plain_of(F).eq_table_plain(F, q, n, alpha, q1)
    lanes, qs0, qt0 = _eq_challenges(F, q, "q")
    logn = q.shape[-2]
    if not 0 <= logn <= EQ_LOGN_MAX or not 1 <= n <= 1 << logn:
        raise ValueError("K24 takes 1 <= n <= 2^logn, logn <= %d; got n %d, "
                         "logn %d" % (EQ_LOGN_MAX, n, logn))
    qs1 = qt1 = as_ = 0
    if alpha is not None:
        if q1.shape != q.shape:
            raise ValueError("q1 must have q's shape %s, got %s"
                             % (tuple(q.shape), tuple(q1.shape)))
        _, qs1, qt1 = _eq_challenges(F, q1, "q1")
        if alpha.dim() != q.dim() - 1 or (q.dim() == 3 and
                                          alpha.shape[0] != lanes):
            raise ValueError("alpha must hold one element a lane of q")
        as_ = _lane_challenges(F, alpha)[1]
    if lanes > 65535:
        raise ValueError("K24 takes at most 65,535 lanes")
    out = torch.empty((lanes, n) + F.elt_shape, dtype=torch.int32,
                      device=q.device)
    kernels.launch(name, 1, out.data_ptr(), q.data_ptr(),
                   0 if q1 is None else q1.data_ptr(),
                   0 if alpha is None else alpha.data_ptr(),
                   1 if alpha is None else 2, n, logn, lanes, qs0, qt0, qs1,
                   qt1, as_)
    return out if q.dim() == 3 else out[0]


def fp_copy_round_sums(F, EQ: torch.Tensor, W: torch.Tensor,
                       h0: torch.Tensor, h1: torch.Tensor,
                       hv: torch.Tensor) -> torch.Tensor:
    """K16 wrapper: (c0, c2, c3), [3, N], of one copy round from the copy
    EQ array EQ [C, N], a layer's inputs W [nw, C, N] (copies inner), the
    terms' indices h0, h1 (int32 [T]) and values hv [T, N]; C even (see
    copy_round_sums_plain)."""
    name = route("copy_round_sums", F, EQ, W, h0, h1, hv)
    if name is None:
        return copy_round_sums_plain(F, EQ, W, h0, h1, hv)
    for t, tname in ((EQ, "EQ"), (W, "W"), (hv, "hv")):
        check_elts(t, tname, F.elt_shape)
    _i32(h0, "h0")
    _i32(h1, "h1")
    C, T = EQ.shape[0], hv.shape[0]
    if EQ.dim() != 2 or C < 2 or C % 2:
        raise ValueError("EQ must be [C, N] with C even, got %s"
                         % (tuple(EQ.shape),))
    if W.dim() != 3 or W.shape[1] != C:
        raise ValueError("W must be [nw, %d, N], got %s"
                         % (C, tuple(W.shape)))
    if hv.dim() != 2 or h0.shape != (T,) or h1.shape != (T,):
        raise ValueError("h0, h1 and hv need one entry per term")
    nblk = max(1, min(_K16_MAX_BLOCKS, (T + 255) // 256))
    out = torch.empty((3, F.nlimb), dtype=torch.int32, device=W.device)
    # the partials, then the count of blocks done (zero)
    scratch = torch.zeros(3 * F.nlimb * nblk + 1, dtype=torch.int64,
                          device=W.device)
    kernels.launch(name, 1, out.data_ptr(), scratch.data_ptr(),
                   EQ.data_ptr(), W.data_ptr(), h0.data_ptr(), h1.data_ptr(),
                   hv.data_ptr(), T, C, nblk)
    return out
