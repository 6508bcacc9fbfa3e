"""Fp24 (the 23-bit ML-DSA prime field) and its sextic extension Fp24_6:
host ints and PyTorch tensors.

Port of the JAX package's fields/fp24.py, semantic twin of the reference
lib/algebra/fp24.h and fp24_6.h (the small-field experiments of the SHA3
and ML-DSA circuits; the canonical instance is the Dilithium prime q =
8380417 with x^6 - 7 irreducible).  Fp24 is a PrimeField of one 32-bit
word (R = 2^32, the JAX package's R with its two 16-bit limbs, so both
hold the same integers), whose tensor ops run through K1, K2, K3 and
K21 `[fp24]`.

Fp24_6 = F_p[x] / (x^6 - beta).  Host elements are 6-tuples of ints in
natural form (hashable, as the compiler's CSE requires), copied from the
JAX package.  A tensor element is its six coefficients, int32 [..., 6,
1] (coefficient 0 first, each Fp24's Montgomery word); the JAX package
holds them planar, uint32 [6, L, ...] (fields/bridge.py converts).  mul,
sqr and inv are wrappers over kernel K22 `fp24x6_elementwise`
(csrc/fp24x6.cu) for a CUDA tensor and over its plain version below,
built on the base field's plain ops (fields/fp.py), for a CPU one; a
CUDA tensor of another prime or beta raises.  The ops that act on each
coefficient alone are the base field's on the six words: add, sub, neg
and select through K1 `[fp24]`, eq and is_zero as K1's per word and an
all over the six, lazy_sum as K3 `[fp24]`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from .fp import (INV, MUL, SQR, PrimeField, _add16, _const16, _join16,
                 _mont_mul16, _renorm16, _split16, elementwise_operands,
                 route)

FP24_P = 8380417  # = 2^23 - 2^13 + 1, the ML-DSA modulus (fp24_test.cc)


def fp24(p: int = FP24_P) -> PrimeField:
    return PrimeField(p, f"fp24({p})", nbytes=4)


Elt6 = Tuple[int, int, int, int, int, int]

# K22's modes: K1's numbers and INV
_K22_MODES = (MUL, SQR, INV)


class Fp24_6:
    """Sextic extension F_p[x]/(x^6 - beta) (fp24_6.h:33-315)."""

    kCharacteristicTwo = False
    kNPolyEvaluationPoints = 6

    def __init__(self, base: PrimeField, beta: int = 7):
        self.f = base
        self.beta = beta
        self.char = base.p
        self.order = base.p ** 6
        self.name = base.name + "^6"
        self.kBytes = 6 * base.kBytes
        self.kSubFieldBytes = base.kBytes
        self.L = base.L
        self.exact_bits = 6 * base.bits
        self.nlimb = base.nlimb
        self.elt_shape = (6, base.nlimb)
        # the kernels' instance: K22 is compiled for the ML-DSA prime and
        # beta = 7 (csrc/fp24x6.cu)
        self.tag = "fp24x6" if base.tag == "fp24" and beta == 7 else None

    # -- host ops (6-tuples, natural form) -----------------------------------

    def _t(self, a) -> Elt6:
        if isinstance(a, tuple):
            return a
        return (int(a) % self.f.p, 0, 0, 0, 0, 0)

    def of_scalar(self, a) -> Elt6:
        return self._t(a)

    def of_base(self, a: int) -> Elt6:
        return (a, 0, 0, 0, 0, 0)

    def add_i(self, a, b) -> Elt6:
        a, b = self._t(a), self._t(b)
        return tuple((x + y) % self.f.p for x, y in zip(a, b))

    def sub_i(self, a, b) -> Elt6:
        a, b = self._t(a), self._t(b)
        return tuple((x - y) % self.f.p for x, y in zip(a, b))

    def neg_i(self, a) -> Elt6:
        return tuple((-x) % self.f.p for x in self._t(a))

    def mul_i(self, a, b) -> Elt6:
        a, b = self._t(a), self._t(b)
        p = self.f.p
        # subfield fast paths (most circuit values live in Fp24)
        if not any(a[1:]):
            a0 = a[0]
            return tuple((a0 * x) % p for x in b)
        if not any(b[1:]):
            b0 = b[0]
            return tuple((x * b0) % p for x in a)
        m = [0] * 11
        for i in range(6):
            for j in range(6):
                m[i + j] += a[i] * b[j]
        return tuple((m[k] + self.beta * m[k + 6]) % p if k < 5
                     else m[5] % p for k in range(6))

    def inv_i(self, a) -> Elt6:
        """Extended Euclid over F_p[x] mod (x^6 - beta): maintain
        s_i * a == r_i (mod x^6 - beta)."""
        p = self.f.p
        a = self._t(a)
        assert any(a), "inverse of zero"

        def pdeg(u):
            for d in range(len(u) - 1, -1, -1):
                if u[d] % p:
                    return d
            return -1

        def pdivmod(num, den):
            num = list(num)
            dd = pdeg(den)
            dinv = pow(den[dd], -1, p)
            q = [0] * (max(pdeg(num) - dd, -1) + 1)
            while pdeg(num) >= dd:
                dn = pdeg(num)
                c = num[dn] * dinv % p
                q[dn - dd] = c
                for i in range(dd + 1):
                    num[i + dn - dd] = (num[i + dn - dd] - c * den[i]) % p
            return q, num

        def psub_mul(s, q, t):
            """s - q*t."""
            out = list(s) + [0] * max(0, pdeg(q) + pdeg(t) + 1 - len(s) + 1)
            for i, qc in enumerate(q):
                if qc == 0:
                    continue
                for j, tc in enumerate(t):
                    out[i + j] = (out[i + j] - qc * tc) % p
            return out

        r0 = [(-self.beta) % p, 0, 0, 0, 0, 0, 1]
        r1 = list(a)
        s0, s1 = [0], [1]
        while pdeg(r1) > 0:
            q, r = pdivmod(r0, r1)
            r0, r1 = r1, r
            s0, s1 = s1, psub_mul(s0, q, s1)
        assert pdeg(r1) == 0, "not invertible"
        cinv = pow(r1[0], -1, p)
        out = [(x * cinv) % p for x in s1[:6]]
        out += [0] * (6 - len(out))
        res = tuple(out)
        assert self.mul_i(res, a) == self.of_scalar(1)
        return res

    def poly_evaluation_point(self, i: int) -> Elt6:
        assert i < self.kNPolyEvaluationPoints
        return self.of_scalar(i)

    def newton_denominator(self, k: int, i: int) -> Elt6:
        return self.of_scalar(pow(i, -1, self.f.p))

    # -- serialization (little-endian, coefficient-major; fp24_6.h) ----------

    def to_bytes(self, x) -> bytes:
        return b"".join(self.f.to_bytes(c) for c in self._t(x))

    def of_bytes(self, b: bytes) -> Optional[Elt6]:
        assert len(b) == self.kBytes
        nb = self.f.kBytes
        out = []
        for i in range(6):
            v = self.f.of_bytes(b[i * nb : (i + 1) * nb])
            if v is None:
                return None
            out.append(v)
        return tuple(out)

    def to_bytes_subfield(self, x) -> bytes:
        t = self._t(x)
        assert all(c == 0 for c in t[1:])
        return self.f.to_bytes(t[0])

    def of_bytes_subfield(self, b: bytes) -> Optional[Elt6]:
        v = self.f.of_bytes(b)
        return None if v is None else self.of_base(v)

    def in_subfield(self, e) -> bool:
        return all(c == 0 for c in self._t(e)[1:])

    def sample(self, fill_bytes) -> Elt6:
        return tuple(self.f.sample(fill_bytes) for _ in range(6))

    def sample_subfield(self, fill_bytes) -> Elt6:
        return self.of_base(self.f.sample(fill_bytes))

    # -- host <-> tensor ------------------------------------------------------

    def to_limbs(self, xs, device=None) -> torch.Tensor:
        """An element (6-tuple or int) -> int32 [6, 1]; a sequence of them
        -> [n, 6, 1], on `device` (the card unless the caller asks for
        the CPU)."""
        dev = resolve_device(device)
        one = isinstance(xs, (int, np.integer, tuple))
        vals = [self._t(x) for x in ([xs] if one else xs)]
        t = self.f.to_limbs([c for v in vals for c in v], dev).reshape(
            (len(vals),) + self.elt_shape)
        return t[0] if one else t

    def from_limbs(self, t: torch.Tensor):
        """int32 [..., 6, 1] -> a 6-tuple ([6, 1]) or a numpy object array
        of 6-tuples (shape t.shape[:-2])."""
        assert tuple(t.shape[-2:]) == self.elt_shape
        flat = self.f.from_limbs(t.reshape(-1, self.nlimb))
        vals = [tuple(int(c) for c in flat[6 * j : 6 * j + 6])
                for j in range(len(flat) // 6)]
        if t.dim() == 2:
            return vals[0]
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return out.reshape(tuple(t.shape[:-2]))

    def zeros(self, shape=(), device=None) -> torch.Tensor:
        return torch.zeros(tuple(shape) + self.elt_shape, dtype=torch.int32,
                           device=resolve_device(device))

    # -- tensor ops (int32 [..., 6, 1]) ---------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.f.add(a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.f.sub(a, b)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.f.neg(a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp24x6_elementwise(self, MUL, a, b)

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return fp24x6_elementwise(self, SQR, a, a)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """a^(p^6 - 2): the inverse, 0 for 0."""
        return fp24x6_elementwise(self, INV, a, a)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.f.eq(a, b).all(-1)

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return self.f.is_zero(a).all(-1)

    def select(self, cond: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        return self.f.select(cond[..., None], a, b)

    def lazy_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum along element axis `dim` of x [..., 6, 1]: the base field's
        sum (K3 `[fp24]`), the six coefficients an axis beside it."""
        return self.f.lazy_sum(x, dim % (x.dim() - 2))


# ----------------------------------------------------------------------
# plain version of K22: the base field's plain ops over 16-bit limbs
# ----------------------------------------------------------------------

def _mul6_16(F6: Fp24_6, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of 16-bit-limb elements [..., 6, 2] (broadcast): the 36
    Montgomery base products, each output column's sum reduced once,
    then m[k] + beta m[k + 6] by the product with beta's limbs (the JAX
    package's Fp24_6.mul, fields/fp24.py:227-240)."""
    F = F6.f
    a, b = torch.broadcast_tensors(a, b)
    pairs = a.shape[:-2] + (6, 6, F.nl16)   # P[..., i, j] = a_i b_j
    P = _mont_mul16(F, a[..., :, None, :].expand(pairs),
                    b[..., None, :, :].expand(pairs))
    cols = torch.zeros(P.shape[:-3] + (11, F.nl16), dtype=torch.int64,
                       device=P.device)
    for i in range(6):
        cols[..., i : i + 6, :] += P[..., i, :, :]
    m = _renorm16(F, cols)
    beta = _split16(F.to_limbs(F6.beta, m.device))
    fold = _mont_mul16(F, m[..., 6:, :], beta.expand(m[..., 6:, :].shape))
    return torch.cat([_add16(F, m[..., :5, :], fold), m[..., 5:6, :]],
                     dim=-2)


def fp24x6_elementwise_plain(F6: Fp24_6, mode: int, a: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Plain version of K22 (fp24x6_elementwise); any device."""
    F = F6.f
    a16 = _split16(a)
    if mode == MUL:
        return _join16(_mul6_16(F6, a16, _split16(b)))
    if mode == SQR:
        return _join16(_mul6_16(F6, a16, a16))
    # INV: a^(p^6 - 2) left to right, as the JAX package's scan
    one = torch.zeros_like(a16)
    one[..., 0, :] = _const16(F._one16, a16)
    r = one
    for bit in bin(F6.order - 2)[2:]:
        r = _mul6_16(F6, r, r)
        if bit == "1":
            r = _mul6_16(F6, r, a16)
    return _join16(r)


def fp24x6_elementwise(F6: Fp24_6, mode: int, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """K22 wrapper: mul broadcasts a and b over the element axes; sqr
    and inv read a alone."""
    if mode not in _K22_MODES:
        raise ValueError("K22 has no mode %d" % mode)
    name = route("fp24x6_elementwise", F6, a, b)
    if name is None:
        return fp24x6_elementwise_plain(F6, mode, a, b)
    out, a, b, _, n, bdiv, bmod = elementwise_operands(
        mode, a, b, None, F6.elt_shape)
    kernels.launch(name, 1, mode, out.data_ptr(), a.data_ptr(), b.data_ptr(),
                   n, bdiv, bmod)
    return out
