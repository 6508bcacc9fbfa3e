"""Quadratic extension field Fp2 = Fp[i]/(i^2 + 1): host ints and tensors.

Port of the JAX package's fields/fp2.py, semantic twin of the reference
Fp2 (lib/algebra/fp2.h:35-250) with its default nonresidue -1.  It
gives the P-256 base field the roots of unity of order 2^31 that its
Reed-Solomon encoder convolves over (transforms/ntt.py
FFTExtConvolution, lib/circuits/mdoc/mdoc_zk.cc:82-88).

Host scalars are (re, im) int tuples.  A tensor element is the pair of
base-field elements in the last two axes, int32 [..., 2, N] (re first),
in the base field's Montgomery form.  The tensor ops (mul, add, sub,
mul_base, from_mont, sqr, neg, mul_const, eq, is_zero, select) are
wrappers over kernel K5 `fp2_elementwise` (csrc/fp2_ops.cu), inv over
K21 `fp_inv[fp256x2]`, for a CUDA tensor, and over their plain versions,
built on the base field's plain ops (fields/fp.py), for a CPU one.
lazy_sum and lazy_segment_sum are the base field's K3 and K2 over the
two parts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import kernels
from .fp import (ADD, EQ, IS_ZERO, MUL, NEG, SELECT, SQR, SUB, PrimeField,
                 broadcast_operands, compare_plain, elementwise_operands,
                 elementwise_plain, fp_inv, inv_plain, natural_bytes, route)

Elt2 = Tuple[int, int]

# K5 modes (csrc/fp2_ops.cu); mul, add, sub and 5-9 are K1's numbers
MUL_BASE = 3
_K5_MODES = (MUL, ADD, SUB, MUL_BASE, SQR, NEG, EQ, IS_ZERO, SELECT)


class Fp2:
    kCharacteristicTwo = False
    kNPolyEvaluationPoints = 6

    def __init__(self, base: PrimeField):
        self.f = base
        self.name = base.name + "^2"
        # i^2 = -1: the reference's default (and fast) nonresidue, the
        # only one the repo's circuits use
        self.nonresidue = base.p - 1
        self.kBytes = 2 * base.kBytes
        self.kSubFieldBytes = base.kBytes
        self.L = base.L
        self.nlimb = base.nlimb
        self.elt_shape = (2, base.nlimb)
        # the kernels' instance for this field, or None
        self.tag = base.tag + "x2" if base.tag == "fp256" else None

    # ------------------------------------------------------------------
    # host ops on (re, im) int tuples
    # ------------------------------------------------------------------

    def add_i(self, a: Elt2, b: Elt2) -> Elt2:
        return (self.f.add_i(a[0], b[0]), self.f.add_i(a[1], b[1]))

    def sub_i(self, a: Elt2, b: Elt2) -> Elt2:
        return (self.f.sub_i(a[0], b[0]), self.f.sub_i(a[1], b[1]))

    def neg_i(self, a: Elt2) -> Elt2:
        return (self.f.neg_i(a[0]), self.f.neg_i(a[1]))

    def mul_i(self, a: Elt2, b: Elt2) -> Elt2:
        p = self.f.p
        p0 = a[0] * b[0] % p
        p1 = a[1] * b[1] % p
        re = (p0 + p1 * self.nonresidue) % p
        im = ((a[0] + a[1]) * (b[0] + b[1]) - p0 - p1) % p
        return (re, im)

    def inv_i(self, a: Elt2) -> Elt2:
        p = self.f.p
        denom = (a[0] * a[0] - self.nonresidue * a[1] * a[1]) % p
        dinv = pow(denom, -1, p)
        return (a[0] * dinv % p, (-a[1]) * dinv % p)

    def of_scalar(self, a) -> Elt2:
        if isinstance(a, tuple):
            return a
        return (int(a) % self.f.p, 0)

    of_scalar_field = of_scalar

    def of_base(self, re: int) -> Elt2:
        return (re, 0)

    def poly_evaluation_point(self, i: int) -> Elt2:
        return (self.f.poly_evaluation_point(i), 0)

    def newton_denominator(self, k: int, i: int) -> Elt2:
        return (self.f.newton_denominator(k, i), 0)

    def to_bytes(self, x: Elt2) -> bytes:
        return self.f.to_bytes(x[0]) + self.f.to_bytes(x[1])

    def of_bytes(self, b: bytes) -> Optional[Elt2]:
        assert len(b) == self.kBytes
        re = self.f.of_bytes(b[: self.f.kBytes])
        im = self.f.of_bytes(b[self.f.kBytes :])
        if re is None or im is None:
            return None
        return (re, im)

    def to_bytes_subfield(self, x: Elt2) -> bytes:
        assert x[1] == 0, "element not in base subfield"
        return self.f.to_bytes(x[0])

    def of_bytes_subfield(self, b: bytes) -> Optional[Elt2]:
        re = self.f.of_bytes(b)
        return None if re is None else (re, 0)

    def in_subfield(self, e: Elt2) -> bool:
        return e[1] == 0

    def sample(self, fill_bytes) -> Elt2:
        return (self.f.sample(fill_bytes), self.f.sample(fill_bytes))

    def sample_subfield(self, fill_bytes) -> Elt2:
        return (self.f.sample(fill_bytes), 0)

    # ------------------------------------------------------------------
    # host <-> tensor
    # ------------------------------------------------------------------

    def to_limbs(self, xs: Union[Elt2, Sequence[Elt2]],
                 device) -> torch.Tensor:
        """(re, im) -> int32 [2, N]; a sequence of them -> [n, 2, N]."""
        one = isinstance(xs, tuple) and len(xs) == 2 and \
            isinstance(xs[0], (int, np.integer))
        vals = [xs] if one else list(xs)
        t = self.f.to_limbs([int(c) for x in vals for c in x], device)
        t = t.reshape(len(vals), 2, self.nlimb)
        return t[0] if one else t

    def from_limbs(self, t: torch.Tensor):
        """int32 [..., 2, N] -> (re, im) ([2, N]) or a numpy object array
        of (re, im) tuples (shape t.shape[:-2])."""
        assert tuple(t.shape[-2:]) == self.elt_shape
        flat = self.f.from_limbs(t.reshape(-1, self.nlimb))
        vals = [(int(flat[2 * j]), int(flat[2 * j + 1]))
                for j in range(len(flat) // 2)]
        if t.dim() == 2:
            return vals[0]
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return out.reshape(tuple(t.shape[:-2]))

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(tuple(shape) + self.elt_shape, dtype=torch.int32,
                           device=device)

    # ------------------------------------------------------------------
    # tensor ops (int32 [..., 2, N]), all through K5
    # ------------------------------------------------------------------

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp2_elementwise(self, MUL, a, b)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp2_elementwise(self, ADD, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp2_elementwise(self, SUB, a, b)

    def mul_base(self, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """a [..., 2, N] times base-field elements s [..., N]."""
        return fp2_elementwise(self, MUL_BASE, a, s)

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery limbs -> limbs of the natural value of each part
        (a * 1 * R^-1, the base-field element 1 given in natural form)."""
        one = torch.zeros(self.nlimb, dtype=torch.int32, device=a.device)
        one[0] = 1
        return fp2_elementwise(self, MUL_BASE, a, one)

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return fp2_elementwise(self, SQR, a, a)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return fp2_elementwise(self, NEG, a, a)

    def mul_const(self, a: torch.Tensor, c) -> torch.Tensor:
        """a times the host constant c ((re, im) or a base-field int; K5's
        product by its limbs)."""
        return fp2_elementwise(self, MUL, a,
                               self.to_limbs(self.of_scalar(c), a.device))

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """(re, -im) / (re^2 + im^2): the inverse, 0 for 0 (K21)."""
        return fp_inv(self, a, fp2_inv_plain)

    batch_inverse = inv

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp2_elementwise(self, EQ, a, b)

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return fp2_elementwise(self, IS_ZERO, a, a)

    def select(self, cond: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        return fp2_elementwise(self, SELECT, a, b, cond)

    def natural_limbs_to_bytes_dev(self, x: torch.Tensor) -> torch.Tensor:
        """Natural-form [..., 2, N] -> uint8 [..., 2 kBytes of the base]:
        re's bytes, then im's (a view and a reshape)."""
        nat = natural_bytes(x, self.f.kBytes)
        return nat.reshape(nat.shape[:-2] + (2 * self.f.kBytes,))

    def lazy_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum along element axis `dim` of x [..., 2, N]: the base field's
        (K3), the two parts an axis beside it."""
        return self.f.lazy_sum(x, dim % (x.dim() - 2))

    def lazy_segment_sum(self, x: torch.Tensor, starts: torch.Tensor,
                         ends: torch.Tensor) -> torch.Tensor:
        """x [T, 2, N] -> [S, 2, N]: out[s] = sum of x[starts[s]:ends[s]],
        the base field's K2 on each part."""
        return torch.stack([self.f.lazy_segment_sum(x[:, c].contiguous(),
                                                    starts, ends)
                            for c in range(2)], dim=-2)


def fp2_elementwise_plain(F2: Fp2, mode: int, a: torch.Tensor,
                          b: torch.Tensor,
                          cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K5 (fp2_elementwise), on Fp256's plain ops; any
    device.  mode MUL (and SQR, b = a): re = p0 - p1, im = (a0 + a1)(b0 +
    b1) - p0 - p1 with p0 = a0 b0, p1 = a1 b1 (Karatsuba, i^2 = -1)."""
    F = F2.f
    if mode in (EQ, IS_ZERO, SELECT):
        return compare_plain(mode, a, b, cond, nelt=2)
    if mode == SQR:
        b = a
    if mode == NEG:
        return torch.stack([elementwise_plain(F, NEG, a[..., c, :], None)
                            for c in range(2)], dim=-2)
    a0, a1 = a[..., 0, :], a[..., 1, :]
    if mode == MUL_BASE:
        return torch.stack([elementwise_plain(F, MUL, a0, b),
                            elementwise_plain(F, MUL, a1, b)], dim=-2)
    b0, b1 = b[..., 0, :], b[..., 1, :]
    if mode in (ADD, SUB):
        return torch.stack([elementwise_plain(F, mode, a0, b0),
                            elementwise_plain(F, mode, a1, b1)], dim=-2)
    p0 = elementwise_plain(F, MUL, a0, b0)
    p1 = elementwise_plain(F, MUL, a1, b1)
    s = elementwise_plain(F, MUL, elementwise_plain(F, ADD, a0, a1),
                          elementwise_plain(F, ADD, b0, b1))
    im = elementwise_plain(F, SUB, elementwise_plain(F, SUB, s, p0), p1)
    re = elementwise_plain(F, SUB, p0, p1)
    re, im = torch.broadcast_tensors(re, im)
    return torch.stack([re, im], dim=-2)


def fp2_inv_plain(F2: Fp2, a: torch.Tensor) -> torch.Tensor:
    """Plain version of K21 [fp256x2]: d = 1 / (re^2 + im^2) by the base
    field's plain a^(p - 2), then (re d, -im d) (0 for 0)."""
    F = F2.f
    re, im = a[..., 0, :], a[..., 1, :]
    d = inv_plain(F, elementwise_plain(
        F, ADD, elementwise_plain(F, SQR, re, None),
        elementwise_plain(F, SQR, im, None)))
    return torch.stack([elementwise_plain(F, MUL, re, d),
                        elementwise_plain(F, NEG, elementwise_plain(
                            F, MUL, im, d), None)], dim=-2)


def fp2_elementwise(F2: Fp2, mode: int, a: torch.Tensor, b: torch.Tensor,
                    cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5 wrapper: mul / add / sub / eq of Fp2 tensors, or mul_base by a
    base-field tensor b [..., N]; b broadcasts over a's element axes.
    sqr, neg and is_zero read a alone; select takes bool conditions
    `cond` and broadcasts them with a and b."""
    if mode not in _K5_MODES:
        raise ValueError("K5 has no mode %d" % mode)
    name = route("fp2_elementwise", F2,
                 *[t for t in (a, b, cond) if t is not None])
    if name is None:
        return fp2_elementwise_plain(F2, mode, a, b, cond)
    if mode == MUL_BASE:
        a, b, bdiv, bmod = broadcast_operands(a, b, F2.elt_shape,
                                              F2.f.elt_shape, False)
        out, n = torch.empty_like(a), a.numel() // (2 * F2.nlimb)
    else:
        out, a, b, cond, n, bdiv, bmod = elementwise_operands(
            mode, a, b, cond, F2.elt_shape)
    kernels.launch(name, 1, mode, out.data_ptr(), a.data_ptr(), b.data_ptr(),
                   0 if cond is None else cond.data_ptr(), n, bdiv, bmod)
    return out
