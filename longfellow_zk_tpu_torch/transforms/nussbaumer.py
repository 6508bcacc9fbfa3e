"""Nussbaumer negacyclic, cyclic and linear convolution over a prime
field or over Fp2: no roots of unity needed.

Port of the JAX package's transforms/nussbaumer.py, the semantic twin of
the reference lib/algebra/nussbaumer.h:28-399 (Knuth TAOCP 4.6.4 ex. 59).
For n = m r (m <= r) write a(x) = sum_i x^i A_i(y), y = x^m, in
R[y]/(y^r + 1): y^(r/m) is a primitive 2m-th root of unity, and a product
by y^s is a rotation with the wrapped part negated.  The product is a
2m-point cyclic convolution of the block vectors (an FFT over the block
axis with rotation twiddles) of r-sized negacyclic products, which recurse
batched over all 2m blocks.  Two kernels carry it:

  K19 `nb_butterfly[<field>]` (csrc/nussbaumer.cu): one level of the
      block-axis FFT, the add/sub butterfly fused with the rotation of its
      rows by y^(s_t), s_t computed in the kernel from (t, step); forward
      (DIF, output in bit-reversed block order) or inverse (DIT);
  K20 `nb_base_conv[<field>]`: the base case n <= K_SMALL = 32 (cyclic at
      n <= 4), one thread an output element (over Fp2 its four base
      products a term summed lazily, one reduction a part at the end).

The scale by 1/M and 1/2 (products by a base-field constant: K1, or K5's
mul_base on both parts of an Fp2 element), the wrap fold and the cyclic
and linear splits (K1's or K5's sums and differences), with constants
uploaded once per size and device (prepare_constants); the lifts are
torch reshapes.  The second operand y may have fewer rows than x (leading
axes of size 1): its transforms then run once, and K20 reads its rows
broadcast.  The kernels' instances: Fp128, P-256, secp256k1 and Fp2 over
P-256 (`fp256x2`; the JAX package's planar Fp2 operands, `_nlead`, are
int32 [..., n, 2, N] here).  Tensors are int32 [..., n, *F.elt_shape];
for CPU tensors the plain versions below take the kernels' places.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import kernels
from ..device import resolve_device
from ..fields.fp import (ADD, MUL, SUB, axis_sum_plain, check_elts,
                         elementwise_plain, route)
from ..fields.fp2 import fp2_elementwise_plain
from .ntt import _choose_padding

K_SMALL = 32  # base-case size (the JAX package's; the reference's is 64)

# base-case products a chunk of K20's plain version (bounds its int64
# temporaries)
_PLAIN_PRODUCTS = 1 << 16


# the constants uploaded by _const, keyed on (modulus, value, device)
_CONSTS: dict = {}


def _base(F):
    """F's prime field: F itself, or the base of an Fp2."""
    return getattr(F, "f", F)


def _k(F) -> int:
    """The element's axes: 1 for a prime field ([N]), 2 for Fp2 ([2, N])."""
    return len(F.elt_shape)


def _const(F, v: int, device) -> torch.Tensor:
    """The natural-form constant v of F's prime field as Montgomery limbs
    [N] on `device`, uploaded once per field and device."""
    Fb = _base(F)
    key = (Fb.p, v, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = Fb.to_limbs(v, device)
    return _CONSTS[key]


def _inv_const(F, v: int, device) -> torch.Tensor:
    """1/v in F's prime field (_const)."""
    return _const(F, _base(F).inv_i(v), device)


def _scale(F, a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a times the base-field constant c: K1's product, or K5's mul_base
    (both parts) over Fp2."""
    return F.mul_base(a, c) if _k(F) == 2 else F.mul(a, c)


def _at(F, x: torch.Tensor, sl) -> torch.Tensor:
    """x[..., sl, :] on the element position axis (the one before the
    element's axes)."""
    return x[(Ellipsis, sl) + (slice(None),) * _k(F)]


def _split(n: int):
    """(m, r) with m r = n, m = 2^floor(log2(n) / 2) <= r."""
    m = 1 << ((n.bit_length() - 1) // 2)
    return m, n // m


def prepare_constants(F, n: int, device) -> None:
    """Uploads the constants that cyclic(F, x, y) of length n uses (1/2
    and 1/M of every negacyclic level), so that it uploads nothing."""
    def nega(k):
        if k <= K_SMALL:
            return
        m, r = _split(k)
        _inv_const(F, 2 * m, device)
        nega(r)

    while n > 4:
        _inv_const(F, 2, device)
        n //= 2
        nega(n)


# ----------------------------------------------------------------------
# plain versions (any device)
# ----------------------------------------------------------------------

def _plain(F, mode: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1's plain product, sum or difference, or K5's over Fp2."""
    if _k(F) == 2:
        return fp2_elementwise_plain(F, mode, a, b)
    return elementwise_plain(F, mode, a, b)


def _neg_plain(F, a: torch.Tensor) -> torch.Tensor:
    return _plain(F, SUB, torch.zeros_like(a), a)


def nb_butterfly_plain(F, A: torch.Tensor, h: int, step: int,
                       inverse: bool) -> torch.Tensor:
    """Plain version of K19: one level of the block-axis FFT on A [rows,
    M, r, *elt], viewed [rows, M / 2h, 2, h, r, *elt] (lo, hi).  Row t of
    a half is multiplied by y^(s_t), s_t = step t mod 2r (y^r = -1): the
    JAX package's _apply_rot.  Forward: (lo + hi, y^s (lo - hi));
    inverse: (lo + y^s hi, lo - y^s hi)."""
    rows, M, r = A.shape[:3]
    elt = tuple(A.shape[3:])
    Ar = A.reshape((rows, M // (2 * h), 2, h, r) + elt)
    lo, hi = Ar[:, :, 0], Ar[:, :, 1]
    dev = A.device
    s = torch.remainder(step * torch.arange(h, device=dev), 2 * r)[:, None]
    flip = s >= r
    s = s % r
    ll = torch.arange(r, device=dev)[None, :]
    idx = (ll - s) % r                                   # [h, r]
    neg = ((ll < s) ^ flip)[(Ellipsis,) + (None,) * len(elt)]

    def rot(a):
        g = a[:, :, torch.arange(h, device=dev)[:, None], idx]
        return torch.where(neg, _neg_plain(F, g), g)

    if inverse:
        rh = rot(hi)
        out = (_plain(F, ADD, lo, rh), _plain(F, SUB, lo, rh))
    else:
        out = (_plain(F, ADD, lo, hi), rot(_plain(F, SUB, lo, hi)))
    return torch.stack(out, dim=2).reshape(A.shape)


def nb_base_conv_plain(F, x: torch.Tensor, y: torch.Tensor,
                       negacyclic: bool) -> torch.Tensor:
    """Plain version of K20: z[k] = sum_j x[j] y[(k - j) mod n], negated
    where k < j if negacyclic, for each row of x [rows, n, *elt] with row
    row % yrows of y [yrows, n, *elt]: the JAX package's _base_conv, its
    _sum_terms the base field's plain sum (over Fp2 the plain version of
    its lazy_sum, both parts at once)."""
    rows, n = x.shape[:2]
    j = torch.arange(n, device=x.device)[:, None]
    k = torch.arange(n, device=x.device)[None, :]
    idx = (k - j) % n
    neg = (k < j) if negacyclic else torch.zeros_like(idx, dtype=torch.bool)
    neg = neg[(Ellipsis,) + (None,) * _k(F)]
    step = max(1, _PLAIN_PRODUCTS // (n * n))
    outs = []
    for s in range(0, rows, step):
        ri = torch.arange(s, min(rows, s + step), device=x.device)
        yg = y[ri % y.shape[0]][:, idx]                  # [., j, k, *elt]
        yg = torch.where(neg, _neg_plain(F, yg), yg)
        terms = _plain(F, MUL, x[ri][:, :, None], yg)
        outs.append(axis_sum_plain(_base(F), terms, 1))
    return torch.cat(outs)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def nb_butterfly(F, A: torch.Tensor, h: int, step: int,
                 inverse: bool) -> torch.Tensor:
    """K19 wrapper (see nb_butterfly_plain) on A [..., M, r, *elt], the
    leading axes rows, with M / h even.  Out of place."""
    k = _k(F)
    M, r = A.shape[-2 - k], A.shape[-1 - k]
    A2 = A.reshape((-1,) + tuple(A.shape[-2 - k:]))
    name = route("nb_butterfly", F, A)
    if name is None:
        return nb_butterfly_plain(F, A2, h, step, inverse).reshape(A.shape)
    check_elts(A2, "A", F.elt_shape)
    if M % (2 * h):
        raise ValueError("nb_butterfly takes A [..., M, r, N] with 2h | M")
    out = torch.empty_like(A2)
    kernels.launch(name, 1, out.data_ptr(), A2.data_ptr(), A2.shape[0], M,
                   h, r, step, int(inverse))
    return out.reshape(A.shape)


def _rows_of(x: torch.Tensor, y: torch.Tensor, k: int = 1):
    """(x [rows, n, *elt], y [yrows, n, *elt]) with y's row row % yrows
    beside x's row, the element's k axes last: y's batch axes (leading
    ones dropped) must be a suffix of x's."""
    xb, yb = tuple(x.shape[:-1 - k]), tuple(y.shape[:-1 - k])
    while yb and yb[0] == 1:
        yb = yb[1:]
    if len(yb) > len(xb) or xb[len(xb) - len(yb):] != yb:
        raise ValueError("y's batch axes %s must end x's %s" % (yb, xb))
    tail = tuple(x.shape[-1 - k:])
    return (x.reshape((-1,) + tail).contiguous(),
            y.reshape((-1,) + tail).contiguous())


def nb_base_conv(F, x: torch.Tensor, y: torch.Tensor,
                 negacyclic: bool) -> torch.Tensor:
    """K20 wrapper: the cyclic or negacyclic product of each row of x
    [..., n, *elt] with its row of y (y broadcast over x's leading axes)."""
    shape = x.shape
    x2, y2 = _rows_of(x, y, _k(F))
    name = route("nb_base_conv", F, x2, y2)
    if name is None:
        return nb_base_conv_plain(F, x2, y2, negacyclic).reshape(shape)
    check_elts(x2, "x", F.elt_shape)
    check_elts(y2, "y", F.elt_shape)
    out = torch.empty_like(x2)
    kernels.launch(name, 1, out.data_ptr(), x2.data_ptr(), y2.data_ptr(),
                   x2.shape[0], x2.shape[1], y2.shape[0], int(negacyclic))
    return out.reshape(shape)


# ----------------------------------------------------------------------
# the convolutions
# ----------------------------------------------------------------------

def _lift(F, a: torch.Tensor, m: int, r: int) -> torch.Tensor:
    """a [..., n, *elt] -> the blocks X[i, j] = a[m j + i], zero-padded to
    [..., 2m, r, *elt] (the leading axes kept, so that y's stay a suffix
    of x's through the recursion)."""
    k = _k(F)
    A = a.reshape(a.shape[:-1 - k] + (r, m) + a.shape[-k:]).transpose(
        -2 - k, -1 - k)
    return torch.cat([A, torch.zeros_like(A)], dim=-2 - k)


def _fwd(F, A: torch.Tensor, m: int, w: int) -> torch.Tensor:
    """The forward DIF FFT over the block axis (bit-reversed output)."""
    h, sm = m, 1
    while h >= 1:
        A = nb_butterfly(F, A, h, w * sm, False)
        h //= 2
        sm *= 2
    return A


def negacyclic(F, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negacyclic convolution along the element position axis of x [...,
    n, *elt] (y's leading axes broadcast): z[k] = sum_{j<=k} x_j y_{k-j}
    - sum_{j>k} x_j y_{n+k-j}."""
    k = _k(F)
    n = x.shape[-1 - k]
    assert n & (n - 1) == 0
    if n <= K_SMALL:
        return nb_base_conv(F, x, y, True)
    m, r = _split(n)
    M = 2 * m
    w = r // m  # y^w is a primitive 2m-th root of unity
    Xf = _fwd(F, _lift(F, x, m, r), m, w)
    Yf = _fwd(F, _lift(F, y, m, r), m, w)
    Z = negacyclic(F, Xf, Yf)  # every block of every row at once
    # the inverse DIT FFT (undoes fwd, ordering included), then 1/M
    h, sm = 1, m
    while h <= m:
        Z = nb_butterfly(F, Z, h, -w * sm, True)
        h *= 2
        sm //= 2
    Z = _scale(F, Z, _inv_const(F, M, Z.device))
    # the fold c_i = C_i + y C_(m+i), then back to [..., n]
    e = (slice(None),) * (k + 1)
    lo, hi = Z[(Ellipsis, slice(None, m)) + e], Z[(Ellipsis, slice(m, None))
                                                  + e]
    C = torch.cat([F.sub(_at(F, lo, slice(None, 1)),
                         _at(F, hi, slice(-1, None))),
                   F.add(_at(F, lo, slice(1, None)),
                         _at(F, hi, slice(None, -1)))], dim=-1 - k)
    return C.transpose(-2 - k, -1 - k).reshape(x.shape).contiguous()


def _halves(F, c: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """((c + g) / 2, (c - g) / 2), concatenated along the position axis."""
    half = _inv_const(F, 2, c.device)
    return torch.cat([_scale(F, F.add(c, g), half),
                      _scale(F, F.sub(c, g), half)], dim=-1 - _k(F))


def cyclic(F, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cyclic convolution along the element axis (nussbaumer.h
    cyclic_with_workspace, recursion instead of the iterative loop)."""
    n = x.shape[-1 - _k(F)]
    assert n & (n - 1) == 0
    if n <= 4:
        return nb_base_conv(F, x, y, False)
    h = n // 2
    lo, hi = slice(None, h), slice(h, None)
    x0, x1, y0, y1 = (_at(F, t, s) for t in (x, y) for s in (lo, hi))
    return _halves(F, cyclic(F, F.add(x0, x1), F.add(y0, y1)),
                   negacyclic(F, F.sub(x0, x1), F.sub(y0, y1)))


def linear(F, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Linear convolution: [..., n] x [..., n] -> [..., 2n]
    (nussbaumer.h:63-86: cyclic + negacyclic, inverse butterfly)."""
    return _halves(F, cyclic(F, x, y), negacyclic(F, x, y))


class NussbaumerConvolution:
    """Drop-in convolver (FFTConvolution's contract: cyclic over the pow2
    padding >= m; only indices >= n are wrap-free, which is all
    ReedSolomon reads)."""

    def __init__(self, n: int, m: int, F, y: Sequence, device=None):
        self.F = F
        self.n = n
        self.m = m
        self.device = resolve_device(device)
        self.padding = _choose_padding(m)
        y_pad = list(y) + [F.of_scalar(0)] * (self.padding - len(y))
        self._y = F.to_limbs(y_pad, self.device)
        prepare_constants(F, self.padding, self.device)

    def convolution(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., n, *elt] -> z: [..., m, *elt]."""
        F, k = self.F, _k(self.F)
        assert x.shape[-1 - k] == self.n
        pad = x.new_zeros(x.shape[:-1 - k] + (self.padding - self.n,) +
                          x.shape[-k:])
        z = cyclic(F, torch.cat([x, pad], dim=-1 - k), self._y)
        return _at(F, z, slice(None, self.m))


def make_nussbaumer_convolution_factory(F, device=None):
    dev = resolve_device(device)

    def factory(n, m, y):
        return NussbaumerConvolution(n, m, F, y, dev)

    return factory
