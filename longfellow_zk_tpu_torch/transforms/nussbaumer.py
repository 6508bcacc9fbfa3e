"""Nussbaumer negacyclic, cyclic and linear convolution over a prime
field: no roots of unity needed.

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
      n <= 4), one thread an output element.

The scale by 1/M and 1/2, the wrap fold and the cyclic and linear splits
are K1 products, sums and differences, with constants uploaded once per
size and device (prepare_constants); the lifts are torch reshapes.  The
second operand y may have fewer rows than x (leading axes of size 1):
its transforms then run once, and K20 reads its rows broadcast.  Prime
fields only (the kernels' instances: Fp128, P-256, secp256k1); the JAX
package's Fp2 case is on no path.  Tensors are int32 [..., n, N]; for CPU
tensors the plain versions below take the kernels' places.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import kernels
from ..device import resolve_device
from ..fields.fp import (ADD, MUL, SUB, axis_sum_plain, check_elts,
                         elementwise_plain, route)
from .ntt import _choose_padding

K_SMALL = 32  # base-case size (the JAX package's; the reference's is 64)

# base-case products a chunk of K20's plain version (bounds its int64
# temporaries)
_PLAIN_PRODUCTS = 1 << 16


# the constants uploaded by _const, keyed on (modulus, value, device)
_CONSTS: dict = {}


def _const(F, v: int, device) -> torch.Tensor:
    """The natural-form constant v as Montgomery limbs [N] on `device`,
    uploaded once per field and device."""
    key = (F.p, v, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = F.to_limbs(v, device)
    return _CONSTS[key]


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
        _const(F, F.inv_i(2 * m), device)
        nega(r)

    while n > 4:
        _const(F, F.inv_i(2), device)
        n //= 2
        nega(n)


# ----------------------------------------------------------------------
# plain versions (any device)
# ----------------------------------------------------------------------

def _neg_plain(F, a: torch.Tensor) -> torch.Tensor:
    return elementwise_plain(F, SUB, torch.zeros_like(a), a)


def nb_butterfly_plain(F, A: torch.Tensor, h: int, step: int,
                       inverse: bool) -> torch.Tensor:
    """Plain version of K19: one level of the block-axis FFT on A [rows,
    M, r, N], viewed [rows, M / 2h, 2, h, r, N] (lo, hi).  Row t of a
    half is multiplied by y^(s_t), s_t = step t mod 2r (y^r = -1): the
    JAX package's _apply_rot.  Forward: (lo + hi, y^s (lo - hi));
    inverse: (lo + y^s hi, lo - y^s hi)."""
    rows, M, r, N = A.shape
    Ar = A.reshape(rows, M // (2 * h), 2, h, r, N)
    lo, hi = Ar[:, :, 0], Ar[:, :, 1]
    dev = A.device
    s = torch.remainder(step * torch.arange(h, device=dev), 2 * r)[:, None]
    flip = s >= r
    s = s % r
    ll = torch.arange(r, device=dev)[None, :]
    idx = (ll - s) % r                                   # [h, r]
    neg = (ll < s) ^ flip

    def rot(a):
        g = a[:, :, torch.arange(h, device=dev)[:, None], idx]
        return torch.where(neg[..., None], _neg_plain(F, g), g)

    if inverse:
        rh = rot(hi)
        out = (elementwise_plain(F, ADD, lo, rh),
               elementwise_plain(F, SUB, lo, rh))
    else:
        out = (elementwise_plain(F, ADD, lo, hi),
               rot(elementwise_plain(F, SUB, lo, hi)))
    return torch.stack(out, dim=2).reshape(A.shape)


def nb_base_conv_plain(F, x: torch.Tensor, y: torch.Tensor,
                       negacyclic: bool) -> torch.Tensor:
    """Plain version of K20: z[k] = sum_j x[j] y[(k - j) mod n], negated
    where k < j if negacyclic, for each row of x [rows, n, N] with row
    row % yrows of y [yrows, n, N]: the JAX package's _base_conv."""
    rows, n, N = x.shape
    j = torch.arange(n, device=x.device)[:, None]
    k = torch.arange(n, device=x.device)[None, :]
    idx = (k - j) % n
    neg = (k < j) if negacyclic else torch.zeros_like(idx, dtype=torch.bool)
    step = max(1, _PLAIN_PRODUCTS // (n * n))
    outs = []
    for s in range(0, rows, step):
        ri = torch.arange(s, min(rows, s + step), device=x.device)
        yg = y[ri % y.shape[0]][:, idx]                  # [., j, k, N]
        yg = torch.where(neg[..., None], _neg_plain(F, yg), yg)
        terms = elementwise_plain(F, MUL, x[ri][:, :, None], yg)
        outs.append(axis_sum_plain(F, terms, 1))
    return torch.cat(outs)


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def nb_butterfly(F, A: torch.Tensor, h: int, step: int,
                 inverse: bool) -> torch.Tensor:
    """K19 wrapper (see nb_butterfly_plain) on A [..., M, r, N], the
    leading axes rows, with M / h even.  Out of place."""
    M, r = A.shape[-3], A.shape[-2]
    A2 = A.reshape((-1,) + tuple(A.shape[-3:]))
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


def _rows_of(x: torch.Tensor, y: torch.Tensor):
    """(x [rows, n, N], y [yrows, n, N]) with y's row row % yrows beside
    x's row: y's batch axes (leading ones dropped) must be a suffix of
    x's."""
    xb, yb = tuple(x.shape[:-2]), tuple(y.shape[:-2])
    while yb and yb[0] == 1:
        yb = yb[1:]
    if len(yb) > len(xb) or xb[len(xb) - len(yb):] != yb:
        raise ValueError("y's batch axes %s must end x's %s" % (yb, xb))
    n, N = x.shape[-2], x.shape[-1]
    return (x.reshape(-1, n, N).contiguous(),
            y.reshape(-1, n, N).contiguous())


def nb_base_conv(F, x: torch.Tensor, y: torch.Tensor,
                 negacyclic: bool) -> torch.Tensor:
    """K20 wrapper: the cyclic or negacyclic product of each row of x
    [..., n, N] with its row of y (y broadcast over x's leading axes)."""
    shape = x.shape
    x2, y2 = _rows_of(x, y)
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

def _lift(a: torch.Tensor, m: int, r: int) -> torch.Tensor:
    """a [..., n, N] -> the blocks X[i, j] = a[m j + i], zero-padded to
    [..., 2m, r, N] (the leading axes kept, so that y's stay a suffix of
    x's through the recursion)."""
    A = a.reshape(a.shape[:-2] + (r, m, a.shape[-1])).transpose(-3, -2)
    return torch.cat([A, torch.zeros_like(A)], dim=-3)


def _fwd(F, A: torch.Tensor, m: int, w: int) -> torch.Tensor:
    """The forward DIF FFT over the block axis (bit-reversed output)."""
    h, sm = m, 1
    while h >= 1:
        A = nb_butterfly(F, A, h, w * sm, False)
        h //= 2
        sm *= 2
    return A


def negacyclic(F, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negacyclic convolution along the element axis of x [..., n, N]
    (y's leading axes broadcast): z[k] = sum_{j<=k} x_j y_{k-j} -
    sum_{j>k} x_j y_{n+k-j}."""
    n, N = x.shape[-2], x.shape[-1]
    assert n & (n - 1) == 0
    if n <= K_SMALL:
        return nb_base_conv(F, x, y, True)
    m, r = _split(n)
    M = 2 * m
    w = r // m  # y^w is a primitive 2m-th root of unity
    Xf = _fwd(F, _lift(x, m, r), m, w)
    Yf = _fwd(F, _lift(y, m, r), m, w)
    Z = negacyclic(F, Xf, Yf)  # every block of every row at once
    # the inverse DIT FFT (undoes fwd, ordering included), then 1/M
    h, sm = 1, m
    while h <= m:
        Z = nb_butterfly(F, Z, h, -w * sm, True)
        h *= 2
        sm //= 2
    Z = F.mul(Z, _const(F, F.inv_i(M), Z.device))
    # the fold c_i = C_i + y C_(m+i), then back to [..., n]
    lo, hi = Z[..., :m, :, :], Z[..., m:, :, :]
    C = torch.cat([F.sub(lo[..., :1, :], hi[..., -1:, :]),
                   F.add(lo[..., 1:, :], hi[..., :-1, :])], dim=-2)
    return C.transpose(-3, -2).reshape(x.shape).contiguous()


def _halves(F, c: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """((c + g) / 2, (c - g) / 2), concatenated along the element axis."""
    half = _const(F, F.inv_i(2), c.device)
    return torch.cat([F.mul(F.add(c, g), half), F.mul(F.sub(c, g), half)],
                     dim=-2)


def cyclic(F, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cyclic convolution along the element axis (nussbaumer.h
    cyclic_with_workspace, recursion instead of the iterative loop)."""
    n = x.shape[-2]
    assert n & (n - 1) == 0
    if n <= 4:
        return nb_base_conv(F, x, y, False)
    h = n // 2
    xs, xd = F.add(x[..., :h, :], x[..., h:, :]), F.sub(x[..., :h, :],
                                                       x[..., h:, :])
    ys, yd = F.add(y[..., :h, :], y[..., h:, :]), F.sub(y[..., :h, :],
                                                       y[..., h:, :])
    return _halves(F, cyclic(F, xs, ys), negacyclic(F, xd, yd))


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
        """x: [..., n, N] -> z: [..., m, N]."""
        assert x.shape[-2] == self.n
        pad = x.new_zeros(x.shape[:-2] + (self.padding - self.n,
                                          x.shape[-1]))
        z = cyclic(self.F, torch.cat([x, pad], dim=-2), self._y)
        return z[..., : self.m, :]


def make_nussbaumer_convolution_factory(F, device=None):
    dev = resolve_device(device)

    def factory(n, m, y):
        return NussbaumerConvolution(n, m, F, y, dev)

    return factory
