"""Radix-2 NTT over a prime field or Fp2, cyclic convolution, and the
Reed-Solomon "extend" encoder of the Ligero commit.

Port of the JAX package's transforms/ntt.py, twin of the reference FFT
(lib/algebra/fft.h:27-202):

    fftb:  T[j] = SUM_k F[k] W^{jk}     (backward, positive exponent)
    fftf:  F[k] = SUM_j T[j] W^{-jk}    (forward = backward with W^-1)
    fftb(fftf(x)) == n * x

The transform runs in kernel K4 (`fp_ntt`, csrc/ntt.cu) over a batch of
rows: bit reversal, then log2(n) butterfly stages with per-stage twiddle
tables computed on the host, a row kept on chip through all of them (one
launch a transform, two where a row does not fit: `ntt_plan`).  K4 has an
instance over Fp128, one over
Fp2 on the P-256 base field and one over the multi-prime field of the
CRT convolution (transforms/crt_conv.py).  Tensors are int32 [..., n,
*F.elt_shape] (fields/fp.py: [..., n, N]; fields/fp2.py: [..., n, 2, N];
fields/multiprime.py: [VS, ..., n, 1], a twiddle table a prime); the
transform runs along the element axis n.

A field without roots of unity of the needed order (P-256's base field)
convolves through Fp2 (FFTExtConvolution): lift to Fp2 with im = 0,
convolve there, take the real part.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..fields.fp import ADD, MUL, SUB, elementwise_plain, route
from ..fields.fp2 import Fp2, fp2_elementwise_plain
from ..fields.multiprime import MultiPrimeField, mp_elementwise_plain


def bitrev_permutation(n: int) -> np.ndarray:
    """Bit-reversal permutation indices (reference algebra/permutations.h)."""
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _plain(F, mode: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if isinstance(F, Fp2):
        return fp2_elementwise_plain(F, mode, a, b)
    if isinstance(F, MultiPrimeField):
        return mp_elementwise_plain(F, mode, a, b)
    return elementwise_plain(F, mode, a, b)


def _lanes(F) -> int:
    """The rows of a transform come in this many lanes, each with its
    own twiddle table: the primes of a multi-prime field, else one."""
    return F.vs if isinstance(F, MultiPrimeField) else 1


def ntt_plain(F, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: x [rows, n, *E] -> its transform under the
    concatenated stage twiddles tw [n - 1, *E] ([VS, n - 1, 1] for a
    multi-prime field, whose rows come lane-major); any device."""
    rows, n, E = x.shape[0], x.shape[1], tuple(F.elt_shape)
    L = _lanes(F)
    x = x.reshape((L, rows // L, n) + E)
    x = x[:, :, torch.as_tensor(bitrev_permutation(n), device=x.device)]
    ax = tw.dim() - len(E) - 1  # tw's element axis
    s = 0
    while (1 << s) < n:
        m = 1 << s
        xr = x.reshape((L, rows // L, n // (2 * m), 2, m) + E)
        lo, hi = xr[:, :, :, 0], xr[:, :, :, 1]
        t = hi if s == 0 else _plain(F, MUL, hi, tw.narrow(ax, m - 1, m))
        x = torch.stack([_plain(F, ADD, lo, t), _plain(F, SUB, lo, t)],
                        dim=3).reshape((L, rows // L, n) + E)
        s += 1
    return x.reshape((rows, n) + E)


# K4's plan (csrc/ntt.cu): threads a block at most; blocks a cluster at
# most; the blocks a launch that the routes spread a batch's rows to (two
# an SM) while a block of route 1 keeps NTT_BLOCK_ELTS elements or more;
# a block's data tiles (bytes) at most; its stage twiddles in shared
# memory up to NTT_TW_SMEM bytes; route 2's tile (bytes, one column or
# row at least): at 2^20 points tiles of 128 KB held one block an SM and
# ran 1.16-1.30x the parent's twenty launches on the H100 (PERF.md
# section 6)
NTT_THREADS = 256
NTT_CS_MAX = 8
NTT_BLOCKS = 264
NTT_BLOCK_ELTS = 256
NTT_SMEM = 192 * 1024
NTT_TW_SMEM = 32 * 1024
NTT_TILE2_BYTES = 32 * 1024


class NttPlan(NamedTuple):
    """How K4 transforms rows of n = 2^logn points: route 1, one launch, a
    row a cluster of 2^la blocks (the n1 x n2 split l1 + l2 = logn, l1 = 0
    for a row a block); route 2, two launches through a scratch, step A
    on 2^la columns a block, step B on 2^lb rows."""
    route: int
    l1: int
    la: int
    lb: int
    threads: int
    tw_smem: bool
    launches: int


def _threads(pairs: int) -> int:
    return min(NTT_THREADS, max(32, pairs))


def ntt_plan(n: int, rows: int, eb: int) -> NttPlan:
    """K4's plan for `rows` rows of n = 2^logn elements of eb bytes:
    route 1 where a cluster of at most NTT_CS_MAX blocks holds a row,
    else route 2 (ntt_plan_two)."""
    logn = n.bit_length() - 1

    def data(lcs):  # a block's tiles: the row, or two of its 2^-lcs parts
        return n * eb if lcs == 0 else (2 * n >> lcs) * eb

    # a cluster splits each half of the n1 x n2 split into its blocks
    top = min(NTT_CS_MAX.bit_length() - 1, logn // 2)
    lcs = 0
    while lcs < top and (data(lcs) > NTT_SMEM or (
            rows << lcs < NTT_BLOCKS and n >> (lcs + 1) >= NTT_BLOCK_ELTS)):
        lcs += 1
    if data(lcs) > NTT_SMEM:
        return ntt_plan_two(n, rows, eb)
    l1 = (logn + 1) // 2 if lcs else 0
    m = 1 << max(l1, logn - l1)
    return NttPlan(1, l1, lcs, 0, _threads(n >> (lcs + 1)),
                   m * eb <= NTT_TW_SMEM, 1)


def ntt_plan_two(n: int, rows: int, eb: int) -> NttPlan:
    """K4's route 2 for rows of n elements of eb bytes: the four-step
    split through a scratch, 2^la columns a block of its first launch and
    2^lb rows of its second, tiles of about NTT_TILE2_BYTES, cut further
    until the launch has NTT_BLOCKS blocks (the route of rows that no
    cluster holds, and at any n the other side of the routes'
    comparison, tools/eq_ntt_bench.py)."""
    logn = n.bit_length() - 1
    l1 = logn // 2
    l2 = logn - l1
    if (1 << max(l1, l2)) * eb > NTT_SMEM:
        raise ValueError("K4 cannot transform rows of %d elements of %d "
                         "bytes" % (n, eb))
    tile = max(1 << max(l1, l2), NTT_TILE2_BYTES // eb)
    la = min(l2, (tile >> l1).bit_length() - 1)
    while la and rows << (l2 - la) < NTT_BLOCKS:
        la -= 1
    lb = min(l1, (tile >> l2).bit_length() - 1)
    while lb and rows << (l1 - lb) < NTT_BLOCKS:
        lb -= 1
    return NttPlan(2, l1, la, lb, _threads(max(1 << (l1 + la),
                                                1 << (lb + l2)) >> 1),
                   (1 << max(l1, l2)) * eb <= NTT_TW_SMEM, 2)


def fp_ntt(F, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """K4 wrapper: transform of every row of x [rows, n, *F.elt_shape],
    n = 2^logn; over a multi-prime field the rows come lane-major, lane b
    with the twiddles tw[b] ([VS, n - 1, 1]).  One launch, or two (a
    scratch of x's size) where a row does not fit a cluster (ntt_plan)."""
    if route("fp_ntt", F, x, tw) is None:
        return ntt_plain(F, x, tw)
    return ntt_run(F, x, tw, ntt_plan)


def ntt_run(F, x: torch.Tensor, tw: torch.Tensor, planner) -> torch.Tensor:
    """K4 on CUDA tensors by the plan planner(n, rows, eb) makes (fp_ntt's
    ntt_plan; ntt_plan_two for the routes' comparison)."""
    name = route("fp_ntt", F, x, tw)
    if name is None:
        raise ValueError("ntt_run launches K4: CUDA tensors only")
    rows, n, E = x.shape[0], x.shape[1], tuple(F.elt_shape)
    logn = n.bit_length() - 1
    L = _lanes(F)
    if x.dtype != torch.int32 or tuple(x.shape[2:]) != E or \
            n != 1 << logn or rows % L or \
            tw.numel() != L * (n - 1) * int(np.prod(E)):
        raise ValueError("fp_ntt takes int32 [rows, 2^k, %s] and 2^k - 1 "
                         "twiddles a lane, got %s" % (E, tuple(x.shape)))
    if logn == 0:
        return x.clone()
    x = x.contiguous()
    tw = tw.contiguous()
    y = torch.empty_like(x)
    p = planner(n, rows, 4 * int(np.prod(E)))
    z = torch.empty_like(x) if p.route == 2 else None
    kernels.launch(name, p.launches, y.data_ptr(), x.data_ptr(),
                   tw.data_ptr(), 0 if z is None else z.data_ptr(), rows,
                   logn, rows // L, p.route, p.l1, p.la, p.lb, p.threads,
                   int(p.tw_smem))
    return y


class NTT:
    """Radix-2 NTT for a field with host scalars (PrimeField or Fp2)."""

    def __init__(self, F, omega, omega_order: int, device=None):
        self.F = F
        self.omega = omega
        self.omega_order = omega_order
        self.device = resolve_device(device)
        self._tw: Dict[Tuple[int, bool], torch.Tensor] = {}

    def _root_of_order(self, n: int, inverse: bool):
        """omega^(order/n), optionally inverted (Twiddle::reroot)."""
        F = self.F
        assert self.omega_order % n == 0
        w = _pow(F, self.omega, self.omega_order // n)
        if inverse:
            w = F.inv_i(w)
        return w

    def twiddles(self, n: int, inverse: bool) -> torch.Tensor:
        """The per-stage twiddle tables for size n, concatenated: stage s
        (half-size m = 2^s) holds wm^0..wm^(m-1) at [m - 1, 2m - 1)."""
        key = (n, inverse)
        if key not in self._tw:
            F = self.F
            w = self._root_of_order(n, inverse)
            tws: List[int] = []
            m = 2
            while m <= n:
                wm = _pow(F, w, n // m)  # primitive m-th root
                cur = F.of_scalar(1)
                for _ in range(m // 2):
                    tws.append(cur)
                    cur = F.mul_i(cur, wm)
                m *= 2
            self._tw[key] = F.to_limbs(tws, self.device)
        return self._tw[key]

    def prepare(self, n: int) -> None:
        """Uploads the twiddles of size n, both directions."""
        for inverse in (False, True):
            self.twiddles(n, inverse)

    def _transform(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """Transform along the element axis of x [..., n, *E]."""
        E = tuple(self.F.elt_shape)
        ax = x.dim() - len(E) - 1
        n = x.shape[ax]
        if n == 1:
            return x
        assert n & (n - 1) == 0, "length must be a power of 2"
        y = fp_ntt(self.F, x.reshape((-1, n) + E), self.twiddles(n, inverse))
        return y.reshape(x.shape)

    def fftb(self, x: torch.Tensor) -> torch.Tensor:
        """Backward FFT: T[j] = sum_k F[k] W^{jk} (fft.h:185)."""
        return self._transform(x, inverse=False)

    def fftf(self, x: torch.Tensor) -> torch.Tensor:
        """Forward FFT: uses W^{-1} (fft.h:198-201)."""
        return self._transform(x, inverse=True)


def _pow(F, base, e: int):
    r = F.of_scalar(1)
    b = base
    while e:
        if e & 1:
            r = F.mul_i(r, b)
        b = F.mul_i(b, b)
        e >>= 1
    return r


def _choose_padding(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _host_fft(F, a: List, w) -> List:
    """Simple host radix-2 backward FFT with root w (for y preprocessing)."""
    n = len(a)
    if n == 1:
        return list(a)
    even = _host_fft(F, a[0::2], F.mul_i(w, w))
    odd = _host_fft(F, a[1::2], F.mul_i(w, w))
    out = [None] * n
    wk = F.of_scalar(1)
    for k in range(n // 2):
        t = F.mul_i(wk, odd[k])
        out[k] = F.add_i(even[k], t)
        out[k + n // 2] = F.sub_i(even[k], t)
        wk = F.mul_i(wk, w)
    return out


class FFTConvolution:
    """Cyclic convolution via NTT (reference convolution.h:55-106).

    z[k] = sum_i x[i] y[k-i] (cyclically over the pow2 padding), first m
    entries returned.  y is fixed at construction (its transform is
    precomputed on the host); x is batched over leading axes.  The
    transforms of x run in ntt_impl (fftf / fftb, e.g. the matmul NTT of
    transforms/matmul_ntt.py) when given, else in the radix-2 NTT (K4).
    """

    def __init__(self, n: int, m: int, F, omega, omega_order: int,
                 y: Sequence, device=None, ntt_impl=None):
        self.F = F
        self.n = n
        self.m = m
        self.device = resolve_device(device)
        self.padding = _choose_padding(m)
        host_ntt = NTT(F, omega, omega_order, self.device)
        self.ntt = ntt_impl if ntt_impl is not None else host_ntt
        # host-side forward transform of padded y, scaled by 1/padding
        y_pad = list(y) + [F.of_scalar(0)] * (self.padding - len(y))
        yhat = _host_fft(F, y_pad, host_ntt._root_of_order(self.padding, True))
        inv_pad = F.inv_i(F.of_scalar(self.padding))
        self._yhat = F.to_limbs([F.mul_i(v, inv_pad) for v in yhat],
                                self.device)
        # the transforms' tables too: every upload at construction, so
        # that an encode waits on nothing (the ZK prover's dot test runs
        # between its first round and its one fetch)
        self.ntt.prepare(self.padding)

    def convolution(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., n, *E] -> z: [..., m, *E]."""
        E = tuple(self.F.elt_shape)
        ax = x.dim() - len(E) - 1
        assert x.shape[ax] == self.n
        pad = x.new_zeros(x.shape[:ax] + (self.padding - self.n,) + E)
        xhat = self.ntt.fftf(torch.cat([x, pad], dim=ax))
        z = self.ntt.fftb(self.F.mul(xhat, self._yhat))
        return z.narrow(ax, 0, self.m)


class ReedSolomon:
    """RS "extend" encoder over a prime field (reference reed_solomon.h:44).

    Given evaluations of a degree <n polynomial at 0..n-1 (along the
    element axis), computes evaluations at n..m-1, batched over leading
    axes: the Ligero tableau encode is one call with rows stacked.
    """

    def __init__(self, n: int, m: int, F, conv_factory, device=None):
        self.F = F
        self.n = n
        self.m = m
        self.device = resolve_device(device)
        d = n - 1  # degree bound
        # inverses[i] = 1/i (i>=1), cf. batch_inverse_arithmetic
        inverses = [_of_int(F, 0)] + [F.inv_i(_of_int(F, i))
                                      for i in range(1, m)]
        # y kernel for the convolution: y[k] = 1/k with y[0] = 0
        self.conv = conv_factory(n, m, inverses)
        # binom_i[i] = (-1)^i C(d, i)
        binom = [F.of_scalar(1)]
        for i in range(1, n):
            binom.append(F.mul_i(binom[-1],
                                 F.mul_i(_of_int(F, n - i), inverses[i])))
        for i in range(1, n, 2):
            binom[i] = F.neg_i(binom[i])
        self._binom = F.to_limbs(binom, self.device)
        # leading_constant_[i] = C(i+d, d) * (-1)^d * i  for i in [0, m-n)
        lead = [F.of_scalar(1)]
        for i in range(1, m - d):
            lead.append(F.mul_i(lead[-1],
                                F.mul_i(_of_int(F, d + i), inverses[i])))
        for k in range(d, m):
            lead[k - d] = F.mul_i(lead[k - d], _of_int(F, k - d))
            if d % 2 == 1:
                lead[k - d] = F.neg_i(lead[k - d])
        # out[i] = lead[i - d] * T[i] for i in [n, m)
        self._lead_tail = F.to_limbs(lead[n - d : m - d], self.device)

    def interpolate(self, y: torch.Tensor) -> torch.Tensor:
        """y: [..., n, N] -> [..., m, N]."""
        F = self.F
        T = self.conv.convolution(F.mul(y, self._binom))
        tail = F.mul(T[..., self.n :, :].contiguous(), self._lead_tail)
        return torch.cat([y, tail], dim=-2)


def _of_int(F, i: int):
    """of_scalar for values possibly >= p (reduce mod field order)."""
    return F.of_scalar(i % F.p)


def make_fft_convolution_factory(F, omega, omega_order: int, device=None,
                                 ntt_impl=None):
    dev = resolve_device(device)

    def factory(n, m, y):
        return FFTConvolution(n, m, F, omega, omega_order, y, dev, ntt_impl)

    return factory


class FFTExtConvolution:
    """Convolution of base-field data via the Fp2 extension
    (reference convolution.h:128-191), as the JAX package computes it:
    lift into Fp2 with im = 0, convolve there, take the real part."""

    def __init__(self, n: int, m: int, Fbase, F2, omega2, omega_order: int,
                 y: Sequence, device=None):
        self.Fb = Fbase
        self.F2 = F2
        self.inner = FFTConvolution(n, m, F2, omega2, omega_order,
                                    [(v, 0) for v in y], device)

    def convolution(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., n, N] base field -> [..., m, N] base field."""
        x2 = torch.stack([x, torch.zeros_like(x)], dim=-2)
        return self.inner.convolution(x2)[..., 0, :].contiguous()


def make_fft_ext_convolution_factory(Fbase, F2, omega2, omega_order: int,
                                     device=None):
    dev = resolve_device(device)

    def factory(n, m, y):
        return FFTExtConvolution(n, m, Fbase, F2, omega2, omega_order, y,
                                 dev)

    return factory
