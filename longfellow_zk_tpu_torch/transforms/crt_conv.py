"""CRT convolution: the NTT convolution of a prime field without large
2-adic roots of unity (secp256k1, P-384, P-521), through residues over a
basis of NTT-friendly 32-bit primes (fields/multiprime.py).

Port of the JAX package's transforms/crt_conv.py, the semantic twin of
the reference CRTConvolution (lib/algebra/crt_convolution.h:32-103 +
crt.h).  A convolution of target-field rows runs in three steps:

  to_crt     K13 `crt_to[<field>]`: the natural value x of each element
             to its VS residues x mod p_b (Montgomery, [VS, ..., 1]);
  convolve   FFTConvolution over the multi-prime field: K4 `fp_ntt[crt]`
             forward, K14 `mp_elementwise[crt]` by the transform of the
             fixed kernel, K4 backward (every lane with its own prime);
  from_crt   K15 `crt_from[<field>]`: Garner's mixed-radix digits of the
             residues, then x = sum_j v_j * prod_{k<j} p_k in the target
             field.

Each coefficient of the integer convolution is below n p^2 < prod p_b
(basis_size_for), so Garner recovers it exactly.  The constants of the
three steps are uploaded when a context is made; a convolution uploads
nothing and reads nothing back.  For CPU tensors the plain versions
below (int64) take the kernels' places.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..fields.fp import (ADD, MUL, check_elts, elementwise_plain, route)
from ..fields.multiprime import (MultiPrimeField, basis_size_for, modmul,
                                 mont_plain, words32, words64)
from .ntt import FFTConvolution, _choose_padding


def _words(vals, nwords: int) -> np.ndarray:
    """Nonnegative ints -> int32 [len(vals), nwords] little-endian words."""
    buf = b"".join(int(v).to_bytes(4 * nwords, "little") for v in vals)
    return np.frombuffer(buf, dtype="<i4").reshape(len(vals), nwords).copy()


class CRTContext:
    """Per-(target field, basis) constants on one device, shared by the
    convolvers of a Reed-Solomon factory."""

    def __init__(self, F, device=None):
        self.F = F
        self.device = dev = resolve_device(device)
        vs = basis_size_for(F.bits)
        self.mp = mp = MultiPrimeField(vs)
        N = F.nlimb
        # K13: C[i, b] = 2^(32 i) 2^64 mod p_b, a Montgomery operand
        self.ci = torch.from_numpy(_words(
            [((1 << (32 * i)) << 64) % p for i in range(N)
             for p in mp.primes], 1).reshape(-1)).to(dev)
        # K15: gar[j - 1, i] = p_{j-1}^-1 2^32 mod p_i for i >= j
        gar = np.zeros((vs, vs), dtype=object)
        for j in range(1, vs):
            for i in range(j, vs):
                pi = mp.primes[i]
                gar[j - 1, i] = (pow(mp.primes[j - 1], -1, pi) << 32) % pi
        self.gar = torch.from_numpy(_words(gar.reshape(-1), 1).reshape(
            -1)).to(dev)
        # K15: G_j = (prod_{k<j} p_k) R^2 mod p, as the raw words of a
        # Montgomery operand
        gs, g = [], 1
        for j in range(vs):
            gs.append(g * F.R * F.R % F.p)
            g = g * mp.primes[j] % F.p
        self.G = torch.from_numpy(_words(gs, N)).to(dev)

    def to_crt(self, x: torch.Tensor) -> torch.Tensor:
        """Target-field elements x [..., N] (Montgomery) -> their residues
        [VS, ..., 1] (Montgomery)."""
        F, vs = self.F, self.mp.vs
        name = route("crt_to", F, x, self.ci)
        if name is None:
            return to_crt_plain(self, x)
        check_elts(x, "x", F.elt_shape)
        out = torch.empty((vs,) + tuple(x.shape[:-1]) + (1,),
                          dtype=torch.int32, device=x.device)
        kernels.launch(name, 1, out.data_ptr(), x.data_ptr(),
                       self.ci.data_ptr(), x.numel() // F.nlimb, vs)
        return out

    def from_crt(self, z: torch.Tensor) -> torch.Tensor:
        """Residues z [VS, ..., 1] (Montgomery) -> the target-field
        elements [..., N] (Montgomery) they stand for."""
        F, vs = self.F, self.mp.vs
        name = route("crt_from", F, z, self.gar)
        if name is None:
            return from_crt_plain(self, z)
        if z.dtype != torch.int32 or z.shape[0] != vs or z.shape[-1] != 1:
            raise ValueError("from_crt takes int32 [VS, ..., 1] residues, "
                             "got %s" % (tuple(z.shape),))
        z = z.contiguous()
        out = torch.empty(tuple(z.shape[1:-1]) + F.elt_shape,
                          dtype=torch.int32, device=z.device)
        kernels.launch(name, 1, out.data_ptr(), z.data_ptr(),
                       self.gar.data_ptr(), self.G.data_ptr(),
                       z.numel() // vs, vs)
        return out


def to_crt_plain(ctx: CRTContext, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K13: the natural words w_i of x, then per lane
    sum_i mont(w_i, C[i, b]) mod p_b; any device."""
    F, mp = ctx.F, ctx.mp
    one = torch.zeros(F.nlimb, dtype=torch.int32, device=x.device)
    one[0] = 1
    w = words64(elementwise_plain(F, MUL, x, one))         # [..., N]
    p, rinv = mp.lane_consts(x.device)
    shape = (mp.vs,) + (1,) * (x.dim() - 1)
    c = words64(ctx.ci).reshape(F.nlimb, mp.vs).T.reshape(shape + (F.nlimb,))
    acc = mont_plain(w[None], c, p.reshape(shape + (1,)),
                     rinv.reshape(shape + (1,))).sum(dim=-1)
    return words32(acc % p.reshape(shape))[..., None]


def from_crt_plain(ctx: CRTContext, z: torch.Tensor) -> torch.Tensor:
    """Plain version of K15: the natural residues, Garner's digits, then
    sum_j v_j * prod_{k<j} p_k in the target field (one Montgomery
    product by G_j each); any device."""
    F, mp = ctx.F, ctx.mp
    p, rinv = mp.lane_consts(z.device)
    shape = (mp.vs,) + (1,) * (z.dim() - 2)
    v = list(modmul(words64(z[..., 0]), rinv.reshape(shape),
                    p.reshape(shape)).unbind(0))
    gar = words64(ctx.gar).reshape(mp.vs, mp.vs)
    for j in range(1, mp.vs):
        for i in range(j, mp.vs):
            pi = mp.primes[i]
            v[i] = mont_plain((v[i] - v[j - 1]) % pi, gar[j - 1, i], pi,
                              rinv[i])
    acc = None
    for j in range(mp.vs):
        d = torch.zeros(v[j].shape + F.elt_shape, dtype=torch.int32,
                        device=z.device)
        d[..., 0] = words32(v[j])
        t = elementwise_plain(F, MUL, d, ctx.G[j])
        acc = t if acc is None else elementwise_plain(F, ADD, acc, t)
    return acc


class CRTConvolution:
    """Drop-in convolver for ReedSolomon over root-poor fields
    (crt_convolution.h:32-103)."""

    def __init__(self, n: int, m: int, ctx: CRTContext, y: Sequence):
        self.ctx = ctx
        self.F = ctx.F
        self.n = n
        self.m = m
        mp = ctx.mp
        assert _choose_padding(m) <= mp.omega_order
        y_crt = [mp.of_scalar(int(v)) for v in y]
        self.inner = FFTConvolution(n, m, mp, mp.omegas, mp.omega_order,
                                    y_crt, ctx.device)

    def convolution(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., n, N] target field -> [..., m, N]."""
        return self.ctx.from_crt(self.inner.convolution(self.ctx.to_crt(x)))


def make_crt_convolution_factory(F, device=None):
    ctx = CRTContext(F, device=device)

    def factory(n, m, y):
        return CRTConvolution(n, m, ctx, y)

    return factory
