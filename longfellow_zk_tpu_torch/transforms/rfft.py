"""Real (base-field) FFT in half-complex storage over Fp2, and the
half-complex convolution of base-field rows.

Port of the JAX package's transforms/rfft.py, the capability twin of the
reference lib/algebra/rfft.h:47-459.  The transform of a "real"
(base-field) row is conjugate-symmetric, so it fits in n base elements
in the FFTW half-complex layout

    HC[j] = re F[j] for 2 j <= n, else im F[n - j].

n real elements go through an n/2-point Fp2 NTT (K4 `fp_ntt[fp256x2]`)
as n/2 complex ones: in the port's layout [..., n, N] the even/odd
packing of r2hc is a free view as [..., n/2, 2, N] (re = even, im = odd),
and so is the interleave of re and im at the end of hc2r.  The passes
around the NTT are kernel K18 `rfft_pass[fp256x2]` (csrc/rfft.cu), one
kernel with three modes:

  split   r2hc after the forward NTT: E = (Z + conj Z[-j]) / 2,
          O = (Z - conj Z[-j]) (-i/2), F_j = E + w^-j O, F_h = E_0 - O_0,
          written in the half-complex layout;
  merge   hc2r before the backward NTT: Z_j = E + i w^j D from F_j and
          conj F_{h-j};
  hc_mul  the pointwise product of two half-complex spectra.

hc2r's final factor 2 is a K1 add.  The constants (1/2 and the tables
w^-j, w^j) are uploaded when a size is first prepared.  For CPU tensors
the plain versions below take the kernel's place.  Requires omega on the
unit circle (omega conj(omega) = 1), as the reference (rfft.h:52-57).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .. import kernels
from ..device import resolve_device
from ..fields.fp import ADD, MUL, SUB, check_elts, elementwise_plain, route
from ..fields.fp2 import MUL_BASE, fp2_elementwise_plain
from .ntt import NTT, _choose_padding, _pow

# K18 modes (csrc/rfft.cu)
SPLIT, MERGE, HC_MUL = 0, 1, 2


def _conj_plain(F2, a: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(a[..., 1, :])
    return torch.stack([a[..., 0, :], elementwise_plain(F2.f, SUB, zero,
                                                        a[..., 1, :])], -2)


def _hc_to_F(F2, hc: torch.Tensor) -> torch.Tensor:
    """Half-complex [rows, n, N] -> F_j (j in [0, h]) as Fp2 [rows, h + 1,
    2, N]: re hc[j], im hc[n - j] (0 at j = 0 and j = h)."""
    h = hc.shape[-2] // 2
    zero = torch.zeros_like(hc[..., :1, :])
    im = torch.cat([zero, hc[..., h + 1 :, :].flip(-2), zero], dim=-2)
    return torch.stack([hc[..., : h + 1, :], im], dim=-2)


def _F_to_hc(Fj: torch.Tensor, Fh_re: torch.Tensor) -> torch.Tensor:
    """F_j (j in [0, h), Fp2 [rows, h, 2, N]) and re F_h [rows, 1, N] ->
    half-complex [rows, 2 h, N]."""
    return torch.cat([Fj[..., 0, :], Fh_re, Fj[..., 1:, 1, :].flip(-2)],
                     dim=-2)


def rfft_pass_plain(F2, mode: int, a: torch.Tensor, b, tab,
                    inv2) -> torch.Tensor:
    """Plain version of K18 (the JAX package's RFFT formulas, on the plain
    field ops); any device.  split: a = Z [rows, h, 2, N] -> HC [rows, 2 h,
    N] with tab = w^-j; merge: a = HC [rows, n, N] -> Z [rows, h, 2, N] with
    tab = w^j; hc_mul: a, b [rows or 1, n, N] -> HC [rows, n, N]."""
    Fb = F2.f

    def f2(m, x, y):
        return fp2_elementwise_plain(F2, m, x, y)

    if mode == SPLIT:
        h = a.shape[-3]
        idx = (h - torch.arange(h, device=a.device)) % h
        Zr = _conj_plain(F2, a[:, idx])
        E = f2(MUL_BASE, f2(ADD, a, Zr), inv2)
        D = f2(MUL_BASE, f2(SUB, a, Zr), inv2)
        # O = (Z - Zr) (-i / 2): re = im D, im = -re D
        O = torch.stack([D[..., 1, :], elementwise_plain(
            Fb, SUB, torch.zeros_like(D[..., 0, :]), D[..., 0, :])], -2)
        Fj = f2(ADD, E, f2(MUL, tab, O))
        Fh = elementwise_plain(Fb, SUB, E[:, :1, 0, :], O[:, :1, 0, :])
        return _F_to_hc(Fj, Fh)
    if mode == MERGE:
        h = a.shape[-2] // 2
        Fj = _hc_to_F(F2, a)
        Fr = _conj_plain(F2, Fj.flip(-3))
        E = f2(MUL_BASE, f2(ADD, Fj[:, :h], Fr[:, :h]), inv2)
        D = f2(MUL_BASE, f2(SUB, Fj[:, :h], Fr[:, :h]), inv2)
        O = f2(MUL, tab, D)
        iO = torch.stack([elementwise_plain(
            Fb, SUB, torch.zeros_like(O[..., 1, :]), O[..., 1, :]),
            O[..., 0, :]], -2)
        return f2(ADD, E, iO)
    h = a.shape[-2] // 2
    P = f2(MUL, _hc_to_F(F2, a), _hc_to_F(F2, b))
    return _F_to_hc(P[:, :h], P[:, h : h + 1, 0, :])


def rfft_pass(F2, mode: int, a: torch.Tensor, b, tab, inv2) -> torch.Tensor:
    """K18 wrapper (see rfft_pass_plain for the modes and shapes); in
    hc_mul b's rows are a's or one row broadcast over them, and tab and
    inv2 are None."""
    name = route("rfft_pass", F2,
                 *[t for t in (a, b, tab, inv2) if t is not None])
    if name is None:
        return rfft_pass_plain(F2, mode, a, b, tab, inv2)
    N = F2.nlimb
    if mode == SPLIT:
        check_elts(a, "Z", F2.elt_shape)
        rows, h = a.shape[0], a.shape[1]
        n = 2 * h
        out = torch.empty((rows, n, N), dtype=torch.int32, device=a.device)
    else:
        check_elts(a, "HC", F2.f.elt_shape)
        rows, n = a.shape[0], a.shape[1]
        h = n // 2
        out = torch.empty((rows, h, 2, N) if mode == MERGE else (rows, n, N),
                          dtype=torch.int32, device=a.device)
    brows = 1
    if mode == HC_MUL:
        check_elts(b, "b", F2.f.elt_shape)
        brows = b.shape[0]
        if b.shape[1:] != a.shape[1:] or brows not in (1, rows):
            raise ValueError("hc_mul takes b of a's rows or of one row")
    else:
        if tab.numel() != h * 2 * N:
            raise ValueError("rfft_pass takes a table of n / 2 Fp2 "
                             "elements")
        check_elts(inv2, "inv2", F2.f.elt_shape)
    if n < 2 or n & (n - 1):
        raise ValueError("rfft_pass takes 2^k >= 2 points, got %d" % n)
    ptrs = [0 if t is None else t.data_ptr() for t in (b, tab, inv2)]
    kernels.launch(name, 1, mode, out.data_ptr(), a.data_ptr(), *ptrs, rows,
                   n, brows)
    return out


class RFFT:
    """r2hc / hc2r / hc_mul along the element axis of base-field rows
    [..., n, N] over the Fp2 of F2 with root omega2 (P-256)."""

    def __init__(self, F2, omega2, omega_order: int, device=None):
        self.F2 = F2
        self.Fb = F2.f
        self.omega = omega2
        self.omega_order = omega_order
        self.device = resolve_device(device)
        self.ntt2 = NTT(F2, omega2, omega_order, self.device)
        conj = (omega2[0], self.Fb.neg_i(omega2[1]))
        assert F2.mul_i(omega2, conj) == F2.of_scalar(1), \
            "root of unity not on the unit circle"
        self._w: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.inv2 = self.Fb.to_limbs(self.Fb.inv_i(2), self.device)

    def w_tables(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """w_n^-j and w_n^j for j in [0, n/2), Fp2 [n/2, 2, N] each."""
        if n not in self._w:
            F2 = self.F2
            w = _pow(F2, self.omega, self.omega_order // n)
            winv = F2.inv_i(w)
            fw, bw = [], []
            cf = cb = F2.of_scalar(1)
            for _ in range(n // 2):
                fw.append(cf)
                bw.append(cb)
                cf = F2.mul_i(cf, winv)
                cb = F2.mul_i(cb, w)
            self._w[n] = (F2.to_limbs(fw, self.device),
                          F2.to_limbs(bw, self.device))
        return self._w[n]

    def prepare(self, n: int) -> None:
        """Uploads the tables of size n (and of its NTT)."""
        self.w_tables(n)
        self.ntt2.prepare(n // 2)

    def r2hc(self, x: torch.Tensor) -> torch.Tensor:
        """Real [..., n, N] -> half-complex [..., n, N] (the forward
        transform, minus sign; rfft.h R2HC)."""
        n, N = x.shape[-2], x.shape[-1]
        assert n >= 2 and n & (n - 1) == 0
        z = x.reshape((-1, n // 2, 2, N))
        Z = self.ntt2.fftf(z)
        hc = rfft_pass(self.F2, SPLIT, Z.contiguous(), None,
                       self.w_tables(n)[0], self.inv2)
        return hc.reshape(x.shape)

    def hc2r(self, hc: torch.Tensor) -> torch.Tensor:
        """Half-complex -> n * real (backward; hc2r(r2hc(x)) == n x)."""
        n, N = hc.shape[-2], hc.shape[-1]
        Z = rfft_pass(self.F2, MERGE, hc.reshape(-1, n, N).contiguous(),
                      None, self.w_tables(n)[1], self.inv2)
        z = self.ntt2.fftb(Z).reshape(hc.shape)  # h z; re even, im odd
        return self.Fb.add(z, z)

    def hc_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Pointwise product of two half-complex spectra; b may be one row
        [n, N], broadcast over a's rows."""
        n, N = a.shape[-2], a.shape[-1]
        out = rfft_pass(self.F2, HC_MUL, a.reshape(-1, n, N).contiguous(),
                        b.reshape(-1, n, N).contiguous(), None, None)
        return out.reshape(a.shape)


class RFFTExtConvolution:
    """Half-complex convolver of base-field rows via Fp2 (the RFFT
    realization of the reference FFTExtConvolution, convolution.h:128-191):
    half the storage and transform work of the full Fp2 lift."""

    def __init__(self, n: int, m: int, Fbase, F2, omega2, omega_order: int,
                 y: Sequence, device=None):
        self.Fb = Fbase
        self.n = n
        self.m = m
        self.device = resolve_device(device)
        self.rfft = RFFT(F2, omega2, omega_order, self.device)
        self.padding = _choose_padding(m)
        self.rfft.prepare(self.padding)
        inv_pad = Fbase.inv_i(Fbase.of_scalar(self.padding))
        y_pad = [Fbase.mul_i(v, inv_pad) for v in y] + \
            [0] * (self.padding - len(y))
        self._hy = self.rfft.r2hc(Fbase.to_limbs(y_pad, self.device))

    def convolution(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., n, N] base field -> [..., m, N]."""
        assert x.shape[-2] == self.n
        pad = x.new_zeros(x.shape[:-2] + (self.padding - self.n,
                                          x.shape[-1]))
        hx = self.rfft.r2hc(torch.cat([x, pad], dim=-2))
        # hz = FFT(conv) / P (1/P folded into hy); hc2r returns P (.)
        z = self.rfft.hc2r(self.rfft.hc_mul(hx, self._hy))
        return z[..., : self.m, :]


def make_rfft_ext_convolution_factory(Fbase, F2, omega2, omega_order: int,
                                      device=None):
    dev = resolve_device(device)

    def factory(n, m, y):
        return RFFTExtConvolution(n, m, Fbase, F2, omega2, omega_order, y,
                                  dev)

    return factory
