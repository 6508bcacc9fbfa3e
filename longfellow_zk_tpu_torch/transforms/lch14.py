"""LCH14 additive FFT over GF(2^128) and the Reed-Solomon encoder of the
hash half: kernel K6 `gf2_lch14`.

Port of the JAX package's transforms/lch14.py (semantic twin of the
reference lib/gf2k/lch14.h:36-238 and lch14_reed_solomon.h:29-110): FFT
and IFFT over the novel polynomial basis on cosets of the subfield
domain, the bidirectional (truncated) FFT, and the "extend" encoder
built from them.

What is computed, not how the TPU computed it.  The JAX package applies
each butterfly stage as one int8 parity matmul (a product by a constant
is GF(2)-linear in the bits).  Here a butterfly is

    forward   lo ^= tw * hi;  hi ^= lo
    backward  hi ^= lo;       lo ^= tw * hi
    diagonal  hi ^= lo and lo ^= tw * hi (old hi), together

with the general GF(2^128) product.  The recursion of `_bidir` depends
only on (n, k), so the host flattens a transform once into a schedule:
passes of independent butterflies (lo, hi, twiddle index), each pass of
one kind, and a table of the twiddles `LCH14.twiddle(i, u)`.  K6 runs a
schedule with one CTA per tableau row, the row in shared memory through
every pass (csrc/lch14.cu); its plain version runs the same schedule on
tensors.  Elements are int32 [..., 4] words (fields/gf2.py).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .. import kernels
from ..device import resolve_device
from ..fields.fp import check_elts, route
from ..fields.gf2 import gf_mul_int, mul_plain

FWD, BWD, DIAG = 0, 1, 2
# K6 modes: transform one row in place; the Reed-Solomon extend
TRANSFORM, EXTEND = 0, 1
# K6 holds (1 + ncos) * fftn elements of a row in shared memory (227 KB)
_SMEM_MAX_ELTS = 232448 // 16


class Schedule:
    """A flattened transform: butterflies int32 [nbf, 4] (lo, hi,
    twiddle index, 0), twiddles int32 [ntw, 4], passes int32 [npass, 4]
    (first butterfly, end, kind, 0); the first `nfirst` passes run on
    positions [0, fftn), the rest (the coset FFTs of the extend) after
    the coefficients are copied to the `ncos` segments that follow."""

    def __init__(self, F, fftn: int, passes: List, nfirst: int, ncos: int,
                 device):
        tw_index = {}
        bfs, prs = [], []
        for kind, bf in passes:
            if not bf:
                continue
            prs.append((len(bfs), len(bfs) + len(bf), kind, 0))
            for lo, hi, tw in bf:
                bfs.append((lo, hi, tw_index.setdefault(tw, len(tw_index)),
                            0))
        self.nfirst = sum(1 for kind, bf in passes[:nfirst] if bf)
        self.fftn, self.ncos = fftn, ncos
        self.bf = torch.tensor(bfs, dtype=torch.int32,
                               device=device).reshape(-1, 4)
        self.tw = F.to_limbs(list(tw_index), device).reshape(-1, 4)
        self.passes = torch.tensor(prs, dtype=torch.int32,
                                   device=device).reshape(-1, 4)
        self.pass_list = prs  # the passes on the host (plain version)


class LCH14:
    """The transform's constants and schedules (lch14.h:36-104)."""

    def __init__(self, F):
        self.F = F
        k = F.kSubFieldBits
        # W_0(X) = X on the basis; W_{i+1}(X) = W_i(X)(W_i(X) + W_i(beta_i))
        W = [[0] * k for _ in range(k)]
        for j in range(k):
            W[0][j] = F.beta[j]
        for i in range(k - 1):
            for j in range(k):
                W[i + 1][j] = gf_mul_int(W[i][j], W[i][j] ^ W[i][i])
        self.w_hat = [[0] * k for _ in range(k)]
        for i in range(k):
            scale = F.inv_i(W[i][i])
            for j in range(k):
                self.w_hat[i][j] = gf_mul_int(scale, W[i][j])

    def twiddle(self, i: int, u: int) -> int:
        """The twiddle of stage i at u (lch14.h:81-89)."""
        t, k = 0, 0
        while u:
            if u & 1:
                t ^= self.w_hat[i][k]
            u >>= 1
            k += 1
        return t

    # -- flattening: lists of (kind, [(lo, hi, twiddle)]) ---------------

    def _stages(self, off: int, l: int, coset: int, forward: bool) -> List:
        """The passes of an FFT (forward) or IFFT over [off, off + 2^l)
        on `coset` (lch14.h:106-144)."""
        out = []
        for i in (reversed(range(l)) if forward else range(l)):
            s = 1 << i
            bf = []
            for g in range(1 << (l - 1 - i)):
                tw = self.twiddle(i, coset ^ (g << (i + 1)))
                base = off + 2 * s * g
                bf.extend((base + j, base + j + s, tw) for j in range(s))
            out.append((FWD if forward else BWD, bf))
        return out

    @staticmethod
    def _butterflies(off: int, a: int, b: int, s: int, tw: int,
                     kind: int) -> Tuple:
        return (kind, [(off + uv, off + uv + s, tw) for uv in range(a, b)])

    def _bidir(self, off: int, i: int, coset: int, k: int) -> List:
        """The passes of the bidirectional FFT (lch14.h:146-217)."""
        if i == 0:
            return []
        i -= 1
        s = 1 << i
        tw0 = self.twiddle(i, coset)
        if k < s:
            return ([self._butterflies(off, k, s, s, tw0, FWD)]
                    + self._bidir(off, i, coset, k)
                    + [self._butterflies(off, 0, k, s, tw0, DIAG)]
                    + self._stages(off + s, i, coset + s, True))
        return (self._stages(off, i, coset, False)
                + [self._butterflies(off, k - s, s, s, tw0, DIAG)]
                + self._bidir(off + s, i, coset + s, k - s)
                + [self._butterflies(off, 0, k - s, s, tw0, BWD)])

    # -- transforms of x [..., n, 4] along the element axis --------------

    def _run(self, x: torch.Tensor, passes: List) -> torch.Tensor:
        n = x.shape[-2]
        sched = Schedule(self.F, n, passes, len(passes), 0, x.device)
        rows = x.reshape(-1, n, 4)
        return gf2_lch14(self.F, TRANSFORM, rows, sched, n).reshape(x.shape)

    @staticmethod
    def _log2(n: int) -> int:
        l = n.bit_length() - 1
        assert 1 << l == n and l <= 16
        return l

    def fft(self, B: torch.Tensor, coset: int = 0) -> torch.Tensor:
        """Basis coefficients -> values on the coset."""
        return self._run(B, self._stages(0, self._log2(B.shape[-2]), coset,
                                         True))

    def ifft(self, B: torch.Tensor, coset: int = 0) -> torch.Tensor:
        """Values on the coset -> basis coefficients."""
        return self._run(B, self._stages(0, self._log2(B.shape[-2]), coset,
                                         False))

    def bidirectional_fft(self, B: torch.Tensor, k: int) -> torch.Tensor:
        """B[..., :k] holds evaluations and B[..., k:] (zero) coefficients;
        on output [:k] holds coefficients and [k:] the missing
        evaluations."""
        return self._run(B, self._bidir(0, self._log2(B.shape[-2]), 0, k))


class LCH14ReedSolomon:
    """RS "extend" over GF(2^128) (lch14_reed_solomon.h:29-110): the
    values at of_scalar(0..n-1) of a polynomial of degree < n, to its
    values at of_scalar(0..m-1), batched over leading axes."""

    def __init__(self, n: int, m: int, F, device=None):
        self.F, self.n, self.m = F, n, m
        self.device = resolve_device(device)
        self.fft = LCH14(F)
        l, fftn = 0, 1
        while fftn < n:
            fftn <<= 1
            l += 1
        # the bidirectional FFT, then the FFTs of the remaining cosets,
        # stage by stage over all cosets at once
        first = self.fft._bidir(0, l, 0, n)
        ncos = 0
        while ((ncos + 1) << l) < m:
            ncos += 1
        assert (1 + ncos) * fftn <= _SMEM_MAX_ELTS
        per = [self.fft._stages(c * fftn, l, c << l, True)
               for c in range(1, ncos + 1)]
        rest = [(FWD, [b for p in per for b in p[i][1]])
                for i in range(l)] if ncos else []
        self.sched = Schedule(F, fftn, first + rest, len(first), ncos,
                              self.device)

    def interpolate(self, y: torch.Tensor) -> torch.Tensor:
        """y [..., n, 4] -> [..., m, 4]; the first n values are y."""
        assert y.shape[-2] == self.n
        rows = y.reshape(-1, self.n, 4)
        out = gf2_lch14(self.F, EXTEND, rows, self.sched, self.m)
        return out.reshape(y.shape[:-2] + (self.m, 4))


# ----------------------------------------------------------------------
# K6: the kernel for a CUDA tensor, the plain version for a CPU one
# ----------------------------------------------------------------------

def _run_passes(x: torch.Tensor, sched: Schedule, lo_p: int,
                hi_p: int) -> None:
    """Runs passes [lo_p, hi_p) of `sched` on x [rows, L, 4] in place."""
    bf = sched.bf.long()
    for start, end, kind, _ in sched.pass_list[lo_p:hi_p]:
        lo_i, hi_i = bf[start:end, 0], bf[start:end, 1]
        tw = sched.tw[bf[start:end, 2]]
        lo, hi = x[:, lo_i], x[:, hi_i]
        if kind == FWD:
            lo = lo ^ mul_plain(hi, tw)
            hi = hi ^ lo
        elif kind == BWD:
            hi = hi ^ lo
            lo = lo ^ mul_plain(hi, tw)
        else:
            lo, hi = lo ^ mul_plain(hi, tw), hi ^ lo
        x[:, lo_i] = lo
        x[:, hi_i] = hi


def lch14_plain(F, mode: int, y: torch.Tensor, sched: Schedule,
                m: int) -> torch.Tensor:
    """Plain version of K6: the same schedule on tensors; any device."""
    rows, n = y.shape[0], y.shape[1]
    fftn, ncos = sched.fftn, sched.ncos
    x = torch.zeros((rows, (1 + ncos) * fftn, 4), dtype=torch.int32,
                    device=y.device)
    x[:, :n] = y
    _run_passes(x, sched, 0, sched.nfirst)
    if mode == TRANSFORM:
        return x[:, :fftn].contiguous()
    out = torch.empty((rows, m, 4), dtype=torch.int32, device=y.device)
    out[:, :n] = y
    e0 = min(m, fftn)
    out[:, n:e0] = x[:, n:e0]
    x[:, n:fftn] = 0
    for c in range(1, ncos + 1):
        x[:, c * fftn : (c + 1) * fftn] = x[:, :fftn]
    _run_passes(x, sched, sched.nfirst, len(sched.pass_list))
    for c in range(1, ncos + 1):
        b = c * fftn
        take = min(fftn, m - b)
        out[:, b : b + take] = x[:, b : b + take]
    return out


def gf2_lch14(F, mode: int, y: torch.Tensor, sched: Schedule,
              m: int) -> torch.Tensor:
    """K6 wrapper: y [rows, n, 4] -> [rows, m, 4]; TRANSFORM runs the
    whole schedule on each row (m = n = fftn), EXTEND the Reed-Solomon
    extend (the first n outputs are y)."""
    name = route("gf2_lch14", F, y, sched.bf, sched.tw, sched.passes)
    if name is None:
        return lch14_plain(F, mode, y, sched, m)
    check_elts(y, "y", (4,))
    rows, n = y.shape[0], y.shape[1]
    if mode == TRANSFORM and not (n == m == sched.fftn):
        raise ValueError("a transform keeps its length")
    out = torch.empty((rows, m, 4), dtype=torch.int32, device=y.device)
    kernels.launch(name, 1, mode, out.data_ptr(), y.data_ptr(),
                   sched.bf.data_ptr(), sched.tw.data_ptr(),
                   sched.passes.data_ptr(), sched.nfirst,
                   sched.passes.shape[0], rows, n, m, sched.fftn,
                   sched.ncos)
    return out
