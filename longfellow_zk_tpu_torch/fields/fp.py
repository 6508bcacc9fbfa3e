"""Prime-field arithmetic: host ints and PyTorch tensors.

Host side (plain Python ints, natural form) is the JAX package's
`PrimeField` host API, copied.  Tensor side: an element is four
little-endian 32-bit limbs in the last axis of an int32 tensor
(`[..., 4]`, 16 bytes, read as uint32 by the kernels), in Montgomery form
with R = 2^128 and always canonical (< p).  R is the JAX package's R
(eight 16-bit limbs), so the two packages hold the same integers
(fields/bridge.py converts the layouts).

Every tensor operation is a wrapper over one of the hand-written kernels
(K1 fp_elementwise, K2 fp_segment_sum, K3 fp_wire_round; see
kernels.py).  For a CUDA tensor the wrapper launches its kernel; for a
CPU tensor it runs the kernel's plain PyTorch version, which lives in
this module too (`*_plain`) and computes in int64 over 16-bit limbs
(CPU PyTorch has no uint32 `+`, `<<` or `>>`).  The kernels are written
for p = 2^128 - 2^108 + 1; the plain versions take any odd p < 2^128.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import kernels

MASK16 = 0xFFFF
NLIMB = 4    # 32-bit limbs per element (the tensor layout)
NL16 = 8     # 16-bit limbs per element (the plain versions)

# K1 modes (csrc/fp_ops.cu)
MUL, ADD, SUB, BIND, HV = 0, 1, 2, 3, 4

# K3 grid: blocks per output, at most
_K3_MAX_BLOCKS = 264


class PrimeField:
    """A prime field Fp, p < 2^128: host int ops and tensor ops."""

    kCharacteristicTwo = False
    kNPolyEvaluationPoints = 6

    def __init__(self, p: int, name: str, nbytes: Optional[int] = None):
        assert p % 2 == 1 and p < (1 << 128)
        self.p = p
        self.char = p
        self.name = name
        self.bits = p.bit_length()
        self.L = (self.bits + 15) // 16
        self.kBytes = nbytes if nbytes is not None else self.L * 2
        # Reference kSubFieldBytes == kBytes for prime fields
        # (fp_generic.h:47); there is no proper subfield.
        self.kSubFieldBytes = self.kBytes
        self.exact_bits = self.bits
        self.R = 1 << 128
        self.Rinv = pow(self.R, -1, p)
        self.R2 = (self.R * self.R) % p
        self.mont_one_int = self.R % p
        # constants of the plain versions (16-bit limbs)
        self.n0inv16 = (-pow(p, -1, 1 << 16)) % (1 << 16)
        self._p16 = [(p >> (16 * i)) & MASK16 for i in range(NL16)]
        self._r2_16 = [(self.R2 >> (16 * i)) & MASK16 for i in range(NL16)]
        self._one16 = [(self.mont_one_int >> (16 * i)) & MASK16
                       for i in range(NL16)]
        from .fp_instances import P128
        self.has_kernels = p == P128

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
        """Natural-form ints -> int32 [4] (one int) or [n, 4] Montgomery
        limbs on `device`."""
        one = isinstance(xs, (int, np.integer))
        vals = [int(xs)] if one else xs
        R, p = self.R, self.p
        buf = b"".join(((int(x) * R) % p).to_bytes(16, "little")
                       for x in vals)
        arr = np.frombuffer(buf, dtype="<i4").reshape(len(vals), NLIMB)
        t = torch.from_numpy(arr.copy()).to(device)
        return t[0] if one else t

    def from_limbs(self, t: torch.Tensor):
        """int32 [..., 4] Montgomery limbs -> natural int ([4]) or a numpy
        object array of ints (shape t.shape[:-1])."""
        a = np.ascontiguousarray(t.detach().cpu().numpy().astype("<i4"))
        assert a.shape[-1] == NLIMB
        raw = a.tobytes()
        Rinv, p = self.Rinv, self.p
        n = len(raw) // 16
        vals = [(int.from_bytes(raw[16 * j : 16 * j + 16], "little") * Rinv)
                % p for j in range(n)]
        if a.ndim == 1:
            return vals[0]
        return np.array(vals, dtype=object).reshape(a.shape[:-1])

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (NLIMB,), dtype=torch.int32,
                           device=device)

    # ------------------------------------------------------------------
    # tensor ops (int32 [..., 4], Montgomery, canonical)
    # ------------------------------------------------------------------

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp_elementwise(self, MUL, a, b)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp_elementwise(self, ADD, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp_elementwise(self, SUB, a, b)

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery limbs -> limbs of the natural value (a * 1 * R^-1)."""
        one = torch.tensor([1, 0, 0, 0], dtype=torch.int32, device=a.device)
        return fp_elementwise(self, MUL, a, one)

    def bind(self, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """Fixed-shape bind of x [..., n, 4] along the element axis:
        pairs fold to lo + (hi - lo) * r, the tail is zero-filled."""
        return fp_elementwise(self, BIND, x, r)

    def hv_update(self, hv: torch.Tensor, h: torch.Tensor,
                  r: torch.Tensor) -> torch.Tensor:
        """hv[t] * (h[t] odd ? r : 1 - r)."""
        return fp_elementwise(self, HV, hv, r, h=h)

    def lazy_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Field sum along element axis `dim` of x [..., 4]."""
        return fp_axis_sum(self, x, dim)

    def lazy_segment_sum(self, x: torch.Tensor, starts: torch.Tensor,
                         ends: torch.Tensor) -> torch.Tensor:
        """x [T, 4] -> [S, 4]: out[s] = sum of x[starts[s]:ends[s]]."""
        return fp_segment_sum(self, x, starts, ends)


# ----------------------------------------------------------------------
# plain versions: int64 over 16-bit limbs
# ----------------------------------------------------------------------

def _split16(x: torch.Tensor) -> torch.Tensor:
    """int32 [..., 4] -> int64 [..., 8] 16-bit limbs."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & MASK16, v >> 16], dim=-1).reshape(
        x.shape[:-1] + (NL16,))


def _join16(l16: torch.Tensor) -> torch.Tensor:
    """int64 [..., 8] 16-bit limbs -> int32 [..., 4]."""
    pairs = l16.reshape(l16.shape[:-1] + (NLIMB, 2))
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
    """top * 2^128 + t (< 2p, t in 16-bit limbs) -> canonical limbs."""
    d = t - _const16(F._p16, t)
    borrow = torch.zeros_like(t[..., 0])
    out = []
    for i in range(NL16):
        di = d[..., i] - borrow
        borrow = (di < 0).to(torch.int64)
        out.append(di + (borrow << 16))
    ge = (top != 0) | (borrow == 0)
    return torch.where(ge[..., None], torch.stack(out, dim=-1), t)


def _mont_mul16(F: PrimeField, a: torch.Tensor, b: torch.Tensor):
    """Montgomery a * b * R^-1 over 16-bit limbs (a < R, b < p)."""
    p16 = _const16(F._p16, a)
    prod = a[..., :, None] * b[..., None, :]          # [..., 8, 8] < 2^32
    T = torch.zeros(prod.shape[:-2] + (2 * NL16 + 1,), dtype=torch.int64,
                    device=a.device)
    for i in range(NL16):
        T[..., i : i + NL16] += prod[..., i, :]       # columns < 2^36
    for i in range(NL16):
        m = ((T[..., i] & MASK16) * F.n0inv16) & MASK16
        T[..., i : i + NL16] += m[..., None] * p16
        T[..., i + 1] += T[..., i] >> 16              # T[i] = 0 mod 2^16
    limbs, c = _carry16(T[..., NL16 : 2 * NL16])
    return _cond_sub16(F, limbs, T[..., 2 * NL16] + c)


def _add16(F: PrimeField, a: torch.Tensor, b: torch.Tensor):
    limbs, c = _carry16(a + b)
    return _cond_sub16(F, limbs, c)


def _sub16(F: PrimeField, a: torch.Tensor, b: torch.Tensor):
    d = a - b
    borrow = torch.zeros_like(d[..., 0])
    out = []
    for i in range(NL16):
        di = d[..., i] - borrow
        borrow = (di < 0).to(torch.int64)
        out.append(di + (borrow << 16))
    d = torch.stack(out, dim=-1)
    limbs, _ = _carry16(d + borrow[..., None] * _const16(F._p16, d))
    return limbs


def _renorm16(F: PrimeField, cols: torch.Tensor) -> torch.Tensor:
    """Columns [..., 8] (value = sum cols[k] 2^(16k), each < 2^62) -> the
    canonical value mod p (16-bit limbs)."""
    limbs, top = _carry16(cols)
    low = _cond_sub16(F, limbs, torch.zeros_like(top))
    # the carry stands for top * 2^128 = top * R: Montgomery-multiply the
    # integer top by R^2
    top16 = torch.stack([(top >> (16 * i)) & MASK16 for i in range(NL16)],
                        dim=-1)
    r2 = _const16(F._r2_16, cols).expand_as(top16)
    return _add16(F, low, _mont_mul16(F, top16, r2))


def elementwise_plain(F: PrimeField, mode: int, a: torch.Tensor,
                      b: torch.Tensor, h: Optional[torch.Tensor] = None):
    """Plain version of K1 (fp_elementwise); any device."""
    if mode == BIND:
        a16 = _split16(a)
        lo, hi = a16[..., 0::2, :], a16[..., 1::2, :]
        r = _split16(b).reshape(NL16)
        bound = _add16(F, lo, _mont_mul16(F, _sub16(F, hi, lo),
                                          r.expand_as(lo)))
        return _join16(torch.cat([bound, torch.zeros_like(bound)], dim=-2))
    if mode == HV:
        r = _split16(b).reshape(NL16)
        one = _const16(F._one16, r)
        f = torch.where((h & 1).bool()[..., None], r, _sub16(F, one, r))
        a16 = _split16(a)
        return _join16(_mont_mul16(F, a16, f.expand_as(a16)))
    a16, b16 = torch.broadcast_tensors(_split16(a), _split16(b))
    fn = {MUL: _mont_mul16, ADD: _add16, SUB: _sub16}[mode]
    return _join16(fn(F, a16, b16))


def segment_sum_plain(F: PrimeField, x: torch.Tensor, starts: torch.Tensor,
                      ends: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 mode 0: prefix sums of the limb columns."""
    x16 = _split16(x)
    cs = torch.cat([torch.zeros_like(x16[:1]), torch.cumsum(x16, dim=0)])
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


def wire_sums_plain(F: PrimeField, hv, Wh, Wo, h, ho) -> torch.Tensor:
    """Plain version of K3 mode 0: [a0, a2] as a [2, 4] tensor."""
    h = h.long()
    z = elementwise_plain(F, MUL, hv, Wo[ho.long()])
    whi, wlo = Wh[h | 1], Wh[h & ~1]
    odd = (h & 1).bool()[:, None]
    t0 = elementwise_plain(F, MUL, z, wlo)
    a0 = axis_sum_plain(F, torch.where(odd, torch.zeros_like(t0), t0), 0)
    zd = elementwise_plain(F, MUL, z, elementwise_plain(F, SUB, whi, wlo))
    zds = torch.where(odd, zd, elementwise_plain(F, SUB,
                                                 torch.zeros_like(zd), zd))
    return torch.stack([a0, axis_sum_plain(F, zds, 0)])


# ----------------------------------------------------------------------
# wrappers: the kernel for a CUDA tensor, the plain version for a CPU one
# ----------------------------------------------------------------------

def on_cuda(F: PrimeField, *ts) -> bool:
    """True if the tensors lie on the card (then the kernel runs)."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("tensors on different devices: %s, %s"
                             % (dev, t.device))
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    if not F.has_kernels:
        raise NotImplementedError(
            "the CUDA kernels are written for Fp128 only, not %s" % F.name)
    return True


def _check(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32 or t.shape[-1] != NLIMB or \
            not t.is_contiguous():
        raise ValueError("%s must be a contiguous int32 [..., 4] tensor, got "
                         "%s %s" % (name, t.dtype, tuple(t.shape)))


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


def fp_elementwise(F: PrimeField, mode: int, a: torch.Tensor, b: torch.Tensor,
                   h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 wrapper.  mul/add/sub broadcast a and b over the element axes;
    bind and hv take a single element b (the challenge r)."""
    if not on_cuda(F, a, b):
        return elementwise_plain(F, mode, a, b, h)
    if mode in (BIND, HV):
        _check(a, "a")
        if b.numel() != NLIMB:
            raise ValueError("bind/hv take one challenge element")
        b = b.contiguous()
        out = torch.empty_like(a)
        n = a.numel() // NLIMB
        row = a.shape[-2] if mode == BIND else 1
        if mode == BIND and row % 2:
            raise ValueError("bind needs an even length, got %d" % row)
        hp = 0
        if mode == HV:
            if h is None or h.dtype != torch.int32 or h.numel() != n or \
                    not h.is_contiguous() or h.device != a.device:
                raise ValueError("hv needs int32 indices h of a's length")
            hp = h.data_ptr()
        kernels.launch("fp_elementwise", 1, mode, out.data_ptr(),
                       a.data_ptr(), b.data_ptr(), hp, n, row, 1, 1)
        return out
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    if mode != SUB and tuple(a.shape[:-1]) != tuple(shape):
        a, b = b, a                       # the full operand goes first
    if tuple(a.shape[:-1]) != tuple(shape) or not a.is_contiguous():
        a = a.expand(tuple(shape) + (NLIMB,)).contiguous()
    dm = _bcast_divmod(b.shape[:-1], shape)
    if dm is None:
        b = b.expand(tuple(shape) + (NLIMB,))
        dm = (1, int(np.prod(shape)))
    b = b.contiguous()
    _check(a, "a")
    _check(b, "b")
    out = torch.empty_like(a)
    kernels.launch("fp_elementwise", 1, mode, out.data_ptr(), a.data_ptr(),
                   b.data_ptr(), 0, a.numel() // NLIMB, 1, dm[0], dm[1])
    return out


def _i32(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError("%s must be a contiguous int32 tensor" % name)


def fp_segment_sum(F: PrimeField, x: torch.Tensor, starts: torch.Tensor,
                   ends: torch.Tensor) -> torch.Tensor:
    """K2 wrapper, mode 0: out[s] = sum of x[starts[s]:ends[s]]."""
    if not on_cuda(F, x, starts, ends):
        return segment_sum_plain(F, x, starts, ends)
    _check(x, "x")
    _i32(starts, "starts")
    _i32(ends, "ends")
    nseg = starts.numel()
    out = torch.empty((nseg, NLIMB), dtype=torch.int32, device=x.device)
    kernels.launch("fp_segment_sum", 1, 0, out.data_ptr(), 0, x.data_ptr(),
                   0, 0, 0, 0, 0, starts.data_ptr(), ends.data_ptr(), nseg)
    return out


def fp_eval_layer(F: PrimeField, W: torch.Tensor, h0: torch.Tensor,
                  h1: torch.Tensor, v: torch.Tensor, bmask: torch.Tensor,
                  starts: torch.Tensor, ends: torch.Tensor):
    """K2 wrapper, mode 1: (V [S, 4], ok) for one circuit layer; ok is a
    0-dim bool tensor on W's device (no host sync)."""
    if not on_cuda(F, W, h0, h1, v, bmask, starts, ends):
        return eval_layer_plain(F, W, h0, h1, v, bmask, starts, ends)
    for t, name in ((W, "W"), (v, "v")):
        _check(t, name)
    for t, name in ((h0, "h0"), (h1, "h1"), (starts, "starts"),
                    (ends, "ends")):
        _i32(t, name)
    if bmask.dtype != torch.bool or not bmask.is_contiguous():
        raise ValueError("bmask must be a contiguous bool tensor")
    nseg = starts.numel()
    out = torch.empty((nseg, NLIMB), dtype=torch.int32, device=W.device)
    bad = torch.zeros(1, dtype=torch.int32, device=W.device)
    kernels.launch("fp_segment_sum", 1, 1, out.data_ptr(), bad.data_ptr(), 0,
                   W.data_ptr(), h0.data_ptr(), h1.data_ptr(), v.data_ptr(),
                   bmask.data_ptr(), starts.data_ptr(), ends.data_ptr(), nseg)
    return out, bad[0] == 0


def _k3_blocks(n: int) -> int:
    return max(1, min(_K3_MAX_BLOCKS, (n + 255) // 256))


def fp_axis_sum(F: PrimeField, x: torch.Tensor, dim: int) -> torch.Tensor:
    """K3 wrapper, mode 1: field sum along element axis `dim`."""
    if not on_cuda(F, x):
        return axis_sum_plain(F, x, dim)
    _check(x, "x")
    eshape = x.shape[:-1]
    dim = dim % len(eshape)
    A = int(np.prod(eshape[:dim]))
    R = int(eshape[dim])
    B = int(np.prod(eshape[dim + 1 :]))
    out = torch.empty(tuple(eshape[:dim]) + tuple(eshape[dim + 1 :]) + (NLIMB,),
                      dtype=torch.int32, device=x.device)
    nblk = _k3_blocks(R)
    scratch = torch.empty(4 * A * B * nblk, dtype=torch.int64,
                          device=x.device)
    kernels.launch("fp_wire_round", 2, 1, out.data_ptr(), scratch.data_ptr(),
                   x.data_ptr(), 0, 0, 0, 0, 0, A, R, B, nblk)
    return out


def fp_wire_sums(F: PrimeField, hv: torch.Tensor, Wh: torch.Tensor,
                 Wo: torch.Tensor, h: torch.Tensor,
                 ho: torch.Tensor) -> torch.Tensor:
    """K3 wrapper, mode 0: [a0, a2] ([2, 4]) of one hand's wire round."""
    if not on_cuda(F, hv, Wh, Wo, h, ho):
        return wire_sums_plain(F, hv, Wh, Wo, h, ho)
    for t, name in ((hv, "hv"), (Wh, "Wh"), (Wo, "Wo")):
        _check(t, name)
    _i32(h, "h")
    _i32(ho, "ho")
    T = hv.shape[0]
    out = torch.empty((2, NLIMB), dtype=torch.int32, device=hv.device)
    nblk = _k3_blocks(T)
    scratch = torch.empty(8 * nblk, dtype=torch.int64, device=hv.device)
    kernels.launch("fp_wire_round", 2, 0, out.data_ptr(), scratch.data_ptr(),
                   hv.data_ptr(), Wh.data_ptr(), Wo.data_ptr(), h.data_ptr(),
                   ho.data_ptr(), T, 0, 0, 0, nblk)
    return out
