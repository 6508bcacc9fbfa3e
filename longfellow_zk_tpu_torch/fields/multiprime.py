"""The multi-prime ("CRT") field of the convolutions over prime fields
without a large 2-adic root of unity (secp256k1, P-384, P-521).

Port of the JAX package's fields/multiprime.py (reference
lib/algebra/crt.h:56-299): VS independent 32-bit prime fields over the
basis p_b = c * 2^22 + 1, the VS largest such primes below 2^32 in
descending order, found by Miller-Rabin (each has roots of unity of
order 2^22).  An element is its VS residues.

Host side: numpy object arrays of VS residues (natural form), so that the
generic NTT code (transforms/ntt.py) computes twiddle tables unchanged.
Tensor side: a residue is one 32-bit word (int32, read as uint32 by the
kernels) in Montgomery form with R = 2^32, canonical, in a tensor
[VS, ..., 1] with the lane (prime) axis leading: the elements of shape
s are the tensor [VS, *s, 1], and the ops broadcast over s (the lane
axis of a per-lane table, [VS, *t, 1], meets the lane axis of the data).
R is the JAX package's R (two 16-bit limbs a residue, uint32[2, VS, ...]
there), so both hold the same integers (fields/bridge.py).

The products, sums and differences go through kernel K14
(`mp_elementwise[crt]`, csrc/crt.cu) for a CUDA tensor and through its
plain PyTorch version (int64, below) for a CPU tensor.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .. import kernels
from .fp import _bcast_divmod, route

K_OMEGA_LOG_ORDER = 22  # kOmegaOrder = 2^22 (crt.h:41)
MP_MAX = 40  # the primes of csrc/mp.cuh's table

# K14 modes (csrc/crt.cu)
MUL, ADD, SUB = 0, 1, 2


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2^64."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def crt_primes(vs: int) -> tuple:
    """The `vs` largest primes c*2^22+1 below 2^32, descending."""
    out = []
    for c in range(1023, 0, -1):
        p = (c << K_OMEGA_LOG_ORDER) + 1
        if _is_prime(p):
            out.append(p)
            if len(out) == vs:
                return tuple(out)
    raise ValueError(f"not enough CRT primes for vs={vs}")


def _find_omega(p: int) -> int:
    """Element of exact order 2^22 in F_p (p = c*2^22+1)."""
    e = (p - 1) >> K_OMEGA_LOG_ORDER
    for g in range(2, 1000):
        w = pow(g, e, p)
        if pow(w, 1 << (K_OMEGA_LOG_ORDER - 1), p) != 1:
            return w
    raise ValueError("no omega found")


def basis_size_for(field_bits: int, log_n: int = K_OMEGA_LOG_ORDER) -> int:
    """Primes needed so prod p_b > n * p^2 (the convolution coefficient
    bound; crt.h:49-53).  32-bit primes => ~1 prime per 31 bits."""
    need = 2 * field_bits + log_n + 2
    primes = crt_primes(MP_MAX)
    total, vs = 0, 0
    for p in primes:
        total += p.bit_length() - 1
        vs += 1
        if total >= need:
            return vs
    raise ValueError("basis too small")


class MultiPrimeField:
    """VS independent 32-bit prime fields: host ops on numpy object
    arrays of VS residues, tensor ops on int32 [VS, ..., 1] Montgomery
    words (R = 2^32 a lane)."""

    kCharacteristicTwo = False
    elt_shape = (1,)
    tag = "crt"  # the kernels' instance (kernels.py)

    def __init__(self, vs: int):
        assert 0 < vs <= MP_MAX
        self.vs = vs
        self.name = "MultiPrime%d" % vs
        self.primes = list(crt_primes(vs))
        self.omegas = np.array([_find_omega(p) for p in self.primes],
                               dtype=object)
        self.omega_order = 1 << K_OMEGA_LOG_ORDER
        self.R = 1 << 32
        self.rinv = [pow(self.R, -1, p) for p in self.primes]
        self._consts = {}

    # -- host scalar ops: numpy object arrays of VS residues ---------------

    def _vec(self, a) -> np.ndarray:
        if isinstance(a, (int, np.integer)):
            return np.array([int(a) % p for p in self.primes], dtype=object)
        return a

    def of_scalar(self, a) -> np.ndarray:
        return self._vec(a)

    def add_i(self, a, b):
        a, b = self._vec(a), self._vec(b)
        return np.array([(int(x) + int(y)) % p for x, y, p in
                         zip(a, b, self.primes)], dtype=object)

    def sub_i(self, a, b):
        a, b = self._vec(a), self._vec(b)
        return np.array([(int(x) - int(y)) % p for x, y, p in
                         zip(a, b, self.primes)], dtype=object)

    def mul_i(self, a, b):
        a, b = self._vec(a), self._vec(b)
        return np.array([(int(x) * int(y)) % p for x, y, p in
                         zip(a, b, self.primes)], dtype=object)

    def inv_i(self, a):
        return np.array([pow(int(x), -1, p) for x, p in
                         zip(self._vec(a), self.primes)], dtype=object)

    # -- host <-> tensor ----------------------------------------------------

    def to_limbs(self, xs, device) -> torch.Tensor:
        """Residue vector(s) (natural) -> int32 [VS, 1] (one vector) or
        [VS, n, 1] Montgomery words on `device`."""
        one = isinstance(xs, np.ndarray) and xs.dtype == object and \
            xs.ndim == 1
        vals = [xs] if one else list(xs)
        arr = np.array([[(int(self._vec(v)[b]) << 32) % p for v in vals]
                        for b, p in enumerate(self.primes)], dtype=np.uint32)
        t = torch.from_numpy(arr.view(np.int32).copy())[..., None].to(device)
        return t[:, 0] if one else t

    def from_limbs(self, t: torch.Tensor) -> np.ndarray:
        """int32 [VS, ..., 1] Montgomery -> object array [VS, ...] of
        natural residues."""
        a = t.detach().cpu().numpy().view(np.uint32)[..., 0]
        out = np.empty(a.shape, dtype=object)
        for b, (p, ri) in enumerate(zip(self.primes, self.rinv)):
            out[b] = np.array([int(v) * ri % p for v in a[b].reshape(-1)],
                              dtype=object).reshape(a[b].shape)
        return out

    def lane_consts(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(p, 2^-32 mod p) a lane, int64 [VS] on `device` (the plain
        versions' constants), uploaded once a device."""
        key = str(device)
        if key not in self._consts:
            self._consts[key] = (
                torch.tensor(self.primes, dtype=torch.int64, device=device),
                torch.tensor(self.rinv, dtype=torch.int64, device=device))
        return self._consts[key]

    # -- tensor ops -----------------------------------------------------------

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mp_elementwise(self, MUL, a, b)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mp_elementwise(self, ADD, a, b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mp_elementwise(self, SUB, a, b)


# ----------------------------------------------------------------------
# plain versions: int64, a residue below 2^32
# ----------------------------------------------------------------------

def words64(t: torch.Tensor) -> torch.Tensor:
    """int32 -> int64 holding the uint32 value."""
    return t.to(torch.int64) & 0xFFFFFFFF


def words32(v: torch.Tensor) -> torch.Tensor:
    """int64 values below 2^32 -> int32 with the same bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def modmul(x: torch.Tensor, y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x * y mod p for int64 x, y below 2^32 and p below 2^32, with no
    product above 2^49."""
    return ((x * (y >> 16)) % p * 65536 + x * (y & 0xFFFF)) % p


def mont_plain(x: torch.Tensor, y, p, rinv) -> torch.Tensor:
    """The Montgomery product x * y * 2^-32 mod p (int64, below 2^32)."""
    return modmul(modmul(x, y, p), rinv, p)


def _lanes(F: MultiPrimeField, a: torch.Tensor, b: torch.Tensor):
    """a [VS, *sa, 1] and b [VS or 1, *sb, 1] with *sa and *sb of one
    length (ones inserted after the lane axis of the shorter), and the
    primes and 2^-32 shaped to broadcast with them."""
    da, db = a.dim(), b.dim()
    if da < db:
        a = a.reshape(a.shape[:1] + (1,) * (db - da) + a.shape[1:])
    elif db < da:
        b = b.reshape(b.shape[:1] + (1,) * (da - db) + b.shape[1:])
    p, rinv = F.lane_consts(a.device)
    shape = (F.vs,) + (1,) * (a.dim() - 1)
    return a, b, p.reshape(shape), rinv.reshape(shape)


def mp_elementwise_plain(F: MultiPrimeField, mode: int, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Plain version of K14: a (op) b modulo each lane's prime; any
    device."""
    a, b, p, rinv = _lanes(F, a, b)
    x, y = words64(a), words64(b)
    if mode == MUL:
        r = mont_plain(x, y, p, rinv)
    elif mode == ADD:
        r = (x + y) % p
    else:
        r = (x - y) % p
    return words32(r)


def mp_elementwise(F: MultiPrimeField, mode: int, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """K14 wrapper: a [VS, *sa, 1] (op) b [VS or 1, *sb, 1], broadcast
    over *sa and *sb; b's lanes, if it has them, meet a's."""
    name = route("mp_elementwise", F, a, b)
    if name is None:
        return mp_elementwise_plain(F, mode, a, b)
    vs = F.vs
    if a.dim() < 2 or a.shape[0] != vs or b.dim() < 2 or \
            b.shape[0] not in (1, vs):
        raise ValueError("mp_elementwise takes [VS, ..., 1] tensors, got %s "
                         "and %s" % (tuple(a.shape), tuple(b.shape)))
    if a.dtype != torch.int32 or b.dtype != torch.int32 or \
            a.shape[-1] != 1 or b.shape[-1] != 1:
        raise ValueError("mp_elementwise takes int32 words")
    full = tuple(torch.broadcast_shapes(a.shape[1:-1], b.shape[1:-1]))
    if tuple(a.shape[1:-1]) != full or not a.is_contiguous():
        a = a.expand((vs,) + full + (1,)).contiguous()
    lanes_b = b.shape[0] == vs
    dm = _bcast_divmod(b.shape[1:-1], full)
    if dm is None:
        b = b.expand(b.shape[:1] + full + (1,))
        dm = (1, int(np.prod(full)))
    b = b.contiguous()
    out = torch.empty_like(a)
    n = a.numel()
    kernels.launch(name, 1, mode, out.data_ptr(), a.data_ptr(), b.data_ptr(),
                   n, vs, (b.numel() // vs) if lanes_b else 0, dm[0], dm[1])
    return out
