"""Host RIPEMD-160 reference + constants (a copy of the JAX package's
circuits/ripemd/reference.py).

Semantic twin of reference lib/circuits/tests/ripemd/ripemd_constants.h
and ripemd_witness.{h,cc} — but the message-word permutations RL/RR and
the additive constants KL/KR are *computed* from their definitions in
the RIPEMD-160 paper (Dobbertin–Bosselaers–Preneel 1996): RL[r] = rho^r,
RR[r] = rho^r ∘ pi with pi(i) = 9i+5 mod 16, KL/KR = floor(2^30 *
sqrt/cbrt of small primes).  The shift tables SL/SR have no closed form
and are taken from the paper (unavoidable spec constants, like the SHA
round constants).
"""

from __future__ import annotations

from math import isqrt
from typing import List

_M32 = (1 << 32) - 1

_RHO = [7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8]


def _compute_rl() -> List[List[int]]:
    rl = [list(range(16))]
    for _ in range(4):
        rl.append([_RHO[i] for i in rl[-1]])
    return rl


def _compute_rr() -> List[List[int]]:
    pi = [(9 * i + 5) % 16 for i in range(16)]
    return [[r[i] for i in pi] for r in _compute_rl()]


def _icbrt(n: int) -> int:
    x = int(round(n ** (1 / 3)))
    while x * x * x > n:
        x -= 1
    while (x + 1) ** 3 <= n:
        x += 1
    return x


RL = _compute_rl()
RR = _compute_rr()
KL = [0] + [isqrt((1 << 60) * m) for m in (2, 3, 5, 7)]
KR = [_icbrt((1 << 90) * m) for m in (2, 3, 5, 7)] + [0]

# shift amounts (RIPEMD-160 paper, Table; ripemd_constants.h:53-70)
SL = [
    [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8],
    [7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12],
    [11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5],
    [11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12],
    [9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6],
]
SR = [
    [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6],
    [9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11],
    [9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5],
    [15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8],
    [8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11],
]

RIPEMD_INIT = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _M32


def _f(r: int, x: int, y: int, z: int) -> int:
    if r == 0:
        return x ^ y ^ z
    if r == 1:
        return (x & y) | (~x & z)
    if r == 2:
        return (x | ~y) ^ z
    if r == 3:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z)


class StepTrace:
    """Per-step intermediates witnessed by the circuit."""

    __slots__ = ("left_temp", "left_calc", "right_temp", "right_calc",
                 "h_out")

    def __init__(self):
        self.left_temp: List[int] = []
        self.left_calc: List[int] = []
        self.right_temp: List[int] = []
        self.right_calc: List[int] = []
        self.h_out: List[int] = []


def transform_block(H: List[int], X: List[int],
                    trace: StepTrace = None) -> List[int]:
    """One RIPEMD-160 compression (X = 16 LE words), optionally
    recording the per-step temp/calc values (ripemd_witness.cc)."""
    a, b, c, d, e = H
    aa, bb, cc, dd, ee = H
    for r in range(5):
        for s in range(16):
            t = (a + _f(r, b, c, d) + X[RL[r][s]] + KL[r]) & _M32
            calc = (_rol(t, SL[r][s]) + e) & _M32
            if trace is not None:
                trace.left_temp.append(t)
                trace.left_calc.append(calc)
            a, e, d, c, b = e, d, _rol(c, 10), b, calc

            t = (aa + _f(4 - r, bb, cc, dd) + X[RR[r][s]] + KR[r]) & _M32
            calc = (_rol(t, SR[r][s]) + ee) & _M32
            if trace is not None:
                trace.right_temp.append(t)
                trace.right_calc.append(calc)
            aa, ee, dd, cc, bb = ee, dd, _rol(cc, 10), bb, calc

    H1 = [(H[1] + c + dd) & _M32, (H[2] + d + ee) & _M32,
          (H[3] + e + aa) & _M32, (H[4] + a + bb) & _M32,
          (H[0] + b + cc) & _M32]
    if trace is not None:
        trace.h_out = list(H1)
    return H1


def ripemd160_pad(msg: bytes) -> bytes:
    """MD-strengthening: 0x80, zeros, 64-bit LE bit length."""
    n = len(msg)
    pad = b"\x80" + b"\x00" * ((55 - n) % 64)
    return msg + pad + (8 * n).to_bytes(8, "little")


def ripemd160(msg: bytes) -> bytes:
    data = ripemd160_pad(msg)
    H = list(RIPEMD_INIT)
    for off in range(0, len(data), 64):
        X = [int.from_bytes(data[off + 4 * i : off + 4 * i + 4], "little")
             for i in range(16)]
        H = transform_block(H, X)
    return b"".join(h.to_bytes(4, "little") for h in H)
