"""ECDSA signature-verification witness (a copy of the host half of the
JAX package's circuits/ecdsa/verify.py; the circuit itself is read from
its LFC1 file).

Semantic twin of reference lib/circuits/ecdsa/verify_witness.h:29-198:
the circuit verifies identity = g*e + pk*r + (rx,ry)*(-s) as a 256-step
triple-scalar multiplication over a witnessed precomputed table pre[8]
(g+pk, g+r, r+pk, g+r+pk) with 3-bit packed exponent digits and
witnessed intermediate projective points.  The host computes the real EC
operations with the identical complete formulas (ec/curves.py), so the
intermediate points match the circuit coordinate-for-coordinate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ...ec.curves import ECPoint, EllipticCurve


@dataclass
class VerifyWitness:
    """Host witness values (verify_witness.h:29-198)."""

    rx: int = 0
    ry: int = 0
    rx_inv: int = 0
    s_inv: int = 0
    pk_inv: int = 0
    pre: List[int] = field(default_factory=list)
    bi: List[int] = field(default_factory=list)
    int_x: List[int] = field(default_factory=list)
    int_y: List[int] = field(default_factory=list)
    int_z: List[int] = field(default_factory=list)

    def fill(self) -> List[int]:
        out = [self.rx, self.ry, self.rx_inv, self.s_inv, self.pk_inv]
        out += self.pre
        kbits = len(self.bi)
        for i in range(kbits):
            out.append(self.bi[i])
            if i < kbits - 1:
                out.append(self.int_x[i])
                out.append(self.int_y[i])
                out.append(self.int_z[i])
        return out


def compute_witness(ec: EllipticCurve, pkx: int, pky: int, e: int, r: int,
                    s: int) -> VerifyWitness:
    """(verify_witness.h:75-197)."""
    p, n = ec.p, ec.order
    w = VerifyWitness()
    s_inv_n = pow(s, -1, n)
    nms = (-s) % n
    # recover R = g*(e/s) + pk*(r/s)
    nes = e * s_inv_n % n
    nrs = r * s_inv_n % n
    pr = ec.normalize(ec.multi_scalar_mult(
        [ec.generator(), _pt(ec, pkx, pky)], [nes, nrs]))
    w.rx = r % p
    w.ry = pr.y
    w.rx_inv = pow(w.rx, -1, p) if w.rx != 0 else 0
    w.s_inv = pow(nms % p, -1, p) if nms % p != 0 else 0
    w.pk_inv = pow(pkx, -1, p) if pkx != 0 else 0

    # precomputed table: g+pk, g+r, r+pk normalized, then g+(r+pk)
    pre = [0] * 8
    lh = [(ec.gx, ec.gy), (ec.gx, ec.gy), (pkx, pky)]
    rh = [(pkx, pky), (w.rx, w.ry), (w.rx, w.ry)]
    for i in range(3):
        X, Y, Z = ec.addE(lh[i][0], lh[i][1], 1, rh[i][0], rh[i][1], 1)
        zi = pow(Z, -1, p) if Z % p != 0 else 0
        pre[2 * i] = X * zi % p
        pre[2 * i + 1] = Y * zi % p
    X, Y, Z = ec.addE(ec.gx, ec.gy, 1, pre[4], pre[5], 1)
    zi = pow(Z, -1, p) if Z % p != 0 else 0
    pre[6] = X * zi % p
    pre[7] = Y * zi % p
    w.pre = pre

    kbits = ec.kBits
    aX, aY, aZ = 0, 1, 0
    table = [
        (0, 1, 0), (ec.gx, ec.gy, 1), (pkx, pky, 1), (pre[0], pre[1], 1),
        (w.rx, w.ry, 1), (pre[2], pre[3], 1), (pre[4], pre[5], 1),
        (pre[6], pre[7], 1),
    ]
    for i in range(kbits):
        b = (((e >> (kbits - i - 1)) & 1)
             + 2 * ((r >> (kbits - i - 1)) & 1)
             + 4 * ((nms >> (kbits - i - 1)) & 1))
        w.bi.append((2 * b - 7) % p)
        if i > 0:
            aX, aY, aZ = ec.doubleE(aX, aY, aZ)
        tx, ty, tz = table[b]
        aX, aY, aZ = ec.addE(aX, aY, aZ, tx, ty, tz)
        w.int_x.append(aX)
        w.int_y.append(aY)
        w.int_z.append(aZ)
    assert aX % p == 0 and aZ % p == 0, "signature does not verify"
    return w


def _pt(ec, x, y):
    return ECPoint(x, y, 1)
