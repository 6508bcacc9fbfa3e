"""Host-side elliptic curve arithmetic for witness generation (a copy of
the JAX package's ec/curves.py: P-256 and secp256k1).

Semantic twin of reference lib/ec/elliptic_curve.h:34-547 and
lib/ec/p256.h: projective short-Weierstrass points with the *complete*
addition/doubling formulas (Renes-Costello-Batina 2015, Algorithms 1 and
3), the same formulas the ECDSA circuit uses in-wire, so host-computed
intermediate points match the circuit's assert_eq checks
coordinate-for-coordinate (including Z).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from ..fields.fp_instances import P256, P256_ORDER, P256K1, P256K1_ORDER


@dataclass
class ECPoint:
    x: int
    y: int
    z: int


class EllipticCurve:
    """y^2 = x^3 + ax + b over Fp, projective complete formulas."""

    def __init__(self, p: int, a: int, b: int, gx: int, gy: int, order: int,
                 kbits: int):
        self.p = p
        self.a = a % p
        self.b = b % p
        self.k3b = (3 * b) % p
        self.gx = gx
        self.gy = gy
        self.order = order
        self.kBits = kbits

    def generator(self) -> ECPoint:
        return ECPoint(self.gx, self.gy, 1)

    def identity(self) -> ECPoint:
        return ECPoint(0, 1, 0)

    def is_on_curve(self, x: int, y: int) -> bool:
        p = self.p
        return (y * y - (x * x * x + self.a * x + self.b)) % p == 0

    def addE(self, X1, Y1, Z1, X2, Y2, Z2) -> Tuple[int, int, int]:
        """RCB15 Algorithm 1 (complete addition), mirrored step-for-step
        with the circuit's addE (verify_circuit.h:264-316)."""
        p, a, k3b = self.p, self.a, self.k3b
        t0 = X1 * X2 % p
        t1 = Y1 * Y2 % p
        t2 = Z1 * Z2 % p
        t3 = (X1 + Y1) * (X2 + Y2) % p
        t4 = (t0 + t1) % p
        t3 = (t3 - t4) % p
        t4 = (X1 + Z1) * (X2 + Z2) % p
        t5 = (t0 + t2) % p
        t4 = (t4 - t5) % p
        t5 = (Y1 + Z1) * (Y2 + Z2) % p
        X3 = (t1 + t2) % p
        t5 = (t5 - X3) % p
        Z3 = a * t4 % p
        X3 = k3b * t2 % p
        Z3 = (X3 + Z3) % p
        X3 = (t1 - Z3) % p
        Z3 = (t1 + Z3) % p
        Y3 = X3 * Z3 % p
        t1 = (t0 + t0) % p
        t1 = (t1 + t0) % p
        t2 = a * t2 % p
        t4 = k3b * t4 % p
        t1 = (t1 + t2) % p
        t2 = (t0 - t2) % p
        t2 = a * t2 % p
        t4 = (t4 + t2) % p
        t0 = t1 * t4 % p
        Y3 = (Y3 + t0) % p
        t0 = t5 * t4 % p
        X3 = (t3 * X3 - t0) % p
        t0 = t3 * t1 % p
        Z3 = (t5 * Z3 + t0) % p
        return X3, Y3, Z3

    def doubleE(self, X, Y, Z) -> Tuple[int, int, int]:
        """RCB15 Algorithm 3 (exception-free doubling), mirrored with the
        circuit's doubleE (verify_circuit.h:318-361)."""
        p, a, k3b = self.p, self.a, self.k3b
        t0 = X * X % p
        t1 = Y * Y % p
        t2 = Z * Z % p
        t3 = X * Y % p
        t3 = (t3 + t3) % p
        Z3 = X * Z % p
        Z3 = (Z3 + Z3) % p
        X3 = a * Z3 % p
        Y3 = k3b * t2 % p
        Y3 = (X3 + Y3) % p
        X3 = (t1 - Y3) % p
        Y3 = (t1 + Y3) % p
        Y3 = X3 * Y3 % p
        X3 = t3 * X3 % p
        Z3 = k3b * Z3 % p
        t2 = a * t2 % p
        t3 = (t0 - t2) % p
        t3 = a * t3 % p
        t3 = (t3 + Z3) % p
        Z3 = (t0 + t0) % p
        t0 = (Z3 + t0) % p
        t0 = (t0 + t2) % p
        t0 = t0 * t3 % p
        Y3 = (Y3 + t0) % p
        t2 = Y * Z % p
        t2 = (t2 + t2) % p
        t0 = t2 * t3 % p
        X3 = (X3 - t0) % p
        Z3 = t2 * t1 % p
        Z3 = (Z3 + Z3) % p
        Z3 = (Z3 + Z3) % p
        return X3, Y3, Z3

    def add_points(self, P: ECPoint, Q: ECPoint) -> ECPoint:
        return ECPoint(*self.addE(P.x, P.y, P.z, Q.x, Q.y, Q.z))

    def double_point(self, P: ECPoint) -> ECPoint:
        return ECPoint(*self.doubleE(P.x, P.y, P.z))

    def normalize(self, P: ECPoint) -> ECPoint:
        if P.z % self.p == 0:
            return ECPoint(0, 1, 0)
        zi = pow(P.z, -1, self.p)
        return ECPoint(P.x * zi % self.p, P.y * zi % self.p, 1)

    def scalar_mult(self, P: ECPoint, k: int) -> ECPoint:
        acc = self.identity()
        for i in range(k.bit_length() - 1, -1, -1):
            acc = self.double_point(acc)
            if (k >> i) & 1:
                acc = self.add_points(acc, P)
        return acc

    def multi_scalar_mult(self, bases: Sequence[ECPoint],
                          scalars: Sequence[int]) -> ECPoint:
        acc = self.identity()
        for P, k in zip(bases, scalars):
            acc = self.add_points(acc, self.scalar_mult(P, k))
        return acc


def p256_curve() -> EllipticCurve:
    return EllipticCurve(
        p=P256,
        a=P256 - 3,
        b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
        gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
        gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
        order=P256_ORDER,
        kbits=256,
    )


def p256k1_curve() -> EllipticCurve:
    return EllipticCurve(
        p=P256K1,
        a=0,
        b=7,
        gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
        gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
        order=P256K1_ORDER,
        kbits=256,
    )


def ecdsa_sign(ec: EllipticCurve, d: int, e: int, k: int) -> Tuple[int, int]:
    """Textbook ECDSA with given nonce k (tests only)."""
    n = ec.order
    R = ec.normalize(ec.scalar_mult(ec.generator(), k))
    r = R.x % n
    assert r != 0
    s = pow(k, -1, n) * (e + r * d) % n
    assert s != 0
    return r, s
