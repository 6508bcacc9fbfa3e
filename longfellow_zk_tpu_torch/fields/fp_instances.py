"""Concrete prime-field instances: Fp128 (reference
lib/algebra/fp_p128.h:26-56), Goldilocks 2^64 - 2^32 + 1 (reference
lib/algebra/fft_test.cc:209), the NIST P-256 base and scalar fields
(reference lib/algebra/fp_p256.h, lib/ec/p256.h), with the Fp2 root of
unity that the P-256 Reed-Solomon encoder uses
(lib/circuits/mdoc/mdoc_zk.cc:82-88), and the secp256k1 base and scalar
fields (reference lib/algebra/fp_p256k1.h), and the NIST P-384 and P-521
base fields (reference lib/algebra/fp_p384.h, fp_p521.h; 12 and 17
32-bit words).  The Reed-Solomon code of a field without a large 2-adic
root of unity (secp256k1, the P-256 order, P-384, P-521) goes through the
CRT convolution (transforms/crt_conv.py).  The ML-DSA prime is
fields/fp24.py's.
"""

from __future__ import annotations

import functools

from .fp import PrimeField
from .fp24 import FP24_P

# --- Fp128: 2^128 - 2^108 + 1 ------------------------------------------------
P128 = (1 << 128) - (1 << 108) + 1
# omega of order 2^108 (fp_p128.h:37)
P128_OMEGA = 17166008163159356379329005055841088858
P128_OMEGA_ORDER = 1 << 108

# --- Goldilocks: 2^64 - 2^32 + 1 --------------------------------------------
P64 = (1 << 64) - (1 << 32) + 1
# 7 is the canonical generator; omega of order 2^32 = 7^((p-1)/2^32)
P64_OMEGA = pow(7, (P64 - 1) >> 32, P64)
P64_OMEGA_ORDER = 1 << 32

# --- NIST P-256 --------------------------------------------------------------
P256 = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
P256_ORDER = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551

# --- secp256k1 ---------------------------------------------------------------
P256K1 = (1 << 256) - (1 << 32) - 977
P256K1_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

# --- NIST P-384 / P-521 ------------------------------------------------------
P384 = (1 << 384) - (1 << 128) - (1 << 96) + (1 << 32) - 1
P384_ORDER = int(
    "39402006196394479212279040100143613805079739270465446667946905279627"
    "659399113263569398956308152294913554433653942643"
)
P521 = (1 << 521) - 1
P521_ORDER = int(
    "68647976601306097149819007990813932172694353001433054093944634591855"
    "43183397655394245057746333217197532963996371363321113864768612440380"
    "340372808892707005449"
)

# Root of unity of order 2^31 in Fp2 over the P-256 base field
# (mdoc_zk.cc:83-88); element is kRootX + i*kRootY.
P256_FP2_ROOT_X = int(
    "11264922414641028187350045760969025837301884043048940872922371417158"
    "2664680802"
)
P256_FP2_ROOT_Y = int(
    "84087994358540907695740461427818660560182168997182378749313018254450"
    "460212908"
)
P256_FP2_ROOT_ORDER = 1 << 31

# The fields whose tensors the CUDA kernels take: p -> instance tag (the
# suffix of the kernel names in kernels.py; the ML-DSA prime's is "fp24").
KERNEL_TAGS = {P128: "fp128", P256: "fp256", P256K1: "fp256k1",
               P64: "fp64", P256_ORDER: "p256n", P256K1_ORDER: "p256k1n",
               FP24_P: "fp24", P384: "p384", P521: "p521"}


@functools.lru_cache(maxsize=None)
def fp128() -> PrimeField:
    return PrimeField(P128, "Fp128")


@functools.lru_cache(maxsize=None)
def p256_base() -> PrimeField:
    return PrimeField(P256, "Fp256Base")


@functools.lru_cache(maxsize=None)
def p256k1_base() -> PrimeField:
    return PrimeField(P256K1, "Fp256k1Base")


@functools.lru_cache(maxsize=None)
def fp64() -> PrimeField:
    return PrimeField(P64, "Fp64")


@functools.lru_cache(maxsize=None)
def p256_scalar() -> PrimeField:
    return PrimeField(P256_ORDER, "Fp256Scalar")


@functools.lru_cache(maxsize=None)
def p256k1_scalar() -> PrimeField:
    return PrimeField(P256K1_ORDER, "Fp256k1Scalar")


@functools.lru_cache(maxsize=None)
def p384_base() -> PrimeField:
    return PrimeField(P384, "Fp384Base")


@functools.lru_cache(maxsize=None)
def p521_base() -> PrimeField:
    return PrimeField(P521, "Fp521Base")
