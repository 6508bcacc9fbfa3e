"""ZK harness constants and the RS factory (counterpart of the JAX
package's zk/testing.py).
"""

from __future__ import annotations

from ..device import resolve_device
from ..transforms.crt_conv import make_crt_convolution_factory
from ..transforms.lch14 import LCH14ReedSolomon
from ..transforms.ntt import (ReedSolomon, make_fft_convolution_factory,
                              make_fft_ext_convolution_factory)

K_LIGERO_RATE = 4
K_LIGERO_NREQ = 128
K_VERSION = 7


def rs_factory_with(F, conv_factory, device=None):
    """factory(n, m) -> a cached Reed-Solomon (n, m) encoder over the prime
    field F on `device` whose convolutions come from conv_factory(n, m, y)
    (any of the transforms' factories: the radix-2 or matmul NTT, the
    half-complex RFFT, Nussbaumer, the CRT convolution)."""
    dev = resolve_device(device)
    return _cached(lambda n, m: ReedSolomon(n, m, F, conv_factory, dev), dev)


def _cached(make, dev):
    cache = {}

    def factory(n, m):
        if (n, m) not in cache:
            cache[(n, m)] = make(n, m)
        return cache[(n, m)]

    factory.device = dev
    return factory


def rs_factory_for(F, omega=None, omega_order: int = None, F2=None,
                   omega2=None, device=None):
    """factory(n, m) -> a cached Reed-Solomon (n, m) encoder on `device`:
    LCH14 for GF(2^128); by NTT convolution over F's root of unity omega;
    given F2 (an Fp2 over F) and its root omega2, by convolution in Fp2;
    given neither, by the CRT convolution over 32-bit primes, for a field
    without roots of unity of the needed order (secp256k1: the
    reference's CrtConvolutionFactory, bitaddr_test.cc:103-125)."""
    dev = resolve_device(device)
    if F.kCharacteristicTwo:
        return _cached(lambda n, m: LCH14ReedSolomon(n, m, F, dev), dev)
    if F2 is not None:
        conv = make_fft_ext_convolution_factory(F, F2, omega2, omega_order,
                                                dev)
    elif omega is not None:
        conv = make_fft_convolution_factory(F, omega, omega_order, dev)
    else:
        conv = make_crt_convolution_factory(F, device=dev)
    return rs_factory_with(F, conv, dev)
