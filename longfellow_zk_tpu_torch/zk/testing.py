"""ZK harness constants and the RS factory (counterpart of the JAX
package's zk/testing.py; prime fields with a native root of unity only).
"""

from __future__ import annotations

from ..device import resolve_device
from ..transforms.ntt import ReedSolomon, make_fft_convolution_factory

K_LIGERO_RATE = 4
K_LIGERO_NREQ = 128
K_VERSION = 7


def rs_factory_for(F, omega, omega_order: int, device=None):
    """factory(n, m) -> a cached ReedSolomon(n, m) encoder on `device`,
    by NTT convolution over F's root of unity omega."""
    dev = resolve_device(device)
    conv = make_fft_convolution_factory(F, omega, omega_order, dev)
    cache = {}

    def factory(n, m):
        if (n, m) not in cache:
            cache[(n, m)] = ReedSolomon(n, m, F, conv, dev)
        return cache[(n, m)]

    factory.device = dev
    return factory
