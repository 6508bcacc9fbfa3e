"""Concrete prime-field instances: Fp128 (reference
lib/algebra/fp_p128.h:26-56), the field of this slice of the port."""

from __future__ import annotations

import functools

from .fp import PrimeField

# --- Fp128: 2^128 - 2^108 + 1 ------------------------------------------------
P128 = (1 << 128) - (1 << 108) + 1
# omega of order 2^108 (fp_p128.h:37)
P128_OMEGA = 17166008163159356379329005055841088858
P128_OMEGA_ORDER = 1 << 108


@functools.lru_cache(maxsize=None)
def fp128() -> PrimeField:
    return PrimeField(P128, "Fp128")
