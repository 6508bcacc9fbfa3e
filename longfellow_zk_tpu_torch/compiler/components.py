"""Host-side bit plucker encoding (reference bit_plucker_encoder.h):
the witness packing of the circuits' BitPlucker inputs.  Copied from the
JAX package's compiler/components.py, without the circuit components.
"""

from __future__ import annotations

from typing import List, Sequence


def bit_plucker_point(F, n: int, bits: int):
    """F.of_scalar(2*bits) - F.of_scalar(n-1) (bit_plucker_constants.h)."""
    if F.kCharacteristicTwo:
        return F.sub_i(F.of_scalar(2 * bits), F.of_scalar(n - 1))
    return F.sub_i(F.of_scalar((2 * bits) % F.char),
                   F.of_scalar((n - 1) % F.char))


class BitPluckerEncoder:
    """Host-side packing matching BitPlucker (bit_plucker_encoder.h)."""

    def __init__(self, F, logn: int):
        self.F = F
        self.logn = logn
        self.kN = 1 << logn
        self.kNv32Elts = (32 + logn - 1) // logn

    def encode(self, i: int):
        return bit_plucker_point(self.F, self.kN, i)

    def mkpacked_v32(self, j: int) -> List:
        r = []
        for _ in range(self.kNv32Elts):
            r.append(self.encode(j & (self.kN - 1)))
            j >>= self.logn
        return r

    def pack_bits(self, bits: Sequence[int], nelts: int) -> List:
        r = []
        for i in range(nelts):
            v = 0
            for j in range(self.logn):
                if i * self.logn + j < len(bits):
                    v += (bits[i * self.logn + j] & 1) << j
            r.append(self.encode(v))
        return r
