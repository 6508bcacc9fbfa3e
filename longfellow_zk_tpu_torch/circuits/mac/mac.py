"""MACs binding values across the two proof fields of the mdoc proof
(reference lib/circuits/mac/mac_reference.h, mac_witness.h):
mac_i = (a_v + a_p_i) * m_i over GF(2^128), where the verifier
contributes one a_v and the prover commits a_p_i.  Copied from the JAX
package's circuits/mac/mac.py: the host MAC and the witness values, not
the circuit builders.
"""

from __future__ import annotations

from typing import List, Sequence

from ...compiler.components import BitPluckerEncoder
from ...fields.gf2 import gf_mul_int

K_MAC_PLUCKER_BITS = 2


class MACReference:
    """Host MAC computation (mac_reference.h:29-55)."""

    def sample(self, n: int, rng) -> List[int]:
        buf = rng.bytes(n * 16)
        return [int.from_bytes(buf[16 * i : 16 * (i + 1)], "little")
                for i in range(n)]

    def compute(self, av: int, ap: Sequence[int], msg: bytes) -> List[int]:
        """MAC of a 32-byte message as two GF(2^128) elements."""
        assert len(msg) == 32
        out = []
        for i in range(2):
            m = int.from_bytes(msg[16 * i : 16 * (i + 1)], "little")
            out.append(gf_mul_int(av ^ ap[i], m))
        return out


def fill_gf2k_bits(m: int, nbits: int = 128) -> List[int]:
    """GF(2^128) element -> bit list (mac_reference.h fill_gf2k)."""
    return [(m >> i) & 1 for i in range(nbits)]


def mac_witness_values(F, plucker_logn: int, ap: Sequence[int],
                       value: int) -> List[int]:
    """Host witness of the MAC check over a prime field: packed a_p bits
    then packed 256 message bits (mac_witness.h)."""
    enc = BitPluckerEncoder(F, plucker_logn)
    n128 = (128 + plucker_logn - 1) // plucker_logn
    n256 = (256 + plucker_logn - 1) // plucker_logn
    out = []
    for i in range(2):
        out.extend(enc.pack_bits(fill_gf2k_bits(ap[i]), n128))
    out.extend(enc.pack_bits([(value >> i) & 1 for i in range(256)], n256))
    return out
