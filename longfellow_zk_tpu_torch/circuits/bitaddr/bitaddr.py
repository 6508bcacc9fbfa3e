"""Host witness of the Bitcoin P2PKH address circuit (reference
lib/circuits/tests/pq/bitaddr/bitaddr_witness.h): knowledge of a
secp256k1 secret key sk with address == RIPEMD160(SHA256(compressed(sk *
G))).  Copied from the JAX package's circuits/bitaddr/bitaddr.py without
the circuit builder (BitaddrCircuit), which needs the compiler; the port
reads the compiled circuit from artifacts/bitaddr_p256k1.lfc1.gz.
"""

from __future__ import annotations

from typing import List

from ...ec.curves import EllipticCurve
from ..ecdsa.pk import compute_pk_witness, fill_pk_witness
from ..ripemd import witness as ripemd_witness
from ..ripemd.reference import ripemd160
from ..sha.sha256 import message_witness, pack_block_witness

K_PLUCKER_LOGN = 2  # bitaddr.h uses BitPlucker<2>


class BitaddrWitness:
    """Host witness (bitaddr_witness.h)."""

    def __init__(self, ec: EllipticCurve, F):
        self.ec = ec
        self.F = F

    def compute_witness(self, sk: int):
        ec = self.ec
        pk = ec.normalize(ec.scalar_mult(ec.generator(), sk))
        self.pkx, self.pky = int(pk.x), int(pk.y)
        self.ecpk_w = compute_pk_witness(ec, sk)
        compressed = bytes([2 + (self.pky & 1)]) + \
            self.pkx.to_bytes(32, "big")
        _, _, sha_bws, sha_digest = message_witness(compressed, 1)
        self.sha_bw = sha_bws[0]
        self.sha_digest = sha_digest
        self.ripemd_traces = ripemd_witness.compute_witness(sha_digest, 1)
        self.addr = int.from_bytes(ripemd160(sha_digest), "big")

    def fill(self) -> List:
        F = self.F
        out = fill_pk_witness(F, self.ecpk_w)
        out.append(self.pkx)
        out.append(self.pky)
        out.extend(F.of_scalar((self.pkx >> i) & 1) for i in range(256))
        out.extend(F.of_scalar((self.pky >> i) & 1) for i in range(256))
        out.extend(pack_block_witness(F, K_PLUCKER_LOGN, [self.sha_bw]))
        out.extend(ripemd_witness.fill_witness(F, self.ripemd_traces,
                                               K_PLUCKER_LOGN))
        return out
