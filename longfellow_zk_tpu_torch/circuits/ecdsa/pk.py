"""Host witness of the public-key derivation circuit, (pkx, pky) == sk * G
(reference lib/circuits/tests/ec/pk_circuit.h:24-231): the bits of sk and
the intermediate projective points of double-and-add.  Copied from the
JAX package's circuits/ecdsa/pk.py without the circuit (Ecpk,
EcpkWitness), which the port reads from an LFC1 file.
"""

from __future__ import annotations

from typing import List

from ...ec.curves import EllipticCurve


def compute_pk_witness(ec: EllipticCurve, sk: int) -> dict:
    """Host: bits of sk (MSB first) + intermediate projective points."""
    kbits = ec.kBits
    bits = [(sk >> (kbits - 1 - i)) & 1 for i in range(kbits)]
    ax, ay, az = 0, 1, 0
    int_x, int_y, int_z = [], [], []
    for i in range(kbits):
        ax, ay, az = ec.doubleE(ax, ay, az)
        if bits[i]:
            ax, ay, az = ec.addE(ax, ay, az, ec.gx, ec.gy, 1)
        else:
            ax, ay, az = ec.addE(ax, ay, az, 0, 1, 0)
        if i < kbits - 1:
            int_x.append(ax)
            int_y.append(ay)
            int_z.append(az)
    return dict(bits=bits, int_x=int_x, int_y=int_y, int_z=int_z)


def fill_pk_witness(F, w: dict) -> List[int]:
    out = []
    kbits = len(w["bits"])
    for i in range(kbits):
        out.append(F.of_scalar(w["bits"][i]))
        if i < kbits - 1:
            out.append(w["int_x"][i] % F.p)
            out.append(w["int_y"][i] % F.p)
            out.append(w["int_z"][i] % F.p)
    return out
