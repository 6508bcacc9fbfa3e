"""Host witness generation for the RIPEMD-160 circuit (twin of reference
ripemd_witness.{h,cc}; a copy of the JAX package's
circuits/ripemd/witness.py).  The circuit itself is read from an LFC1
file."""

from __future__ import annotations

from typing import List

from ...compiler.components import BitPluckerEncoder
from .reference import RIPEMD_INIT, StepTrace, ripemd160_pad, transform_block


def compute_witness(msg: bytes, maxb: int) -> List[StepTrace]:
    """Per-block step traces for the padded message; the caller packs
    them with fill_witness.  len(padded) must fit in maxb blocks."""
    data = ripemd160_pad(msg)
    nb = len(data) // 64
    assert nb <= maxb, (nb, maxb)
    H = list(RIPEMD_INIT)
    traces = []
    for b in range(nb):
        X = [int.from_bytes(data[64 * b + 4 * i : 64 * b + 4 * i + 4],
                            "little") for i in range(16)]
        tr = StepTrace()
        H = transform_block(H, X, tr)
        traces.append(tr)
    # dummy all-zero-message blocks keep the wire count fixed
    # (the circuit only selects block nb's h_out)
    for b in range(nb, maxb):
        X = [0] * 16
        tr = StepTrace()
        H = transform_block(H, X, tr)
        traces.append(tr)
    return traces


def fill_witness(F, traces: List[StepTrace], plucker_logn: int = 4) -> List:
    """Packed field elements in block_witness_input() wire order."""
    enc = BitPluckerEncoder(F, plucker_logn)
    out: List = []
    for tr in traces:
        for i in range(80):
            for v in (tr.left_temp[i], tr.left_calc[i],
                      tr.right_temp[i], tr.right_calc[i]):
                out.extend(enc.mkpacked_v32(v))
        for h in tr.h_out:
            out.extend(enc.mkpacked_v32(h))
    return out

