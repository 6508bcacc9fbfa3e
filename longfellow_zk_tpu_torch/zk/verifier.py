"""ZK verifier (reference lib/zk/zk_verifier.h:40-107); port of the JAX
package's zk/verifier.py.

The replay of the sumcheck verifier's constraints (zk/common.py) binds
each layer's quad on the device (K7), and the Ligero verifier re-encodes
the responses there (the rs_factory's kernels); the rest is host work.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..device import resolve_device
from ..ligero.param import LigeroParam
from ..ligero.verifier import LigeroVerifier
from ..sumcheck.circuit import Circuit
from .common import (
    HASH_OF_A,
    initialize_sumcheck_fiat_shamir,
    pad_size,
    setup_lqc,
    verifier_constraints,
)
from .proof import ZkProof


class ZkVerifier:
    def __init__(self, circ: Circuit, F, rs_factory, rate: int, nreq: int,
                 block_enc: Optional[int] = None, device=None):
        """rs_factory must encode on the same device
        (zk.testing.rs_factory_for(..., device=...))."""
        self.circ = circ
        self.F = F
        self.device = resolve_device(device)
        self.n_witness = circ.ninputs - circ.npub_in
        self.param = LigeroParam(
            nw=self.n_witness + pad_size(circ), nq=circ.nl, rateinv=rate,
            nreq=nreq, block_enc=block_enc,
            subfield_bytes=F.kSubFieldBytes, field_bytes=F.kBytes)
        self.lqc = setup_lqc(circ, self.n_witness)
        self.rs_factory = rs_factory
        self.lv = LigeroVerifier(self.param, F, rs_factory, self.device)

    def recv_commitment(self, zkp: ZkProof, ts) -> None:
        self.lv.receive_commitment(zkp.com, ts)

    def verify(self, zkp: ZkProof, pub: List, ts) -> Tuple[bool, str]:
        """(ok, why) for the proof and the public inputs pub[:npub_in]."""
        c, F = self.circ, self.F
        initialize_sumcheck_fiat_shamir(ts, c, pub, F)
        a, b, ci = verifier_constraints(c, pub, zkp.proof, ts,
                                        self.n_witness, F, self.device)
        return self.lv.verify(zkp.com, zkp.com_proof, ts, ci, a, HASH_OF_A,
                              b, self.lqc)
