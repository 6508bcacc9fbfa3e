"""ZK prover: Longfellow composition of sumcheck + Ligero
(reference lib/zk/zk_prover.h:36-198); port of the JAX package's
ZkProver with its phased prove.

Commit to [private witness | random pad], run the sumcheck prover with
the pad subtracted from every transcript message (the encrypted
transcript), then prove via Ligero that the committed pad+witness
decrypt the transcript into something the sumcheck verifier accepts.
"""

from __future__ import annotations

from typing import List, Optional

from ..device import resolve_device
from ..ligero.param import LigeroParam
from ..ligero.prover import LigeroProver
from ..sumcheck.circuit import Circuit, LayerProof, Proof
from ..sumcheck.prover import SumcheckProver
from ..sumcheck.transcript_sumcheck import TranscriptSumcheck
from .common import (
    HASH_OF_A,
    initialize_sumcheck_fiat_shamir,
    pad_size,
    setup_lqc,
    verifier_constraints,
)
from .proof import ZkProof


class ZkProver:
    def __init__(self, circ: Circuit, F, rs_factory, rate: int, nreq: int,
                 block_enc: Optional[int] = None, device=None):
        """rs_factory must encode on the same device
        (zk.testing.rs_factory_for(..., device=...))."""
        self.circ = circ
        self.F = F
        self.device = resolve_device(device)
        self.rs_factory = rs_factory
        self.n_witness = circ.ninputs - circ.npub_in
        self.param = LigeroParam(
            nw=self.n_witness + pad_size(circ), nq=circ.nl, rateinv=rate,
            nreq=nreq, block_enc=block_enc,
            subfield_bytes=F.kSubFieldBytes, field_bytes=F.kBytes)
        self.lqc = setup_lqc(circ, self.n_witness)
        self.pad: Optional[Proof] = None
        self.witness: Optional[List] = None
        self.lp: Optional[LigeroProver] = None
        self.sumcheck = SumcheckProver(F, self.device)

    def commit(self, zkp: ZkProof, W_host: List, ts, rng) -> None:
        """(zk_prover.h:72-100).  W_host: all input wires (public first)."""
        c, F = self.circ, self.F
        self.witness = list(W_host[c.npub_in : c.ninputs])
        subfield_boundary = max(0, c.subfield_boundary - c.npub_in)
        self._fill_pad(rng)
        self.lp = LigeroProver(self.param, F, self.rs_factory, self.device)
        zkp.com = self.lp.commit(ts, self.witness, subfield_boundary,
                                 self.lqc, rng)

    def prove(self, zkp: ZkProof, W_host: List, ts) -> bool:
        """(zk_prover.h:102-149): sumcheck on a clone of the transcript,
        the verifier-constraint replay, then the Ligero proof."""
        c, F = self.circ, self.F
        assert self.lp is not None, "must run commit before prove"
        initialize_sumcheck_fiat_shamir(ts, c, W_host, F)
        tst = ts.clone()
        W0 = F.to_limbs(W_host[: c.ninputs], self.device)
        proof, aux, _bnd = self.sumcheck.prove_with_witness(
            c, W0, TranscriptSumcheck(tst, F), pad=self.pad, with_aux=True)
        if proof is None:
            return False
        zkp.proof = proof

        a, b, ci = verifier_constraints(c, W_host, proof, aux, ts,
                                        self.n_witness, F, self.device)
        zkp.com_proof = self.lp.prove(ts, ci, a, HASH_OF_A, self.lqc)
        return True

    def _fill_pad(self, rng) -> None:
        """Random pad; the P(1) entries are zero (zk_prover.h:152-188)."""
        c, F = self.circ, self.F
        self.pad = Proof()
        for layer in c.layers:
            lp = LayerProof(cp=[], hp=[[], []], wc=[None, None])
            for _ in range(c.logc):
                poly = []
                for k in range(4):
                    if k != 1:
                        r = F.sample(rng.bytes)
                        poly.append(r)
                        self.witness.append(r)
                    else:
                        poly.append(F.of_scalar(0))
                lp.cp.append(poly)
            for _ in range(layer.logw):
                for h in range(2):
                    poly = []
                    for k in range(3):
                        if k != 1:
                            r = F.sample(rng.bytes)
                            poly.append(r)
                            self.witness.append(r)
                        else:
                            poly.append(F.of_scalar(0))
                    lp.hp[h].append(poly)
            for k in range(2):
                r = F.sample(rng.bytes)
                lp.wc[k] = r
                self.witness.append(r)
            self.witness.append(F.mul_i(lp.wc[0], lp.wc[1]))
            self.pad.layers.append(lp)
