"""ZK prover: Longfellow composition of sumcheck + Ligero
(reference lib/zk/zk_prover.h:36-198); port of the JAX package's
ZkProver with its phased prove.

Commit to [private witness | random pad], run the sumcheck prover with
the pad subtracted from every transcript message (the encrypted
transcript), then prove via Ligero that the committed pad+witness
decrypt the transcript into something the sumcheck verifier accepts.

After the commit, `prove` reads one value back (the evaluation check),
uploads every table its steps need, then runs on the card, with the
transcript there too, nothing read back between them: the sumcheck
(sumcheck/prover.py), the linear constraints (K11, zk/fused.py), the
Ligero finish (K12, the responses, K9's draws, writes and column choice,
zk/fused.py); then one fetch, from which the host assembles the proof
and its transcript takes the final state.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ligero.param import LigeroParam
from ..ligero.prover import LigeroProver
from ..random_oracle import device_fs as dfs
from ..sumcheck.circuit import Circuit, LayerProof, Proof
from ..sumcheck.prover import SumcheckProver
from .common import initialize_sumcheck_fiat_shamir, pad_size, setup_lqc
from .fused import constraints_dev, fused_static, ligero_finish_dev, prepare
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
        """(zk_prover.h:102-149): the evaluation check, the uploads, the
        device chain (_prove_dev), one fetch; ts ends where the host
        prover's transcript would (its PRF aside)."""
        c, F, p, dev = self.circ, self.F, self.param, self.device
        assert self.lp is not None, "must run commit before prove"
        initialize_sumcheck_fiat_shamir(ts, c, W_host, F)
        W0 = F.to_limbs(W_host[: c.ninputs], dev)
        inputs = self.sumcheck.evaluate(c, W0)
        if inputs is None:
            return False
        # every upload before the first round (the responses' encoder
        # went up with the commit)
        pads, consts = self.sumcheck.prepare(c, self.pad)
        tabs = prepare(F, fused_static(c, p, self.lqc, self.n_witness), dev)
        fs = dfs.fs_init_from_host(ts, dev)
        host = self._prove_dev(inputs, fs, pads, consts, tabs).cpu().numpy()
        # [okq | y_ldt | y_dot | y_quad | idx | cols | sumcheck | fs]
        N = F.nlimb
        sizes = [1, p.block * N, p.dblock * N, p.dblock * N, p.nreq,
                 p.nrow * p.nreq * N]
        okq, y_ldt, y_dot, y_quad, idx, cols, rest = np.split(
            host, np.cumsum(sizes))
        assert okq[0], "W part of y_quad is nonzero"
        zkp.proof, _, _ = self.sumcheck._assemble(c, self.pad, rest, ts)
        zkp.com_proof = self.lp.assemble(
            y_ldt.reshape(-1, N), y_dot.reshape(-1, N),
            y_quad.reshape(-1, N), idx, cols.reshape(p.nrow, p.nreq, N))
        return True

    def _prove_dev(self, inputs, fs, pads, consts, tabs) -> torch.Tensor:
        """Everything between the first round and the one fetch, on the
        card, nothing read back: the sumcheck on fs, the constraints, the
        Ligero finish.  Returns the words to fetch (int32)."""
        F = self.F
        outs, rows = self.sumcheck._rounds(self.circ, inputs, fs, pads,
                                           consts)
        k = constraints_dev(F, tabs, outs, rows, pads, fs, consts["one"])
        lig = ligero_finish_dev(F, self.lp, tabs, fs, k)
        return torch.cat(
            [lig["okq"].to(torch.int32)[None]] +
            [lig[n].reshape(-1) for n in ("y_ldt", "y_dot", "y_quad", "idx",
                                          "cols")] +
            self.sumcheck.words(outs) + [fs.view(torch.int32)])

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
