"""ZK prover: Longfellow composition of sumcheck + Ligero
(reference lib/zk/zk_prover.h:36-198); port of the JAX package's
ZkProver with its phased prove.

Commit to [private witness | random pad], run the sumcheck prover with
the pad subtracted from every transcript message (the encrypted
transcript), then prove via Ligero that the committed pad+witness
decrypt the transcript into something the sumcheck verifier accepts.

The prover's one flow runs B lanes at once: the proofs of B witnesses of
one circuit, each on its own transcript, in the launches of one proof
(`commit_lanes`, `prove_lanes`; zk/batch.py's BatchZkProver calls them
for a batch, `commit` and `prove` for one proof, B = 1).  The commit
draws each lane's pad and tableau rows on the host in lane order, from
one randomness stream, then encodes and hashes every lane on the card
and brings the Merkle heaps back in one copy.  After the commit, the
prove reads one value back (every lane's evaluation check), uploads
every table its steps need, then runs on the card, with the transcripts
there too, nothing read back between them: the sumcheck
(sumcheck/prover.py), the linear constraints (K11, zk/fused.py), the
Ligero finish (K12, the responses, K9's draws, writes and column choice,
zk/fused.py); then one fetch, from which the host assembles each lane's
proof and each lane's transcript takes its final state.

With a mesh (parallel/mesh.py; the JAX package's ZkProver(mesh=),
zk/prover.py:34-64, :117-126) the tableau's rows go over the mesh's rows
axis (ligero/prover.py: the encode, the column hashes and the responses'
sums over rows sharded), and the copies of the sumcheck over its cols
axis (sumcheck/prover.py; the ZK replay takes no copies, logc = 0, so a
ZK proof shards only rows).  The host's draws, the pads and the tableau
rows (`draw_lanes`), are made on rank 0 alone, in the one card's order,
and broadcast, so that an engine with a stream of its own on each rank
(SecureRandomEngine) commits every rank to rank 0's tableau.  The
sumcheck, the constraint build (K11) and the Ligero finish (K12, K9)
run on every rank, whose transcripts stay equal, and every rank returns
the one card's proof, byte for byte.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ligero.param import LigeroCommitment, LigeroParam
from ..ligero.prover import LigeroProver
from ..ligero.transcript import write_commitment
from ..parallel.mesh import mesh_device
from ..random_oracle import device_fs as dfs
from ..sumcheck.circuit import Circuit, LayerProof, Proof
from ..sumcheck.prover import SumcheckProver
from .common import initialize_sumcheck_fiat_shamir, pad_size, setup_lqc
from .fused import constraints_dev, fused_static, ligero_finish_dev, prepare
from .proof import ZkProof


class ZkProver:
    def __init__(self, circ: Circuit, F, rs_factory, rate: int, nreq: int,
                 block_enc: Optional[int] = None, device=None, mesh=None):
        """rs_factory must encode on the same device
        (zk.testing.rs_factory_for(..., device=...)); with a mesh, the
        mesh's device."""
        self.circ = circ
        self.F = F
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.rs_factory = rs_factory
        self.n_witness = circ.ninputs - circ.npub_in
        self.param = LigeroParam(
            nw=self.n_witness + pad_size(circ), nq=circ.nl, rateinv=rate,
            nreq=nreq, block_enc=block_enc,
            subfield_bytes=F.kSubFieldBytes, field_bytes=F.kBytes)
        self.lqc = setup_lqc(circ, self.n_witness)
        self.pad: Optional[Proof] = None
        self.witness: Optional[List] = None
        self.pads: List[Proof] = []  # the committed lanes' pads
        self.lp: Optional[LigeroProver] = None
        self.sumcheck = SumcheckProver(F, self.device, mesh)

    def commit(self, zkp: ZkProof, W_host: List, ts, rng) -> None:
        """(zk_prover.h:72-100).  W_host: all input wires (public first)."""
        self.commit_lanes([zkp], [W_host], [ts], rng)

    def prove(self, zkp: ZkProof, W_host: List, ts) -> bool:
        """(zk_prover.h:102-149): the evaluation check, the uploads, the
        device chain (_prove_dev), one fetch; ts ends where the host
        prover's transcript would (its PRF aside).  False if the witness
        does not satisfy the circuit."""
        return self.prove_lanes([zkp], [W_host], [ts])[0]

    def commit_lanes(self, zkps: List[ZkProof], Ws: List[List], tss,
                     rng) -> None:
        """The commit of B lanes (W: all input wires, public first; ts
        each lane's transcript): each lane's pad and tableau rows on the
        host, in lane order from the one stream rng (the JAX package's
        zk/batch.py:104-116), then one device commit of every lane (the
        jax.vmap of its _commit_full_fn, :118-134) and each root written
        to its lane's transcript (:136-146)."""
        if self.mesh is None:
            drawn = self.draw_lanes(Ws, rng)
        else:
            drawn = self.mesh.broadcast_object(
                self.draw_lanes(Ws, rng) if self.mesh.rank == 0 else None)
        self.commit_drawn(zkps, tss, *drawn)

    def draw_lanes(self, Ws: List[List], rng):
        """The host's draws of the lanes' commit, from the one stream rng
        in lane order: (each lane's pad, each lane's _commit_prep)."""
        c = self.circ
        subfield_boundary = max(0, c.subfield_boundary - c.npub_in)
        lp = LigeroProver(self.param, self.F, self.rs_factory, self.device)
        pads, preps = [], []
        for W_host in Ws:
            self.witness = list(W_host[c.npub_in : c.ninputs])
            self._fill_pad(rng)
            pads.append(self.pad)
            preps.append(lp._commit_prep(self.witness, subfield_boundary,
                                         self.lqc, rng))
        return pads, preps

    def commit_drawn(self, zkps: List[ZkProof], tss, pads: List,
                     preps: List) -> None:
        """The device commit of the lanes drawn by draw_lanes, and each
        root written to its lane's transcript."""
        self.lp = LigeroProver(self.param, self.F, self.rs_factory,
                               self.device, self.mesh)
        self.pads = list(pads)
        for zkp, ts, root in zip(zkps, tss, self.lp.commit(preps)):
            zkp.com = LigeroCommitment(root=root)
            write_commitment(zkp.com, ts)

    def prove_lanes(self, zkps: List[ZkProof], Ws: List[List],
                    tss) -> List[bool]:
        """The prove of the committed lanes, each on its own transcript:
        every lane's evaluation check, read back in one copy; if every
        lane holds, the device chain of all lanes and one fetch, then each
        lane's proof and final transcript state.  Returns each lane's
        flag; if one lane fails, no lane is proved (nothing after the
        evaluation runs)."""
        c, F, p, dev = self.circ, self.F, self.param, self.device
        B = len(Ws)
        assert self.lp is not None and len(self.pads) == B, \
            "must commit these lanes before the prove"
        for W_host, ts in zip(Ws, tss):
            initialize_sumcheck_fiat_shamir(ts, c, W_host, F)
        W0 = F.to_limbs([w for W_host in Ws for w in W_host[: c.ninputs]],
                        dev).reshape((B, c.ninputs) + F.elt_shape)
        inputs, flags = self.sumcheck.evaluate(c, W0)
        oks = flags.tolist()
        if not all(oks):
            # one lane's failing assert-zero term clears every lane's
            # flag: find which lanes fail by evaluating each alone
            return oks if B == 1 else [
                bool(self.sumcheck.evaluate(c, W0[b : b + 1])[1].item())
                for b in range(B)]
        # every upload before the first round (the responses' encoder
        # went up with the commit)
        pads, consts = self.sumcheck.prepare(c, self.pads)
        tabs = prepare(F, fused_static(c, p, self.lqc, self.n_witness), dev)
        fs = torch.stack([dfs.fs_init_from_host(ts, "cpu")
                          for ts in tss]).to(dev)
        host = self._prove_dev(inputs, fs, pads, consts, tabs).cpu().numpy()
        # a lane's words: [okq | y_ldt | y_dot | y_quad | idx | cols |
        # sumcheck | fs]
        N = F.nlimb
        sizes = [1, p.block * N, p.dblock * N, p.dblock * N, p.nreq,
                 p.nrow * p.nreq * N]
        for b, (zkp, ts) in enumerate(zip(zkps, tss)):
            okq, y_ldt, y_dot, y_quad, idx, cols, rest = np.split(
                host[b], np.cumsum(sizes))
            assert okq[0], "W part of y_quad is nonzero"
            zkp.proof, _, _ = self.sumcheck._assemble(c, self.pads[b], rest,
                                                      ts)
            zkp.com_proof = self.lp.assemble(
                b, y_ldt.reshape(-1, N), y_dot.reshape(-1, N),
                y_quad.reshape(-1, N), idx, cols.reshape(p.nrow, p.nreq, N))
        return oks

    def _prove_dev(self, inputs, fs, pads, consts, tabs) -> torch.Tensor:
        """Everything between the first round and the one fetch, on the
        card, for the lanes of fs [B, 104], nothing read back: the
        sumcheck on fs, the constraints, the Ligero finish.  Returns the
        words to fetch (int32 [B, .], a row a lane)."""
        F = self.F
        B = fs.shape[0]
        outs, rows = self.sumcheck._rounds(self.circ, inputs, fs, pads,
                                           consts)
        k = constraints_dev(F, tabs, outs, rows, pads, fs, consts["one"])
        lig = ligero_finish_dev(F, self.lp, tabs, fs, k)
        return torch.cat(
            [lig["okq"].to(torch.int32)[:, None]] +
            [lig[n].reshape(B, -1) for n in ("y_ldt", "y_dot", "y_quad",
                                             "idx", "cols")] +
            self.sumcheck.words(outs) + [fs.view(torch.int32)], dim=1)

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
