"""Batched ZK proving: B proofs of one circuit in one lane-batched run
on the card.

Port of the JAX package's zk/batch.py BatchZkProver (`prove_batch`, :94,
with its phased flow, `_phased_batch`, :254).  The JAX package vmaps its
device programs over a proof axis; the port's kernels take that axis as
a lane axis (K1's bind and hv, K3, K9 and its column choice, K10, K11,
K12 one block or grid row a lane; K2, K4-K6 and K8 the lanes as more
rows, messages or offset segments), so a batch of B proofs runs in the
launches of one proof.  The flow is the prover's one flow
(zk/prover.py `commit_lanes`, `prove_lanes`), of which a single proof is
the case B = 1:

  1. host prep, lane by lane: each lane's pad and tableau rows from the
     one randomness stream, in lane order (the JAX package's :104-116);
  2. one batched commit: the RS encode of every lane's rows, the column
     hashes and the Merkle heaps, one copy back; each root to its lane's
     transcript (:118-146);
  3. the evaluation of every lane, one flag a lane read back; an
     unsatisfied lane raises, naming it, before any round runs;
  4. the sumcheck, the constraint build and the Ligero finish with a
     lane axis, nothing read back (:301, :344, :375);
  5. one fetch, then each lane's proof assembled on the host.

Each lane's proof is byte-identical to the scalar ZkProver's with the
same transcript tag and the same randomness stream (tests/
test_torch_batch.py; on the card, chip_smoke.py).

With a mesh (parallel/mesh.py; the JAX package's mesh= and `_dp`,
:75-86, :209: the proof axis sharded, data parallelism) the B lanes are
split over the mesh's rows axis, B / D a rank (B % D == 0): rank 0
draws every lane's pad and tableau rows from the one stream, lane by
lane (step 1, as above), and broadcasts them; each rank runs steps 2-5
on its lanes, with no traffic between the cards; the proofs and the
lanes' final transcript states are all-gathered, so that every rank
returns the B proofs in lane order and every lane's transcript ends in
its state.  The proofs are the unsharded batch's, the scalar ZkProver's
(the JAX package's mesh path is held to nothing: its proofs differ from
its unsharded ones, tests/test_mesh_prover.py test_batch_prover_mesh_dp).
Not ported: the JAX package's one-program branch (:159-206) and the
per-proof fallback (`_scalar_fallback`), which exist for the TPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..parallel.mesh import mesh_device
from ..sumcheck.circuit import Circuit
from .proof import ZkProof
from .prover import ZkProver
from .serialization import write_zk_proof


class BatchZkProver:
    """Proves batches of witnesses of one circuit (same shapes, same
    Ligero parameters: the serving configuration) on `device` (the card
    unless the caller passes device="cpu", which runs the kernels' plain
    versions)."""

    def __init__(self, circ: Circuit, F, rs_factory, rate: int, nreq: int,
                 block_enc: Optional[int] = None, device=None, mesh=None):
        """rs_factory must encode on the same device
        (zk.testing.rs_factory_for(..., device=...)); with a mesh, the
        mesh's device."""
        self.circ = circ
        self.F = F
        self.rate = rate
        self.nreq = nreq
        self.mesh = mesh
        # each rank proves its lanes as one card does: no mesh below
        self.prover = ZkProver(circ, F, rs_factory, rate=rate, nreq=nreq,
                               block_enc=block_enc,
                               device=mesh_device(mesh, device))
        self.param = self.prover.param

    def prove_batch(self, W_list: Sequence[List], ts_list,
                    rng) -> List[bytes]:
        """W_list: B witness vectors (all input wires, public first);
        ts_list: B independent transcripts, already initialized with their
        tags; rng: the one randomness stream, consumed lane by lane.
        Returns the B serialized proofs.  Raises ValueError naming the
        lanes whose witness does not satisfy the circuit."""
        B = len(W_list)
        if B == 0 or B != len(ts_list):
            raise ValueError("need one transcript for each of B > 0 "
                             "witnesses, got %d and %d"
                             % (B, len(ts_list)))
        if self.mesh is None:
            zkps = [ZkProof(rate=self.rate, nreq=self.nreq)
                    for _ in range(B)]
            self.prover.commit_lanes(zkps, W_list, ts_list, rng)
            blobs, bad = self._prove(zkps, W_list, ts_list, range(B))
            _refuse(bad)
            return blobs
        mesh = self.mesh
        D = mesh.size("rows")
        if B % D:
            raise ValueError("a batch of %d lanes does not split over the "
                             "%d ranks of the mesh's rows axis" % (B, D))
        drawn = mesh.broadcast_object(self.prover.draw_lanes(W_list, rng)
                                      if mesh.rank == 0 else None)
        lo, hi = mesh.bounds(B)
        zkps = [ZkProof(rate=self.rate, nreq=self.nreq)
                for _ in range(lo, hi)]
        self.prover.commit_drawn(zkps, ts_list[lo:hi],
                                 *(d[lo:hi] for d in drawn))
        mine, bad = self._prove(zkps, W_list[lo:hi], ts_list[lo:hi],
                                range(lo, hi))
        # every rank learns every rank's verdict before any raises
        parts = mesh.all_gather_object(
            (mine, bad, [ts.export_state() for ts in ts_list[lo:hi]]))
        _refuse([b for _, bad, _ in parts for b in bad])
        blobs = []
        for part, _, states in parts:
            for ts, st in zip(ts_list[len(blobs):], states):
                ts.import_state(st)
            blobs += part
        return blobs

    def _prove(self, zkps, W_list, ts_list, lanes):
        """The prove of the committed lanes (numbered `lanes` in the
        batch): (their proofs' bytes, the lanes that do not satisfy the
        circuit); no proofs if one does not."""
        oks = self.prover.prove_lanes(zkps, W_list, ts_list)
        bad = [b for b, ok in zip(lanes, oks) if not ok]
        return [] if bad else [write_zk_proof(zkp, self.circ, self.param,
                                              self.F) for zkp in zkps], bad


def _refuse(bad: List[int]) -> None:
    if bad:
        raise ValueError("the witness of lane %s does not satisfy the "
                         "circuit" % ", ".join(map(str, bad)))
