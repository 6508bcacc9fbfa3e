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
test_torch_batch.py; on the card, chip_smoke.py).  Not ported: the
JAX package's mesh sharding of the proof axis (`_dp`, :209), its
one-program branch (:159-206) and the per-proof fallback
(`_scalar_fallback`), which exist for the TPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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
                 block_enc: Optional[int] = None, device=None):
        """rs_factory must encode on the same device
        (zk.testing.rs_factory_for(..., device=...))."""
        self.circ = circ
        self.F = F
        self.rate = rate
        self.nreq = nreq
        self.prover = ZkProver(circ, F, rs_factory, rate=rate, nreq=nreq,
                               block_enc=block_enc, device=device)
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
        zkps = [ZkProof(rate=self.rate, nreq=self.nreq) for _ in range(B)]
        self.prover.commit_lanes(zkps, W_list, ts_list, rng)
        oks = self.prover.prove_lanes(zkps, W_list, ts_list)
        bad = [b for b, ok in enumerate(oks) if not ok]
        if bad:
            raise ValueError("the witness of lane %s does not satisfy the "
                             "circuit" % ", ".join(map(str, bad)))
        return [write_zk_proof(zkp, self.circ, self.param, self.F)
                for zkp in zkps]
