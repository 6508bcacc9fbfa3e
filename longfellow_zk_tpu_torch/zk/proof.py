"""ZK proof container (serialization in zk/serialization.py; reference
lib/zk/zk_proof.h:46-378)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..ligero.param import LigeroCommitment, LigeroProof
from ..sumcheck.circuit import Proof


@dataclass
class ZkProof:
    rate: int
    nreq: int
    com: Optional[LigeroCommitment] = None
    proof: Optional[Proof] = None  # padded sumcheck proof
    com_proof: Optional[LigeroProof] = None
