"""Versioned ZK specification registry.

Twin of reference lib/circuits/mdoc/zk_spec.cc:28-103 and the
ZkSpecStruct in mdoc_zk.h:114-132: (system, circuit_hash, num_attributes,
version, block_enc_hash, block_enc_sig) tuples that prover and verifier
negotiate.  The circuit hashes identify the reference's shipped circuit
files (lib/circuits/mdoc/circuits/); entries are interop configuration
data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ZkSpec:
    system: str
    circuit_hash: str
    num_attributes: int
    version: int
    block_enc_hash: int
    block_enc_sig: int


# Production Ligero parameters (mdoc_zk.h:33-37)
K_LIGERO_RATE = 4
K_LIGERO_NREQ = 128

ZK_SPECS = [
    # Circuits produced 2026-01-09 (version 7)
    ZkSpec("longfellow-libzk-v1",
           "8d079211715200ff06c5109639245502bfe94aa869908d31176aae4016182121",
           1, 7, 4151, 4096),
    ZkSpec("longfellow-libzk-v1",
           "6a5810683e62b6d7766ebd0d7ca72518a2b8325418142adcadb10d51dbbcd5ad",
           2, 7, 4265, 4096),
    ZkSpec("longfellow-libzk-v1",
           "8ee4849ae1293ae6fe5f9082ce3e5e15c4f198f2998c682fa1b727237d6d252f",
           3, 7, 4307, 4096),
    ZkSpec("longfellow-libzk-v1",
           "5aebdaaafe17296a3ef3ca6c80c6e7505e09291897c39700410a365fb278e460",
           4, 7, 4415, 4096),
    # Circuits produced 2025-10-10 (version 6)
    ZkSpec("longfellow-libzk-v1",
           "137e5a75ce72735a37c8a72da1a8a0a5df8d13365c2ae3d2c2bd6a0e7197c7c6",
           1, 6, 4096, 2945),
    ZkSpec("longfellow-libzk-v1",
           "b4bb6f01b7043f4f51d8302a30b36e3d4d2d0efc3c24557ab9212ad524a9764e",
           2, 6, 4025, 2945),
    ZkSpec("longfellow-libzk-v1",
           "b2211223b954b34a1081e3fbf71b8ea2de28efc888b4be510f532d6ba76c2010",
           3, 6, 4121, 2945),
    ZkSpec("longfellow-libzk-v1",
           "c70b5f44a1365c53847eb8948ad5b4fdc224251a2bc02d958c84c862823c49d6",
           4, 6, 4283, 2945),
    # Circuits produced 2025-08-21 (version 5)
    ZkSpec("longfellow-libzk-v1",
           "f88a39e561ec0be02bb3dfe38fb609ad154e98decbbe632887d850fc612fea6f",
           1, 5, 4096, 2945),
    ZkSpec("longfellow-libzk-v1",
           "f51b7248b364462854d306326abded169854697d752d3bb6d9a9446ff7605ddb",
           2, 5, 4025, 2945),
    ZkSpec("longfellow-libzk-v1",
           "c27195e03e22c9ab4efe9e1dabd2c33aa8b2429cc4e86410c6f12542d3c5e0a1",
           3, 5, 4121, 2945),
    ZkSpec("longfellow-libzk-v1",
           "fa5fadfb2a916d3b71144e9b412eff78f71fd6a6d4607eac10de66b195868b7a",
           4, 5, 4283, 2945),
]


def find_zk_spec(system: str, circuit_hash: str) -> Optional[ZkSpec]:
    for spec in ZK_SPECS:
        if spec.system == system and spec.circuit_hash == circuit_hash:
            return spec
    return None


def find_zk_spec_by_version(version: int, num_attributes: int
                            ) -> Optional[ZkSpec]:
    for spec in ZK_SPECS:
        if spec.version == version and spec.num_attributes == num_attributes:
            return spec
    return None
