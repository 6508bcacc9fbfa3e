"""Merkle tree with compressed multi-leaf proofs, and the nonce-blinded
commitment used by Ligero.

Byte-exact twin of the reference (lib/merkle/merkle_tree.h:43-214,
lib/merkle/merkle_commitment.h:31-97): heap layout over 2n digests
(leaves at [n, 2n)), parent i = SHA256(child(2i) || child(2i+1)), root at
index 1; compressed proofs include only the siblings that cannot be
recomputed.  Works for any n >= 1 (not just powers of two) exactly as
the reference's index arithmetic does.

The Ligero prover hashes the leaves (nonce || column) and builds the
heap on the device (merkle_dev.merkle_heap) and hands this module the
whole heap (`MerkleCommitment.commit_heap`), which opens columns from it
with no hashing; `commit_leaves` builds the tree from leaf digests on
the host.  The verifiers (MerkleTreeVerifier, MerkleCommitmentVerifier,
merkle.py:88-170 of the JAX package) recompute the root from the opened
leaves on the host.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np

DIGEST_LEN = 32


def hash2(l: bytes, r: bytes) -> bytes:
    return hashlib.sha256(l + r).digest()


def merkle_tree_len(n: int) -> int:
    """Worst-case proof length bound (merkle_tree.h:64-71)."""
    r = 1
    pos = (n - 1) + n
    while pos > 1:
        r += 1
        pos >>= 1
    return r


def _proof_tree(n: int, pos: Sequence[int]) -> List[bool]:
    """Mark all nodes on root->leaf paths (merkle_tree.h:75-98)."""
    assert len(pos) > 0, "A Merkle proof with 0 leaves is not defined."
    tree = [False] * (2 * n)
    for p in pos:
        assert 0 <= p < n, "Invalid position for leaf in Merkle tree"
        assert not tree[p + n], "duplicate position"
        tree[p + n] = True
    for i in range(n - 1, 0, -1):
        tree[i] = tree[2 * i] or tree[2 * i + 1]
    assert tree[1]
    return tree


class MerkleTree:
    def __init__(self, n: int):
        self.n = n
        self.layers: List[bytes] = [b"\x00" * DIGEST_LEN] * (2 * n)

    def set_leaf(self, pos: int, digest: bytes):
        assert 0 <= pos < self.n
        assert len(digest) == DIGEST_LEN
        self.layers[pos + self.n] = digest

    def set_leaves(self, digests: Sequence[bytes]):
        assert len(digests) == self.n
        for i, d in enumerate(digests):
            self.set_leaf(i, d)

    def build_tree(self) -> bytes:
        for i in range(self.n - 1, 0, -1):
            self.layers[i] = hash2(self.layers[2 * i], self.layers[2 * i + 1])
        return self.layers[1]

    def generate_compressed_proof(self, pos: Sequence[int]) -> List[bytes]:
        """Proof digests, root-downward order (merkle_tree.h:122-143)."""
        tree = _proof_tree(self.n, pos)
        proof = []
        for i in range(self.n - 1, 0, -1):
            if tree[i]:
                child = 2 * i
                if tree[child]:
                    child = 2 * i + 1
                if not tree[child]:
                    proof.append(self.layers[child])
        return proof


class MerkleTreeVerifier:
    def __init__(self, n: int, root: bytes):
        self.n = n
        self.root = root

    def verify_compressed_proof(self, proof: List[bytes],
                                leaves: Sequence[bytes],
                                pos: Sequence[int]) -> bool:
        n = self.n
        layers = [b""] * (2 * n)
        defined = [False] * (2 * n)
        try:
            tree = _proof_tree(n, pos)
        except AssertionError:
            return False
        sz = 0
        for i in range(n - 1, 0, -1):
            if tree[i]:
                child = 2 * i
                if tree[child]:
                    child = 2 * i + 1
                if not tree[child]:
                    if sz >= len(proof):
                        return False
                    layers[child] = proof[sz]
                    sz += 1
                    defined[child] = True
        if sz != len(proof):
            return False
        for p, leaf in zip(pos, leaves):
            layers[p + n] = leaf
            defined[p + n] = True
        for i in range(n - 1, 0, -1):
            if defined[2 * i] and defined[2 * i + 1]:
                layers[i] = hash2(layers[2 * i], layers[2 * i + 1])
                defined[i] = True
        return defined[1] and layers[1] == self.root


# ---------------------------------------------------------------------------
# Nonce-blinded commitment (merkle_commitment.h)
# ---------------------------------------------------------------------------

NONCE_LEN = 32  # MerkleNonce::kLength == kSHA256DigestSize


def leaf_hash(column_bytes: bytes, nonce: bytes) -> bytes:
    """H(32-byte nonce || column bytes) (merkle_commitment.h:50-61:
    the nonce is absorbed first, then the column)."""
    return hashlib.sha256(nonce + column_bytes).digest()


class MerkleCommitment:
    """Hiding commitment: each leaf is H(column, nonce)
    (merkle_commitment.h:31-82)."""

    def __init__(self, n: int):
        self.n = n
        self.tree = MerkleTree(n)
        self.nonces: List[bytes] = []

    def commit_leaves(self, leaf_digests: Sequence[bytes],
                      nonces: Sequence[bytes]) -> bytes:
        """Leaves must already be H(column||nonce) digests (device-hashed)."""
        assert len(leaf_digests) == self.n
        self.nonces = list(nonces)
        self.tree.set_leaves(leaf_digests)
        return self.tree.build_tree()

    def commit_heap(self, heap, nonces: Sequence[bytes]) -> bytes:
        """Takes a heap built elsewhere (uint8 [2n, 32], as a numpy array:
        node 1 the root, leaves at [n, 2n)) and returns its root."""
        heap = np.asarray(heap, dtype=np.uint8)
        assert heap.shape == (2 * self.n, DIGEST_LEN)
        self.nonces = list(nonces)
        self.tree.layers = [row.tobytes() for row in heap]
        return self.tree.layers[1]

    def open(self, pos: Sequence[int]):
        proof = self.tree.generate_compressed_proof(pos)
        nonces = [self.nonces[p] for p in pos]
        return proof, nonces


class MerkleCommitmentVerifier:
    def __init__(self, n: int, root: bytes):
        self.inner = MerkleTreeVerifier(n, root)

    def verify(self, proof: List[bytes], columns: Sequence[bytes],
               nonces: Sequence[bytes], pos: Sequence[int]) -> bool:
        leaves = [leaf_hash(c, nc) for c, nc in zip(columns, nonces)]
        return self.inner.verify_compressed_proof(proof, leaves, pos)
