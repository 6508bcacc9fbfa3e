"""The Merkle tree of the Ligero commitment, built on the leaves' device.

Port of the JAX package's merkle/merkle_jax.py:57 `merkle_root_dev`,
returning the whole heap instead of the root, so that the host
`MerkleCommitment` opens columns from it without hashing.

The heap of n leaves stores leaf i at node n + i and internal node
i = SHA-256(node 2i || node 2i + 1) (node 0 is unused and zero), the
layout of the host `MerkleTree` (merkle/merkle.py).  Each level is one
`sha256_msgs` call (K8 on the card): the parents [lo, hi) with
lo = ceil(hi / 2) hash their children [2 lo, 2 hi), which are contiguous
and already computed, so any n, not only a power of two, gives the host
tree's nodes.
"""

from __future__ import annotations

import torch

from .sha256_dev import DIGEST_LEN, sha256_msgs


def merkle_heap(leaves: torch.Tensor) -> torch.Tensor:
    """uint8 [n, 32] leaf digests -> uint8 [2n, 32] heap; the root is
    node 1 (the leaf itself when n = 1)."""
    n = leaves.shape[0]
    if leaves.dtype != torch.uint8 or tuple(leaves.shape[1:]) != \
            (DIGEST_LEN,) or n < 1:
        raise ValueError("leaves must be a uint8 [n >= 1, 32] tensor")
    heap = torch.zeros((2 * n, DIGEST_LEN), dtype=torch.uint8,
                       device=leaves.device)
    heap[n:] = leaves
    hi = n
    while hi > 1:
        lo = (hi + 1) // 2
        heap[lo:hi] = sha256_msgs(
            heap[2 * lo : 2 * hi].reshape(hi - lo, 2 * DIGEST_LEN))
        hi = lo
    return heap
