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
tree's nodes.  A leading lane axis holds the trees of a batch of proofs
(the jax.vmap of the JAX package's zk/batch.py:124): one call a level for
all of them.
"""

from __future__ import annotations

import torch

from .sha256_dev import DIGEST_LEN, sha256_msgs


def merkle_heap(leaves: torch.Tensor) -> torch.Tensor:
    """uint8 [n, 32] leaf digests -> uint8 [2n, 32] heap; the root is
    node 1 (the leaf itself when n = 1).  With a lane axis, [B, n, 32] ->
    [B, 2n, 32], B heaps in the launches of one."""
    if leaves.dtype != torch.uint8 or leaves.dim() not in (2, 3) or \
            leaves.shape[-1] != DIGEST_LEN or leaves.shape[-2] < 1:
        raise ValueError("leaves must be a uint8 [n >= 1, 32] or [B, n, 32] "
                         "tensor")
    lanes = leaves.reshape((-1,) + tuple(leaves.shape[-2:]))
    B, n = lanes.shape[:2]
    heap = torch.zeros((B, 2 * n, DIGEST_LEN), dtype=torch.uint8,
                       device=leaves.device)
    heap[:, n:] = lanes
    hi = n
    while hi > 1:
        lo = (hi + 1) // 2
        heap[:, lo:hi] = sha256_msgs(
            heap[:, 2 * lo : 2 * hi].reshape(B * (hi - lo), 2 * DIGEST_LEN)
        ).reshape(B, hi - lo, DIGEST_LEN)
        hi = lo
    return heap.reshape(leaves.shape[:-2] + (2 * n, DIGEST_LEN))
