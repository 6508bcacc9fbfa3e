"""The port's device Merkle commit (merkle/sha256_dev.py, the plain
version of K8, and merkle/merkle_dev.py, CPU) against hashlib, the
port's host MerkleTree and the JAX package's merkle_jax.  Exact: digest
bytes.  Inputs come from numpy seeds."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.merkle.merkle_jax import merkle_root_dev
from longfellow_zk_tpu_torch.merkle.merkle import (
    MerkleCommitment, MerkleTree, leaf_hash)
from longfellow_zk_tpu_torch.merkle.merkle_dev import merkle_heap
from longfellow_zk_tpu_torch.merkle.sha256_dev import sha256_msgs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain SHA-256 makes many small torch ops: one thread, so that
    they do not wait on the pool beside busy test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _msgs(rng, n, mlen):
    return rng.integers(0, 256, (n, mlen), dtype=np.uint8)


def test_sha256_msgs_matches_hashlib():
    """Every length from 0 to 130 (the padding's one- and two-block
    cases), 320 and the mdoc hash commit's 4,288-byte columns."""
    rng = np.random.default_rng(0)
    for mlen in list(range(131)) + [320, 4288]:
        m = _msgs(rng, 3, mlen)
        got = sha256_msgs(torch.from_numpy(m)).numpy()
        for row, d in zip(m, got):
            assert d.tobytes() == hashlib.sha256(row.tobytes()).digest(), \
                mlen


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 2047])
def test_merkle_heap_matches_host_tree(n):
    rng = np.random.default_rng(n)
    leaves = _msgs(rng, n, 32)
    heap = merkle_heap(torch.from_numpy(leaves)).numpy()
    tree = MerkleTree(n)
    tree.set_leaves([x.tobytes() for x in leaves])
    root = tree.build_tree()
    assert [row.tobytes() for row in heap[1:]] == tree.layers[1:]
    assert heap[1].tobytes() == root


def test_commit_heap_opens_like_commit_leaves():
    """A commitment from a device heap opens the same paths and nonces
    as one from host leaf digests."""
    rng = np.random.default_rng(7)
    n = 13
    cols = [rng.bytes(40) for _ in range(n)]
    nonces = [rng.bytes(32) for _ in range(n)]
    msgs = torch.from_numpy(np.frombuffer(
        b"".join(x + c for x, c in zip(nonces, cols)), np.uint8).reshape(
            n, 72).copy())
    a, b = MerkleCommitment(n), MerkleCommitment(n)
    ra = a.commit_heap(merkle_heap(sha256_msgs(msgs)).numpy(), nonces)
    rb = b.commit_leaves([leaf_hash(c, x) for c, x in zip(cols, nonces)],
                         nonces)
    assert ra == rb
    for pos in ([0], [3, 7, 12], list(range(n))):
        assert a.open(pos) == b.open(pos)


def test_merkle_heap_matches_jax_root():
    """The heap's root against the JAX package's merkle_root_dev (eager)
    at a small n that is not a power of two."""
    rng = np.random.default_rng(9)
    leaves = _msgs(rng, 5, 32)
    heap = merkle_heap(torch.from_numpy(leaves)).numpy()
    want = np.asarray(merkle_root_dev(jnp.asarray(leaves)))
    assert heap[1].tobytes() == want.tobytes()
