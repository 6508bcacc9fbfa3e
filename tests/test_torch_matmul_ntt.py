"""The port's matmul NTT (transforms/matmul_ntt.py, plain K17 version,
CPU) against the JAX package's transforms/matmul_ntt.py and the port's
radix-2 NTT on the same inputs, made from a numpy seed; the Reed-Solomon
code through `ntt_impl`; the toy Fp128 proof through that route against
its golden bytes.  Exact: tolerance 0.

The JAX side runs eagerly (its jitted programs compile for minutes on a
CPU at these sizes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.transforms.matmul_ntt import (
    MatmulNTT as JaxMatmulNTT, _matmul_ntt_block, _ntt_matrices,
    bytes_to_halfwords, halfwords_to_bytes)
from longfellow_zk_tpu_torch.fields.bridge import limbs_to_jax
from longfellow_zk_tpu_torch.fields.fp_instances import (
    P128_OMEGA, P128_OMEGA_ORDER, fp128)
from longfellow_zk_tpu_torch.random_oracle.engine import DeterministicEngine
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.transforms.matmul_ntt import (
    MatmulNTT, block_matrix_words, matmul_ntt_plain)
from longfellow_zk_tpu_torch.transforms.ntt import (
    NTT, make_fft_convolution_factory)
from longfellow_zk_tpu_torch.zk.proof import ZkProof
from longfellow_zk_tpu_torch.zk.prover import ZkProver
from longfellow_zk_tpu_torch.zk.serialization import (
    read_zk_proof, write_zk_proof)
from longfellow_zk_tpu_torch.zk.testing import rs_factory_for, rs_factory_with
from longfellow_zk_tpu_torch.zk.verifier import ZkVerifier

from test_torch_golden import (
    TOY_BIN, TOY_BLOCK_ENC, TOY_LABEL, TOY_NREQ, TOY_RATE, toy_inputs)
from test_torch_sumcheck import port_circuit
from test_zk import _zk_circuit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(shape, seed):
    """(JAX u32[8, *shape], port int32[*shape, 4]) of the same random
    Fp128 elements (0, 1 and p - 1 first)."""
    F = fp128()
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = ([0, 1, F.p - 1] + [int.from_bytes(rng.bytes(16), "little") % F.p
                               for _ in range(n)])[:n]
    px = F.to_limbs(vals, "cpu").reshape(tuple(shape) + (4,))
    return jnp.asarray(limbs_to_jax(px)), px


def _port(radix=16):
    return MatmulNTT(fp128(), P128_OMEGA, P128_OMEGA_ORDER, radix, "cpu")


@pytest.mark.parametrize("n", [2, 16, 64, 256])
def test_matmul_ntt_matches_jax_and_ntt(n):
    jx, px = _rows((n,), n)
    jm = JaxMatmulNTT(jax_fp128(), P128_OMEGA, P128_OMEGA_ORDER, radix=16)
    pm = _port()
    nt = NTT(fp128(), P128_OMEGA, P128_OMEGA_ORDER, "cpu")
    for port_fn, jax_fn, ntt_fn in ((pm.fftb, jm.fftb, nt.fftb),
                                    (pm.fftf, jm.fftf, nt.fftf)):
        got = port_fn(px)
        assert np.array_equal(limbs_to_jax(got), np.asarray(jax_fn(jx)))
        assert torch.equal(got, ntt_fn(px))


def test_matmul_ntt_batched():
    jx, px = _rows((3, 64), 7)
    jm = JaxMatmulNTT(jax_fp128(), P128_OMEGA, P128_OMEGA_ORDER, radix=16)
    got = _port().fftb(px)
    assert np.array_equal(limbs_to_jax(got), np.asarray(jm.fftb(jx)))
    assert torch.equal(got, NTT(fp128(), P128_OMEGA, P128_OMEGA_ORDER,
                                "cpu").fftb(px))


@pytest.mark.parametrize("B,inverse", [(16, False), (64, True)])
def test_block_plain_matches_jax_block(B, inverse):
    """K17's plain version on one block against the JAX package's
    _matmul_ntt_block + bytes_to_halfwords (the nibble matrices of
    _ntt_matrices, the carry and the fold)."""
    J, F = jax_fp128(), fp128()
    jx, px = _rows((1, B), 100 + B)
    w = _port()._root(B, inverse)
    lo, hi = _ntt_matrices(F.p, w, B)
    yb = _matmul_ntt_block(J, halfwords_to_bytes(jx), jnp.asarray(lo),
                           jnp.asarray(hi), B)
    want = np.asarray(bytes_to_halfwords(J, yb))
    G = torch.from_numpy(block_matrix_words(F.p, w, B))
    assert np.array_equal(limbs_to_jax(matmul_ntt_plain(F, px, G)), want)


def test_block_matrix_bytes_match_jax():
    """K17's packed matrix holds the bytes of the JAX package's matrix
    (its nibbles recombined, the padding input bytes dropped)."""
    F = fp128()
    B = 8
    w = _port()._root(B, False)
    lo, hi = _ntt_matrices(F.p, w, B)
    M = (lo + 16 * hi).astype(np.int64).reshape(B, 18, B, 16)[:, :16]
    g = block_matrix_words(F.p, w, B).view(np.uint32)[: 4 * B, : 16 * 16]
    g = g.reshape(B, 4, 16, 16)[..., :B].astype(np.int64)   # [n, q, b, k]
    by = np.stack([(g >> (8 * t)) & 0xFF for t in range(4)], axis=2)
    assert np.array_equal(by.reshape(B, 16, 16, B).transpose(0, 1, 3, 2), M)


@pytest.mark.parametrize("n,m", [(5, 13), (40, 200)])
def test_reed_solomon_through_ntt_impl(n, m):
    """ReedSolomon whose convolution runs its transforms in the matmul
    NTT equals the radix-2 (K4) route."""
    F = fp128()
    _, px = _rows((2, n), 200 + n)
    conv = make_fft_convolution_factory(F, P128_OMEGA, P128_OMEGA_ORDER,
                                        "cpu", ntt_impl=_port())
    got = rs_factory_with(F, conv, "cpu")(n, m).interpolate(px)
    want = rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER,
                          device="cpu")(n, m).interpolate(px)
    assert torch.equal(got, want)


def _matmul_rs():
    F = fp128()
    return rs_factory_with(F, make_fft_convolution_factory(
        F, P128_OMEGA, P128_OMEGA_ORDER, "cpu", ntt_impl=_port()), "cpu")


def test_toy_proof_through_matmul_ntt_equals_golden():
    """The toy Fp128 proof with the Reed-Solomon code through the matmul
    NTT (radix 16: padding 128 runs the recursion) equals the JAX
    package's golden bytes; the port's verifier with the same factory
    accepts it and refuses a copy with one bit flipped."""
    F = fp128()
    circ = port_circuit(_zk_circuit(jax_fp128()))
    W = toy_inputs(F.p)
    rs = _matmul_rs()
    zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
    prover = ZkProver(circ, F, rs, rate=TOY_RATE, nreq=TOY_NREQ,
                      block_enc=TOY_BLOCK_ENC, device="cpu")
    ts = Transcript(TOY_LABEL)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    data = write_zk_proof(zkp, circ, prover.param, F)
    with open(TOY_BIN, "rb") as f:
        assert data == f.read()

    def verify(data):
        v = ZkVerifier(circ, F, rs, rate=TOY_RATE, nreq=TOY_NREQ,
                       block_enc=TOY_BLOCK_ENC, device="cpu")
        zkp = read_zk_proof(data, circ, v.param, F, rate=TOY_RATE,
                            nreq=TOY_NREQ)
        ts = Transcript(TOY_LABEL)
        v.recv_commitment(zkp, ts)
        return v.verify(zkp, W[: circ.npub_in], ts)

    assert verify(data) == (True, "ok")
    bad = bytearray(data)
    bad[len(data) // 2] ^= 0x04
    assert verify(bytes(bad))[0] is False
