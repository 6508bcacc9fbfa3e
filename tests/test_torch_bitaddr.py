"""The secp256k1 bitaddr slice of the port against the JAX package, on
the CPU: the host witness (BitaddrWitness, the RIPEMD-160 and SHA-256
witnesses, the public-key derivation), the circuit file
artifacts/bitaddr_p256k1.lfc1.gz in both LFC1 readers, and the toy
secp256k1 ZK proof with the CRT Reed-Solomon code: the port's CPU proof
equals the JAX package's golden bytes, the JAX ZkVerifier accepts them
and the port's verifier refuses one-bit flips.

The slow tests hold the full-size golden (testdata/bitaddr_p256k1.proof.bin,
made by the port's CPU path) to a fresh CPU proof, to the JAX ZkVerifier
with the JAX CRT factory and to the JAX compiler's circuit.
"""

import gzip
import hashlib
import os
import random

import numpy as np
import pytest
import torch

from longfellow_zk_tpu.circuits.bitaddr import (
    BitaddrWitness as JaxBitaddrWitness)
from longfellow_zk_tpu.circuits.ripemd.reference import (
    ripemd160 as jax_ripemd160)
from longfellow_zk_tpu.ec.curves import p256k1_curve as jax_p256k1_curve
from longfellow_zk_tpu.fields.fp_instances import p256k1_base as jax_p256k1
from longfellow_zk_tpu.proto.lfc1 import read_circuit as jax_read_circuit
from longfellow_zk_tpu.random_oracle.transcript import (
    Transcript as JaxTranscript)
from longfellow_zk_tpu.zk.serialization import (
    read_zk_proof as jax_read_zk_proof)
from longfellow_zk_tpu.zk.verifier import ZkVerifier as JaxZkVerifier

from longfellow_zk_tpu_torch.circuits.bitaddr.bitaddr import BitaddrWitness
from longfellow_zk_tpu_torch.circuits.ripemd.reference import ripemd160
from longfellow_zk_tpu_torch.circuits.sha.sha256 import message_witness
from longfellow_zk_tpu_torch.ec.curves import p256k1_curve
from longfellow_zk_tpu_torch.fields.bridge import circuit_from_arrays
from longfellow_zk_tpu_torch.fields.fp_instances import p256k1_base
from longfellow_zk_tpu_torch.proto.lfc1 import SECP_ID, read_circuit
from longfellow_zk_tpu_torch.random_oracle.engine import DeterministicEngine
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.zk.proof import ZkProof
from longfellow_zk_tpu_torch.zk.prover import ZkProver
from longfellow_zk_tpu_torch.zk.serialization import (
    read_zk_proof, write_zk_proof)
from longfellow_zk_tpu_torch.zk.testing import K_VERSION, rs_factory_for
from longfellow_zk_tpu_torch.zk.verifier import ZkVerifier

from test_torch_golden import (
    BITADDR_BIN, BITADDR_CIRCUIT, BITADDR_LABEL, NREQ, RATE, TOY_BLOCK_ENC,
    TOY_LABEL, TOY_NREQ, TOY_P256K1_BIN, TOY_RATE, bitaddr_witness,
    jax_bitaddr_circuit, jax_crt_rs_factory, port_bitaddr_proof, toy_inputs)
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


def test_ripemd160_and_sha_witness():
    """The port's RIPEMD-160 against the JAX package's (and the empty
    message's published digest), and the SHA-256 message witness's
    digest against hashlib, over block boundaries."""
    assert ripemd160(b"").hex() == "9c1185a5c5e9fc54612808977ee8f548b2258d31"
    for n in (0, 1, 55, 56, 64, 119, 200):
        msg = bytes(range(n % 256))[:n] * 1
        assert ripemd160(msg) == jax_ripemd160(msg)
        nb, padded, bws, digest = message_witness(msg, 4)
        assert digest == hashlib.sha256(msg).digest()
        assert len(padded) == 256 and len(bws) == 4


@pytest.mark.parametrize("seed", [21, 23])
def test_bitaddr_witness_matches_jax(seed):
    """BitaddrWitness.fill() equals the JAX package's for a seeded key:
    the public key's bits and projective steps, the SHA-256 block and the
    RIPEMD-160 steps, packed by the bit plucker."""
    ec, F = p256k1_curve(), p256k1_base()
    sk = random.Random(seed).randrange(1, ec.order)
    bw = BitaddrWitness(ec, F)
    bw.compute_witness(sk)
    jw = JaxBitaddrWitness(jax_p256k1_curve(), jax_p256k1())
    jw.compute_witness(sk)
    got = bw.fill()
    assert len(got) == 9679 and got == jw.fill()
    assert bw.addr == jw.addr
    pk = ec.normalize(ec.scalar_mult(ec.generator(), sk))
    compressed = bytes([2 + (pk.y & 1)]) + pk.x.to_bytes(32, "big")
    assert bw.addr == int.from_bytes(
        ripemd160(hashlib.sha256(compressed).digest()), "big")


def test_circuit_file_parses_in_both_readers():
    """artifacts/bitaddr_p256k1.lfc1.gz: the same circuit, with the same
    id, in the port's and the JAX package's LFC1 readers; its size as
    compiled (8 layers, 406,801 terms, 9,681 inputs, 2 public)."""
    F, J = p256k1_base(), jax_p256k1()
    data = gzip.open(BITADDR_CIRCUIT, "rb").read()
    pc = read_circuit(F, SECP_ID, data)
    jc = jax_read_circuit(J, SECP_ID, data)
    assert pc is not None and pc.id == jc.id
    assert (pc.nl, pc.ninputs, pc.npub_in, pc.nc, pc.logc) == \
        (jc.nl, jc.ninputs, jc.npub_in, 1, 0) == (8, 9681, 2, 1, 0)
    assert [l.logw for l in pc.layers] == [9, 10, 12, 15, 16, 15, 16, 14]
    assert sum(l.nterms for l in pc.layers) == 406801
    for lp, lj in zip(pc.layers, jc.layers):
        assert (lp.nw, lp.logw) == (lj.nw, lj.logw)
        for k in ("g", "h0", "h1", "kidx"):
            assert np.array_equal(getattr(lp.quad, k), getattr(lj.quad, k))
        assert list(lp.quad.ktable) == list(lj.quad.ktable)
    # another field's reader refuses it
    assert read_circuit(F, SECP_ID - 1, data) is None


def test_jax_compiler_reproduces_circuit_file():
    """The JAX package's compiler (QuadCircuit, Logic, BitaddrCircuit)
    writes the committed circuit file's bytes (about 18 s)."""
    data, circ = jax_bitaddr_circuit()
    assert data == gzip.open(BITADDR_CIRCUIT, "rb").read()
    assert circ.id.hex().startswith("16cf5be7")


# ----------------------------------------------------------------------
# the toy secp256k1 proof with the CRT Reed-Solomon code
# ----------------------------------------------------------------------

def _toy():
    """(JAX circuit, port circuit, witness) of the toy circuit of
    tests/test_zk.py over the secp256k1 base field."""
    J, F = jax_p256k1(), p256k1_base()
    jc = _zk_circuit(J)
    layers = [dict(nw=l.nw, logw=l.logw, g=l.quad.g, h0=l.quad.h0,
                   h1=l.quad.h1, v=J.to_limbs(list(l.quad.v)))
              for l in jc.layers]
    pc = circuit_from_arrays(F, jc.nv, jc.nc, jc.ninputs, jc.npub_in, layers,
                             jc.subfield_boundary, jc.id)
    return jc, pc, toy_inputs(F.p, 32)


def _port_verify(circ, data, pub):
    F = p256k1_base()
    v = ZkVerifier(circ, F, rs_factory_for(F, device="cpu"),
                   rate=TOY_RATE, nreq=TOY_NREQ, block_enc=TOY_BLOCK_ENC,
                   device="cpu")
    zkp = read_zk_proof(data, circ, v.param, F, rate=TOY_RATE, nreq=TOY_NREQ)
    if zkp is None:
        return False, "unreadable"
    ts = Transcript(TOY_LABEL)
    v.recv_commitment(zkp, ts)
    return v.verify(zkp, pub, ts)


def test_toy_p256k1_proof_bytes_equal_jax():
    """The port's CPU proof of the toy circuit over secp256k1, with the
    CRT Reed-Solomon code, equals the JAX package's golden bytes."""
    F = p256k1_base()
    _, circ, W = _toy()
    zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
    prover = ZkProver(circ, F, rs_factory_for(F, device="cpu"),
                      rate=TOY_RATE, nreq=TOY_NREQ, block_enc=TOY_BLOCK_ENC,
                      device="cpu")
    ts = Transcript(TOY_LABEL)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    with open(TOY_P256K1_BIN, "rb") as f:
        assert write_zk_proof(zkp, circ, prover.param, F) == f.read()


def test_jax_verifier_accepts_toy_p256k1_golden():
    """The JAX ZkVerifier, with the JAX CRT Reed-Solomon factory, accepts
    the toy golden and refuses it with a flipped public input."""
    J = jax_p256k1()
    jc, _, W = _toy()
    with open(TOY_P256K1_BIN, "rb") as f:
        data = f.read()
    for pub, want in ((W[:2], True), ([W[0] ^ 1, W[1]], False)):
        v = JaxZkVerifier(jc, J, jax_crt_rs_factory(J), rate=TOY_RATE,
                          nreq=TOY_NREQ, block_enc=TOY_BLOCK_ENC)
        zkp = jax_read_zk_proof(data, jc, v.param, J, rate=TOY_RATE,
                                nreq=TOY_NREQ)
        ts = JaxTranscript(TOY_LABEL)
        v.recv_commitment(zkp, ts)
        assert v.verify(zkp, pub, ts)[0] is want


@pytest.mark.parametrize("where", ["root", "sumcheck", "middle", "tail",
                                   "last"])
def test_port_verifier_on_toy_p256k1_flips(where):
    """The port's verifier accepts the toy golden and refuses a copy with
    one bit flipped: in the Merkle root, the first sumcheck element, the
    middle of the proof, near its end (the openings), the last
    byte."""
    _, circ, W = _toy()
    with open(TOY_P256K1_BIN, "rb") as f:
        data = f.read()
    assert _port_verify(circ, data, W[:2]) == (True, "ok")
    i = {"root": 3, "sumcheck": 32, "middle": len(data) // 2,
         "tail": len(data) - 40 * 32, "last": len(data) - 1}[where]
    bad = bytearray(data)
    bad[i] ^= 0x04
    assert _port_verify(circ, bytes(bad), W[:2])[0] is False


# ----------------------------------------------------------------------
# the full-size golden
# ----------------------------------------------------------------------

def _bitaddr_inputs():
    F = p256k1_base()
    circ = read_circuit(F, SECP_ID, gzip.open(BITADDR_CIRCUIT, "rb").read())
    W = bitaddr_witness(F, p256k1_curve(), BitaddrWitness)
    with open(BITADDR_BIN, "rb") as f:
        return F, circ, W, f.read()


@pytest.mark.slow
def test_port_cpu_path_reproduces_bitaddr_golden():
    """The port's CPU path (plain versions) makes the golden's bytes
    (about 100 s, 9 GB)."""
    assert port_bitaddr_proof() == _bitaddr_inputs()[3]


@pytest.mark.slow
def test_jax_verifier_accepts_bitaddr_golden():
    """The JAX ZkVerifier with the JAX CRT factory accepts the port's
    bitaddr golden and refuses a copy with one bit flipped."""
    J = jax_p256k1()
    _, _, W, data = _bitaddr_inputs()
    jc = jax_read_circuit(J, SECP_ID, gzip.open(BITADDR_CIRCUIT, "rb").read())
    rs = jax_crt_rs_factory(J)
    for d, want in ((data, True), (data[:32] + bytes([data[32] ^ 1]) +
                                   data[33:], False)):
        v = JaxZkVerifier(jc, J, rs, rate=RATE, nreq=NREQ)
        zkp = jax_read_zk_proof(d, jc, v.param, J, rate=RATE, nreq=NREQ)
        ts = JaxTranscript(BITADDR_LABEL, version=K_VERSION)
        v.recv_commitment(zkp, ts)
        assert v.verify(zkp, W[: jc.npub_in], ts)[0] is want


@pytest.mark.slow
def test_port_verifier_accepts_bitaddr_golden():
    """The port's ZkVerifier on the CPU accepts the golden (about 15 s)
    and refuses a copy with one bit flipped."""
    F, circ, W, data = _bitaddr_inputs()
    rs = rs_factory_for(F, device="cpu")
    for d, want in ((data, True), (data[:32] + bytes([data[32] ^ 1]) +
                                   data[33:], False)):
        v = ZkVerifier(circ, F, rs, rate=RATE, nreq=NREQ, device="cpu")
        zkp = read_zk_proof(d, circ, v.param, F, RATE, NREQ)
        ts = Transcript(BITADDR_LABEL, version=K_VERSION)
        v.recv_commitment(zkp, ts)
        assert v.verify(zkp, W[: circ.npub_in], ts)[0] is want
