"""Full-size golden proofs: the Fp128 SHA-256 one-block ZK proof and the
P-256 ECDSA signature ZK proof.

`longfellow_zk_tpu_torch/testdata/sha256_1block_fp128.proof.bin` holds the
JAX package's `write_zk_proof` bytes for the inputs recorded in the JSON
file beside it (message b"abc", `DeterministicEngine()`, transcript label
b"bench", version 7, rate 4, nreq 128).  `chip_smoke.py` holds the port's
proof on the card against these bytes.

`ecdsa_p256.proof.bin` holds the JAX package's bytes of the ECDSA proof
for the inputs in the JSON file beside it (the witness of bench.py's
phase_ecdsa, the same label, version, rate and nreq, the Reed-Solomon
code by convolution over Fp2).  They are made with the JAX package's
host-round SumcheckProver in place of its fused device program, whose
XLA compile at this size outgrows a CPU host's memory; the JAX package's
tests/test_prover_device.py holds the two to the same proofs.
`chip_smoke.py` holds the card's ECDSA proof against these bytes.

`zk_toy_fp128.proof.bin` and `zk_toy_p256.proof.bin` hold the JAX
package's proofs of the two-layer toy circuit of tests/test_zk.py on the
inputs of `toy_inputs()`, over Fp128 and over the P-256 base field (with
the Fp2 Reed-Solomon code); tests/test_torch_zk.py and
tests/test_torch_fp256.py hold the port against them (the JAX prover
takes minutes to compile even at that size on a CPU).

The tests here are slow (the JAX prover compiles for about ten minutes
at SHA size; the JAX ECDSA proof takes 12-16 minutes and 14 GB) and
never run in the default (not slow) test run.  Regenerate the files with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py \
        [--toy] [--toy-p256] [--ecdsa]

(no flag: all of them; a flag: only that file.)
"""

import gzip
import json
import os
import random
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "longfellow_zk_tpu_torch", "testdata")
GOLDEN_BIN = os.path.join(TESTDATA, "sha256_1block_fp128.proof.bin")
GOLDEN_JSON = os.path.join(TESTDATA, "sha256_1block_fp128.proof.json")
TOY_BIN = os.path.join(TESTDATA, "zk_toy_fp128.proof.bin")
CIRCUIT = os.path.join(REPO, "artifacts", "sha256_1block_fp128.lfc1.gz")
ECDSA_BIN = os.path.join(TESTDATA, "ecdsa_p256.proof.bin")
ECDSA_JSON = os.path.join(TESTDATA, "ecdsa_p256.proof.json")
ECDSA_CIRCUIT = os.path.join(REPO, "artifacts", "ecdsa_p256.lfc1.gz")
TOY_P256_BIN = os.path.join(TESTDATA, "zk_toy_p256.proof.bin")
ECDSA_SEED = 1234

MESSAGE = b"abc"
LABEL = b"bench"
RATE, NREQ = 4, 128


def sha_witness(F):
    """All input wires of the SHA-256 one-block circuit for MESSAGE (the
    witness of bench.py's _sha_setup), from the port's witness code."""
    from longfellow_zk_tpu_torch.circuits.sha.sha256 import (
        SHA256_INIT, pack_block_witness, sha256_pad, transform_block_witness)

    padded = sha256_pad(MESSAGE)
    W = [F.of_scalar(1)]
    for byte in padded:
        for i in range(8):
            W.append(F.of_scalar((byte >> i) & 1))
    W.extend(pack_block_witness(
        F, 4, [transform_block_witness(SHA256_INIT, padded)]))
    return W


def jax_golden_proof():
    """(proof bytes, circuit, prover, witness) from the JAX package."""
    from longfellow_zk_tpu.circuits.sha.sha256 import (
        SHA256_INIT, pack_block_witness, sha256_pad, transform_block_witness)
    from longfellow_zk_tpu.fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER, fp128)
    from longfellow_zk_tpu.proto.lfc1 import FP128_ID, read_circuit
    from longfellow_zk_tpu.random_oracle.engine import DeterministicEngine
    from longfellow_zk_tpu.random_oracle.transcript import Transcript
    from longfellow_zk_tpu.zk.proof import ZkProof
    from longfellow_zk_tpu.zk.prover import ZkProver
    from longfellow_zk_tpu.zk.serialization import write_zk_proof
    from longfellow_zk_tpu.zk.testing import K_VERSION, rs_factory_for

    F = fp128()
    circ = read_circuit(F, FP128_ID, gzip.open(CIRCUIT, "rb").read())
    padded = sha256_pad(MESSAGE)
    W = [F.of_scalar(1)]
    for byte in padded:
        for i in range(8):
            W.append(F.of_scalar((byte >> i) & 1))
    W.extend(pack_block_witness(
        F, 4, [transform_block_witness(SHA256_INIT, padded)]))
    zkp = ZkProof(rate=RATE, nreq=NREQ)
    prover = ZkProver(circ, F, rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER),
                      rate=RATE, nreq=NREQ)
    ts = Transcript(LABEL, version=K_VERSION)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F), circ, prover, W


TOY_RATE, TOY_NREQ, TOY_BLOCK_ENC = 4, 6, 128
TOY_LABEL = b"zk_test"


def toy_inputs(p: int, nbytes: int = 16):
    """Witness [c, 1, a, b] with c = a * b mod p, a and b from a numpy
    seed."""
    import numpy as np

    rng = np.random.default_rng(21)
    a, b = (int.from_bytes(rng.bytes(nbytes), "little") % p
            for _ in range(2))
    return [a * b % p, 1, a, b]


def jax_toy_proof():
    """(proof bytes, circuit, prover) of the JAX package on the toy
    circuit of tests/test_zk.py."""
    from longfellow_zk_tpu.fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER, fp128)
    from longfellow_zk_tpu.random_oracle.engine import DeterministicEngine
    from longfellow_zk_tpu.random_oracle.transcript import Transcript
    from longfellow_zk_tpu.zk.proof import ZkProof
    from longfellow_zk_tpu.zk.prover import ZkProver
    from longfellow_zk_tpu.zk.serialization import write_zk_proof
    from longfellow_zk_tpu.zk.testing import rs_factory_for
    from test_zk import _zk_circuit

    F = fp128()
    circ = _zk_circuit(F)
    W = toy_inputs(F.p)
    zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
    prover = ZkProver(circ, F, rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER),
                      rate=TOY_RATE, nreq=TOY_NREQ, block_enc=TOY_BLOCK_ENC)
    ts = Transcript(TOY_LABEL)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F), circ, prover


def ecdsa_witness(F, ec, compute_witness, ecdsa_sign):
    """All input wires of the ECDSA circuit (the witness of bench.py's
    phase_ecdsa): a key, a digest e and a signature (r, s) from
    random.Random(ECDSA_SEED), then the verification witness."""
    rng = random.Random(ECDSA_SEED)
    d = rng.randrange(1, ec.order)
    pk = ec.normalize(ec.scalar_mult(ec.generator(), d))
    e = rng.randrange(1, ec.order)
    r, s = ecdsa_sign(ec, d, e, rng.randrange(1, ec.order))
    W = [F.of_scalar(1), pk.x, pk.y, e % F.p]
    W.extend(compute_witness(ec, pk.x, pk.y, e, r, s).fill())
    return W


def jax_ecdsa_rs_factory(F):
    from longfellow_zk_tpu.fields.fp2 import Fp2
    from longfellow_zk_tpu.fields.fp_instances import (
        P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X, P256_FP2_ROOT_Y)
    from longfellow_zk_tpu.zk.testing import rs_factory_for

    return rs_factory_for(F, F2=Fp2(F),
                          omega2=(P256_FP2_ROOT_X, P256_FP2_ROOT_Y),
                          omega_order=P256_FP2_ROOT_ORDER)


class _HostRoundSumcheck:
    """The JAX package's host-round SumcheckProver behind the interface
    ZkProver uses (DeviceSumcheckProver.prove_with_witness)."""

    def __init__(self, F):
        from longfellow_zk_tpu.sumcheck.prover import SumcheckProver

        self.prover = SumcheckProver(F)

    def prove_with_witness(self, circ, W0, ts, pad=None, with_aux=False):
        inputs, _ = self.prover.eval_circuit(circ, W0)
        return self.prover.prove(circ, inputs, ts, pad=pad,
                                 with_aux=with_aux)


def jax_ecdsa_proof():
    """(proof bytes, circuit, prover, witness) of the JAX package on the
    P-256 ECDSA circuit, its sumcheck by the host-round prover."""
    from longfellow_zk_tpu.circuits.ecdsa.verify import compute_witness
    from longfellow_zk_tpu.ec.curves import ecdsa_sign, p256_curve
    from longfellow_zk_tpu.fields.fp_instances import p256_base
    from longfellow_zk_tpu.proto.lfc1 import P256_ID, read_circuit
    from longfellow_zk_tpu.random_oracle.engine import DeterministicEngine
    from longfellow_zk_tpu.random_oracle.transcript import Transcript
    from longfellow_zk_tpu.zk.proof import ZkProof
    from longfellow_zk_tpu.zk.prover import ZkProver
    from longfellow_zk_tpu.zk.serialization import write_zk_proof
    from longfellow_zk_tpu.zk.testing import K_VERSION

    F = p256_base()
    circ = read_circuit(F, P256_ID, gzip.open(ECDSA_CIRCUIT, "rb").read())
    W = ecdsa_witness(F, p256_curve(), compute_witness, ecdsa_sign)
    zkp = ZkProof(rate=RATE, nreq=NREQ)
    prover = ZkProver(circ, F, jax_ecdsa_rs_factory(F), rate=RATE, nreq=NREQ)
    prover.sumcheck = _HostRoundSumcheck(F)
    ts = Transcript(LABEL, version=K_VERSION)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F), circ, prover, W


def jax_toy_p256_proof():
    """(proof bytes, circuit, prover) of the JAX package on the toy
    circuit of tests/test_zk.py over the P-256 base field, with the Fp2
    Reed-Solomon factory."""
    from longfellow_zk_tpu.fields.fp_instances import p256_base
    from longfellow_zk_tpu.random_oracle.engine import DeterministicEngine
    from longfellow_zk_tpu.random_oracle.transcript import Transcript
    from longfellow_zk_tpu.zk.proof import ZkProof
    from longfellow_zk_tpu.zk.prover import ZkProver
    from longfellow_zk_tpu.zk.serialization import write_zk_proof
    from test_zk import _zk_circuit

    F = p256_base()
    circ = _zk_circuit(F)
    W = toy_inputs(F.p, 32)
    zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
    prover = ZkProver(circ, F, jax_ecdsa_rs_factory(F), rate=TOY_RATE,
                      nreq=TOY_NREQ, block_enc=TOY_BLOCK_ENC)
    ts = Transcript(TOY_LABEL)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F), circ, prover


def write_toy_p256_golden() -> int:
    data = jax_toy_p256_proof()[0]
    os.makedirs(TESTDATA, exist_ok=True)
    with open(TOY_P256_BIN, "wb") as f:
        f.write(data)
    return len(data)


def port_ecdsa_proof() -> bytes:
    """The port's CPU-path (plain versions) ECDSA proof bytes."""
    from longfellow_zk_tpu_torch.circuits.ecdsa.verify import compute_witness
    from longfellow_zk_tpu_torch.ec.curves import ecdsa_sign, p256_curve
    from longfellow_zk_tpu_torch.fields.fp2 import Fp2
    from longfellow_zk_tpu_torch.fields.fp_instances import (
        P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X, P256_FP2_ROOT_Y, p256_base)
    from longfellow_zk_tpu_torch.proto.lfc1 import P256_ID, read_circuit
    from longfellow_zk_tpu_torch.random_oracle.engine import (
        DeterministicEngine)
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
    from longfellow_zk_tpu_torch.zk.proof import ZkProof
    from longfellow_zk_tpu_torch.zk.prover import ZkProver
    from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof
    from longfellow_zk_tpu_torch.zk.testing import K_VERSION, rs_factory_for

    F = p256_base()
    circ = read_circuit(F, P256_ID, gzip.open(ECDSA_CIRCUIT, "rb").read())
    W = ecdsa_witness(F, p256_curve(), compute_witness, ecdsa_sign)
    rs = rs_factory_for(F, F2=Fp2(F),
                        omega2=(P256_FP2_ROOT_X, P256_FP2_ROOT_Y),
                        omega_order=P256_FP2_ROOT_ORDER, device="cpu")
    zkp = ZkProof(rate=RATE, nreq=NREQ)
    prover = ZkProver(circ, F, rs, rate=RATE, nreq=NREQ, device="cpu")
    ts = Transcript(LABEL, version=K_VERSION)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F)


def write_ecdsa_golden() -> int:
    from longfellow_zk_tpu.zk.testing import K_VERSION

    data = jax_ecdsa_proof()[0]
    os.makedirs(TESTDATA, exist_ok=True)
    with open(ECDSA_BIN, "wb") as f:
        f.write(data)
    meta = {"circuit": "artifacts/ecdsa_p256.lfc1.gz",
            "witness": "bench.py phase_ecdsa: key, digest e and signature "
                       "(r, s) from random.Random(seed)",
            "seed": ECDSA_SEED, "engine": "DeterministicEngine()",
            "engine_seed": "bogorng",
            "rs": "FFTExtConvolution over Fp2 = Fp256[i]/(i^2+1)",
            "transcript_label": LABEL.decode(), "version": K_VERSION,
            "rate": RATE, "nreq": NREQ, "proof_bytes": len(data),
            "made_by": "tests/test_torch_golden.py (JAX package, CPU; "
                       "host-round sumcheck prover)"}
    with open(ECDSA_JSON, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    return len(data)


@pytest.mark.slow
def test_jax_reproduces_golden_and_verifies():
    from longfellow_zk_tpu.fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER)
    from longfellow_zk_tpu.random_oracle.transcript import Transcript
    from longfellow_zk_tpu.zk.serialization import read_zk_proof
    from longfellow_zk_tpu.zk.testing import K_VERSION, rs_factory_for
    from longfellow_zk_tpu.zk.verifier import ZkVerifier

    data, circ, prover, W = jax_golden_proof()
    with open(GOLDEN_BIN, "rb") as f:
        assert data == f.read()
    F = prover.F
    verifier = ZkVerifier(circ, F, rs_factory_for(F, P128_OMEGA,
                                                  P128_OMEGA_ORDER),
                          rate=RATE, nreq=NREQ)
    zkp = read_zk_proof(data, circ, verifier.param, F, rate=RATE, nreq=NREQ)
    ts = Transcript(LABEL, version=K_VERSION)
    verifier.recv_commitment(zkp, ts)
    ok, why = verifier.verify(zkp, W[: circ.npub_in], ts)
    assert ok, why


@pytest.mark.slow
def test_port_cpu_path_reproduces_golden():
    from longfellow_zk_tpu_torch.fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER, fp128)
    from longfellow_zk_tpu_torch.proto.lfc1 import FP128_ID, read_circuit
    from longfellow_zk_tpu_torch.random_oracle.engine import (
        DeterministicEngine)
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
    from longfellow_zk_tpu_torch.zk.proof import ZkProof
    from longfellow_zk_tpu_torch.zk.prover import ZkProver
    from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof
    from longfellow_zk_tpu_torch.zk.testing import K_VERSION, rs_factory_for

    F = fp128()
    circ = read_circuit(F, FP128_ID, gzip.open(CIRCUIT, "rb").read())
    W = sha_witness(F)
    zkp = ZkProof(rate=RATE, nreq=NREQ)
    prover = ZkProver(circ, F, rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER,
                                              device="cpu"),
                      rate=RATE, nreq=NREQ, device="cpu")
    ts = Transcript(LABEL, version=K_VERSION)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    with open(GOLDEN_BIN, "rb") as f:
        assert write_zk_proof(zkp, circ, prover.param, F) == f.read()


@pytest.mark.slow
def test_port_cpu_path_reproduces_ecdsa_golden():
    with open(ECDSA_BIN, "rb") as f:
        assert port_ecdsa_proof() == f.read()


@pytest.mark.slow
def test_jax_verifier_accepts_ecdsa_golden():
    from longfellow_zk_tpu.circuits.ecdsa.verify import compute_witness
    from longfellow_zk_tpu.ec.curves import ecdsa_sign, p256_curve
    from longfellow_zk_tpu.fields.fp_instances import p256_base
    from longfellow_zk_tpu.proto.lfc1 import P256_ID, read_circuit
    from longfellow_zk_tpu.random_oracle.transcript import Transcript
    from longfellow_zk_tpu.zk.serialization import read_zk_proof
    from longfellow_zk_tpu.zk.testing import K_VERSION
    from longfellow_zk_tpu.zk.verifier import ZkVerifier

    F = p256_base()
    circ = read_circuit(F, P256_ID, gzip.open(ECDSA_CIRCUIT, "rb").read())
    W = ecdsa_witness(F, p256_curve(), compute_witness, ecdsa_sign)
    verifier = ZkVerifier(circ, F, jax_ecdsa_rs_factory(F), rate=RATE,
                          nreq=NREQ)
    with open(ECDSA_BIN, "rb") as f:
        data = f.read()
    zkp = read_zk_proof(data, circ, verifier.param, F, rate=RATE, nreq=NREQ)
    ts = Transcript(LABEL, version=K_VERSION)
    verifier.recv_commitment(zkp, ts)
    ok, why = verifier.verify(zkp, W[: circ.npub_in], ts)
    assert ok, why


@pytest.mark.slow
def test_jax_reproduces_ecdsa_golden():
    with open(ECDSA_BIN, "rb") as f:
        assert jax_ecdsa_proof()[0] == f.read()


@pytest.mark.slow
def test_jax_reproduces_toy_p256_golden():
    with open(TOY_P256_BIN, "rb") as f:
        assert jax_toy_p256_proof()[0] == f.read()


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    only = set(sys.argv[1:])
    if not only:
        print(write_golden(), "bytes written to", GOLDEN_BIN)
    if not only or "--toy" in only:
        print(write_toy_golden(), "bytes written to", TOY_BIN)
    if not only or "--toy-p256" in only:
        print(write_toy_p256_golden(), "bytes written to", TOY_P256_BIN)
    if not only or "--ecdsa" in only:
        print(write_ecdsa_golden(), "bytes written to", ECDSA_BIN)
