"""Full-size golden proof: the Fp128 SHA-256 one-block ZK proof.

`longfellow_zk_tpu_torch/testdata/sha256_1block_fp128.proof.bin` holds the
JAX package's `write_zk_proof` bytes for the inputs recorded in the JSON
file beside it (message b"abc", `DeterministicEngine()`, transcript label
b"bench", version 7, rate 4, nreq 128).  `chip_smoke.py` holds the port's
proof on the card against these bytes.

`zk_toy_fp128.proof.bin` holds the JAX package's proof of the two-layer
toy circuit of tests/test_zk.py on the inputs of `toy_inputs()`;
tests/test_torch_zk.py holds the port against it (the JAX prover takes
minutes to compile even at that size on a CPU).

The tests here are slow (the JAX prover compiles for about ten minutes
at SHA size) and never run in the default (not slow) test run.
Regenerate the files with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py [--toy]

(`--toy` rewrites only the toy proof.)
"""

import gzip
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "longfellow_zk_tpu_torch", "testdata")
GOLDEN_BIN = os.path.join(TESTDATA, "sha256_1block_fp128.proof.bin")
GOLDEN_JSON = os.path.join(TESTDATA, "sha256_1block_fp128.proof.json")
TOY_BIN = os.path.join(TESTDATA, "zk_toy_fp128.proof.bin")
CIRCUIT = os.path.join(REPO, "artifacts", "sha256_1block_fp128.lfc1.gz")

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


def toy_inputs(p: int):
    """Witness [c, 1, a, b] with c = a * b mod p, a and b from a numpy
    seed."""
    import numpy as np

    rng = np.random.default_rng(21)
    a, b = (int.from_bytes(rng.bytes(16), "little") % p for _ in range(2))
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


def write_toy_golden() -> int:
    data = jax_toy_proof()[0]
    os.makedirs(TESTDATA, exist_ok=True)
    with open(TOY_BIN, "wb") as f:
        f.write(data)
    return len(data)


def write_golden() -> int:
    from longfellow_zk_tpu.zk.testing import K_VERSION

    data = jax_golden_proof()[0]
    os.makedirs(TESTDATA, exist_ok=True)
    with open(GOLDEN_BIN, "wb") as f:
        f.write(data)
    meta = {"circuit": "artifacts/sha256_1block_fp128.lfc1.gz",
            "message": MESSAGE.decode(), "engine": "DeterministicEngine()",
            "engine_seed": "bogorng", "transcript_label": LABEL.decode(),
            "version": K_VERSION, "rate": RATE, "nreq": NREQ,
            "proof_bytes": len(data),
            "made_by": "tests/test_torch_golden.py (JAX package, CPU)"}
    with open(GOLDEN_JSON, "w") as f:
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
                                              "cpu"),
                      rate=RATE, nreq=NREQ, device="cpu")
    ts = Transcript(LABEL, version=K_VERSION)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    with open(GOLDEN_BIN, "rb") as f:
        assert write_zk_proof(zkp, circ, prover.param, F) == f.read()


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    if "--toy" not in sys.argv[1:]:
        print(write_golden(), "bytes written to", GOLDEN_BIN)
    print(write_toy_golden(), "bytes written to", TOY_BIN)
