"""Full-size golden proofs: the Fp128 SHA-256 one-block ZK proof, the
P-256 ECDSA signature ZK proof and the mdoc presentation proof.

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
`zk_toy_gf2128.proof.bin` holds the JAX package's proof of that circuit
over GF(2^128) with more private inputs, all in the subfield
(`gf2_toy_circuit`); tests/test_torch_gf2.py holds the port against it.

`mdoc_v7_1attr.proof.bin` holds the bytes of the port's own
`run_mdoc_prover` on the CPU (plain versions) for the inputs in the JSON
file beside it (the wallet example 0 of artifacts/mdoc_examples.json,
age_over_18, the v7 one-attribute ZkSpec, DeterministicEngine(b"mdoc")):
the JAX package cannot prove mdoc on a CPU in useful time, so its
`run_mdoc_verifier` holds these bytes instead (a slow test), and
`chip_smoke.py` holds the card's mdoc proof against them.

The tests here are slow (the JAX prover compiles for about ten minutes
at SHA size; the JAX ECDSA proof takes 12-16 minutes and 14 GB) and
never run in the default (not slow) test run.  Regenerate the files with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py \
        [--toy] [--toy-p256] [--ecdsa] [--toy-gf2] [--mdoc] \
        [--bitaddr-circuit] [--toy-p256k1] [--bitaddr] [--bitaddr-jax]

(no flag: all of them; a flag: only that file.  --bitaddr-jax writes
nothing: it makes the bitaddr proof with the JAX package, its host-round
sumcheck and its CRT code, and compares it with the golden; its Ligero
commit alone ran for more than an hour on an 8-core CPU host.)
"""

import gzip
import json
import os
import random
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


MDOC_BIN = os.path.join(TESTDATA, "mdoc_v7_1attr.proof.bin")
MDOC_JSON = os.path.join(TESTDATA, "mdoc_v7_1attr.proof.json")
MDOC_CIRCUIT = os.path.join(REPO, "artifacts", "mdoc_v7_1attr.zst")
MDOC_EXAMPLES = os.path.join(REPO, "artifacts", "mdoc_examples.json")
MDOC_META = {"circuit": "artifacts/mdoc_v7_1attr.zst",
             "examples": "artifacts/mdoc_examples.json", "example": 0,
             "attributes": [{"id": "age_over_18", "cbor_value": "f5"}],
             "version": 7, "engine": "DeterministicEngine(b'mdoc')",
             "engine_seed": "mdoc"}


def mdoc_inputs(RequestedAttribute):
    """(mdoc, pkx, pky, transcript, attrs, now, doc_type) of MDOC_META,
    the attributes built by the given package's RequestedAttribute."""
    ex = json.load(open(MDOC_EXAMPLES))[MDOC_META["example"]]
    attrs = [RequestedAttribute(id=a["id"].encode(),
                                cbor_value=bytes.fromhex(a["cbor_value"]))
             for a in MDOC_META["attributes"]]
    return (bytes.fromhex(ex["mdoc"]), int(ex["pkx"], 16),
            int(ex["pky"], 16), bytes.fromhex(ex["transcript"]), attrs,
            ex["now"].encode(), ex["doc_type"].encode())


def port_mdoc_proof() -> bytes:
    """The port's run_mdoc_prover on the CPU (plain versions) under
    DeterministicEngine(b"mdoc"), on the inputs of MDOC_META."""
    from longfellow_zk_tpu_torch.circuits.mdoc import api
    from longfellow_zk_tpu_torch.circuits.mdoc.witness import (
        RequestedAttribute)
    from longfellow_zk_tpu_torch.circuits.mdoc.zk_spec import (
        find_zk_spec_by_version)
    from longfellow_zk_tpu_torch.random_oracle.engine import (
        DeterministicEngine)

    mdoc, pkx, pky, tr, attrs, now, _ = mdoc_inputs(RequestedAttribute)
    return api.run_mdoc_prover(
        open(MDOC_CIRCUIT, "rb").read(), mdoc, pkx, pky, tr, attrs, now,
        find_zk_spec_by_version(MDOC_META["version"], len(attrs)),
        rng=DeterministicEngine(MDOC_META["engine_seed"].encode()),
        device="cpu")


def write_mdoc_golden() -> int:
    import hashlib

    data = port_mdoc_proof()
    os.makedirs(TESTDATA, exist_ok=True)
    with open(MDOC_BIN, "wb") as f:
        f.write(data)
    meta = dict(MDOC_META, proof_bytes=len(data),
                sha256=hashlib.sha256(data).hexdigest(),
                made_by="tests/test_torch_golden.py --mdoc (the port's "
                        "run_mdoc_prover on the CPU, plain versions)")
    with open(MDOC_JSON, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    return len(data)


TOY_GF2_BIN = os.path.join(TESTDATA, "zk_toy_gf2128.proof.bin")
TOY_GF2_EXTRA = 30


def gf2_toy_circuit(F):
    """The two-layer toy circuit of tests/test_zk.py over GF(2^128), with
    TOY_GF2_EXTRA more private inputs that no term reads and every input
    in the subfield (subfield_boundary = ninputs): the first two witness
    rows of the tableau are then subfield rows (subfield blinds) and
    their openings subfield runs of the serialization."""
    from longfellow_zk_tpu.sumcheck.circuit import Circuit, Layer
    from test_zk import _zk_circuit

    c = _zk_circuit(F)
    n = 4 + TOY_GF2_EXTRA
    return Circuit(nv=c.nv, logv=c.logv, nc=1, logc=0, nl=2, ninputs=n,
                   npub_in=2, subfield_boundary=n,
                   layers=[c.layers[0],
                           Layer(nw=n, logw=(n - 1).bit_length(),
                                 quad=c.layers[1].quad)],
                   id=c.id)


def gf2_toy_inputs(F):
    """[c, 1, a, b, x...] with c = a * b, every value of_scalar(u) of a
    16-bit u from a numpy seed (the subfield is closed under products)."""
    import numpy as np

    rng = np.random.default_rng(22)
    a, b, *xs = (F.of_scalar(int(u)) for u in
                 rng.integers(1, 1 << 16, 2 + TOY_GF2_EXTRA))
    return [F.mul_i(a, b), F.of_scalar(1), a, b] + xs


def jax_toy_gf2_proof():
    """(proof bytes, circuit, prover) of the JAX package on
    gf2_toy_circuit, with its LCH14 Reed-Solomon code."""
    from longfellow_zk_tpu.fields.gf2 import gf2_128
    from longfellow_zk_tpu.random_oracle.engine import DeterministicEngine
    from longfellow_zk_tpu.random_oracle.transcript import Transcript
    from longfellow_zk_tpu.zk.proof import ZkProof
    from longfellow_zk_tpu.zk.prover import ZkProver
    from longfellow_zk_tpu.zk.serialization import write_zk_proof
    from longfellow_zk_tpu.zk.testing import rs_factory_for

    F = gf2_128()
    circ = gf2_toy_circuit(F)
    W = gf2_toy_inputs(F)
    zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
    prover = ZkProver(circ, F, rs_factory_for(F), rate=TOY_RATE,
                      nreq=TOY_NREQ, block_enc=TOY_BLOCK_ENC)
    ts = Transcript(TOY_LABEL)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F), circ, prover


def write_toy_gf2_golden() -> int:
    data = jax_toy_gf2_proof()[0]
    os.makedirs(TESTDATA, exist_ok=True)
    with open(TOY_GF2_BIN, "wb") as f:
        f.write(data)
    return len(data)


def write_toy_golden() -> int:
    data = jax_toy_proof()[0]
    os.makedirs(TESTDATA, exist_ok=True)
    with open(TOY_BIN, "wb") as f:
        f.write(data)
    return len(data)


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


BITADDR_CIRCUIT = os.path.join(REPO, "artifacts", "bitaddr_p256k1.lfc1.gz")
BITADDR_BIN = os.path.join(TESTDATA, "bitaddr_p256k1.proof.bin")
BITADDR_JSON = os.path.join(TESTDATA, "bitaddr_p256k1.proof.json")
TOY_P256K1_BIN = os.path.join(TESTDATA, "zk_toy_p256k1.proof.bin")
BITADDR_SEED = 23
BITADDR_LABEL = b"bitaddr"


def jax_bitaddr_circuit():
    """(LFC1 bytes, circuit) of the bitaddr circuit compiled by the JAX
    package (tests/test_bitaddr.py::test_bitaddr_compiled_zk: QuadCircuit,
    Logic, BitaddrCircuit, mkcircuit(nc=1)), over the secp256k1 base
    field."""
    from longfellow_zk_tpu.circuits.bitaddr import BitaddrCircuit
    from longfellow_zk_tpu.compiler.logic import CompilerBackend, Logic
    from longfellow_zk_tpu.compiler.quad_circuit import QuadCircuit
    from longfellow_zk_tpu.ec.curves import p256k1_curve
    from longfellow_zk_tpu.fields.fp_instances import p256k1_base
    from longfellow_zk_tpu.proto.lfc1 import SECP_ID, write_circuit

    F = p256k1_base()
    qc = QuadCircuit(F)
    L = Logic(CompilerBackend(qc), F)
    bc = BitaddrCircuit(L, p256k1_curve())
    addr_elt = L.eltw_input()
    qc.private_input()
    w = bc.witness_input()
    bc.assert_bitaddr(addr_elt, w)
    circ = qc.mkcircuit(nc=1)
    return write_circuit(F, SECP_ID, circ), circ


def write_bitaddr_circuit() -> int:
    data = gzip.compress(jax_bitaddr_circuit()[0], mtime=0)
    with open(BITADDR_CIRCUIT, "wb") as f:
        f.write(data)
    return len(data)


def bitaddr_key(ec):
    """(sk, Hash160 address) from random.Random(BITADDR_SEED), as
    tests/test_bitaddr.py draws them."""
    import hashlib

    from longfellow_zk_tpu_torch.circuits.ripemd.reference import ripemd160

    sk = random.Random(BITADDR_SEED).randrange(1, ec.order)
    pk = ec.normalize(ec.scalar_mult(ec.generator(), sk))
    compressed = bytes([2 + (int(pk.y) & 1)]) + int(pk.x).to_bytes(32, "big")
    return sk, int.from_bytes(
        ripemd160(hashlib.sha256(compressed).digest()), "big")


def bitaddr_witness(F, ec, BitaddrWitness):
    """All input wires of the bitaddr circuit: [1, addr] and the host
    witness of the given package's BitaddrWitness."""
    sk, addr = bitaddr_key(ec)
    bw = BitaddrWitness(ec, F)
    bw.compute_witness(sk)
    return [F.of_scalar(1), addr % F.p] + bw.fill()


def jax_crt_rs_factory(F):
    """The JAX package's Reed-Solomon factory over a root-poor field: the
    CRT convolution (bitaddr_test.cc:103-125 CrtConvolutionFactory)."""
    from longfellow_zk_tpu.transforms.crt_conv import (
        make_crt_convolution_factory)
    from longfellow_zk_tpu.transforms.ntt import ReedSolomon

    conv = make_crt_convolution_factory(F)
    cache = {}

    def rs(n, m):
        if (n, m) not in cache:
            cache[(n, m)] = ReedSolomon(n, m, F, conv)
        return cache[(n, m)]

    rs.fingerprint = ("crt", F.name)
    return rs


def jax_toy_p256k1_proof():
    """(proof bytes, circuit, prover) of the JAX package on the toy
    circuit of tests/test_zk.py over the secp256k1 base field, with the
    CRT Reed-Solomon code."""
    from longfellow_zk_tpu.fields.fp_instances import p256k1_base
    from longfellow_zk_tpu.random_oracle.engine import DeterministicEngine
    from longfellow_zk_tpu.random_oracle.transcript import Transcript
    from longfellow_zk_tpu.zk.proof import ZkProof
    from longfellow_zk_tpu.zk.prover import ZkProver
    from longfellow_zk_tpu.zk.serialization import write_zk_proof
    from test_zk import _zk_circuit

    F = p256k1_base()
    circ = _zk_circuit(F)
    W = toy_inputs(F.p, 32)
    zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
    prover = ZkProver(circ, F, jax_crt_rs_factory(F), rate=TOY_RATE,
                      nreq=TOY_NREQ, block_enc=TOY_BLOCK_ENC)
    ts = Transcript(TOY_LABEL)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F), circ, prover


def write_toy_p256k1_golden() -> int:
    data = jax_toy_p256k1_proof()[0]
    os.makedirs(TESTDATA, exist_ok=True)
    with open(TOY_P256K1_BIN, "wb") as f:
        f.write(data)
    return len(data)


def jax_bitaddr_proof() -> bytes:
    """The JAX package's bitaddr proof bytes, its sumcheck by the
    host-round prover and its Reed-Solomon code the JAX CRT convolution,
    under DeterministicEngine()."""
    from longfellow_zk_tpu.circuits.bitaddr.bitaddr import BitaddrWitness
    from longfellow_zk_tpu.ec.curves import p256k1_curve
    from longfellow_zk_tpu.fields.fp_instances import p256k1_base
    from longfellow_zk_tpu.proto.lfc1 import SECP_ID, read_circuit
    from longfellow_zk_tpu.random_oracle.engine import DeterministicEngine
    from longfellow_zk_tpu.random_oracle.transcript import Transcript
    from longfellow_zk_tpu.zk.proof import ZkProof
    from longfellow_zk_tpu.zk.prover import ZkProver
    from longfellow_zk_tpu.zk.serialization import write_zk_proof
    from longfellow_zk_tpu.zk.testing import K_VERSION

    F = p256k1_base()
    circ = read_circuit(F, SECP_ID, gzip.open(BITADDR_CIRCUIT, "rb").read())
    W = bitaddr_witness(F, p256k1_curve(), BitaddrWitness)
    zkp = ZkProof(rate=RATE, nreq=NREQ)
    prover = ZkProver(circ, F, jax_crt_rs_factory(F), rate=RATE, nreq=NREQ)
    prover.sumcheck = _HostRoundSumcheck(F)
    ts = Transcript(BITADDR_LABEL, version=K_VERSION)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F)


def port_bitaddr_proof() -> bytes:
    """The port's CPU-path (plain versions) bitaddr proof bytes, with
    the CRT Reed-Solomon code, under DeterministicEngine()."""
    from longfellow_zk_tpu_torch.circuits.bitaddr.bitaddr import (
        BitaddrWitness)
    from longfellow_zk_tpu_torch.ec.curves import p256k1_curve
    from longfellow_zk_tpu_torch.fields.fp_instances import p256k1_base
    from longfellow_zk_tpu_torch.proto.lfc1 import SECP_ID, read_circuit
    from longfellow_zk_tpu_torch.random_oracle.engine import (
        DeterministicEngine)
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
    from longfellow_zk_tpu_torch.zk.proof import ZkProof
    from longfellow_zk_tpu_torch.zk.prover import ZkProver
    from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof
    from longfellow_zk_tpu_torch.zk.testing import K_VERSION, rs_factory_for

    F = p256k1_base()
    circ = read_circuit(F, SECP_ID, gzip.open(BITADDR_CIRCUIT, "rb").read())
    W = bitaddr_witness(F, p256k1_curve(), BitaddrWitness)
    zkp = ZkProof(rate=RATE, nreq=NREQ)
    prover = ZkProver(circ, F, rs_factory_for(F, device="cpu"),
                      rate=RATE, nreq=NREQ, device="cpu")
    ts = Transcript(BITADDR_LABEL, version=K_VERSION)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F)


def write_bitaddr_golden() -> int:
    import hashlib

    from longfellow_zk_tpu_torch.zk.testing import K_VERSION

    data = port_bitaddr_proof()
    os.makedirs(TESTDATA, exist_ok=True)
    with open(BITADDR_BIN, "wb") as f:
        f.write(data)
    meta = {"circuit": "artifacts/bitaddr_p256k1.lfc1.gz",
            "witness": "sk = random.Random(seed).randrange(1, n) on "
                       "secp256k1, addr its Hash160 (tests/test_bitaddr.py)",
            "seed": BITADDR_SEED, "engine": "DeterministicEngine()",
            "engine_seed": "bogorng",
            "rs": "CRTConvolution over 18 primes c*2^22+1",
            "transcript_label": BITADDR_LABEL.decode(), "version": K_VERSION,
            "rate": RATE, "nreq": NREQ, "proof_bytes": len(data),
            "sha256": hashlib.sha256(data).hexdigest(),
            "made_by": "tests/test_torch_golden.py --bitaddr (the port's "
                       "ZkProver on the CPU, plain versions)"}
    with open(BITADDR_JSON, "w") as f:
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


@pytest.mark.slow
def test_jax_reproduces_toy_gf2_golden():
    with open(TOY_GF2_BIN, "rb") as f:
        assert jax_toy_gf2_proof()[0] == f.read()


@pytest.mark.slow
def test_port_cpu_path_reproduces_mdoc_golden():
    with open(MDOC_BIN, "rb") as f:
        assert port_mdoc_proof() == f.read()


@pytest.mark.slow
def test_jax_mdoc_verifier_accepts_mdoc_golden():
    """The JAX package's run_mdoc_verifier accepts the golden mdoc proof
    and refuses a copy with one bit flipped (in the hash proof's
    sumcheck part)."""
    from longfellow_zk_tpu.circuits.mdoc import api
    from longfellow_zk_tpu.circuits.mdoc.witness import RequestedAttribute
    from longfellow_zk_tpu.circuits.mdoc.zk_spec import (
        find_zk_spec_by_version)

    mdoc, pkx, pky, tr, attrs, now, doc_type = mdoc_inputs(
        RequestedAttribute)
    spec = find_zk_spec_by_version(MDOC_META["version"], len(attrs))
    circuit = open(MDOC_CIRCUIT, "rb").read()
    with open(MDOC_BIN, "rb") as f:
        data = f.read()
    assert api.run_mdoc_verifier(circuit, pkx, pky, tr, attrs, now, data,
                                 doc_type, spec)
    bad = bytearray(data)
    bad[6 * 16 + 32 + 5] ^= 0x10
    assert not api.run_mdoc_verifier(circuit, pkx, pky, tr, attrs, now,
                                     bytes(bad), doc_type, spec)


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
    if not only or "--toy-gf2" in only:
        print(write_toy_gf2_golden(), "bytes written to", TOY_GF2_BIN)
    if not only or "--mdoc" in only:
        print(write_mdoc_golden(), "bytes written to", MDOC_BIN)
    if not only or "--bitaddr-circuit" in only:
        print(write_bitaddr_circuit(), "bytes written to", BITADDR_CIRCUIT)
    if not only or "--toy-p256k1" in only:
        print(write_toy_p256k1_golden(), "bytes written to", TOY_P256K1_BIN)
    if not only or "--bitaddr" in only:
        print(write_bitaddr_golden(), "bytes written to", BITADDR_BIN)
    if "--bitaddr-jax" in only:
        with open(BITADDR_BIN, "rb") as f:
            print("the JAX package's bitaddr proof equals", BITADDR_BIN,
                  jax_bitaddr_proof() == f.read())
