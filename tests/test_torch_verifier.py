"""The port's verifier (plain kernel versions, CPU) against the JAX
package's: K7's plain version against `bind_quad_host`, the proof reader,
the Merkle verifiers, the plain sumcheck verifier, and `ZkVerifier` on
the three toy goldens of tests/test_torch_golden.py (Fp128, P-256 with
the Fp2 Reed-Solomon code, GF(2^128) with subfield runs), intact and
corrupted five ways.  Field arithmetic is exact: values are compared as
canonical integers, tolerance 0.

Every corruption is compared with the JAX verifier live; so are the
intact GF(2^128) toy and, in a slow test, the intact Fp128 and P-256
toys (see _JAX_SLOW).  The full-size goldens: the SHA-256 proof
verifies here in a few seconds; the ECDSA and mdoc proofs are slow
tests.
"""

import gzip

import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.fields.fp_instances import p256_base as jax_p256
from longfellow_zk_tpu.fields.gf2 import gf2_128 as jax_gf2
from longfellow_zk_tpu.merkle.merkle import (
    MerkleCommitmentVerifier as JaxCommitmentVerifier)
from longfellow_zk_tpu.merkle.merkle import (
    MerkleTreeVerifier as JaxTreeVerifier)
from longfellow_zk_tpu.random_oracle.transcript import (
    Transcript as JaxTranscript)
from longfellow_zk_tpu.sumcheck.circuit import Quad as JaxQuad
from longfellow_zk_tpu.sumcheck.transcript_sumcheck import (
    TranscriptSumcheck as JaxTS)
from longfellow_zk_tpu.sumcheck.verifier import (
    bind_quad_host as jax_bind_quad_host)
from longfellow_zk_tpu.sumcheck.verifier import verify as jax_sc_verify
from longfellow_zk_tpu.zk.serialization import (
    read_zk_proof as jax_read_zk_proof)
from longfellow_zk_tpu.zk.testing import rs_factory_for as jax_rs_factory
from longfellow_zk_tpu.zk.verifier import ZkVerifier as JaxZkVerifier
from longfellow_zk_tpu_torch.circuits.mdoc import api
from longfellow_zk_tpu_torch.circuits.mdoc.witness import RequestedAttribute
from longfellow_zk_tpu_torch.circuits.mdoc.zk_spec import (
    find_zk_spec_by_version)
from longfellow_zk_tpu_torch.fields.fp2 import Fp2
from longfellow_zk_tpu_torch.fields.fp_instances import (
    P128_OMEGA, P128_OMEGA_ORDER, P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X,
    P256_FP2_ROOT_Y, fp128, p256_base)
from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
from longfellow_zk_tpu_torch.merkle.merkle import (
    MerkleCommitment, MerkleCommitmentVerifier, MerkleTree,
    MerkleTreeVerifier)
from longfellow_zk_tpu_torch.proto.lfc1 import FP128_ID, read_circuit
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.sumcheck.circuit import Quad
from longfellow_zk_tpu_torch.sumcheck.prover import quad_tensors
from longfellow_zk_tpu_torch.sumcheck.transcript_sumcheck import (
    TranscriptSumcheck)
from longfellow_zk_tpu_torch.sumcheck.verifier import (
    bind_quad, bind_quad_host, fp_quad_bind, verify)
from longfellow_zk_tpu_torch.zk.serialization import (
    read_zk_proof, write_zk_proof)
from longfellow_zk_tpu_torch.zk.testing import K_VERSION, rs_factory_for
from longfellow_zk_tpu_torch.zk.verifier import ZkVerifier

from test_sumcheck import _mul_check_circuit
from test_torch_fp256 import _port_toy_circuit
from test_torch_gf2 import port_gf2_circuit
from test_torch_golden import (
    CIRCUIT, ECDSA_BIN, ECDSA_CIRCUIT, GOLDEN_BIN, LABEL, MDOC_BIN,
    MDOC_CIRCUIT, MDOC_META, NREQ, RATE, TOY_BIN, TOY_BLOCK_ENC, TOY_GF2_BIN,
    TOY_LABEL, TOY_NREQ, TOY_P256_BIN, TOY_RATE, ecdsa_witness,
    gf2_toy_circuit, gf2_toy_inputs, jax_ecdsa_rs_factory, mdoc_inputs,
    sha_witness, toy_inputs)
from test_torch_sumcheck import _port_prove, _witness, port_circuit
from test_zk import _zk_circuit

FIELDS = ("fp128", "p256", "gf2_128")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads (the SHA verification: 7 s on one thread, 75 s on eight
    beside six busy cores).  One thread for this module, restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# K7: the plain version against the JAX package's host loop
# ----------------------------------------------------------------------

def _port_field(field):
    return {"fp128": fp128, "p256": p256_base, "gf2_128": gf2_128}[field]()


def _jax_field(field):
    return {"fp128": jax_fp128, "p256": jax_p256, "gf2_128": jax_gf2}[field]()


def _rand_elts(F, rng, n):
    if F.kCharacteristicTwo:
        return [int.from_bytes(rng.bytes(16), "little") for _ in range(n)]
    return [int.from_bytes(rng.bytes(32), "little") % F.p for _ in range(n)]


@pytest.mark.parametrize("field,logv,logw", [
    ("fp128", 6, 9), ("p256", 8, 8), ("gf2_128", 7, 10)])
def test_quad_bind_matches_jax_host(field, logv, logw):
    """bind_quad on the CPU (K1's and K7's plain versions) equals the JAX
    package's bind_quad_host on a random quad of 3,000 terms, a tenth of
    them assert-zero terms (v = 0, which take beta)."""
    F, J = _port_field(field), _jax_field(field)
    rng = np.random.default_rng(FIELDS.index(field) + 71)
    T = 3000
    g = rng.integers(0, 1 << logv, T)
    h0, h1 = (rng.integers(0, 1 << logw, T) for _ in range(2))
    v = _rand_elts(F, rng, T)
    for t in rng.choice(T, T // 10, replace=False):
        v[t] = 0
    g0, g1 = _rand_elts(F, rng, logv), _rand_elts(F, rng, logv)
    h0c, h1c = _rand_elts(F, rng, logw), _rand_elts(F, rng, logw)
    alpha, beta = _rand_elts(F, rng, 2)
    args = (logv, g0, g1, alpha, beta, logw, h0c, h1c)
    want = jax_bind_quad_host(J, JaxQuad(g, h0, h1, v=list(v)), *args)
    quad = Quad(g, h0, h1, v=list(v))
    assert bind_quad(F, quad, *args, "cpu") == want
    assert bind_quad_host(F, quad, *args) == want
    # K7 alone: a beta-masked term takes beta itself, never v * beta
    qd = quad_tensors(F, quad, "cpu")
    v3 = _rand_elts(F, rng, 3)
    tabs = [F.to_limbs(_rand_elts(F, rng, 3), "cpu") for _ in range(3)]
    idx = torch.tensor([0, 1, 2])
    masked = fp_quad_bind(F, idx, idx.int(), idx.int(),
                          F.to_limbs(v3, "cpu"),
                          torch.tensor([True, False, True]), *tabs,
                          F.to_limbs(beta, "cpu"))
    vals = [F.from_limbs(t) for t in tabs]
    terms = [F.mul_i(F.mul_i(F.mul_i(b, vals[0][i]), vals[1][i]), vals[2][i])
             for i, b in enumerate([beta, v3[1], beta])]
    want = F.of_scalar(0)
    for x in terms:
        want = F.add_i(want, x)
    assert F.from_limbs(masked) == want
    assert int(qd["bmask"].sum()) == T // 10


# ----------------------------------------------------------------------
# the toy goldens: reading, writing, verifying, corruptions
# ----------------------------------------------------------------------

def _toy(field):
    """(port F, port circuit, port rs factory, JAX F, JAX circuit, JAX rs
    factory, golden bytes, public inputs) of a toy golden."""
    if field == "fp128":
        F, J = fp128(), jax_fp128()
        jc = _zk_circuit(J)
        pc = port_circuit(jc)
        rs = rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER, device="cpu")
        jrs = jax_rs_factory(J, P128_OMEGA, P128_OMEGA_ORDER)
        path, pub = TOY_BIN, toy_inputs(F.p)[:2]
    elif field == "p256":
        F, J = p256_base(), jax_p256()
        jc, pc = _port_toy_circuit()
        rs = rs_factory_for(F, F2=Fp2(F),
                            omega2=(P256_FP2_ROOT_X, P256_FP2_ROOT_Y),
                            omega_order=P256_FP2_ROOT_ORDER, device="cpu")
        jrs = jax_ecdsa_rs_factory(J)
        path, pub = TOY_P256_BIN, toy_inputs(F.p, 32)[:2]
    else:
        F, J = gf2_128(), jax_gf2()
        jc = gf2_toy_circuit(J)
        pc = port_gf2_circuit(jc)
        rs = rs_factory_for(F, device="cpu")
        jrs = jax_rs_factory(J)
        path, pub = TOY_GF2_BIN, gf2_toy_inputs(F)[:2]
    with open(path, "rb") as f:
        data = f.read()
    return F, pc, rs, J, jc, jrs, data, pub


def _toy_param(F, circ):
    return ZkVerifier(circ, F, None, rate=TOY_RATE, nreq=TOY_NREQ,
                      block_enc=TOY_BLOCK_ENC, device="cpu").param


def _port_verify(F, circ, rs, data, pub):
    v = ZkVerifier(circ, F, rs, rate=TOY_RATE, nreq=TOY_NREQ,
                   block_enc=TOY_BLOCK_ENC, device="cpu")
    zkp = read_zk_proof(data, circ, v.param, F, rate=TOY_RATE, nreq=TOY_NREQ)
    assert zkp is not None
    ts = Transcript(TOY_LABEL)
    v.recv_commitment(zkp, ts)
    return v.verify(zkp, pub, ts)


def _jax_verify(J, jc, jrs, data, pub):
    v = JaxZkVerifier(jc, J, jrs, rate=TOY_RATE, nreq=TOY_NREQ,
                      block_enc=TOY_BLOCK_ENC)
    zkp = jax_read_zk_proof(data, jc, v.param, J, rate=TOY_RATE,
                            nreq=TOY_NREQ)
    assert zkp is not None
    ts = JaxTranscript(TOY_LABEL)
    v.recv_commitment(zkp, ts)
    return v.verify(zkp, pub, ts)


CORRUPTIONS = ("none", "sumcheck", "y_ldt", "y_dot", "column", "public")


def _corrupt(F, circ, data, pub, how):
    """(proof bytes, public inputs) with one bit flipped in the named
    part: the low bit of the first sumcheck element, of y_ldt[0], of
    y_dot[0], of the first opened column's first value, or of the first
    public input."""
    param = _toy_param(F, circ)
    zkp = read_zk_proof(data, circ, param, F, rate=TOY_RATE, nreq=TOY_NREQ)
    pub = list(pub)
    if how == "sumcheck":
        zkp.proof.layers[0].hp[0][0][0] ^= 1
    elif how == "y_ldt":
        zkp.com_proof.y_ldt[0] ^= 1
    elif how == "y_dot":
        zkp.com_proof.y_dot[0] ^= 1
    elif how == "column":
        zkp.com_proof.req[0][0] ^= 1
    elif how == "public":
        pub[0] ^= 1
    return write_zk_proof(zkp, circ, param, F), pub


# The JAX ZkVerifier's (ok, why) on each toy golden and corruption (the
# tests below hold it and the port to these).  Every flip fails
# the Merkle check: the sumcheck elements, y_ldt, y_dot and the public
# inputs enter the transcript before the opened columns are drawn, so the
# columns are drawn elsewhere; a flipped opening changes its leaf.
JAX_ANSWERS = dict({"none": (True, "ok")},
                   **{how: (False, "merkle_check failed")
                      for how in CORRUPTIONS[1:]})


@pytest.mark.parametrize("field", FIELDS)
def test_read_write_roundtrip(field):
    """read_zk_proof then write_zk_proof gives back the golden bytes, and
    the port's reader parses what the JAX package's does (the GF(2^128)
    toy's openings hold subfield runs)."""
    F, pc, _, J, jc, _, data, _ = _toy(field)
    param = _toy_param(F, pc)
    zkp = read_zk_proof(data, pc, param, F, rate=TOY_RATE, nreq=TOY_NREQ)
    assert write_zk_proof(zkp, pc, param, F) == data
    jzkp = jax_read_zk_proof(data, jc, param, J, rate=TOY_RATE, nreq=TOY_NREQ)
    assert zkp.com_proof.req == jzkp.com_proof.req
    assert [l.hp for l in zkp.proof.layers] == \
        [l.hp for l in jzkp.proof.layers]
    if field == "gf2_128":
        sub = [F.in_subfield(v) for row in zkp.com_proof.req for v in row]
        assert any(sub) and not all(sub)


@pytest.mark.parametrize("field", FIELDS)
def test_short_or_malformed_proof_reads_as_none(field):
    """A truncated proof, or one with a run length past the openings, is
    None for both readers: no exception escapes."""
    F, pc, _, J, jc, _, data, _ = _toy(field)
    param = _toy_param(F, pc)
    sc = sum(4 * l.logw + 2 for l in pc.layers) * F.kBytes
    runs = 32 + sc + (param.block + 2 * param.dblock - param.w) * F.kBytes \
        + 32 * param.nreq
    bad_run = data[:runs] + (1 << 24).to_bytes(4, "little") + data[runs + 4:]
    for d in (b"", data[:31], data[:32 + F.kBytes], data[: runs + 2],
              data[: len(data) // 2], data[:-1], bad_run):
        assert read_zk_proof(d, pc, param, F, TOY_RATE, TOY_NREQ) is None
        assert jax_read_zk_proof(d, jc, param, J, TOY_RATE, TOY_NREQ) is None


# Held to the JAX verifier live only in the slow test: an accepted toy
# proof runs the JAX verifier's Reed-Solomon programs, which compile for
# about 25 s on a CPU and, over P-256, run 12-20 s more (the corruptions
# stop at the Merkle check, before them).
_JAX_SLOW = (("fp128", "none"), ("p256", "none"))


@pytest.mark.parametrize("field", FIELDS)
def test_corruptions_match_jax(field):
    """The port's ZkVerifier accepts the toy golden and refuses each of
    its five corruptions, with the JAX ZkVerifier's (ok, why)."""
    F, pc, rs, J, jc, jrs, data, pub = _toy(field)
    for how in CORRUPTIONS:
        d, p = _corrupt(F, pc, data, pub, how)
        got = _port_verify(F, pc, rs, d, p)
        assert got == JAX_ANSWERS[how], how
        if (field, how) not in _JAX_SLOW:
            assert _jax_verify(J, jc, jrs, d, p) == got, how


@pytest.mark.slow
@pytest.mark.parametrize("field,how", _JAX_SLOW)
def test_toy_golden_accepted_by_both_live(field, how):
    F, pc, rs, J, jc, jrs, data, pub = _toy(field)
    d, p = _corrupt(F, pc, data, pub, how)
    got = _port_verify(F, pc, rs, d, p)
    assert got == _jax_verify(J, jc, jrs, d, p) == JAX_ANSWERS[how]


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    F, pc, rs, *_ = _toy("fp128")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ZkVerifier(pc, F, rs, rate=TOY_RATE, nreq=TOY_NREQ)


# ----------------------------------------------------------------------
# the Merkle verifiers and the plain sumcheck verifier
# ----------------------------------------------------------------------

def test_merkle_verifiers_match_jax():
    """A compressed multi-leaf proof of the port's MerkleTree (37 leaves,
    not a power of two) and of its nonce-blinded commitment: accepted by
    the port's and the JAX package's verifiers; a tampered digest, leaf,
    nonce or proof length refused by both."""
    rng = np.random.default_rng(74)
    n = 37
    leaves = [rng.bytes(32) for _ in range(n)]
    tree = MerkleTree(n)
    tree.set_leaves(leaves)
    root = tree.build_tree()
    pos = [0, 5, 6, 17, 36]
    proof = tree.generate_compressed_proof(pos)
    opened = [leaves[p] for p in pos]

    def both(pf, lv, ps):
        a = MerkleTreeVerifier(n, root).verify_compressed_proof(pf, lv, ps)
        b = JaxTreeVerifier(n, root).verify_compressed_proof(pf, lv, ps)
        assert a == b
        return a

    assert both(proof, opened, pos)
    assert not both([proof[0][:-1] + b"\x00"] + proof[1:], opened, pos)
    assert not both(proof, [opened[0][::-1]] + opened[1:], pos)
    assert not both(proof[:-1], opened, pos)
    assert not both(proof + proof[:1], opened, pos)
    assert not both(proof, opened, [0, 5, 6, 17, 37])

    cols = [rng.bytes(48) for _ in range(n)]
    nonces = [rng.bytes(32) for _ in range(n)]
    from longfellow_zk_tpu_torch.merkle.merkle import leaf_hash
    com = MerkleCommitment(n)
    croot = com.commit_leaves([leaf_hash(c, x) for c, x in zip(cols, nonces)],
                              nonces)
    cproof, cnonces = com.open(pos)
    ccols = [cols[p] for p in pos]
    for nc, ok in ((cnonces, True), ([cnonces[1]] + cnonces[1:], False)):
        assert MerkleCommitmentVerifier(n, croot).verify(
            cproof, ccols, nc, pos) == ok
        assert JaxCommitmentVerifier(n, croot).verify(
            cproof, ccols, nc, pos) == ok


def test_sumcheck_verify_matches_jax():
    """The port's plain sumcheck verifier (bound quads by K7's plain
    version) accepts the port prover's proof of the mul-check circuit, as
    the JAX verifier does, and both refuse a copy with one changed wire
    claim for the same reason."""
    F, J = fp128(), jax_fp128()
    jc = _mul_check_circuit(J, 1)
    pc = port_circuit(jc)
    W = _witness(75)
    (proof, _, _), _ = _port_prove(pc, W, b"verify")
    for bad in (False, True):
        if bad:
            proof.layers[1].wc[0] = F.add_i(proof.layers[1].wc[0], 1)
        got = verify(pc, proof, [W], TranscriptSumcheck(
            Transcript(b"verify"), F), F, device="cpu")
        want = jax_sc_verify(jc, proof, [W], JaxTS(JaxTranscript(b"verify"),
                                                   J), J)
        assert got == want == ((False, "got != claim (layer)") if bad
                               else (True, "ok"))


# ----------------------------------------------------------------------
# the full-size goldens
# ----------------------------------------------------------------------

def _golden_verify(F, circ, rs, data, pub):
    v = ZkVerifier(circ, F, rs, rate=RATE, nreq=NREQ, device="cpu")
    zkp = read_zk_proof(data, circ, v.param, F, rate=RATE, nreq=NREQ)
    assert zkp is not None
    ts = Transcript(LABEL, version=K_VERSION)
    v.recv_commitment(zkp, ts)
    return v.verify(zkp, pub, ts)


def test_sha_golden_verifies_on_cpu():
    """The JAX package's SHA-256 one-block proof is accepted by the port's
    ZkVerifier on the CPU; a copy with one bit flipped in a sumcheck
    element is refused."""
    F = fp128()
    circ = read_circuit(F, FP128_ID, gzip.open(CIRCUIT, "rb").read())
    pub = sha_witness(F)[: circ.npub_in]
    rs = rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER, device="cpu")
    with open(GOLDEN_BIN, "rb") as f:
        data = f.read()
    assert _golden_verify(F, circ, rs, data, pub) == (True, "ok")
    bad = bytearray(data)
    bad[32] ^= 1
    assert _golden_verify(F, circ, rs, bytes(bad), pub)[0] is False


def _mdoc_args():
    mdoc, pkx, pky, tr, attrs, now, doc_type = mdoc_inputs(RequestedAttribute)
    spec = find_zk_spec_by_version(MDOC_META["version"], len(attrs))
    with open(MDOC_CIRCUIT, "rb") as f:
        circuit = f.read()
    with open(MDOC_BIN, "rb") as f:
        data = f.read()
    return circuit, pkx, pky, tr, attrs, now, data, doc_type, spec


def test_mdoc_verifier_refuses_a_short_proof():
    """run_mdoc_verifier refuses a truncated golden (no proof is
    verified: the reader refuses it first) and one shorter than its
    MACs."""
    circuit, pkx, pky, tr, attrs, now, data, doc_type, spec = _mdoc_args()
    for d in (data[:-1], data[: len(data) // 2], data[:50]):
        assert api.run_mdoc_verifier(circuit, pkx, pky, tr, attrs, now, d,
                                     doc_type, spec, device="cpu") is False


@pytest.mark.slow
def test_ecdsa_golden_verifies_on_cpu():
    from longfellow_zk_tpu_torch.circuits.ecdsa.verify import compute_witness
    from longfellow_zk_tpu_torch.ec.curves import ecdsa_sign, p256_curve
    from longfellow_zk_tpu_torch.proto.lfc1 import P256_ID

    F = p256_base()
    circ = read_circuit(F, P256_ID, gzip.open(ECDSA_CIRCUIT, "rb").read())
    pub = ecdsa_witness(F, p256_curve(), compute_witness,
                        ecdsa_sign)[: circ.npub_in]
    rs = rs_factory_for(F, F2=Fp2(F),
                        omega2=(P256_FP2_ROOT_X, P256_FP2_ROOT_Y),
                        omega_order=P256_FP2_ROOT_ORDER, device="cpu")
    with open(ECDSA_BIN, "rb") as f:
        data = f.read()
    assert _golden_verify(F, circ, rs, data, pub) == (True, "ok")


@pytest.mark.slow
def test_mdoc_golden_verifies_on_cpu():
    """The port's run_mdoc_verifier on the CPU accepts the mdoc golden and
    refuses the copy that tests/test_torch_golden.py's JAX verifier test
    flips (a bit of the hash proof's sumcheck part)."""
    circuit, pkx, pky, tr, attrs, now, data, doc_type, spec = _mdoc_args()
    assert api.run_mdoc_verifier(circuit, pkx, pky, tr, attrs, now, data,
                                 doc_type, spec, device="cpu")
    bad = bytearray(data)
    bad[6 * 16 + 32 + 5] ^= 0x10
    assert not api.run_mdoc_verifier(circuit, pkx, pky, tr, attrs, now,
                                     bytes(bad), doc_type, spec,
                                     device="cpu")
