"""The plain sumcheck over nc copies (copy rounds) in the port, on the CPU
(the kernels' plain versions), against the JAX package on the same
inputs made from a numpy seed; field values compared as canonical
integers, exactly:

  - K16's plain version (fields/fp.py copy_round_sums_plain) against the
    JAX host-round SumcheckProver._evaluations_c (eager);
  - arrays/dense.bind and bind_all against the JAX package's;
  - K10's cubic mode (device_fs.round_tail_cubic, plain) against the
    host evals_of_coefs, TranscriptSumcheck.round and eval_lagrange;
  - the evaluation of a circuit with copies against the JAX
    SumcheckProver.eval_circuit;
  - whole proofs of the mul-check circuit of tests/test_sumcheck.py
    against the JAX host-round prove (cp, hp, wc, the bound quads, q, g
    and the transcript's final state): live for Fp128 at nc 3 and
    GF(2^128) at nc 4, and against a listing the JAX package made once
    (testdata/sumcheck_copies_toy.json) for Fp128 at nc 8 and at nc 3
    with a pad drawn from a DeterministicEngine;
  - the port's verify against the JAX verify, (ok, why), on an accepted
    proof and two corruptions.

The slow tests make the SHA-256 one-block circuit's proof over 64 copies
on the CPU and hold it to testdata/sumcheck_sha256_copies64.json, and
hold the port to the JAX host-round prover on that circuit at nc 4.

Regenerate the listings with

    JAX_PLATFORMS=cpu python tests/test_torch_copies.py [--toy] [--sha]
"""

import copy
import dataclasses
import gzip
import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.arrays import dense as jax_dense
from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.fields.fp_instances import p256_base as jax_p256
from longfellow_zk_tpu.fields.fp_instances import p256k1_base as jax_p256k1
from longfellow_zk_tpu.fields.gf2 import gf2_128 as jax_gf2
from longfellow_zk_tpu.random_oracle.engine import (
    DeterministicEngine as JaxEngine)
from longfellow_zk_tpu.random_oracle.transcript import (
    Transcript as JaxTranscript)
from longfellow_zk_tpu.sumcheck import poly as jax_poly
from longfellow_zk_tpu.sumcheck.prover import SumcheckProver as JaxProver
from longfellow_zk_tpu.sumcheck.transcript_sumcheck import (
    TranscriptSumcheck as JaxTS)
from longfellow_zk_tpu.sumcheck.verifier import verify as jax_verify
from longfellow_zk_tpu_torch.arrays import dense
from longfellow_zk_tpu_torch.fields import fp as fpm
from longfellow_zk_tpu_torch.fields.bridge import (
    copies_from_jax, copies_to_jax, limbs_from_jax)
from longfellow_zk_tpu_torch.fields.fp_instances import (
    fp128, p256_base, p256k1_base)
from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs
from longfellow_zk_tpu_torch.random_oracle.engine import DeterministicEngine
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.sumcheck.circuit import (
    Circuit, Layer, LayerProof, Proof, Quad)
from longfellow_zk_tpu_torch.sumcheck.prover import SumcheckProver
from longfellow_zk_tpu_torch.sumcheck.transcript_sumcheck import (
    TranscriptSumcheck)
from longfellow_zk_tpu_torch.sumcheck.verifier import verify

from test_sumcheck import _mul_check_circuit


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
TOY_JSON = os.path.join(TESTDATA, "sumcheck_copies_toy.json")
SHA_JSON = os.path.join(TESTDATA, "sumcheck_sha256_copies64.json")
SHA_CIRCUIT = os.path.join(REPO, "artifacts", "sha256_1block_fp128.lfc1.gz")

# field name -> (JAX field, port field)
FIELDS = {"fp128": (jax_fp128, fp128), "fp256": (jax_p256, p256_base),
          "fp256k1": (jax_p256k1, p256k1_base),
          "gf2_128": (jax_gf2, gf2_128)}


def _ints(F, rng, n):
    """n field elements (host ints) from a numpy seed."""
    if F.kCharacteristicTwo:
        return [int.from_bytes(rng.bytes(16), "little") for _ in range(n)]
    return [int.from_bytes(rng.bytes(F.kBytes), "little") % F.p
            for _ in range(n)]


def _lg(n):
    return (n - 1).bit_length() if n > 1 else 0


def with_copies(circ, nc):
    """The circuit `circ` (either package's) over nc copies: its layers
    unchanged, as the JAX compiler makes one (quad_circuit.py:462)."""
    return dataclasses.replace(circ, nc=nc, logc=_lg(nc))


def port_circuit(jc):
    """The port's copy of a JAX-package circuit (its host ints)."""
    return Circuit(nv=jc.nv, logv=jc.logv, nc=jc.nc, logc=jc.logc, nl=jc.nl,
                   ninputs=jc.ninputs, npub_in=jc.npub_in,
                   subfield_boundary=jc.subfield_boundary, id=jc.id,
                   layers=[Layer(nw=l.nw, logw=l.logw,
                                 quad=Quad(g=l.quad.g, h0=l.quad.h0,
                                           h1=l.quad.h1, v=list(l.quad.v)))
                           for l in jc.layers])


def mul_check_witness(F, nc, seed):
    """[nc][a, b, a * b, 1] from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nc):
        a, b = _ints(F, rng, 2)
        out.append([a, b, F.mul_i(a, b), 1])
    return out


def jax_w0(J, W_host):
    """W_host [nc][ninputs] -> the JAX layout [L, ninputs, nc]."""
    nc, n = len(W_host), len(W_host[0])
    flat = [W_host[c][w] for w in range(n) for c in range(nc)]
    return jnp.asarray(J.to_limbs(flat)).reshape(-1, n, nc)


def engine_pad(F, circ, engine):
    """A pad drawn from `engine` in the order of ZkProver._fill_pad: per
    layer the copy rounds' [r, 0, r, r], the hand-rounds' [r, 0, r], then
    wc."""
    pad = Proof()
    for layer in circ.layers:
        lp = LayerProof(cp=[], hp=[[], []], wc=[None, None])
        for _ in range(circ.logc):
            lp.cp.append([0 if k == 1 else F.sample(engine.bytes)
                          for k in range(4)])
        for _ in range(layer.logw):
            for h in range(2):
                lp.hp[h].append([0 if k == 1 else F.sample(engine.bytes)
                                 for k in range(3)])
        lp.wc = [F.sample(engine.bytes), F.sample(engine.bytes)]
        pad.layers.append(lp)
    return pad


def listing(F, proof, aux, bindings, ts):
    """Every field element of a plain sumcheck proof as canonical hex:
    per layer cp, hp, wc and the bound quad; the bindings q and g; the
    transcript's final state."""
    w = 2 * F.kBytes

    def hx(x):
        return "%0*x" % (w, int(x))

    return {"layers": [{"cp": [[hx(v) for v in p] for p in lp.cp],
                        "hp": [[[hx(v) for v in p] for p in hand]
                               for hand in lp.hp],
                        "wc": [hx(v) for v in lp.wc], "bound_quad": hx(bq)}
                       for lp, bq in zip(proof.layers, aux.bound_quad)],
            "q": [hx(x) for x in bindings["q"]],
            "g": [[hx(x) for x in h] for h in bindings["g"]],
            "transcript_state": ts.export_state().hex()}


def jax_prove(J, jc, W_host, label, pad=None):
    """The JAX host-round prover's proof of W_host [nc][ninputs] as a
    listing."""
    ts = JaxTranscript(label)
    tss = JaxTS(ts, J)
    tss.write_input(W_host)
    prover = JaxProver(J)
    inputs, V = prover.eval_circuit(jc, jax_w0(J, W_host))
    assert V is not None
    proof, aux, b = prover.prove(jc, inputs, tss, pad=pad, with_aux=True)
    return listing(J, proof, aux, b, ts)


def port_prove(F, pc, W_host, label, pad=None, device="cpu"):
    """The port's proof of W_host [nc][ninputs] on `device`: (proof,
    listing)."""
    ts = Transcript(label)
    tss = TranscriptSumcheck(ts, F)
    tss.write_input(W_host)
    W0 = F.to_limbs([w for W in W_host for w in W], device).reshape(
        (pc.nc, pc.ninputs) + F.elt_shape)
    proof, aux, b = SumcheckProver(F, device=device).prove_with_witness(
        pc, W0, tss, pad=pad)
    assert proof is not None
    return proof, listing(F, proof, aux, b, ts)


# ----------------------------------------------------------------------
# K16, dense binding and K10's cubic mode
# ----------------------------------------------------------------------

# the shapes are the mul-check circuit's (4 wires, 4 terms a layer), so
# the JAX package's eager ops compiled here serve its whole proofs below
@pytest.mark.parametrize("field,nc", [("fp128", 3), ("fp128", 8),
                                      ("fp256", 4), ("fp256k1", 2),
                                      ("gf2_128", 4)])
def test_k16_plain_matches_jax_evaluations_c(field, nc):
    """(c0, c2, c3) of a random layer: the port pads the copies to a
    power of two with zeros (as its prover does), the JAX function pads
    an odd count by one."""
    J, F = FIELDS[field][0](), FIELDS[field][1]()
    rng = np.random.default_rng(nc)
    nw, T, C = 4, 4, 1 << _lg(nc)
    h0, h1 = (rng.integers(0, nw, T).astype(np.int64) for _ in range(2))
    eq, hv = _ints(F, rng, nc), _ints(F, rng, T)
    W = _ints(F, rng, nw * nc)
    ref = JaxProver(J)._evaluations_c(
        jnp.asarray(J.to_limbs(eq)),
        jnp.asarray(J.to_limbs(W)).reshape(-1, nw, nc), [h0, h1],
        jnp.asarray(J.to_limbs(hv)))
    EQ = F.zeros((C,), "cpu")
    EQ[:nc] = F.to_limbs(eq, "cpu")
    Wt = F.zeros((nw, C), "cpu")
    Wt[:, :nc] = F.to_limbs(W, "cpu").reshape(nw, nc, -1)
    got = fpm.fp_copy_round_sums(
        F, EQ, Wt, torch.as_tensor(h0, dtype=torch.int32),
        torch.as_tensor(h1, dtype=torch.int32), F.to_limbs(hv, "cpu"))
    assert list(F.from_limbs(got)) == [J.from_limbs(np.asarray(x))
                                       for x in ref]


# odd and even lengths, the last axis and another (shapes of the copy
# binds of the whole proofs below: EQ [3] over Fp128, W [4, 4] over
# GF(2^128))
@pytest.mark.parametrize("field,shape,axis", [
    ("fp128", (3,), -1), ("fp128", (3, 4), 0), ("gf2_128", (4, 4), -1)])
def test_dense_bind_matches_jax(field, shape, axis):
    """bind and bind_all along an axis, odd lengths zero-padded."""
    J, F = FIELDS[field][0](), FIELDS[field][1]()
    rng = np.random.default_rng(sum(shape) + axis)
    n = int(np.prod(shape))
    x, rs = _ints(F, rng, n), _ints(F, rng, 3)
    xj = jnp.asarray(J.to_limbs(x)).reshape((-1,) + shape)
    xp = F.to_limbs(x, "cpu").reshape(shape + F.elt_shape)
    jaxis = axis if axis < 0 else axis + 1
    one = jax_dense.bind(J, xj, J.broadcast_const(rs[0]), jaxis)
    assert np.array_equal(
        limbs_from_jax(np.asarray(one)),
        dense.bind(F, xp, F.to_limbs(rs[0], "cpu"), axis))
    k = _lg(shape[axis])
    allj = jax_dense.bind_all(J, xj, [J.broadcast_const(r) for r in rs[:k]],
                              jaxis)
    assert np.array_equal(
        limbs_from_jax(np.asarray(allj)),
        dense.bind_all(F, xp, F.to_limbs(rs[:k], "cpu"), axis))


@pytest.mark.parametrize("field", list(FIELDS))
def test_k10_cubic_matches_host_round(field):
    """K10's cubic mode (plain version) against the host round: the cubic
    from (claim, c0, c2, c3), minus the pad, written by
    TranscriptSumcheck.round (evaluations 0, 2 and 3, each tagged), its
    challenge, and the claim interpolated at it; the row and the
    transcript's state after it."""
    J, F = FIELDS[field][0](), FIELDS[field][1]()
    rng = np.random.default_rng(len(field))
    consts = fpm.round_consts(F, "cpu")
    for prefix in (5, 58):
        ts = Transcript(rng.bytes(4))
        ts.write_bytes(rng.bytes(prefix))
        jts = JaxTranscript(b"")
        jts.import_state(ts.export_state())
        claim, c0, c2, c3, *pad = _ints(F, rng, 8)
        c1 = claim
        for x in (c0, c0, c2, c3):
            c1 = J.sub_i(c1, x)
        raw = jax_poly.evals_of_coefs(J, [c0, c1, c2, c3])
        ev = [J.sub_i(x, y) for x, y in zip(raw, pad)]
        r = JaxTS(jts, J).round(ev)
        new_claim = jax_poly.eval_lagrange(J, raw, r)

        fs = dfs.fs_init_from_host(ts, "cpu")
        claim_t = F.to_limbs(claim, "cpu")
        row = torch.empty((5, F.nlimb), dtype=torch.int32)
        dfs.round_tail_cubic(F, fs, claim_t, row,
                             F.to_limbs([c0, c2, c3], "cpu"),
                             F.to_limbs(pad, "cpu"), consts)
        assert list(F.from_limbs(row)) == ev + [r]
        assert F.from_limbs(claim_t) == new_claim
        assert bytes(fs.tolist()) == jts.export_state()


# ----------------------------------------------------------------------
# evaluation and whole proofs
# ----------------------------------------------------------------------

def test_eval_with_copies_matches_jax():
    """Every layer's inputs and the outputs of the mul-check circuit over
    3 copies against the JAX SumcheckProver.eval_circuit (copies
    leading in the port, trailing in the JAX layout)."""
    J, F = jax_fp128(), fp128()
    jc = _mul_check_circuit(J, 3)
    W_host = mul_check_witness(F, 3, 4)
    W_host[1][2] = F.add_i(W_host[1][2], 1)   # copy 1's output is not 0
    ins_j, V_j = JaxProver(J).eval_circuit(jc, jax_w0(J, W_host))
    W0 = F.to_limbs([w for W in W_host for w in W], "cpu").reshape(3, 4, -1)
    assert np.array_equal(copies_from_jax(np.asarray(jax_w0(J, W_host))),
                          W0)
    ins_p, V_p = SumcheckProver(F, device="cpu").eval_circuit(
        port_circuit(jc), W0)
    for a, b in zip(ins_j, ins_p):
        assert np.array_equal(np.asarray(a), copies_to_jax(b))
    assert np.array_equal(np.asarray(V_j), copies_to_jax(V_p))
    assert F.from_limbs(V_p[1]).any() and not F.from_limbs(V_p[0]).any()


@pytest.mark.parametrize("field,nc", [("fp128", 3), ("gf2_128", 4)])
def test_proof_matches_jax(field, nc):
    J, F = FIELDS[field][0](), FIELDS[field][1]()
    jc = _mul_check_circuit(J, nc)
    W_host = mul_check_witness(F, nc, nc)
    label = b"copies-%d" % nc
    _, got = port_prove(F, port_circuit(jc), W_host, label)
    assert got == jax_prove(J, jc, W_host, label)


def _toy_case(name):
    """(JAX circuit, witness, label, pad) of the toy listing `name`."""
    J, F = jax_fp128(), fp128()
    nc = {"fp128_nc8": 8, "fp128_nc3_pad": 3}[name]
    jc = _mul_check_circuit(J, nc)
    pad = None
    if name.endswith("_pad"):
        pad = engine_pad(F, port_circuit(jc), DeterministicEngine())
    return jc, mul_check_witness(F, nc, 10 + nc), name.encode(), pad


@pytest.mark.parametrize("name", ["fp128_nc8", "fp128_nc3_pad"])
def test_proof_matches_jax_listing(name):
    """Against the JAX host-round prover's listing (made once: see the
    module's docstring)."""
    jc, W_host, label, pad = _toy_case(name)
    _, got = port_prove(fp128(), port_circuit(jc), W_host, label, pad)
    with open(TOY_JSON) as f:
        assert got == json.load(f)[name]


def test_engine_pad_matches_jax_engine():
    """The toy listing's pad: the port's DeterministicEngine draws what
    the JAX package's does."""
    jc, _, _, pad = _toy_case("fp128_nc3_pad")
    jpad = engine_pad(jax_fp128(), jc, JaxEngine())
    assert [(l.cp, l.hp, l.wc) for l in pad.layers] == \
        [(l.cp, l.hp, l.wc) for l in jpad.layers]


def _corrupt(F, proof, what):
    lp = proof.layers[0]
    if what == "cp":
        lp.cp[0][0] = F.add_i(lp.cp[0][0], 1)
    elif what == "wc":
        lp.wc[1] = F.add_i(lp.wc[1], 1)
    return proof


@pytest.fixture(scope="module")
def verify_case():
    """A circuit over 3 copies (both packages'), its witness and the
    port's proof of it."""
    jc = _mul_check_circuit(jax_fp128(), 3)
    pc = port_circuit(jc)
    W_host = mul_check_witness(fp128(), 3, 30)
    return jc, pc, W_host, port_prove(fp128(), pc, W_host, b"verify")[0]


@pytest.mark.parametrize("what", ["none", "cp", "wc"])
def test_verify_matches_jax(what, verify_case):
    """The port's verify and the JAX verify give the same (ok, why) on
    an accepted proof over 3 copies and on a changed cp entry and wc."""
    J, F = jax_fp128(), fp128()
    jc, pc, W_host, proof = verify_case
    proof = _corrupt(F, copy.deepcopy(proof), what)
    got = verify(pc, proof, W_host, TranscriptSumcheck(Transcript(b"verify"),
                                                       F), F, device="cpu")
    ref = jax_verify(jc, proof, W_host, JaxTS(JaxTranscript(b"verify"), J), J)
    assert got == ref
    assert got[0] == (what == "none")


def test_copy_path_needs_a_device_or_the_cpu():
    """Asked for no device, the copy path's entry points raise without a
    card; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    F = fp128()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SumcheckProver(F)
    pc = port_circuit(_mul_check_circuit(jax_fp128(), 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify(pc, Proof(layers=[LayerProof([], [[], []], [0, 0])] * 2),
               mul_check_witness(F, 2, 1),
               TranscriptSumcheck(Transcript(b"x"), F), F)


# ----------------------------------------------------------------------
# the SHA-256 one-block circuit over copies (slow)
# ----------------------------------------------------------------------

SHA_NC = 64
SHA_LABEL = b"sha256-copies"


def sha_messages(nc):
    """Copy 0 the golden's message, copies 1.. msg0001, msg0002, ..."""
    return [b"abc"] + [b"msg%04d" % i for i in range(1, nc)]


def sha_witnesses(F, nc, sha):
    """[nc][ninputs] of the SHA-256 one-block circuit from the witness
    module `sha` (either package's circuits/sha/sha256.py)."""
    out = []
    for m in sha_messages(nc):
        padded = sha.sha256_pad(m)
        W = [F.of_scalar(1)] + [F.of_scalar((b >> i) & 1)
                                for b in padded for i in range(8)]
        W.extend(sha.pack_block_witness(
            F, 4, [sha.transform_block_witness(sha.SHA256_INIT, padded)]))
        out.append(W)
    return out


def jax_sha_listing(nc):
    from longfellow_zk_tpu.circuits.sha import sha256 as jsha
    from longfellow_zk_tpu.proto.lfc1 import FP128_ID, read_circuit

    J = jax_fp128()
    jc = with_copies(read_circuit(J, FP128_ID,
                                  gzip.open(SHA_CIRCUIT, "rb").read()), nc)
    return jax_prove(J, jc, sha_witnesses(J, nc, jsha), SHA_LABEL)


def port_sha_listing(nc, device="cpu"):
    from longfellow_zk_tpu_torch.circuits.sha import sha256 as psha
    from longfellow_zk_tpu_torch.proto.lfc1 import FP128_ID, read_circuit

    F = fp128()
    pc = with_copies(read_circuit(F, FP128_ID,
                                  gzip.open(SHA_CIRCUIT, "rb").read()), nc)
    return port_prove(F, pc, sha_witnesses(F, nc, psha), SHA_LABEL,
                      device=device)[1]


@pytest.mark.slow
def test_port_cpu_path_reproduces_sha_copies64_golden():
    with open(SHA_JSON) as f:
        golden = json.load(f)
    assert port_sha_listing(SHA_NC) == golden["listing"]


@pytest.mark.slow
def test_sha_copies4_matches_jax():
    assert port_sha_listing(4) == jax_sha_listing(4)


def write_toy_listing():
    out = {}
    for name in ("fp128_nc8", "fp128_nc3_pad"):
        jc, W_host, label, pad = _toy_case(name)
        if pad is not None:
            pad = engine_pad(jax_fp128(), jc, JaxEngine())
        out[name] = jax_prove(jax_fp128(), jc, W_host, label, pad)
    out["made_by"] = ("tests/test_torch_copies.py --toy: the JAX package's "
                      "host-round SumcheckProver (CPU)")
    with open(TOY_JSON, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def write_sha_listing(use_jax):
    listing_ = jax_sha_listing(SHA_NC) if use_jax else \
        port_sha_listing(SHA_NC)
    out = {"circuit": "artifacts/sha256_1block_fp128.lfc1.gz",
           "nc": SHA_NC, "logc": _lg(SHA_NC),
           "messages": "copy 0 b'abc', copy c > 0 b'msg%04d' % c",
           "transcript_label": SHA_LABEL.decode(),
           "made_by": ("tests/test_torch_copies.py --sha: " +
                       ("the JAX package's host-round SumcheckProver (CPU)"
                        if use_jax else
                        "the port's SumcheckProver on the CPU (plain "
                        "versions); tests/test_torch_copies.py holds it to "
                        "the JAX host-round prover at nc 4")),
           "listing": listing_}
    with open(SHA_JSON, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    only = set(sys.argv[1:])
    if not only or "--toy" in only:
        write_toy_listing()
        print("written", TOY_JSON)
    if not only or "--sha" in only:
        write_sha_listing(use_jax="--port" not in only)
        print("written", SHA_JSON)
