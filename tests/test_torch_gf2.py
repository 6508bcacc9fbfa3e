"""The port's GF(2^128) slice (plain kernel versions, CPU) against the JAX
package on the same numpy-seeded inputs, exactly (field arithmetic is
exact: tolerance 0): the field ops, XOR sums, bind and hv update, the
LCH14 transforms and Reed-Solomon extend, a sumcheck over GF(2^128)
against the JAX host-round prover, the wire-merge plan's second stage,
the toy GF(2^128) ZK proof against JAX-made bytes, and the mdoc witness
builders.  Larger JAX compiles (LCH14 at the hash tableau's width, the
JAX verifier) are slow tests.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.circuits.mdoc import api as jax_api
from longfellow_zk_tpu.fields.gf2 import gf2_128 as jax_gf2
from longfellow_zk_tpu.random_oracle.transcript import (
    Transcript as JaxTranscript)
from longfellow_zk_tpu.sumcheck.prover import SumcheckProver as JaxProver
from longfellow_zk_tpu.sumcheck.prover_device import (
    _bind_fixed, _wire_merge_plan as jax_merge_plan)
from longfellow_zk_tpu.sumcheck.transcript_sumcheck import (
    TranscriptSumcheck as JaxTS)
from longfellow_zk_tpu.transforms.lch14 import LCH14 as JaxLCH14
from longfellow_zk_tpu.transforms.lch14 import (
    LCH14ReedSolomon as JaxLCH14RS, bits_to_halfwords, halfwords_to_bits)
from longfellow_zk_tpu_torch.circuits.mdoc import api
from longfellow_zk_tpu_torch.circuits.mdoc.witness import RequestedAttribute
from longfellow_zk_tpu_torch.fields.bridge import (
    circuit_from_arrays, gf2_from_jax, gf2_to_jax)
from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
from longfellow_zk_tpu_torch.random_oracle.engine import DeterministicEngine
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.sumcheck.circuit import LayerProof, Proof
from longfellow_zk_tpu_torch.sumcheck.prover import (
    SumcheckProver, _wire_merge_plan)
from longfellow_zk_tpu_torch.sumcheck.transcript_sumcheck import (
    TranscriptSumcheck)
from longfellow_zk_tpu_torch.transforms.lch14 import LCH14, LCH14ReedSolomon
from longfellow_zk_tpu_torch.zk.proof import ZkProof
from longfellow_zk_tpu_torch.zk.prover import ZkProver
from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof
from longfellow_zk_tpu_torch.zk.testing import rs_factory_for

from test_sumcheck import _mul_check_circuit
from test_torch_golden import (
    TOY_BLOCK_ENC, TOY_GF2_BIN, TOY_LABEL, TOY_NREQ, TOY_RATE,
    gf2_toy_circuit, gf2_toy_inputs)


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
MDOC = os.path.join(REPO, "artifacts", "mdoc_v7_1attr.zst")
EXAMPLES = os.path.join(REPO, "artifacts", "mdoc_examples.json")


def _halfwords(rng, shape):
    """Random GF(2^128) elements as JAX uint32[8, *shape] halfwords."""
    return rng.integers(0, 1 << 16, size=(8,) + tuple(shape),
                        dtype=np.uint32)


def _ints(rng, n):
    return [int.from_bytes(rng.bytes(16), "little") for _ in range(n)]


def port_gf2_circuit(jc):
    """The port's copy of a JAX-package GF(2^128) circuit."""
    J = jax_gf2()
    layers = [dict(nw=l.nw, logw=l.logw, g=l.quad.g, h0=l.quad.h0,
                   h1=l.quad.h1, v=J.to_limbs(list(l.quad.v)))
              for l in jc.layers]
    return circuit_from_arrays(gf2_128(), jc.nv, jc.nc, jc.ninputs,
                               jc.npub_in, layers, jc.subfield_boundary,
                               jc.id)


def test_host_constants_match_jax():
    J, F = jax_gf2(), gf2_128()
    assert F.g == J.g and F.beta == J.beta
    assert F.poly_evaluation_points == J.poly_evaluation_points
    assert F._newton_denoms == J._newton_denoms
    rng = np.random.default_rng(1)
    for x in _ints(rng, 4) + [F.of_scalar(0xBEEF)]:
        assert F.solve(x) == J.solve(x)


def test_add_mul_match_jax():
    J, F = jax_gf2(), gf2_128()
    rng = np.random.default_rng(2)
    a, b = _halfwords(rng, (4, 64)), _halfwords(rng, (4, 64))
    pa, pb = gf2_from_jax(a), gf2_from_jax(b)
    assert np.array_equal(gf2_to_jax(F.mul(pa, pb)),
                          np.asarray(J.mul(jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(gf2_to_jax(F.add(pa, pb)), a ^ b)
    assert np.array_equal(gf2_to_jax(F.sub(pa, pb)), a ^ b)
    # broadcast of one element against a row, as the wrappers take it
    assert np.array_equal(
        gf2_to_jax(F.mul(pa, pb[0, 0])),
        np.asarray(J.mul(jnp.asarray(a), jnp.asarray(b[:, :1, :1]))))
    assert torch.equal(F.from_mont(pa), pa)


def test_field_api_matches_jax():
    """Twin of tests/test_fields.py:146-170 over the whole device API of
    GF2_128 (fields/gf2.py:286 neg, :358 mul_const, :361 sqr, :378 inv,
    batch_inverse, :392-398 eq, is_zero, select, :260
    natural_limbs_to_bytes_dev): the port's plain versions against the
    JAX device functions, and the inverse against the host product."""
    J, F = jax_gf2(), gf2_128()
    rng = np.random.default_rng(12)
    xs = [0, 1, (1 << 128) - 1] + _ints(rng, 29)
    ys = [1, (1 << 128) - 1, 0] + _ints(rng, 29)
    ys[3::3] = xs[3::3]
    ja, jb = jnp.asarray(J.to_limbs(xs)), jnp.asarray(J.to_limbs(ys))
    pa, pb = gf2_from_jax(np.asarray(ja)), gf2_from_jax(np.asarray(jb))
    cond = rng.random(32) < 0.5
    c = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321
    for got, want in ((F.sqr(pa), J.sqr(ja)), (F.neg(pa), J.neg(ja)),
                      (F.mul_const(pa, c), J.mul_const(ja, c)),
                      (F.select(torch.as_tensor(cond), pa, pb),
                       J.select(jnp.asarray(cond), ja, jb))):
        assert np.array_equal(gf2_to_jax(got), np.asarray(want))
    assert np.array_equal(F.eq(pa, pb).numpy(), np.asarray(J.eq(ja, jb)))
    assert np.array_equal(F.is_zero(pa).numpy(), np.asarray(J.is_zero(ja)))
    assert np.array_equal(F.natural_limbs_to_bytes_dev(F.from_mont(pa)),
                          np.asarray(J.natural_limbs_to_bytes_dev(ja)))
    # the inverse: the JAX scan once, on 16 elements, 0 among them
    iv = F.inv(pa[:16])
    assert np.array_equal(gf2_to_jax(iv), np.asarray(J.inv(ja[:, :16])))
    assert type(F).batch_inverse is type(F).inv
    assert [J.mul_i(int(v), x) for v, x in zip(F.from_limbs(iv), xs)] == \
        [0] + [1] * 15


def test_sums_match_jax():
    J, F = jax_gf2(), gf2_128()
    rng = np.random.default_rng(3)
    x = _halfwords(rng, (300,))
    seg = np.sort(rng.integers(0, 40, 300))
    got = F.lazy_segment_sum(
        gf2_from_jax(x),
        torch.as_tensor(np.searchsorted(seg, np.arange(40), "left"),
                        dtype=torch.int32),
        torch.as_tensor(np.searchsorted(seg, np.arange(40), "right"),
                        dtype=torch.int32))
    ref = J.lazy_segment_sum(jnp.asarray(x), jnp.asarray(seg), 40)
    assert np.array_equal(gf2_to_jax(got), np.asarray(ref))
    y = _halfwords(rng, (7, 33))
    for dim in (0, 1):
        assert np.array_equal(
            gf2_to_jax(F.lazy_sum(gf2_from_jax(y), dim)),
            np.asarray(J.lazy_sum(jnp.asarray(y), dim)))


def test_bind_and_hv_update_match_jax():
    J, F = jax_gf2(), gf2_128()
    rng = np.random.default_rng(4)
    x, r = _halfwords(rng, (16,)), _halfwords(rng, ())
    got = F.bind(gf2_from_jax(x), gf2_from_jax(r))
    # the port keeps the bound half; the JAX package's fixed shape
    # zero-fills the rest
    ref = _bind_fixed(J, jnp.asarray(x), jnp.asarray(r), axis=-1)[..., :8]
    assert np.array_equal(gf2_to_jax(got), np.asarray(ref))
    hv = _halfwords(rng, (50,))
    h = rng.integers(0, 1 << 10, 50).astype(np.int32)
    got = F.hv_update(gf2_from_jax(hv), torch.as_tensor(h),
                      gf2_from_jax(r))
    rj = jnp.asarray(r)
    f = jnp.where(jnp.asarray(h & 1 == 1)[None], rj[:, None],
                  J.sub(jnp.asarray(J.to_limbs(1)), rj)[:, None])
    assert np.array_equal(gf2_to_jax(got),
                          np.asarray(J.mul(jnp.asarray(hv), f)))


@pytest.mark.parametrize("n,m", [(5, 13), (29, 64)])
def test_lch14_matches_jax(n, m):
    J, F = jax_gf2(), gf2_128()
    rng = np.random.default_rng(n)
    y = _halfwords(rng, (3, n))
    ref = JaxLCH14RS(n, m, J).interpolate(jnp.asarray(y))
    got = LCH14ReedSolomon(n, m, F, device="cpu").interpolate(
        gf2_from_jax(y))
    assert np.array_equal(gf2_to_jax(got), np.asarray(ref))


def test_lch14_transforms_match_jax():
    """fft and ifft on nonzero cosets, and the bidirectional FFT."""
    J, F = jax_gf2(), gf2_128()
    x = _halfwords(np.random.default_rng(8), (2, 8))
    xb, px = halfwords_to_bits(jnp.asarray(x)), gf2_from_jax(x)
    L, PL = JaxLCH14(J), LCH14(F)
    for ref, got in ((L.fft(xb, 16), PL.fft(px, 16)),
                     (L.ifft(xb, 8), PL.ifft(px, 8)),
                     (L.bidirectional_fft(xb, 5), PL.bidirectional_fft(px, 5))):
        assert np.array_equal(np.asarray(bits_to_halfwords(ref)),
                              gf2_to_jax(got))


@pytest.mark.slow
@pytest.mark.parametrize("n", [461, 921])
def test_lch14_hash_tableau_width_matches_jax(n):
    """One row of the mdoc hash tableau's encodings (block 461, dblock
    921, block_enc 4151)."""
    J, F = jax_gf2(), gf2_128()
    y = _halfwords(np.random.default_rng(n), (1, n))
    ref = JaxLCH14RS(n, 4151, J).interpolate(jnp.asarray(y))
    got = LCH14ReedSolomon(n, 4151, F, device="cpu").interpolate(
        gf2_from_jax(y))
    assert np.array_equal(gf2_to_jax(got), np.asarray(ref))


def _gf2_pad(circ, seed):
    """A random pad in the layout of ZkProver._fill_pad (p(1) slots 0)."""
    rng = np.random.default_rng(seed)
    pad = Proof()
    for layer in circ.layers:
        lp = LayerProof(cp=[], hp=[[], []], wc=_ints(rng, 2))
        for _ in range(layer.logw):
            for h in range(2):
                a, c = _ints(rng, 2)
                lp.hp[h].append([a, 0, c])
        pad.layers.append(lp)
    return pad


_SC_SEED = 5


@pytest.fixture(scope="module")
def jax_gf2_sumcheck():
    """The JAX host-round prover's sumcheck of the GF(2^128) mul-check
    circuit with a pad: (circuit, witness, pad, proof, aux, bindings,
    next transcript element)."""
    J, F = jax_gf2(), gf2_128()
    jc = _mul_check_circuit(J, 1)
    rng = np.random.default_rng(_SC_SEED)
    a, b = _ints(rng, 2)
    W = [a, b, F.mul_i(a, b), 1]
    pad = _gf2_pad(port_gf2_circuit(jc), _SC_SEED + 1)
    ts = JaxTranscript(b"gf2")
    tss = JaxTS(ts, J)
    tss.write_input([W])
    jp = JaxProver(J)
    inputs, _ = jp.eval_circuit(
        jc, jnp.asarray(J.to_limbs(W)).reshape(8, 4, 1))
    out = jp.prove(jc, inputs, tss, pad=pad, with_aux=True)
    return (jc, W, pad) + tuple(out) + (ts.elt(J),)


@pytest.mark.parametrize("merge_min", [4096, 0])
def test_sumcheck_matches_jax(merge_min, jax_gf2_sumcheck):
    """Circuit evaluation and the wire rounds over GF(2^128): proof,
    bound_quad, bindings and the next transcript element equal the JAX
    host-round prover's (merge_min 0: with term merging)."""
    jc, W, pad, p1, aux1, b1, elt1 = jax_gf2_sumcheck
    F = gf2_128()
    ts = Transcript(b"gf2")
    tss = TranscriptSumcheck(ts, F)
    tss.write_input([W])
    sp = SumcheckProver(F, device="cpu")
    sp.K_MERGE_MIN_TERMS = merge_min
    p2, aux2, b2 = sp.prove_with_witness(port_gf2_circuit(jc),
                                         F.to_limbs(W, "cpu"), tss, pad=pad)
    for l1, l2 in zip(p1.layers, p2.layers):
        assert l1.hp == l2.hp and l1.wc == l2.wc
    assert aux1.bound_quad == aux2.bound_quad
    assert [list(x) for x in b1["g"]] == [list(x) for x in b2["g"]]
    assert ts.elt(F) == elt1


def test_merge_plan_second_stage_matches_jax():
    """A synthetic layer with more than 262,144 distinct (h0, h1) pairs:
    the port's plan (permutation and stages) equals the JAX package's,
    and it has the second stage."""
    rng = np.random.default_rng(7)
    logw = 10
    h0 = rng.integers(0, 1 << logw, 400_000)
    h1 = rng.integers(0, 1 << logw, 400_000)
    perm, stages = _wire_merge_plan(h0, h1, logw)
    jperm, jstages = jax_merge_plan(h0, h1, logw)
    assert len(stages) == 2
    assert np.array_equal(perm, jperm)
    for s, js in zip(stages, jstages):
        assert s[0] == js[0]
        for a, b in zip(s[1:], js[1:]):
            assert np.array_equal(a, b)


def _port_toy_gf2_proof():
    F = gf2_128()
    circ = port_gf2_circuit(gf2_toy_circuit(jax_gf2()))
    W = gf2_toy_inputs(F)
    zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
    prover = ZkProver(circ, F, rs_factory_for(F, device="cpu"),
                      rate=TOY_RATE, nreq=TOY_NREQ, block_enc=TOY_BLOCK_ENC,
                      device="cpu")
    ts = Transcript(TOY_LABEL)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F), zkp, prover


def test_toy_gf2_proof_bytes_equal_jax():
    """The JAX-made toy GF(2^128) proof, whose first witness rows are
    subfield rows: subfield blinds, and subfield runs in the openings."""
    data, zkp, prover = _port_toy_gf2_proof()
    F, p = gf2_128(), prover.param
    assert p.w <= gf2_toy_circuit(jax_gf2()).ninputs - 2
    assert sum(F.in_subfield(v) for v in zkp.com_proof.req[p.iw]) == p.nreq
    with open(TOY_GF2_BIN, "rb") as f:
        assert data == f.read()


@pytest.mark.slow
def test_jax_verifier_accepts_toy_gf2_proof():
    from longfellow_zk_tpu.zk.serialization import read_zk_proof
    from longfellow_zk_tpu.zk.testing import rs_factory_for as jax_rs
    from longfellow_zk_tpu.zk.verifier import ZkVerifier

    J = jax_gf2()
    jc = gf2_toy_circuit(J)
    verifier = ZkVerifier(jc, J, jax_rs(J), rate=TOY_RATE, nreq=TOY_NREQ,
                          block_enc=TOY_BLOCK_ENC)
    zkp = read_zk_proof(_port_toy_gf2_proof()[0], jc, verifier.param, J,
                        rate=TOY_RATE, nreq=TOY_NREQ)
    ts = JaxTranscript(TOY_LABEL)
    verifier.recv_commitment(zkp, ts)
    ok, why = verifier.verify(zkp, gf2_toy_inputs(J)[:2], ts)
    assert ok, why


def test_mdoc_witnesses_match_jax():
    """W_hash and W_sig of the wallet example equal the JAX package's
    builders' lists and fill the circuits' inputs."""
    from longfellow_zk_tpu.circuits.mac.mac import MACReference as JaxMAC
    from longfellow_zk_tpu.circuits.mdoc.witness import (
        MdocHashWitness, MdocSignatureWitness)
    from longfellow_zk_tpu.circuits.mdoc.witness import (
        RequestedAttribute as JaxAttr)
    from longfellow_zk_tpu.ec.curves import p256_curve

    ex = json.load(open(EXAMPLES))[0]
    mdoc, tr = bytes.fromhex(ex["mdoc"]), bytes.fromhex(ex["transcript"])
    pkx, pky, now = int(ex["pkx"], 16), int(ex["pky"], 16), ex["now"].encode()
    c_sig, c_hash = api.load_circuits(open(MDOC, "rb").read())
    ap = JaxMAC().sample(6, DeterministicEngine(b"w"))
    W_hash, W_sig, _ = api.mdoc_witnesses(
        c_sig, c_hash, mdoc, pkx, pky, tr,
        [RequestedAttribute(id=b"age_over_18", cbor_value=b"\xf5")], now, 7,
        ap)
    assert len(W_hash) == c_hash.ninputs and len(W_sig) == c_sig.ninputs

    GF, FB = jax_api.GF, jax_api.FB
    attrs = [JaxAttr(id=b"age_over_18", cbor_value=b"\xf5")]
    hw = MdocHashWitness(1, GF, 7)
    hw.compute_witness(mdoc, tr, attrs)
    sw = MdocSignatureWitness(p256_curve(), FB)
    sw.compute_witness(pkx, pky, mdoc, tr)
    jh = jax_api.fill_hash_public(attrs, now, [0] * 6, 0, 7)
    for val in (hw.e_nat % FB.p, hw.dpkx_nat, hw.dpky_nat):
        jh.extend(GF.of_scalar((val >> i) & 1) for i in range(256))
    jh.extend(hw.fill_witness())
    for i in range(3):
        jh.extend(ap[2 * i : 2 * i + 2])
    js = jax_api.fill_sig_public(pkx, pky, sw.e2_nat, [0] * 6, 0)
    js.extend(sw.fill_witness(ap))
    assert W_hash == jh
    assert W_sig == js
