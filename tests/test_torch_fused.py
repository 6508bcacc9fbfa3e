"""The ZK prover's device steps after the sumcheck (zk/fused.py: K11's
and K12's plain versions, the Ligero finish) against the JAX package's
host functions, on the CPU, for Fp128, P-256 and GF(2^128).  Exact:
field elements compared as canonical integers, transcript states as
bytes.  Inputs come from numpy seeds and the toy proofs of
tests/test_torch_golden.py.

Each field's toy proof runs once (the port's ZkProver.prove, with the
port's host verifier_constraints, inner_product_vector and gen_idx made
to raise); the tests read what it passed to and got from
constraints_dev.
"""

import gzip
import sys

import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.fields.fp_instances import p256_base as jax_p256
from longfellow_zk_tpu.fields.gf2 import gf2_128 as jax_gf2
from longfellow_zk_tpu.ligero import param as jparam
from longfellow_zk_tpu.ligero.transcript import (
    gen_alphal, gen_alphaq, gen_idx, gen_uldt, gen_uquad)
from longfellow_zk_tpu.random_oracle.transcript import (
    Transcript as JaxTranscript)
from longfellow_zk_tpu.zk import common as jcommon
from longfellow_zk_tpu_torch.fields.fp2 import Fp2
from longfellow_zk_tpu_torch.fields.fp_instances import (
    P128_OMEGA, P128_OMEGA_ORDER, P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X,
    P256_FP2_ROOT_Y, fp128, p256_base)
from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
from longfellow_zk_tpu_torch.proto.lfc1 import FP128_ID, read_circuit
from longfellow_zk_tpu_torch.random_oracle.engine import DeterministicEngine
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.sumcheck.circuit import ProofAux
from longfellow_zk_tpu_torch.zk import common as pcommon
from longfellow_zk_tpu_torch.zk import fused
from longfellow_zk_tpu_torch.zk import prover as zkprover
from longfellow_zk_tpu_torch.zk.proof import ZkProof
from longfellow_zk_tpu_torch.zk.prover import ZkProver
from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof
from longfellow_zk_tpu_torch.zk.testing import rs_factory_for

from test_torch_fp256 import _port_toy_circuit as p256_toy_circuit
from test_torch_gf2 import port_gf2_circuit
from test_torch_golden import (
    CIRCUIT, TOY_BIN, TOY_BLOCK_ENC, TOY_GF2_BIN, TOY_LABEL, TOY_NREQ,
    TOY_P256_BIN, TOY_RATE, gf2_toy_circuit, gf2_toy_inputs, toy_inputs)
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


FIELDS = ["fp128", "p256", "gf2_128"]
# the host steps the prover no longer takes (the verifier still does)
HOST_STEPS = ("verifier_constraints", "inner_product_vector", "gen_idx")


def _toy(field):
    """(J, F, JAX circuit, port circuit, witness, RS factory, golden)."""
    if field == "fp128":
        J, F = jax_fp128(), fp128()
        jc = _zk_circuit(J)
        return (J, F, jc, port_circuit(jc), toy_inputs(F.p),
                rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER, device="cpu"),
                TOY_BIN)
    if field == "p256":
        J, F = jax_p256(), p256_base()
        jc, pc = p256_toy_circuit()
        return (J, F, jc, pc, toy_inputs(F.p, 32),
                rs_factory_for(F, F2=Fp2(F),
                               omega2=(P256_FP2_ROOT_X, P256_FP2_ROOT_Y),
                               omega_order=P256_FP2_ROOT_ORDER,
                               device="cpu"), TOY_P256_BIN)
    J, F = jax_gf2(), gf2_128()
    jc = gf2_toy_circuit(J)
    return (J, F, jc, port_gf2_circuit(jc), gf2_toy_inputs(F),
            rs_factory_for(F, device="cpu"), TOY_GF2_BIN)


def _raise(*args, **kwargs):
    raise AssertionError("the prover took a host step")


_RUNS = {}


def _run(field):
    """The port's toy proof over `field` with the host steps made to
    raise, once per module: its bytes, its prover and transcript, the
    transcript state after the commit and what constraints_dev got and
    returned."""
    if field in _RUNS:
        return _RUNS[field]
    J, F, jc, circ, W, rs, golden = _toy(field)
    seen = {}
    real = zkprover.constraints_dev

    def spy(F_, tabs, outs, rows, pads, fs, one):
        # the one proof is the prover's lane 0
        seen.update(stat=tabs.stat, fs=fs[0].clone())
        k = real(F_, tabs, outs, rows, pads, fs, one)
        seen["k"] = k[0]
        return k

    mp = pytest.MonkeyPatch()
    try:
        for mod in [m for n, m in sys.modules.items()
                    if n.startswith("longfellow_zk_tpu_torch")]:
            for name in HOST_STEPS:
                if hasattr(mod, name):
                    mp.setattr(mod, name, _raise)
        mp.setattr(zkprover, "constraints_dev", spy)
        zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
        prover = ZkProver(circ, F, rs, rate=TOY_RATE, nreq=TOY_NREQ,
                          block_enc=TOY_BLOCK_ENC, device="cpu")
        ts = Transcript(TOY_LABEL)
        prover.commit(zkp, W, ts, DeterministicEngine())
        after_commit = ts.export_state()
        assert prover.prove(zkp, W, ts)
    finally:
        mp.undo()
    _RUNS[field] = dict(J=J, F=F, jc=jc, circ=circ, W=W, golden=golden,
                        zkp=zkp, prover=prover, ts=ts,
                        after_commit=after_commit,
                        data=write_zk_proof(zkp, circ, prover.param, F),
                        **seen)
    return _RUNS[field]


def _jax_ts(state):
    jts = JaxTranscript(b"")
    jts.import_state(state)
    return jts


@pytest.mark.parametrize("field", FIELDS)
def test_toy_proof_without_host_steps(field):
    """The toy proof equals the JAX package's golden bytes with the host
    verifier_constraints, inner_product_vector and gen_idx raising, and
    the transcript ends where the JAX prover's host flow leaves it
    (replayed from the commit with the JAX package's functions on the
    proof's messages: the sumcheck and constraint replay, the HASH_OF_A
    write, the four draws, the four response writes, gen_idx)."""
    r = _run(field)
    with open(r["golden"], "rb") as f:
        assert r["data"] == f.read()
    J, jc, W, zkp = r["J"], r["jc"], r["W"], r["zkp"]
    p = r["prover"].param
    jts = _jax_ts(r["after_commit"])
    jcommon.initialize_sumcheck_fiat_shamir(jts, jc, W, J)
    aux = ProofAux()
    aux.bound_quad = [lp._bound_quad for lp in zkp.proof.layers]
    n_witness = jc.ninputs - jc.npub_in
    _, _, nl = jcommon.verifier_constraints(jc, W, zkp.proof, aux, jts,
                                            n_witness, J)
    jts.write_bytes(jcommon.HASH_OF_A)
    gen_uldt(p, jts, J)
    gen_alphal(nl, jts, J)
    gen_alphaq(p, jts, J)
    gen_uquad(p, jts, J)
    lpf = zkp.com_proof
    for ys in (lpf.y_ldt, lpf.y_dot, lpf.y_quad_0, lpf.y_quad_2):
        jts.write_elts(ys, J)
    idx = gen_idx(p, jts, J)
    assert r["ts"].export_state() == jts.export_state()
    # the opened columns are the tableau's at the JAX package's choice
    T = r["F"].from_limbs(r["prover"].lp.tableau[0])
    assert [list(row) for row in T[:, np.asarray(idx) + p.dblock]] == \
        lpf.req


@pytest.mark.parametrize("field", FIELDS)
def test_verifier_ends_where_prover_ends(field):
    """The port's host verifier, on the toy proof from the same start,
    accepts it and leaves its transcript in the state the prover's ends
    in (what chip_smoke.py holds both to on the golden proofs)."""
    from longfellow_zk_tpu_torch.zk.serialization import read_zk_proof
    from longfellow_zk_tpu_torch.zk.verifier import ZkVerifier

    r = _run(field)
    _, F, _, circ, W, rs, _ = _toy(field)
    v = ZkVerifier(circ, F, rs, rate=TOY_RATE, nreq=TOY_NREQ,
                   block_enc=TOY_BLOCK_ENC, device="cpu")
    zkp = read_zk_proof(r["data"], circ, v.param, F, TOY_RATE, TOY_NREQ)
    ts = Transcript(TOY_LABEL)
    v.recv_commitment(zkp, ts)
    ok, _ = v.verify(zkp, W[: circ.npub_in], ts)
    assert ok
    assert ts.export_state() == r["ts"].export_state()


@pytest.mark.parametrize("field", FIELDS)
def test_constraints_match_verifier_constraints(field):
    """K11's plain version and the input binding (constraints_dev) give
    the (c, w, k) list of the JAX package's host verifier_constraints and
    of the port's own, through FusedStatic's positions, on the toy
    proof's sumcheck outputs; alpha_b leaves the transcript as the
    host's Transcript.elt does."""
    r = _run(field)
    J, F, jc, W, zkp = r["J"], r["F"], r["jc"], r["W"], r["zkp"]
    stat = r["stat"]
    got = list(zip(stat.cs.tolist(), stat.ws.tolist(),
                   F.from_limbs(r["k"]).tolist()))
    aux = ProofAux()
    aux.bound_quad = [lp._bound_quad for lp in zkp.proof.layers]
    n_witness = jc.ninputs - jc.npub_in
    state = _jax_ts(r["after_commit"])
    jcommon.initialize_sumcheck_fiat_shamir(state, jc, W, J)
    start = state.export_state()
    jts = _jax_ts(start)
    ja, _, jnl = jcommon.verifier_constraints(jc, W, zkp.proof, aux, jts,
                                              n_witness, J)
    assert got == [(t.c, t.w, t.k) for t in ja]
    assert jnl == stat.nl_constraints
    pts = Transcript(b"")
    pts.import_state(start)
    pa, _, _ = pcommon.verifier_constraints(r["circ"], W, zkp.proof, pts,
                                            n_witness, F, "cpu")
    assert got == [(t.c, t.w, t.k) for t in pa]
    # constraints_dev got the state after the last layer's write and
    # left it there; the host has squeezed alpha_b from the same state
    assert bytes(r["fs"].tolist()) == jts.export_state()


@pytest.mark.parametrize("field", FIELDS)
def test_inner_product_matches_host(field):
    """K12's plain version against the JAX package's host
    inner_product_vector in the layout_Aext layout, on the toy proof's k
    and random alphal and alphaq."""
    r = _run(field)
    J, F, stat = r["J"], r["F"], r["stat"]
    _check_inner_product(J, F, stat, r["k"], r["prover"].lqc,
                         np.random.default_rng(61))


def test_inner_product_at_sha_geometry():
    """K12's plain version at the SHA-256 one-block proof's geometry (15
    witness and quadratic rows of 341), random k, alphal and alphaq
    against the JAX host inner_product_vector; FusedStatic's positions
    against the JAX package's FusedStatic."""
    from longfellow_zk_tpu.zk.fused import FusedStatic as JaxFusedStatic

    J, F = jax_fp128(), fp128()
    circ = read_circuit(F, FP128_ID, gzip.open(CIRCUIT, "rb").read())
    prover = ZkProver(circ, F, None, rate=4, nreq=128, device="cpu")
    stat = fused.fused_static(circ, prover.param, prover.lqc,
                              prover.n_witness)
    jstat = JaxFusedStatic(circ, prover.param, prover.lqc,
                           prover.n_witness)
    for name in ("ws", "cs", "qws", "qcols", "qneg"):
        assert getattr(stat, name).tolist() == \
            getattr(jstat, name).astype(np.int64).tolist(), name
    rng = np.random.default_rng(62)
    k = F.to_limbs([int.from_bytes(rng.bytes(16), "little") % F.p
                    for _ in stat.ws], "cpu")
    _check_inner_product(J, F, stat, k, prover.lqc, rng)


def _check_inner_product(J, F, stat, k, lqc, rng):
    p = stat.p
    mod = (1 << 128) if F.kCharacteristicTwo else F.p

    def ints(n):
        return [int.from_bytes(rng.bytes(4 * F.nlimb), "little") % mod
                for _ in range(n)]

    alphal, alphaq = ints(stat.nl_constraints), ints(3 * p.nq)
    A = fused.ligero_inner_product(F, fused.prepare(F, stat, "cpu"), k,
                                   F.to_limbs(alphal, "cpu"),
                                   F.to_limbs(alphaq, "cpu"))
    llterm = [jparam.LigeroLinearConstraint(c=int(c), w=int(w), k=v)
              for c, w, v in zip(stat.cs, stat.ws, F.from_limbs(k))]
    want = jparam.inner_product_vector(
        J, p, stat.nl_constraints, llterm, alphal, lqc,
        [alphaq[3 * i : 3 * i + 3] for i in range(p.nq)])
    rows = [jparam.layout_Aext(J, p, i, want) for i in range(p.nwqrow)]
    assert F.from_limbs(A).tolist() == rows


def test_lagrange3_consts_match_host_interpolation():
    """K11's constants: L_k(x) = inv_d_k prod_{j != k} (x - x_j) is the
    host's _wpoly_lagrange_coef at a random point, every field."""
    rng = np.random.default_rng(63)
    for F in (fp128(), p256_base(), gf2_128()):
        x0, x1, x2, d0, d1, d2 = F.from_limbs(
            fused.lagrange3_consts(F, "cpu")).tolist()
        mod = (1 << 128) if F.kCharacteristicTwo else F.p
        x = int.from_bytes(rng.bytes(32), "little") % mod
        a, b, c = F.sub_i(x, x0), F.sub_i(x, x1), F.sub_i(x, x2)
        assert [F.mul_i(F.mul_i(d0, b), c), F.mul_i(F.mul_i(d1, a), c),
                F.mul_i(F.mul_i(d2, a), b)] == \
            pcommon._wpoly_lagrange_coef(F, x)


def test_verifier_keeps_host_flow():
    """The verifier still draws and replays on the host: its module
    holds the host functions the prover gave up."""
    from longfellow_zk_tpu_torch.ligero import verifier as lv
    from longfellow_zk_tpu_torch.zk import verifier as zv

    assert zv.verifier_constraints is pcommon.verifier_constraints
    assert lv.inner_product_vector.__module__.endswith("ligero.param")
    assert lv.gen_idx.__module__.endswith("ligero.transcript")
    assert not hasattr(zkprover, "verifier_constraints")
