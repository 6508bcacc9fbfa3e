"""The port's lane-batched prover (zk/batch.py BatchZkProver) on the CPU,
with the kernels' plain versions: each lane's proof against the port's
scalar ZkProver with the same transcript tag and the same randomness
stream, and against the JAX package's golden toy proofs; the port's
verifier on every lane; an unsatisfied lane; the lane-batched plain
versions of K1's bind and hv, K3, K9 (mode 9 too), K10, K11 and K12
against one call a lane.  Exact: proofs and transcript states as bytes,
field elements as canonical integers.  The JAX package's own
BatchZkProver is a slow test (it compiles for minutes on a CPU).
"""

import random

import numpy as np
import pytest
import torch

from longfellow_zk_tpu_torch.fields import fp as fpm
from longfellow_zk_tpu_torch.fields.fp_instances import fp128
from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs
from longfellow_zk_tpu_torch.random_oracle.engine import DeterministicEngine
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.zk import fused
from longfellow_zk_tpu_torch.zk.batch import BatchZkProver
from longfellow_zk_tpu_torch.zk.proof import ZkProof
from longfellow_zk_tpu_torch.zk.prover import ZkProver
from longfellow_zk_tpu_torch.zk.serialization import (
    read_zk_proof, write_zk_proof)
from longfellow_zk_tpu_torch.zk.verifier import ZkVerifier

from test_torch_device_fs import REJECT_LABEL
from test_torch_fused import _toy
from test_torch_golden import TOY_BLOCK_ENC, TOY_LABEL, TOY_NREQ, TOY_RATE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _witnesses(field, F, W0, B, seed):
    """B satisfying witnesses of the toy circuit ([c, 1, a, b, ...] with
    c = a b): the golden's W0 first, then ones from a numpy seed (for
    GF(2^128) in the subfield, as the golden's)."""
    rng = np.random.default_rng(seed)
    out = [list(W0)]
    for _ in range(B - 1):
        if F.kCharacteristicTwo:
            a, b, *xs = (F.of_scalar(int(u)) for u in
                         rng.integers(1, 1 << 16, len(W0) - 2))
        else:
            a, b = (int.from_bytes(rng.bytes(32), "little") % F.p
                    for _ in range(2))
            xs = list(W0[4:])
        out.append([F.mul_i(a, b), F.of_scalar(1), a, b] + xs)
    return out


def _tag(i):
    return TOY_LABEL if i == 0 else b"lane%d" % i


def _scalar_proofs(circ, F, rs, Ws):
    """The scalar ZkProver's proofs of Ws, lane i under _tag(i), all from
    one DeterministicEngine in lane order; and their final transcript
    states."""
    eng = DeterministicEngine()
    out, states = [], []
    for i, W in enumerate(Ws):
        zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
        pr = ZkProver(circ, F, rs, rate=TOY_RATE, nreq=TOY_NREQ,
                      block_enc=TOY_BLOCK_ENC, device="cpu")
        ts = Transcript(_tag(i))
        pr.commit(zkp, W, ts, eng)
        assert pr.prove(zkp, W, ts)
        out.append(write_zk_proof(zkp, circ, pr.param, F))
        states.append(ts.export_state())
    return out, states


def _batch(circ, F, rs, Ws):
    """The batch's proofs of Ws and the lanes' final transcript states."""
    bp = BatchZkProver(circ, F, rs, rate=TOY_RATE, nreq=TOY_NREQ,
                       block_enc=TOY_BLOCK_ENC, device="cpu")
    tss = [Transcript(_tag(i)) for i in range(len(Ws))]
    got = bp.prove_batch(Ws, tss, DeterministicEngine())
    return got, [ts.export_state() for ts in tss]


_RUNS = {}


@pytest.fixture(scope="module")
def fp128_batch():
    """The toy Fp128 batch at B = 3 and its scalar twins, made once for
    the module."""
    if "fp128" not in _RUNS:
        _, F, _, circ, W, rs, golden = _toy("fp128")
        Ws = _witnesses("fp128", F, W, 3, 71)
        _RUNS["fp128"] = dict(F=F, circ=circ, rs=rs, Ws=Ws, golden=golden,
                              batch=_batch(circ, F, rs, Ws),
                              scalar=_scalar_proofs(circ, F, rs, Ws))
    return _RUNS["fp128"]


def _check_lanes(run):
    got, got_states = run["batch"]
    want, want_states = run["scalar"]
    assert got == want
    assert got_states == want_states
    with open(run["golden"], "rb") as f:
        assert got[0] == f.read()


def test_fp128_batch_equals_scalar_proofs_and_golden(fp128_batch):
    """(a) Every lane of the B = 3 toy Fp128 batch equals the scalar proof
    with the same tag and the same continued stream, and ends its
    transcript in the same state; lane 0 (the golden's inputs, tag and a
    fresh engine) equals testdata/zk_toy_fp128.proof.bin."""
    _check_lanes(fp128_batch)


@pytest.mark.parametrize("field", ["p256", "gf2_128"])
def test_batch_equals_scalar_proofs_and_golden(field):
    """(b) The same at B = 2 for the toy P-256 proof (RS over Fp2) and the
    toy GF(2^128) proof (LCH14, subfield rows)."""
    _, F, _, circ, W, rs, golden = _toy(field)
    Ws = _witnesses(field, F, W, 2, 72)
    _check_lanes(dict(golden=golden, batch=_batch(circ, F, rs, Ws),
                      scalar=_scalar_proofs(circ, F, rs, Ws)))


def test_verifier_accepts_every_lane(fp128_batch):
    """(c) The port's ZkVerifier accepts every lane of the Fp128 batch."""
    r = fp128_batch
    F, circ = r["F"], r["circ"]
    for i, (data, W) in enumerate(zip(r["batch"][0], r["Ws"])):
        v = ZkVerifier(circ, F, r["rs"], rate=TOY_RATE, nreq=TOY_NREQ,
                       block_enc=TOY_BLOCK_ENC, device="cpu")
        zkp = read_zk_proof(data, circ, v.param, F, TOY_RATE, TOY_NREQ)
        ts = Transcript(_tag(i))
        v.recv_commitment(zkp, ts)
        ok, why = v.verify(zkp, W[: circ.npub_in], ts)
        assert ok, (i, why)


def test_unsatisfied_lane_raises_and_names_it(fp128_batch):
    """(d) A batch whose lane 1 does not satisfy the circuit raises
    before any round runs, naming lane 1."""
    r = fp128_batch
    F = r["F"]
    Ws = [list(W) for W in r["Ws"]]
    Ws[1][0] = F.add_i(Ws[1][0], 1)
    bp = BatchZkProver(r["circ"], F, r["rs"], rate=TOY_RATE, nreq=TOY_NREQ,
                       block_enc=TOY_BLOCK_ENC, device="cpu")
    calls = []
    real = bp.prover._prove_dev
    bp.prover._prove_dev = lambda *a: calls.append(1) or real(*a)
    with pytest.raises(ValueError, match="lane 1 does not satisfy"):
        bp.prove_batch(Ws, [Transcript(_tag(i)) for i in range(3)],
                       DeterministicEngine())
    assert not calls


def test_batch_of_one_equals_zk_prover(fp128_batch):
    """(f) B = 1 is ZkProver: the batch of the golden's lane alone."""
    r = fp128_batch
    got, states = _batch(r["circ"], r["F"], r["rs"], r["Ws"][:1])
    assert got == r["scalar"][0][:1]
    assert states == r["scalar"][1][:1]


# ----------------------------------------------------------------------
# (e) the lane-batched plain versions against one call a lane
# ----------------------------------------------------------------------

def _rand(F, rng, shape):
    n = int(np.prod(shape))
    mod = (1 << 128) if F.kCharacteristicTwo else F.p
    return F.to_limbs([int.from_bytes(rng.bytes(4 * F.nlimb), "little") % mod
                       for _ in range(n)], "cpu").reshape(
                           tuple(shape) + F.elt_shape)


def _eq(a, b):
    assert torch.equal(a, b)


@pytest.mark.parametrize("mk", [fp128, gf2_128], ids=["fp128", "gf2_128"])
def test_lane_bind_hv_wire_sums(mk):
    """K1's bind and hv with one challenge a lane (a strided view of a rows
    tensor, as the sumcheck passes it) and K3's wire sums with a lane
    axis, against one call a lane."""
    F, rng, B = mk(), np.random.default_rng(81), 3
    rows = _rand(F, rng, (B, 5, 2, 4))
    r = rows[:, 2, 1, 3]                  # [B, N], lanes 40 elements apart
    x = _rand(F, rng, (B, 16))
    got = F.bind(x, r)
    assert got.shape == (B, 8) + F.elt_shape
    _eq(got, torch.stack([F.bind(x[b], r[b]) for b in range(B)]))
    hv = _rand(F, rng, (B, 40))
    h = torch.as_tensor(rng.integers(0, 16, 40, dtype=np.int32))
    _eq(F.hv_update(hv, h, r),
        torch.stack([F.hv_update(hv[b], h, r[b]) for b in range(B)]))
    Wh, Wo = _rand(F, rng, (B, 16)), _rand(F, rng, (B, 32))
    ho = torch.as_tensor(rng.integers(0, 32, 40, dtype=np.int32))
    _eq(fpm.fp_wire_sums(F, hv, Wh, Wo, h, ho),
        torch.stack([fpm.fp_wire_sums(F, hv[b], Wh[b], Wo[b], h, ho)
                     for b in range(B)]))


def _fs_lanes(labels):
    """[B, 104] states of fresh transcripts with these labels."""
    return torch.stack([dfs.fs_init_from_host(Transcript(lb), "cpu")
                        for lb in labels])


@pytest.mark.parametrize("mk", [fp128, gf2_128], ids=["fp128", "gf2_128"])
def test_lane_fs_oracle_and_choose(mk):
    """K9 over lanes (lane 1 of Fp128 rejects its first draw,
    REJECT_LABEL): absorbs shared and per lane, writes, samples after a
    squeeze, PRF bytes, the key and mode 9's column choice, each state and
    output against one call a lane."""
    F, rng = mk(), np.random.default_rng(82)
    labels = [b"lane-a", REJECT_LABEL, b"lane-c"]
    B = len(labels)
    fs, prf = _fs_lanes(labels), dfs.new_prf("cpu", B)
    one = [(fs[b].clone(), dfs.new_prf("cpu")) for b in range(B)]
    got = dfs.dev_sample_elts(F, prf, 5, fs=fs)
    want = torch.stack([dfs.dev_sample_elts(F, p, 5, fs=f) for f, p in one])
    _eq(got, want)
    if not F.kCharacteristicTwo:
        # the rejecting lane drew one block more than the others
        nb = [int.from_bytes(bytes(p[256:264].tolist()), "little")
              for p in prf]
        assert nb[1] > nb[0]
    shared = torch.as_tensor(rng.integers(0, 256, 70, dtype=np.uint8))
    per = torch.as_tensor(rng.integers(0, 256, (B, 9), dtype=np.uint8))
    xs = _rand(F, rng, (B, 3))
    dfs.fs_absorb(F, fs, shared)
    dfs.fs_absorb(F, fs, per)
    dfs.fs_write_elts(F, fs, xs)
    dfs.write_tagged_elts(F, fs, xs)
    for b, (f, p) in enumerate(one):
        dfs.fs_absorb(F, f, shared)
        dfs.fs_absorb(F, f, per[b])
        dfs.fs_write_elts(F, f, xs[b])
        dfs.write_tagged_elts(F, f, xs[b])
    _eq(fs, torch.stack([f for f, _ in one]))
    _eq(dfs.fs_getkey(F, fs), torch.stack([dfs.fs_getkey(F, f)
                                           for f, _ in one]))
    dfs.fs_squeeze(F, fs, prf)
    _eq(dfs.prf_bytes(F, prf, 21), torch.stack(
        [(dfs.fs_squeeze(F, f, p), dfs.prf_bytes(F, p, 21))[1]
         for f, p in one]))
    _eq(prf, torch.stack([p for _, p in one]))
    _eq(dfs.dev_choose(F, fs, prf, 300, 40), torch.stack(
        [dfs.dev_choose(F, f, p, 300, 40) for f, p in one]))
    _eq(prf, torch.stack([p for _, p in one]))


def test_lane_round_tail():
    """K10 over lanes, rows and pads as strided views of per-layer
    tensors, eq0 and the constants shared, against one call a lane."""
    F, rng, B = fp128(), np.random.default_rng(83), 3
    consts = fpm.round_consts(F, "cpu")
    fs = _fs_lanes([b"rt0", REJECT_LABEL, b"rt2"])
    claim, a, eq0 = _rand(F, rng, (B,)), _rand(F, rng, (B, 2)), \
        _rand(F, rng, (1,))[0]
    rows = torch.zeros((B, 3, 2, 4) + F.elt_shape, dtype=torch.int32)
    pads = _rand(F, rng, (B, 3, 2, 3))
    one = [(fs[b].clone(), claim[b].clone()) for b in range(B)]
    dfs.round_tail(F, fs, claim, rows[:, 1, 0], a, eq0, pads[:, 1, 0],
                   consts)
    for b, (f, c) in enumerate(one):
        row = torch.empty((4,) + F.elt_shape, dtype=torch.int32)
        dfs.round_tail(F, f, c, row, a[b], eq0, pads[b, 1, 0], consts)
        _eq(rows[b, 1, 0], row)
        _eq(claim[b], c)
        _eq(fs[b], f)
    assert not rows[:, 0].any() and not rows[:, 2].any()


@pytest.mark.parametrize("mk", [fp128, gf2_128], ids=["fp128", "gf2_128"])
def test_lane_constraints_and_inner_product(mk):
    """K11 and K12 with a lane axis against one call a lane, at the toy
    Fp128 proof's geometry."""
    F, rng, B = mk(), np.random.default_rng(84), 3
    _, _, _, circ, _, _, _ = _toy("fp128")
    pr = ZkProver(circ, F, None, rate=TOY_RATE, nreq=TOY_NREQ,
                  block_enc=TOY_BLOCK_ENC, device="cpu")
    stat = fused.fused_static(circ, pr.param, pr.lqc, pr.n_witness)
    tabs = fused.prepare(F, stat, "cpu")
    R, nl, p = int(stat.lay[:, 0].sum()), circ.nl, stat.p
    rows = _rand(F, rng, (B, R, 2, 4))
    scal, wcpad = _rand(F, rng, (B, nl, 4)), _rand(F, rng, (B, nl, 2))
    _eq(fused.zk_constraints(F, tabs, rows, scal, wcpad), torch.stack(
        [fused.zk_constraints(F, tabs, rows[b], scal[b], wcpad[b])
         for b in range(B)]))
    k = _rand(F, rng, (B, len(stat.ws)))
    al, aq = _rand(F, rng, (B, stat.nl_constraints)), \
        _rand(F, rng, (B, 3 * p.nq))
    _eq(fused.ligero_inner_product(F, tabs, k, al, aq), torch.stack(
        [fused.ligero_inner_product(F, tabs, k[b], al[b], aq[b])
         for b in range(B)]))


# ----------------------------------------------------------------------
# (g) the JAX package's BatchZkProver
# ----------------------------------------------------------------------

@pytest.mark.slow
def test_batch_equals_jax_batch_prover():
    """The JAX package's BatchZkProver.prove_batch on the toy circuit of
    tests/test_zk_batch.py (B = 3, rate 4, nreq 8) against the port's,
    byte for byte."""
    from longfellow_zk_tpu.fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER, fp128 as jax_fp128)
    from longfellow_zk_tpu.random_oracle.engine import (
        DeterministicEngine as JaxEngine)
    from longfellow_zk_tpu.random_oracle.transcript import (
        Transcript as JaxTranscript)
    from longfellow_zk_tpu.zk.batch import BatchZkProver as JaxBatch
    from longfellow_zk_tpu.zk.testing import K_VERSION
    from longfellow_zk_tpu.zk.testing import rs_factory_for as jax_rs
    from longfellow_zk_tpu_torch.zk.testing import rs_factory_for
    from test_torch_sumcheck import port_circuit
    from test_zk_batch import RATE, NREQ, B, _circuit

    J, F = jax_fp128(), fp128()
    jc = _circuit(J)
    rng = random.Random(17)
    Ws = []
    for _ in range(B):
        a, b = rng.randrange(J.p), rng.randrange(J.p)
        Ws.append([1, J.neg_i(J.mul_i(J.mul_i(a, b), a)), a, b])
    want = JaxBatch(jc, J, jax_rs(J, omega=P128_OMEGA,
                                  omega_order=P128_OMEGA_ORDER),
                    rate=RATE, nreq=NREQ).prove_batch(
        Ws, [JaxTranscript(b"batch%d" % i, version=K_VERSION)
             for i in range(B)], JaxEngine())
    bp = BatchZkProver(port_circuit(jc), F,
                       rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER,
                                      device="cpu"),
                       rate=RATE, nreq=NREQ, device="cpu")
    got = bp.prove_batch(Ws, [Transcript(b"batch%d" % i, version=K_VERSION)
                              for i in range(B)], DeterministicEngine())
    assert got == want
