"""What each rank of tests/test_torch_parallel.py runs (parallel/launch.spawn
on the CPU, gloo).  This module imports torch, numpy and the port only:
the ranks are fresh processes that import it, and the JAX package stays
in the test's own process, which builds the inputs (circuits, witnesses,
field elements as host ints) and compares what the ranks return.
"""

import time

import numpy as np
import torch

from longfellow_zk_tpu_torch.fields.fp2 import Fp2
from longfellow_zk_tpu_torch.fields.fp_instances import (
    P128_OMEGA, P128_OMEGA_ORDER, P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X,
    P256_FP2_ROOT_Y, fp128, p256_base)
from longfellow_zk_tpu_torch.parallel.mesh import make_mesh
from longfellow_zk_tpu_torch.parallel.ntt_sharded import ShardedNTT
from longfellow_zk_tpu_torch.parallel.sumcheck_sharded import (
    copy_round_coeffs, sharded_copy_round_coeffs)
from longfellow_zk_tpu_torch.random_oracle.engine import DeterministicEngine
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.sumcheck.prover import SumcheckProver
from longfellow_zk_tpu_torch.sumcheck.transcript_sumcheck import (
    TranscriptSumcheck)
from longfellow_zk_tpu_torch.transforms.matmul_ntt import MatmulNTT
from longfellow_zk_tpu_torch.zk.batch import BatchZkProver
from longfellow_zk_tpu_torch.zk.proof import ZkProof
from longfellow_zk_tpu_torch.zk.prover import ZkProver
from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof
from longfellow_zk_tpu_torch.zk.testing import rs_factory_for

CPU = "cpu"


def field_and_rs(name):
    """The port's field and CPU Reed-Solomon factory of a toy proof."""
    if name == "fp128":
        F = fp128()
        return F, rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER, device=CPU)
    F = p256_base()
    return F, rs_factory_for(F, F2=Fp2(F),
                             omega2=(P256_FP2_ROOT_X, P256_FP2_ROOT_Y),
                             omega_order=P256_FP2_ROOT_ORDER, device=CPU)


def listing(F, proof, aux, bindings, ts):
    """A plain sumcheck proof as canonical hex, the layout of
    testdata/sumcheck_copies_toy.json (tests/test_torch_copies.py)."""
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


def sumcheck_listing(case, mesh):
    """The plain sumcheck's proof of a circuit with copies, as a listing
    (mesh None: one card)."""
    circ, W_host, label, pad = case
    F = fp128()
    ts = Transcript(label)
    tss = TranscriptSumcheck(ts, F)
    tss.write_input(W_host)
    W0 = F.to_limbs([w for W in W_host for w in W], CPU).reshape(
        (circ.nc, circ.ninputs) + F.elt_shape)
    proof, aux, b = SumcheckProver(F, CPU, mesh).prove_with_witness(
        circ, W0, tss, pad=pad)
    return listing(F, proof, aux, b, ts)


def zk_proof(field, circ, W, label, rng, mesh, rate, nreq, block_enc):
    """One ZkProver proof: (bytes, final transcript state)."""
    F, rs = field_and_rs(field)
    zkp = ZkProof(rate=rate, nreq=nreq)
    prover = ZkProver(circ, F, rs, rate=rate, nreq=nreq, block_enc=block_enc,
                      device=CPU if mesh is None else None, mesh=mesh)
    ts = Transcript(label)
    prover.commit(zkp, W, ts, rng)
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F), ts.export_state()


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 -- the test reads the message
        return "%s: %s" % (type(e).__name__, e)
    return None


def world4(inp):
    """Every case of the four-rank world; returns this rank's results."""
    t0 = time.perf_counter()
    rank = torch.distributed.get_rank()
    out = {"rank": rank}
    m41 = make_mesh(4, 1, device=CPU)
    m14 = make_mesh(1, 4, device=CPU)
    m22 = make_mesh(2, 2, device=CPU)
    F = fp128()

    # ShardedNTT against the one-card MatmulNTT, both directions
    for n, radix, vals in inp["ntt"]:
        x = F.to_limbs(vals, CPU)
        snt = ShardedNTT(F, P128_OMEGA, P128_OMEGA_ORDER, m41, radix=radix)
        mnt = MatmulNTT(F, P128_OMEGA, P128_OMEGA_ORDER, radix=radix,
                        device=CPU)
        sent = m41.sent_bytes
        yl = snt.fftb(snt.shard_input(x))
        out["ntt%d" % n] = dict(
            sent=m41.sent_bytes - sent, local=yl,
            fftb=snt.gather_output(yl), one_card_fftb=mnt.fftb(x),
            fftf=snt.gather_output(snt.fftf(snt.shard_input(x))),
            one_card_fftf=mnt.fftf(x))

    # the copy-round coefficients, the copies over the first axis
    c = inp["copy"]
    EQ = F.to_limbs(c["EQ"], CPU)
    W = F.to_limbs(c["W"], CPU).reshape(c["nw"], c["C"], F.nlimb)
    hv = F.to_limbs(c["hv"], CPU)
    h0 = torch.tensor(c["h0"], dtype=torch.int32)
    h1 = torch.tensor(c["h1"], dtype=torch.int32)
    out["copy_one_card"] = copy_round_coeffs(F, EQ, W, hv, h0, h1)
    for key, m in (("copy41", m41), ("copy22", m22)):
        out[key] = sharded_copy_round_coeffs(
            F, m, m.shard(EQ), m.shard(W, dim=1).contiguous(), hv, h0, h1)

    # the plain sumcheck with the copy axis sharded (or not: nc 3)
    for name, case in inp["sumcheck"].items():
        meshes = (("m14", m14), ("m22", m22))
        if name not in inp["listings"]:
            meshes += (("one_card", None),)
        out["sc_" + name] = {key: sumcheck_listing(case, m)
                             for key, m in meshes}

    # ZkProver with the tableau rows over (4, 1); the Fp128 proof's
    # one-card twin (its transcript state)
    z = inp["zk_args"]
    for field, (circ, W, golden) in inp["zk"].items():
        meshes = (("m41", m41),) + ((("one_card", None),)
                                    if field == "fp128" else ())
        out["zk_" + field] = {
            key: zk_proof(field, circ, W, z["label"], DeterministicEngine(),
                          m, z["rate"], z["nreq"], z["block_enc"])
            for key, m in meshes}
    # an engine with a stream of its own on each rank: rank 0's decides
    circ, W, _ = inp["zk"]["fp128"]
    own = DeterministicEngine() if rank == 0 else \
        DeterministicEngine(b"rank%d" % rank)
    out["zk_own_streams"] = zk_proof("fp128", circ, W, z["label"], own, m41,
                                     z["rate"], z["nreq"], z["block_enc"])

    # BatchZkProver, the 4 lanes over (4, 1), and the scalar proof of
    # lane `rank` (the one stream continued past lanes 0 .. rank - 1)
    b = inp["batch"]
    F, rs = field_and_rs("fp128")
    tss = [Transcript(t) for t in b["tags"]]
    bp = BatchZkProver(b["circ"], F, rs, z["rate"], z["nreq"],
                       block_enc=z["block_enc"], mesh=m41)
    out["batch"] = (bp.prove_batch(b["Ws"], tss, DeterministicEngine()),
                    [ts.export_state() for ts in tss])
    eng = DeterministicEngine()
    ZkProver(b["circ"], F, rs, z["rate"], z["nreq"], z["block_enc"],
             device=CPU).draw_lanes(b["Ws"][:rank], eng)
    zkp = ZkProof(rate=z["rate"], nreq=z["nreq"])
    pr = ZkProver(b["circ"], F, rs, z["rate"], z["nreq"], z["block_enc"],
                  device=CPU)
    ts = Transcript(b["tags"][rank])
    pr.commit(zkp, b["Ws"][rank], ts, eng)
    assert pr.prove(zkp, b["Ws"][rank], ts)
    out["batch_scalar"] = (write_zk_proof(zkp, b["circ"], pr.param, F),
                           ts.export_state())

    # the error paths
    out["err_world"] = _raises(lambda: make_mesh(3, 1, device=CPU))
    out["err_lanes"] = _raises(lambda: bp.prove_batch(
        b["Ws"][:3], [Transcript(t) for t in b["tags"][:3]],
        DeterministicEngine()))
    out["err_cuda"] = None if torch.cuda.is_available() else \
        _raises(lambda: make_mesh(4, 1))
    out["seconds"] = time.perf_counter() - t0
    return out


def world2(inp):
    """The plain sumcheck's copies over a world of 2 ranks."""
    m12 = make_mesh(1, 2, device=CPU)
    return {name: sumcheck_listing(case, m12)
            for name, case in inp["sumcheck"].items()}


def raise_on_rank1():
    """Rank 1 raises while rank 0 waits for it in a collective."""
    mesh = make_mesh(2, 1, device=CPU)
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.all_true(True)
    return np.zeros(1)
