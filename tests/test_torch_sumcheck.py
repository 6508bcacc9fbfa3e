"""The port's sumcheck prover (plain kernel versions, CPU) against the JAX
package's on the same circuits and witnesses: the proof, bound_quad, the
bindings and the next transcript element must be equal (exact).

The default run's reference is the JAX host-round prover (sumcheck/prover.py),
which the JAX package's own tests hold byte-identical to its device
prover (tests/test_prover_device.py); the device prover compiles for
about a minute per circuit on a CPU, so the comparison against
DeviceSumcheckProver.prove_with_witness itself, with term merging on both
sides, is a slow test.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.proto.lfc1 import FP128_ID
from longfellow_zk_tpu.proto.lfc1 import read_circuit as jax_read_circuit
from longfellow_zk_tpu.random_oracle.transcript import (
    Transcript as JaxTranscript)
from longfellow_zk_tpu.sumcheck.prover import SumcheckProver as JaxProver
from longfellow_zk_tpu.sumcheck.prover_device import DeviceSumcheckProver
from longfellow_zk_tpu.sumcheck.transcript_sumcheck import (
    TranscriptSumcheck as JaxTS)
from longfellow_zk_tpu_torch.fields.bridge import (
    circuit_from_arrays, limbs_from_jax, limbs_to_jax)
from longfellow_zk_tpu_torch.fields.fp import fp_eval_layer
from longfellow_zk_tpu_torch.fields.fp_instances import fp128
from longfellow_zk_tpu_torch.proto.lfc1 import read_circuit
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.sumcheck.circuit import LayerProof, Proof
from longfellow_zk_tpu_torch.sumcheck.prover import (
    SumcheckProver, quad_tensors)
from longfellow_zk_tpu_torch.sumcheck.transcript_sumcheck import (
    TranscriptSumcheck)

from test_lfc1 import SGONAL_HEX
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


def port_circuit(jc):
    """The port's copy of a JAX-package circuit, built through the bridge
    from numpy arrays."""
    J = jax_fp128()
    layers = [dict(nw=l.nw, logw=l.logw, g=l.quad.g, h0=l.quad.h0,
                   h1=l.quad.h1, v=J.to_limbs(list(l.quad.v)))
              for l in jc.layers]
    return circuit_from_arrays(fp128(), jc.nv, jc.nc, jc.ninputs, jc.npub_in,
                               layers, jc.subfield_boundary, jc.id)


def _witness(seed):
    """[a, b, a * b, 1] from a numpy seed (the mul-check circuit's inputs)."""
    p = fp128().p
    rng = np.random.default_rng(seed)
    a, b = (int.from_bytes(rng.bytes(16), "little") % p for _ in range(2))
    return [a, b, a * b % p, 1]


def _pad(circ, seed):
    """A random pad in the layout of ZkProver._fill_pad (p(1) slots 0)."""
    p = fp128().p
    rng = np.random.default_rng(seed)

    def rnd():
        return int.from_bytes(rng.bytes(16), "little") % p

    pad = Proof()
    for layer in circ.layers:
        lp = LayerProof(cp=[], hp=[[], []], wc=[rnd(), rnd()])
        for _ in range(layer.logw):
            for h in range(2):
                lp.hp[h].append([rnd(), 0, rnd()])
        pad.layers.append(lp)
    return pad


def _jax_prove(jc, W, label, pad=None, device=False):
    J = jax_fp128()
    W0 = jnp.asarray(J.to_limbs(W)).reshape(8, len(W), 1)
    ts = JaxTranscript(label)
    tss = JaxTS(ts, J)
    tss.write_input([W])
    if device:
        out = DeviceSumcheckProver(J).prove_with_witness(
            jc, W0, tss, pad=pad, with_aux=True)
    else:
        prover = JaxProver(J)
        inputs, _ = prover.eval_circuit(jc, W0)
        out = prover.prove(jc, inputs, tss, pad=pad, with_aux=True)
    return out, ts


def _port_prove(pc, W, label, pad=None, merge_min=None):
    F = fp128()
    ts = Transcript(label)
    tss = TranscriptSumcheck(ts, F)
    tss.write_input([W])
    prover = SumcheckProver(F, device="cpu")
    if merge_min is not None:
        prover.K_MERGE_MIN_TERMS = merge_min
    out = prover.prove_with_witness(pc, F.to_limbs(W, "cpu"), tss, pad=pad)
    return out, ts


def _same(jax_out, port_out):
    (p1, aux1, b1), ts1 = jax_out
    (p2, aux2, b2), ts2 = port_out
    assert p2 is not None
    assert len(p1.layers) == len(p2.layers)
    for l1, l2 in zip(p1.layers, p2.layers):
        assert l1.hp == l2.hp
        assert l1.wc == l2.wc
    assert aux1.bound_quad == aux2.bound_quad
    assert [list(x) for x in b1["g"]] == [list(x) for x in b2["g"]]
    assert b1["logv"] == b2["logv"]
    F = fp128()
    assert ts1.elt(jax_fp128()) == ts2.elt(F)


@pytest.mark.parametrize("with_pad", [False, True])
def test_mul_check_matches_jax(with_pad):
    jc = _mul_check_circuit(jax_fp128(), 1)
    pc = port_circuit(jc)
    W = _witness(1)
    pad = _pad(pc, 2) if with_pad else None
    _same(_jax_prove(jc, W, b"sc", pad), _port_prove(pc, W, b"sc", pad))


def test_mul_check_term_merging_matches_jax():
    """K_MERGE_MIN_TERMS = 0 merges the terms of every layer."""
    jc = _mul_check_circuit(jax_fp128(), 1)
    pc = port_circuit(jc)
    W = _witness(3)
    pad = _pad(pc, 4)
    _same(_jax_prove(jc, W, b"wm", pad),
          _port_prove(pc, W, b"wm", pad, merge_min=0))


def _sgonal_witness(pc):
    """The wire order of (12, 3, 5, 1) that satisfies the s-gonal circuit
    (found with the port's evaluation)."""
    F = fp128()
    sp = SumcheckProver(F, device="cpu")
    for perm in itertools.permutations([12, 3, 5, 1]):
        inputs, V = sp.eval_circuit(pc, F.to_limbs(list(perm), "cpu"))
        if V is not None and not V.any():
            return list(perm)
    raise AssertionError("no satisfying wire order")


def test_sgonal_lfc1_matches_jax():
    J, F = jax_fp128(), fp128()
    data = bytes.fromhex(SGONAL_HEX)
    jc = jax_read_circuit(J, FP128_ID, data)
    pc = read_circuit(F, FP128_ID, data)
    W = _sgonal_witness(pc)
    pad = _pad(pc, 5)
    _same(_jax_prove(jc, W, b"sg", pad),
          _port_prove(pc, W, b"sg", pad, merge_min=0))


def test_eval_layer_matches_jax():
    """K2's evaluation mode against DeviceSumcheckProver._eval_layer."""
    J, F = jax_fp128(), fp128()
    jc = _mul_check_circuit(J, 1)
    W = _witness(6)
    dp = DeviceSumcheckProver(J)
    qd = dp._quad_dev_eval(jc.layers[1].quad, jc.layers[0].nw)
    W0 = jnp.asarray(J.to_limbs(W)).reshape(8, 4, 1)
    V_j, ok_j = dp._eval_layer(qd, W0, jc.layers[0].nw)
    pc = port_circuit(jc)
    sp = SumcheckProver(F, device="cpu")
    pq = quad_tensors(F, pc.layers[1].quad, sp.device)
    s, e = sp._segments(pc.layers[1].quad, pc.layers[0].nw)
    V_p, ok_p = fp_eval_layer(F, limbs_from_jax(np.asarray(W0)[:, :, 0]),
                              pq["h0"], pq["h1"], pq["v"], pq["bmask"], s, e)
    assert np.array_equal(limbs_to_jax(V_p), np.asarray(V_j)[:, :, 0])
    assert bool(ok_p) == bool(ok_j)


def test_unsatisfied_witness_leaves_transcript_untouched():
    F = fp128()
    pc = port_circuit(_mul_check_circuit(jax_fp128(), 1))
    W = _witness(7)
    W[2] = (W[2] + 1) % F.p
    ts = Transcript(b"bad")
    before = ts.clone().elt(F)
    out = SumcheckProver(F, device="cpu").prove_with_witness(
        pc, F.to_limbs(W, "cpu"), TranscriptSumcheck(ts, F))
    assert out == (None, None, None)
    assert ts.elt(F) == before


def test_copy_rounds_not_ported():
    """Copy rounds are not ported to the lane axis: lanes and copies are
    never both above 1 (the batch prover is ZK-only and ZK refuses
    copies), so the rounds of a circuit with copies refuse a second lane
    (tests/test_torch_copies.py holds the copy rounds of one proof)."""
    pc = port_circuit(_mul_check_circuit(jax_fp128(), 2))
    fs = torch.zeros((2, 104), dtype=torch.uint8)
    with pytest.raises(ValueError, match="one proof at a time"):
        SumcheckProver(fp128(), device="cpu")._rounds(
            pc, [None] * pc.nl, fs, None, None)


@pytest.mark.slow
@pytest.mark.parametrize("circuit,with_pad,merge_min", [
    ("mul_check", False, 4096), ("mul_check", True, 4096),
    ("mul_check", True, 0), ("sgonal", False, 0), ("sgonal", True, 4096)])
def test_matches_jax_device_prover(circuit, with_pad, merge_min,
                                   monkeypatch):
    """Against DeviceSumcheckProver.prove_with_witness, with the same
    term-merge threshold on both sides."""
    monkeypatch.setattr(DeviceSumcheckProver, "K_MERGE_MIN_TERMS", merge_min)
    J, F = jax_fp128(), fp128()
    if circuit == "mul_check":
        jc = _mul_check_circuit(J, 1)
        pc = port_circuit(jc)
        W = _witness(8)
    else:
        data = bytes.fromhex(SGONAL_HEX)
        jc = jax_read_circuit(J, FP128_ID, data)
        pc = read_circuit(F, FP128_ID, data)
        W = _sgonal_witness(pc)
    pad = _pad(pc, 9) if with_pad else None
    _same(_jax_prove(jc, W, b"dev", pad, device=True),
          _port_prove(pc, W, b"dev", pad, merge_min=merge_min))
