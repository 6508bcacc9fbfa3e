"""The port's ZkProver (plain kernel versions, CPU) against the JAX
package's on the two-layer toy circuit of tests/test_zk.py, under
DeterministicEngine: the write_zk_proof bytes must be equal, and the JAX
ZkVerifier must accept the port's proof.

The JAX prover compiles for minutes on a CPU even at this size, so its
proof bytes for the inputs of test_torch_golden.toy_inputs are kept in
longfellow_zk_tpu_torch/testdata/zk_toy_fp128.proof.bin (made by
tests/test_torch_golden.py); the live comparison is a slow test.
"""

import pytest
import torch

from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.random_oracle.transcript import (
    Transcript as JaxTranscript)
from longfellow_zk_tpu.zk.serialization import read_zk_proof
from longfellow_zk_tpu.zk.testing import rs_factory_for as jax_rs_factory
from longfellow_zk_tpu.zk.verifier import ZkVerifier
from longfellow_zk_tpu_torch.fields.fp_instances import (
    P128_OMEGA, P128_OMEGA_ORDER, fp128)
from longfellow_zk_tpu_torch.random_oracle.engine import DeterministicEngine
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.zk.proof import ZkProof
from longfellow_zk_tpu_torch.zk.prover import ZkProver
from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof
from longfellow_zk_tpu_torch.zk.testing import rs_factory_for

from test_torch_golden import (
    TOY_BIN, TOY_BLOCK_ENC, TOY_LABEL, TOY_NREQ, TOY_RATE, jax_toy_proof,
    toy_inputs)
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


def _port_toy_proof(W=None):
    F = fp128()
    circ = port_circuit(_zk_circuit(jax_fp128()))
    W = toy_inputs(F.p) if W is None else W
    zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
    prover = ZkProver(circ, F, rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER,
                                              device="cpu"),
                      rate=TOY_RATE, nreq=TOY_NREQ, block_enc=TOY_BLOCK_ENC,
                      device="cpu")
    ts = Transcript(TOY_LABEL)
    prover.commit(zkp, W, ts, DeterministicEngine())
    if not prover.prove(zkp, W, ts):
        return None
    return write_zk_proof(zkp, circ, prover.param, F)


@pytest.fixture(scope="module")
def toy_proof():
    """The port's toy proof, made once for the module's tests."""
    return _port_toy_proof()


def test_toy_proof_bytes_equal_jax(toy_proof):
    with open(TOY_BIN, "rb") as f:
        assert toy_proof == f.read()


def test_jax_verifier_accepts_port_proof(toy_proof):
    J = jax_fp128()
    jc = _zk_circuit(J)
    W = toy_inputs(J.p)
    factory = jax_rs_factory(J, P128_OMEGA, P128_OMEGA_ORDER)
    verifier = ZkVerifier(jc, J, factory, rate=TOY_RATE, nreq=TOY_NREQ,
                          block_enc=TOY_BLOCK_ENC)
    zkp = read_zk_proof(toy_proof, jc, verifier.param, J,
                        rate=TOY_RATE, nreq=TOY_NREQ)
    assert zkp is not None
    ts = JaxTranscript(TOY_LABEL)
    verifier.recv_commitment(zkp, ts)
    ok, why = verifier.verify(zkp, W[:2], ts)
    assert ok, why


def test_unsatisfied_witness_is_refused():
    W = toy_inputs(fp128().p)
    W[0] = (W[0] + 1) % fp128().p
    assert _port_toy_proof(W) is None


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    F = fp128()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER)
    circ = port_circuit(_zk_circuit(jax_fp128()))
    factory = rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ZkProver(circ, F, factory, rate=TOY_RATE, nreq=TOY_NREQ)


@pytest.mark.slow
def test_toy_proof_bytes_equal_live_jax(toy_proof):
    assert toy_proof == jax_toy_proof()[0]
