"""The port's half-complex RFFT (transforms/rfft.py, plain K18 version,
CPU) against the JAX package's transforms/rfft.py on the same inputs,
made from a numpy seed: r2hc, hc2r and hc_mul, RFFTExtConvolution against
the JAX one and the port's full Fp2 lift (FFTExtConvolution), and the toy
P-256 proof through the RFFT route against its golden bytes.  Exact:
tolerance 0.  The JAX side runs eagerly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields.fp2 import Fp2 as JaxFp2
from longfellow_zk_tpu.fields.fp_instances import p256_base as jax_p256
from longfellow_zk_tpu.transforms.rfft import (
    RFFT as JaxRFFT, RFFTExtConvolution as JaxRFFTExtConvolution)
from longfellow_zk_tpu_torch.fields.bridge import limbs_to_jax
from longfellow_zk_tpu_torch.fields.fp2 import Fp2
from longfellow_zk_tpu_torch.fields.fp_instances import (
    P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X, P256_FP2_ROOT_Y, p256_base)
from longfellow_zk_tpu_torch.random_oracle.engine import DeterministicEngine
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.transforms.ntt import FFTExtConvolution
from longfellow_zk_tpu_torch.transforms.rfft import (
    RFFT, RFFTExtConvolution, make_rfft_ext_convolution_factory)
from longfellow_zk_tpu_torch.zk.proof import ZkProof
from longfellow_zk_tpu_torch.zk.prover import ZkProver
from longfellow_zk_tpu_torch.zk.serialization import (
    read_zk_proof, write_zk_proof)
from longfellow_zk_tpu_torch.zk.testing import rs_factory_with
from longfellow_zk_tpu_torch.zk.verifier import ZkVerifier

from test_torch_fp256 import _port_toy_circuit
from test_torch_golden import (
    TOY_BLOCK_ENC, TOY_LABEL, TOY_NREQ, TOY_P256_BIN, TOY_RATE, toy_inputs)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OMEGA2 = (P256_FP2_ROOT_X, P256_FP2_ROOT_Y)


def _rows(shape, seed):
    """(JAX u32[16, *shape], port int32[*shape, 8]) of the same random
    P-256 base-field elements (0, 1 and p - 1 first)."""
    F = p256_base()
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = ([0, 1, F.p - 1] + [int.from_bytes(rng.bytes(32), "little") % F.p
                               for _ in range(n)])[:n]
    px = F.to_limbs(vals, "cpu").reshape(tuple(shape) + (8,))
    return jnp.asarray(limbs_to_jax(px)), px


def _same(port, jax_arr):
    assert np.array_equal(limbs_to_jax(port), np.asarray(jax_arr))


@pytest.mark.parametrize("n", [2, 4, 8, 32])
def test_r2hc_hc2r_hc_mul_match_jax(n):
    jr = JaxRFFT(JaxFp2(jax_p256()), OMEGA2, P256_FP2_ROOT_ORDER)
    pr = RFFT(Fp2(p256_base()), OMEGA2, P256_FP2_ROOT_ORDER, "cpu")
    jx, px = _rows((3, n), n)
    jy, py = _rows((3, n), 50 + n)
    jhc, phc = jr.r2hc(jx), pr.r2hc(px)
    _same(phc, jhc)
    _same(pr.hc2r(py), jr.hc2r(jy))
    _same(pr.hc_mul(phc, py), jr.hc_mul(jhc, jy))
    # one row of b broadcast over a's rows, as the convolution's spectrum
    assert torch.equal(pr.hc_mul(phc, py[0]),
                       pr.hc_mul(phc, py[:1].expand_as(py)))


@pytest.mark.parametrize("n,m,jax", [(6, 20, True), (40, 150, False)])
def test_rfft_convolution_matches_jax_and_full_lift(n, m, jax):
    """Against the JAX RFFTExtConvolution at (6, 20) (its eager ops
    compile for about 40 s at the larger size) and against the port's
    full Fp2 lift at both."""
    Fb, F2 = p256_base(), Fp2(p256_base())
    rng = np.random.default_rng(m)
    ys = [int.from_bytes(rng.bytes(32), "little") % Fb.p for _ in range(m)]
    jx, px = _rows((2, n), n + m)
    got = RFFTExtConvolution(n, m, Fb, F2, OMEGA2, P256_FP2_ROOT_ORDER, ys,
                             "cpu").convolution(px)
    if jax:
        _same(got, JaxRFFTExtConvolution(
            n, m, jax_p256(), JaxFp2(jax_p256()), OMEGA2,
            P256_FP2_ROOT_ORDER, ys).convolution(jx))
    full = FFTExtConvolution(n, m, Fb, F2, OMEGA2, P256_FP2_ROOT_ORDER, ys,
                             "cpu").convolution(px)
    assert torch.equal(got, full)


def test_toy_p256_proof_through_rfft_equals_golden():
    """The toy P-256 proof with the Reed-Solomon code through the
    half-complex RFFT equals the JAX package's golden bytes (made with
    the full Fp2 lift); the port's verifier with the same factory accepts
    it and refuses a copy with one bit flipped."""
    F = p256_base()
    _, circ = _port_toy_circuit()
    W = toy_inputs(F.p, 32)
    rs = rs_factory_with(F, make_rfft_ext_convolution_factory(
        F, Fp2(F), OMEGA2, P256_FP2_ROOT_ORDER, "cpu"), "cpu")
    zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
    prover = ZkProver(circ, F, rs, rate=TOY_RATE, nreq=TOY_NREQ,
                      block_enc=TOY_BLOCK_ENC, device="cpu")
    ts = Transcript(TOY_LABEL)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    data = write_zk_proof(zkp, circ, prover.param, F)
    with open(TOY_P256_BIN, "rb") as f:
        assert data == f.read()

    def verify(data):
        v = ZkVerifier(circ, F, rs, rate=TOY_RATE, nreq=TOY_NREQ,
                       block_enc=TOY_BLOCK_ENC, device="cpu")
        zkp = read_zk_proof(data, circ, v.param, F, rate=TOY_RATE,
                            nreq=TOY_NREQ)
        ts = Transcript(TOY_LABEL)
        v.recv_commitment(zkp, ts)
        return v.verify(zkp, W[: circ.npub_in], ts)

    assert verify(data) == (True, "ok")
    bad = bytearray(data)
    bad[len(data) // 2] ^= 0x04
    assert verify(bytes(bad))[0] is False
