"""The port's Nussbaumer convolution (transforms/nussbaumer.py, plain K19
and K20 versions, CPU) against the JAX package's transforms/nussbaumer.py
on the same inputs, made from a numpy seed: negacyclic, cyclic and
linear over Fp128 and secp256k1, one butterfly level (K19) against
_apply_rot and the JAX butterflies, the base case (K20) against
_base_conv, the Reed-Solomon code over secp256k1 against Lagrange and the
JAX one, and the toy secp256k1 proof through the Nussbaumer route
against its golden bytes.  Exact: tolerance 0.  The JAX side runs
eagerly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.fields.fp_instances import p256k1_base as jax_p256k1
from longfellow_zk_tpu.transforms import nussbaumer as jnb
from longfellow_zk_tpu.transforms.ntt import ReedSolomon as JaxReedSolomon
from longfellow_zk_tpu_torch.fields.bridge import limbs_to_jax
from longfellow_zk_tpu_torch.fields.fp_instances import fp128, p256k1_base
from longfellow_zk_tpu_torch.random_oracle.engine import DeterministicEngine
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.transforms import nussbaumer as nb
from longfellow_zk_tpu_torch.zk.proof import ZkProof
from longfellow_zk_tpu_torch.zk.prover import ZkProver
from longfellow_zk_tpu_torch.zk.serialization import (
    read_zk_proof, write_zk_proof)
from longfellow_zk_tpu_torch.zk.testing import rs_factory_with
from longfellow_zk_tpu_torch.zk.verifier import ZkVerifier

from test_torch_bitaddr import _toy
from test_torch_golden import (
    TOY_BLOCK_ENC, TOY_LABEL, TOY_NREQ, TOY_P256K1_BIN, TOY_RATE)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = {"fp128": (jax_fp128, fp128), "p256k1": (jax_p256k1, p256k1_base)}


def _rows(F, shape, seed):
    """(JAX u32[2N, *shape], port int32[*shape, N]) of the same random
    elements (0, 1 and p - 1 first)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = ([0, 1, F.p - 1] + [int.from_bytes(rng.bytes(32), "little") % F.p
                               for _ in range(n)])[:n]
    px = F.to_limbs(vals, "cpu").reshape(tuple(shape) + (F.nlimb,))
    return jnp.asarray(limbs_to_jax(px)), px


def _same(port, jax_arr):
    assert np.array_equal(limbs_to_jax(port), np.asarray(jax_arr))


@pytest.mark.parametrize("field,n", [("fp128", 128), ("p256k1", 4),
                                     ("p256k1", 64)])
def test_convolutions_match_jax(field, n):
    """negacyclic, cyclic and linear of 2 rows; y once as full rows and
    once as one row broadcast (the Reed-Solomon convolver's form)."""
    J, F = FIELDS[field][0](), FIELDS[field][1]()
    jx, px = _rows(F, (2, n), n)
    jy, py = _rows(F, (2, n), 1000 + n)
    _same(nb.negacyclic(F, px, py), jnb.negacyclic(J, jx, jy))
    _same(nb.cyclic(F, px, py), jnb.cyclic(J, jx, jy))
    _same(nb.linear(F, px, py), jnb.linear(J, jx, jy))
    yb = py[:1].expand_as(py).contiguous()
    assert torch.equal(nb.cyclic(F, px, py[0]), nb.cyclic(F, px, yb))


@pytest.mark.parametrize("M,r,h,step", [(8, 8, 4, 2), (8, 8, 1, 8),
                                        (16, 16, 2, -6), (16, 16, 8, -1),
                                        (4, 8, 2, 11)])
@pytest.mark.parametrize("inverse", [False, True])
def test_butterfly_plain_matches_apply_rot(M, r, h, step, inverse):
    """One level of the block-axis FFT (K19's plain version) against the
    JAX package's butterflies with _apply_rot (nussbaumer.py:135-168)."""
    J, F = jax_fp128(), fp128()
    jA, pA = _rows(F, (3, M, r), M * r + h)
    Ar = jA.reshape((8, 3, M // (2 * h), 2, h, r))
    lo, hi = Ar[..., 0, :, :], Ar[..., 1, :, :]
    shifts = tuple(step * t for t in range(h))
    if inverse:
        hi = jnb._apply_rot(J, hi, shifts)
        pair = [J.add(lo, hi), J.sub(lo, hi)]
    else:
        pair = [J.add(lo, hi), jnb._apply_rot(J, J.sub(lo, hi), shifts)]
    want = jnp.stack(pair, axis=-3).reshape((8, 3, M, r))
    _same(nb.nb_butterfly_plain(F, pA, h, step, inverse), want)


@pytest.mark.parametrize("n", [4, 32])
@pytest.mark.parametrize("negacyclic", [False, True])
def test_base_conv_plain_matches_jax(n, negacyclic):
    J, F = jax_p256k1(), p256k1_base()
    jx, px = _rows(F, (3, n), n)
    jy, py = _rows(F, (3, n), 50 + n)
    _same(nb.nb_base_conv_plain(F, px, py, negacyclic),
          jnb._base_conv(J, jx, jy, negacyclic))


def test_reed_solomon_matches_lagrange_and_jax():
    """ReedSolomon(6, 20) over secp256k1 through Nussbaumer against the
    Lagrange extension and the JAX package's."""
    J, F = jax_p256k1(), p256k1_base()
    jx, px = _rows(F, (6,), 42)
    rs = rs_factory_with(F, nb.make_nussbaumer_convolution_factory(F, "cpu"),
                         "cpu")(6, 20)
    got = rs.interpolate(px)
    want = JaxReedSolomon(6, 20, J, jnb.make_nussbaumer_convolution_factory(
        J)).interpolate(jx)
    _same(got, want)
    ys = [int(v) for v in F.from_limbs(px)]
    out = [int(v) for v in F.from_limbs(got)]
    for k in range(20):
        acc = 0
        for i in range(6):
            num = den = 1
            for j in range(6):
                if j != i:
                    num = num * (k - j) % F.p
                    den = den * (i - j) % F.p
            acc = (acc + ys[i] * num * pow(den, -1, F.p)) % F.p
        assert out[k] == acc, k


def test_toy_p256k1_proof_through_nussbaumer_equals_golden():
    """The toy secp256k1 proof with the Reed-Solomon code through
    Nussbaumer equals the JAX package's golden bytes (made with the CRT
    code); the port's verifier with the same factory accepts it and
    refuses a copy with one bit flipped."""
    F = p256k1_base()
    _, circ, W = _toy()
    rs = rs_factory_with(F, nb.make_nussbaumer_convolution_factory(F, "cpu"),
                         "cpu")
    zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
    prover = ZkProver(circ, F, rs, rate=TOY_RATE, nreq=TOY_NREQ,
                      block_enc=TOY_BLOCK_ENC, device="cpu")
    ts = Transcript(TOY_LABEL)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    data = write_zk_proof(zkp, circ, prover.param, F)
    with open(TOY_P256K1_BIN, "rb") as f:
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


def test_two_level_recursion():
    """negacyclic at 2,048 points recurses twice (m = 32, r = 64, then m =
    r = 8 over every block): y as one row broadcast over x's rows equals
    y expanded to them, and five coefficients equal a host sum."""
    F = fp128()
    n = 2048
    _, px = _rows(F, (2, n), 7)
    _, py = _rows(F, (n,), 8)
    got = nb.negacyclic(F, px, py)
    assert torch.equal(got, nb.negacyclic(F, px, py.expand_as(px)))
    xs = [[int(v) for v in row] for row in F.from_limbs(px)]
    ys = [int(v) for v in F.from_limbs(py)]
    out = F.from_limbs(got)
    for r, k in ((0, 0), (0, 1), (1, 777), (1, 2046), (0, 2047)):
        want = sum(xs[r][j] * ys[k - j] for j in range(k + 1)) - \
            sum(xs[r][j] * ys[n + k - j] for j in range(k + 1, n))
        assert out[r, k] == want % F.p
