"""The port's P-256 slice (plain kernel versions, CPU) against the JAX
package on the same inputs, made from a numpy seed: the Fp256 tensor ops
(K1-K3), Fp2 (K5), the Fp2 NTT (K4) and the Reed-Solomon encoder through
FFTExtConvolution, the bridge, the ECDSA witness, the LFC1 reader and the
toy Fp256 proof.  Field arithmetic is exact: canonical integers must be
equal (tolerance 0).

Also checks, on the CPU, what surrounds the CUDA kernels: the constants
of csrc/fp.cuh and the broadcast arithmetic that the wrappers hand to K1
and K5.
"""

import gzip
import os
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.circuits.ecdsa.verify import (
    compute_witness as jax_compute_witness)
from longfellow_zk_tpu.ec.curves import ecdsa_sign as jax_ecdsa_sign
from longfellow_zk_tpu.ec.curves import p256_curve as jax_p256_curve
from longfellow_zk_tpu.fields.fp2 import Fp2 as JaxFp2
from longfellow_zk_tpu.fields.fp_instances import p256_base as jax_p256
from longfellow_zk_tpu.proto.lfc1 import read_circuit as jax_read_circuit
from longfellow_zk_tpu.sumcheck.prover_device import (
    DeviceSumcheckProver, _bind_fixed, _contig_fold)
from longfellow_zk_tpu.transforms.ntt import NTT as JaxNTT
from longfellow_zk_tpu_torch.circuits.ecdsa.verify import compute_witness
from longfellow_zk_tpu_torch.ec.curves import ecdsa_sign, p256_curve
from longfellow_zk_tpu_torch.fields import fp as fpm
from longfellow_zk_tpu_torch.fields.bridge import (
    circuit_from_arrays, fp2_from_jax, fp2_to_jax, limbs_from_jax,
    limbs_to_jax)
from longfellow_zk_tpu_torch.fields.fp2 import Fp2
from longfellow_zk_tpu_torch.fields.fp_instances import (
    P128, P256, P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X, P256_FP2_ROOT_Y,
    p256_base)
from longfellow_zk_tpu_torch.proto.lfc1 import P256_ID, read_circuit
from longfellow_zk_tpu_torch.random_oracle.engine import DeterministicEngine
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.sumcheck.prover import (
    SumcheckProver, quad_tensors)
from longfellow_zk_tpu_torch.transforms.ntt import NTT
from longfellow_zk_tpu_torch.zk.proof import ZkProof
from longfellow_zk_tpu_torch.zk.prover import ZkProver
from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof
from longfellow_zk_tpu_torch.zk.testing import rs_factory_for

from test_torch_golden import (
    ECDSA_CIRCUIT, TOY_BLOCK_ENC, TOY_LABEL, TOY_NREQ, TOY_P256_BIN, TOY_RATE,
    ecdsa_witness, toy_inputs)
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OMEGA2 = (P256_FP2_ROOT_X, P256_FP2_ROOT_Y)


def _vals(p, rng, n):
    """n canonical field elements with the edge values 0, 1, p - 1 first."""
    v = [0, 1, p - 1] + [int.from_bytes(rng.bytes(32), "little") % p
                         for _ in range(n)]
    return v[:n]


def _pair(n, seed):
    """The same n elements as a JAX array [16, n] and a port tensor [n, 8]."""
    J, F = jax_p256(), p256_base()
    vals = _vals(F.p, np.random.default_rng(seed), n)
    return vals, jnp.asarray(J.to_limbs(vals)), F.to_limbs(vals, "cpu")


def _pair2(n, seed):
    """The same n Fp2 elements as JAX [2, 16, n] and port [n, 2, 8]."""
    J2, F2 = JaxFp2(jax_p256()), Fp2(p256_base())
    rng = np.random.default_rng(seed)
    re = _vals(F2.f.p, rng, n)
    im = _vals(F2.f.p, rng, n)[::-1]
    vals = list(zip(re, im))
    return vals, jnp.asarray(J2.to_limbs(vals)), F2.to_limbs(vals, "cpu")


def _eq(port, jax_arr):
    assert np.array_equal(limbs_to_jax(port), np.asarray(jax_arr))


def _eq2(port, jax_arr):
    assert np.array_equal(fp2_to_jax(port), np.asarray(jax_arr))


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_fp256_arith_matches_jax(op):
    J, F = jax_p256(), p256_base()
    _, ja, pa = _pair(64, 1)
    _, jb, pb = _pair(64, 2)
    _eq(getattr(F, op)(pa, pb), getattr(J, op)(ja, jb))
    _eq(getattr(F, op)(pb, pa), getattr(J, op)(jb, ja))


def test_fp256_from_mont_bind_hv_match_jax():
    J, F = jax_p256(), p256_base()
    vals, jx, px = _pair(32, 3)
    _eq(F.from_mont(px), J.from_mont_device(jx))
    assert [int(x) for x in F.from_limbs(px)] == vals
    _, jr, pr = _pair(4, 4)
    r_j, r_p = jr[:, 3], pr[3]
    # the port keeps the bound half; the JAX package's fixed shape
    # zero-fills the rest
    _eq(F.bind(px, r_p), _bind_fixed(J, jx, r_j, axis=-1)[:, :16])
    # hv * (h odd ? r : 1 - r), prover_device.py:594-595
    h = np.random.default_rng(5).integers(0, 1 << 10, 32).astype(np.int32)
    odd = jnp.asarray((h & 1) == 1)
    one_minus = J.sub(jnp.asarray(J.to_limbs(1)), r_j)
    want = J.mul(jx, J.select(odd, jnp.broadcast_to(r_j[:, None], jx.shape),
                              jnp.broadcast_to(one_minus[:, None], jx.shape)))
    _eq(F.hv_update(px, torch.as_tensor(h), r_p), want)


def test_fp256_sums_match_jax():
    J, F = jax_p256(), p256_base()
    vals, ja, pa = _pair(3 * 20, 6)
    _eq(F.lazy_sum(pa.reshape(3, 20, 8), 1), J.lazy_sum(ja.reshape(16, 3, 20),
                                                        1))
    _eq(F.lazy_sum(pa.reshape(3, 20, 8), 0), J.lazy_sum(ja.reshape(16, 3, 20),
                                                        0))
    # all p - 1: the carry out of the top limb is reduced too
    full = F.to_limbs([F.p - 1] * 300, "cpu")
    assert F.from_limbs(F.lazy_sum(full, 0)) == (F.p - 1) * 300 % F.p
    assert F.from_limbs(F.lazy_sum(pa, 0)) == sum(vals) % F.p
    seg = np.sort(np.random.default_rng(7).integers(0, 9, 60))
    seg[seg == 4] = 5   # an empty segment
    starts = np.searchsorted(seg, np.arange(9), "left").astype(np.int32)
    ends = np.searchsorted(seg, np.arange(9), "right").astype(np.int32)
    got = F.lazy_segment_sum(pa, torch.as_tensor(starts),
                             torch.as_tensor(ends))
    _eq(got, J.lazy_segment_sum(ja, seg, 9))
    _eq(got, _contig_fold(J, ja, jnp.asarray(starts), jnp.asarray(ends)))


def _port_toy_circuit():
    J, F = jax_p256(), p256_base()
    jc = _zk_circuit(J)
    layers = [dict(nw=l.nw, logw=l.logw, g=l.quad.g, h0=l.quad.h0,
                   h1=l.quad.h1, v=J.to_limbs(list(l.quad.v)))
              for l in jc.layers]
    return jc, circuit_from_arrays(F, jc.nv, jc.nc, jc.ninputs, jc.npub_in,
                                   layers, jc.subfield_boundary, jc.id)


def test_fp256_eval_layer_matches_jax():
    """K2's evaluation mode against DeviceSumcheckProver._eval_layer."""
    J, F = jax_p256(), p256_base()
    jc, pc = _port_toy_circuit()
    W = toy_inputs(F.p, 32)
    dp = DeviceSumcheckProver(J)
    qd = dp._quad_dev_eval(jc.layers[1].quad, jc.layers[0].nw)
    W0 = jnp.asarray(J.to_limbs(W)).reshape(16, 4, 1)
    V_j, ok_j = dp._eval_layer(qd, W0, jc.layers[0].nw)
    sp = SumcheckProver(F, device="cpu")
    pq = quad_tensors(F, pc.layers[1].quad, sp.device)
    s, e = sp._segments(pc.layers[1].quad, pc.layers[0].nw)
    V_p, ok_p = fpm.fp_eval_layer(F, limbs_from_jax(np.asarray(W0)[:, :, 0]),
                                  pq["h0"], pq["h1"], pq["v"], pq["bmask"],
                                  s, e)
    assert np.array_equal(limbs_to_jax(V_p), np.asarray(V_j)[:, :, 0])
    assert bool(ok_p) == bool(ok_j)


@pytest.mark.parametrize("op", ["mul", "add", "sub", "mul_base"])
def test_fp2_ops_match_jax(op):
    J2, F2 = JaxFp2(jax_p256()), Fp2(p256_base())
    _, ja, pa = _pair2(16, 8)
    if op == "mul_base":
        _, jb, pb = _pair(16, 9)
    else:
        _, jb, pb = _pair2(16, 9)
    _eq2(getattr(F2, op)(pa, pb), getattr(J2, op)(ja, jb))
    vals, _, _ = _pair2(16, 8)
    _eq2(F2.to_limbs(list(F2.from_limbs(pa)), "cpu"), ja)
    assert list(F2.from_limbs(pa)) == vals


def test_fp2_ntt_matches_jax():
    J2, F2 = JaxFp2(jax_p256()), Fp2(p256_base())
    _, jx, px = _pair2(16, 10)
    jn = JaxNTT(J2, OMEGA2, P256_FP2_ROOT_ORDER)
    pn = NTT(F2, OMEGA2, P256_FP2_ROOT_ORDER, "cpu")
    _eq2(pn.fftf(px), jn.fftf(jx))


def test_reed_solomon_ext_matches_jax():
    """RS 8 -> 32 through FFTExtConvolution, two rows."""
    from longfellow_zk_tpu.zk.testing import rs_factory_for as jax_factory

    J, F = jax_p256(), p256_base()
    _, jx, px = _pair(2 * 8, 11)
    want = jax_factory(J, F2=JaxFp2(J), omega2=OMEGA2,
                       omega_order=P256_FP2_ROOT_ORDER)(8, 32).interpolate(
                           jx.reshape(16, 2, 8))
    got = rs_factory_for(F, F2=Fp2(F), omega2=OMEGA2,
                         omega_order=P256_FP2_ROOT_ORDER, device="cpu")(8, 32)
    _eq(got.interpolate(px.reshape(2, 8, 8)), want)


def test_bridge_round_trip_fp256_and_fp2():
    J = jax_p256()
    vals, ja, pa = _pair(30, 12)
    arr = np.asarray(ja).reshape(16, 5, 6)
    t = limbs_from_jax(arr)
    assert t.shape == (5, 6, 8) and t.dtype == torch.int32
    assert np.array_equal(limbs_to_jax(t), arr)
    assert torch.equal(limbs_from_jax(np.asarray(ja)), pa)
    assert list(J.from_limbs(limbs_to_jax(pa))) == vals
    _, ja2, pa2 = _pair2(12, 13)
    arr2 = np.asarray(ja2).reshape(2, 16, 3, 4)
    t2 = fp2_from_jax(arr2)
    assert t2.shape == (3, 4, 2, 8)
    assert np.array_equal(fp2_to_jax(t2), arr2)
    assert torch.equal(fp2_from_jax(np.asarray(ja2)), pa2)


def test_ecdsa_witness_matches_jax():
    F, J = p256_base(), jax_p256()
    got = ecdsa_witness(F, p256_curve(), compute_witness, ecdsa_sign)
    want = ecdsa_witness(J, jax_p256_curve(), jax_compute_witness,
                         jax_ecdsa_sign)
    assert len(got) == 1038 and got == want
    # a signature over another digest does not verify
    ec = p256_curve()
    rng = random.Random(5)
    d = rng.randrange(1, ec.order)
    pk = ec.normalize(ec.scalar_mult(ec.generator(), d))
    r, s = ecdsa_sign(ec, d, 7, rng.randrange(1, ec.order))
    with pytest.raises(AssertionError, match="does not verify"):
        compute_witness(ec, pk.x, pk.y, 8, r, s)


def test_lfc1_reads_the_ecdsa_circuit_as_jax():
    F, J = p256_base(), jax_p256()
    data = gzip.open(ECDSA_CIRCUIT, "rb").read()
    pc = read_circuit(F, P256_ID, data)
    jc = jax_read_circuit(J, P256_ID, data)
    assert pc is not None and pc.id == jc.id and pc.nl == jc.nl == 11
    assert (pc.ninputs, pc.npub_in, pc.logc) == (jc.ninputs, jc.npub_in, 0)
    for lp, lj in zip(pc.layers, jc.layers):
        assert (lp.nw, lp.logw) == (lj.nw, lj.logw)
        for k in ("g", "h0", "h1", "kidx"):
            assert np.array_equal(getattr(lp.quad, k), getattr(lj.quad, k))
        # the 32-byte constants
        assert list(lp.quad.ktable) == list(lj.quad.ktable)
        assert max(lp.quad.ktable) >= 1 << 128


def test_toy_p256_proof_bytes_equal_jax():
    """The toy circuit of tests/test_zk.py over P-256 with the Fp2 RS:
    the port's CPU proof equals the JAX package's golden bytes."""
    F = p256_base()
    _, circ = _port_toy_circuit()
    W = toy_inputs(F.p, 32)
    rs = rs_factory_for(F, F2=Fp2(F), omega2=OMEGA2,
                        omega_order=P256_FP2_ROOT_ORDER, device="cpu")
    zkp = ZkProof(rate=TOY_RATE, nreq=TOY_NREQ)
    prover = ZkProver(circ, F, rs, rate=TOY_RATE, nreq=TOY_NREQ,
                      block_enc=TOY_BLOCK_ENC, device="cpu")
    ts = Transcript(TOY_LABEL)
    prover.commit(zkp, W, ts, DeterministicEngine())
    assert prover.prove(zkp, W, ts)
    with open(TOY_P256_BIN, "rb") as f:
        assert write_zk_proof(zkp, circ, prover.param, F) == f.read()


def test_header_constants():
    """csrc/fp.cuh's per-field constants: p, -p^-1 mod 2^32, R mod p and
    R^2 mod p with R = 2^(32 N)."""
    src = open(os.path.join(REPO, "longfellow_zk_tpu_torch", "csrc",
                            "fp.cuh")).read()
    for name, p in (("P128", P128), ("P256", P256)):
        body = src[src.index("struct %s {" % name):]
        body = body[: body.index("\n};")]
        n = int(re.search(r"int N = (\d+);", body).group(1))
        n0inv = int(re.search(r"N0INV = (0x[0-9A-F]+)u", body).group(1), 16)
        R = 1 << (32 * n)
        assert p < R <= p << 1
        assert n0inv == (-pow(p, -1, 1 << 32)) % (1 << 32)

        def table(fn):
            m = re.search(r"uint32_t %s\(int j\) \{(?: *//[^\n]*)?\s*"
                          r"const uint32_t v\[\d\] = \{([^}]*)\}" % fn, body)
            if m is None:    # P128's p(j), written as a ternary
                return None
            words = [int(w.strip().rstrip("u"), 16)
                     for w in m.group(1).split(",")]
            assert len(words) == n
            return sum(w << (32 * i) for i, w in enumerate(words))

        assert table("p") in (p, None)
        assert table("one") == R % p
        assert table("r2") == R * R % p


@pytest.mark.parametrize("mode", ["fp", "fp2", "fp2_base"])
def test_broadcast_operands_index_as_the_kernels(mode):
    """The (a, b, bdiv, bmod) that K1's and K5's wrappers hand to the card:
    reading b[(i // bdiv) % bmod] beside a[i] gives the broadcast."""
    F = p256_base()
    E = {"fp": (8,), "fp2": (2, 8), "fp2_base": (2, 8)}[mode]
    Eb = (8,) if mode == "fp2_base" else E
    rng = np.random.default_rng(14)

    def t(shape, e):
        return torch.as_tensor(rng.integers(-2**31, 2**31, shape + e,
                                            dtype=np.int64)).to(torch.int32)

    cases = [((6, 40), (40,)), ((6, 40), (6, 1)), ((6, 40), ()),
             ((40,), (6, 40)), ((6, 5, 2), (6, 1, 2)), ((3, 4), (3, 4))]
    for sa, sb in cases:
        a, b = t(sa, E), t(sb, Eb)
        a2, b2, bdiv, bmod = fpm.broadcast_operands(a, b, E, Eb,
                                                    mode == "fp")
        shape = torch.broadcast_shapes(sa, sb)
        assert tuple(a2.shape) == tuple(shape) + E and a2.is_contiguous()
        n = int(np.prod(shape))
        idx = (torch.arange(n) // bdiv) % bmod
        full_b = b2.reshape((-1,) + Eb)[idx].reshape(tuple(shape) + Eb)
        if torch.equal(a2, a.expand(tuple(shape) + E)):
            want_b = b.expand(tuple(shape) + Eb)
        else:   # swapped: b was the full operand
            want_b = a.expand(tuple(shape) + Eb)
        assert torch.equal(full_b, want_b)
