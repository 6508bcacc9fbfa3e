"""The port's CRT Reed-Solomon route over the other root-poor fields (the
P-256 group order, P-384, P-521; K13's and K15's plain versions, K4
[crt] and K14 at 18, 26 and 35 lanes) against the JAX package's
transforms/crt_conv.py, and over the P-256 base field against the port's
own Fp2 route, on the CPU.

Inputs come from numpy seeds; field tensors are compared through
fields/bridge.py field_from_jax / field_to_jax (bit-equal: tolerance 0;
at P-521 the bridge converts the Montgomery values, JAX's R being 2^528).
The JAX side runs eagerly; its contexts are shared by a module fixture.
"""

import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields import fp_instances as jfi
from longfellow_zk_tpu.transforms import crt_conv as jcc
from longfellow_zk_tpu.transforms.ntt import ReedSolomon as JaxReedSolomon

from longfellow_zk_tpu_torch.fields import fp_instances as pfi
from longfellow_zk_tpu_torch.fields.bridge import (
    field_from_jax, field_to_jax, mp_from_jax, mp_to_jax)
from longfellow_zk_tpu_torch.fields.fp2 import Fp2
from longfellow_zk_tpu_torch.fields.multiprime import basis_size_for
from longfellow_zk_tpu_torch.transforms import crt_conv
from longfellow_zk_tpu_torch.transforms.ntt import ReedSolomon
from longfellow_zk_tpu_torch.zk.testing import rs_factory_for, rs_factory_with

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (JAX field, port field, basis size) of the fields whose JAX tests
# (tests/test_crt.py:50, :80) run the CRT route, and P-521
FIELDS = {"p256_scalar": (jfi.p256_scalar, pfi.p256_scalar, 18),
          "p384_base": (jfi.p384_base, pfi.p384_base, 26),
          "p521_base": (jfi.p521_base, pfi.p521_base, 35)}


@pytest.fixture(scope="module")
def contexts():
    """field -> (J, F, the JAX CRTContext, the port's CPU CRTContext),
    made once a module."""
    cache = {}

    def get(field):
        if field not in cache:
            jmake, pmake, _ = FIELDS[field]
            J, F = jmake(), pmake()
            cache[field] = (J, F, jcc.CRTContext(J),
                            crt_conv.CRTContext(F, device="cpu"))
        return cache[field]
    return get


def _elts(F, rng, n):
    """n canonical elements from a numpy seed, 0, 1 and p - 1 first."""
    nb = 4 * F.nlimb
    vals = [0, 1, F.p - 1] + [int.from_bytes(rng.bytes(nb), "little") % F.p
                              for _ in range(n)]
    return vals[:n]


@pytest.mark.parametrize("field", list(FIELDS))
def test_crt_round_trip_matches_jax(contexts, field):
    """Twin of tests/test_crt.py:50 over the three fields: the residues of
    to_crt (K13's plain version) bit-equal to the JAX CRTContext.to_crt's
    through the bridge, from_crt (K15's) the identity on them and equal to
    the JAX from_crt on other residues."""
    J, F, jctx, ctx = contexts(field)
    vs = FIELDS[field][2]
    assert ctx.mp.vs == jctx.mp.vs == basis_size_for(F.bits) == vs
    assert ctx.mp.primes == list(jctx.mp.primes)
    rng = np.random.default_rng(50)
    xs = _elts(F, rng, 9)
    x = F.to_limbs(xs, "cpu").reshape(3, 3, F.nlimb)
    jx = jnp.asarray(field_to_jax(F, x))
    assert np.array_equal(np.asarray(jx), np.asarray(J.to_limbs(xs)).reshape(
        J.L, 3, 3))
    z = ctx.to_crt(x)
    assert z.shape == (vs, 3, 3, 1)
    assert torch.equal(z, mp_from_jax(np.asarray(jctx.to_crt(jx))))
    back = ctx.from_crt(z)
    assert torch.equal(back, x)
    assert [int(v) for v in F.from_limbs(back).reshape(-1)] == xs
    # beside them, residues of no element of the field (values up to
    # prod p_b): one JAX from_crt (10 s eager at P-521) for both
    r = ctx.mp.to_limbs([np.array([int(rng.integers(0, q)) for q in
                                   ctx.mp.primes], dtype=object)
                         for _ in range(3)], "cpu")
    zr = torch.cat([z, r[:, None]], dim=1)                  # [VS, 4, 3, 1]
    want = field_from_jax(F, np.asarray(jctx.from_crt(jnp.asarray(
        mp_to_jax(zr)))))
    assert torch.equal(want[:3], x)
    assert torch.equal(ctx.from_crt(zr), want)


def _naive_rs_extend(F, ys, m):
    """Lagrange evaluation of the interpolating polynomial at n..m-1
    (tests/test_crt.py:61)."""
    n = len(ys)
    out = list(ys)
    for k in range(n, m):
        acc = 0
        for i in range(n):
            num, den = 1, 1
            for j in range(n):
                if j != i:
                    num = num * (k - j) % F.p
                    den = den * (i - j) % F.p
            acc = (acc + ys[i] * num * pow(den, -1, F.p)) % F.p
        out.append(acc)
    return out


@pytest.mark.parametrize("field,n,m", [("p256_scalar", 5, 17),
                                       ("p384_base", 5, 17),
                                       ("p521_base", 4, 9)])
def test_crt_reed_solomon_matches_jax_and_lagrange(contexts, field, n, m):
    """Twin of tests/test_crt.py:80: rs_factory_for(F) (the CRT route)
    against the JAX ReedSolomon with its CRT convolution and against
    naive Lagrange, on 3 rows."""
    J, F, jctx, _ = contexts(field)
    rng = np.random.default_rng(80 + n)
    rows = [_elts(F, rng, n + 3)[3:] for _ in range(3)]
    rows[0][0] = F.p - 1
    y = F.to_limbs([v for r in rows for v in r], "cpu").reshape(3, n, F.nlimb)
    rs = rs_factory_for(F, device="cpu")(n, m)
    assert isinstance(rs.conv, crt_conv.CRTConvolution)
    got = rs.interpolate(y)
    jrs = JaxReedSolomon(n, m, J, lambda nn, mm, yy: jcc.CRTConvolution(
        nn, mm, jctx, yy))
    want = jrs.interpolate(jnp.asarray(field_to_jax(F, y)))
    assert torch.equal(got, field_from_jax(F, np.asarray(want)))
    vals = F.from_limbs(got)
    for r in range(3):
        assert [int(v) for v in vals[r]] == _naive_rs_extend(F, rows[r], m)


def test_ecdsa_route_crt_equals_fp2():
    """The P-256 base field's Reed-Solomon code at the ECDSA tableau's
    shape (block 341 -> block_enc 2,048, as the ECDSA proof's Ligero
    commit encodes it) through the CRT convolution equals it through the
    Fp2 NTT (both the port's plain versions): the extension is unique."""
    F = pfi.p256_base()
    F2 = Fp2(F)
    meta = json.load(open(os.path.join(
        REPO, "longfellow_zk_tpu_torch", "testdata", "ecdsa_p256.proof.json")))
    assert (meta["rate"], meta["nreq"]) == (4, 128)
    from longfellow_zk_tpu_torch.proto.lfc1 import P256_ID, read_circuit
    from longfellow_zk_tpu_torch.zk.prover import ZkProver
    circ = read_circuit(F, P256_ID, gzip.open(os.path.join(
        REPO, "artifacts", "ecdsa_p256.lfc1.gz"), "rb").read())
    lp = ZkProver(circ, F, None, rate=meta["rate"], nreq=meta["nreq"],
                  device="cpu").param
    n, m = lp.block, lp.block_enc
    assert (n, m) == (341, 2048)
    rng = np.random.default_rng(341)
    y = F.to_limbs(_elts(F, rng, 2 * n), "cpu").reshape(2, n, F.nlimb)
    crt = rs_factory_with(F, crt_conv.make_crt_convolution_factory(
        F, device="cpu"), device="cpu")(n, m)
    fp2 = rs_factory_for(F, F2=F2, omega2=(pfi.P256_FP2_ROOT_X,
                                           pfi.P256_FP2_ROOT_Y),
                         omega_order=pfi.P256_FP2_ROOT_ORDER,
                         device="cpu")(n, m)
    assert isinstance(crt, ReedSolomon)
    got = crt.interpolate(y)
    assert torch.equal(got, fp2.interpolate(y))
    assert torch.equal(got[:, :n], y)
