"""The port's Fp24 and Fp24_6 (fields/fp24.py; plain versions, CPU)
against the JAX package's fields/fp24.py on the same numpy-seeded
inputs: twins of tests/test_fp24.py:16-58 over the whole device API
(K1, K21 and K3 `[fp24]`, K22), through the bridge (fields/bridge.py
fp24x6_from_jax / fp24x6_to_jax).  Field arithmetic is exact: canonical
integers must be equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields import fp24 as jfp24
from longfellow_zk_tpu.fields.fp_instances import fp64 as jax_fp64
from longfellow_zk_tpu_torch.fields.bridge import (
    fp24x6_from_jax, fp24x6_to_jax, limbs_from_jax, limbs_to_jax)
from longfellow_zk_tpu_torch.fields.fp24 import FP24_P, Fp24_6, fp24
from longfellow_zk_tpu_torch.fields.fp_instances import fp64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _elts6(rng, n):
    """n Fp24_6 elements: zero, one, all p - 1, then random."""
    out = [(0,) * 6, (1, 0, 0, 0, 0, 0), (FP24_P - 1,) * 6]
    out += [tuple(int(c) for c in rng.integers(0, FP24_P, 6))
            for _ in range(n - 3)]
    return out[:n]


def test_fp24_device_field_ops():
    """Twin of tests/test_fp24.py:16-25: mul and inv of the ML-DSA prime
    (one 32-bit word here, two 16-bit limbs there), 0 among the inputs."""
    J, F = jfp24.fp24(), fp24()
    assert F.p == J.p == FP24_P and F.kBytes == J.kBytes == 4
    assert F.nlimb == 1 and F.tag == "fp24"
    rng = np.random.default_rng(0)
    xs = [0] + [int(v) for v in rng.integers(0, F.p, 15)]
    ys = [int(v) for v in rng.integers(0, F.p, 16)]
    xa, ya = jnp.asarray(J.to_limbs(xs)), jnp.asarray(J.to_limbs(ys))
    pa, pb = F.to_limbs(xs, "cpu"), F.to_limbs(ys, "cpu")
    assert torch.equal(limbs_from_jax(np.asarray(xa)), pa)
    m = F.mul(pa, pb)
    assert np.array_equal(limbs_to_jax(m), np.asarray(J.mul(xa, ya)))
    assert list(F.from_limbs(m)) == [x * y % F.p for x, y in zip(xs, ys)]
    iv = F.inv(pa)
    assert np.array_equal(limbs_to_jax(iv), np.asarray(J.inv(xa)))
    assert list(F.from_limbs(iv)) == [0] + [pow(x, -1, F.p) for x in xs[1:]]


def test_bridge_one_and_two_words():
    """The bridge at N = 1 (JAX L = 2) and N = 2 (Fp64, JAX L = 4): both
    packages' R is 2^(32 N), so the limbs move and no value changes."""
    rng = np.random.default_rng(1)
    for J, F in ((jfp24.fp24(), fp24()), (jax_fp64(), fp64())):
        xs = [0, 1, F.p - 1] + [int.from_bytes(rng.bytes(8), "little") % F.p
                                for _ in range(13)]
        arr = np.asarray(J.to_limbs(xs)).reshape(J.L, 4, 4)
        t = limbs_from_jax(arr)
        assert t.shape == (4, 4, F.nlimb)
        assert np.array_equal(limbs_to_jax(t), arr)
        assert torch.equal(t.reshape(16, F.nlimb), F.to_limbs(xs, "cpu"))


def test_fp24_6_host_axioms():
    """Twin of tests/test_fp24.py:28-43: the port's host copy against
    the JAX package's host ops."""
    J6, F6 = jfp24.Fp24_6(jfp24.fp24(), beta=7), Fp24_6(fp24(), beta=7)
    rng = np.random.default_rng(2)
    es = _elts6(rng, 12)
    for a, b in zip(es[1:], es[2:] + es[:1]):
        assert F6.mul_i(a, b) == J6.mul_i(a, b) == F6.mul_i(b, a)
        assert F6.add_i(a, b) == J6.add_i(a, b)
        assert F6.inv_i(a) == J6.inv_i(a)
        assert F6.mul_i(a, F6.inv_i(a)) == F6.of_scalar(1)
        assert F6.of_bytes(F6.to_bytes(a)) == a
        assert F6.to_bytes(a) == J6.to_bytes(a)


def test_fp24_6_device_matches_jax():
    """Twin of tests/test_fp24.py:46-58 over the whole device API of
    Fp24_6 (fields/fp24.py:218-224 add, sub, neg, :227 mul, :242 sqr,
    :245 inv, :261-270 eq, is_zero, select, lazy_sum): the port's K22 and
    K3 plain versions against the JAX device functions, through the
    bridge, and against the host ops; the JAX inverse (a scan) once, on
    6 elements, 0 among them (0 maps to 0)."""
    J6, F6 = jfp24.Fp24_6(jfp24.fp24(), beta=7), Fp24_6(fp24(), beta=7)
    assert F6.tag == "fp24x6" and F6.elt_shape == (6, 1)
    rng = np.random.default_rng(3)
    xs, ys = _elts6(rng, 12), _elts6(rng, 12)[::-1]
    ys[4] = xs[4]
    xa, ya = jnp.asarray(J6.to_limbs(xs)), jnp.asarray(J6.to_limbs(ys))
    pa, pb = F6.to_limbs(xs, "cpu"), F6.to_limbs(ys, "cpu")
    assert torch.equal(fp24x6_from_jax(np.asarray(xa)), pa)
    assert np.array_equal(fp24x6_to_jax(pa), np.asarray(xa))
    cond = rng.random(12) < 0.5

    def same(got, want, host):
        assert np.array_equal(fp24x6_to_jax(got), np.asarray(want))
        assert list(F6.from_limbs(got)) == host

    same(F6.add(pa, pb), J6.add(xa, ya),
         [F6.add_i(x, y) for x, y in zip(xs, ys)])
    same(F6.sub(pa, pb), J6.sub(xa, ya),
         [F6.sub_i(x, y) for x, y in zip(xs, ys)])
    same(F6.neg(pa), J6.neg(xa), [F6.neg_i(x) for x in xs])
    same(F6.mul(pa, pb), J6.mul(xa, ya),
         [F6.mul_i(x, y) for x, y in zip(xs, ys)])
    same(F6.sqr(pa), J6.sqr(xa), [F6.mul_i(x, x) for x in xs])
    same(F6.select(torch.as_tensor(cond), pa, pb),
         J6.select(jnp.asarray(cond), xa, ya),
         [x if t else y for x, y, t in zip(xs, ys, cond)])
    assert F6.eq(pa, pb).tolist() == np.asarray(J6.eq(xa, ya)).tolist() \
        == [x == y for x, y in zip(xs, ys)]
    assert F6.is_zero(pa).tolist() == \
        np.asarray(J6.is_zero(xa)).tolist() == [not any(x) for x in xs]
    # lazy_sum: the JAX byte-column sums of fp24 leave limbs that are
    # congruent, not canonical (tests/test_torch_fields.py): held as ints
    got = F6.lazy_sum(pa.reshape(3, 4, 6, 1), 1)
    want = J6.lazy_sum(xa.reshape(6, 2, 3, 4), 1)
    assert list(F6.from_limbs(got)) == list(J6.from_limbs(np.asarray(want)))
    # the inverse
    iv = F6.inv(pa[:6])
    same(iv, J6.inv(xa[:, :, :6]),
         [(0,) * 6] + [F6.inv_i(x) for x in xs[1:6]])
