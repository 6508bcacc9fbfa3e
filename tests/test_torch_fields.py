"""The port's prime-field tensor ops (plain versions, CPU) against the
JAX package's PrimeField on the same inputs, made from a numpy seed:
Fp128's kernel ops, and the whole device API (sqr, neg, mul_const, inv,
batch_inverse, eq, is_zero, select, natural_limbs_to_bytes_dev) at every
instance of fields/fp_instances.py and fields/fp24.py, and of Fp2 over
the P-256 base field.  Field arithmetic is exact: canonical integers
must be equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields import fp_instances as jfi
from longfellow_zk_tpu.fields.fp2 import Fp2 as JaxFp2
from longfellow_zk_tpu.fields.fp24 import fp24 as jax_fp24
from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.sumcheck.prover_device import _bind_fixed, _contig_fold
from longfellow_zk_tpu_torch.fields import fp_instances as pfi
from longfellow_zk_tpu_torch.fields.bridge import (
    fp2_from_jax, fp2_to_jax, limbs_from_jax, limbs_to_jax)
from longfellow_zk_tpu_torch.fields.fp2 import Fp2
from longfellow_zk_tpu_torch.fields.fp24 import fp24
from longfellow_zk_tpu_torch.fields.fp_instances import fp128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vals(p, rng, n):
    """n canonical field elements with the edge values 0, 1, p - 1 first."""
    v = [0, 1, p - 1] + [int.from_bytes(rng.bytes(16), "little") % p
                         for _ in range(n)]
    return v[:n]


def _pair(n, seed):
    """The same n elements as a JAX array [8, n] and a port tensor [n, 4]."""
    J, F = jax_fp128(), fp128()
    vals = _vals(F.p, np.random.default_rng(seed), n)
    return vals, jnp.asarray(J.to_limbs(vals)), F.to_limbs(vals, "cpu")


def _eq(port, jax_arr):
    assert np.array_equal(limbs_to_jax(port), np.asarray(jax_arr))


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_arith_matches_jax(op):
    J, F = jax_fp128(), fp128()
    _, ja, pa = _pair(257, 1)
    _, jb, pb = _pair(257, 2)
    _eq(getattr(F, op)(pa, pb), getattr(J, op)(ja, jb))
    _eq(getattr(F, op)(pb, pa), getattr(J, op)(jb, ja))


def test_broadcast_mul_matches_jax():
    J, F = jax_fp128(), fp128()
    _, ja, pa = _pair(6 * 40, 3)
    _, jb, pb = _pair(6, 4)
    # a column of row constants over [rows, n], as in the Ligero responses
    got = F.mul(pa.reshape(6, 40, 4), pb[:, None])
    want = J.mul(ja.reshape(8, 6, 40), jb[:, :, None])
    _eq(got, want)


def test_bind_and_hv_update_match_jax():
    J, F = jax_fp128(), fp128()
    _, jx, px = _pair(64, 5)
    vals, jr, pr = _pair(3, 6)
    r_j, r_p = jr[:, 2], pr[2]
    # the port keeps the bound half; the JAX package's fixed shape
    # zero-fills the rest
    _eq(F.bind(px, r_p), _bind_fixed(J, jx, r_j, axis=-1)[:, :32])
    # hv * (h odd ? r : 1 - r), prover_device.py:594-595
    h = np.random.default_rng(7).integers(0, 1 << 10, 64).astype(np.int32)
    odd = jnp.asarray((h & 1) == 1)
    one_minus = J.sub(jnp.asarray(J.to_limbs(1)), r_j)
    want = J.mul(jx, J.select(odd, jnp.broadcast_to(r_j[:, None], jx.shape),
                              jnp.broadcast_to(one_minus[:, None], jx.shape)))
    _eq(F.hv_update(px, torch.as_tensor(h), r_p), want)


def test_from_mont_matches_jax():
    J, F = jax_fp128(), fp128()
    vals, ja, pa = _pair(33, 8)
    _eq(F.from_mont(pa), J.from_mont_device(ja))
    assert [int(x) for x in F.from_limbs(pa)] == vals


def test_lazy_sum_matches_jax():
    J, F = jax_fp128(), fp128()
    vals, ja, pa = _pair(3 * 50, 9)
    _eq(F.lazy_sum(pa.reshape(3, 50, 4), 1), J.lazy_sum(ja.reshape(8, 3, 50), 1))
    _eq(F.lazy_sum(pa.reshape(3, 50, 4), 0), J.lazy_sum(ja.reshape(8, 3, 50), 0))
    # all p - 1: the carry out of the top limb is reduced too
    full = F.to_limbs([F.p - 1] * 1000, "cpu")
    assert F.from_limbs(F.lazy_sum(full, 0)) == (F.p - 1) * 1000 % F.p
    assert F.from_limbs(F.lazy_sum(pa, 0)) == sum(vals) % F.p


def test_lazy_segment_sum_matches_jax():
    J, F = jax_fp128(), fp128()
    _, ja, pa = _pair(400, 10)
    rng = np.random.default_rng(11)
    seg = np.sort(rng.integers(0, 90, 400))
    seg[seg == 17] = 18   # an empty segment
    starts = np.searchsorted(seg, np.arange(90), "left").astype(np.int32)
    ends = np.searchsorted(seg, np.arange(90), "right").astype(np.int32)
    got = F.lazy_segment_sum(pa, torch.as_tensor(starts),
                             torch.as_tensor(ends))
    _eq(got, J.lazy_segment_sum(ja, seg, 90))
    _eq(got, _contig_fold(J, ja, jnp.asarray(starts), jnp.asarray(ends)))


def test_bridge_round_trip():
    J = jax_fp128()
    vals, ja, pa = _pair(100, 12)
    arr = np.asarray(ja).reshape(8, 4, 25)
    t = limbs_from_jax(arr)
    assert t.shape == (4, 25, 4) and t.dtype == torch.int32
    assert np.array_equal(limbs_to_jax(t), arr)
    assert torch.equal(limbs_from_jax(np.asarray(ja)), pa)
    assert list(J.from_limbs(limbs_to_jax(pa))) == vals


# every prime-field instance of both packages: (JAX, port)
API = {"fp24": (jax_fp24, fp24), "fp64": (jfi.fp64, pfi.fp64),
       "fp128": (jfi.fp128, pfi.fp128),
       "p256_base": (jfi.p256_base, pfi.p256_base),
       "p256_scalar": (jfi.p256_scalar, pfi.p256_scalar),
       "p256k1_base": (jfi.p256k1_base, pfi.p256k1_base),
       "p256k1_scalar": (jfi.p256k1_scalar, pfi.p256k1_scalar)}


def _api_vals(p, rng, n):
    """x and y, n canonical values each with the edges 0, 1, p - 1 and
    y equal to x at every third place."""
    xs = _vals(p, rng, n)
    ys = [p - 1, p - 1, 0] + [int.from_bytes(rng.bytes(32), "little") % p
                              for _ in range(n - 3)]
    ys[3::3] = xs[3::3]
    return xs, ys


@pytest.mark.parametrize("field", list(API))
def test_field_api_matches_jax(field):
    """Twin of tests/test_fields.py:24-48 over every instance and the
    whole device API of fields/fp.py (:245 add, :255 sub, :277 mul, :457
    sqr, :274 neg, :460 mul_const, :500-507 eq, is_zero, select, :202
    natural_limbs_to_bytes_dev): the JAX device functions and the host
    ints."""
    J, F = (make() for make in API[field])
    rng = np.random.default_rng(21)
    p, n = F.p, 48
    xs, ys = _api_vals(p, rng, n)
    ja, jb = jnp.asarray(J.to_limbs(xs)), jnp.asarray(J.to_limbs(ys))
    pa, pb = F.to_limbs(xs, "cpu"), F.to_limbs(ys, "cpu")
    assert torch.equal(limbs_from_jax(np.asarray(ja)), pa)
    cond = rng.random(n) < 0.5
    c = 0xC0FFEE % p
    ops = {"add": (F.add(pa, pb), J.add(ja, jb), lambda x, y: x + y),
           "sub": (F.sub(pa, pb), J.sub(ja, jb), lambda x, y: x - y),
           "mul": (F.mul(pa, pb), J.mul(ja, jb), lambda x, y: x * y),
           "sqr": (F.sqr(pa), J.sqr(ja), lambda x, y: x * x),
           "neg": (F.neg(pa), J.neg(ja), lambda x, y: -x),
           "mul_const": (F.mul_const(pa, c), J.mul_const(ja, c),
                         lambda x, y: x * c)}
    for name, (got, want, host) in ops.items():
        _eq(got, want)
        assert list(F.from_limbs(got)) == \
            [host(x, y) % p for x, y in zip(xs, ys)], name
    sel = F.select(torch.as_tensor(cond), pa, pb)
    _eq(sel, J.select(jnp.asarray(cond), ja, jb))
    assert list(F.from_limbs(sel)) == \
        [x if t else y for x, y, t in zip(xs, ys, cond)]
    assert F.eq(pa, pb).tolist() == np.asarray(J.eq(ja, jb)).tolist() == \
        [x == y for x, y in zip(xs, ys)]
    assert F.is_zero(pa).tolist() == np.asarray(J.is_zero(ja)).tolist() == \
        [x == 0 for x in xs]
    got = F.natural_limbs_to_bytes_dev(F.from_mont(pa))
    assert np.array_equal(got.numpy(), np.asarray(
        J.natural_limbs_to_bytes_dev(J.from_mont_device(ja))))
    assert [bytes(r) for r in got.numpy()] == [F.to_bytes(x) for x in xs]


@pytest.mark.parametrize("field", list(API))
def test_inverse_matches_jax(field):
    """Twin of tests/test_fields.py:51-58 at every instance: inv and
    batch_inverse (fields/fp.py:466, :488) against the JAX scan, once, on
    16 elements, 0 among them (0 maps to 0)."""
    J, F = (make() for make in API[field])
    rng = np.random.default_rng(22)
    xs = [0, 1, F.p - 1] + [int.from_bytes(rng.bytes(32), "little") % F.p
                            for _ in range(13)]
    ja, pa = jnp.asarray(J.to_limbs(xs)), F.to_limbs(xs, "cpu")
    iv = F.inv(pa)
    _eq(iv, J.inv(ja))
    assert type(F).batch_inverse is type(F).inv
    assert list(F.from_limbs(iv)) == \
        [pow(x, -1, F.p) if x else 0 for x in xs]


def test_sums_of_the_small_prime_match_jax():
    """lazy_sum and lazy_segment_sum over the ML-DSA prime, whose sums
    pass 2p below R = 2^32 (the plain versions reduce them by a
    product), against the JAX package's byte-column sums as canonical
    ints: the JAX limbs there are not canonical (its _renormalize
    subtracts p once from a value below R, fields/fp.py:532), only
    congruent; the port's are canonical."""
    J, F = jax_fp24(), fp24()
    rng = np.random.default_rng(23)
    xs = [F.p - 1] * 200 + _vals(F.p, rng, 400)
    ja, pa = jnp.asarray(J.to_limbs(xs)), F.to_limbs(xs, "cpu")
    seg = np.sort(rng.integers(0, 30, 600))
    starts = np.searchsorted(seg, np.arange(30), "left").astype(np.int32)
    ends = np.searchsorted(seg, np.arange(30), "right").astype(np.int32)
    for got, want in (
            (F.lazy_sum(pa.reshape(6, 100, 1), 1),
             J.lazy_sum(ja.reshape(2, 6, 100), 1)),
            (F.lazy_segment_sum(pa, torch.as_tensor(starts),
                                torch.as_tensor(ends)),
             J.lazy_segment_sum(ja, seg, 30))):
        assert bool(((got.to(torch.int64) & 0xFFFFFFFF) < F.p).all())
        assert list(F.from_limbs(got)) == \
            list(J.from_limbs(np.asarray(want)))
    assert F.from_limbs(F.lazy_sum(pa, 0)) == sum(xs) % F.p


def test_fp2_api_matches_jax():
    """Twin of tests/test_fields.py:172-190 over the whole device API of
    Fp2 (fields/fp2.py:150 add, :153 sub, :159 mul, :156 neg, :175 sqr,
    :178 mul_const, :181 inv, :193-199 eq, is_zero, select, :212
    natural_limbs_to_bytes_dev, :217 lazy_sum, :221 lazy_segment_sum)
    against the JAX device functions, through the bridge."""
    J2, F2 = JaxFp2(jfi.p256_base()), Fp2(pfi.p256_base())
    rng = np.random.default_rng(24)
    p = F2.f.p
    xs = [(0, 0), (1, 0), (p - 1, p - 1)] + [
        (int.from_bytes(rng.bytes(32), "little") % p,
         int.from_bytes(rng.bytes(32), "little") % p) for _ in range(13)]
    ys = xs[::-1]
    ja, jb = jnp.asarray(J2.to_limbs(xs)), jnp.asarray(J2.to_limbs(ys))
    pa, pb = F2.to_limbs(xs, "cpu"), F2.to_limbs(ys, "cpu")
    assert torch.equal(fp2_from_jax(np.asarray(ja)), pa)
    cond = rng.random(16) < 0.5
    c = (12345, 678)

    def same(got, want):
        assert np.array_equal(fp2_to_jax(got), np.asarray(want))

    for got, want in ((F2.add(pa, pb), J2.add(ja, jb)),
                      (F2.sub(pa, pb), J2.sub(ja, jb)),
                      (F2.mul(pa, pb), J2.mul(ja, jb)),
                      (F2.neg(pa), J2.neg(ja)), (F2.sqr(pa), J2.sqr(ja)),
                      (F2.mul_const(pa, c), J2.mul_const(ja, c)),
                      (F2.select(torch.as_tensor(cond), pa, pb),
                       J2.select(jnp.asarray(cond), ja, jb))):
        same(got, want)
    assert F2.eq(pa, pb).tolist() == np.asarray(J2.eq(ja, jb)).tolist()
    assert F2.is_zero(pa).tolist() == np.asarray(J2.is_zero(ja)).tolist()
    assert np.array_equal(
        F2.natural_limbs_to_bytes_dev(F2.from_mont(pa)).numpy(),
        np.asarray(J2.natural_limbs_to_bytes_dev(J2.from_mont_device(ja))))
    iv = F2.inv(pa)
    same(iv, J2.inv(ja))
    assert type(F2).batch_inverse is type(F2).inv
    assert [F2.mul_i(tuple(v), x) for v, x in zip(F2.from_limbs(iv), xs)] \
        == [(0, 0)] + [(1, 0)] * 15
    same(F2.lazy_sum(pa.reshape(4, 4, 2, F2.nlimb), 1),
         J2.lazy_sum(ja.reshape(2, 16, 4, 4), 1))
    seg = np.array([0, 0, 0, 1, 1, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4])
    starts = np.searchsorted(seg, np.arange(5), "left").astype(np.int32)
    ends = np.searchsorted(seg, np.arange(5), "right").astype(np.int32)
    same(F2.lazy_segment_sum(pa, torch.as_tensor(starts),
                             torch.as_tensor(ends)),
         J2.lazy_segment_sum(ja, seg, 5))
