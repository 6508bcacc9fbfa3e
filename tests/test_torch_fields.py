"""The port's Fp128 tensor ops (plain versions, CPU) against the JAX
package's PrimeField on the same inputs, made from a numpy seed.  Field
arithmetic is exact: canonical integers must be equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.sumcheck.prover_device import _bind_fixed, _contig_fold
from longfellow_zk_tpu_torch.fields.bridge import limbs_from_jax, limbs_to_jax
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
