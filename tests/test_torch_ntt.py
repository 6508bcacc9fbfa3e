"""The port's NTT and Reed-Solomon encoder (plain K4 version, CPU) against
the JAX package's transforms/ntt.py on the same inputs, made from a numpy
seed.  Exact: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.transforms.ntt import NTT as JaxNTT
from longfellow_zk_tpu.zk.testing import rs_factory_for as jax_rs_factory
from longfellow_zk_tpu_torch.fields.bridge import limbs_to_jax
from longfellow_zk_tpu_torch.fields.fp_instances import (
    P128_OMEGA, P128_OMEGA_ORDER, fp128)
from longfellow_zk_tpu_torch.transforms.ntt import NTT
from longfellow_zk_tpu_torch.zk.testing import rs_factory_for


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(rows, n, seed):
    J, F = jax_fp128(), fp128()
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(16), "little") % F.p
            for _ in range(rows * n)]
    return (jnp.asarray(J.to_limbs(vals)).reshape(8, rows, n),
            F.to_limbs(vals, "cpu").reshape(rows, n, 4))


@pytest.mark.parametrize("n", [1, 4])
def test_ntt_matches_jax(n):
    J, F = jax_fp128(), fp128()
    jx, px = _rows(3, n, n)
    jn = JaxNTT(J, P128_OMEGA, P128_OMEGA_ORDER)
    pn = NTT(F, P128_OMEGA, P128_OMEGA_ORDER, "cpu")
    assert np.array_equal(limbs_to_jax(pn.fftf(px)), np.asarray(jn.fftf(jx)))
    assert np.array_equal(limbs_to_jax(pn.fftb(px)), np.asarray(jn.fftb(jx)))


@pytest.mark.parametrize("n,m", [(5, 13)])
def test_reed_solomon_matches_jax(n, m):
    J, F = jax_fp128(), fp128()
    jx, px = _rows(2, n, 100 + n)
    want = jax_rs_factory(J, P128_OMEGA, P128_OMEGA_ORDER)(n, m).interpolate(jx)
    got = rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER, device="cpu")(n, m)
    assert np.array_equal(limbs_to_jax(got.interpolate(px)), np.asarray(want))


def test_ntt_round_trip_at_tableau_width():
    """fftb(fftf(x)) = n * x at the Ligero row width n = 2048."""
    F = fp128()
    _, px = _rows(2, 2048, 7)
    nt = NTT(F, P128_OMEGA, P128_OMEGA_ORDER, "cpu")
    back = nt.fftb(nt.fftf(px))
    assert torch.equal(back, F.mul(px, F.to_limbs(2048, "cpu")))
