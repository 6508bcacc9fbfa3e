"""The layer prologue (K23 layer_hv's plain version, through the sumcheck
prover's term order) and the shifted wire-round sums and hv update (K3's
and K1's plain versions with the round's shift as an argument) against
the JAX package's functions, on numpy inputs from a seed, as canonical
integers (exact).

  - the prologue: hv = F.mul(F.select(bmask, beta, v), jnp.take(dot, g))
    with dot = _raw_eq2_dev(...) (sumcheck/prover_device.py:667-671;
    the port's dot from F.eq_table, K24's plain version),
    then jnp.take(hv, wm_perm) where a merge plan exists (:623), one
    lane at a time as the JAX batch prover's vmap takes them, against
    F.layer_hv over 1 and 3 lanes on SumcheckProver._hv_terms' arrays
    (the plan's permutation applied at upload), in Fp128, the P-256 and
    secp256k1 base fields and GF(2^128);
  - a hand-round at shifts 0-3: the JAX one_hand sums on h >> s and ho
    >> so (:571-584) and its hv update (:590-595) against the port's
    wire_sums_plain, hv_update and bind_hv with the shifts as arguments,
    the indices as uploaded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields import fp_instances as jfi
from longfellow_zk_tpu.fields.gf2 import gf2_128 as jax_gf2_128
from longfellow_zk_tpu.sumcheck.prover_device import (
    _raw_eq2_dev as jax_raw_eq2_dev, _wire_merge_plan as jax_merge_plan)
from longfellow_zk_tpu_torch.fields import fp as fpm
from longfellow_zk_tpu_torch.fields import fp_instances as pfi
from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
from longfellow_zk_tpu_torch.sumcheck.circuit import Quad
from longfellow_zk_tpu_torch.sumcheck.prover import SumcheckProver

# the sumcheck fields: the three prime fields of the proofs and GF(2^128)
FIELDS = {"fp128": (jfi.fp128, pfi.fp128),
          "p256_base": (jfi.p256_base, pfi.p256_base),
          "p256k1_base": (jfi.p256k1_base, pfi.p256k1_base),
          "gf2_128": (jax_gf2_128, gf2_128)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _elts(F, rng, n):
    p = (1 << 128) if F.kCharacteristicTwo else F.p
    return [int.from_bytes(rng.bytes(F.kBytes), "little") % p
            for _ in range(n)]


def _ints(F, t):
    return [int(x) for x in np.asarray(F.from_limbs(t)).reshape(-1)]


@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("field", list(FIELDS))
def test_layer_hv_matches_jax(field, lanes, plan):
    jmk, pmk = FIELDS[field]
    J, F = jmk(), pmk()
    rng = np.random.default_rng(30 + 2 * lanes + plan)
    logv, nv, logw, T = 5, 27, 4, 48
    g = np.sort(rng.integers(0, nv, T)).astype(np.int64)
    h0 = rng.integers(0, 1 << logw, T).astype(np.int64)
    h1 = rng.integers(0, 1 << logw, T).astype(np.int64)
    bmask = rng.random(T) < 0.25
    v = [0 if b else x for b, x in zip(bmask, _elts(F, rng, T))]
    g0, g1 = _elts(F, rng, lanes * logv), _elts(F, rng, lanes * logv)
    ab = _elts(F, rng, 2 * lanes)  # alpha, beta of each lane

    # the port: the terms in the order of the wire rounds, K23's plain
    # version on the lanes (beta a strided view, as the prover's draws)
    sp = SumcheckProver(F, "cpu")
    sp.K_MERGE_MIN_TERMS = 0 if plan else 1 << 30
    quad = Quad(g, h0, h1, v=v)
    ht = sp._hv_terms(quad, logw)
    wm = sp._wm_for(quad, logw)
    assert (wm is not None) == plan
    abt = F.to_limbs(ab, "cpu").reshape((lanes, 2) + F.elt_shape)
    dot = F.eq_table(
        F.to_limbs(g0, "cpu").reshape((lanes, logv) + F.elt_shape), nv,
        abt[:, 0], F.to_limbs(g1, "cpu").reshape((lanes, logv) +
                                                 F.elt_shape))
    got = F.layer_hv(dot, ht["g"], ht["v"], ht["bmask"], abt[:, 1])
    assert got.shape == (lanes, T) + F.elt_shape

    # the JAX package, one lane at a time
    L = J.to_limbs(1).shape[0]
    vj = jnp.asarray(J.to_limbs([1 if x == 0 else x for x in v]))
    perm = jax_merge_plan(h0, h1, logw)[0] if plan else None
    for b in range(lanes):
        gj0 = jnp.asarray(J.to_limbs(g0[b * logv:(b + 1) * logv]))
        gj1 = jnp.asarray(J.to_limbs(g1[b * logv:(b + 1) * logv]))
        alpha = jnp.asarray(J.to_limbs(ab[2 * b]))
        beta = jnp.asarray(J.to_limbs(ab[2 * b + 1]))
        dj = jax_raw_eq2_dev(J, logv, nv, gj0, gj1, alpha)
        vq = J.select(jnp.asarray(bmask),
                      jnp.broadcast_to(beta[..., None], vj.shape), vj)
        hv = J.mul(vq, jnp.take(dj, jnp.asarray(g), axis=dj.ndim - 1))
        if plan:
            hv = jnp.take(hv, jnp.asarray(perm), axis=hv.ndim - 1)
        assert hv.shape == (L, T)
        assert _ints(F, got[b]) == [int(x) for x in
                                    np.asarray(J.from_limbs(hv))]


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("field", list(FIELDS))
def test_shifted_hand_round_matches_jax(field, shift):
    """One hand of round `shift` with the indices as uploaded: the JAX
    one_hand's sums and hv update on h >> s (the other hand's ho one
    round further on, as on a round's second hand), against the port's
    plain K3 sums and K1 hv update and bind_hv taking the shifts."""
    jmk, pmk = FIELDS[field]
    J, F = jmk(), pmk()
    pm = fpm.plain_of(F)
    rng = np.random.default_rng(50 + shift)
    T, logw = 40, 6
    n = 1 << (logw - shift)
    h = rng.integers(0, 1 << logw, T).astype(np.int32)
    ho = rng.integers(0, 1 << logw, T).astype(np.int32)
    so = min(shift + 1, logw)
    hv, Wh, Wo, r = (_elts(F, rng, m) for m in (T, n, n, 1))
    hvp, Whp, Wop = (F.to_limbs(x, "cpu") for x in (hv, Wh, Wo))
    rp = F.to_limbs(r, "cpu")
    ht, hot = torch.as_tensor(h), torch.as_tensor(ho)
    sums = pm.wire_sums_plain(F, hvp, Whp, Wop, ht, hot, shift, so)
    lanes2 = pm.wire_sums_plain(F, torch.stack([hvp, hvp]),
                                torch.stack([Whp, Whp]),
                                torch.stack([Wop, Wop]), ht, hot, shift, so)
    upd = F.hv_update(hvp, ht, rp[0], shift)
    w2, upd2 = F.bind_hv(Whp[None], hvp[None], ht, rp[0], shift)

    # the JAX one_hand (prover_device.py:571-595) on the shifted indices
    hs, hos = jnp.asarray(h >> shift), jnp.asarray(ho >> so)
    jhv, jWh, jWo = (jnp.asarray(J.to_limbs(x)) for x in (hv, Wh, Wo))
    jr = jnp.asarray(J.to_limbs(r[0]))
    z = J.mul(jhv, jnp.take(jWo, hos, axis=-1))
    Whi = jnp.take(jWh, hs | 1, axis=-1)
    Wlo = jnp.take(jWh, hs & ~np.int32(1), axis=-1)
    odd = (hs & 1) == 1
    t0 = J.mul(z, J.select(odd, Whi, Wlo))
    # lazy_sum's axis leaves out the limb axis (prover_device.py:152)
    a0 = J.lazy_sum(J.select(odd, jnp.zeros_like(jhv), t0), axis=0)
    zd = J.mul(z, J.sub(Whi, Wlo))
    a2 = J.lazy_sum(J.select(odd, zd, J.neg(zd)), axis=0)
    one_minus = J.sub(jnp.asarray(J.to_limbs(1)), jr)
    jupd = J.mul(jhv, J.select(odd, jnp.broadcast_to(jr[:, None], jhv.shape),
                               jnp.broadcast_to(one_minus[:, None],
                                                jhv.shape)))
    want = [int(J.from_limbs(np.asarray(a0))),
            int(J.from_limbs(np.asarray(a2)))]
    assert _ints(F, sums) == want
    assert _ints(F, lanes2) == want + want
    want_upd = [int(x) for x in np.asarray(J.from_limbs(jupd))]
    assert _ints(F, upd) == want_upd
    assert _ints(F, upd2) == want_upd
    assert _ints(F, w2) == _ints(F, pm.elementwise_plain(F, fpm.BIND,
                                                         Whp[None], rp[0]))
