"""The port's P-384 and P-521 base fields (12 and 17 32-bit words;
fields/fp.py plain versions of K1, K2, K3 and K21, CPU), the bridge that
carries their tensors across, and the sums (K2, K3) of Goldilocks and the
P-256 and secp256k1 group orders, against the JAX package's PrimeField on
the same inputs, made from a numpy seed.  Field arithmetic is exact:
canonical integers must be equal (tolerance 0).

At P-521 the JAX package's Montgomery R is 2^528 (33 16-bit limbs) and
the port's 2^544 (17 words): fields/bridge.py field_from_jax and
field_to_jax convert the values.  P-521's p lies below R / 2 in both
packages; the JAX package's sums (_renormalize) may then leave limbs
that are congruent, not canonical, so its sums are compared as integers
mod p, the port's as canonical limbs."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields import fp_instances as jfi
from longfellow_zk_tpu_torch.fields import fp as fpm
from longfellow_zk_tpu_torch.fields import fp_instances as pfi
from longfellow_zk_tpu_torch.fields.bridge import (
    field_from_jax, field_to_jax, limbs_from_jax, limbs_to_jax)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (JAX, port) of the new fields and of the fields whose sums are new
WIDE = {"p384_base": (jfi.p384_base, pfi.p384_base),
        "p521_base": (jfi.p521_base, pfi.p521_base)}
SUMS = dict(WIDE, fp64=(jfi.fp64, pfi.fp64),
            p256_scalar=(jfi.p256_scalar, pfi.p256_scalar),
            p256k1_scalar=(jfi.p256k1_scalar, pfi.p256k1_scalar))


def _vals(p, rng, n):
    """n canonical elements, the edges 0, 1, p - 1 first."""
    nb = (p.bit_length() + 7) // 8 + 2
    v = [0, 1, p - 1] + [int.from_bytes(rng.bytes(nb), "little") % p
                         for _ in range(n)]
    return v[:n]


def _ints(F, t):
    return [int(v) for v in np.ravel(F.from_limbs(t))]


@pytest.mark.parametrize("name,nwords", [("P384", 12), ("P521", 17)])
def test_header_constants(name, nwords):
    """csrc/fp.cuh's P384 and P521 structs (N, -p^-1 mod 2^32, p, R mod
    p, R^2 mod p with R = 2^(32 N), SMALL) recomputed from
    fields/fp_instances.py."""
    p = getattr(pfi, name)
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "longfellow_zk_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "fp.cuh")).read()
    body = src[src.index("struct %s {" % name):]
    body = body[: body.index("\n};")]
    assert int(re.search(r"int N = (\d+);", body).group(1)) == nwords
    F = fpm.PrimeField(p, name)
    assert F.nlimb == nwords
    R = 1 << (32 * nwords)
    n0inv = int(re.search(r"N0INV = (0x[0-9A-F]+)u", body).group(1), 16)
    assert n0inv == (-pow(p, -1, 1 << 32)) % (1 << 32)
    small = re.search(r"SMALL = (true|false)", body).group(1) == "true"
    assert small == F.small == (2 * p < R)

    def table(fn):
        m = re.search(r"uint32_t %s\(int j\) \{(?: *//[^\n]*)?\s*"
                      r"const uint32_t v\[%d\] = \{([^}]*)\}" % (fn, nwords),
                      body)
        words = [int(w.strip().rstrip("u"), 16)
                 for w in m.group(1).split(",")]
        assert len(words) == nwords
        return sum(w << (32 * i) for i, w in enumerate(words))

    assert (table("p"), table("one"), table("r2")) == (p, R % p, R * R % p)


@pytest.mark.parametrize("field", list(WIDE))
def test_field_api_matches_jax(field):
    """Twin of tests/test_fields.py:24-48 at P-384 and P-521 over the
    device API of the JAX fields/fp.py (:245 add, :255 sub, :277 mul,
    :457 sqr, :274 neg, :460 mul_const, :187 from_mont_device, :500-507
    eq, is_zero, select, :202 natural_limbs_to_bytes_dev): bit-equal
    through the bridge, and the host ints."""
    J, F = (make() for make in WIDE[field])
    assert (F.name, F.kBytes, F.L) == (J.name, J.kBytes, J.L)
    assert F.tag == pfi.KERNEL_TAGS[F.p] == field[:4]
    rng = np.random.default_rng(121)
    p, n = F.p, 24
    xs = _vals(p, rng, n)
    ys = [p - 1, p - 1, 0] + _vals(p, rng, n + 3)[6:]
    ys[3::3] = xs[3::3]
    ja, jb = jnp.asarray(J.to_limbs(xs)), jnp.asarray(J.to_limbs(ys))
    pa, pb = F.to_limbs(xs, "cpu"), F.to_limbs(ys, "cpu")
    assert torch.equal(field_from_jax(F, np.asarray(ja)), pa)
    cond = rng.random(n) < 0.5
    c = 0xC0FFEE << 300
    ops = {"add": (F.add(pa, pb), J.add(ja, jb), lambda x, y: x + y),
           "sub": (F.sub(pa, pb), J.sub(ja, jb), lambda x, y: x - y),
           "mul": (F.mul(pa, pb), J.mul(ja, jb), lambda x, y: x * y),
           "sqr": (F.sqr(pa), J.sqr(ja), lambda x, y: x * x),
           "neg": (F.neg(pa), J.neg(ja), lambda x, y: -x),
           "mul_const": (F.mul_const(pa, c % p), J.mul_const(ja, c % p),
                         lambda x, y: x * c)}
    for name, (got, want, host) in ops.items():
        assert np.array_equal(field_to_jax(F, got), np.asarray(want)), name
        assert _ints(F, got) == [host(x, y) % p for x, y in zip(xs, ys)], \
            name
    sel = F.select(torch.as_tensor(cond), pa, pb)
    assert np.array_equal(field_to_jax(F, sel), np.asarray(
        J.select(jnp.asarray(cond), ja, jb)))
    assert F.eq(pa, pb).tolist() == np.asarray(J.eq(ja, jb)).tolist() == \
        [x == y for x, y in zip(xs, ys)]
    assert F.is_zero(pa).tolist() == np.asarray(J.is_zero(ja)).tolist() == \
        [x == 0 for x in xs]
    # the natural form: limbs of the value in both packages (no R), and
    # its kBytes little-endian bytes (P-521: 66 of the 68)
    nat = F.from_mont(pa)
    jnat = J.from_mont_device(ja)
    limbs16 = np.ascontiguousarray(nat.numpy()).view(np.uint16)[:, : J.L]
    assert np.array_equal(limbs16.T.astype(np.uint32), np.asarray(jnat))
    got = F.natural_limbs_to_bytes_dev(nat)
    assert got.shape == (n, F.kBytes)
    assert np.array_equal(got.numpy(), np.asarray(
        J.natural_limbs_to_bytes_dev(jnat)))
    assert [bytes(r) for r in got.numpy()] == [F.to_bytes(x) for x in xs]


@pytest.mark.parametrize("field", list(WIDE))
def test_inverse_matches_jax(field):
    """inv and batch_inverse (K21's plain version, Fermat) against the JAX
    scan (fields/fp.py:466, :488), 0 among the inputs (0 maps to 0)."""
    J, F = (make() for make in WIDE[field])
    xs = _vals(F.p, np.random.default_rng(122), 8)
    ja, pa = jnp.asarray(J.to_limbs(xs)), F.to_limbs(xs, "cpu")
    iv = F.inv(pa)
    assert np.array_equal(field_to_jax(F, iv), np.asarray(J.inv(ja)))
    assert type(F).batch_inverse is type(F).inv
    assert _ints(F, iv) == [pow(x, -1, F.p) if x else 0 for x in xs]


@pytest.mark.parametrize("field", list(SUMS))
def test_sums_match_jax(field):
    """lazy_sum and lazy_segment_sum (K3's and K2's plain versions,
    fields/fp.py:555, :561) at the instances whose sums are new, with a
    run of p - 1 (at P-521 the column sums pass 2p below R): canonical
    limbs, equal to the JAX sums as integers mod p (bit-equal to them
    where p > R / 2)."""
    J, F = (make() for make in SUMS[field])
    rng = np.random.default_rng(123)
    xs = [F.p - 1] * 40 + _vals(F.p, rng, 80)
    ja, pa = jnp.asarray(J.to_limbs(xs)), F.to_limbs(xs, "cpu")
    seg = np.sort(rng.integers(0, 9, 120))
    starts = np.searchsorted(seg, np.arange(9), "left").astype(np.int32)
    ends = np.searchsorted(seg, np.arange(9), "right").astype(np.int32)
    cases = (
        (F.lazy_sum(pa.reshape(4, 30, F.nlimb), 1),
         J.lazy_sum(ja.reshape(J.L, 4, 30), 1),
         [sum(xs[30 * i : 30 * i + 30]) % F.p for i in range(4)]),
        (F.lazy_sum(pa.reshape(4, 30, F.nlimb), 0),
         J.lazy_sum(ja.reshape(J.L, 4, 30), 0),
         [sum(xs[i::30]) % F.p for i in range(30)]),
        (F.lazy_segment_sum(pa, torch.as_tensor(starts),
                            torch.as_tensor(ends)),
         J.lazy_segment_sum(ja, seg, 9),
         [sum(xs[s:e]) % F.p for s, e in zip(starts, ends)]))
    for got, want, host in cases:
        w = (got.to(torch.int64) & 0xFFFFFFFF).numpy()
        top = F.p >> (32 * (F.nlimb - 1))
        assert bool((w[:, -1] <= top).all())
        assert _ints(F, got) == host
        want = np.asarray(want)
        assert [int(v) % F.p for v in J.from_limbs(want)] == host
        if not F.small:
            assert np.array_equal(field_to_jax(F, got), want)


@pytest.mark.parametrize("field", list(WIDE))
def test_bridge_round_trip(field):
    """field_from_jax / field_to_jax round trips, and a JAX Montgomery
    product carried across equals the port's product; the bit-moving
    functions refuse P-521's 33 limbs and 17 words."""
    J, F = (make() for make in WIDE[field])
    xs = _vals(F.p, np.random.default_rng(124), 30)
    arr = np.asarray(J.to_limbs(xs)).reshape(J.L, 5, 6)
    t = field_from_jax(F, arr)
    assert t.shape == (5, 6, F.nlimb) and t.dtype == torch.int32
    assert np.array_equal(field_to_jax(F, t), arr)
    assert _ints(F, t) == xs
    ja = jnp.asarray(arr)
    prod = field_from_jax(F, np.asarray(J.mul(ja, ja[:, ::-1])))
    assert torch.equal(prod, F.mul(t, t.flip(0)))
    if F.nlimb == 17:
        with pytest.raises(AssertionError):
            limbs_from_jax(arr)
        with pytest.raises(AssertionError):
            limbs_to_jax(t)
    else:
        assert torch.equal(limbs_from_jax(arr), t)
