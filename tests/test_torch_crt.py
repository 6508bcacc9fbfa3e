"""The port's CRT Reed-Solomon code (fields/multiprime.py,
transforms/crt_conv.py, K4 [crt] and K13-K15's plain versions) and its
secp256k1 field against the JAX package, on the CPU.

Inputs come from numpy seeds; field tensors are compared as canonical
integers through fields/bridge.py (exact, tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from longfellow_zk_tpu.fields import multiprime as jmp
from longfellow_zk_tpu.fields.fp_instances import p256k1_base as jax_p256k1
from longfellow_zk_tpu.transforms import crt_conv as jcc
from longfellow_zk_tpu.transforms.ntt import ReedSolomon as JaxReedSolomon

from longfellow_zk_tpu_torch.fields import fp as fpm
from longfellow_zk_tpu_torch.fields import multiprime as mpm
from longfellow_zk_tpu_torch.fields.bridge import (
    limbs_from_jax, limbs_to_jax, mp_from_jax, mp_to_jax)
from longfellow_zk_tpu_torch.fields.fp_instances import (
    KERNEL_TAGS, P256K1, p256k1_base)
from longfellow_zk_tpu_torch.transforms import crt_conv
from longfellow_zk_tpu_torch.transforms.ntt import NTT, ReedSolomon
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


VS = 18


@pytest.fixture(scope="module")
def fields():
    return jmp.MultiPrimeField(VS), mpm.MultiPrimeField(VS)


def _residues(mp, rng, n):
    """n residue vectors (natural), 0, 1 and p_b - 1 first."""
    out = [np.array([v % p for p in mp.primes], dtype=object)
           for v in (0, 1)]
    out.append(np.array([p - 1 for p in mp.primes], dtype=object))
    out += [np.array([int(rng.integers(0, p)) for p in mp.primes],
                     dtype=object) for _ in range(n)]
    return out[:n]


def _elts(F, rng, n):
    vals = [0, 1, F.p - 1] + [int.from_bytes(rng.bytes(32), "little") % F.p
                              for _ in range(n)]
    return vals[:n]


@pytest.mark.parametrize("bits", [256, 384, 521])
def test_basis_matches_jax(bits):
    vs = mpm.basis_size_for(bits)
    assert vs == jmp.basis_size_for(bits)
    assert mpm.crt_primes(vs) == jmp.crt_primes(vs)
    if bits == 256:
        assert vs == VS
        assert mpm.crt_primes(3) == (4253024257, 4194304001, 4106223617)
    J, P = jmp.MultiPrimeField(vs), mpm.MultiPrimeField(vs)
    assert list(J.omegas) == list(P.omegas)
    # every basis is a prefix of the kernels' table (csrc/mp.cuh)
    assert vs <= mpm.MP_MAX
    assert mpm.crt_primes(mpm.MP_MAX)[:vs] == mpm.crt_primes(vs)


def test_layout_matches_jax(fields):
    J, P = fields
    vals = _residues(P, np.random.default_rng(1), 40)
    t = P.to_limbs(vals, "cpu")
    assert t.shape == (VS, 40, 1)
    assert torch.equal(mp_from_jax(J.to_limbs(vals)), t)
    assert np.array_equal(mp_to_jax(t), J.to_limbs(vals))
    back = P.from_limbs(t)
    assert all(list(back[:, j]) == list(vals[j]) for j in range(40))


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_mp_ops_match_jax(fields, op):
    """K14's plain version against MultiPrimeField.mul / add / sub, on
    full operands and on one constant a lane broadcast over the rows."""
    J, P = fields
    rng = np.random.default_rng(2)
    a, b = _residues(P, rng, 60), _residues(P, rng, 60)
    ja, jb = J.to_limbs(a), J.to_limbs(b)
    ta, tb = P.to_limbs(a, "cpu"), P.to_limbs(b, "cpu")
    got = getattr(P, op)(ta.reshape(VS, 3, 20, 1), tb.reshape(VS, 3, 20, 1))
    want = getattr(J, op)(jnp.asarray(ja), jnp.asarray(jb))
    assert torch.equal(got.reshape(VS, 60, 1), mp_from_jax(np.asarray(want)))
    c = P.to_limbs(_residues(P, rng, 1)[0], "cpu")         # [VS, 1]
    got = getattr(P, op)(ta, c)
    want = getattr(J, op)(jnp.asarray(ja), jnp.asarray(mp_to_jax(c))[
        :, :, None])
    assert torch.equal(got, mp_from_jax(np.asarray(want)))


def test_crt_ntt_round_trip(fields):
    """fftb(fftf(x)) = n x in every lane (K4 [crt]'s plain version)."""
    _, P = fields
    rng = np.random.default_rng(3)
    n = 64
    x = P.to_limbs(_residues(P, rng, 2 * n), "cpu").reshape(VS, 2, n, 1)
    ntt = NTT(P, P.omegas, P.omega_order, "cpu")
    y = ntt.fftb(ntt.fftf(x))
    assert torch.equal(y, P.mul(x, P.to_limbs(P.of_scalar(n), "cpu")))


def test_to_from_crt_match_jax():
    """K13's and K15's plain versions against CRTContext.to_crt and
    from_crt on seeded secp256k1 elements and residues."""
    F, JF = p256k1_base(), jax_p256k1()
    ctx, jctx = crt_conv.CRTContext(F, device="cpu"), jcc.CRTContext(JF)
    rng = np.random.default_rng(4)
    x = F.to_limbs(_elts(F, rng, 60), "cpu").reshape(3, 20, F.nlimb)
    z = ctx.to_crt(x)
    assert z.shape == (VS, 3, 20, 1)
    assert torch.equal(z, mp_from_jax(np.asarray(
        jctx.to_crt(jnp.asarray(limbs_to_jax(x))))))
    assert torch.equal(ctx.from_crt(z), x)
    r = ctx.mp.to_limbs(_residues(ctx.mp, rng, 60), "cpu").reshape(
        VS, 3, 20, 1)
    assert torch.equal(ctx.from_crt(r), limbs_from_jax(np.asarray(
        jctx.from_crt(jnp.asarray(mp_to_jax(r))))))


@pytest.mark.parametrize("n,m", [(5, 17), (12, 40)])
def test_crt_reed_solomon_matches_jax(n, m):
    """ReedSolomon with the CRT convolution (rs_factory_for(F))
    against the JAX ReedSolomon with make_crt_convolution_factory."""
    F, JF = p256k1_base(), jax_p256k1()
    rng = np.random.default_rng(5 + n)
    y = F.to_limbs(_elts(F, rng, 3 * n), "cpu").reshape(3, n, F.nlimb)
    rs = rs_factory_for(F, device="cpu")(n, m)
    jrs = JaxReedSolomon(n, m, JF, jcc.make_crt_convolution_factory(JF))
    got = rs.interpolate(y)
    assert isinstance(rs, ReedSolomon)
    assert torch.equal(got, limbs_from_jax(np.asarray(
        jrs.interpolate(jnp.asarray(limbs_to_jax(y))))))
    assert torch.equal(got[:, :n], y)


@pytest.mark.parametrize("op", ["mul", "add", "sub", "from_mont"])
def test_p256k1_field_ops_match_jax(op):
    """The secp256k1 field's plain versions (K1 [fp256k1] on the card)
    against the JAX PrimeField, with the values next to p."""
    F, JF = p256k1_base(), jax_p256k1()
    assert KERNEL_TAGS[P256K1] == F.tag == "fp256k1"
    assert F.name == JF.name and F.kBytes == JF.kBytes == 32
    rng = np.random.default_rng(6)
    a = _elts(F, rng, 50) + [F.p - 2, F.p - (1 << 32)]
    b = list(reversed(a))
    ta, tb = F.to_limbs(a, "cpu"), F.to_limbs(b, "cpu")
    ja, jb = (jnp.asarray(limbs_to_jax(t)) for t in (ta, tb))
    if op == "from_mont":
        got, want = F.from_mont(ta), JF.from_mont_device(ja)
    else:
        got, want = getattr(F, op)(ta, tb), getattr(JF, op)(ja, jb)
    assert torch.equal(got, limbs_from_jax(np.asarray(want)))
    if op == "mul":
        assert list(F.from_limbs(got)) == [x * y % F.p for x, y in zip(a, b)]


def test_p256k1_sums_near_p():
    """Sums of many elements next to p (R - p = 2^32 + 977): the segment
    and axis sums' plain versions against host ints."""
    F = p256k1_base()
    vals = [F.p - 1 - i for i in range(300)]
    x = F.to_limbs(vals, "cpu")
    starts = torch.tensor([0, 7, 100], dtype=torch.int32)
    ends = torch.tensor([7, 100, 300], dtype=torch.int32)
    got = F.from_limbs(F.lazy_segment_sum(x, starts, ends))
    assert list(got) == [sum(vals[s:e]) % F.p for s, e in
                         ((0, 7), (7, 100), (100, 300))]
    assert F.from_limbs(F.lazy_sum(x.reshape(3, 100, F.nlimb), 1)).tolist() \
        == [sum(vals[100 * i : 100 * i + 100]) % F.p for i in range(3)]
    assert fpm.axis_sum_plain(F, x, 0).shape == (F.nlimb,)


def test_header_constants():
    """csrc/fp.cuh's secp256k1 constants (p, -p^-1 mod 2^32, R mod p,
    R^2 mod p with R = 2^256) and csrc/mp.cuh's table of basis primes
    with their -p^-1 mod 2^32."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "longfellow_zk_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "fp.cuh")).read()
    body = src[src.index("struct P256K1 {"):]
    body = body[: body.index("\n};")]
    p, R = P256K1, 1 << 256
    assert int(re.search(r"int N = (\d+);", body).group(1)) == 8
    n0inv = int(re.search(r"N0INV = (0x[0-9A-F]+)u", body).group(1), 16)
    assert n0inv == (-pow(p, -1, 1 << 32)) % (1 << 32) == 0xD2253531

    def table(fn):
        m = re.search(r"uint32_t %s\(int j\) \{(?: *//[^\n]*)?\s*"
                      r"const uint32_t v\[8\] = \{([^}]*)\}" % fn, body)
        words = [int(w.strip().rstrip("u"), 16)
                 for w in m.group(1).split(",")]
        return sum(w << (32 * i) for i, w in enumerate(words))

    assert (table("p"), table("one"), table("r2")) == (p, R % p, R * R % p)
    mp_src = open(os.path.join(csrc, "mp.cuh")).read()
    pairs = re.findall(r"\{(0x[0-9A-F]+)u, (0x[0-9A-F]+)u\}", mp_src)
    assert int(re.search(r"#define MP_MAX (\d+)", mp_src).group(1)) == \
        len(pairs) == mpm.MP_MAX
    for (ps, ns), q in zip(pairs, mpm.crt_primes(mpm.MP_MAX)):
        assert int(ps, 16) == q
        assert int(ns, 16) == (-pow(q, -1, 1 << 32)) % (1 << 32)
        assert (1 << 31) < q < (1 << 32)
