"""The port's CUDA kernels (K1-K24, every instance) against their plain
PyTorch versions, on the card.  Field arithmetic, hashing and the
Fiat-Shamir states are exact: equality, tolerance 0.

These tests need an NVIDIA GPU and nvcc; without a card they skip.  On a
machine with one (and no JAX, which tests/conftest.py imports):

    python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -m cuda -q
"""

import numpy as np
import pytest
import torch

from longfellow_zk_tpu_torch import kernels
from longfellow_zk_tpu_torch.fields import fp as fpm
from longfellow_zk_tpu_torch.fields.fp2 import (
    MUL_BASE, Fp2, fp2_elementwise, fp2_elementwise_plain, fp2_inv_plain)
from longfellow_zk_tpu_torch.fields.fp_instances import (
    P128_OMEGA, P128_OMEGA_ORDER, P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X,
    P256_FP2_ROOT_Y, fp64, fp128, p256_base, p256_scalar, p256k1_base,
    p256k1_scalar, p384_base, p521_base)
from longfellow_zk_tpu_torch.fields import fp24 as f24m
from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
from longfellow_zk_tpu_torch.fields import multiprime as mpm
from longfellow_zk_tpu_torch.merkle.merkle_dev import merkle_heap
from longfellow_zk_tpu_torch.merkle.sha256_dev import (
    sha256_msgs, sha256_msgs_plain)
from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.utils.crypto import SHA256
from longfellow_zk_tpu_torch.sumcheck import verifier
from longfellow_zk_tpu_torch.transforms import crt_conv, lch14
from longfellow_zk_tpu_torch.transforms import matmul_ntt as mnt
from longfellow_zk_tpu_torch.transforms import nussbaumer as nbm
from longfellow_zk_tpu_torch.transforms import rfft as rfm
from longfellow_zk_tpu_torch.transforms.ntt import (
    NTT, fp_ntt, ntt_plain, ntt_plan, ntt_plan_two, ntt_run)
from longfellow_zk_tpu_torch.zk import fused


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    kernels.build_all()
    return torch.device("cuda")


FIELDS = {"fp128": fp128, "fp256": p256_base, "fp256k1": p256k1_base,
          "gf2_128": gf2_128}


def _elts(F, rng, n, dev):
    """n field elements from a numpy seed, with 0, 1 and p - 1 (for
    GF(2^128) all ones) first."""
    if F.kCharacteristicTwo:
        vals = [0, 1, (1 << 128) - 1] + [
            int.from_bytes(rng.bytes(16), "little") for _ in range(n)]
    else:
        vals = [0, 1, F.p - 1] + [
            int.from_bytes(rng.bytes(4 * F.nlimb), "little") % F.p
            for _ in range(n)]
    return F.to_limbs(vals[:n], dev)


def _elts2(F2, rng, n, dev):
    """n Fp2 elements [n, 2, N] from a numpy seed."""
    return torch.stack([_elts(F2.f, rng, n, dev),
                        _elts(F2.f, rng, n, dev).flip(0)], dim=-2)


def _same(a, b):
    torch.cuda.synchronize()
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("mode", [fpm.MUL, fpm.ADD, fpm.SUB])
def test_k1_arith(dev, mode, field):
    F, rng = FIELDS[field](), np.random.default_rng(1)
    P = fpm.plain_of(F)
    N = F.nlimb
    a = _elts(F, rng, 5000, dev)
    b = _elts(F, rng, 5000, dev).flip(0).contiguous()
    _same(fpm.fp_elementwise(F, mode, a, b),
          P.elementwise_plain(F, mode, a, b))
    # broadcast: a column [rows, 1] and a row [n] over [rows, n]
    m = a[:4000].reshape(40, 100, N)
    col, row = b[:40].reshape(40, 1, N), b[:100]
    # (rows, 1, 2) over (rows, 5, 2) is not one block of dims: b is
    # materialised
    m3, b3 = a[:400].reshape(40, 5, 2, N), b[:80].reshape(40, 1, 2, N)
    for x, y in ((m, col), (m, row), (m, b[0]), (row, m), (m3, b3)):
        _same(fpm.fp_elementwise(F, mode, x, y),
              P.elementwise_plain(F, mode, x, y))


@pytest.mark.parametrize("field", list(FIELDS))
def test_k1_bind_hv(dev, field):
    _check_bind_hv(FIELDS[field](), dev)


def _check_bind_hv(F, dev):
    rng = np.random.default_rng(2)
    P = fpm.plain_of(F)
    x = _elts(F, rng, 4096, dev)
    r = _elts(F, rng, 7, dev)[5]
    _same(F.bind(x, r), P.elementwise_plain(F, fpm.BIND, x, r))
    h = torch.as_tensor(rng.integers(0, 1 << 15, 3000, dtype=np.int32),
                        device=dev)
    hv = _elts(F, rng, 3000, dev)
    _same(F.hv_update(hv, h, r), P.elementwise_plain(F, fpm.HV, hv, r, h))


def _segments(rng, nseg, T, dev):
    g = np.sort(rng.integers(0, nseg, T))
    g[: T // 10] = 3  # one long segment
    g = np.sort(g)
    s = np.searchsorted(g, np.arange(nseg), "left").astype(np.int32)
    e = np.searchsorted(g, np.arange(nseg), "right").astype(np.int32)
    return (torch.as_tensor(s, device=dev), torch.as_tensor(e, device=dev))


@pytest.mark.parametrize("field", list(FIELDS))
def test_k2_segment_sum(dev, field):
    F, rng = FIELDS[field](), np.random.default_rng(3)
    P = fpm.plain_of(F)
    x = _elts(F, rng, 20000, dev)
    s, e = _segments(rng, 3000, 20000, dev)   # some segments are empty
    _same(F.lazy_segment_sum(x, s, e), P.segment_sum_plain(F, x, s, e))


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("bad", [False, True])
def test_k2_eval_layer(dev, bad, field):
    F, rng = FIELDS[field](), np.random.default_rng(4)
    P = fpm.plain_of(F)
    T, nw, nseg = 20000, 1 << 12, 1 << 11
    W = _elts(F, rng, nw, dev)
    W[7] = 0  # beta-masked terms read a zero product
    h0 = torch.as_tensor(rng.integers(0, nw, T, dtype=np.int32), device=dev)
    h1 = torch.as_tensor(rng.integers(0, nw, T, dtype=np.int32), device=dev)
    bm = torch.as_tensor(rng.random(T) < 0.1, device=dev)
    h0[bm] = 7
    if bad:
        h0[int(torch.nonzero(bm)[0])] = 8
    v = _elts(F, rng, T, dev)
    s, e = _segments(rng, nseg, T, dev)
    V, ok = fpm.fp_eval_layer(F, W, h0, h1, v, bm, s, e)
    V2, ok2 = P.eval_layer_plain(F, W, h0, h1, v, bm, s, e)
    _same(V, V2)
    assert bool(ok) == bool(ok2) == (not bad)


@pytest.mark.parametrize("field", list(FIELDS))
def test_k3_wire_and_sums(dev, field):
    F, rng = FIELDS[field](), np.random.default_rng(5)
    P = fpm.plain_of(F)
    T, N = 70000, 1 << 14
    hv = _elts(F, rng, T, dev)
    Wh = _elts(F, rng, N, dev)
    Wo = _elts(F, rng, N, dev)
    h = torch.as_tensor(rng.integers(0, N, T, dtype=np.int32), device=dev)
    ho = torch.as_tensor(rng.integers(0, N, T, dtype=np.int32), device=dev)
    _same(fpm.fp_wire_sums(F, hv, Wh, Wo, h, ho),
          P.wire_sums_plain(F, hv, Wh, Wo, h, ho))
    x = hv[:68100].reshape(10, 15, 454, F.nlimb)
    for dim in (0, 1, 2):
        _same(F.lazy_sum(x, dim), P.axis_sum_plain(F, x, dim))
    _same(F.lazy_sum(hv, 0), P.axis_sum_plain(F, hv, 0))


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("T", [0, 1, 70000, 300000])
def test_k7_quad_bind(dev, field, T):
    """K7 against its plain version, one launch a call (the last block
    sums the partials; 1,024 blocks at 300,000 terms), twice back to back
    on the same scratch, the tickets left zero."""
    F, rng = FIELDS[field](), np.random.default_rng(10)
    nv, nw = 1 << 9, 1 << 12
    g = torch.as_tensor(np.sort(rng.integers(0, nv, T)), device=dev)
    h0, h1 = (torch.as_tensor(rng.integers(0, nw, T, dtype=np.int32),
                              device=dev) for _ in range(2))
    v = _elts(F, rng, T, dev)
    bmask = torch.as_tensor(rng.random(T) < 0.1, device=dev)
    dot, eqh0, eqh1 = (_elts(F, rng, n, dev) for n in (nv, nw, nw))
    beta = _elts(F, rng, 5, dev)[4]
    args = (g, h0, h1, v, bmask, dot, eqh0, eqh1, beta)
    n0 = kernels.LAUNCHES["fp_quad_bind[%s]" % F.tag]
    want = verifier.quad_bind_plain(F, *args)
    _same(verifier.fp_quad_bind(F, *args), want)
    _same(verifier.fp_quad_bind(F, *args), want)
    assert kernels.LAUNCHES["fp_quad_bind[%s]" % F.tag] - n0 == 2
    _k3_scratch_clear()


@pytest.mark.parametrize("n", [2, 64, 2048])
def test_k4_ntt(dev, n):
    F, rng = fp128(), np.random.default_rng(6)
    x = _elts(F, rng, 18 * n, dev).reshape(18, n, 4)
    for inverse in (False, True):
        tw = NTT(F, P128_OMEGA, P128_OMEGA_ORDER, dev).twiddles(n, inverse)
        _same(fp_ntt(F, x, tw), ntt_plain(F, x, tw))


@pytest.mark.parametrize("n", [2, 64, 2048])
def test_k4_ntt_fp2(dev, n):
    F2, rng = Fp2(p256_base()), np.random.default_rng(7)
    x = _elts2(F2, rng, 14 * n, dev).reshape(14, n, 2, F2.nlimb)
    ntt = NTT(F2, (P256_FP2_ROOT_X, P256_FP2_ROOT_Y), P256_FP2_ROOT_ORDER,
              dev)
    for inverse in (False, True):
        tw = ntt.twiddles(n, inverse)
        _same(fp_ntt(F2, x, tw), ntt_plain(F2, x, tw))


def _k4_case(inst, rows, n, dev, rng):
    """(field, rows x n elements, twiddles of both directions) of K4
    instance inst; [crt] rows come in 18 lanes (one lane at 1 row)."""
    if inst == "fp128":
        F = fp128()
        x = _elts(F, rng, rows * n, dev).reshape(rows, n, 4)
        ntt = NTT(F, P128_OMEGA, P128_OMEGA_ORDER, dev)
    elif inst == "fp256x2":
        F = Fp2(p256_base())
        x = _elts2(F, rng, rows * n, dev).reshape(rows, n, 2, F.nlimb)
        ntt = NTT(F, (P256_FP2_ROOT_X, P256_FP2_ROOT_Y), P256_FP2_ROOT_ORDER,
                  dev)
    else:
        F = mpm.MultiPrimeField(18 if rows % 18 == 0 else 1)
        x = _residues(F, rng, (rows // F.vs, n), dev).reshape(rows, n, 1)
        ntt = NTT(F, F.omegas, F.omega_order, dev)
    return F, x, [ntt.twiddles(n, inv) for inv in (False, True)]


@pytest.mark.parametrize("rows", [1, 18, 450])
@pytest.mark.parametrize("inst", ["fp128", "fp256x2", "crt"])
def test_k4_ntt_one_launch(dev, inst, rows):
    """K4 at n = 2^1 .. 2^12 against its plain version, both directions,
    one launch a call where a cluster holds a row (ntt_plan: all these
    but 2^12 Fp2 points at one row), two elsewhere; route 2 (the
    four-step split through a scratch, two launches) at the same
    shapes."""
    rng = np.random.default_rng(280 + rows)
    name = "fp_ntt[%s]" % inst
    for logn in range(1, 13):
        n = 1 << logn
        F, x, tws = _k4_case(inst, rows, n, dev, rng)
        eb = 4 * int(np.prod(F.elt_shape))
        for tw in tws:
            want = ntt_plain(F, x, tw)
            for planner in (ntt_plan, ntt_plan_two):
                plan = planner(n, rows, eb)
                n0 = kernels.LAUNCHES[name]
                got = ntt_run(F, x, tw, planner)
                assert kernels.LAUNCHES[name] - n0 == plan.launches <= 2
                assert planner is ntt_plan_two or plan.launches == 1
                _same(got, want)


@pytest.mark.parametrize("logn", [14, 16, 20])
@pytest.mark.parametrize("inst", ["fp128", "fp256x2"])
def test_k4_ntt_long_rows(dev, inst, logn):
    """K4 on one row of 2^14, 2^16 and 2^20 points (route 2 past a
    cluster's tiles; bench.py's phase_fft takes 2^20) against its plain
    version, in two launches or one."""
    F, x, tws = _k4_case(inst, 1, 1 << logn, dev,
                         np.random.default_rng(290 + logn))
    n0 = kernels.LAUNCHES["fp_ntt[%s]" % inst]
    _same(fp_ntt(F, x, tws[0]), ntt_plain(F, x, tws[0]))
    assert kernels.LAUNCHES["fp_ntt[%s]" % inst] - n0 == ntt_plan(
        1 << logn, 1, 4 * int(np.prod(F.elt_shape))).launches


def _residues(mp, rng, shape, dev):
    """Residues [VS, *shape, 1] from a numpy seed, each lane below its
    prime, with 0, 1 and p_b - 1 first."""
    n = int(np.prod(shape))
    vals = [np.array([v % p if v >= 0 else p - 1 for p in mp.primes],
                     dtype=object) for v in (0, 1, -1)]
    vals += [np.array([int(rng.integers(0, p)) for p in mp.primes],
                      dtype=object) for _ in range(n)]
    return mp.to_limbs(vals[:n], dev).reshape((mp.vs,) + tuple(shape) + (1,))


@pytest.mark.parametrize("vs", [18, 26, 35])
@pytest.mark.parametrize("n", [2, 64, 4096])
def test_k4_ntt_crt(dev, n, vs):
    """K4 [crt]: every lane's rows under its own prime and twiddles, at
    the bases of the 256-bit fields, P-384 and P-521."""
    mp, rng = mpm.MultiPrimeField(vs), np.random.default_rng(11)
    x = _residues(mp, rng, (3, n), dev).reshape(vs * 3, n, 1)
    ntt = NTT(mp, mp.omegas, mp.omega_order, dev)
    for inverse in (False, True):
        tw = ntt.twiddles(n, inverse)
        _same(fp_ntt(mp, x, tw), ntt_plain(mp, x, tw))


@pytest.mark.parametrize("vs", [18, 26, 35])
@pytest.mark.parametrize("mode", [mpm.MUL, mpm.ADD, mpm.SUB])
def test_k14_mp_elementwise(dev, mode, vs):
    """K14 on full operands, on a per-lane table broadcast over rows (the
    convolution's product) and on one constant a lane."""
    mp, rng = mpm.MultiPrimeField(vs), np.random.default_rng(12)
    a = _residues(mp, rng, (5, 300), dev)
    for b in (_residues(mp, rng, (5, 300), dev),
              _residues(mp, rng, (300,), dev), _residues(mp, rng, (), dev)):
        _same(mpm.mp_elementwise(mp, mode, a, b),
              mpm.mp_elementwise_plain(mp, mode, a, b))


# the target fields of K13 and K15
CRT_FIELDS = {"fp256k1": p256k1_base, "p256n": p256_scalar,
              "fp256": p256_base, "p384": p384_base, "p521": p521_base}


@pytest.mark.parametrize("field", list(CRT_FIELDS))
def test_k13_k15_crt_conversions(dev, field):
    """K13 (to_crt) and K15 (from_crt) of each target field's elements;
    from_crt of to_crt is the identity."""
    F, rng = CRT_FIELDS[field](), np.random.default_rng(13)
    ctx = crt_conv.CRTContext(F, device=dev)
    x = _elts(F, rng, 3 * 700, dev).reshape(3, 700, F.nlimb)
    z = ctx.to_crt(x)
    _same(z, crt_conv.to_crt_plain(ctx, x))
    _same(ctx.from_crt(z), x)
    r = _residues(ctx.mp, rng, (3, 700), dev)
    _same(ctx.from_crt(r), crt_conv.from_crt_plain(ctx, r))


@pytest.mark.parametrize("mode", [fpm.MUL, fpm.ADD, fpm.SUB, MUL_BASE])
def test_k5_fp2(dev, mode):
    F2, rng = Fp2(p256_base()), np.random.default_rng(8)
    N = F2.nlimb
    a = _elts2(F2, rng, 3000, dev)
    if mode == MUL_BASE:
        b = _elts(F2.f, rng, 3000, dev)
        row, col = b[:100], b[:30].reshape(30, 1, N)
    else:
        b = _elts2(F2, rng, 3000, dev).flip(0).contiguous()
        row, col = b[:100], b[:30].reshape(30, 1, 2, N)
    _same(fp2_elementwise(F2, mode, a, b),
          fp2_elementwise_plain(F2, mode, a, b))
    # broadcast over [rows, n], as the yhat table and the RS lead vector
    m = a.reshape(30, 100, 2, N)
    for y in (row, col):
        _same(fp2_elementwise(F2, mode, m, y),
              fp2_elementwise_plain(F2, mode, m, y))


@pytest.mark.parametrize("n,m,rows", [(5, 13, 3), (29, 64, 7),
                                      (461, 4151, 5), (921, 4151, 3)])
def test_k6_lch14(dev, n, m, rows):
    F, rng = gf2_128(), np.random.default_rng(9)
    y = _elts(F, rng, rows * n, dev).reshape(rows, n, 4)
    rs = lch14.LCH14ReedSolomon(n, m, F, dev)
    _same(rs.interpolate(y),
          lch14.lch14_plain(F, lch14.EXTEND, y, rs.sched, m))
    x = _elts(F, rng, rows * 64, dev).reshape(rows, 64, 4)
    L = lch14.LCH14(F)
    for passes in (L._stages(0, 6, 128, True), L._stages(0, 6, 64, False),
                   L._bidir(0, 6, 0, 29)):
        sched = lch14.Schedule(F, 64, passes, len(passes), 0, dev)
        _same(lch14.gf2_lch14(F, lch14.TRANSFORM, x, sched, 64),
              lch14.lch14_plain(F, lch14.TRANSFORM, x, sched, 64))


@pytest.mark.parametrize("mlen", [0, 1, 55, 56, 64, 119, 320, 4288])
def test_k8_sha256(dev, mlen):
    rng = np.random.default_rng(10)
    m = torch.as_tensor(rng.integers(0, 256, (300, mlen), dtype=np.uint8),
                        device=dev)
    _same(sha256_msgs(m), sha256_msgs_plain(m))
    leaves = torch.as_tensor(rng.integers(0, 256, (77, 32), dtype=np.uint8))
    _same(merkle_heap(leaves.to(dev)), merkle_heap(leaves))


def _fs_pair(rng, dev):
    """The same random transcript state twice on the card."""
    ts = Transcript(rng.bytes(5))
    ts.write_bytes(rng.bytes(int(rng.integers(0, 200))))
    fs = dfs.fs_init_from_host(ts, dev)
    return fs, fs.clone()


@pytest.mark.parametrize("field", list(FIELDS))
def test_k9_fs_oracle(dev, field):
    """Every mode of K9 against the plain version, from random states, at
    absorb lengths that cross the 55/56/64-byte boundaries."""
    F, rng = FIELDS[field](), np.random.default_rng(11)
    for n in (1, 7, 55, 56, 63, 64, 65, 130):
        fs, fs2 = _fs_pair(rng, dev)
        data = torch.as_tensor(rng.integers(0, 256, n, dtype=np.uint8),
                               device=dev)
        dfs.fs_absorb(F, fs, data)
        dfs.fs_absorb_plain(F, fs2, data)
        _same(fs, fs2)
        _same(dfs.fs_getkey(F, fs), dfs.fs_getkey_plain(F, fs2))
        xs = _elts(F, rng, n % 9 + 4, dev)
        dfs.fs_write_elts(F, fs, xs)
        dfs.fs_write_elts_plain(F, fs2, xs)
        _same(fs, fs2)
        dfs.write_tagged_elts(F, fs, xs)
        dfs.write_tagged_elts_plain(F, fs2, xs)
        _same(fs, fs2)
        prf, prf2 = dfs.new_prf(dev), dfs.new_prf(dev)
        dfs.fs_squeeze(F, fs, prf)
        dfs.fs_squeeze_plain(F, fs2, prf2)
        _same(prf, prf2)
        _same(dfs.prf_bytes(F, prf, n), dfs.prf_bytes_plain(F, prf2, n))
        _same(prf, prf2)
        _same(dfs.dev_sample_elts(F, prf, 40),
              dfs.dev_sample_elts_plain(F, prf2, 40))
        _same(prf, prf2)
        out = dfs.dev_sample_elts(F, prf, 3, fs=fs)
        dfs.fs_squeeze_plain(F, fs2, prf2)
        _same(out, dfs.dev_sample_elts_plain(F, prf2, 3))
        _same(prf, prf2)
        key = dfs.fs_getkey(F, fs)
        dfs.prf_fresh(F, prf, key)
        dfs.prf_fresh_plain(F, prf2, key)
        _same(prf, prf2)


@pytest.mark.parametrize("field", list(FIELDS))
def test_k10_round_tail(dev, field):
    F, rng = FIELDS[field](), np.random.default_rng(12)
    consts = fpm.round_consts(F, dev)
    for _ in range(6):
        fs, fs2 = _fs_pair(rng, dev)
        x = _elts(F, rng, 10, dev)[3:]   # random elements
        claim, eq0 = x[0].clone(), x[1]
        claim2 = claim.clone()
        a, pad = x[2:4], x[4:7]
        row = torch.empty((4, F.nlimb), dtype=torch.int32, device=dev)
        row2 = torch.empty_like(row)
        dfs.round_tail(F, fs, claim, row, a, eq0, pad, consts)
        dfs.round_tail_plain(F, fs2, claim2, row2, a, eq0, pad, consts)
        _same(fs, fs2)
        _same(claim, claim2)
        _same(row, row2)


@pytest.mark.parametrize("field", list(FIELDS))
def test_k10_cubic_round_tail(dev, field):
    F, rng = FIELDS[field](), np.random.default_rng(16)
    consts = fpm.round_consts(F, dev)
    for _ in range(6):
        fs, fs2 = _fs_pair(rng, dev)
        x = _elts(F, rng, 11, dev)[3:]   # random elements
        claim = x[0].clone()
        claim2 = claim.clone()
        c, pad = x[1:4], x[4:8]
        row = torch.empty((5, F.nlimb), dtype=torch.int32, device=dev)
        row2 = torch.empty_like(row)
        dfs.round_tail_cubic(F, fs, claim, row, c, pad, consts)
        dfs.round_tail_cubic_plain(F, fs2, claim2, row2, c, pad, consts)
        _same(fs, fs2)
        _same(claim, claim2)
        _same(row, row2)


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("C,T", [(2, 1), (4, 0), (8, 3000), (64, 9000)])
def test_k16_copy_round_sums(dev, field, C, T):
    """K16 against its plain version on random layers (repeated indices,
    a zero-padded copy tail), twice in a row (the count of blocks done
    is left at zero for the next launch)."""
    F, rng = FIELDS[field](), np.random.default_rng(C + T)
    nw = 700
    EQ = _elts(F, rng, C, dev)
    EQ[C - 1] = 0
    W = _elts(F, rng, nw * C, dev).reshape(nw, C, -1)
    h0, h1 = (torch.as_tensor(rng.integers(0, nw, T, dtype=np.int32),
                              device=dev) for _ in range(2))
    hv = _elts(F, rng, T, dev) if T else F.zeros((0,), dev)
    for _ in range(2):
        _same(fpm.fp_copy_round_sums(F, EQ, W, h0, h1, hv),
              fpm.copy_round_sums_plain(F, EQ, W, h0, h1, hv))


@pytest.mark.parametrize("field", list(FIELDS))
def test_k9_choose(dev, field):
    """K9 mode 9 against its plain version from random states: the
    indices, the stream state after the walk, fs untouched, twice in a
    row; n up to the mdoc hash proof's 3,230 and one whose walk array
    does not fit in shared memory."""
    F, rng = FIELDS[field](), np.random.default_rng(13)
    for n, k in ((2, 2), (255, 40), (300, 100), (3230, 132), (20000, 64)):
        fs, fs2 = _fs_pair(rng, dev)
        prf, prf2 = dfs.new_prf(dev), dfs.new_prf(dev)
        _same(dfs.dev_choose(F, fs, prf, n, k),
              dfs.dev_choose_plain(F, fs2, prf2, n, k))
        _same(prf, prf2)
        _same(fs, fs2)
        _same(dfs.dev_choose(F, fs, prf, n, min(n, 3)),
              dfs.dev_choose_plain(F, fs2, prf2, n, min(n, 3)))
        _same(prf, prf2)


def _fused_stat(logws, ninputs, npub):
    """A FusedStatic of a circuit with layers of these logw (no terms:
    K11 and K12 read only the geometry)."""
    from longfellow_zk_tpu_torch.ligero.param import LigeroParam
    from longfellow_zk_tpu_torch.sumcheck.circuit import Circuit, Layer
    from longfellow_zk_tpu_torch.zk.common import pad_size, setup_lqc

    circ = Circuit(nv=1, logv=0, nc=1, logc=0, nl=len(logws),
                   ninputs=ninputs, npub_in=npub, subfield_boundary=0,
                   layers=[Layer(nw=1 << lw, logw=lw, quad=None)
                           for lw in logws])
    nw = ninputs - npub
    p = LigeroParam(nw=nw + pad_size(circ), nq=circ.nl, rateinv=4,
                    nreq=16)
    return fused.FusedStatic(circ, p, setup_lqc(circ, nw), nw)


@pytest.mark.parametrize("field", list(FIELDS))
def test_k11_k12_constraints_and_inner_product(dev, field):
    """K11 and K12 against their plain versions on random rows, claims,
    pads and challenges, with layers of logw 19 (96 threads a block), 3,
    1 and 10."""
    F, rng = FIELDS[field](), np.random.default_rng(14)
    N = F.nlimb
    stat = _fused_stat([19, 3, 1, 10], 5000, 7)
    R, nl = int(stat.lay[:, 0].sum()), stat.lay.shape[0]
    rows = _elts(F, rng, R * 8, dev).reshape(R, 2, 4, N)
    scal = _elts(F, rng, 4 * nl, dev).flip(0).reshape(nl, 4, N)
    wcpad = _elts(F, rng, 2 * nl, dev).reshape(nl, 2, N)
    tabs = fused.prepare(F, stat, dev)
    _same(fused.zk_constraints(F, tabs, rows, scal, wcpad),
          fused.constraints_plain(F, stat.lay, rows, scal, wcpad, tabs.lag))
    p = stat.p
    k = _elts(F, rng, len(stat.ws), dev).flip(0).contiguous()
    alphal = _elts(F, rng, stat.nl_constraints, dev)
    alphaq = _elts(F, rng, 3 * p.nq + 3, dev)[3:]
    _same(fused.ligero_inner_product(F, tabs, k, alphal, alphaq),
          fused.inner_product_plain(F, tabs.ptr, tabs.ent, k, alphal,
                                    alphaq, p.nwqrow, p.r, p.w))


# ----------------------------------------------------------------------
# the lane axis of K1's bind and hv, K3, K9 (mode 9 too), K10, K11 and
# K12: the proofs of a batch in one launch, against the plain versions
# (K9's and K10's loop over the lanes with the one-lane code)
# ----------------------------------------------------------------------

# a label whose transcript's first Fp128 draw is >= p (found by a host
# search; tests/test_torch_device_fs.py REJECT_LABEL)
REJECT_LABEL = b"reject-1044179"


@pytest.mark.parametrize("field", list(FIELDS))
def test_lanes_k1_k3(dev, field):
    """Bind and hv with one challenge a lane, read from a strided view of
    a rows tensor as the sumcheck passes them; K3's wire sums of 8 lanes
    with Wh and Wo of different lengths."""
    F, rng, B = FIELDS[field](), np.random.default_rng(15), 8
    P = fpm.plain_of(F)
    N = F.nlimb
    rows = _elts(F, rng, B * 9 * 8, dev).reshape(B, 9, 2, 4, N)
    r = rows[:, 4, 1, 3]
    x = _elts(F, rng, B * 2048, dev).reshape(B, 2048, N)
    _same(F.bind(x, r), P.elementwise_plain(F, fpm.BIND, x, r))
    T = 9000
    hv = _elts(F, rng, B * T, dev).reshape(B, T, N)
    h = torch.as_tensor(rng.integers(0, 1024, T, dtype=np.int32), device=dev)
    ho = torch.as_tensor(rng.integers(0, 2048, T, dtype=np.int32),
                         device=dev)
    _same(F.hv_update(hv, h, r), P.elementwise_plain(F, fpm.HV, hv, r, h))
    Wh, Wo = x[:, :1024].contiguous(), x.flip(1).contiguous()
    _same(fpm.fp_wire_sums(F, hv, Wh, Wo, h, ho),
          P.wire_sums_plain(F, hv, Wh, Wo, h, ho))


def _fs_lanes(rng, dev, B):
    """B random transcript states [B, 104] on the card and on the CPU,
    lane 1 from REJECT_LABEL (its first Fp128 draw rejects)."""
    states = []
    for b in range(B):
        ts = Transcript(REJECT_LABEL if b == 1 else rng.bytes(5))
        if b != 1:
            ts.write_bytes(rng.bytes(int(rng.integers(0, 200))))
        states.append(dfs.fs_init_from_host(ts, "cpu"))
    fs = torch.stack(states)
    return fs.clone().to(dev), fs


@pytest.mark.parametrize("field", list(FIELDS))
def test_lanes_k9_k10(dev, field):
    """K9's modes, its column choice and K10 over 8 lanes (one of them
    rejecting) against the plain versions on the CPU, whole states
    compared."""
    F, rng, B = FIELDS[field](), np.random.default_rng(16), 8
    N = F.nlimb
    fs, fs2 = _fs_lanes(rng, dev, B)
    prf, prf2 = dfs.new_prf(dev, B), dfs.new_prf("cpu", B)
    _same(dfs.dev_sample_elts(F, prf, 80, fs=fs),
          dfs.dev_sample_elts(F, prf2, 80, fs=fs2))
    _same(prf, prf2)
    for data in (rng.integers(0, 256, 57, dtype=np.uint8),
                 rng.integers(0, 256, (B, 9), dtype=np.uint8)):
        dfs.fs_absorb(F, fs, torch.as_tensor(data, device=dev))
        dfs.fs_absorb(F, fs2, torch.as_tensor(data))
    xs = _elts(F, rng, B * 5, dev).reshape(B, 5, N)
    dfs.fs_write_elts(F, fs, xs)
    dfs.fs_write_elts(F, fs2, xs.cpu())
    dfs.write_tagged_elts(F, fs, xs)
    dfs.write_tagged_elts(F, fs2, xs.cpu())
    _same(fs, fs2)
    _same(dfs.fs_getkey(F, fs), dfs.fs_getkey(F, fs2))
    dfs.fs_squeeze(F, fs, prf)
    dfs.fs_squeeze(F, fs2, prf2)
    _same(dfs.prf_bytes(F, prf, 33), dfs.prf_bytes(F, prf2, 33))
    _same(dfs.dev_sample_elts(F, prf, 3), dfs.dev_sample_elts(F, prf2, 3))
    key = dfs.fs_getkey(F, fs)
    dfs.prf_fresh(F, prf, key)
    dfs.prf_fresh(F, prf2, key.cpu())
    _same(prf, prf2)
    for n, k in ((1367, 128), (20000, 16)):
        _same(dfs.dev_choose(F, fs, prf, n, k),
              dfs.dev_choose(F, fs2, prf2, n, k))
        _same(prf, prf2)
    consts = fpm.round_consts(F, dev)
    rows = torch.zeros((B, 6, 2, 4, N), dtype=torch.int32, device=dev)
    rows2 = rows.cpu().clone()
    x = _elts(F, rng, B * 3, dev).reshape(B, 3, N)
    claim, claim2 = x[:, 0].contiguous(), x[:, 0].cpu().contiguous()
    a = x[:, 1:].contiguous()
    pads = _elts(F, rng, B * 36, dev).reshape(B, 6, 2, 3, N)
    for rnd in range(3):
        dfs.round_tail(F, fs, claim, rows[:, rnd, 1], a, x[0, 0],
                       pads[:, rnd, 1], consts)
        dfs.round_tail(F, fs2, claim2, rows2[:, rnd, 1], a.cpu(),
                       x[0, 0].cpu(), pads[:, rnd, 1].cpu(), consts.cpu())
    _same(rows, rows2)
    _same(claim, claim2)
    _same(fs, fs2)


@pytest.mark.parametrize("field", list(FIELDS))
def test_lanes_k11_k12(dev, field):
    """K11 and K12 of 8 lanes against their plain versions."""
    F, rng, B = FIELDS[field](), np.random.default_rng(17), 8
    N = F.nlimb
    stat = _fused_stat([15, 3, 1, 10], 3000, 7)
    R, nl = int(stat.lay[:, 0].sum()), stat.lay.shape[0]
    rows = _elts(F, rng, B * R * 8, dev).reshape(B, R, 2, 4, N)
    scal = _elts(F, rng, B * 4 * nl, dev).reshape(B, nl, 4, N)
    wcpad = _elts(F, rng, B * 2 * nl, dev).reshape(B, nl, 2, N)
    tabs = fused.prepare(F, stat, dev)
    _same(fused.zk_constraints(F, tabs, rows, scal, wcpad),
          fused.constraints_plain(F, stat.lay, rows, scal, wcpad, tabs.lag))
    p = stat.p
    k = _elts(F, rng, B * len(stat.ws), dev).reshape(B, -1, N)
    alphal = _elts(F, rng, B * stat.nl_constraints, dev).reshape(B, -1, N)
    alphaq = _elts(F, rng, B * 3 * p.nq, dev).reshape(B, -1, N)
    _same(fused.ligero_inner_product(F, tabs, k, alphal, alphaq),
          fused.inner_product_plain(F, tabs.ptr, tabs.ent, k, alphal,
                                    alphaq, p.nwqrow, p.r, p.w))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("B", [2, 16, 64, 128])
def test_k17_matmul_ntt(dev, B, inverse):
    """K17 on 37 blocks (a ragged tile of rows), B from 2 (padded columns
    and reduction) to 128."""
    F, rng = fp128(), np.random.default_rng(B)
    G = mnt.MatmulNTT(F, P128_OMEGA, P128_OMEGA_ORDER,
                      device=dev).block_matrix(B, inverse)
    x = _elts(F, rng, 37 * B, dev).reshape(37, B, 4)
    _same(mnt.fp_matmul_ntt(F, x, G), mnt.matmul_ntt_plain(F, x, G))


@pytest.mark.parametrize("radix,n,rows", [(128, 2, 3), (16, 256, 3),
                                          (16, 256, 1), (128, 4096, 3),
                                          (128, 4096, 1)])
def test_k17_matmul_ntt_transform(dev, radix, n, rows):
    """The four-step MatmulNTT on the card equals K4's NTT (one row too:
    its transposes are then views that K17 must not be handed)."""
    F, rng = fp128(), np.random.default_rng(n)
    x = _elts(F, rng, rows * n, dev).reshape(rows, n, 4)
    m = mnt.MatmulNTT(F, P128_OMEGA, P128_OMEGA_ORDER, radix, dev)
    nt = NTT(F, P128_OMEGA, P128_OMEGA_ORDER, dev)
    _same(m.fftb(x), nt.fftb(x))
    _same(m.fftf(x), nt.fftf(x))


@pytest.mark.parametrize("n", [2, 8, 2048])
@pytest.mark.parametrize("mode", [rfm.SPLIT, rfm.MERGE, rfm.HC_MUL])
def test_k18_rfft_pass(dev, mode, n):
    F2, rng = Fp2(p256_base()), np.random.default_rng(n + mode)
    rf = rfm.RFFT(F2, (P256_FP2_ROOT_X, P256_FP2_ROOT_Y),
                  P256_FP2_ROOT_ORDER, dev)
    fw, bw = rf.w_tables(n)
    rows = 14
    b, tab, inv2 = None, bw, rf.inv2
    if mode == rfm.SPLIT:
        a, tab = _elts2(F2, rng, rows * n // 2, dev).reshape(
            rows, n // 2, 2, F2.nlimb), fw
    else:
        a = _elts(F2.f, rng, rows * n, dev).reshape(rows, n, F2.nlimb)
    if mode == rfm.HC_MUL:
        b, tab, inv2 = _elts(F2.f, rng, n, dev).reshape(1, n, F2.nlimb), \
            None, None
    _same(rfm.rfft_pass(F2, mode, a, b, tab, inv2),
          rfm.rfft_pass_plain(F2, mode, a, b, tab, inv2))
    if mode == rfm.HC_MUL:
        _same(rfm.rfft_pass(F2, mode, a, a, None, None),
              rfm.rfft_pass_plain(F2, mode, a, a, None, None))


PRIMES = ["fp128", "fp256", "fp256k1"]
# the Nussbaumer instances: the prime fields and Fp2 over P-256
NB_FIELDS = PRIMES + ["fp256x2"]


def _nb_field(field):
    """(F, elts(rng, n, dev) -> [n, *F.elt_shape])."""
    if field == "fp256x2":
        F = Fp2(p256_base())
        return F, lambda r, n, d: _elts2(F, r, n, d)
    F = FIELDS[field]()
    return F, lambda r, n, d: _elts(F, r, n, d)


@pytest.mark.parametrize("field", NB_FIELDS)
def test_k19_nb_butterfly(dev, field):
    """Every level of both directions at the shapes of negacyclic(2048)
    (M = 64, r = 64) and of negacyclic(64) (M = 16, r = 8), with the
    steps the recursion uses and odd ones."""
    (F, elts), rng = _nb_field(field), np.random.default_rng(19)
    for rows, M, r in ((3, 64, 64), (40, 16, 8)):
        A = elts(rng, rows * M * r, dev).reshape((rows, M, r) + F.elt_shape)
        h = M // 2
        while h >= 1:
            for step in (r // h, 3, -7, -r):
                for inverse in (False, True):
                    _same(nbm.nb_butterfly(F, A, h, step, inverse),
                          nbm.nb_butterfly_plain(F, A, h, step, inverse))
            h //= 2


@pytest.mark.parametrize("n", [1, 4, 8, 32])
@pytest.mark.parametrize("field", NB_FIELDS)
def test_k20_nb_base_conv(dev, field, n):
    (F, elts), rng = _nb_field(field), np.random.default_rng(20 + n)
    e = F.elt_shape
    x = elts(rng, 6 * n, dev).reshape((2, 3, n) + e)
    for y in (elts(rng, 3 * n, dev).reshape((3, n) + e),
              elts(rng, 6 * n, dev).reshape((2, 3, n) + e)):
        for neg in (False, True):
            x2, y2 = nbm._rows_of(x, y, len(e))
            _same(nbm.nb_base_conv(F, x, y, neg).reshape(x2.shape),
                  nbm.nb_base_conv_plain(F, x2, y2, neg))


@pytest.mark.parametrize("field", NB_FIELDS)
def test_nussbaumer_cyclic_on_the_card(dev, field):
    """cyclic at 4,096 points (K19, K20 and K1, or K5 over Fp2;
    negacyclic(2,048) recurses twice), y one row, equals the CPU's plain
    versions."""
    (F, elts), rng = _nb_field(field), np.random.default_rng(21)
    x = elts(rng, 2 * 4096, dev).reshape((2, 4096) + F.elt_shape)
    y = elts(rng, 4096, dev)
    _same(nbm.cyclic(F, x, y), nbm.cyclic(F, x.cpu(), y.cpu()))


# the field API no proof path calls (K1 modes 5-9, K5's, K21, K22) and
# the instances it adds
API_FIELDS = dict(FIELDS, fp24=f24m.fp24, fp64=fp64, p256n=p256_scalar,
                  p256k1n=p256k1_scalar, p384=p384_base, p521=p521_base)
API_MODES = [fpm.MUL, fpm.ADD, fpm.SUB, fpm.SQR, fpm.NEG, fpm.EQ,
             fpm.IS_ZERO, fpm.SELECT]


def _api_operands(make, rng, n, dev):
    """a, b (equal to a at every third element, zero at a few) and bool
    conditions, n elements from make(rng, n, dev)."""
    a, b = make(rng, n, dev), make(rng, n, dev)
    b[::3] = a[::3]
    a[5:9] = 0
    b[7:9] = 0
    cond = torch.as_tensor(rng.random(n) < 0.5, device=dev)
    return a, b, cond


@pytest.mark.parametrize("field", list(API_FIELDS))
@pytest.mark.parametrize("mode", API_MODES)
def test_k1_field_api(dev, mode, field):
    F, rng = API_FIELDS[field](), np.random.default_rng(31)
    P = fpm.plain_of(F)
    a, b, cond = _api_operands(lambda r, n, d: _elts(F, r, n, d), rng,
                               4000, dev)
    _same(fpm.fp_elementwise(F, mode, a, b, cond),
          P.elementwise_plain(F, mode, a, b, cond))
    # broadcast: b a row over [rows, n], the conditions a column
    m, row = a.reshape(40, 100, F.nlimb), b[:100]
    c2 = cond[:40].reshape(40, 1)
    _same(fpm.fp_elementwise(F, mode, m, row, c2),
          P.elementwise_plain(F, mode, m, row, c2))
    if mode == fpm.MUL:
        _same(F.mul_const(a, 123456789), P.elementwise_plain(
            F, fpm.MUL, a, F.to_limbs(123456789, dev)))


# K1's one-word path (four elements a thread) and 12- and 17-word path
# (a tile of TILE_ELTS elements a block through shared memory),
# csrc/fp_ops.cu, at the sizes where they split: none, a ragged quad or
# tile, a tile less or more one, many tiles and a ragged one
K1_TILE = kernels.k1_tile()


@pytest.mark.parametrize("n", [0, 1, 3, K1_TILE - 1, K1_TILE + 1,
                               (1 << 16) + 5])
@pytest.mark.parametrize("mode", API_MODES)
@pytest.mark.parametrize("field", ["fp24", "p384", "p521"])
def test_k1_split_shapes(dev, field, mode, n):
    """K1 [fp24], [p384] and [p521] against the plain versions: b full, one
    element and a row over two rows; the conditions full, a row and a
    column; operands that are views one element into their tensors (not
    16-byte aligned), alone and beside aligned ones."""
    F, rng = API_FIELDS[field](), np.random.default_rng(33 + n)
    P = fpm.plain_of(F)
    a, b, cond = _api_operands(lambda r, m, d: _elts(F, r, m, d), rng,
                               2 * n + 2, dev)
    x, y, c = a[:n], b[:n], cond[:n]
    xo, yo, co = a[1 : n + 1], b[1 : n + 1], cond[1 : n + 1]
    rows = a[: 2 * n].reshape(2, n, F.nlimb)
    cases = [(x, y, c), (xo, yo, co), (x, yo, c), (xo, y, co),
             (x, b[n + 1], c), (xo, b[n + 1], co), (rows, yo, co),
             (rows, y, cond[:2].reshape(2, 1))]
    for k, (xx, yy, cc) in enumerate(cases):
        got = fpm.fp_elementwise(F, mode, xx, yy, cc)
        want = P.elementwise_plain(F, mode, xx, yy, cc)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want.cpu()), "case %d" % k


@pytest.mark.parametrize("field", ["fp24", "p521"])
def test_k1_bind_hv_one_and_17_words(dev, field):
    """bind and hv keep one element a thread at one and 17 words."""
    _check_bind_hv(API_FIELDS[field](), dev)


@pytest.mark.parametrize("field", list(API_FIELDS) + ["fp256x2"])
def test_k21_inv(dev, field):
    rng = np.random.default_rng(32)
    if field == "fp256x2":
        F = Fp2(p256_base())
        a = _elts2(F, rng, 300, dev)
        a[3] = 0
        want = fp2_inv_plain(F, a)
        one = F.to_limbs((1, 0), dev)
    else:
        F = API_FIELDS[field]()
        a = _elts(F, rng, 300, dev)
        want = fpm.plain_of(F).inv_plain(F, a)
        one = F.to_limbs(1, dev)
    got = F.inv(a)
    _same(got, want)
    _same(F.batch_inverse(a), want)
    nz = ~F.is_zero(a)
    assert bool(F.is_zero(got[~nz]).all())
    assert bool(F.eq(F.mul(got[nz], a[nz]), one).all())


@pytest.mark.parametrize("mode", [fpm.SQR, fpm.NEG, fpm.EQ, fpm.IS_ZERO,
                                  fpm.SELECT])
def test_k5_field_api(dev, mode):
    F2, rng = Fp2(p256_base()), np.random.default_rng(33)
    a, b, cond = _api_operands(lambda r, n, d: _elts2(F2, r, n, d), rng,
                               3000, dev)
    _same(fp2_elementwise(F2, mode, a, b, cond),
          fp2_elementwise_plain(F2, mode, a, b, cond))
    m, row = a.reshape(30, 100, 2, F2.nlimb), b[:100]
    c2 = cond[:30].reshape(30, 1)
    _same(fp2_elementwise(F2, mode, m, row, c2),
          fp2_elementwise_plain(F2, mode, m, row, c2))


def _elts6(F6, rng, n, dev):
    return _elts(F6.f, rng, 6 * n, dev).reshape(n, 6, 1)


def _fp24x6_op(F6, mode, a, b, cond):
    """Fp24_6's op in `mode` through its API."""
    return {fpm.MUL: lambda: F6.mul(a, b), fpm.ADD: lambda: F6.add(a, b),
            fpm.SUB: lambda: F6.sub(a, b), fpm.SQR: lambda: F6.sqr(a),
            fpm.NEG: lambda: F6.neg(a), fpm.EQ: lambda: F6.eq(a, b),
            fpm.IS_ZERO: lambda: F6.is_zero(a),
            fpm.SELECT: lambda: F6.select(cond, a, b),
            fpm.INV: lambda: F6.inv(a)}[mode]()


@pytest.mark.parametrize("mode", API_MODES + [fpm.INV])
def test_k22_fp24x6(dev, mode):
    """Fp24_6's ops on the card: mul, sqr and inv by K22 against its plain
    version, the per-coefficient ops (K1 [fp24] on the six words) against
    the same call on the CPU."""
    F6, rng = f24m.Fp24_6(f24m.fp24()), np.random.default_rng(34)
    n = 200 if mode == fpm.INV else 3000
    a, b, cond = _api_operands(lambda r, k, d: _elts6(F6, r, k, d), rng, n,
                               dev)
    cases = [(a, b, cond)]
    if mode != fpm.INV:
        cases.append((a.reshape(30, 100, 6, 1), b[:100],
                      cond[:30].reshape(30, 1)))
    for x, y, c in cases:
        got = _fp24x6_op(F6, mode, x, y, c)
        if mode in (fpm.MUL, fpm.SQR, fpm.INV):
            want = f24m.fp24x6_elementwise_plain(F6, mode, x, y)
        else:
            want = _fp24x6_op(F6, mode, x.cpu(), y.cpu(), c.cpu())
        _same(got, want)


def test_k2_k3_fp24(dev):
    """K2 and K3 [fp24]: sums that pass 2p (R = 2^32, p < 2^23) and
    Fp24_6.lazy_sum."""
    F, rng = f24m.fp24(), np.random.default_rng(35)
    x = _elts(F, rng, 20000, dev)
    x[:5000] = F.to_limbs(F.p - 1, dev)
    s, e = _segments(rng, 3000, 20000, dev)
    _same(F.lazy_segment_sum(x, s, e), fpm.segment_sum_plain(F, x, s, e))
    for t in (x, x.reshape(20, 1000, 1)):
        for dim in range(t.dim() - 1):
            _same(F.lazy_sum(t, dim), fpm.axis_sum_plain(F, t, dim))
    F6 = f24m.Fp24_6(F)
    x6 = x[:6000].reshape(1000, 6, 1)
    _same(F6.lazy_sum(x6, 0), fpm.axis_sum_plain(F, x6, 0))


@pytest.mark.parametrize("field", ["fp64", "p256n", "p256k1n", "p384",
                                   "p521"])
def test_k2_k3_field_api(dev, field):
    """K2 and K3 at the instances that only lazy_segment_sum and lazy_sum
    reach: sums with a run of p - 1 (at P-521 they pass 2p below R)."""
    F, rng = API_FIELDS[field](), np.random.default_rng(36)
    x = _elts(F, rng, 20000, dev)
    x[:5000] = F.to_limbs(F.p - 1, dev)
    s, e = _segments(rng, 3000, 20000, dev)
    _same(F.lazy_segment_sum(x, s, e), fpm.segment_sum_plain(F, x, s, e))
    for t in (x, x.reshape(20, 1000, F.nlimb),
              x[:19992].reshape(7, 2, 1428, F.nlimb)):
        for dim in range(t.dim() - 1):
            _same(F.lazy_sum(t, dim), fpm.axis_sum_plain(F, t, dim))


# K2 at segment lengths around a warp (32), a thread's chunk of the scan
# and a block of it, a long one and empty ones, in that order and mixed
K2_LENGTHS = [0, 1, 2, 31, 32, 33, 0, 7, 8, 9, 255, 256, 257, 2047, 2048,
              2049, 1 << 19, 0, 0, 3, 1]


def _k2_segments(rng, dev):
    """(starts, ends, n): K2_LENGTHS, then 3,000 random lengths of 0-40,
    laid end to end from an odd start (so that segments straddle the
    chunk, warp and block edges of the scan)."""
    lens = np.array(K2_LENGTHS + list(rng.integers(0, 41, 3000)),
                    dtype=np.int64)
    starts = 5 + np.concatenate([[0], np.cumsum(lens)[:-1]])
    ends = starts + lens
    n = int(ends[-1]) + 3
    return (torch.as_tensor(starts.astype(np.int32), device=dev),
            torch.as_tensor(ends.astype(np.int32), device=dev), n)


@pytest.mark.parametrize("field", list(API_FIELDS))
@pytest.mark.parametrize("scan", [False, True])
def test_k2_segment_lengths(dev, scan, field):
    """K2 mode 0 at every instance over segments of 0, 1, 2, 31-33,
    255-257, 2047-2049 and 2^19 terms and mixed short ones across the
    scan's chunk, warp and block edges, over ranges in no order that
    overlap, and over no term at all; through the scan (`scan`: the
    longest segment given) and a warp a segment (none given)."""
    F, rng = API_FIELDS[field](), np.random.default_rng(37)
    P = fpm.plain_of(F)
    s, e, n = _k2_segments(rng, dev)
    most = (1 << 19,) if scan else ()
    x = _elts(F, rng, n, dev)
    x[: n // 3] = F.to_limbs(F.p - 1 if not F.kCharacteristicTwo
                             else (1 << 128) - 1, dev)
    _same(F.lazy_segment_sum(x, s, e, *most),
          P.segment_sum_plain(F, x, s, e))
    a = torch.as_tensor(rng.integers(0, n, 500, dtype=np.int32), device=dev)
    b = torch.as_tensor(rng.integers(0, n, 500, dtype=np.int32), device=dev)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    _same(F.lazy_segment_sum(x, lo, hi, *((n,) if scan else ())),
          P.segment_sum_plain(F, x, lo, hi))
    z = x[:0]
    zs = torch.zeros(4, dtype=torch.int32, device=dev)
    _same(F.lazy_segment_sum(z, zs, zs, *most),
          P.segment_sum_plain(F, z, zs, zs))


@pytest.mark.parametrize("field", list(API_FIELDS))
@pytest.mark.parametrize("bad", [False, True])
def test_k2_eval_layer_lengths(dev, bad, field):
    """K2 mode 1 at every instance over the segments of
    test_k2_segment_lengths (over 2^16 terms: the scan; test_k2_eval_layer
    takes a warp a segment), v one at a third of the terms (the skipped
    product), beta-masked terms that read a zero product, and with `bad`
    one that does not."""
    F, rng = API_FIELDS[field](), np.random.default_rng(38)
    P = fpm.plain_of(F)
    s, e, n = _k2_segments(rng, dev)
    nw = 1 << 12
    W = _elts(F, rng, nw, dev)
    W[7] = 0
    h0 = torch.as_tensor(rng.integers(0, nw, n, dtype=np.int32), device=dev)
    h1 = torch.as_tensor(rng.integers(0, nw, n, dtype=np.int32), device=dev)
    bm = torch.as_tensor(rng.random(n) < 0.1, device=dev)
    h0[bm] = 7
    if bad:
        h0[int(torch.nonzero(bm)[-1])] = 8
    v = _elts(F, rng, n, dev)
    v[torch.as_tensor(rng.random(n) < 0.33, device=dev)] = \
        F.to_limbs(1, dev)
    V, ok = fpm.fp_eval_layer(F, W, h0, h1, v, bm, s, e)
    V2, ok2 = P.eval_layer_plain(F, W, h0, h1, v, bm, s, e)
    _same(V, V2)
    assert bool(ok) == bool(ok2) == (not bad)


@pytest.mark.parametrize("field", ["fp128", "gf2_128"])
def test_k2_large_table(dev, field):
    """K2 in both modes over 2^21 + 12,345 terms (its scan takes 8 terms
    a thread there; 1 or 2 in the tests above; mode 0 also a warp a
    segment): short segments, a long one and empty ones across the
    table."""
    F, rng = FIELDS[field](), np.random.default_rng(45)
    P = fpm.plain_of(F)
    n = (1 << 21) + 12345
    lens = rng.integers(0, 41, n // 10)
    lens[100] = 1 << 19
    lens[5:9] = 0
    ends = np.minimum(np.cumsum(lens), n).astype(np.int32)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)
    s, e = (torch.as_tensor(x, device=dev) for x in (starts, ends))
    x = _elts(F, rng, n, dev)
    for most in ((), (1 << 19,)):
        _same(F.lazy_segment_sum(x, s, e, *most),
              P.segment_sum_plain(F, x, s, e))
    nw = 1 << 12
    W = _elts(F, rng, nw, dev)
    h0 = torch.as_tensor(rng.integers(0, nw, n, dtype=np.int32), device=dev)
    h1 = torch.as_tensor(rng.integers(0, nw, n, dtype=np.int32), device=dev)
    bm = torch.zeros(n, dtype=torch.bool, device=dev)
    V, ok = fpm.fp_eval_layer(F, W, h0, h1, x, bm, s, e)
    V2, ok2 = P.eval_layer_plain(F, W, h0, h1, x, bm, s, e)
    _same(V, V2)
    assert bool(ok) and bool(ok2)


@pytest.mark.parametrize("field", ["fp128", "gf2_128"])
def test_k2_scans_on_two_streams(dev, field):
    """K2's scan on two streams at once and on the default one, four
    times over (each call counts its blocks in its own scratch,
    csrc/segsum.cu), against the plain version."""
    F, rng = FIELDS[field](), np.random.default_rng(46)
    P = fpm.plain_of(F)
    s, e, n = _k2_segments(rng, dev)
    xs = [_elts(F, rng, n, dev) for _ in range(3)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = [None] * 3
    torch.cuda.synchronize()
    for _ in range(4):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i] = F.lazy_segment_sum(xs[i], s, e, 1 << 19)
        outs[2] = F.lazy_segment_sum(xs[2], s, e, 1 << 19)
    torch.cuda.synchronize()
    for x, out in zip(xs, outs):
        _same(out, P.segment_sum_plain(F, x, s, e))


def _fs_at(rng, off, dev):
    """A random host transcript state whose absorbed count is off mod
    64, on the card."""
    ts = Transcript(rng.bytes(5))
    cnt = int.from_bytes(ts.export_state()[32:40], "little")
    # a byte string absorbs 9 + L bytes (the tag, the length, the bytes)
    ts.write_bytes(rng.bytes((off - cnt - 9) % 64 + 64 * int(
        rng.integers(0, 3))))
    fs = dfs.fs_init_from_host(ts, dev)
    assert int.from_bytes(bytes(fs[32:40].tolist()), "little") % 64 == off
    return fs


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("cubic", [False, True])
@pytest.mark.parametrize("lanes", [1, 2, 8])
def test_k10_every_offset(dev, lanes, cubic, field):
    """K10 in both modes at every starting offset cnt % 64 (0-63, one
    lane each), `lanes` lanes a launch, against the plain version lane
    by lane: fs, the claim and the row compared."""
    F, rng = FIELDS[field](), np.random.default_rng(39 + lanes)
    N, npts = F.nlimb, 4 if cubic else 3
    consts = fpm.round_consts(F, dev)
    tail = dfs.round_tail_cubic if cubic else dfs.round_tail
    plain = dfs.round_tail_cubic_plain if cubic else dfs.round_tail_plain
    cpu = torch.device("cpu")
    consts2 = consts.cpu()
    for first in range(0, 64, lanes):
        # the plain version runs on the CPU (its thousands of small ops
        # are faster there than launched one by one)
        fs2 = torch.stack([_fs_at(rng, off, cpu)
                           for off in range(first, first + lanes)])
        x = _elts(F, rng, lanes * (2 * npts + 1) + 3, cpu)[3:]
        x = x.reshape(lanes, 2 * npts + 1, N)
        claim2 = x[:, 0].clone()
        a2 = x[:, 1:npts].contiguous()
        pad2 = x[:, npts + 1:].contiguous()
        eq02 = x[0, npts].contiguous()
        row2 = torch.zeros((lanes, npts + 1, N), dtype=torch.int32)
        fs, claim, a, pad, eq0, row = (t.to(dev) for t in (
            fs2, claim2, a2, pad2, eq02, row2))
        args = (a,) if cubic else (a, eq0)
        tail(F, fs, claim, row, *args, pad, consts)
        for b in range(lanes):
            plain(F, fs2[b], claim2[b], row2[b],
                  *((a2[b],) + ((eq02,) if not cubic else ())), pad2[b],
                  consts2)
        _same(fs, fs2)
        _same(claim, claim2)
        _same(row, row2)


# From the empty transcript state (the SHA-256 initial value, nothing
# absorbed), a hand-round that absorbs ev_0 = K10_REJECT_EV0 and ev_2 = 0
# (natural values) draws a first Fp128 block of 0xffff f412 ... 48 >= p:
# K10 [fp128] rejects it and samples the second block.
K10_REJECT_EV0 = 64395


def test_k10_forced_rejection(dev):
    """K10 [fp128] through a rejected draw, in one lane and as lane 1 of
    4, against the plain version and the host transcript."""
    import struct
    F = fp128()
    rng = np.random.default_rng(40)
    consts = fpm.round_consts(F, dev)
    iv = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F,
          0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
    empty = torch.frombuffer(bytearray(struct.pack("<8IQ", *iv, 0) +
                                       bytes(64)), dtype=torch.uint8)
    x = _elts(F, rng, 16, dev)[3:]
    claim, eq0, a = x[0].clone(), x[1], x[2:4].contiguous()
    # the pads that make ev_0 and ev_2 the values above
    row = torch.zeros((4, F.nlimb), dtype=torch.int32, device=dev)
    dfs.round_tail_plain(F, empty.clone().to(dev), claim.clone(), row, a,
                         eq0, F.zeros((3,), dev), consts)
    want = F.to_limbs([K10_REJECT_EV0, 0, 0], dev)
    pad = F.sub(row[:3], want).contiguous()
    for lanes, at in ((1, 0), (4, 1)):
        fs = torch.stack([empty.to(dev) if b == at else _fs_at(rng, b, dev)
                          for b in range(lanes)])
        fs2 = fs.clone()
        cl = claim.repeat(lanes, 1)
        cl2 = cl.clone()
        aa = a.repeat(lanes, 1, 1)
        pp = pad.repeat(lanes, 1, 1)
        r1 = torch.zeros((lanes, 4, F.nlimb), dtype=torch.int32, device=dev)
        r2 = r1.clone()
        dfs.round_tail(F, fs, cl, r1, aa, eq0, pp, consts)
        for b in range(lanes):
            dfs.round_tail_plain(F, fs2[b], cl2[b], r2[b], aa[b], eq0, pp[b],
                                 consts)
        _same(fs, fs2)
        _same(cl, cl2)
        _same(r1, r2)
        assert F.from_limbs(r1[at, 0].cpu()) == K10_REJECT_EV0
        # the host transcript draws the same challenge past its rejection
        ts = Transcript(b"", _sha=SHA256())
        ts.write_elt(K10_REJECT_EV0, F)
        ts.write_elt(0, F)
        assert F.from_limbs(r1[at, 3].cpu()) == ts.elt(F)


def test_no_kernel_raises(dev):
    """A CUDA tensor of a field or mode that has no kernel raises; nothing
    falls back to a plain version."""
    F = fpm.PrimeField((1 << 61) - 1, "M61")  # no instance
    a = F.to_limbs([1, 2, 3], dev)
    F2 = Fp2(fp128())  # Fp2 has an instance over P-256 only
    a2 = F2.to_limbs([(1, 2)], dev)
    F6 = f24m.Fp24_6(f24m.fp24(), beta=3)  # K22 is compiled for beta 7
    a6 = F6.to_limbs([(1, 2, 3, 4, 5, 6)], dev)
    for call in (lambda: F.mul(a, a), lambda: F.sqr(a), lambda: F.inv(a),
                 lambda: F.eq(a, a), lambda: F.lazy_sum(a, 0),
                 lambda: F2.inv(a2), lambda: F2.sqr(a2),
                 lambda: F6.mul(a6, a6), lambda: F6.inv(a6)):
        with pytest.raises(NotImplementedError):
            call()
    G = fp128()
    g = G.to_limbs([1, 2], dev)
    with pytest.raises(ValueError):
        fpm.fp_elementwise(G, 11, g, g)
    with pytest.raises(ValueError):
        fp2_elementwise(Fp2(p256_base()), fpm.HV, a2, a2)


def test_parallel_paths_at_the_cards_visible(dev):
    """parallel/smoke.py's checks (ShardedNTT at 2^20, the SHA-256 x 64
    copies sumcheck, ZkProver on the three goldens, the batch of 8, the
    sharded RS encode) at world = the cards visible, through NCCL: every
    one exact and every kernel of its path launched."""
    from longfellow_zk_tpu_torch.parallel import smoke

    ok, summary = smoke.run(torch.cuda.device_count(), timeout_s=900)
    assert ok, {k: (v["exact"], v["missing"]) for k, v in summary.items()}


# K1 [gf2_128] (csrc/fp_ops.cu): a kernel a mode, E elements a thread
# (k_g128_ew), and the products by one element a lane (k_g128_lane: the
# Karatsuba product below G128_TAB_MIN elements, a table of the
# element's multiples from there on); sizes on both sides of each split
G128_LANE_MIN, G128_TAB_MIN = kernels.k1_g128_splits()
G128_SIZES = [1, 3, 255, 257, 1023, 4097, G128_TAB_MIN - 1, G128_TAB_MIN + 5,
              70001]


@pytest.mark.parametrize("n", G128_SIZES)
@pytest.mark.parametrize("mode", API_MODES)
def test_k1_gf2_modes(dev, mode, n):
    """Every mode of K1 [gf2_128] at ragged sizes: b full, one element, a
    row over rows and a column over rows (one element a row: the lane
    path where rows are long enough), views one element into their
    tensors; mul_const; all against the plain version."""
    F, rng = gf2_128(), np.random.default_rng(160 + n)
    P = fpm.plain_of(F)
    a, b, cond = _api_operands(lambda r, m, d: _elts(F, r, m, d), rng,
                               2 * n + 2, dev)
    x, y, c = a[:n], b[:n], cond[:n]
    xo, yo = a[1 : n + 1], b[1 : n + 1]
    rows = a[: 2 * n].reshape(2, n, 4)
    cases = [(x, y, c), (xo, yo, c), (x, b[n + 1], c), (rows, yo, c),
             (rows, b[:2].reshape(2, 1, 4), cond[:2].reshape(2, 1))]
    for k, (xx, yy, cc) in enumerate(cases):
        got = fpm.fp_elementwise(F, mode, xx, yy, cc)
        want = P.elementwise_plain(F, mode, xx, yy, cc)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want.cpu()), "case %d" % k
    if mode == fpm.MUL:
        c = (1 << 127) | 0xC0FFEE
        _same(F.mul_const(x, c),
              P.elementwise_plain(F, fpm.MUL, x, F.to_limbs(c, dev)))


@pytest.mark.parametrize("lanes,n", [(1, 8), (1, 4096), (2, 300),
                                     (2, G128_TAB_MIN // 2 + 256),
                                     (3, 70000), (2, 1 << 16)])
def test_k1_gf2_bind_hv_lanes(dev, lanes, n):
    """K1 [gf2_128] bind and hv with `lanes` lanes, each its own challenge
    read from a strided view (as the sumcheck passes them), on both
    sides of the table's split; lanes whose length is no multiple of a
    block; bind over several rows a lane; edge challenges (0, 1, x^127,
    all ones)."""
    F, rng = gf2_128(), np.random.default_rng(170 + n)
    P = fpm.plain_of(F)
    rows = _elts(F, rng, lanes * 12, dev).reshape(lanes, 3, 4, 4)
    rows[0, 1, 2] = F.to_limbs(1 << 127, dev)
    r = rows[:, 1, 2]
    x = _elts(F, rng, lanes * 2 * n, dev).reshape(lanes, 2 * n, 4)
    _same(F.bind(x, r), P.elementwise_plain(F, fpm.BIND, x, r))
    x4 = x.reshape(lanes, 2, n, 4)
    _same(F.bind(x4, r), P.elementwise_plain(F, fpm.BIND, x4, r))
    h = torch.as_tensor(rng.integers(0, 1 << 20, n, dtype=np.int32),
                        device=dev)
    hv = x[:, :n].contiguous()
    _same(F.hv_update(hv, h, r), P.elementwise_plain(F, fpm.HV, hv, r, h))
    for v in (0, 1, 1 << 127, (1 << 128) - 1):
        rv = F.to_limbs(v, dev)
        _same(F.hv_update(hv[0], h, rv),
              P.elementwise_plain(F, fpm.HV, hv[0], rv, h))
        _same(F.bind(x[0], rv), P.elementwise_plain(F, fpm.BIND, x[0], rv))


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("parity", ["mixed", "even", "odd"])
@pytest.mark.parametrize("T", [1, 300, 70000, 400000])
def test_k3_gf2_wire(dev, T, parity, lanes):
    """K3 [gf2_128] (k_wire_g128: z split once, two unreduced products a
    term, the sums folded once a thread) with odd and even h mixed, all
    even and all odd, 1 and 2 lanes, against the plain version."""
    F, rng = gf2_128(), np.random.default_rng(180 + T)
    P = fpm.plain_of(F)
    N = 1 << 12
    hv, Wh, Wo = (_elts(F, rng, lanes * m, dev).reshape(lanes, m, 4)
                  for m in (T, N, N))
    h = rng.integers(0, N, T, dtype=np.int32)
    if parity == "even":
        h &= ~1
    elif parity == "odd":
        h |= 1
    h = torch.as_tensor(h, device=dev)
    ho = torch.as_tensor(rng.integers(0, N, T, dtype=np.int32), device=dev)
    if lanes == 1:
        hv, Wh, Wo = hv[0], Wh[0], Wo[0]
    _same(fpm.fp_wire_sums(F, hv, Wh, Wo, h, ho),
          P.wire_sums_plain(F, hv, Wh, Wo, h, ho))


def test_gf2_product_in_k2_k7(dev):
    """K2's layer evaluation and K7 at GF(2^128), which take gf2.cuh's
    product, on edge elements (0, 1, x^127, all ones) among random ones."""
    F, rng = gf2_128(), np.random.default_rng(190)
    P = fpm.plain_of(F)
    T, nw, nv, nseg = 30000, 1 << 12, 1 << 9, 1 << 10
    W = _elts(F, rng, nw, dev)
    W[3:7] = F.to_limbs([1 << 127, (1 << 128) - 1, 1 << 127, 0x87], dev)
    h0 = torch.as_tensor(rng.integers(0, nw, T, dtype=np.int32), device=dev)
    h1 = torch.as_tensor(rng.integers(0, nw, T, dtype=np.int32), device=dev)
    h0[:2000] = 4
    bm = torch.zeros(T, dtype=torch.bool, device=dev)
    v = _elts(F, rng, T, dev)
    s, e = _segments(rng, nseg, T, dev)
    V, ok = fpm.fp_eval_layer(F, W, h0, h1, v, bm, s, e)
    V2, ok2 = P.eval_layer_plain(F, W, h0, h1, v, bm, s, e)
    _same(V, V2)
    assert bool(ok) and bool(ok2)
    g = torch.as_tensor(np.sort(rng.integers(0, nv, T)), device=dev)
    dot, eqh0, eqh1 = (_elts(F, rng, m, dev) for m in (nv, nw, nw))
    eqh0[4] = F.to_limbs((1 << 128) - 1, dev)
    args = (g, h0, h1, v, bm, dot, eqh0, eqh1, F.to_limbs(1 << 127, dev))
    _same(verifier.fp_quad_bind(F, *args), verifier.quad_bind_plain(F, *args))


# K9's writes and draws spread over a block (csrc/fs.cu k_fs_write,
# k_fs_draw): around a SHA-256 block and a stage of K9_CHUNK blocks
K9_SMALL = (1, 63, 64, 65, 130)
# the response writes of zk/fused.py ligero_finish_dev (block, dblock, r,
# dblock - block) at the SHA-256 and ECDSA, bitaddr, mdoc hash and mdoc
# signature proofs' ZkProver.param
K9_RESPONSES = {"fp128": (341, 681, 128, 340),
                "fp256": (341, 681, 128, 340, 455, 909, 132, 454),
                "fp256k1": (682, 1363, 128, 681),
                "gf2_128": (461, 921, 132, 460)}
# K9 [fp128]'s PRF_FRESH key whose first draw is >= p
# (tests/test_torch_fs_words.py)
REJECT_KEY = bytes.fromhex(
    "b2b7ec6f3f4f538ce55603547b6d9e9ec516e965a7d1db5e1c2118eb7e0edd66")


def _host_of(fs):
    ts = Transcript(b"", _sha=SHA256())
    dfs.fs_state_to_host(ts, fs.cpu())
    return ts


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("lanes", [1, 8])
def test_k9_writes_and_draws(dev, lanes, field):
    """K9's modes 0 and 4-8 at K9_SMALL elements (bytes for modes 0 and
    4) against the plain versions on the CPU, whole fs and prf states
    compared; 8 lanes, lane 1 rejecting its first Fp128 draw."""
    F, rng = FIELDS[field](), np.random.default_rng(60)
    N = F.nlimb
    for n in K9_SMALL:
        fs, fs2 = _fs_lanes(rng, dev, lanes)
        if lanes == 1:
            fs, fs2 = fs[0], fs2[0]
        lead = () if lanes == 1 else (lanes,)
        data = torch.as_tensor(rng.integers(0, 256, lead + (n,),
                                            dtype=np.uint8))
        dfs.fs_absorb(F, fs, data.to(dev))
        dfs.fs_absorb(F, fs2, data)
        _same(fs, fs2)
        xs = _elts(F, rng, lanes * n, dev).reshape(lead + (n, N))
        dfs.fs_write_elts(F, fs, xs)
        dfs.fs_write_elts(F, fs2, xs.cpu())
        _same(fs, fs2)
        dfs.write_tagged_elts(F, fs, xs)
        dfs.write_tagged_elts(F, fs2, xs.cpu())
        _same(fs, fs2)
        prf, prf2 = dfs.new_prf(dev, *lead), dfs.new_prf("cpu", *lead)
        _same(dfs.dev_sample_elts(F, prf, n, fs=fs),
              dfs.dev_sample_elts(F, prf2, n, fs=fs2))
        _same(prf, prf2)
        _same(dfs.prf_bytes(F, prf, n), dfs.prf_bytes(F, prf2, n))
        _same(prf, prf2)
        _same(dfs.dev_sample_elts(F, prf, n),
              dfs.dev_sample_elts(F, prf2, n))
        _same(prf, prf2)


@pytest.mark.parametrize("field", list(FIELDS))
def test_k9_response_sizes(dev, field):
    """K9 at the proofs' response writes (arrays and tagged elements)
    and a draw of as many samples, against the host Transcript (the
    plain versions' reference, tests/test_torch_device_fs.py; they take
    minutes on the card at these sizes): the whole fs state, the samples
    and the stream after them."""
    F, rng = FIELDS[field](), np.random.default_rng(61)
    for n in K9_RESPONSES[field]:
        fs, _ = _fs_pair(rng, dev)
        ts = _host_of(fs)
        xs = _elts(F, rng, n, dev)
        vals = list(F.from_limbs(xs.cpu()))
        dfs.fs_write_elts(F, fs, xs)
        ts.write_elts(vals, F)
        assert bytes(fs.cpu().tolist()) == ts.export_state()
        dfs.write_tagged_elts(F, fs, xs)
        for v in vals:
            ts.write_elt(v, F)
        assert bytes(fs.cpu().tolist()) == ts.export_state()
        prf = dfs.new_prf(dev)
        got = dfs.dev_sample_elts(F, prf, n, fs=fs)
        assert list(F.from_limbs(got.cpu())) == ts.elts(n, F)
        assert bytes(dfs.prf_bytes(F, prf, 37).cpu().tolist()) == \
            ts.bytes(37)


@pytest.mark.parametrize("field", list(FIELDS))
def test_k9_every_offset(dev, field):
    """K9's array and tagged writes of 65 elements, and an absorb of 130
    bytes, from each of the 64 offsets cnt % 64, against the host
    Transcript."""
    F, rng = FIELDS[field](), np.random.default_rng(62)
    for off in range(64):
        ts = Transcript(rng.bytes(5))
        cnt = int.from_bytes(ts.export_state()[32:40], "little")
        ts.write_bytes(rng.bytes((off - cnt - 9) % 64))
        fs = dfs.fs_init_from_host(ts, dev)
        xs = _elts(F, rng, 65, dev)
        vals = list(F.from_limbs(xs.cpu()))
        dfs.fs_write_elts(F, fs, xs)
        ts.write_elts(vals, F)
        dfs.write_tagged_elts(F, fs, xs)
        for v in vals:
            ts.write_elt(v, F)
        data = rng.bytes(130)
        dfs.fs_absorb(F, fs, torch.frombuffer(bytearray(data),
                                              dtype=torch.uint8).to(dev))
        ts._write_untyped(data)
        assert bytes(fs.cpu().tolist()) == ts.export_state(), off


@pytest.mark.parametrize("n", [1, 3, 300])
def test_k9_rejecting_key(dev, n):
    """K9 [fp128] from REJECT_KEY's stream (PRF_FRESH), whose first draw
    is rejected: n samples (300: more than a window) in one lane and as
    lane 0 of 8, against the plain version, whole prf states compared."""
    F = fp128()
    rng = np.random.default_rng(63)
    for lanes in (1, 8):
        keys = torch.stack([torch.frombuffer(bytearray(REJECT_KEY),
                                             dtype=torch.uint8)] +
                           [torch.as_tensor(rng.integers(0, 256, 32,
                                                         dtype=np.uint8))
                            for _ in range(lanes - 1)])
        if lanes == 1:
            keys = keys[0]
        lead = () if lanes == 1 else (lanes,)
        prf, prf2 = dfs.new_prf(dev, *lead), dfs.new_prf("cpu", *lead)
        dfs.prf_fresh(F, prf, keys.to(dev))
        dfs.prf_fresh(F, prf2, keys)
        _same(prf, prf2)
        _same(dfs.dev_sample_elts(F, prf, n),
              dfs.dev_sample_elts(F, prf2, n))
        _same(prf, prf2)


# K1 at the 2-12-word instances (csrc/fp_ops.cu k_fp_ew, k_fp_lane): the
# sizes of a warp's and a block's edges, a wire round's, the ECDSA
# tableau's and 2^20
K1_WORDS = ("fp128", "fp256", "fp256k1", "fp64", "p256n", "p256k1n", "p384")
K1_WORD_SIZES = (1, 255, 256, 257, 1 << 13, (1 << 16) + 3, 1 << 20)


@pytest.mark.parametrize("n", K1_WORD_SIZES)
@pytest.mark.parametrize("field", K1_WORDS)
def test_k1_words_every_mode(dev, field, n):
    """K1's modes (bind of n pairs, hv of n terms) against the plain
    versions; bind and hv with 3 lanes, each its own challenge (a strided
    view, as the prover passes them)."""
    F, rng = API_FIELDS[field](), np.random.default_rng(64)
    P = fpm.plain_of(F)
    a, b, cond = _api_operands(lambda r, m, d: _elts(F, r, m, d), rng, n,
                               dev)
    for mode in API_MODES:
        _same(fpm.fp_elementwise(F, mode, a, b, cond),
              P.elementwise_plain(F, mode, a, b, cond))
    r = _elts(F, rng, 12, dev).reshape(3, 4, F.nlimb)[:, 2]
    h = torch.as_tensor(rng.integers(0, 1 << 20, n, dtype=np.int32),
                        device=dev)
    W = torch.cat([a, b]).reshape(1, 2 * n, F.nlimb)
    _same(F.bind(W, r[0]), P.elementwise_plain(F, fpm.BIND, W, r[0]))
    _same(F.hv_update(a, h, r[0]), P.elementwise_plain(F, fpm.HV, a, r[0],
                                                       h))
    if n <= 1 << 16:
        W3 = _elts(F, rng, 6 * n, dev).reshape(3, 2 * n, F.nlimb)
        hv3 = _elts(F, rng, 3 * n, dev).reshape(3, n, F.nlimb)
        _same(F.bind(W3, r), P.elementwise_plain(F, fpm.BIND, W3, r))
        _same(F.hv_update(hv3, h, r),
              P.elementwise_plain(F, fpm.HV, hv3, r, h))


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("field", list(API_FIELDS))
def test_k1_bind_hv_one_launch(dev, field, lanes):
    """bind_hv (one K1 launch at the 2-12-word instances, two elsewhere)
    against the separate bind and hv launches and the plain versions, at
    a wire round's sizes and at W's last rounds (1 and 2 pairs)."""
    F, rng = API_FIELDS[field](), np.random.default_rng(65)
    P = fpm.plain_of(F)
    r = _elts(F, rng, 4 * lanes, dev).reshape(lanes, 4, F.nlimb)[:, 1]
    if lanes == 1:
        r = r[0]
    for nw, T in ((4096, 3000), (2, 70000), (4, 1)):
        W = _elts(F, rng, lanes * nw, dev).reshape(lanes, nw, F.nlimb)
        hv = _elts(F, rng, lanes * T, dev).reshape(lanes, T, F.nlimb)
        h = torch.as_tensor(rng.integers(0, 1 << 15, T, dtype=np.int32),
                            device=dev)
        n0 = kernels.LAUNCHES["fp_elementwise[%s]" % field]
        w2, h2 = F.bind_hv(W, hv, h, r)
        one = fpm.BIND_HV_WORDS.count(F.nlimb) and not F.kCharacteristicTwo
        assert kernels.LAUNCHES["fp_elementwise[%s]" % field] - n0 == \
            (1 if one else 2)
        _same(w2, F.bind(W, r))
        _same(h2, F.hv_update(hv, h, r))
        _same(w2, P.elementwise_plain(F, fpm.BIND, W, r))
        _same(h2, P.elementwise_plain(F, fpm.HV, hv, r, h))


# K3's wire mode at the term counts around a block and its grid (one
# block a lane up to 256 terms, which writes its sums directly), a mid and
# a large layer (8 lanes of the last two take the wide prime body); the
# mdoc hash circuit's largest layer at GF(2^128)
K3_SIZES = [1, 255, 256, 257, 1000, 4097, (1 << 16) + 3, 158231]


def _k3_scratch_clear():
    """Every ticket of K3's scratch is zero between launches."""
    torch.cuda.synchronize()
    for _, tick in fpm._K3_SCRATCH.values():
        assert int(tick.abs().sum()) == 0


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("field", list(FIELDS))
def test_k3_one_launch_shifts(dev, field, lanes):
    """K3's wire mode (one launch: the last block of a lane sums the
    partials) at the sizes of K3_SIZES (and 3,578,789 terms at
    GF(2^128)) and the round's shifts 0-3 of h and ho (ho one further on,
    as on a round's second hand), 1 and 8 lanes, against its plain
    version; the hv update by the same shift (K1, and bind_hv); two
    launches back to back on the same scratch, and the tickets left
    zero."""
    F, rng = FIELDS[field](), np.random.default_rng(230 + lanes)
    P = fpm.plain_of(F)
    sizes = K3_SIZES + ([3578789] if F.kCharacteristicTwo and lanes == 1
                        else [])
    n0 = kernels.LAUNCHES["fp_wire_round[%s]" % F.tag]
    calls = 0
    for T in sizes:
        logw = max(4, (T - 1).bit_length())
        N = 1 << logw
        hv = _elts(F, rng, lanes * T, dev).reshape(lanes, T, F.nlimb)
        Wh = _elts(F, rng, lanes * N, dev).reshape(lanes, N, F.nlimb)
        h = torch.as_tensor(rng.integers(0, N, T, dtype=np.int32),
                            device=dev)
        ho = torch.as_tensor(rng.integers(0, N, T, dtype=np.int32),
                             device=dev)
        r = _elts(F, rng, lanes, dev)
        for s in range(4):
            # the bound halves: Wh of round s, Wo one round further on
            n = N >> s
            Whs, Wo = Wh[:, :n].contiguous(), Wh[:, n // 2 : n].contiguous()
            so = s + 1
            got = fpm.fp_wire_sums(F, hv, Whs, Wo, h, ho, s, so)
            again = fpm.fp_wire_sums(F, hv, Whs, Wo, h, ho, s, so)
            calls += 2
            want = P.wire_sums_plain(F, hv, Whs, Wo, h, ho, s, so)
            _same(got, want)
            _same(again, want)
            if T <= 4097:
                _same(F.hv_update(hv, h, r, s),
                      P.elementwise_plain(F, fpm.HV, hv, r, h, s))
                w2, hv2 = F.bind_hv(Whs, hv, h, r, s)
                _same(hv2, P.elementwise_plain(F, fpm.HV, hv, r, h, s))
                _same(w2, P.elementwise_plain(F, fpm.BIND, Whs, r))
    _k3_scratch_clear()
    assert kernels.LAUNCHES["fp_wire_round[%s]" % F.tag] - n0 == calls


@pytest.mark.parametrize("field", list(FIELDS) + ["fp24", "fp64", "p256n",
                                                  "p256k1n", "p384", "p521"])
def test_k3_axis_sum_one_launch(dev, field):
    """K3's sum mode (one launch: the last block of an output sums its
    partials) at every instance: many blocks an output (R = 70,000) over
    15 outputs, one block an output over 1,000, back to back; the
    tickets left zero."""
    mk = dict(FIELDS, **API_FIELDS)
    F, rng = mk[field](), np.random.default_rng(240)
    x = _elts(F, rng, 3 * 70000 * 5, dev).reshape(3, 70000, 5, F.nlimb)
    x[0, :20000] = F.to_limbs(F.p - 1 if not F.kCharacteristicTwo
                              else (1 << 128) - 1, dev)
    y = x[:, :200].contiguous()
    for t, dim in ((x, 1), (y, 1), (y, 0), (x, 1)):
        _same(F.lazy_sum(t, dim), fpm.plain_of(F).axis_sum_plain(F, t, dim))
    _k3_scratch_clear()


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("T", [0, 1, 1000, 70001])
@pytest.mark.parametrize("field", list(FIELDS))
def test_k23_layer_hv(dev, field, T, lanes):
    """K23 against its plain version: hv = (bmask ? beta : v) * dot[g],
    beta a view with its lanes 2 elements apart (the prover's alpha and
    beta draws), every output wire reached, a quarter of the terms
    flagged."""
    F, rng = FIELDS[field](), np.random.default_rng(250 + T)
    nv = 1 << 10
    dot = _elts(F, rng, lanes * nv, dev).reshape(lanes, nv, F.nlimb)
    g = torch.as_tensor(rng.integers(0, nv, T, dtype=np.int32), device=dev)
    v = _elts(F, rng, T, dev)
    bmask = torch.as_tensor(rng.random(T) < 0.25, device=dev)
    ab = _elts(F, rng, 2 * lanes, dev).reshape(lanes, 2, F.nlimb)
    n0 = kernels.LAUNCHES["layer_hv[%s]" % F.tag]
    got = F.layer_hv(dot, g, v, bmask, ab[:, 1])
    assert kernels.LAUNCHES["layer_hv[%s]" % F.tag] - n0 == 1
    _same(got, fpm.plain_of(F).layer_hv_plain(F, dot, g, v, bmask, ab[:, 1]))


@pytest.mark.parametrize("lanes", [1, 8])
def test_k23_sha_circuit_layers(dev, lanes):
    """K23 at every layer of the SHA-256 circuit, in the order of its
    wire rounds (SumcheckProver._hv_terms: the merge plan's permutation
    where the layer has one), against its plain version."""
    import gzip
    import os
    from longfellow_zk_tpu_torch.proto.lfc1 import FP128_ID, read_circuit
    from longfellow_zk_tpu_torch.sumcheck.prover import SumcheckProver
    F, rng = fp128(), np.random.default_rng(260)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    circ = read_circuit(F, FP128_ID, gzip.open(os.path.join(
        root, "artifacts", "sha256_1block_fp128.lfc1.gz"), "rb").read())
    sp = SumcheckProver(F, dev)
    for ly, layer in enumerate(circ.layers):
        nv = circ.layers[ly - 1].nw if ly > 0 else circ.nv
        nv = 1 << max(0, (nv - 1).bit_length())
        ht = sp._hv_terms(layer.quad, layer.logw)
        dot = _elts(F, rng, lanes * nv, dev).reshape(lanes, nv, F.nlimb)
        beta = _elts(F, rng, lanes, dev)
        _same(F.layer_hv(dot, ht["g"], ht["v"], ht["bmask"], beta),
              fpm.layer_hv_plain(F, dot, ht["g"], ht["v"], ht["bmask"],
                                 beta))


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("field", list(FIELDS))
def test_k24_eq_table(dev, field, lanes):
    """K24 against its plain version in modes 1 and 2 at logn 0-20 (8
    lanes to 2^16), n = 2^logn, 2^logn - 3 and 2^(logn - 1) + 1: the
    challenges views of rows as the prover's (2 x 4 elements apart, the
    lanes a row apart; at one lane contiguous [logn, N]), alpha a view 2
    elements apart; one launch a call."""
    F, rng = FIELDS[field](), np.random.default_rng(300 + lanes)
    name = "eq_table[%s]" % F.tag
    for logn in range(21):
        B = lanes if logn <= 16 else 1
        rows = _elts(F, rng, B * max(1, logn) * 8, dev).reshape(
            (B, max(1, logn), 2, 4) + F.elt_shape)[:, :logn]
        ab = _elts(F, rng, 2 * B, dev).reshape((B, 2) + F.elt_shape)
        q, q1, alpha = rows[:, :, 0, 3], rows[:, :, 1, 3], ab[:, 0]
        if B == 1:
            q, q1, alpha = (q[0].contiguous(), q1[0].contiguous(),
                            alpha[0].contiguous())
        for n in sorted({1 << logn, max(1, (1 << logn) - 3),
                         (1 << logn) // 2 + 1}):
            for args in ((q, n), (q, n, alpha, q1)):
                n0 = kernels.LAUNCHES[name]
                got = F.eq_table(*args)
                assert kernels.LAUNCHES[name] - n0 == 1
                _same(got, fpm.plain_of(F).eq_table_plain(F, *args))


def test_k24_bad_inputs_raise(dev):
    """K24 raises on inputs it does not take; nothing falls back."""
    F, rng = fp128(), np.random.default_rng(310)
    q = _elts(F, rng, 8, dev).reshape(2, 4, 4)
    a = _elts(F, rng, 2, dev)
    for call in (lambda: F.eq_table(q, 17),            # n > 2^logn
                 lambda: F.eq_table(q, 0),
                 lambda: F.eq_table(q, 16, a),          # alpha without q1
                 lambda: F.eq_table(q, 16, a[:1], q),   # one alpha, 2 lanes
                 lambda: F.eq_table(q[:, :3], 8, a, q),  # q1's shape
                 lambda: F.eq_table(q.to(torch.int64), 16),
                 lambda: F.eq_table(q.transpose(1, 2), 16)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(NotImplementedError):
        fpm.fp_eq_table(p256_scalar(), _elts(p256_scalar(), rng, 2, dev), 4)
