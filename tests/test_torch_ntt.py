"""The port's NTT and Reed-Solomon encoder (plain K4 version, CPU) against
the JAX package's transforms/ntt.py on the same inputs, made from a numpy
seed, and K4's schedule (csrc/ntt.cu: ntt_plan's routes, the tiles' index
maps and twiddles) replayed on the plain products against ntt_plain and
the JAX NTT.  Exact: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields import multiprime as jax_multiprime
from longfellow_zk_tpu.fields.fp2 import Fp2 as JaxFp2
from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.fields.fp_instances import p256_base as jax_p256
from longfellow_zk_tpu.transforms.ntt import NTT as JaxNTT
from longfellow_zk_tpu.zk.testing import rs_factory_for as jax_rs_factory
from longfellow_zk_tpu_torch.fields.bridge import (
    fp2_from_jax, limbs_from_jax, limbs_to_jax, mp_from_jax, mp_to_jax)
from longfellow_zk_tpu_torch.fields.fp import ADD, MUL, SUB
from longfellow_zk_tpu_torch.fields.fp2 import Fp2
from longfellow_zk_tpu_torch.fields.fp_instances import (
    P128_OMEGA, P128_OMEGA_ORDER, P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X,
    P256_FP2_ROOT_Y, fp128, p256_base)
from longfellow_zk_tpu_torch.fields.multiprime import MultiPrimeField
from longfellow_zk_tpu_torch.transforms import ntt as ntt_mod
from longfellow_zk_tpu_torch.transforms.ntt import (
    NTT, NTT_SMEM, ntt_plain, ntt_plan, ntt_plan_two)
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


# -- K4's schedule (csrc/ntt.cu), replayed on the plain products ---------
#
# The kernel's index maps written out again in numpy: which element each
# block's tile loads (bit-reversed, __brev), the butterflies of each stage
# and the stage twiddle tw[h - 1 + j] each reads, step A's twiddle
# w^(j1 k2) (tw[n/2 - 1 + e], negated past n/2), the cluster's reads of
# the other blocks' tiles and the stores y[j1 + n1 j2], over the plans
# that ntt_plan makes for 1, 18 and 450 rows (a row a cluster of 8, 2 or
# 1 blocks) and for route 2.  The tiles of all blocks lie in one flat
# buffer, block b's at b times its size; the products are ntt_plain's.


def _brev(k, nbits):
    k = np.asarray(k, dtype=np.int64)
    r = np.zeros_like(k)
    for b in range(nbits):
        r |= ((k >> b) & 1) << (nbits - 1 - b)
    return r


class _Replay:
    def __init__(self, F, tw):
        self.F, self.tw, self.mp = F, tw, isinstance(F, MultiPrimeField)
        self.E = tuple(F.elt_shape)

    def op(self, mode, a, b):
        if self.mp:  # one prime lane: a leading lane axis for the plain op
            return ntt_mod._plain(self.F, mode, a[None], b[None])[0]
        return ntt_mod._plain(self.F, mode, a, b)

    def tws(self, idx):
        return (self.tw[0] if self.mp else self.tw)[torch.as_tensor(idx)]

    def buf(self, n):
        return torch.zeros((n,) + self.E, dtype=torch.int32)

    def stages(self, buf, base, lm, count, se, sd):
        if lm == 0:
            return
        hm = 1 << (lm - 1)
        b = np.arange(count << (lm - 1))
        d, q = b >> (lm - 1), b & (hm - 1)
        for s in range(lm):
            h = 1 << s
            j = q & (h - 1)
            a0 = (((q >> s) << (s + 1)) + j) * se + d * sd
            i0 = torch.as_tensor((base[:, None] + a0[None]).ravel())
            i1 = i0 + h * se
            lo, t = buf[i0], buf[i1]
            if s:
                t = self.op(MUL, t, self.tws(np.tile(h - 1 + j, len(base))))
            buf[i0] = self.op(ADD, lo, t)
            buf[i1] = self.op(SUB, lo, t)

    def cols(self, A, base, x, xbase, l1, l2, lcol, k2base):
        ncol = 1 << lcol
        e = np.arange(ncol << l1)
        k1, kl = e >> lcol, e & (ncol - 1)
        A[torch.as_tensor((base[:, None] + ((_brev(k1, l1) << lcol) + kl)
                           [None]).ravel())] = x[torch.as_tensor(
                               (xbase[:, None] + (k1 << l2)[None] +
                                k2base[:, None] + kl[None]).ravel())]
        self.stages(A, base, l1, ncol, ncol, 1)
        hn = 1 << (l1 + l2 - 1)
        ex = (e >> lcol)[None] * (k2base[:, None] + kl[None])
        live = ex != 0
        idx = torch.as_tensor((base[:, None] + e[None])[live])
        exl = ex[live]
        if len(exl):
            v = self.op(MUL, A[idx], self.tws(hn - 1 + (exl & (hn - 1))))
            neg = torch.as_tensor(exl >= hn)
            v[neg] = self.op(SUB, self.op(SUB, v, v), v)[neg]
            A[idx] = v

    def rows_out(self, B, base, y, ybase, l1, l2, lrow, j1base):
        self.stages(B, base, l2, 1 << lrow, 1, 1 << l2)
        e = np.arange(1 << (lrow + l2))
        jl, j2 = e & ((1 << lrow) - 1), e >> lrow
        y[torch.as_tensor((ybase[:, None] + j1base[:, None] + jl[None] +
                           (j2 << l1)[None]).ravel())] = B[torch.as_tensor(
                               (base[:, None] + ((jl << l2) + j2)[None])
                               .ravel())]

    def run(self, x, plan):
        rows, n = x.shape[0], x.shape[1]
        logn = n.bit_length() - 1
        x = x.reshape((rows * n,) + self.E)
        y = self.buf(rows * n)
        l1, l2 = plan.l1, logn - plan.l1
        if plan.route == 1:
            lcs = plan.la
            bi = np.arange(rows << lcs)
            r, c = bi >> lcs, bi & ((1 << lcs) - 1)
            blk = n >> lcs
            B = self.buf(rows * n)
            if lcs == 0:
                e = np.arange(n)
                B[torch.as_tensor((r[:, None] * n + _brev(e, logn)[None])
                                  .ravel())] = x
                self.rows_out(B, r * n, y, r * n, 0, logn, 0, 0 * r)
            else:
                lcol, lrow = l2 - lcs, l1 - lcs
                A = self.buf(rows * n)
                self.cols(A, bi * blk, x, r * n, l1, l2, lcol, c << lcol)
                e = np.arange(blk)
                jl, k2 = e >> l2, e & ((1 << l2) - 1)
                owner = (r << lcs)[:, None] + (k2 >> lcol)[None]
                src = owner * blk + (((c << lrow)[:, None] + jl[None])
                                     << lcol) + (k2 & ((1 << lcol) - 1))[None]
                B[torch.as_tensor((bi[:, None] * blk + ((jl << l2) +
                                   _brev(k2, l2))[None]).ravel())] = \
                    A[torch.as_tensor(src.ravel())]
                self.rows_out(B, bi * blk, y, r * n, l1, l2, lrow,
                              c << lrow)
        else:
            la, lb = plan.la, plan.lb
            bi = np.arange(rows << (l2 - la))
            r, g = bi >> (l2 - la), bi & ((1 << (l2 - la)) - 1)
            ta = 1 << (l1 + la)
            A, z = self.buf(len(bi) * ta), self.buf(rows * n)
            self.cols(A, bi * ta, x, r * n, l1, l2, la, g << la)
            e = np.arange(ta)
            z[torch.as_tensor((r[:, None] * n + ((e >> la) << l2)[None] +
                               (g << la)[:, None] +
                               (e & ((1 << la) - 1))[None]).ravel())] = \
                A[torch.as_tensor((bi[:, None] * ta + e[None]).ravel())]
            bi = np.arange(rows << (l1 - lb))
            r, g = bi >> (l1 - lb), bi & ((1 << (l1 - lb)) - 1)
            tb = 1 << (lb + l2)
            B = self.buf(len(bi) * tb)
            e = np.arange(tb)
            jl, k2 = e >> l2, e & ((1 << l2) - 1)
            B[torch.as_tensor((bi[:, None] * tb + ((jl << l2) +
                               _brev(k2, l2))[None]).ravel())] = \
                z[torch.as_tensor((r[:, None] * n + (((g << lb)[:, None] +
                                   jl[None]) << l2) + k2[None]).ravel())]
            self.rows_out(B, bi * tb, y, r * n, l1, l2, lb, g << lb)
        return y.reshape((rows, n) + self.E)


def _plans(n, eb):
    """The distinct plans of K4 for rows of n elements of eb bytes: route
    1 for 1, 18 and 450 rows where it holds a row, and route 2."""
    plans = {ntt_plan(n, rows, eb) for rows in (1, 18, 450)}
    return sorted(plans | {ntt_plan_two(n, 1, eb)})


def _field_case(field, n, rng):
    """(F, port rows [2, n, *E], twiddles of fftb, a JAX check or None)."""
    if field == "fp128":
        F = fp128()
        vals = [int.from_bytes(rng.bytes(16), "little") % F.p
                for _ in range(2 * n)]
        x = F.to_limbs(vals, "cpu").reshape(2, n, 4)
        nt = NTT(F, P128_OMEGA, P128_OMEGA_ORDER, "cpu")

        def jax_fftb():
            J = jax_fp128()
            jx = jnp.asarray(J.to_limbs(vals)).reshape(8, 2, n)
            return limbs_from_jax(np.asarray(JaxNTT(
                J, P128_OMEGA, P128_OMEGA_ORDER).fftb(jx)))
    elif field == "fp256x2":
        F = Fp2(p256_base())
        vals = [(int.from_bytes(rng.bytes(32), "little") % F.f.p,
                 int.from_bytes(rng.bytes(32), "little") % F.f.p)
                for _ in range(2 * n)]
        x = F.to_limbs(vals, "cpu").reshape(2, n, 2, 8)
        omega2 = (P256_FP2_ROOT_X, P256_FP2_ROOT_Y)
        nt = NTT(F, omega2, P256_FP2_ROOT_ORDER, "cpu")

        def jax_fftb():
            J2 = JaxFp2(jax_p256())
            jx = jnp.asarray(J2.to_limbs(vals)).reshape(2, 16, 2, n)
            return fp2_from_jax(np.asarray(JaxNTT(
                J2, omega2, P256_FP2_ROOT_ORDER).fftb(jx)))
    else:
        F = MultiPrimeField(1)
        w = rng.integers(0, F.primes[0], (1, 2, n, 1)).astype(np.uint32)
        xl = torch.as_tensor(w.view(np.int32))  # [VS = 1, 2, n, 1]
        x = xl[0]
        nt = NTT(F, F.omegas, F.omega_order, "cpu")

        def jax_fftb():
            J = jax_multiprime.MultiPrimeField(1)
            return mp_from_jax(np.asarray(JaxNTT(
                J, J.omegas, J.omega_order).fftb(jnp.asarray(mp_to_jax(xl))))
                )[0]
    return F, x, nt.twiddles(n, False), jax_fftb


@pytest.mark.parametrize("field", ["fp128", "fp256x2", "crt"])
def test_k4_schedule_replay(field):
    """K4's index maps at n = 2^1 .. 2^12 (Fp2 to 2^11, its largest row on
    a path), every plan, against ntt_plain; at n = 4 also against the JAX
    package's NTT.fftb (eager: 16 s at 4,096 points)."""
    rng = np.random.default_rng({"fp128": 41, "fp256x2": 42, "crt": 43}[field])
    top = 11 if field == "fp256x2" else 12
    nplans = set()
    for logn in range(1, top + 1):
        n = 1 << logn
        F, x, tw, jax_fftb = _field_case(field, n, rng)
        eb = 4 * int(np.prod(F.elt_shape))
        want = ntt_plain(F, x, tw)
        for plan in _plans(n, eb):
            # two rows up to 256 points (the rows' offsets), then one
            got = _Replay(F, tw).run(x if n <= 256 else x[:1], plan)
            assert torch.equal(got, want[: got.shape[0]]), (n, plan)
            nplans.add((plan.route, plan.la if plan.route == 1 else None))
        if n == 4:
            assert torch.equal(want, jax_fftb())
    # a row a block and clusters of 2, 4 and 8; the two-launch route
    assert {(1, 0), (1, 1), (1, 2), (1, 3)} <= nplans and any(
        r == 2 for r, _ in nplans)


def test_k4_plan_launches():
    """One launch a transform where a cluster holds a row (the proofs'
    tableaus: 18 x 2,048 Fp128, 14 x 2,048 Fp2, 450 x 4,096 residues),
    two for 2^20 points; the tiles within the shared memory."""
    for n, rows, eb in ((2048, 18, 16), (2048, 14, 64), (4096, 450, 4),
                        (2048, 144, 16)):
        p = ntt_plan(n, rows, eb)
        assert p.route == 1 and p.launches == 1, (n, rows, eb, p)
        assert (n * eb if p.la == 0 else 2 * (n >> p.la) * eb) <= NTT_SMEM
    for eb in (16, 64):
        p = ntt_plan(1 << 20, 1, eb)
        assert p.route == 2 and p.launches == 2
        assert eb << (p.l1 + p.la) <= NTT_SMEM
        assert eb << (p.lb + 20 - p.l1) <= NTT_SMEM
    with pytest.raises(ValueError):
        ntt_plan_two(1 << 30, 1, 64)
