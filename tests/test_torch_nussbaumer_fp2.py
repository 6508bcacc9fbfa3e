"""The port's Nussbaumer convolution over Fp2 (P-256, i^2 = -1;
transforms/nussbaumer.py with the plain versions of K19 and K20
[fp256x2], CPU): negacyclic, cyclic and linear against the JAX
package's P-256 convolutions of the parts, one butterfly level against
the JAX _apply_rot over Fp2, the base case against host ints, and
NussbaumerConvolution against the JAX package's Fp2 NTT convolution, on
planar arrays made from a numpy seed.  Exact: tolerance 0.  The JAX
side runs eagerly.  The JAX package's own Fp2 Nussbaumer path sums its
base case along the wrong axis; the last test records it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields import fp_instances as jfi
from longfellow_zk_tpu.fields.fp2 import Fp2 as JaxFp2
from longfellow_zk_tpu.transforms import nussbaumer as jnb
from longfellow_zk_tpu.transforms.ntt import FFTConvolution as JaxFFTConv
from longfellow_zk_tpu_torch.fields import fp_instances as pfi
from longfellow_zk_tpu_torch.fields.bridge import fp2_from_jax, fp2_to_jax
from longfellow_zk_tpu_torch.fields.fp2 import Fp2
from longfellow_zk_tpu_torch.transforms import nussbaumer as nb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fp2_fields():
    return JaxFp2(jfi.p256_base()), Fp2(pfi.p256_base())


def _rows2(F2, shape, seed):
    """Port int32[*shape, 2, N] Fp2 elements (0, 1, p - 1 + (p - 1) i
    first) and their host (re, im) tuples."""
    rng = np.random.default_rng(seed)
    p, n = F2.f.p, int(np.prod(shape))
    vals = [(0, 0), (1, 0), (p - 1, p - 1)] + [
        tuple(int.from_bytes(rng.bytes(32), "little") % p for _ in range(2))
        for _ in range(n)]
    vals = vals[:n]
    return F2.to_limbs(vals, "cpu").reshape(tuple(shape) + (2, F2.nlimb)), \
        vals


def _jax_parts_conv(J2, fn, jx, jy):
    """The Fp2 convolution `fn` of planar x and y from three JAX
    prime-field convolutions of the parts in one batched call
    (Karatsuba): re = x0 y0 - x1 y1, im = (x0 + x1)(y0 + y1) - x0 y0 - x1
    y1."""
    F = J2.f
    xs = jnp.stack([jx[0], jx[1], F.add(jx[0], jx[1])], axis=1)
    ys = jnp.stack([jy[0], jy[1], F.add(jy[0], jy[1])], axis=1)
    z = fn(F, xs, ys)                   # [L, 3, ...]
    p0, p1, s = z[:, 0], z[:, 1], z[:, 2]
    return jnp.stack([F.sub(p0, p1), F.sub(F.sub(s, p0), p1)])


@pytest.mark.parametrize("n", [4, 64])
def test_fp2_convolutions_match_jax(fp2_fields, n):
    """negacyclic, cyclic and linear over Fp2 at n = 4 (the base case)
    and n = 64 (negacyclic(64) splits once, the cyclic splits recurse to
    the base case), 2 rows, y once as full rows and once as one row
    broadcast: against the JAX package's P-256 convolutions of the parts
    (its Fp2 case is no reference, test_jax_fp2_base_case_sums_over_k)."""
    J2, F2 = fp2_fields
    px, _ = _rows2(F2, (2, n), n)
    py, _ = _rows2(F2, (2, n), 500 + n)
    jx, jy = jnp.asarray(fp2_to_jax(px)), jnp.asarray(fp2_to_jax(py))
    for name in ("negacyclic", "cyclic", "linear"):
        got = getattr(nb, name)(F2, px, py)
        want = _jax_parts_conv(J2, getattr(jnb, name), jx, jy)
        assert np.array_equal(fp2_to_jax(got), np.asarray(want)), name
    yb = py[:1].expand_as(py).contiguous()
    assert torch.equal(nb.cyclic(F2, px, py[0]), nb.cyclic(F2, px, yb))


@pytest.mark.parametrize("negacyclic", [False, True])
def test_fp2_base_conv_plain_matches_host(fp2_fields, negacyclic):
    """K20 [fp256x2]'s plain version at 8 points, y with fewer rows,
    against host Fp2 ints."""
    _, F2 = fp2_fields
    px, xs = _rows2(F2, (3, 8), 8)
    py, ys = _rows2(F2, (1, 8), 9)
    got = F2.from_limbs(nb.nb_base_conv_plain(F2, px, py, negacyclic))
    for r in range(3):
        for k in range(8):
            acc = (0, 0)
            for j in range(8):
                t = F2.mul_i(xs[8 * r + j], ys[(k - j) % 8])
                acc = F2.add_i(acc, F2.neg_i(t) if negacyclic and j > k
                               else t)
            assert tuple(got[r, k]) == acc


def test_fp2_butterfly_plain_matches_apply_rot(fp2_fields):
    """One level of the block-axis FFT over Fp2 (K19 [fp256x2]'s plain
    version) against the JAX _apply_rot and butterflies on planar
    arrays, both directions."""
    J2, F2 = fp2_fields
    M, r, h, step = 8, 8, 2, -6
    pA, _ = _rows2(F2, (3, M, r), 88)
    jA = jnp.asarray(fp2_to_jax(pA))
    Ar = jA.reshape(jA.shape[:2] + (3, M // (2 * h), 2, h, r))
    lo, hi = Ar[..., 0, :, :], Ar[..., 1, :, :]
    shifts = tuple(step * t for t in range(h))
    for inverse in (False, True):
        if inverse:
            rh = jnb._apply_rot(J2, hi, shifts)
            pair = [J2.add(lo, rh), J2.sub(lo, rh)]
        else:
            pair = [J2.add(lo, hi), jnb._apply_rot(J2, J2.sub(lo, hi),
                                                   shifts)]
        want = jnp.stack(pair, axis=-3).reshape(jA.shape)
        got = nb.nb_butterfly_plain(F2, pA, h, step, inverse)
        assert np.array_equal(fp2_to_jax(got), np.asarray(want))


def test_fp2_nussbaumer_convolution_matches_jax_fft(fp2_fields):
    """NussbaumerConvolution over Fp2 (the Reed-Solomon convolver's
    contract, n = 6 into m = 13, padding 16) against the JAX package's
    FFTConvolution over Fp2 with the 2^31-th root of unity."""
    J2, F2 = fp2_fields
    n, m = 6, 13
    px, _ = _rows2(F2, (3, n), 20)
    _, ys = _rows2(F2, (m,), 21)
    got = nb.NussbaumerConvolution(n, m, F2, ys, "cpu").convolution(px)
    omega = (pfi.P256_FP2_ROOT_X, pfi.P256_FP2_ROOT_Y)
    want = JaxFFTConv(n, m, J2, omega, pfi.P256_FP2_ROOT_ORDER,
                      ys).convolution(jnp.asarray(fp2_to_jax(px)))
    assert got.shape == (3, m, 2, F2.nlimb)
    assert torch.equal(got, fp2_from_jax(np.asarray(want)))


def test_jax_fp2_base_case_sums_over_k(fp2_fields):
    """Why the Fp2 cases above are held to the JAX package's prime-field
    convolutions and not to its Fp2 path: its _base_conv over Fp2 sums the
    product terms [2, L, ..., j, k] along k, not j (_sum_terms passes axis
    - 1 to lazy_sum, which leaves out one leading axis, not _nlead's two),
    so its Fp2 negacyclic(4) is out[j] = x[j] * sum_k (+-) y[k - j], not a
    convolution; the port computes the convolution."""
    J2, F2 = fp2_fields
    px, xs = _rows2(F2, (4,), 40)
    py, ys = _rows2(F2, (4,), 41)
    jout = J2.from_limbs(np.asarray(jnb.negacyclic(
        J2, jnp.asarray(fp2_to_jax(px)), jnp.asarray(fp2_to_jax(py)))))
    conv, over_k = [], []
    for a in range(4):
        c, t = (0, 0), (0, 0)
        for b in range(4):
            u = F2.mul_i(xs[b], ys[(a - b) % 4])
            c = F2.add_i(c, F2.neg_i(u) if b > a else u)
            v = F2.mul_i(xs[a], ys[(b - a) % 4])
            t = F2.add_i(t, F2.neg_i(v) if b < a else v)
        conv.append(c)
        over_k.append(t)
    assert [tuple(map(int, v)) for v in jout] == over_k != conv
    assert [tuple(v) for v in F2.from_limbs(nb.negacyclic(F2, px, py))] == \
        conv
