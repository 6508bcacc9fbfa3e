"""K1 fp_elementwise's plain versions (fields/fp.py, CPU) at P-521 and
the ML-DSA prime, at the shapes where the kernel's 17-word path (a tile
of TILE17 elements a block) and one-word path (four elements a thread)
split, against the JAX package's select, add and sub (fields/fp.py:507,
:245, :255) on the same inputs, made from a numpy seed: b full, one
element and a row over two rows; the conditions full, a row and a
column; operands that are views one element into their tensors.  The
JAX functions get the operands broadcast and copied; the port's take
them as they are.  Field arithmetic is exact: the Montgomery limbs must
be equal through the bridge (fields/bridge.py field_to_jax) and the
values equal to the host ints (tolerance 0).  tests/test_torch_kernels.py
holds the kernels to these plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields import fp24 as jfp24
from longfellow_zk_tpu.fields import fp_instances as jfi
from longfellow_zk_tpu_torch import kernels
from longfellow_zk_tpu_torch.fields import fp as fpm
from longfellow_zk_tpu_torch.fields import fp24 as pfp24
from longfellow_zk_tpu_torch.fields import fp_instances as pfi
from longfellow_zk_tpu_torch.fields.bridge import field_to_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = {"p521": (jfi.p521_base, pfi.p521_base),
          "fp24": (jfp24.fp24, pfp24.fp24)}
TILE = kernels.k1_tile()


def test_tile_size():
    """A tile of 17-word elements starts on a 16-byte boundary."""
    assert TILE % 4 == 0 and TILE * 68 % 16 == 0


@pytest.mark.parametrize("n", [1, 3, TILE + 1])
@pytest.mark.parametrize("field", list(FIELDS))
def test_select_add_sub_match_jax(field, n):
    J, F = (make() for make in FIELDS[field])
    rng = np.random.default_rng(140 + n)
    m = 2 * n + 2
    vals = [0, 1, F.p - 1] + [int.from_bytes(rng.bytes(4 * F.nlimb + 2),
                                             "little") % F.p
                              for _ in range(2 * m)]
    xs, ys = vals[:m], vals[m : 2 * m]
    ys[::3] = xs[::3]
    a, b = F.to_limbs(xs, "cpu"), F.to_limbs(ys, "cpu")
    cond = torch.as_tensor(rng.random(m) < 0.5)
    rows = a[: 2 * n].reshape(2, n, F.nlimb)
    cases = [(a[:n], b[:n], cond[:n]), (a[1 : n + 1], b[1 : n + 1],
                                        cond[1 : n + 1]),
             (a[:n], b[n + 1], cond[:n]), (rows, b[1 : n + 1], cond[:n]),
             (rows, b[:n], cond[:2].reshape(2, 1))]
    ops = {"add": (fpm.ADD, J.add, lambda x, y, t: (x + y) % F.p),
           "sub": (fpm.SUB, J.sub, lambda x, y, t: (x - y) % F.p),
           "select": (fpm.SELECT, None, lambda x, y, t: x if t else y)}
    for k, (x, y, c) in enumerate(cases):
        shape = tuple(torch.broadcast_shapes(x.shape[:-1], y.shape[:-1],
                                             c.shape))
        xf = x.expand(shape + (F.nlimb,)).contiguous()
        yf = y.expand(shape + (F.nlimb,)).contiguous()
        cf = c.expand(shape).contiguous()
        jx, jy = (jnp.asarray(field_to_jax(F, t)) for t in (xf, yf))
        hx = [int(v) for v in np.ravel(F.from_limbs(xf))]
        hy = [int(v) for v in np.ravel(F.from_limbs(yf))]
        ht = cf.reshape(-1).tolist()
        for name, (mode, jfn, host) in ops.items():
            got = fpm.fp_elementwise(F, mode, x, y, c)
            want = J.select(jnp.asarray(cf.numpy()), jx, jy) if jfn is None \
                else jfn(jx, jy)
            assert got.shape == shape + (F.nlimb,), (name, k)
            assert np.array_equal(field_to_jax(F, got), np.asarray(want)), \
                (name, k)
            assert [int(v) for v in np.ravel(F.from_limbs(got))] == [
                host(u, v, t) for u, v, t in zip(hx, hy, ht)], (name, k)
