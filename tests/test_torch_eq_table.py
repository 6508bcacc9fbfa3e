"""K24 eq_table, the sumcheck's EQ tables: its plain version (F.eq_table on
the CPU) against the JAX package's host eq_array_host / raw_eq2_host
(sumcheck/eqs.py) and device _eq_dev / _raw_eq2_dev (sumcheck/
prover_device.py:107, :124, eager), and its device code (csrc/
eq_table.cu eq_block: the half tables by doubling, the chunks' top
products, an entry a product a table) compiled for the host with
tests/cuda_host/cuda_runtime.h (one thread plays every thread of a block,
block after block), against the plain version.  In mode 1 a table is
EQ(q, i), in mode 2 EQ(q, i) + alpha EQ(q1, i), for 0 <= i < n <= 2^logn.
Inputs come from a numpy seed; the four sumcheck fields (Fp128, the
P-256 and secp256k1 base fields, GF(2^128)); compared as canonical
integers, exactly.  The kernel itself is held to its plain version on the
card by tests/test_torch_kernels.py.
"""

import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields import fp_instances as jfi
from longfellow_zk_tpu.fields.gf2 import gf2_128 as jax_gf2_128
from longfellow_zk_tpu.sumcheck import eqs as jeqs
from longfellow_zk_tpu.sumcheck.prover_device import (
    _eq_dev as jax_eq_dev, _raw_eq2_dev as jax_raw_eq2_dev)
from longfellow_zk_tpu_torch.fields import fp_instances as pfi
from longfellow_zk_tpu_torch.fields.fp import eq_table_plain
from longfellow_zk_tpu_torch.fields.gf2 import gf2_128

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "longfellow_zk_tpu_torch", "csrc")

# field -> (JAX field, port field, csrc/fp.cuh's constants struct)
FIELDS = {"fp128": (jfi.fp128, pfi.fp128, "P128"),
          "p256_base": (jfi.p256_base, pfi.p256_base, "P256"),
          "p256k1_base": (jfi.p256k1_base, pfi.p256k1_base, "P256K1"),
          "gf2_128": (jax_gf2_128, gf2_128, "G128")}


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


def _ns(logn):
    """n = 2^logn, ragged 2^logn - 3, and 1."""
    return sorted({1 << logn, max(1, (1 << logn) - 3), 1})


def _case(F, rng, logn, lanes, mode):
    """(q, alpha, q1) as ints a lane, and the port's tensors (2-D q at one
    lane: the wrapper's form without a lane axis)."""
    q = [_elts(F, rng, logn) for _ in range(lanes)]
    ints = (q, None, None)
    if mode == 2:
        ints = (q, _elts(F, rng, lanes), [_elts(F, rng, logn)
                                          for _ in range(lanes)])

    def tens(v, shape):
        t = F.to_limbs([x for row in v for x in row], "cpu")
        return t.reshape(shape + F.elt_shape)

    lead = (lanes,) if lanes > 1 else ()
    qt = tens(q, lead + (logn,))
    if mode == 1:
        return ints, (qt, None, None)
    return ints, (qt, tens([ints[1]], lead), tens(ints[2], lead + (logn,)))


def _want_host(J, logn, n, ints, b):
    q, alpha, q1 = ints
    if alpha is None:
        return jeqs.eq_array_host(J, logn, n, q[b])
    return jeqs.raw_eq2_host(J, logn, n, q[b], q1[b], alpha[b])


@pytest.mark.parametrize("field", list(FIELDS))
def test_eq_table_plain_matches_host(field):
    """Modes 1 and 2, logn 0-8, n = 2^logn, 2^logn - 3 and 1, lanes 1
    and 3, against the JAX package's eq_array_host and raw_eq2_host."""
    jmk, pmk, _ = FIELDS[field]
    J, F = jmk(), pmk()
    rng = np.random.default_rng(190 + list(FIELDS).index(field))
    for logn in range(9):
        for n in _ns(logn):
            for lanes in (1, 3):
                for mode in (1, 2):
                    ints, (q, alpha, q1) = _case(F, rng, logn, lanes, mode)
                    got = F.eq_table(q, n, alpha, q1)
                    assert got.shape == ((lanes,) if lanes > 1 else ()) + \
                        (n,) + F.elt_shape
                    got = got.reshape((lanes, n) + F.elt_shape)
                    for b in range(lanes):
                        assert list(F.from_limbs(got[b])) == _want_host(
                            J, logn, n, ints, b), (logn, n, lanes, mode, b)


@pytest.mark.parametrize("field", list(FIELDS))
def test_eq_table_plain_matches_jax_device(field):
    """Modes 2 and 1 at logn 3, n 5, 2 lanes against the JAX package's
    _raw_eq2_dev and _eq_dev (eager: each op and shape compiles, so one
    small case a field; _raw_eq2_dev runs _eq_dev on the same shapes)."""
    jmk, pmk, _ = FIELDS[field]
    J, F = jmk(), pmk()
    rng = np.random.default_rng(290 + list(FIELDS).index(field))
    logn, n, lanes = 3, 5, 2
    for mode in (2, 1):
        (q, alpha, q1), (qt, at, q1t) = _case(F, rng, logn, lanes, mode)
        got = F.eq_table(qt, n, at, q1t)
        # a lane at a time, as the JAX batch prover's vmap takes them
        for b in range(lanes):
            if mode == 1:
                want = jax_eq_dev(J, logn, n, jnp.asarray(J.to_limbs(q[b])))
            else:
                want = jax_raw_eq2_dev(
                    J, logn, n, jnp.asarray(J.to_limbs(q[b])),
                    jnp.asarray(J.to_limbs(q1[b])),
                    jnp.asarray(J.to_limbs(alpha[b])))
            want = [int(x) for x in np.asarray(J.from_limbs(want))]
            assert len(want) == n
            assert list(F.from_limbs(got[b])) == want


# -- K24's device code on the host ------------------------------------------

HARNESS = r"""
#include "eq_dev.inc"
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <vector>

static char* next(char** p) { return strtok_r(nullptr, " \n", p); }

template <class C>
static void elt_in(const char* h, std::vector<uint4>& v, int i) {
  uint8_t* b = (uint8_t*)&v[(size_t)i * Fp<C>::V];
  for (int k = 0; k < 4 * C::N; k++) {
    unsigned x;
    sscanf(h + 2 * k, "%2x", &x);
    b[k] = (uint8_t)x;
  }
}

// <field> mode logn n G cmin tmax q0... [q1... alpha]: the lane's table
// made by the G blocks of eq_block, one after another
template <class C>
static void run(char** p) {
  const int mode = atoi(next(p)), logn = atoi(next(p));
  const uint32_t n = (uint32_t)atol(next(p));
  const uint32_t G = (uint32_t)atoi(next(p));
  const int cmin = atoi(next(p)), tmax = atoi(next(p));
  const int V = Fp<C>::V;
  EqPlan P = eq_plan(logn, n, mode, cmin, tmax);
  P.per = (P.chunks + G - 1) / G;
  std::vector<uint4> q0(V * (logn + 1)), q1(V * (logn + 1)), alpha(V),
      out((size_t)V * n), sm((size_t)V * eq_smem_elts(P));
  for (int t = 0; t < logn; t++) elt_in<C>(next(p), q0, t);
  if (mode == 2) {
    for (int t = 0; t < logn; t++) elt_in<C>(next(p), q1, t);
    elt_in<C>(next(p), alpha, 0);
  }
  for (uint32_t bx = 0; bx < G; bx++)
    eq_block<C>(sm.data(), out.data(), q0.data(), q1.data(), alpha.data(),
                1, 1, P, bx, G, 0, 1);
  const uint8_t* b = (const uint8_t*)out.data();
  for (size_t k = 0; k < (size_t)16 * V * n; k++) printf("%02x", b[k]);
}

int main() {
  static char line[1 << 20];
  while (fgets(line, sizeof line, stdin)) {
    char* p;
    char* f = strtok_r(line, " \n", &p);
    if (!f) continue;
    if (!strcmp(f, "P128")) run<P128>(&p);
    else if (!strcmp(f, "P256")) run<P256>(&p);
    else if (!strcmp(f, "P256K1")) run<P256K1>(&p);
    else if (!strcmp(f, "G128")) run<G128>(&p);
    printf("\n");
    fflush(stdout);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("eq_table")
    src, exe = str(d / "harness.cpp"), str(d / "harness")
    with open(src, "w") as fh:
        fh.write(HARNESS)
    # K24's device code up to its kernel
    with open(os.path.join(CSRC, "eq_table.cu")) as fh:
        dev = fh.read().split("// grid (G, lanes): block (bx, lane)")[0]
    with open(str(d / "eq_dev.inc"), "w") as fh:
        fh.write(dev)
    subprocess.run([cxx, "-std=c++17", "-O1", "-w", "-I",
                    os.path.join(HERE, "cuda_host"), "-I", CSRC, "-I",
                    str(d), "-o", exe, src], check=True,
                   capture_output=True, text=True)

    def run(cmds):
        out = subprocess.run([exe], input="\n".join(cmds) + "\n",
                             capture_output=True, text=True, check=True,
                             timeout=120)
        return out.stdout.split("\n")[:len(cmds)]
    return run


def _chunk_consts():
    with open(os.path.join(CSRC, "eq_table.cu")) as fh:
        src = fh.read()
    return tuple(int(re.search(r"constexpr int %s = (\d+);" % k,
                               src).group(1))
                 for k in ("EQ_CHUNK_MIN", "EQ_TOP_MAX"))


def _hex(t):
    return np.ascontiguousarray(t.numpy().astype("<i4")).tobytes().hex()


def test_eq_table_device_code(harness):
    """eq_block at logn 0-10, n = 2^logn, 2^logn - 3 and 1, modes 1 and
    2, in every field: with the kernel's chunk sizes (one chunk up to
    2^EQ_CHUNK_MIN entries) on one block, and with chunks of 2^2 and 2^3
    entries (top chains of up to 8 products) on 1, 3 and 64 blocks a lane
    (blocks without a chunk, blocks of several), against the plain
    version."""
    cmin, tmax = _chunk_consts()
    rng = np.random.default_rng(192)
    cmds, wants = [], []
    for field, (_, pmk, tag) in FIELDS.items():
        F = pmk()
        for logn in range(11):
            for mode in (1, 2):
                # one input a (logn, mode): a table cut to n keeps its
                # first n entries, so the plain version runs once
                _, (q, alpha, q1) = _case(F, rng, logn, 1, mode)
                full = eq_table_plain(F, q, 1 << logn, alpha, q1)
                args = " ".join(_hex(x) for x in q) + (
                    "" if mode == 1 else " " + " ".join(
                        _hex(x) for x in q1) + " " + _hex(alpha))
                for n in _ns(logn):
                    for G, cm, tm in ((1, cmin, tmax), (1, 2, 8), (3, 2, 8),
                                      (64, 3, 6)):
                        cmds.append("%s %d %d %d %d %d %d %s" % (
                            tag, mode, logn, n, G, cm, tm, args))
                        wants.append(_hex(full[:n]))
    got = harness(cmds)
    bad = [c.split()[:7] for c, g, w in zip(cmds, got, wants) if g != w]
    assert not bad, bad[:5]
