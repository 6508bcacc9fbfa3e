"""The GF(2^128) products of csrc/gf2.cuh (the spaced-multiply Karatsuba
product fp_mul<G128>, the table product by one element that K1's bind, hv
and products by one element run) and K3's
GF(2^128) term (csrc/wire_round.cu g128_wire_term: z split once, two
unreduced products, the sums folded once), compiled for the host and held
on the CPU, exactly, to the JAX package's GF2_128.mul (eager) and to the
port's host product gf_mul_int; and K3's prime term (prime_wire_term: z
reduced once, the two sums of products kept as unreduced double-width
columns and Montgomery-reduced once, redc_wide) at Fp128, P-256 and
secp256k1, against the sums of Montgomery products of host ints.

The device code builds with a host C++ compiler through
tests/cuda_host/cuda_runtime.h (the CUDA qualifiers empty, one thread);
a small harness program reads commands on stdin and prints its results.
The test skips where no C++ compiler is found.  The kernels themselves are
held to their plain versions on the card by tests/test_torch_kernels.py.
"""

import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from longfellow_zk_tpu.fields.gf2 import gf2_128 as jax_gf2
from longfellow_zk_tpu_torch.fields.gf2 import gf_mul_int

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "longfellow_zk_tpu_torch", "csrc")
MASK = (1 << 128) - 1

HARNESS = r"""
#include "wire_dev.inc"
#include <stdio.h>
#include <string.h>

static Fp<G128> elt_in(const char* h) {
  Fp<G128> x;
  for (int i = 0; i < 16; i++) {
    unsigned v;
    sscanf(h + 2 * i, "%2x", &v);
    ((uint8_t*)x.l)[i] = (uint8_t)v;
  }
  return x;
}
static void elt_out(const Fp<G128>& x) {
  for (int i = 0; i < 16; i++) printf("%02x", ((const uint8_t*)x.l)[i]);
}
static char* next(char** p) {
  char* t = strtok_r(nullptr, " \n", p);
  return t;
}
template <class C>
static Fp<C> pelt_in(const char* h) {
  Fp<C> x;
  for (int i = 0; i < 4 * C::N; i++) {
    unsigned v;
    sscanf(h + 2 * i, "%2x", &v);
    ((uint8_t*)x.l)[i] = (uint8_t)v;
  }
  return x;
}
template <class C>
static void pelt_out(const Fp<C>& x) {
  for (int i = 0; i < 4 * C::N; i++)
    printf("%02x", ((const uint8_t*)x.l)[i]);
}
// P<field> n (hv wo wlo whi h)...: a thread's a0 and a2 over n terms
template <class C>
static void prime_terms(char** p) {
  u64 w0[2 * C::N] = {0}, w2[2 * C::N] = {0};
  int n = atoi(next(p));
  for (int i = 0; i < n; i++) {
    const Fp<C> hv = pelt_in<C>(next(p)), wo = pelt_in<C>(next(p));
    const Fp<C> wlo = pelt_in<C>(next(p)), whi = pelt_in<C>(next(p));
    prime_wire_term<C>(hv, wo, wlo, whi, atoi(next(p)), w0, w2);
  }
  pelt_out(redc_wide<C>(w0));
  printf(" ");
  pelt_out(redc_wide<C>(w2));
}

int main() {
  static char line[1 << 22];
  static uint4 tab[G128_TAB_BYTES / 16];
  while (fgets(line, sizeof line, stdin)) {
    char* p;
    char* cmd = strtok_r(line, " \n", &p);
    if (!cmd) continue;
    if (!strcmp(cmd, "M")) {  // M a b: fp_mul, then fp_sqr of a
      const Fp<G128> a = elt_in(next(&p)), b = elt_in(next(&p));
      elt_out(fp_mul(a, b));
      printf(" ");
      elt_out(fp_sqr(a));
    } else if (!strcmp(cmd, "T")) {  // T r n x...: x r by r's table
      const Fp<G128> r = elt_in(next(&p));
      g128_tab_build(r, tab);
      int n = atoi(next(&p));
      for (int i = 0; i < n; i++) {
        elt_out(g128_tab_mul(tab, elt_in(next(&p))));
        printf(" ");
      }
    } else if (!strcmp(cmd, "W")) {  // W n (hv wo wlo whi h)...: a0 a2
      uint32_t s0[8] = {0}, s2[8] = {0};
      int n = atoi(next(&p));
      for (int i = 0; i < n; i++) {
        const Fp<G128> hv = elt_in(next(&p)), wo = elt_in(next(&p));
        const Fp<G128> wlo = elt_in(next(&p)), whi = elt_in(next(&p));
        g128_wire_term(hv, wo, wlo, whi, atoi(next(&p)), s0, s2);
      }
      elt_out(g128_fold(s0));
      printf(" ");
      elt_out(g128_fold(s2));
    } else if (!strcmp(cmd, "P128")) {
      prime_terms<P128>(&p);
    } else if (!strcmp(cmd, "P256")) {
      prime_terms<P256>(&p);
    } else if (!strcmp(cmd, "P256K1")) {
      prime_terms<P256K1>(&p);
    }
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
    d = tmp_path_factory.mktemp("gf2_mul")
    src, exe = str(d / "harness.cpp"), str(d / "harness")
    with open(src, "w") as fh:
        fh.write("#include <stdlib.h>\n" + HARNESS)
    # K3's device code up to its first kernel
    with open(os.path.join(CSRC, "wire_round.cu")) as fh:
        dev = fh.read().split("// grid (nblk, lanes): block (x, lane)")[0]
    with open(str(d / "wire_dev.inc"), "w") as fh:
        fh.write(dev)
    subprocess.run([cxx, "-std=c++17", "-O1", "-w", "-I",
                    os.path.join(HERE, "cuda_host"), "-I", CSRC, "-I",
                    str(d), "-o", exe, src], check=True,
                   capture_output=True, text=True)

    def run(cmds):
        out = subprocess.run([exe], input="\n".join(cmds) + "\n",
                             capture_output=True, text=True, check=True,
                             timeout=120)
        return [ln.split() for ln in out.stdout.split("\n")[:len(cmds)]]
    return run


def _hex(x):
    return x.to_bytes(16, "little").hex()


def _int(h):
    return int.from_bytes(bytes.fromhex(h), "little")


def _jax_mul(a, b):
    """GF2_128.mul of the JAX package (eager, CPU) on lists of ints."""
    J = jax_gf2()
    out = J.mul(jnp.asarray(J.to_limbs(a)), jnp.asarray(J.to_limbs(b)))
    return [int(v) for v in J.from_limbs(np.asarray(out))]


def _operands(rng, n):
    """Edge elements (0, 1, x^127, all ones, and elements whose high half
    sets the bits that spill past x^127 in the fold), then random ones."""
    edge = [0, 1, 1 << 127, MASK, MASK ^ 1, (1 << 127) | (1 << 126) |
            (1 << 121), ((1 << 7) - 1) << 121, 0x87, 1 << 64,
            (1 << 64) - 1]
    rand = [int.from_bytes(rng.bytes(16), "little") for _ in range(n)]
    return edge, rand


def test_product_and_square(harness):
    """fp_mul<G128> (and fp_sqr, which shares the fold) on every pair of
    edge elements and 300 random pairs, against GF2_128.mul and
    gf_mul_int."""
    rng = np.random.default_rng(160)
    edge, rand = _operands(rng, 600)
    pairs = [(a, b) for a in edge for b in edge] + \
        list(zip(rand[:300], rand[300:]))
    a, b = [p[0] for p in pairs], [p[1] for p in pairs]
    want = _jax_mul(a, b)
    got = harness(["M %s %s" % (_hex(x), _hex(y)) for x, y in pairs])
    assert [_int(g[0]) for g in got] == want
    assert want == [gf_mul_int(x, y) for x, y in pairs]
    assert [_int(g[1]) for g in got] == [gf_mul_int(x, x) for x in a]


def test_table_product(harness):
    """The table product x r for edge and random r, each over edge and
    random x, against GF2_128.mul."""
    rng = np.random.default_rng(161)
    edge, rand = _operands(rng, 80)
    rs = edge[:6] + rand[:10]
    xs = edge + rand[10:]
    cmds = ["T %s %d %s" % (_hex(r), len(xs), " ".join(map(_hex, xs)))
            for r in rs]
    got = harness(cmds)
    want = _jax_mul([x for _ in rs for x in xs],
                    [r for r in rs for _ in xs])
    assert [_int(g) for line in got for g in line] == want


def test_wire_term_fold_once(harness):
    """K3's GF(2^128) sums over terms, each product z Wh unreduced and
    the sums folded once, against a0 = sum over even h of z W[h] and a2 =
    sum of z (W[h | 1] + W[h & ~1]), z = hv Wo, by GF2_128.mul term by
    term; odd and even h mixed, runs of one parity, edge operands."""
    rng = np.random.default_rng(162)
    edge, rand = _operands(rng, 4 * 64)
    cases = []
    for c in range(6):
        n = [1, 2, 7, 64, 64, 40][c]
        vals = [edge[(7 * i + c) % len(edge)] for i in range(4 * n)] \
            if c >= 4 else rand[:4 * n]
        hs = [int(v) for v in rng.integers(0, 1 << 20, n)]
        if c == 3:
            hs = [2 * k for k in range(n // 2)] + \
                [2 * k + 1 for k in range(n - n // 2)]
        cases.append([(vals[4 * i], vals[4 * i + 1], vals[4 * i + 2],
                       vals[4 * i + 3], hs[i]) for i in range(n)])
    cmds = ["W %d %s" % (len(ts), " ".join(
        "%s %s %s %s %d" % (_hex(hv), _hex(wo), _hex(lo), _hex(hi), h)
        for hv, wo, lo, hi, h in ts)) for ts in cases]
    got = harness(cmds)
    for ts, g in zip(cases, got):
        z = _jax_mul([t[0] for t in ts], [t[1] for t in ts])
        plo = _jax_mul(z, [t[2] for t in ts])
        phi = _jax_mul(z, [t[3] for t in ts])
        a0 = a2 = 0
        for t, lo, hi in zip(ts, plo, phi):
            if t[4] % 2 == 0:
                a0 ^= lo
            a2 ^= lo ^ hi
        assert (_int(g[0]), _int(g[1])) == (a0, a2)


# the prime fields of K3's wire mode in the proofs: command, p, words
PRIMES = {"fp128": ("P128", (1 << 128) - (1 << 108) + 1, 4),
          "p256_base": ("P256", 2**256 - 2**224 + 2**192 + 2**96 - 1, 8),
          "p256k1_base": ("P256K1", 2**256 - 2**32 - 977, 8)}


@pytest.mark.parametrize("field", list(PRIMES))
def test_prime_wire_term_reduced_once(harness, field):
    """K3's prime sums over one thread's terms, the products z Wh
    unreduced in 2 N columns and reduced once, against a0 = sum over even
    h of z W[h & ~1] and a2 = sum of +-z (W[h | 1] - W[h & ~1]) (+ for
    odd h), z = hv Wo, by Montgomery products of host ints (R = 2^(32
    N)), as canonical Montgomery forms; edge operands (0, 1, p - 1, p -
    2) on long runs, so the columns grow."""
    cmd, p, nw = PRIMES[field]
    R = 1 << (32 * nw)
    rinv = pow(R, -1, p)

    def mont(a, b):
        return a * b * rinv % p

    def hx(x):
        return x.to_bytes(4 * nw, "little").hex()

    rng = np.random.default_rng(163)
    edge = [0, 1, p - 1, p - 2, R % p, (R * R) % p]
    cases = []
    for c, n in enumerate([1, 2, 9, 300, 700, 64]):
        if c == 4:
            vals = [p - 1] * (4 * n)
        elif c == 5:
            vals = [edge[(5 * i + 3) % len(edge)] for i in range(4 * n)]
        else:
            vals = [int.from_bytes(rng.bytes(4 * nw), "little") % p
                    for _ in range(4 * n)]
        hs = [int(v) for v in rng.integers(0, 1 << 20, n)]
        if c == 4:
            hs = [2 * (i % 3) + (i % 5 == 0) for i in range(n)]
        cases.append([(vals[4 * i], vals[4 * i + 1], vals[4 * i + 2],
                       vals[4 * i + 3], hs[i]) for i in range(n)])
    got = harness(["%s %d %s" % (cmd, len(ts), " ".join(
        "%s %s %s %s %d" % (hx(hv), hx(wo), hx(lo), hx(hi), h)
        for hv, wo, lo, hi, h in ts)) for ts in cases])
    for ts, g in zip(cases, got):
        a0 = a2 = 0
        for hv, wo, lo, hi, h in ts:
            z = mont(hv, wo)
            if h % 2 == 0:
                a0 += mont(z, lo)
                a2 += mont(z, (lo - hi) % p)
            else:
                a2 += mont(z, (hi - lo) % p)
        got0, got2 = (int.from_bytes(bytes.fromhex(x), "little") for x in g)
        assert (got0, got2) == (a0 % p, a2 % p)
