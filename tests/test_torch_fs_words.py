"""The word-wise Fiat-Shamir oracle of K9 and K10 (csrc/fs.cuh) and K10's
GF(2^128) product (csrc/rt_mul.cuh), compiled for the host and held on the
CPU to the port's host transcript, FSPRF and field sampling
(random_oracle/transcript.py, utils/crypto.py) and to the host GF(2^128)
product.

The device headers build with a host C++ compiler through
tests/cuda_host/cuda_runtime.h (the CUDA qualifiers empty, the intrinsics
in C++, one thread).  A small harness program reads commands on stdin and prints
its results; the test skips where no C++ compiler is found.  The kernels
themselves (the warp that fills the AES table, the launches) are held to
their plain versions on the card by tests/test_torch_kernels.py.
"""

import os
import shutil
import struct
import subprocess

import numpy as np
import pytest

from longfellow_zk_tpu_torch.fields import gf2 as gf2m
from longfellow_zk_tpu_torch.fields.fp_instances import (
    fp128, p256_base, p256k1_base)
from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
from longfellow_zk_tpu_torch.random_oracle.transcript import FSPRF, Transcript
from longfellow_zk_tpu_torch.utils.crypto import SHA256

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "longfellow_zk_tpu_torch", "csrc")

FIELDS = {"p128": fp128, "p256": p256_base, "p256k1": p256k1_base,
          "g128": gf2_128}

# A key whose first counter block, read as an Fp128 draw, is >= p: the
# sample is the second block.
REJECT_KEY = bytes.fromhex(
    "b2b7ec6f3f4f538ce55603547b6d9e9ec516e965a7d1db5e1c2118eb7e0edd66")

HARNESS = r"""
#include "rt_dev.inc"
#include <stdio.h>
#include <string.h>

static uint32_t T[256];

static void hex_in(const char* h, uint8_t* out, int n) {
  for (int i = 0; i < n; i++) {
    unsigned v;
    sscanf(h + 2 * i, "%2x", &v);
    out[i] = (uint8_t)v;
  }
}
static void hex_out(const uint8_t* b, int n) {
  for (int i = 0; i < n; i++) printf("%02x", b[i]);
}
template <class C>
static Fp<C> elt_in(const char* h) {
  Fp<C> x;
  hex_in(h, (uint8_t*)x.l, 4 * C::N);
  return x;
}
template <class C>
static void elt_out(const Fp<C>& x) {
  hex_out((const uint8_t*)x.l, 4 * C::N);
}
template <class C>
static void absorb(FsW& s, int tagged, const char* h) {
  const Fp<C> x = elt_in<C>(h);
  if (tagged)
    fsw_absorb_tagged<C>(s, x);
  else
    fsw_absorb_elt<C>(s, x);
}
template <class C>
static void sample(const uint32_t key[8], int skip) {
  static uint32_t RK[60], rk[60];
  PrfW p;
  p.rk = RK;
  prfw_fresh(p, key, T);
  for (int i = 0; i < skip; i++) prfw_byte(p, T);
  const Fp<C> x = prfw_sample<C>(p, T);
  aes_expand(key, rk, T);
  const Fp<C> y = fresh_sample<C>(rk, T);
  elt_out(x);
  printf(" ");
  elt_out(y);
  printf(" %u %llu\n", p.ptr, (unsigned long long)p.nb);
}
// one K10 round of one lane: inputs fs | claim | a (npts - 1) | eq0 |
// pad (npts) | consts (10); prints fs | claim | row (npts + 1)
template <class C>
static void rtail(int npts, const char* h) {
  constexpr int EB = 4 * C::N;
  static uint4 buf[1024];
  FsState fs;
  hex_in(h, (uint8_t*)&fs, 104);
  const int nel = 1 + (npts - 1) + 1 + npts + 10;
  hex_in(h + 208, (uint8_t*)buf, EB * nel);
  uint8_t* b = (uint8_t*)buf;
  uint4 *claim = (uint4*)b, *a = (uint4*)(b + EB),
        *eq0 = (uint4*)(b + EB * npts), *pad = (uint4*)(b + EB * (npts + 1)),
        *consts = (uint4*)(b + EB * (2 * npts + 1));
  static uint4 row[64];
  static uint32_t RK[60], Q[16 * FS_QUEUE];
  round_tail_lane<C>(0, &fs, claim, row, a, eq0, pad, consts, 0, 0, npts, T,
                     RK, Q);
  hex_out((const uint8_t*)&fs, 104);
  printf(" ");
  hex_out((const uint8_t*)claim, EB);
  printf(" ");
  hex_out((const uint8_t*)row, EB * (npts + 1));
  printf("\n");
}
#define FIELD(f, call)                       \
  if (!strcmp(f, "p128")) { call(P128); }    \
  else if (!strcmp(f, "p256")) { call(P256); } \
  else if (!strcmp(f, "p256k1")) { call(P256K1); } \
  else { call(G128); }

int main() {
  aes_tables(T);
  static char line[1 << 16], a[1 << 15], b[1 << 15], f[16];
  FsW s;
  while (fgets(line, sizeof line, stdin)) {
    int t = 0, n = 0;
    if (line[0] == 'S') {  // S <blob>: the state from a 104-byte blob
      FsState blob;
      sscanf(line + 2, "%s", a);
      hex_in(a, (uint8_t*)&blob, 104);
      fsw_load(s, &blob);
    } else if (line[0] == 'B') {  // B <n> <bytes>: absorb n <= 64 bytes
      uint8_t buf[64];
      sscanf(line + 2, "%d %s", &n, a);
      hex_in(a, buf, n);
      fsw_absorb_bytes(s, buf, n);
    } else if (line[0] == 'H') {  // H <n>: an array's header
      unsigned long long m;
      sscanf(line + 2, "%llu", &m);
      fsw_absorb_array_header(s, m);
    } else if (line[0] == 'E') {  // E <field> <tagged> <limbs>
      sscanf(line + 2, "%s %d %s", f, &t, a);
#define ABSORB(C) absorb<C>(s, t, a)
      FIELD(f, ABSORB)
    } else if (line[0] == 'K') {  // K: the key and the state's blob
      uint32_t key[8];
      fsw_getkey(s, key);
      FsState blob;
      fsw_store(&blob, s);
      hex_out((const uint8_t*)key, 32);
      printf(" ");
      hex_out((const uint8_t*)&blob, 104);
      printf("\n");
    } else if (line[0] == 'P') {  // P <field> <key> <skip>: samples
      uint32_t key[8];
      sscanf(line + 2, "%s %s %d", f, a, &n);
      hex_in(a, (uint8_t*)key, 32);
#define SAMPLE(C) sample<C>(key, n)
      FIELD(f, SAMPLE)
    } else if (line[0] == 'R') {  // R <field> <npts> <inputs>: K10
      sscanf(line + 2, "%s %d %s", f, &n, a);
#define RTAIL(C) rtail<C>(n, a)
      FIELD(f, RTAIL)
    } else if (line[0] == 'M') {  // M <a> <b>: rt_mul at GF(2^128)
      sscanf(line + 2, "%s %s", a, b);
      elt_out(rt_mul<G128>(elt_in<G128>(a), elt_in<G128>(b)));
      printf("\n");
    }
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
    d = tmp_path_factory.mktemp("fs_words")
    src, exe = str(d / "harness.cpp"), str(d / "harness")
    with open(src, "w") as fh:
        fh.write(HARNESS)
    # K10's device code: round_tail.cu up to its host launch
    with open(os.path.join(CSRC, "round_tail.cu")) as fh:
        dev = fh.read().split("template <class C>\nstatic int round_tail(")[0]
    with open(str(d / "rt_dev.inc"), "w") as fh:
        fh.write(dev)
    subprocess.run([cxx, "-std=c++17", "-O1", "-w", "-I",
                    os.path.join(HERE, "cuda_host"), "-I", CSRC, "-I",
                    str(d), "-o", exe, src], check=True,
                   capture_output=True, text=True)

    def run(cmds):
        out = subprocess.run([exe], input="\n".join(cmds) + "\n",
                             capture_output=True, text=True, check=True,
                             timeout=120)
        return out.stdout.split("\n")
    return run


def _limbs_hex(F, x):
    """x (natural) as the kernels hold it: Montgomery limbs for a prime
    field, its bits for GF(2^128), little-endian bytes in hex."""
    t = F.to_limbs([x], "cpu")[0].numpy().astype("<i4")
    return t.tobytes().hex()


def test_absorbs_and_key(harness):
    """Byte strings of 0-64 bytes, tagged and untagged elements of each
    field and arrays' headers at every offset, then the key and the whole
    state, against the host Transcript."""
    rng = np.random.default_rng(41)
    for trial in range(60):
        ts = Transcript(rng.bytes(int(rng.integers(0, 90))))
        blob = ts.export_state()
        cnt = struct.unpack("<Q", blob[32:40])[0]
        blob = blob[:40 + cnt % 64] + bytes(64 - cnt % 64)
        cmds = ["S " + blob.hex()]
        keys = []
        for _ in range(int(rng.integers(1, 12))):
            kind = int(rng.integers(0, 3))
            if kind == 0:
                data = rng.bytes(int(rng.integers(0, 65)))
                cmds.append("B %d %s" % (len(data), data.hex() or "00"))
                ts._write_untyped(data)
            elif kind == 1:
                name = list(FIELDS)[int(rng.integers(0, 4))]
                F = FIELDS[name]()
                x = int.from_bytes(rng.bytes(F.kBytes), "little")
                x = x if F.kCharacteristicTwo else x % F.p
                tagged = int(rng.integers(0, 2))
                cmds.append("E %s %d %s" % (name, tagged, _limbs_hex(F, x)))
                if tagged:
                    ts.write_elt(x, F)
                else:
                    ts._write_untyped(F.to_bytes(x))
            else:
                m = int(rng.integers(0, 1 << 62))
                cmds.append("H %d" % m)
                ts._tag(2)
                ts._length(m)
            cmds.append("K")
            want = ts.export_state()
            off = struct.unpack("<Q", want[32:40])[0] % 64
            keys.append((ts.get_key(), want[:40 + off] + bytes(64 - off)))
        got = [ln.split() for ln in harness(cmds) if ln]
        assert len(got) == len(keys)
        for (key, state), (k, b) in zip(keys, got):
            assert bytes.fromhex(k) == key
            assert bytes.fromhex(b) == state


@pytest.mark.parametrize("name", list(FIELDS))
def test_samples(harness, name):
    """A sample after 0-40 PRF bytes (K9's reads) and one from a fresh
    stream by whole blocks (K10's) against FSPRF and Field.sample; at
    Fp128 also from a key whose first draw is rejected."""
    F, rng = FIELDS[name](), np.random.default_rng(42)
    keys = [rng.bytes(32) for _ in range(20)] + [REJECT_KEY]
    skips = [int(rng.integers(0, 41)) for _ in keys[:-1]] + [0]
    out = harness(["P %s %s %d" % (name, k.hex(), n)
                  for k, n in zip(keys, skips)])
    for key, skip, line in zip(keys, skips, out):
        x, y, ptr, nb = line.split()
        prf = FSPRF(key)
        prf.bytes(skip)
        n0 = F.sample(prf.bytes)
        used = len(F.to_bytes(0))
        fresh = F.sample(FSPRF(key).bytes)
        assert F.from_limbs(_parse(F, x)) == n0
        assert F.from_limbs(_parse(F, y)) == fresh
        # the device reads a block ahead: the pointer is in the block
        # after the bytes read, its counter the blocks made
        total = skip + used * (1 + _rejections(F, key, skip))
        assert (int(ptr), int(nb)) == (total % 16, total // 16 + 1)
    if name == "p128":
        first = int.from_bytes(FSPRF(REJECT_KEY).bytes(16), "little")
        assert first >= F.p


def _parse(F, h):
    import torch
    return torch.from_numpy(np.frombuffer(bytes.fromhex(h), dtype="<i4")
                            .copy())


def _rejections(F, key, skip):
    """The draws the host sampling rejected after `skip` bytes."""
    prf = FSPRF(key)
    prf.bytes(skip)
    n, nb = 0, len(F.to_bytes(0))
    while True:
        v = int.from_bytes(prf.bytes(nb), "little")
        if F.kCharacteristicTwo or v < F.p:
            return n
        n += 1


def test_k10_gf2_product(harness):
    """rt_mul at GF(2^128) against the host product, on random elements,
    0, 1, x^127 and all ones."""
    rng = np.random.default_rng(43)
    F = gf2_128()
    vals = [0, 1, 1 << 127, (1 << 128) - 1] + [
        int.from_bytes(rng.bytes(16), "little") for _ in range(400)]
    pairs = [(a, b) for a in vals[:4] for b in vals[:4]] + \
        list(zip(vals[4:204], vals[204:]))
    out = harness(["M %s %s" % (_limbs_hex(F, a), _limbs_hex(F, b))
                  for a, b in pairs])
    for (a, b), line in zip(pairs, out):
        assert F.from_limbs(_parse(F, line)) == gf2m.gf_mul_int(a, b)


# K10's starting offsets cnt % 64 on the CPU: the ends of words, of the
# 55/56-byte padding split and of the block (the card test takes all 64)
K10_OFFSETS = (0, 1, 3, 4, 31, 32, 47, 54, 55, 56, 57, 62, 63)


def _fs_at(rng, off):
    ts = Transcript(rng.bytes(5))
    cnt = int.from_bytes(ts.export_state()[32:40], "little")
    ts.write_bytes(rng.bytes((off - cnt - 9) % 64))
    blob = ts.export_state()
    return blob[:40 + off] + bytes(64 - off)


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("cubic", [False, True])
def test_k10_round(harness, name, cubic):
    """K10's round (round_tail.cu's device code, one lane) in both modes
    at the offsets of K10_OFFSETS against the plain version: the state,
    the claim and the row, with the constants of round_consts; at Fp128
    also through a rejected draw."""
    import torch
    from longfellow_zk_tpu_torch.fields.fp import round_consts
    from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs

    F, rng = FIELDS[name](), np.random.default_rng(44)
    npts = 4 if cubic else 3
    std = round_consts(F, "cpu")
    cases = [(_fs_at(rng, off), std) for off in K10_OFFSETS]
    iv = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F,
          0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
    empty = struct.pack("<8IQ", *iv, 0) + bytes(64)
    cmds, want = [], []
    for fs, consts in cases + ([(empty, std)] if name == "p128" and
                               not cubic else []):
        x = _rand_elts(F, rng, 2 * npts + 1)
        claim, a, eq0 = x[0], x[1:npts], x[npts]
        pad = x[npts + 1:]
        if fs == empty:
            # the pads that draw the rejected block (test_torch_kernels.py
            # K10_REJECT_EV0)
            row = torch.zeros((4, F.nlimb), dtype=torch.int32)
            fs0 = torch.frombuffer(bytearray(empty), dtype=torch.uint8)
            dfs.round_tail_plain(F, fs0.clone(), claim.clone(), row, a,
                                 eq0, F.zeros((3,), "cpu"), consts)
            pad = F.sub(row[:3], F.to_limbs([64395, 0, 0], "cpu"))
        args = torch.cat([claim[None], a, eq0[None], pad, consts])
        cmds.append("R %s %d %s%s" % (name, npts, fs.hex(), args.numpy()
                                      .astype("<i4").tobytes().hex()))
        fs2 = torch.frombuffer(bytearray(fs), dtype=torch.uint8).clone()
        cl2 = claim.clone()
        row2 = torch.zeros((npts + 1, F.nlimb), dtype=torch.int32)
        if cubic:
            dfs.round_tail_cubic_plain(F, fs2, cl2, row2, a, pad, consts)
        else:
            dfs.round_tail_plain(F, fs2, cl2, row2, a, eq0, pad, consts)
        want.append((bytes(fs2.tolist()).hex(),
                     cl2.numpy().astype("<i4").tobytes().hex(),
                     row2.numpy().astype("<i4").tobytes().hex()))
    got = [tuple(ln.split()) for ln in harness(cmds) if ln]
    assert got == want


def _rand_elts(F, rng, n):
    vals = [int.from_bytes(rng.bytes(4 * F.nlimb), "little")
            for _ in range(n)]
    if not F.kCharacteristicTwo:
        vals = [v % F.p for v in vals]
    else:
        vals = [v % (1 << 128) for v in vals]
    return F.to_limbs(vals, "cpu")
