"""The word-wise Fiat-Shamir oracle of K9 and K10 (csrc/fs.cuh) and K10's
GF(2^128) product (csrc/rt_mul.cuh), compiled for the host and held on the
CPU to the port's host transcript, FSPRF and field sampling
(random_oracle/transcript.py, utils/crypto.py) and to the host GF(2^128)
product.

The device headers build with a host C++ compiler through
tests/cuda_host/cuda_runtime.h (the CUDA qualifiers empty, the intrinsics
in C++, one thread).  A small harness program reads commands on stdin and prints
its results; the test skips where no C++ compiler is found.  K9's writes
and draws run there as fs.cu's kernels run them, their producers' and
their draws' work done by one thread in turn; the kernels themselves (the
warps that share that work, the barriers, the ordered count, the
launches) are held to their plain versions on the card by
tests/test_torch_kernels.py.
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
// K9's write of mode MODE (fs.cu k_fs_write) on the state f: the
// producers' stages and the chain's, one after another.
template <class C, int MODE>
static void write(FsState& f, long long n, const uint8_t* in) {
  static K9WriteSmem<C> sm;
  const u64 cnt = f.cnt;
  const K9Write w = k9w_plan<C, MODE>(cnt, (u64)n);
  memcpy(sm.old, f.buf, 64);
  uint32_t h[8];
  memcpy(h, f.h, 32);
  const u64 nstage = (w.nfull + K9_CHUNK) / K9_CHUNK;
  for (u64 c = 0; c <= nstage; c++) {
    if (c > 0) k9w_chain(w, sm, c - 1, h);
    if (c < nstage)
      k9w_produce<C, MODE>(w, sm, c, 0, 1, in, K9ProducerSync());
  }
  k9w_store(&f, h, cnt, w, sm.part);
}
template <class C>
static void write_mode(FsState& f, int mode, long long n,
                       const uint8_t* in) {
  if (mode == 0)
    write<C, 0>(f, n, in);
  else if (mode == 5)
    write<C, 5>(f, n, in);
  else
    write<C, 6>(f, n, in);
}
// K9's draw (fs.cu k_fs_draw) of n elements from the stream keyed by key
// after `skip` bytes, in windows of `win` candidates; prints the
// elements, then ptr, nb and the saved block of the state it leaves.
template <class C>
static void draw(const uint32_t key[8], u64 skip, long long n, int win) {
  static uint32_t RK[60], S[4 * 1100 + 4];
  static uint4 out[4096];
  constexpr uint32_t L = Oracle<C>::KBYTES;
  aes_expand(key, RK, T);
  u64 P = skip, done = 0, b0 = 0;
  int nblk = 0;
  while (done < (u64)n) {
    const int M = (int)k9_min((u64)win, (u64)n - done);
    const uint32_t q0 = (uint32_t)(P & 15);
    b0 = P >> 4;
    nblk = (int)((q0 + (uint32_t)M * L + 15) / 16) + 1;
    k9d_blocks(RK, b0, nblk, S, 0, 1, T);
    int last = -1;
    u64 acc = 0;
    for (int j = 0; j < M; j++) {
      Fp<C> x = k9d_candidate<C>(S, q0 + (uint32_t)j * L);
      if (!fs_accept(x)) continue;
      if (done + acc < (u64)n) x.store(out, (long long)(done + acc));
      if (done + acc == (u64)n - 1) last = j;
      acc++;
    }
    if (done + acc >= (u64)n) {
      P += (u64)(last + 1) * L;
      done = n;
    } else {
      P += (u64)M * L;
      done += acc;
    }
  }
  static PrfState f;
  k9d_settle(&f, P, S, b0, nblk, RK, T);
  for (long long i = 0; i < n; i++) {
    elt_out(Fp<C>::load(out, i));
    printf(" ");
  }
  printf("%u %llu ", f.ptr, (unsigned long long)f.nb);
  hex_out((const uint8_t*)f.saved, 16);
  printf("\n");
}
// K10's draw: one element from a fresh stream by whole blocks.
template <class C>
static void fresh(const uint32_t key[8]) {
  static uint32_t rk[60];
  aes_expand(key, rk, T);
  elt_out(fresh_sample<C>(rk, T));
  printf("\n");
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
  static uint8_t buf[1 << 14];
  FsState st;
  while (fgets(line, sizeof line, stdin)) {
    int t = 0, n = 0, w = 0;
    if (line[0] == 'S') {  // S <blob>: the state from a 104-byte blob
      sscanf(line + 2, "%s", a);
      hex_in(a, (uint8_t*)&st, 104);
    } else if (line[0] == 'W') {  // W <field> <mode> <n> <input hex>
      sscanf(line + 2, "%s %d %d %s", f, &t, &n, a);
      hex_in(a, buf, (int)(strlen(a) / 2));
#define WRITE(C) write_mode<C>(st, t, n, buf)
      FIELD(f, WRITE)
    } else if (line[0] == 'K') {  // K: the key and the state's blob
      uint32_t key[8];
      FsW s;
      fsw_load(s, &st);
      fsw_getkey(s, key);
      hex_out((const uint8_t*)key, 32);
      printf(" ");
      hex_out((const uint8_t*)&st, 104);
      printf("\n");
    } else if (line[0] == 'D') {  // D <field> <key> <skip> <n> <window>
      uint32_t key[8];
      sscanf(line + 2, "%s %s %d %d %d", f, a, &t, &n, &w);
      hex_in(a, (uint8_t*)key, 32);
#define DRAW(C) draw<C>(key, (u64)t, n, w)
      FIELD(f, DRAW)
    } else if (line[0] == 'F') {  // F <field> <key>: K10's fresh sample
      uint32_t key[8];
      sscanf(line + 2, "%s %s", f, a);
      hex_in(a, (uint8_t*)key, 32);
#define FRESH(C) fresh<C>(key)
      FIELD(f, FRESH)
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
    """K9's writes (fs.cu's stages in turn): byte strings (mode 0),
    arrays (5) and tagged elements (6) of each field, from 0 to a few
    blocks long, at every offset, then the key and the whole state,
    against the host Transcript."""
    rng = np.random.default_rng(41)
    for trial in range(40):
        ts = Transcript(rng.bytes(int(rng.integers(0, 90))))
        blob = ts.export_state()
        cnt = struct.unpack("<Q", blob[32:40])[0]
        blob = blob[:40 + cnt % 64] + bytes(64 - cnt % 64)
        cmds = ["S " + blob.hex()]
        keys = []
        for _ in range(int(rng.integers(1, 10))):
            kind = int(rng.integers(0, 3))
            name = list(FIELDS)[int(rng.integers(0, 4))]
            F = FIELDS[name]()
            if kind == 0:
                data = rng.bytes(int(rng.integers(0, 200)))
                cmds.append("W %s 0 %d %s" % (name, len(data),
                                              data.hex() or "00"))
                ts._write_untyped(data)
            else:
                xs = _rand_ints(F, rng, int(rng.integers(0, 20)))
                hexs = "".join(_limbs_hex(F, x) for x in xs) or "00"
                cmds.append("W %s %d %d %s" % (name, 5 if kind == 1 else 6,
                                               len(xs), hexs))
                if kind == 1:
                    ts.write_elts(xs, F)
                else:
                    for x in xs:
                        ts.write_elt(x, F)
            cmds.append("K")
            want = ts.export_state()
            off = struct.unpack("<Q", want[32:40])[0] % 64
            keys.append((ts.get_key(), want[:40 + off] + bytes(64 - off)))
        got = [ln.split() for ln in harness(cmds) if ln]
        assert len(got) == len(keys)
        for (key, state), (k, b) in zip(keys, got):
            assert bytes.fromhex(k) == key
            assert bytes.fromhex(b) == state


def _rand_ints(F, rng, n):
    p = (1 << 128) if F.kCharacteristicTwo else F.p
    return [int.from_bytes(rng.bytes(F.kBytes), "little") % p
            for _ in range(n)]


@pytest.mark.parametrize("name", list(FIELDS))
def test_samples(harness, name):
    """K9's draws (fs.cu's windows in turn) of 1-40 elements after 0-40
    stream bytes, in windows of 1, 3 and 256 candidates, and K10's draw
    from a fresh stream by whole blocks, against FSPRF and Field.sample:
    the elements, the stream position and the saved block after them; at
    Fp128 also from a key whose first draw is rejected."""
    F, rng = FIELDS[name](), np.random.default_rng(42)
    keys = [rng.bytes(32) for _ in range(12)] + [REJECT_KEY]
    cases = [(k, int(rng.integers(0, 41)), int(rng.integers(1, 41)),
              (1, 3, 256)[i % 3]) for i, k in enumerate(keys[:-1])]
    cases += [(REJECT_KEY, 0, 1, 256), (REJECT_KEY, 0, 3, 1)]
    out = harness(["D %s %s %d %d %d" % (name, k.hex(), skip, n, win)
                   for k, skip, n, win in cases] +
                  ["F %s %s" % (name, k.hex()) for k in keys])
    used = F.kBytes
    for (key, skip, n, win), line in zip(cases, out):
        *xs, ptr, nb, saved = line.split()
        prf = FSPRF(key)
        prf.bytes(skip)
        want = [F.sample(prf.bytes) for _ in range(n)]
        assert [F.from_limbs(_parse(F, x)) for x in xs] == want
        total = skip + used * (n + _rejections(F, key, skip, n))
        assert (int(ptr), int(nb)) == (total % 16, total // 16 + 1)
        assert bytes.fromhex(saved) == FSPRF(key).bytes(
            16 * (total // 16 + 1))[-16:]
    for key, line in zip(keys, out[len(cases):]):
        assert F.from_limbs(_parse(F, line)) == F.sample(FSPRF(key).bytes)
    if name == "p128":
        first = int.from_bytes(FSPRF(REJECT_KEY).bytes(16), "little")
        assert first >= F.p


def _parse(F, h):
    import torch
    return torch.from_numpy(np.frombuffer(bytes.fromhex(h), dtype="<i4")
                            .copy())


def _rejections(F, key, skip, n):
    """The draws the host sampling rejected in n samples after `skip`
    bytes."""
    prf = FSPRF(key)
    prf.bytes(skip)
    rej, nb = 0, F.kBytes
    while n:
        v = int.from_bytes(prf.bytes(nb), "little")
        if F.kCharacteristicTwo or v < F.p:
            n -= 1
        else:
            rej += 1
    return rej


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
