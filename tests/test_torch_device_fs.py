"""The port's device Fiat-Shamir transcript (random_oracle/device_fs.py,
the plain versions of K9 and K10, CPU) against the JAX package's
device_fs (eager on the CPU, as tests/test_device_fs.py runs it) and
against the port's host Transcript, for Fp128, P-256 and GF(2^128).
Exact: state bytes, key and stream bytes, and field elements compared
as canonical integers.  Inputs come from numpy seeds.

The JAX functions compile per call on a CPU (about 0.3-2 s each), so
the JAX comparisons take a few states; the host Transcript takes every
length and boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.fields.fp_instances import p256_base as jax_p256
from longfellow_zk_tpu.fields.gf2 import gf2_128 as jax_gf2_128
from longfellow_zk_tpu.random_oracle import device_fs as jfs
from longfellow_zk_tpu.random_oracle.transcript import (
    Transcript as JaxTranscript)
from longfellow_zk_tpu_torch.fields.fp import round_consts
from longfellow_zk_tpu_torch.fields.fp_instances import fp128, p256_base
from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs
from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
from longfellow_zk_tpu_torch.sumcheck.poly import (
    eval_lagrange, evals_of_coefs)
from longfellow_zk_tpu_torch.sumcheck.transcript_sumcheck import (
    TranscriptSumcheck)

FIELDS = {"fp128": (fp128, jax_fp128), "p256": (p256_base, jax_p256),
          "gf2_128": (gf2_128, jax_gf2_128)}

# Transcript(REJECT_LABEL)'s first 16 stream bytes, read as an Fp128
# draw, are >= p (0xfffff0bbee19eda4ff1b09f0a5f372e7), so its first
# Transcript.elt rejects one draw (probability about 2^-20).  Found by
# trying the labels b"reject-%d" for i = 0, 1, ... with the host
# SHA-256 and AES-256 (the first hit is i = 1,044,179).
REJECT_LABEL = b"reject-1044179"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops: one thread, so that
    they do not wait on the pool beside busy test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _elts(F, rng, n):
    p = (1 << 128) if F.kCharacteristicTwo else F.p
    return [int.from_bytes(rng.bytes(4 * F.nlimb), "little") % p
            for _ in range(n)]


def _ts(rng, prefix_len):
    """A host transcript that has absorbed a random prefix."""
    ts = Transcript(b"dfs")
    ts._write_untyped(rng.bytes(prefix_len))
    return ts


def _u8(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def _blob(fs) -> bytes:
    return bytes(fs.tolist())


@pytest.mark.parametrize("n", [1, 55, 56, 63, 64, 65, 130])
def test_absorb_and_key_match_host(n):
    """Absorbs that end before, at and across block boundaries, from
    every kind of offset; the key at the offsets 55 and 56 (one and two
    finalizing compressions)."""
    rng = np.random.default_rng(n)
    F = fp128()
    for prefix in (0, 9, 55, 56, 63):
        ts = _ts(rng, prefix)
        fs = dfs.fs_init_from_host(ts, "cpu")
        data = rng.bytes(n)
        dfs.fs_absorb(F, fs, _u8(data))
        ts._write_untyped(data)
        assert _blob(fs) == ts.export_state()
        assert _blob(dfs.fs_getkey(F, fs)) == ts.get_key()
    for off in (55, 56):
        ts = _ts(rng, 64 * 3 + off)
        fs = dfs.fs_init_from_host(ts, "cpu")
        assert _blob(dfs.fs_getkey(F, fs)) == ts.get_key()


def test_prf_bytes_match_host():
    """Reads that end inside, at the end of and across AES blocks,
    a one-byte read at the last byte of a block included."""
    rng = np.random.default_rng(1)
    F = fp128()
    ts = _ts(rng, 30)
    fs = dfs.fs_init_from_host(ts, "cpu")
    prf = dfs.new_prf("cpu")
    dfs.fs_squeeze(F, fs, prf)
    for k in (15, 1, 16, 17, 1, 32, 47, 2):
        assert _blob(dfs.prf_bytes(F, prf, k)) == ts.bytes(k)


def test_export_import_round_trip():
    rng = np.random.default_rng(2)
    F = gf2_128()
    for prefix in (0, 17, 64, 100):
        ts = _ts(rng, prefix)
        fs = dfs.fs_init_from_host(ts, "cpu")
        back = Transcript(b"")
        dfs.fs_state_to_host(back, fs)
        assert back.export_state() == ts.export_state()
        dfs.fs_absorb(F, fs, _u8(rng.bytes(40)))
        dfs.fs_state_to_host(back, fs.numpy())
        assert dfs.fs_init_from_host(back, "cpu").tolist() == fs.tolist()


def test_states_match_jax():
    """The absorbed state, the key and the PRF stream state against the
    JAX package's device_fs, across block boundaries."""
    rng = np.random.default_rng(3)
    F = fp128()
    jts = JaxTranscript(b"dfs")
    ts = Transcript(b"dfs")
    prefix = rng.bytes(21)
    jts._write_untyped(prefix)
    ts._write_untyped(prefix)
    jst = jfs.fs_init_from_host(jts)
    fs = dfs.fs_init_from_host(ts, "cpu")
    # 21 + 130 bytes: two blocks compressed, 23 left over
    data = rng.bytes(130)
    jst = jfs.fs_absorb(jst, jnp.asarray(np.frombuffer(data, np.uint8)))
    dfs.fs_absorb(F, fs, _u8(data))
    blob = _blob(fs)
    assert blob[:32] == np.asarray(jst["h"], "<u4").tobytes()
    assert int.from_bytes(blob[32:40], "little") == int(jst["cnt"])
    assert blob[40:] == np.asarray(jst["buf"]).tobytes()
    assert _blob(dfs.fs_getkey(F, fs)) == \
        np.asarray(jfs.fs_getkey(jst)).tobytes()
    jprf = jfs.fs_squeeze(jst)
    prf = dfs.new_prf("cpu")
    dfs.fs_squeeze(F, fs, prf)
    jb, jprf = jfs.prf_bytes(jprf, 40)
    assert _blob(dfs.prf_bytes(F, prf, 40)) == np.asarray(jb).tobytes()
    st = _blob(prf)
    assert st[:240] == np.asarray(jprf["rk"]).tobytes()
    assert st[240:256] == np.asarray(jprf["saved"]).tobytes()
    assert int.from_bytes(st[256:264], "little") == int(jprf["nb"])
    assert int.from_bytes(st[264:268], "little") == int(jprf["ptr"])


@pytest.mark.parametrize("field", list(FIELDS))
def test_samples_and_writes_match_jax_and_host(field):
    """A squeeze and samples against JAX dev_sample_elts and the host
    Transcript.elt; the tagged array and the tagged elements against
    Transcript.write_elts and write_elt."""
    mk, jmk = FIELDS[field]
    F, J = mk(), jmk()
    rng = np.random.default_rng(4)
    ts = _ts(rng, 33)
    fs = dfs.fs_init_from_host(ts, "cpu")
    vals = _elts(F, rng, 3)
    dfs.fs_write_elts(F, fs, F.to_limbs(vals, "cpu"))
    ts.write_elts(vals, F)
    dfs.write_tagged_elts(F, fs, F.to_limbs(vals[:2], "cpu"))
    for v in vals[:2]:
        ts.write_elt(v, F)
    assert _blob(fs) == ts.export_state()

    jts = JaxTranscript(b"")
    jts.import_state(ts.export_state())
    jprf = jfs.fs_squeeze(jfs.fs_init_from_host(jts))
    jx, _ = jfs.dev_sample_elts(J, jprf, 3)
    want = [J.from_limbs(np.asarray(jx[..., i])) for i in range(3)]
    prf = dfs.new_prf("cpu")
    got = list(F.from_limbs(dfs.dev_sample_elts(F, prf, 3, fs=fs)))
    assert got == want == ts.elts(3, F)
    # the stream goes on where the host's does
    assert _blob(dfs.prf_bytes(F, prf, 5)) == ts.bytes(5)


def test_forced_rejection_fp128():
    """REJECT_LABEL's first draw is rejected: the sample is the second
    draw, and the stream stands where the host Transcript.elt leaves it
    (three draws of 16 bytes in)."""
    F = fp128()
    ts = Transcript(REJECT_LABEL)
    first = int.from_bytes(ts.clone().bytes(16), "little")
    assert first >= F.p
    fs = dfs.fs_init_from_host(ts, "cpu")
    prf = dfs.new_prf("cpu")
    x = dfs.dev_sample_elts(F, prf, 2, fs=fs)
    assert list(F.from_limbs(x)) == ts.elts(2, F)
    assert int.from_bytes(_blob(prf)[256:264], "little") == 4   # blocks 0-3
    assert _blob(dfs.prf_bytes(F, prf, 7)) == ts.bytes(7)
    # the JAX package's sampler rejects it too
    jts = JaxTranscript(REJECT_LABEL)
    jx, _ = jfs.dev_sample_elts(jax_fp128(), jfs.fs_squeeze(
        jfs.fs_init_from_host(jts)), 2)
    assert [jax_fp128().from_limbs(np.asarray(jx[..., i]))
            for i in range(2)] == list(F.from_limbs(x))


@pytest.mark.parametrize("field", list(FIELDS))
def test_round_tail_matches_host_round(field):
    """K10's plain version against the host round: the polynomial from
    (claim, a0, a2), minus the pad, written by TranscriptSumcheck.round
    (evaluations 0 and 2, each tagged), its challenge, and the claim
    interpolated at it."""
    mk, _ = FIELDS[field]
    F = mk()
    rng = np.random.default_rng(5)
    consts = round_consts(F, "cpu")
    for prefix in (3, 40):
        ts = _ts(rng, prefix)
        fs = dfs.fs_init_from_host(ts, "cpu")
        claim, a0, a2, eq0, p0, p1, p2 = _elts(F, rng, 7)
        c0, c2 = F.mul_i(eq0, a0), F.mul_i(eq0, a2)
        c1 = F.sub_i(F.sub_i(F.sub_i(claim, c0), c0), c2)
        raw = evals_of_coefs(F, [c0, c1, c2])
        ev = [F.sub_i(x, y) for x, y in zip(raw, (p0, p1, p2))]
        r = TranscriptSumcheck(ts, F).round(ev)
        new_claim = eval_lagrange(F, raw, r)

        claim_t = F.to_limbs(claim, "cpu")
        row = torch.empty((4, F.nlimb), dtype=torch.int32)
        dfs.round_tail(F, fs, claim_t, row, F.to_limbs([a0, a2], "cpu"),
                       F.to_limbs(eq0, "cpu"), F.to_limbs([p0, p1, p2], "cpu"),
                       consts)
        assert list(F.from_limbs(row)) == ev + [r]
        assert F.from_limbs(claim_t) == new_claim
        assert _blob(fs) == ts.export_state()


# (n, k) of the column choices: the toy proofs' n = block_enc - dblock =
# 128 - 41, the SHA-256 golden's 2048 - 681 and the mdoc hash proof's
# 4151 - 921, each with its nreq; and the byte count's edges: one byte
# below 256, two from 256 on, a walk that crosses n - i = 256 (300 -> 201)
CHOOSE_CASES = [(2, 2), (255, 40), (256, 40), (257, 40), (300, 100),
                (87, 6), (1367, 128), (3230, 132)]


@pytest.mark.parametrize("n,k", CHOOSE_CASES)
def test_choose_matches_host(n, k):
    """K9 mode 9's plain version (a squeeze, then the walk) against the
    port's and the JAX package's host Transcript.choose; the stream
    goes on where the host's does."""
    rng = np.random.default_rng(n)
    F = gf2_128() if n % 2 else fp128()
    ts = _ts(rng, 17 + n % 50)
    jts = JaxTranscript(b"")
    jts.import_state(ts.export_state())
    fs = dfs.fs_init_from_host(ts, "cpu")
    prf = dfs.new_prf("cpu")
    idx = dfs.dev_choose(F, fs, prf, n, k)
    assert idx.dtype == torch.int32
    assert idx.tolist() == ts.choose(n, k) == jts.choose(n, k)
    assert _blob(fs) == ts.export_state()
    assert _blob(dfs.prf_bytes(F, prf, 21)) == ts.bytes(21)
    # after a write, a fresh squeeze
    x = F.to_limbs([n], "cpu")
    dfs.fs_write_elts(F, fs, x)
    ts.write_elts([n], F)
    more = dfs.dev_choose(F, fs, prf, n, min(k, 5))
    assert more.tolist() == ts.choose(n, min(k, 5))


def test_write_bytes_const_matches_host():
    """The HASH_OF_A write, fs_absorb of its bstr_tensor: [TAG_BSTR,
    le8(len), data] as Transcript.write_bytes."""
    from longfellow_zk_tpu_torch.zk.common import HASH_OF_A

    rng = np.random.default_rng(6)
    F = p256_base()
    for prefix in (0, 22, 23, 60):
        ts = _ts(rng, prefix)
        fs = dfs.fs_init_from_host(ts, "cpu")
        dfs.fs_absorb(F, fs, dfs.bstr_tensor(HASH_OF_A, "cpu"))
        ts.write_bytes(HASH_OF_A)
        assert _blob(fs) == ts.export_state()


@pytest.mark.slow
@pytest.mark.parametrize("n,k,first", [(87, 6, None), (200, 40, 10),
                                       (300, 100, 53)])
def test_jax_dev_choose_against_host(n, k, first):
    """The JAX package's dev_choose (eager on the CPU, its while loops
    compile per call) against the host Transcript.choose from one state:
    equal on the toy proofs' choice, 6 of 87; from draw `first` on it
    departs, where its prf_bytes repeats a block after a one-byte read
    that ends an AES block (ROADMAP C).  The port's choice (K9 mode 9's
    plain version) keeps to the host on every case."""
    ts = Transcript(b"dfs-choose")
    ts._write_untyped(bytes(range(33)))
    jts = JaxTranscript(b"")
    jts.import_state(ts.export_state())
    jidx, _ = jfs.dev_choose(jfs.fs_squeeze(jfs.fs_init_from_host(jts)),
                             n, k)
    got = [int(i) for i in np.asarray(jidx)]
    fs = dfs.fs_init_from_host(ts, "cpu")
    port = dfs.dev_choose(fp128(), fs, dfs.new_prf("cpu"), n, k)
    want = ts.choose(n, k)
    assert port.tolist() == want
    diff = next((i for i in range(k) if got[i] != want[i]), None)
    assert diff == first
