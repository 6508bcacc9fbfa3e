"""The port's multi-card paths at full size on N cards, each held to its
golden and to its one-card run, and timed.

    python3 -m longfellow_zk_tpu_torch.parallel.smoke [--world N]

(N: the cards to use, by default every card visible.)  The ranks are
started by parallel/launch.spawn, NCCL between them; each check runs on
every rank, exact (tolerance 0):

  ntt       ShardedNTT.fftb over Fp128 at n = 2^20, radix 128, the ranks
            on the rows axis of a (N, 1) mesh: every rank's partition
            and the gathered whole equal one card's MatmulNTT.fftb, word
            for word;
  copies    the plain sumcheck (SumcheckProver.prove_with_witness) over
            the SHA-256 one-block circuit x 64 copies (copy 0 b"abc",
            copy c b"msg%04d"), the copies over a (1, N) mesh: the
            listing of testdata/sumcheck_sha256_copies64.json on every
            rank and on one card; the port's verify accepts it and
            refuses a flipped wc;
  zk_sha256, zk_ecdsa, zk_bitaddr
            ZkProver on a (N, 1) mesh (tableau rows sharded) for the
            goldens sha256_1block_fp128, ecdsa_p256 (Fp2 Reed-Solomon)
            and bitaddr_p256k1 (CRT Reed-Solomon, 25 tableau rows): the
            golden bytes and transcript_states.json's final state on
            every rank and on one card; the port's ZkVerifier accepts the
            golden and refuses a one-bit flip;
  batch     BatchZkProver on a (N, 1) mesh, 8 SHA-256 lanes (lane 0 the
            golden's witness and tag, lane i b"msg%04d" under b"bench%d"):
            every lane equals the scalar ZkProver's proof with its tag
            and the one stream continued (each rank proves its lanes'
            twins), lane 0 the golden; the unsharded batch is the
            one-card run;
  rs_encode sharded_rs_encode of the SHA-256 tableau's block-width rows
            (their DeterministicEngine draws), gathered: one card's
            interpolate.

For each, the launch counts are set to zero just before the first
sharded run and read just after (each kernel the path must run has to
have launched); then one run timed on the host clock (the ranks start
together; wall = the slowest rank's) and one profiled on each rank: the
device ms of every kernel and copy (after a head of sleep kernels, left
out: the profiler loses a window's first records; the ranks meet at a
barrier just before), the NCCL kernels' ms by name (an NCCL kernel
spins until every rank joins: its ms hold the wait for the slowest
rank), and the bytes this rank's collectives sent (Mesh.sent_bytes); the
same work on one card (mesh=None) timed and
profiled on each rank beside it.  Bound: max(the sharded work's bound /
N, the bytes a card sends / 450 GB/s (NVLink, each way)); the sharded
work's bound is, for ntt, the matmul NTT's operations (the int8 tensor
cores' rate; chip_smoke.py run_fft_phase's), for copies K16's products in
every copy round at the width a rank holds, for zk_* and batch the
sharded commit's (the block-width rows read and their extension written
once, K8's SHA-256 compressions of the column hashes), for rs_encode its
rows read and written once: the replicated steps are not counted, so the
proof rows' bounds are floors.

The last line is a JSON object {"parallel": {check: {...}}, "ok": ...}.
Importing this module starts nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import hashlib
import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TESTDATA = os.path.join(REPO, "longfellow_zk_tpu_torch", "testdata")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
INT32_OPS_PER_S = 67e12 / 4      # chip_smoke.py's integer multiply rate
INT8_OPS_PER_S = 1979e12         # the int8 tensor cores, dense
NVLINK_BYTES_PER_S = 450e9       # NVLink 4 on an H100 SXM, each way
SHA_OPS_PER_BLOCK = 64 * 17 + 48 * 11
HEAD_PAD = 256
COPIES, COPIES_LABEL, LANES = 64, b"sha256-copies", 8
CHECKS = ("ntt", "copies", "zk_sha256", "zk_ecdsa", "zk_bitaddr", "batch",
          "rs_encode")


# ----------------------------------------------------------------------
# measurement
# ----------------------------------------------------------------------

def _device_ms(fn):
    """(device ms, {NCCL kernel: ms}, fn's output) of one call of fn: the
    sum of the kernels and copies the profiler records, after a head of
    HEAD_PAD sleep kernels (left out).  An NCCL kernel runs from its
    launch until the other ranks join it, so its ms count the wait for
    the slowest rank."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(HEAD_PAD):
            torch.cuda._sleep(1)
        out = fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    total, nccl = 0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or "spin_kernel" in e.name():
            continue
        ns = e.end_ns() - e.start_ns()
        total += ns
        if "nccl" in e.name().lower():
            nccl[e.name()] = nccl.get(e.name(), 0) + ns / 1e6
    return total / 1e6, nccl, out


def _wall_ms(mesh, fn):
    """Host ms of one call of fn, every rank started together."""
    mesh.barrier()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize(mesh.device)
    return (time.perf_counter() - t) * 1e3


def measure(mesh, sharded, one_card, expect, local_bound_ms):
    """The launches, times and bytes of the check (see the module's
    docstring); `sharded` and `one_card` return what the check holds to
    the golden.  Returns (record, sharded's first output, one_card's)."""
    from .. import kernels

    kernels.reset_launches()
    first = sharded()
    torch.cuda.synchronize(mesh.device)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    missing = [k for k in expect if not launches.get(k)]
    sent0 = mesh.sent_bytes
    wall = _wall_ms(mesh, sharded)
    sent = mesh.sent_bytes - sent0
    mesh.barrier()
    dev, nccl, _ = _device_ms(sharded)
    mesh.barrier()
    one = one_card()
    one_wall = _wall_ms(mesh, one_card)
    one_dev, _, _ = _device_ms(one_card)
    D = mesh.world
    link = sent / NVLINK_BYTES_PER_S * 1e3
    rec = dict(launches=launches, missing=missing, wall_ms=wall,
               device_ms=dev, nccl_ms=nccl,
               nccl_total_ms=sum(nccl.values()), sent_bytes=sent,
               one_card_wall_ms=one_wall, one_card_device_ms=one_dev,
               bound_ms=max(local_bound_ms / D, link),
               bound_by="local work" if local_bound_ms / D >= link
               else "bytes between cards")
    return rec, first, one


# ----------------------------------------------------------------------
# the inputs
# ----------------------------------------------------------------------

def _meta(name):
    with open(os.path.join(TESTDATA, name + ".proof.json")) as f:
        return json.load(f)


def _golden(name):
    with open(os.path.join(TESTDATA, name + ".proof.bin"), "rb") as f:
        return f.read()


def _circuit(F, field_id, path):
    from ..proto.lfc1 import read_circuit

    with gzip.open(os.path.join(REPO, path), "rb") as f:
        return read_circuit(F, field_id, f.read())


def sha_witness(F, message):
    """All input wires of the SHA-256 one-block circuit for `message`."""
    from ..circuits.sha.sha256 import (
        SHA256_INIT, pack_block_witness, sha256_pad, transform_block_witness)

    padded = sha256_pad(message)
    W = [F.of_scalar(1)] + [F.of_scalar((byte >> i) & 1)
                            for byte in padded for i in range(8)]
    W.extend(pack_block_witness(
        F, 4, [transform_block_witness(SHA256_INIT, padded)]))
    return W


def ecdsa_witness(F, seed):
    """bench.py phase_ecdsa's witness (testdata/ecdsa_p256.proof.json)."""
    from ..circuits.ecdsa.verify import compute_witness
    from ..ec.curves import ecdsa_sign, p256_curve

    ec = p256_curve()
    er = random.Random(seed)
    d = er.randrange(1, ec.order)
    pk = ec.normalize(ec.scalar_mult(ec.generator(), d))
    e = er.randrange(1, ec.order)
    r, s = ecdsa_sign(ec, d, e, er.randrange(1, ec.order))
    return [F.of_scalar(1), pk.x, pk.y, e % F.p] + \
        compute_witness(ec, pk.x, pk.y, e, r, s).fill()


def bitaddr_witness(F, seed):
    """testdata/bitaddr_p256k1.proof.json's witness."""
    from ..circuits.bitaddr.bitaddr import BitaddrWitness
    from ..circuits.ripemd.reference import ripemd160
    from ..ec.curves import p256k1_curve

    ec = p256k1_curve()
    sk = random.Random(seed).randrange(1, ec.order)
    bw = BitaddrWitness(ec, F)
    bw.compute_witness(sk)
    pk = ec.normalize(ec.scalar_mult(ec.generator(), sk))
    compressed = bytes([2 + (pk.y & 1)]) + pk.x.to_bytes(32, "big")
    addr = int.from_bytes(ripemd160(hashlib.sha256(compressed).digest()),
                          "big")
    assert bw.addr == addr
    return [F.of_scalar(1), addr % F.p] + bw.fill()


def zk_cases():
    """name -> (field, circuit, witness, RS factory maker, meta, golden,
    its transcript_states.json key)."""
    from ..fields.fp2 import Fp2
    from ..fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER, P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X,
        P256_FP2_ROOT_Y, fp128, p256_base, p256k1_base)
    from ..proto.lfc1 import FP128_ID, P256_ID, SECP_ID
    from ..zk.testing import rs_factory_for

    F, FB, FK = fp128(), p256_base(), p256k1_base()
    m_sha, m_ec, m_bit = (_meta(n) for n in (
        "sha256_1block_fp128", "ecdsa_p256", "bitaddr_p256k1"))
    return {
        "zk_sha256": (F, _circuit(F, FP128_ID, m_sha["circuit"]),
                      sha_witness(F, m_sha["message"].encode()),
                      lambda dev: rs_factory_for(F, P128_OMEGA,
                                                 P128_OMEGA_ORDER,
                                                 device=dev),
                      m_sha, "sha256_1block_fp128"),
        "zk_ecdsa": (FB, _circuit(FB, P256_ID, m_ec["circuit"]),
                     ecdsa_witness(FB, m_ec["seed"]),
                     lambda dev: rs_factory_for(
                         FB, F2=Fp2(FB),
                         omega2=(P256_FP2_ROOT_X, P256_FP2_ROOT_Y),
                         omega_order=P256_FP2_ROOT_ORDER, device=dev),
                     m_ec, "ecdsa_p256"),
        "zk_bitaddr": (FK, _circuit(FK, SECP_ID, m_bit["circuit"]),
                       bitaddr_witness(FK, m_bit["seed"]),
                       lambda dev: rs_factory_for(FK, device=dev),
                       m_bit, "bitaddr_p256k1")}


def prover_kernels(*instances):
    """The kernels a ZK proof of those instances must launch (as
    chip_smoke.py's prover_kernels)."""
    from .. import kernels

    return [k for k in kernels.KERNELS if k.endswith(instances)
            and not k.startswith(("fp_quad_bind[", "copy_round_sums[",
                                  "sumcheck_round_tail_cubic[",
                                  "fp_matmul_ntt[", "rfft_pass[",
                                  "nb_butterfly[", "nb_base_conv[",
                                  "fp_inv["))
            and k not in ("crt_to[fp256]", "crt_from[fp256]")
            ] + ["sha256_msgs[bytes]"]


def _commit_bound_ms(F, p, lanes):
    """The sharded commit's bound on one card (see the module's
    docstring): the block-width rows read and their extension written
    once, and the column hashes' SHA-256 compressions."""
    eb = 4 * int(np.prod(F.elt_shape))
    nblock = 1 + p.nwrow + 3 * p.nqtriples
    nbytes = lanes * nblock * (p.block + p.block_enc) * eb
    msg = 32 + p.nrow * F.kBytes
    ops = lanes * p.block_ext * ((msg + 8) // 64 + 1) * SHA_OPS_PER_BLOCK
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3


# ----------------------------------------------------------------------
# the checks, on every rank
# ----------------------------------------------------------------------

def check_ntt(world):
    from ..fields.fp_instances import P128_OMEGA, P128_OMEGA_ORDER, fp128
    from ..transforms.matmul_ntt import MatmulNTT
    from .mesh import make_mesh
    from .ntt_sharded import ShardedNTT

    F, n = fp128(), 1 << 20
    mesh = make_mesh(world, 1)
    dev = mesh.device
    # canonical elements: a top word below 0xFFF00000 keeps x below p
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, size=(n, 4), dtype=np.uint64)
    words[:, 3] %= 0xFFF00000
    x = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
    snt = ShardedNTT(F, P128_OMEGA, P128_OMEGA_ORDER, mesh, radix=128)
    mnt = MatmulNTT(F, P128_OMEGA, P128_OMEGA_ORDER, 128, dev)
    snt.prepare(n)
    mnt.prepare(n)
    xl = snt.shard_input(x)
    mm_ops = 2 * sum((n // B) * (16 * B) ** 2 for B in (64, 128, 128))
    local = max(6 * 16 * n / HBM_BYTES_PER_S,
                mm_ops / INT8_OPS_PER_S + 2 * 32 * n / INT32_OPS_PER_S) * 1e3
    rec, yl, y1 = measure(mesh, lambda: snt.fftb(xl), lambda: mnt.fftb(x),
                          ["fp_matmul_ntt[fp128]", "fp_elementwise[fp128]"],
                          local)
    R, Sd = yl.shape[0], yl.shape[1]
    k = mesh.index("rows")
    rec["exact"] = bool(
        torch.equal(yl, y1.reshape(R, -1, 4)[:, k * Sd : (k + 1) * Sd])
        and torch.equal(snt.gather_output(yl), y1))
    rec["shape"] = "2^20 points, R = %d, S = %d, %d a card" % (
        R, Sd * world, n // world)
    return rec


def check_copies(world):
    from ..fields.fp_instances import fp128
    from ..proto.lfc1 import FP128_ID
    from ..random_oracle.transcript import Transcript
    from ..sumcheck.prover import SumcheckProver
    from ..sumcheck.transcript_sumcheck import TranscriptSumcheck
    from ..sumcheck.verifier import verify
    from .mesh import make_mesh

    F = fp128()
    mesh = make_mesh(1, world)
    dev = mesh.device
    with open(os.path.join(TESTDATA, "sumcheck_sha256_copies64.json")) as f:
        golden = json.load(f)["listing"]
    circ = _circuit(F, FP128_ID, _meta("sha256_1block_fp128")["circuit"])
    cc = dataclasses.replace(circ, nc=COPIES,
                             logc=(COPIES - 1).bit_length())
    W_host = [sha_witness(F, m) for m in
              [b"abc"] + [b"msg%04d" % i for i in range(1, COPIES)]]
    W0 = F.to_limbs([w for W in W_host for w in W], dev).reshape(
        (COPIES, cc.ninputs) + F.elt_shape)

    def prove(m):
        def run():
            ts = Transcript(COPIES_LABEL)
            tss = TranscriptSumcheck(ts, F)
            tss.write_input(W_host)
            proof, aux, b = SumcheckProver(F, dev, m).prove_with_witness(
                cc, W0, tss)
            return proof, listing(F, proof, aux, b, ts)
        return run

    # K16's products in every copy round, at the width a rank holds
    C, ops_one, ops_card = 1 << cc.logc, 0, 0
    for layer in cc.layers:
        for r in range(cc.logc):
            width = C >> r
            mine = width // world if width // world >= 2 else width
            ops_one += (7 * (width // 2) + 3) * layer.nterms * 32
            ops_card += (7 * (mine // 2) + 3) * layer.nterms * 32
    rec, (proof, got), (_, one) = measure(
        mesh, prove(mesh), prove(None),
        ["copy_round_sums[fp128]", "sumcheck_round_tail_cubic[fp128]",
         "fp_wire_round[fp128]", "sumcheck_round_tail[fp128]",
         "layer_hv[fp128]"],
        ops_card * world / INT32_OPS_PER_S * 1e3)
    ok = got == golden and one == golden
    if mesh.rank == 0:
        ok &= verify(cc, proof, W_host,
                     TranscriptSumcheck(Transcript(COPIES_LABEL), F), F,
                     device=dev)[0]
        proof.layers[0].wc[1] = F.add_i(proof.layers[0].wc[1], 1)
        ok &= not verify(cc, proof, W_host,
                         TranscriptSumcheck(Transcript(COPIES_LABEL), F), F,
                         device=dev)[0]
    rec["exact"] = bool(ok)
    rec["shape"] = "%d copies, %d a card; K16 bound one card %.5f ms" % (
        COPIES, COPIES // world, ops_one / INT32_OPS_PER_S * 1e3)
    return rec


def listing(F, proof, aux, bindings, ts):
    """A plain sumcheck proof as canonical hex (the layout of
    testdata/sumcheck_sha256_copies64.json's listing)."""
    w = 2 * F.kBytes

    def hx(x):
        return "%0*x" % (w, int(x))

    return {"layers": [{"cp": [[hx(v) for v in p] for p in lp.cp],
                        "hp": [[[hx(v) for v in p] for p in hand]
                               for hand in lp.hp],
                        "wc": [hx(v) for v in lp.wc], "bound_quad": hx(bq)}
                       for lp, bq in zip(proof.layers, aux.bound_quad)],
            "q": [hx(x) for x in bindings["q"]],
            "g": [[hx(x) for x in h] for h in bindings["g"]],
            "transcript_state": ts.export_state().hex()}


def _zk_prove(F, circ, rs, W, meta, dev, mesh, rng):
    from ..random_oracle.transcript import Transcript
    from ..zk.proof import ZkProof
    from ..zk.prover import ZkProver
    from ..zk.serialization import write_zk_proof

    zkp = ZkProof(rate=meta["rate"], nreq=meta["nreq"])
    prover = ZkProver(circ, F, rs, rate=meta["rate"], nreq=meta["nreq"],
                      device=dev, mesh=mesh)
    ts = Transcript(meta["transcript_label"].encode(),
                    version=meta["version"])
    prover.commit(zkp, W, ts, rng)
    assert prover.prove(zkp, W, ts)
    return write_zk_proof(zkp, circ, prover.param, F), \
        ts.export_state().hex()


def _zk_verifies(F, circ, rs, pub, meta, data, dev):
    from ..random_oracle.transcript import Transcript
    from ..zk.serialization import read_zk_proof
    from ..zk.verifier import ZkVerifier

    v = ZkVerifier(circ, F, rs, rate=meta["rate"], nreq=meta["nreq"],
                   device=dev)
    zkp = read_zk_proof(data, circ, v.param, F, meta["rate"], meta["nreq"])
    if zkp is None:
        return False
    ts = Transcript(meta["transcript_label"].encode(),
                    version=meta["version"])
    v.recv_commitment(zkp, ts)
    return v.verify(zkp, pub, ts)[0]


def check_zk(world, name, case):
    from ..random_oracle.engine import DeterministicEngine
    from ..zk.prover import ZkProver
    from .mesh import make_mesh

    F, circ, W, make_rs, meta, key = case
    mesh = make_mesh(world, 1)
    dev = mesh.device
    rs = make_rs(dev)
    golden = _golden(key)
    with open(os.path.join(TESTDATA, "transcript_states.json")) as f:
        state = json.load(f)[key][0]
    tags = {"zk_sha256": ("[fp128]",), "zk_ecdsa": ("[fp256]", "[fp256x2]"),
            "zk_bitaddr": ("[fp256k1]", "[crt]")}[name]
    param = ZkProver(circ, F, rs, rate=meta["rate"], nreq=meta["nreq"],
                     device=dev).param
    rec, got, one = measure(
        mesh, lambda: _zk_prove(F, circ, rs, W, meta, dev, mesh,
                                DeterministicEngine()),
        lambda: _zk_prove(F, circ, rs, W, meta, dev, None,
                          DeterministicEngine()),
        prover_kernels(*tags), _commit_bound_ms(F, param, 1))
    ok = got == (golden, state) and one == (golden, state)
    if mesh.rank == 0:
        bad = bytearray(golden)
        bad[32] ^= 1
        pub = W[: circ.npub_in]
        ok &= _zk_verifies(F, circ, rs, pub, meta, golden, dev)
        ok &= not _zk_verifies(F, circ, rs, pub, meta, bytes(bad), dev)
    rec["exact"] = bool(ok)
    rec["shape"] = "tableau %d x %d, %d block-width rows over %d cards" % (
        param.nrow, param.block_enc, 1 + param.nwrow + 3 * param.nqtriples,
        world)
    return rec


def check_batch(world, case):
    from ..random_oracle.engine import DeterministicEngine
    from ..random_oracle.transcript import Transcript
    from ..zk.batch import BatchZkProver
    from ..zk.prover import ZkProver
    from .mesh import make_mesh

    F, circ, W, make_rs, meta, key = case
    mesh = make_mesh(world, 1)
    dev = mesh.device
    rs = make_rs(dev)
    Ws = [W] + [sha_witness(F, b"msg%04d" % i) for i in range(1, LANES)]
    tags = [meta["transcript_label"].encode()] + \
        [b"bench%d" % i for i in range(1, LANES)]

    def batch(m):
        def run():
            bp = BatchZkProver(circ, F, rs, rate=meta["rate"],
                               nreq=meta["nreq"], device=dev, mesh=m)
            tss = [Transcript(t, version=meta["version"]) for t in tags]
            return bp.prove_batch(Ws, tss, DeterministicEngine())
        return run

    # the scalar twins of this rank's lanes, the one stream continued
    lo, hi = mesh.bounds(LANES)
    eng = DeterministicEngine()
    zp = ZkProver(circ, F, rs, rate=meta["rate"], nreq=meta["nreq"],
                  device=dev)
    zp.draw_lanes(Ws[:lo], eng)
    scalar = []
    for i in range(lo, hi):
        scalar.append(_zk_prove(F, circ, rs, Ws[i], dict(
            meta, transcript_label=tags[i].decode()), dev, None, eng)[0])
    rec, got, one = measure(
        mesh, batch(mesh), batch(None), prover_kernels("[fp128]"),
        _commit_bound_ms(F, zp.param, LANES))
    ok = got == one and got[lo:hi] == scalar and got[0] == _golden(key)
    rec["exact"] = bool(ok)
    rec["shape"] = "%d SHA-256 lanes, %d a card" % (LANES, LANES // world)
    return rec


def check_rs_encode(world, case):
    from ..random_oracle.engine import DeterministicEngine
    from ..zk.prover import ZkProver
    from .mesh import make_mesh, shard_rows, sharded_rs_encode, split

    F, circ, W, make_rs, meta, key = case
    mesh = make_mesh(world, 1)
    dev = mesh.device
    rs_factory = make_rs(dev)
    zp = ZkProver(circ, F, rs_factory, rate=meta["rate"], nreq=meta["nreq"],
                  device=dev)
    p = zp.param
    _, preps = zp.draw_lanes([W], DeterministicEngine())
    rows = F.to_limbs([v for row in preps[0][0] for v in row], dev).reshape(
        (-1, p.block) + F.elt_shape)
    rs = rs_factory(p.block, p.block_enc)
    mine = shard_rows(mesh, rows)
    eb = 4 * F.nlimb
    rec, got, one = measure(
        mesh, lambda: mesh.gather(sharded_rs_encode(rs, mesh, mine),
                                  rows.shape[0]),
        lambda: rs.interpolate(rows), ["fp_ntt[fp128]"],
        rows.shape[0] * (p.block + p.block_enc) * eb / HBM_BYTES_PER_S * 1e3)
    rec["exact"] = bool(torch.equal(got, one))
    rec["shape"] = "%d rows, %d -> %d, %s a card" % (
        rows.shape[0], p.block, p.block_enc,
        "/".join(str(hi - lo) for lo, hi in split(rows.shape[0], world)))
    return rec


def rank_checks(world, only=None):
    """Every check (or those named in `only`) on this rank: {check:
    record}."""
    out = {}
    cases = zk_cases()
    for name in only or CHECKS:
        t = time.perf_counter()
        if name == "ntt":
            rec = check_ntt(world)
        elif name == "copies":
            rec = check_copies(world)
        elif name.startswith("zk_"):
            rec = check_zk(world, name, cases[name])
        elif name == "batch":
            rec = check_batch(world, cases["zk_sha256"])
        else:
            rec = check_rs_encode(world, cases["zk_sha256"])
        rec["seconds"] = time.perf_counter() - t
        out[name] = rec
    return out


# ----------------------------------------------------------------------
# the parent
# ----------------------------------------------------------------------

def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def run(world, timeout_s=1800.0, only=None):
    """The checks on `world` cards; prints a line a check.  Returns (all
    exact and every expected kernel launched, {check: summary})."""
    from . import smoke
    from .launch import spawn

    per_rank = spawn(smoke.rank_checks, world, "cuda", timeout_s,
                     args=(world, only))
    ok, summary = True, {}
    for name in per_rank[0]:
        recs = [r[name] for r in per_rank]
        r0 = recs[0]
        good = all(r["exact"] and not r["missing"] for r in recs)
        ok &= good
        nccl = {}
        for r in recs:
            for k, v in r["nccl_ms"].items():
                nccl[k] = nccl.get(k, 0.0) + v / len(recs)
        summary[name] = dict(
            exact=all(r["exact"] for r in recs), world=world,
            shape=r0["shape"], wall_ms=max(r["wall_ms"] for r in recs),
            device_ms=[r["device_ms"] for r in recs],
            nccl_card_ms=[r["nccl_total_ms"] for r in recs],
            nccl_ms=nccl, sent_bytes=[r["sent_bytes"] for r in recs],
            one_card_wall_ms=r0["one_card_wall_ms"],
            one_card_device_ms=r0["one_card_device_ms"],
            bound_ms=r0["bound_ms"], bound_by=r0["bound_by"],
            launches=r0["launches"],
            missing=sorted({k for r in recs for k in r["missing"]}),
            seconds=max(r["seconds"] for r in recs))
        s = summary[name]
        print("parallel %-10s world %d (%s): %s; wall %.3f ms (one card "
              "%.3f ms); device ms a card %s, of which NCCL %s (one card "
              "%.4f); NCCL kernels, ms a card %s; bytes sent a card %s; "
              "bound %.5f ms (%s); launches of the first sharded run %s%s; "
              "%.1f s"
              % (name, world, s["shape"],
                 "exact" if s["exact"] else "FAIL: differs", s["wall_ms"],
                 s["one_card_wall_ms"],
                 ", ".join("%.4f" % v for v in s["device_ms"]),
                 ", ".join("%.4f" % v for v in s["nccl_card_ms"]),
                 s["one_card_device_ms"],
                 json.dumps({k: round(v, 5) for k, v in nccl.items()}),
                 s["sent_bytes"], s["bound_ms"], s["bound_by"],
                 json.dumps(s["launches"]),
                 "; NOT LAUNCHED: %s" % s["missing"] if s["missing"] else "",
                 s["seconds"]))
    return ok, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=None,
                    help="cards to use (default: every card visible)")
    ap.add_argument("--only", nargs="*", choices=CHECKS, default=None)
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    world = args.world or torch.cuda.device_count()
    smi = card_line()
    print("cards: %d x %s | %s; torch %s, CUDA %s" % (
        world, torch.cuda.get_device_name(0), smi, torch.__version__,
        torch.version.cuda))
    t = time.perf_counter()
    ok, summary = run(world, args.timeout, args.only)
    print("%d checks in %.1f s: %s" % (len(summary), time.perf_counter() - t,
                                       "all exact" if ok else "FAILED"))
    print(smi)
    print(json.dumps({"parallel": summary, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
