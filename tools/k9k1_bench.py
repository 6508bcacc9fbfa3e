#!/usr/bin/env python3
"""K9 fs_oracle and K1 fp_elementwise at the prime instances on the card,
tree against tree, and each proof's K9 and K1 time split by mode and size.

    python3 tools/k9k1_bench.py [--roots DIR ...] [--only k9 k1 proof]
                                [--k1-fields TAG ...] [--out FILE]

Each root (a checkout of this repository; default: this one) runs in a
child process of its own, in the order given, so `--roots old . . old`
times two trees in turns on one card.  A child

  - builds the root's csrc/fs.cu and csrc/fp_ops.cu with `nvcc -Xptxas
    -v` (registers, stack and spills of every K9 kernel and of K1's
    kernels at fp128, fp256 and fp256k1) and counts the K9 kernels' SASS
    instructions (cuobjdump), then, for the proofs, the root's other
    kernels;
  - k9: K9 at the shapes of each proof of chip_smoke.py (the SHA-256,
    ECDSA, mdoc hash and signature, and bitaddr proofs; sizes from
    ZkProver.param and zk/fused.py's static tables): the four response
    writes of zk/fused.py ligero_finish_dev (y_ldt, y_dot, y_quad[:r],
    y_quad[block:dblock], one array each), its Ligero draw (a squeeze
    and the u_ldt, alphal, alphaq and u_quad samples), its column choice
    (mode 9), and the small steps of a proof (a squeeze and 2 samples, a
    squeeze and 80 samples, a write of 2 elements); each from a random
    transcript state, held to the host Transcript (the state after a
    write; the elements and the stream after a draw), device ms a launch
    beside the chain of its compressions and key schedules
    (chip_smoke.py's model: SHA_CHAIN a compression, AES_KEY_CHAIN and
    AES_BLOCK_CHAIN a squeeze, PROD_CHAIN a field product);
  - k1: K1 at its 2-12-word instances (fp128, fp256, fp256k1, fp64,
    p256n, p256k1n, p384) against its plain version in every mode at 2^20
    elements (device ms warm and with the L2 flushed), and at fp128,
    fp256 and fp256k1 bind, hv and (where the root has it) bind_hv at the
    round sizes of the mdoc signature circuit's largest layer (bind of
    its wires, hv of its terms), with 1 and 3 lanes (only fp_ops.cu is
    built unless the proofs run);
  - proof: the SHA-256, ECDSA, mdoc and bitaddr proofs, each held to its
    golden bytes, then one profiled with each K9 (fs_oracle, fs_choose)
    and K1 launch at fp128, fp256 and fp256k1 matched, in order, to the
    call that made it (the wrappers' calls logged through
    kernels.launch): device ms and launches by mode and by size (powers
    of 2), every kernel's device ms and launches, the device busy ms.

Device times are chip_smoke.py's device_ms.  Prints one JSON line a child
and writes all of them, with the card's name and power limit, to --out
(default k9k1_bench.json in the port's ignored build directory).  Needs a
card and nvcc.
"""

import argparse
import gzip
import hashlib
import importlib.util
import json
import os
import random
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(HERE, "longfellow_zk_tpu_torch", "testdata")
K1_TAGS = {"fp128": "P128", "fp256": "P256", "fp256k1": "P256K1"}
K9_TAGS = dict(K1_TAGS, gf2_128="G128")
K1_MODES = ("mul", "add", "sub", "bind", "hv", "sqr", "neg", "eq",
            "is_zero", "select", "inv", "bind_hv")
K9_MODES = ("absorb", "getkey", "prf_fresh", "squeeze", "prf_bytes",
            "write_array", "write_tagged", "sample", "squeeze_sample")


def k1_rec(tag):
    """A profiler record's name of a K1 kernel at instance `tag`."""
    return re.compile(r"k_fp_(?!inv)[a-z0-9_]+<%s[,>]" % K1_TAGS[tag])


def k9_rec(tag):
    """... of a K9 kernel (modes 0-8) at `tag`; mode 9 apart."""
    return re.compile(r"k_fs_(?!choose)[a-z0-9_]+<%s[,>]" % K9_TAGS[tag])


def k9c_rec(tag):
    return re.compile(r"k_fs_choose<%s[,>]" % K9_TAGS[tag])


def ptxas_lines(log):
    """{mangled kernel: "registers ...; stack ..."} of the K9 kernels and
    the prime K1 kernels in nvcc -Xptxas -v output."""
    out, cur = {}, None
    keep = re.compile(r"k_fs_|k_fp_\w*(P128|P256)")
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(_Z\w+)", line)
        if m:
            cur = m.group(1) if keep.search(m.group(1)) else None
            continue
        if cur and ("stack frame" in line or "Used" in line):
            out.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def demangle(names):
    try:
        r = subprocess.run(["c++filt"], input="\n".join(names),
                           capture_output=True, text=True)
        return dict(zip(names, r.stdout.splitlines()))
    except OSError:
        return {n: n for n in names}


def build(kernels, full):
    """fs.cu and fp_ops.cu with -Xptxas -v, then (full) every other stale
    kernel; returns their ptxas lines and the seconds taken."""
    t0 = time.perf_counter()
    procs = []
    for src in ("fs.cu", "fp_ops.cu"):
        lib = kernels._lib_path(src)
        tmp = lib + ".%d.tmp" % os.getpid()
        cmd = [kernels.nvcc_path()] + kernels.NVCC_FLAGS + \
            ["-Xptxas", "-v", "-o", tmp, os.path.join(kernels.CSRC, src)]
        procs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = ""
    for lib, tmp, p in procs:
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError("nvcc failed:\n" + out)
        os.replace(tmp, lib)
        log += out
    if full:
        kernels.build_all()
    ptx = ptxas_lines(log)
    dm = demangle(list(ptx))
    return {dm.get(k, k): v for k, v in ptx.items()}, \
        time.perf_counter() - t0


def sass_counts(kernels):
    """{kernel: SASS instructions} of libfs.so's kernels."""
    exe = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    r = subprocess.run([exe, "-sass", kernels._lib_path("fs.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        return "cuobjdump exited %d" % r.returncode
    out, cur = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = 0
        elif cur and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[cur] += 1
    dm = demangle(list(out))
    return {dm.get(k, k).split("(")[0]: v for k, v in out.items()}


class Proof:
    """One proof of chip_smoke.py: its field, circuit and metadata, and
    the sizes of its response writes, its Ligero draw and its column
    choice (from ZkProver.param and zk/fused.py's static tables)."""

    def __init__(self, name, F, tag, circ, meta, block_enc=None):
        from longfellow_zk_tpu_torch.zk.fused import fused_static
        from longfellow_zk_tpu_torch.zk.prover import ZkProver
        self.name, self.F, self.tag, self.circ, self.meta = (
            name, F, tag, circ, meta)
        kw = {} if block_enc is None else dict(block_enc=block_enc)
        zp = ZkProver(circ, F, None, rate=meta["rate"], nreq=meta["nreq"],
                      device="cpu", **kw)
        p = zp.param
        st = fused_static(circ, p, zp.lqc, zp.n_witness)
        self.writes = [p.block, p.dblock, p.r, p.dblock - p.block]
        self.draw = p.nwqrow + st.nl_constraints + 3 * p.nq + p.nqtriples
        self.choose = (p.block_enc - p.dblock, p.nreq)


def load_proofs():
    """The proofs' shapes: {name: Proof}; the mdoc circuits too."""
    from longfellow_zk_tpu_torch.circuits.mdoc import api as mdoc_api
    from longfellow_zk_tpu_torch.circuits.mdoc.zk_spec import (
        find_zk_spec_by_version)
    from longfellow_zk_tpu_torch.fields.fp_instances import (
        fp128, p256_base, p256k1_base)
    from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
    from longfellow_zk_tpu_torch.proto.lfc1 import (
        FP128_ID, P256_ID, SECP_ID, read_circuit)

    def meta(name):
        return json.load(open(os.path.join(TD, name + ".proof.json")))

    def circuit(F, fid, path):
        return read_circuit(F, fid, gzip.open(os.path.join(HERE, path),
                                              "rb").read())

    out = {}
    F, FB, FK, GF = fp128(), p256_base(), p256k1_base(), gf2_128()
    m = meta("sha256_1block_fp128")
    out["sha"] = Proof("sha", F, "fp128", circuit(
        F, FP128_ID, "artifacts/sha256_1block_fp128.lfc1.gz"), m)
    m = meta("ecdsa_p256")
    out["ecdsa"] = Proof("ecdsa", FB, "fp256", circuit(
        FB, P256_ID, "artifacts/ecdsa_p256.lfc1.gz"), m)
    m = meta("bitaddr_p256k1")
    out["bitaddr"] = Proof("bitaddr", FK, "fp256k1",
                           circuit(FK, SECP_ID, m["circuit"]), m)
    m = meta("mdoc_v7_1attr")
    spec = find_zk_spec_by_version(m["version"], len(m["attributes"]))
    cbytes = open(os.path.join(HERE, "artifacts", "mdoc_v7_1attr.zst"),
                  "rb").read()
    c_sig, c_hash = mdoc_api.load_circuits(cbytes)
    rate, nreq = mdoc_api._rate_nreq(spec.version)
    mm = dict(m, rate=rate, nreq=nreq)
    out["mdoc hash"] = Proof("mdoc hash", GF, "gf2_128", c_hash, mm,
                             spec.block_enc_hash)
    out["mdoc sig"] = Proof("mdoc sig", FB, "fp256", c_sig, mm,
                            spec.block_enc_sig)
    return out


def rand_state(dfs, Transcript, rng, dev):
    """A random host transcript and its state on the card."""
    ts = Transcript(rng.bytes(5))
    ts.write_bytes(rng.bytes(int(rng.integers(0, 200))))
    return ts, dfs.fs_init_from_host(ts, dev)


def host_of(dfs, Transcript, fs):
    ts = Transcript(b"")
    dfs.fs_state_to_host(ts, fs.cpu())
    return ts


def fs_off(fs):
    return int.from_bytes(bytes(fs[32:40].cpu().tolist()), "little") % 64


def k9_rows(cs, torch, dev, proofs, clock):
    """K9 at each proof's shapes, held to the host Transcript."""
    import numpy as np
    from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript

    rng = np.random.default_rng(17)
    rows = {}

    def put(key, err, fn, steps, iters=20):
        t = cs.device_ms(fn, iters)
        chain = cs.chain_ms(steps, clock)
        rows[key] = dict(err=err, ms=t.ms, ms_by=t.by, chain_ms=chain,
                         chain_steps=steps)
        print("  K9 %-40s err %d  %.5f ms  chain %.5f ms (%.2fx)"
              % (key, err, t.ms, chain, t.ms / chain), file=sys.stderr,
              flush=True)

    done = set()
    for pr in proofs.values():
        F, tag = pr.F, pr.tag
        K = F.kBytes
        prod = 0 if F.kCharacteristicTwo else cs.PROD_CHAIN[tag]
        elts = cs.elts_of(F, rng, dev)
        # the four response writes, one array each
        for i, n in enumerate(pr.writes):
            ts, fs = rand_state(dfs, Transcript, rng, dev)
            xs = elts(n)
            vals = list(F.from_limbs(xs.cpu()))
            off = fs_off(fs)
            dfs.fs_write_elts(F, fs, xs)
            ts.write_elts(vals, F)
            err = int(bytes(fs.cpu().tolist()) != ts.export_state())
            nblk = (off + 9 + n * K) // 64
            put("%s write %d: %d elements" % (pr.name, i, n), err,
                lambda fs=fs, xs=xs: dfs.fs_write_elts(F, fs, xs),
                nblk * cs.SHA_CHAIN)
        # the Ligero draw: a squeeze and the samples
        ts, fs = rand_state(dfs, Transcript, rng, dev)
        prf = dfs.new_prf(dev)
        m = pr.draw
        got = dfs.dev_sample_elts(F, prf, m, fs=fs)
        want = ts.elts(m, F)
        err = int(list(F.from_limbs(got.cpu())) != want) + int(
            bytes(dfs.prf_bytes(F, prf, 5).cpu().tolist()) != ts.bytes(5))
        steps = (1 + (fs_off(fs) >= 56)) * cs.SHA_CHAIN + \
            cs.AES_KEY_CHAIN + cs.AES_BLOCK_CHAIN + prod
        put("%s draw: %d samples" % (pr.name, m), err,
            lambda fs=fs, prf=prf, m=m: dfs.dev_sample_elts(F, prf, m,
                                                            fs=fs), steps)
        # the column choice
        n, k = pr.choose
        ts, fs = rand_state(dfs, Transcript, rng, dev)
        prf = dfs.new_prf(dev)
        got = dfs.dev_choose(F, fs, prf, n, k)
        err = int(got.cpu().tolist() != ts.choose(n, k)) + int(
            bytes(dfs.prf_bytes(F, prf, 5).cpu().tolist()) != ts.bytes(5))
        put("%s choose %d of %d" % (pr.name, k, n), err,
            lambda fs=fs, prf=prf: dfs.dev_choose(F, fs, prf, n, k),
            (1 + (fs_off(fs) >= 56)) * cs.SHA_CHAIN + cs.AES_KEY_CHAIN +
            cs.AES_BLOCK_CHAIN + 8 * k)
        if tag in done:
            continue
        done.add(tag)
        # the small steps: a layer's alpha and beta, begin_circuit, a wc
        # write
        for m in (2, 80):
            ts, fs = rand_state(dfs, Transcript, rng, dev)
            prf = dfs.new_prf(dev)
            got = dfs.dev_sample_elts(F, prf, m, fs=fs)
            err = int(list(F.from_limbs(got.cpu())) != ts.elts(m, F))
            steps = (1 + (fs_off(fs) >= 56)) * cs.SHA_CHAIN + \
                cs.AES_KEY_CHAIN + cs.AES_BLOCK_CHAIN + prod
            put("[%s] a squeeze, %d samples" % (tag, m), err,
                lambda fs=fs, prf=prf, m=m: dfs.dev_sample_elts(
                    F, prf, m, fs=fs), steps, iters=50)
        ts, fs = rand_state(dfs, Transcript, rng, dev)
        xs = elts(2)
        off = fs_off(fs)
        dfs.fs_write_elts(F, fs, xs)
        ts.write_elts(list(F.from_limbs(xs.cpu())), F)
        err = int(bytes(fs.cpu().tolist()) != ts.export_state())
        put("[%s] write 2 elements" % tag, err,
            lambda fs=fs, xs=xs: dfs.fs_write_elts(F, fs, xs),
            max(1, (off + 9 + 2 * K) // 64) * cs.SHA_CHAIN + prod,
            iters=50)
    return rows


def k1_rows(cs, torch, dev, proofs, fields=None, n=1 << 20):
    """K1 at its 2-12-word instances (`fields`: some of their tags; all by
    default): every mode at n = 2^20, and at fp128, fp256 and fp256k1
    bind, hv and bind_hv at the mdoc signature circuit's largest
    layer."""
    import numpy as np
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.sumcheck.prover import quad_tensors

    rng = np.random.default_rng(18)
    rows = {}

    def put(key, err, fn, nbytes, ops):
        warm = cs.device_ms(fn, 20)
        cold = cs.device_ms(fn, 20, cold=True)
        b = cs.bound_ms(nbytes, ops)
        rows[key] = dict(err=err, ms=warm.ms, ms_by=warm.by,
                         cold_ms=cold.ms, bound_ms=b[0], bound_by=b[1])
        print("  K1 %-36s err %d  warm %.5f  cold %.5f  bound %.5f (%s)"
              % (key, err, warm.ms, cold.ms, b[0], b[1]), file=sys.stderr,
              flush=True)

    from longfellow_zk_tpu_torch.fields.fp_instances import (
        fp64, p256_scalar, p256k1_scalar, p384_base)

    sig = proofs["mdoc sig"]
    # the signature circuit's largest layer, its term indices h0 (made in
    # its own field: quad_tensors keeps them with the circuit's layer)
    ly = max(range(sig.circ.nl), key=lambda i: sig.circ.layers[i].nterms)
    layer = sig.circ.layers[ly]
    hh = quad_tensors(sig.F, layer.quad, dev)["h0"]
    T, nw = layer.nterms, 1 << layer.logw
    for tag, F in (("fp128", proofs["sha"].F), ("fp256", sig.F),
                   ("fp256k1", proofs["bitaddr"].F), ("fp64", fp64()),
                   ("p256n", p256_scalar()), ("p256k1n", p256k1_scalar()),
                   ("p384", p384_base())):
        if fields and tag not in fields:
            continue
        pm = fpm.plain_of(F)
        eb, mops = 4 * F.nlimb, cs.MUL_OPS[tag]
        elts = cs.elts_of(F, rng, dev)
        a, b = elts(n), elts(n)
        cond = torch.as_tensor(rng.integers(0, 2, n).astype(bool),
                               device=dev)
        r = elts(3)
        h = torch.as_tensor(rng.integers(0, 1 << 20, n, dtype=np.int32),
                            device=dev)
        for mode in (fpm.MUL, fpm.ADD, fpm.SUB, fpm.SQR, fpm.NEG, fpm.EQ,
                     fpm.IS_ZERO, fpm.SELECT):
            y = a if mode in fpm.UNARY else b
            c = cond if mode == fpm.SELECT else None
            err = cs.max_err(fpm.fp_elementwise(F, mode, a, y, c),
                             pm.elementwise_plain(F, mode, a, y, c))
            # inputs read once (select: the operand it chooses and the
            # conditions), the output written once (a byte for eq, is_zero)
            nb = {fpm.SQR: 2, fpm.NEG: 2, fpm.IS_ZERO: 2,
                  fpm.SELECT: 2}.get(mode, 3) * eb * n
            if mode in fpm.BOOL_OUT:
                nb = nb - eb * n + n
            if mode == fpm.SELECT:
                nb += n
            ops = mops * n if mode in (fpm.MUL, fpm.SQR) else 0
            put("[%s] 2^%d %s" % (tag, n.bit_length() - 1, K1_MODES[mode]),
                err,
                lambda m=mode, y=y, c=c: fpm.fp_elementwise(F, m, a, y, c),
                nb, ops)
        W = a.reshape(1, n, F.nlimb)
        err = cs.max_err(F.bind(W, r[0]),
                         pm.elementwise_plain(F, fpm.BIND, W, r[0]))
        put("[%s] 2^%d bind" % (tag, n.bit_length() - 1), err,
            lambda: F.bind(W, r[0]),
            eb * (n + n // 2), mops * n // 2)
        err = cs.max_err(F.hv_update(a, h, r[0]),
                         pm.elementwise_plain(F, fpm.HV, a, r[0], h))
        put("[%s] 2^%d hv" % (tag, n.bit_length() - 1), err,
            lambda: F.hv_update(a, h, r[0]),
            2 * eb * n + 4 * n, mops * n)
        if tag not in K1_TAGS:
            continue
        # the round sizes of the mdoc signature circuit's largest layer
        # (for every instance: the widths K1 runs at on a proof)
        for lanes in (1, 3):
            hv = elts(lanes * T).reshape(lanes, T, F.nlimb)
            Wl = elts(lanes * nw).reshape(lanes, nw, F.nlimb)
            rl = r[:lanes] if lanes > 1 else r[0]
            sfx = "" if lanes == 1 else " %d lanes" % lanes
            err = cs.max_err(F.bind(Wl, rl),
                             pm.elementwise_plain(F, fpm.BIND, Wl, rl))
            put("[%s] bind %d%s" % (tag, nw, sfx), err,
                lambda Wl=Wl, rl=rl: F.bind(Wl, rl),
                lanes * eb * (nw + nw // 2), lanes * mops * nw // 2)
            err = cs.max_err(F.hv_update(hv, hh, rl),
                             pm.elementwise_plain(F, fpm.HV, hv, rl, hh))
            put("[%s] hv %d%s" % (tag, T, sfx), err,
                lambda hv=hv, rl=rl: F.hv_update(hv, hh, rl),
                lanes * 2 * eb * T + 4 * T, lanes * mops * T)
            if hasattr(F, "bind_hv"):
                w2, h2 = F.bind_hv(Wl, hv, hh, rl)
                err = max(cs.max_err(w2, F.bind(Wl, rl)),
                          cs.max_err(h2, F.hv_update(hv, hh, rl)))
                put("[%s] bind_hv %d + %d%s" % (tag, nw, T, sfx), err,
                    lambda Wl=Wl, hv=hv, rl=rl: F.bind_hv(Wl, hv, hh, rl),
                    lanes * (eb * (nw + nw // 2) + 2 * eb * T) + 4 * T,
                    lanes * mops * (nw // 2 + T))
    return rows


def proof_runs(cs, torch, dev, proofs):
    """[(name, prove, golden)]: chip_smoke.py's four prover paths."""
    from longfellow_zk_tpu_torch.circuits.bitaddr.bitaddr import (
        BitaddrWitness)
    from longfellow_zk_tpu_torch.circuits.ecdsa.verify import compute_witness
    from longfellow_zk_tpu_torch.circuits.mdoc import api as mdoc_api
    from longfellow_zk_tpu_torch.circuits.mdoc.witness import (
        RequestedAttribute)
    from longfellow_zk_tpu_torch.circuits.mdoc.zk_spec import (
        find_zk_spec_by_version)
    from longfellow_zk_tpu_torch.circuits.ripemd.reference import ripemd160
    from longfellow_zk_tpu_torch.circuits.sha.sha256 import (
        SHA256_INIT, pack_block_witness, sha256_pad, transform_block_witness)
    from longfellow_zk_tpu_torch.ec.curves import (
        ecdsa_sign, p256_curve, p256k1_curve)
    from longfellow_zk_tpu_torch.fields import fp2 as fp2m
    from longfellow_zk_tpu_torch.fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER, P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X,
        P256_FP2_ROOT_Y)
    from longfellow_zk_tpu_torch.random_oracle.engine import (
        DeterministicEngine)
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
    from longfellow_zk_tpu_torch.zk.proof import ZkProof
    from longfellow_zk_tpu_torch.zk.prover import ZkProver
    from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof
    from longfellow_zk_tpu_torch.zk.testing import rs_factory_for

    def golden(name):
        return open(os.path.join(TD, name + ".proof.bin"), "rb").read()

    def zk(pr, rs, W):
        meta = pr.meta

        def prove():
            zkp = ZkProof(rate=meta["rate"], nreq=meta["nreq"])
            prover = ZkProver(pr.circ, pr.F, rs, rate=meta["rate"],
                              nreq=meta["nreq"], device=dev)
            ts = Transcript(meta["transcript_label"].encode(),
                            version=meta["version"])
            prover.commit(zkp, W, ts, DeterministicEngine())
            assert prover.prove(zkp, W, ts)
            return write_zk_proof(zkp, pr.circ, prover.param, pr.F)
        return prove

    out = []
    sha = proofs["sha"]
    F = sha.F
    padded = sha256_pad(sha.meta["message"].encode())
    W = [F.of_scalar(1)] + [F.of_scalar((byte >> i) & 1)
                            for byte in padded for i in range(8)]
    W.extend(pack_block_witness(
        F, 4, [transform_block_witness(SHA256_INIT, padded)]))
    out.append(("sha", zk(sha, rs_factory_for(
        F, P128_OMEGA, P128_OMEGA_ORDER, device=dev), W),
        golden("sha256_1block_fp128")))

    ecd = proofs["ecdsa"]
    FB = ecd.F
    ec = p256_curve()
    er = random.Random(ecd.meta["seed"])
    d = er.randrange(1, ec.order)
    pk = ec.normalize(ec.scalar_mult(ec.generator(), d))
    e = er.randrange(1, ec.order)
    r, s = ecdsa_sign(ec, d, e, er.randrange(1, ec.order))
    EW = [FB.of_scalar(1), pk.x, pk.y, e % FB.p]
    EW.extend(compute_witness(ec, pk.x, pk.y, e, r, s).fill())
    F2 = fp2m.Fp2(FB)
    ers = rs_factory_for(FB, F2=F2, omega2=(P256_FP2_ROOT_X,
                                            P256_FP2_ROOT_Y),
                         omega_order=P256_FP2_ROOT_ORDER, device=dev)
    out.append(("ecdsa", zk(ecd, ers, EW), golden("ecdsa_p256")))

    mm = proofs["mdoc sig"].meta
    spec = find_zk_spec_by_version(mm["version"], len(mm["attributes"]))
    cbytes = open(os.path.join(HERE, "artifacts", "mdoc_v7_1attr.zst"),
                  "rb").read()
    ex = json.load(open(os.path.join(HERE, mm["examples"])))[mm["example"]]
    attrs = [RequestedAttribute(id=a["id"].encode(),
                                cbor_value=bytes.fromhex(a["cbor_value"]))
             for a in mm["attributes"]]

    def mdoc():
        return mdoc_api.run_mdoc_prover(
            cbytes, bytes.fromhex(ex["mdoc"]), int(ex["pkx"], 16),
            int(ex["pky"], 16), bytes.fromhex(ex["transcript"]), attrs,
            ex["now"].encode(), spec,
            rng=DeterministicEngine(mm["engine_seed"].encode()),
            device=dev, phases=[])
    out.append(("mdoc", mdoc, golden("mdoc_v7_1attr")))

    bit = proofs["bitaddr"]
    FK = bit.F
    eck = p256k1_curve()
    sk = random.Random(bit.meta["seed"]).randrange(1, eck.order)
    bw = BitaddrWitness(eck, FK)
    bw.compute_witness(sk)
    pk = eck.normalize(eck.scalar_mult(eck.generator(), sk))
    compressed = bytes([2 + (pk.y & 1)]) + pk.x.to_bytes(32, "big")
    addr = int.from_bytes(ripemd160(hashlib.sha256(compressed).digest()),
                          "big")
    BW = [FK.of_scalar(1), addr % FK.p] + bw.fill()
    out.append(("bitaddr", zk(bit, rs_factory_for(FK, device=dev), BW),
                golden("bitaddr_p256k1")))
    return out


def _bucket(n):
    return "2^%d" % max(0, (int(n) - 1).bit_length())


def proof_rows(cs, torch, kernels, dev, proofs):
    """Each proof: golden bytes, then one profiled with the K9 and K1
    launches split by mode and size."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    res = {}
    for name, prove, golden in proof_runs(cs, torch, dev, proofs):
        same = prove() == golden
        prove()
        torch.cuda.synchronize()
        calls = []
        launch = kernels.launch

        def logged(kname, nl, *args):
            # K1: mode, out, a, b, h, n, ...; K9: mode, fs, prf, in, out,
            # n, lanes, ...; mode 9: fs, prf, out, k, n, lanes
            kind, tag = kname.split("[")
            tag = tag[:-1]
            if kind == "fp_elementwise" and tag in K1_TAGS:
                calls.append(("K1[%s]" % tag, K1_MODES[args[0]], args[5],
                              nl))
            elif kind == "fs_oracle":
                calls.append(("K9[%s]" % tag, K9_MODES[args[0]], args[5],
                              nl))
            elif kind == "fs_choose":
                calls.append(("K9[%s]" % tag, "choose", args[4], nl))
            return launch(kname, nl, *args)

        kernels.launch = logged
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(cs.HEAD_PAD):
                    torch.cuda._sleep(1)
                t = time.perf_counter()
                prove()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
        finally:
            kernels.launch = launch
        classes = {}
        for tag in K1_TAGS:
            classes["K1[%s]" % tag] = [k1_rec(tag)]
        for tag in K9_TAGS:
            classes["K9[%s]" % tag] = [k9_rec(tag), k9c_rec(tag)]
        by, recs = {}, {k: [] for k in classes}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda or "spin_kernel" in e.name():
                continue
            ms = (e.end_ns() - e.start_ns()) / 1e6
            v = by.setdefault(e.name(), [0.0, 0])
            v[0] += ms
            v[1] += 1
            for k, rxs in classes.items():
                if any(rx.search(e.name()) for rx in rxs):
                    recs[k].append((e.start_ns(), ms))
        busy = sum(v[0] for v in by.values())
        split = {}
        for k in classes:
            mine = [c for c in calls if c[0] == k]
            if not mine:
                continue
            recs[k].sort()
            nrec = sum(c[3] for c in mine)
            s = split[k] = dict(calls=len(mine), launches=nrec,
                                records=len(recs[k]),
                                ms=sum(m for _, m in recs[k]))
            if nrec != len(recs[k]):
                s["note"] = "records and launches differ: not split"
                continue
            it = iter(recs[k])
            modes = s["by_mode"] = {}
            for _, mode, n, nl in mine:
                ms = sum(next(it)[1] for _ in range(nl))
                m = modes.setdefault(mode, dict(ms=0.0, launches=0,
                                                by_size={}))
                m["ms"] += ms
                m["launches"] += nl
                z = m["by_size"].setdefault(_bucket(n), [0.0, 0])
                z[0] += ms
                z[1] += nl
        print("  %s proof: golden bytes %s, %.1f ms wall, %.3f ms device "
              "busy" % (name, same, wall, busy), file=sys.stderr, flush=True)
        for k, s in split.items():
            print("    %s %.3f ms, %d launches (%d records)" % (
                k, s["ms"], s["launches"], s["records"]), file=sys.stderr)
            for mode, m in sorted(s.get("by_mode", {}).items(),
                                  key=lambda kv: -kv[1]["ms"]):
                print("      %-14s %8.3f ms %5d launches  %s" % (
                    mode, m["ms"], m["launches"], " ".join(
                        "%s:%.3f/%d" % (z, v[0], v[1])
                        for z, v in sorted(m["by_size"].items(),
                                           key=lambda kv: int(kv[0][2:])))),
                    file=sys.stderr)
        for kn, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:12]:
            print("    %9.3f ms %6d  %s" % (ms, n, kn[:90]), file=sys.stderr,
                  flush=True)
        res[name] = dict(golden=same, wall_ms=wall, busy_ms=busy,
                         split=split, kernels=by)
    return res


def child(root, only, clock, k1_fields):
    sys.path.insert(0, root)
    import torch
    from longfellow_zk_tpu_torch import kernels
    if os.path.dirname(os.path.abspath(kernels.__file__)) != os.path.join(
            os.path.abspath(root), "longfellow_zk_tpu_torch"):
        raise RuntimeError("imported the port from %s" % kernels.__file__)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    ptx, build_s = build(kernels, "proof" in only)
    for k, v in ptx.items():
        print("  ptxas %s: %s" % (k[:100], v), file=sys.stderr)
    sass = sass_counts(kernels)
    for k, v in (sass.items() if isinstance(sass, dict) else []):
        print("  sass %-50s %6d instructions" % (k[:50], v),
              file=sys.stderr)
    res = dict(root=root, build_s=build_s, ptxas=ptx,
               sass_instructions=sass)
    dev = torch.device("cuda")
    proofs = load_proofs()
    res["shapes"] = {k: dict(writes=p.writes, draw=p.draw,
                             choose=p.choose) for k, p in proofs.items()}
    if "k9" in only:
        res["k9"] = k9_rows(cs, torch, dev, proofs, clock)
    if "k1" in only:
        res["k1"] = k1_rows(cs, torch, dev, proofs, k1_fields)
    if "proof" in only:
        res["proofs"] = proof_rows(cs, torch, kernels, dev, proofs)
    print(json.dumps(res))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="*", default=[HERE])
    ap.add_argument("--out", help="default: k9k1_bench.json in the port's "
                    "build directory")
    ap.add_argument("--only", nargs="*", default=["k9", "k1", "proof"])
    ap.add_argument("--k1-fields", nargs="*", help="K1's instances "
                    "(default: fp128 fp256 fp256k1 fp64 p256n p256k1n "
                    "p384)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--clock", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.only, args.clock, args.k1_fields)
    if args.out is None:
        sys.path.insert(0, HERE)
        from longfellow_zk_tpu_torch.native import build_dir
        args.out = os.path.join(build_dir(), "k9k1_bench.json")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip().splitlines()[0])
    print("card:", smi, "| top SM clock %.0f MHz" % clock, flush=True)
    results, failed = [], False
    for root in args.roots:
        root = os.path.abspath(root)
        print("== %s" % root, flush=True)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", root, "--clock", str(clock),
                            "--only"] + args.only +
                           (["--k1-fields"] + args.k1_fields
                            if args.k1_fields else []),
                           stdout=subprocess.PIPE, text=True)
        if r.returncode:
            print("FAIL: the child for %s exited %d" % (root, r.returncode))
            failed = True
            continue
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["card"] = smi
        results.append(res)
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, clock_mhz=clock, results=results), f,
                      indent=1)
    bad = [(res["root"], part, k) for res in results
           for part in ("k9", "k1") for k, row in res.get(part, {}).items()
           if row["err"]]
    bad += [(res["root"], k) for res in results
            for k, v in res.get("proofs", {}).items() if not v["golden"]]
    if bad:
        print("FAIL: not exact:", bad)
    print("wrote", args.out)
    return 1 if failed or bad else 0


if __name__ == "__main__":
    sys.exit(main())
