#!/usr/bin/env python3
"""K2 fp_segment_sum, K9 fs_oracle and K10 sumcheck_round_tail on the
card, tree against tree, and the parts of one K10 round apart.

    python3 tools/k2k10_bench.py [--roots DIR ...] [--no-proof]
                                 [--only k2 k9 k10 diag] [--out FILE]

Each root (a checkout of this repository; default: this one) runs in a
child process of its own, in the order given, so `--roots old . . old`
times two trees in turns on one card.  A child

  - builds the root's csrc/segsum.cu, csrc/fs.cu and csrc/round_tail.cu
    with `nvcc -Xptxas -v` (registers, stack frame and spills of every
    K2, K9 and K10 kernel);
  - builds tools/k10_diag.cu (this repository's) against the root's
    csrc/ and times the parts of one K10 round in one thread at each
    instance: cycles an iteration of the two tagged absorbs, fs_getkey,
    the AES-256 key schedule and one block, a squeeze and a sample, the
    field algebra and one product;
  - holds K2 [gf2_128] to its plain version and times it on the mdoc
    hash circuit (artifacts/mdoc_v7_1attr.zst): mode 1 (the layer
    evaluation) at layers 17, 18 and 20, mode 0 at the term-merge plan's
    stages of the same layers (sumcheck/prover.py _wire_merge_plan); and
    K2 at its other instances as chip_smoke.py's rows time it (mode 1 at
    the SHA-256, ECDSA and bitaddr circuits' largest layers, mode 0 at
    2^20 terms in 2^14 segments);
  - holds K10 at fp128, fp256, fp256k1 and gf2_128, both modes, 1 and 8
    lanes, and K9's modes (absorb, write, tagged write, bytes, squeeze
    and samples, choose) to their plain versions and times a launch;
  - unless --no-proof, makes the mdoc proof (circuits/mdoc/api.
    run_mdoc_prover, its golden bytes checked) and profiles one: the
    device ms and the launches of every kernel of the proof.

Device times are chip_smoke.py's device_ms (the profiler's sum over 50
calls, after a head of sleep kernels).  Prints one JSON line a child and
writes all of them, with the card's name and power limit, to --out
(default k2k10_bench.json in the port's ignored build directory).
Needs a card and nvcc.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAGS = ("fp128", "fp256", "fp256k1", "gf2_128")
K2_LAYERS = (17, 18, 20)
DIAG_PARTS = ("two tagged absorbs", "getkey", "AES key schedule + 1 block",
              "squeeze + sample", "field algebra", "one product",
              "whole hand-round", "whole copy round")
DIAG_ITERS = 64


def ptxas_lines(log, keep):
    """{mangled kernel: "registers ...; stack ..."} of the kernels whose
    names contain one of `keep`, from nvcc -Xptxas -v output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(_Z\w+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur and any(k in cur for k in keep):
            if "stack frame" in line or "Used" in line:
                out.setdefault(cur, []).append(line.split(":", 1)[-1]
                                               .strip())
    return {k: "; ".join(v) for k, v in out.items()}


def build(kernels, srcs):
    """Builds the root's csrc sources with -Xptxas -v, one nvcc each, in
    parallel; returns their ptxas lines and the seconds taken."""
    t0 = time.perf_counter()
    procs = []
    for src in srcs:
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
    return ptxas_lines(log, ("segment_sum", "k_seg", "round_tail",
                             "fs_oracle", "fs_choose")), \
        time.perf_counter() - t0


def sass_counts(kernels, srcs):
    """{kernel: SASS instructions} of the root's built libraries
    (cuobjdump -sass), or why there are none."""
    exe = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    out = {}
    for src in srcs:
        r = subprocess.run([exe, "-sass", kernels._lib_path(src)],
                           capture_output=True, text=True)
        if r.returncode:
            return "cuobjdump exited %d" % r.returncode
        cur = None
        for line in r.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = m.group(1)
                out[cur] = 0
            elif cur and re.search(r"/\*[0-9a-f]{4,}\*/", line):
                out[cur] += 1
    return out


def demangle(names):
    try:
        r = subprocess.run(["c++filt"], input="\n".join(names),
                           capture_output=True, text=True)
        return dict(zip(names, r.stdout.splitlines()))
    except OSError:
        return {n: n for n in names}


def fields():
    from longfellow_zk_tpu_torch.fields.fp_instances import (
        fp128, p256_base, p256k1_base)
    from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
    return {"fp128": fp128, "fp256": p256_base, "fp256k1": p256k1_base,
            "gf2_128": gf2_128}


def diag_rows(torch, kernels, root, clock_mhz):
    """tools/k10_diag.cu against the root's csrc/: cycles an iteration of
    each part at each instance."""
    src = os.path.join(HERE, "tools", "k10_diag.cu")
    lib = os.path.join(kernels.build_dir(), "libk10_diag.so")
    # the word-wise oracle (struct FsW) or the byte-wise one before it
    with open(os.path.join(kernels.CSRC, "fs.cuh")) as f:
        words = "struct FsW" in f.read()
    r = subprocess.run([kernels.nvcc_path()] + kernels.NVCC_FLAGS +
                       ["-Xptxas", "-v", "-I", kernels.CSRC, "-o", lib] +
                       (["-DFS_WORDS"] if words else []) + [src],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed for k10_diag.cu:\n" + r.stdout +
                           r.stderr)
    ptx = ptxas_lines(r.stdout + r.stderr, ("k_diag_k10",))
    dl = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    rows = {}
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    for tag in TAGS:
        fn = getattr(dl, "diag_k10_" + tag)
        fn.argtypes = [I, I, P, P, P]
        for part, what in enumerate(DIAG_PARTS):
            if part >= 6 and not words:
                continue
            # parts 6-7 also once (one pass through the kernel's code, as
            # a launch makes it)
            for iters in (DIAG_ITERS, 1) if part >= 6 else (DIAG_ITERS,):
                cs = []
                for _ in range(3):   # the first call loads the module
                    io = torch.randint(0, 2**31 - 1, (4096,),
                                       dtype=torch.int32, device="cuda")
                    assert fn(part, iters, io.data_ptr(), cyc.data_ptr(),
                              torch.cuda.current_stream().cuda_stream) == 0
                    torch.cuda.synchronize()
                    cs.append(int(cyc.item()) / iters)
                best = min(cs)
                k = "%s %s%s" % (tag, what, "" if iters > 1 else " once")
                rows[k] = dict(cycles=best, us=best / clock_mhz,
                               first_cycles=cs[0])
                print("  diag %-8s %-33s %9.1f cycles  %.4f us (first "
                      "call %.1f)" % (tag, what + ("" if iters > 1 else
                                                   " once"),
                                      best, best / clock_mhz, cs[0]),
                      file=sys.stderr, flush=True)
    return rows, {demangle([k])[k]: v for k, v in ptx.items()}


def k2_rows(cs, torch, dev):
    """K2 [gf2_128] on the mdoc hash circuit: mode 1 at K2_LAYERS, mode 0
    at their merge plans' stages."""
    from longfellow_zk_tpu_torch.circuits.mdoc import api as mdoc_api
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
    from longfellow_zk_tpu_torch.sumcheck.prover import (
        SumcheckProver, quad_tensors)

    import numpy as np
    rng = np.random.default_rng(15)
    GF = gf2_128()
    pm = fpm.plain_of(GF)
    _, c_hash = mdoc_api.load_circuits(open(os.path.join(
        HERE, "artifacts", "mdoc_v7_1attr.zst"), "rb").read())
    sp = SumcheckProver(GF, dev)
    elts = cs.elts_of(GF, rng, dev)
    rows = {}
    for ly in K2_LAYERS:
        layer = c_hash.layers[ly]
        nv = c_hash.layers[ly - 1].nw if ly > 0 else c_hash.nv
        qd = quad_tensors(GF, layer.quad, dev)
        starts, ends = sp._segments(layer.quad, nv)
        W = elts(layer.nw)
        args = (W, qd["h0"], qd["h1"], qd["v"], qd["bmask"], starts, ends)
        V, ok = fpm.fp_eval_layer(GF, *args)
        V2, ok2 = pm.eval_layer_plain(GF, *args)
        err = cs.max_err(V, V2) + int(bool(ok) != bool(ok2))
        t = cs.device_ms(lambda: fpm.fp_eval_layer(GF, *args), 20)
        seg = (ends - starts).long()
        rows["mode 1 layer %d" % ly] = dict(
            err=err, ms=t.ms, ms_by=t.by, terms=layer.nterms, nseg=nv,
            max_seg=int(seg.max()), v_one=int(
                (qd["v"] == GF.to_limbs(1, dev)).all(-1).sum()))
        plan = sp._wm_for(layer.quad, layer.logw)
        n_in = layer.nterms
        for si, (nr, s, e, _, _) in enumerate(plan["stages"] if plan
                                               else []):
            x = elts(n_in)
            # the longest fold, as the prover passes it (a tree without
            # it takes three arguments)
            most = (plan["longest"][si],) if "longest" in plan else ()
            err = cs.max_err(GF.lazy_segment_sum(x, s, e, *most),
                             pm.segment_sum_plain(GF, x, s, e))
            t = cs.device_ms(lambda: GF.lazy_segment_sum(x, s, e, *most),
                             20)
            rows["mode 0 layer %d stage %d" % (ly, si)] = dict(
                err=err, ms=t.ms, ms_by=t.by, terms=n_in, nseg=len(s),
                max_seg=int((e - s).max()))
            n_in = len(s)
    for k, r in rows.items():
        print("  K2 %-24s err %d  %.5f ms  (%d terms, %d segments, "
              "longest %d)" % (k, r["err"], r["ms"], r["terms"], r["nseg"],
                               r["max_seg"]), file=sys.stderr, flush=True)
    return rows


# the proofs' circuits (K2 mode 1 at the largest layer, as chip_smoke.py's
# rows): tag -> (artifact, field, circuit id)
K2_CIRCUITS = {"fp128": ("sha256_1block_fp128.lfc1.gz", "fp128", "FP128_ID"),
               "fp256": ("ecdsa_p256.lfc1.gz", "p256_base", "P256_ID"),
               "fp256k1": ("bitaddr_p256k1.lfc1.gz", "p256k1_base",
                           "SECP_ID")}
# K2's instances with a mode-0 row in chip_smoke.py (2^20 terms in 2^14
# segments)
K2_API = ("fp24", "fp64", "p256n", "p256k1n", "p384", "p521")


def k2_prime_rows(cs, torch, dev):
    """K2 at its other instances, as chip_smoke.py times them: mode 1 at
    the SHA-256, ECDSA and bitaddr circuits' largest layers, mode 0 at
    2^20 terms in 2^14 segments (the field API)."""
    import gzip
    import numpy as np
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.fields import fp24 as f24m
    from longfellow_zk_tpu_torch.fields import fp_instances as fi
    from longfellow_zk_tpu_torch.proto import lfc1
    from longfellow_zk_tpu_torch.sumcheck.prover import (
        SumcheckProver, quad_tensors)

    rng = np.random.default_rng(16)
    rows = {}
    for tag, (art, fname, cid) in K2_CIRCUITS.items():
        F = getattr(fi, fname)()
        circ = lfc1.read_circuit(F, getattr(lfc1, cid), gzip.open(
            os.path.join(HERE, "artifacts", art), "rb").read())
        ly = max(range(circ.nl), key=lambda i: circ.layers[i].nterms)
        layer = circ.layers[ly]
        nv = circ.layers[ly - 1].nw if ly > 0 else circ.nv
        qd = quad_tensors(F, layer.quad, dev)
        starts, ends = SumcheckProver(F, dev)._segments(layer.quad, nv)
        args = (cs.elts_of(F, rng, dev)(layer.nw), qd["h0"], qd["h1"],
                qd["v"], qd["bmask"], starts, ends)
        V, ok = fpm.fp_eval_layer(F, *args)
        V2, ok2 = fpm.plain_of(F).eval_layer_plain(F, *args)
        t = cs.device_ms(lambda: fpm.fp_eval_layer(F, *args), 50)
        rows["K2[%s] eval layer %d" % (tag, ly)] = dict(
            err=cs.max_err(V, V2) + int(bool(ok) != bool(ok2)), ms=t.ms,
            ms_by=t.by, terms=layer.nterms, nseg=nv)
    api = cs.FieldApi(cs.Rows(), dev, rng, 1 << 20)
    mk = {"fp24": f24m.fp24, "fp64": fi.fp64, "p256n": fi.p256_scalar,
          "p256k1n": fi.p256k1_scalar, "p384": fi.p384_base,
          "p521": fi.p521_base}
    nseg = 1 << 14
    g = np.sort(rng.integers(0, nseg, 1 << 20))
    starts = torch.as_tensor(np.searchsorted(g, np.arange(nseg), "left")
                             .astype(np.int32), device=dev)
    ends = torch.as_tensor(np.searchsorted(g, np.arange(nseg), "right")
                           .astype(np.int32), device=dev)
    for tag in K2_API:
        F = mk[tag]()
        x = api.fast_elts(F)(1 << 20)
        err = cs.max_err(F.lazy_segment_sum(x, starts, ends),
                         fpm.segment_sum_plain(F, x, starts, ends))
        t = cs.device_ms(lambda: F.lazy_segment_sum(x, starts, ends), 20)
        rows["K2[%s] 2^20 terms, 2^14 segments" % tag] = dict(
            err=err, ms=t.ms, ms_by=t.by, terms=1 << 20, nseg=nseg)
    for k, r in rows.items():
        print("  %-40s err %d  %.5f ms" % (k, r["err"], r["ms"]),
              file=sys.stderr, flush=True)
    return rows


def fs_states(dfs, Transcript, rng, dev, lanes, reject=None):
    """`lanes` random host transcript states on the card [lanes, 104] and
    a copy; lane 0 from Transcript(reject) where given."""
    import torch
    out = []
    for b in range(lanes):
        ts = Transcript(reject if b == 0 and reject else rng.bytes(5))
        if not (b == 0 and reject):
            ts.write_bytes(rng.bytes(int(rng.integers(0, 200))))
        out.append(dfs.fs_init_from_host(ts, dev))
    fs = torch.stack(out)
    return fs, fs.clone()


def k9_k10_rows(cs, torch, dev):
    """K10 (both modes, 1 and 8 lanes) and K9's modes at every instance:
    exact against the plain versions, device ms a launch."""
    import numpy as np
    from longfellow_zk_tpu_torch.fields.fp import round_consts
    from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript

    rng = np.random.default_rng(10)
    rows = {}
    for tag, mk in fields().items():
        F = mk()
        N = F.nlimb
        elts = cs.elts_of(F, rng, dev)
        consts = round_consts(F, dev)
        for cubic in (False, True):
            npts = 4 if cubic else 3
            tail = dfs.round_tail_cubic if cubic else dfs.round_tail
            plain = (dfs.round_tail_cubic_plain if cubic
                     else dfs.round_tail_plain)
            for B in (1, 8):
                fs, fs2 = fs_states(dfs, Transcript, rng, dev, B)
                x = elts(B * (2 * npts + 1)).reshape(B, 2 * npts + 1, N)
                # copies: at one lane x[:, 0] is contiguous, and a view
                # of it would alias eq0
                claim = x[:, 0].clone()
                claim2 = claim.clone()
                a = x[:, 1:npts].contiguous()
                pad = x[:, npts + 1:].contiguous()
                row = torch.zeros((B, npts + 1, N), dtype=torch.int32,
                                  device=dev)
                row2 = row.clone()
                eq0 = x[0, 0].contiguous()
                args = (a,) if cubic else (a, eq0)
                if B == 1:
                    def fn(fs=fs, claim=claim, row=row, args=args, pad=pad):
                        tail(F, fs[0], claim[0], row[0],
                             *((args[0][0],) + args[1:]), pad[0], consts)
                else:
                    def fn(fs=fs, claim=claim, row=row, args=args, pad=pad):
                        tail(F, fs, claim, row, *args, pad, consts)
                fn()
                for b in range(B):
                    plain(F, fs2[b], claim2[b], row2[b],
                          *((args[0][b],) + args[1:]), pad[b], consts)
                err = max(cs.max_err(fs, fs2), cs.max_err(claim, claim2),
                          cs.max_err(row, row2))
                t = cs.device_ms(fn, 50)
                k = "K10%s[%s] lanes=%d" % (" cubic" if cubic else "", tag,
                                            B)
                rows[k] = dict(err=err, ms=t.ms, ms_by=t.by)
        # K9: its modes from random states
        fs, fs2 = fs_states(dfs, Transcript, rng, dev, 1)
        fs, fs2 = fs[0], fs2[0]
        prf, prf2 = dfs.new_prf(dev), dfs.new_prf(dev)
        data = torch.as_tensor(rng.integers(0, 256, 130, dtype=np.uint8),
                               device=dev)
        xs = elts(9)
        modes = {
            "absorb 130 bytes": (lambda: dfs.fs_absorb(F, fs, data),
                                 lambda: dfs.fs_absorb_plain(F, fs2, data)),
            "write 9 elements": (
                lambda: dfs.fs_write_elts(F, fs, xs),
                lambda: dfs.fs_write_elts_plain(F, fs2, xs)),
            "write 9 tagged": (
                lambda: dfs.write_tagged_elts(F, fs, xs),
                lambda: dfs.write_tagged_elts_plain(F, fs2, xs)),
            "squeeze + 2 samples": (
                lambda: dfs.dev_sample_elts(F, prf, 2, fs=fs),
                lambda: (dfs.fs_squeeze_plain(F, fs2, prf2),
                         dfs.dev_sample_elts_plain(F, prf2, 2))[1]),
            "33 bytes": (lambda: dfs.prf_bytes(F, prf, 33),
                         lambda: dfs.prf_bytes_plain(F, prf2, 33)),
            "choose 128 of 1367": (
                lambda: dfs.dev_choose(F, fs, prf, 1367, 128),
                lambda: dfs.dev_choose_plain(F, fs2, prf2, 1367, 128)),
        }
        for what, (kfn, pfn) in modes.items():
            err = 0
            for _ in range(2):
                out, out2 = kfn(), pfn()
                if out is not None:
                    err = max(err, cs.max_err(out, out2))
                err = max(err, cs.max_err(fs, fs2), cs.max_err(prf, prf2))
            t = cs.device_ms(kfn, 50)
            rows["K9[%s] %s" % (tag, what)] = dict(err=err, ms=t.ms,
                                                   ms_by=t.by)
            # the timed calls moved the states on: the plain ones follow
            fs2.copy_(fs)
            prf2.copy_(prf)
    for k, r in rows.items():
        print("  %-28s err %d  %.5f ms" % (k, r["err"], r["ms"]),
              file=sys.stderr, flush=True)
    return rows


def mdoc_proof(cs, torch, dev):
    """The mdoc proof: its bytes against the golden, then one profiled:
    {kernel name: [device ms, launches]}, busy ms and wall ms."""
    from torch.profiler import ProfilerActivity, profile
    from longfellow_zk_tpu_torch.circuits.mdoc import api as mdoc_api
    from longfellow_zk_tpu_torch.circuits.mdoc.witness import (
        RequestedAttribute)
    from longfellow_zk_tpu_torch.circuits.mdoc.zk_spec import (
        find_zk_spec_by_version)
    from longfellow_zk_tpu_torch.random_oracle.engine import (
        DeterministicEngine)

    td = os.path.join(HERE, "longfellow_zk_tpu_torch", "testdata")
    meta = json.load(open(os.path.join(td, "mdoc_v7_1attr.proof.json")))
    golden = open(os.path.join(td, "mdoc_v7_1attr.proof.bin"), "rb").read()
    spec = find_zk_spec_by_version(meta["version"], len(meta["attributes"]))
    cbytes = open(os.path.join(HERE, "artifacts", "mdoc_v7_1attr.zst"),
                  "rb").read()
    ex = json.load(open(os.path.join(HERE, meta["examples"])))[
        meta["example"]]
    attrs = [RequestedAttribute(id=a["id"].encode(),
                                cbor_value=bytes.fromhex(a["cbor_value"]))
             for a in meta["attributes"]]

    def prove():
        return mdoc_api.run_mdoc_prover(
            cbytes, bytes.fromhex(ex["mdoc"]), int(ex["pkx"], 16),
            int(ex["pky"], 16), bytes.fromhex(ex["transcript"]), attrs,
            ex["now"].encode(), spec,
            rng=DeterministicEngine(meta["engine_seed"].encode()),
            device=dev, phases=[])

    same = prove() == golden
    prove()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(cs.HEAD_PAD):
            torch.cuda._sleep(1)
        t = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or "spin_kernel" in e.name():
            continue
        ms = (e.end_ns() - e.start_ns()) / 1e6
        v = by.setdefault(e.name(), [0.0, 0])
        v[0] += ms
        v[1] += 1
    busy = sum(v[0] for v in by.values())
    print("  mdoc proof: golden bytes %s, %.1f ms wall, %.3f ms device busy"
          % (same, wall, busy), file=sys.stderr, flush=True)
    for k, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:16]:
        print("    %9.3f ms %6d  %s" % (ms, n, k[:90]), file=sys.stderr,
              flush=True)
    return dict(golden=same, wall_ms=wall, busy_ms=busy, kernels=by)


def child(root, only, proof, clock_mhz):
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
    ptx, build_s = build(kernels, ("segsum.cu", "fs.cu", "round_tail.cu"))
    kernels.build_all()
    dm = demangle(list(ptx))
    res = dict(root=root, build_s=build_s,
               ptxas={dm.get(k, k): v for k, v in ptx.items()})
    for k, v in res["ptxas"].items():
        print("  ptxas %s: %s" % (k, v), file=sys.stderr)
    sass = sass_counts(kernels, ("segsum.cu", "fs.cu", "round_tail.cu"))
    if isinstance(sass, dict):
        dm = demangle(list(sass))
        sass = {dm.get(k, k).split("(")[0]: v for k, v in sass.items()}
        for k, v in sass.items():
            print("  sass %-40s %7d instructions" % (k, v),
                  file=sys.stderr)
    res["sass_instructions"] = sass
    dev = torch.device("cuda")
    if "diag" in only:
        res["diag"], res["diag_ptxas"] = diag_rows(torch, kernels, root,
                                                   clock_mhz)
    if "k2" in only:
        res["k2"] = k2_rows(cs, torch, dev)
        res["k2"].update(k2_prime_rows(cs, torch, dev))
    if "k10" in only or "k9" in only:
        res["k9_k10"] = k9_k10_rows(cs, torch, dev)
    if proof:
        res["mdoc"] = mdoc_proof(cs, torch, dev)
    print(json.dumps(res))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="*", default=[HERE])
    ap.add_argument("--out", help="default: k2k10_bench.json in the "
                    "port's build directory")
    ap.add_argument("--only", nargs="*", default=["diag", "k2", "k9", "k10"])
    ap.add_argument("--no-proof", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--clock", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.only, not args.no_proof, args.clock)
    if args.out is None:
        sys.path.insert(0, HERE)
        from longfellow_zk_tpu_torch.native import build_dir
        args.out = os.path.join(build_dir(), "k2k10_bench.json")
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
                           (["--no-proof"] if args.no_proof else []),
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
    bad = [k for res in results for part in ("k2", "k9_k10")
           for k, row in res.get(part, {}).items() if row["err"]]
    bad += [res["root"] for res in results
            if "mdoc" in res and not res["mdoc"]["golden"]]
    if bad:
        print("FAIL: not exact:", bad)
    print("wrote", args.out)
    return 1 if failed or bad else 0


if __name__ == "__main__":
    sys.exit(main())
