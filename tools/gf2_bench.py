#!/usr/bin/env python3
"""K1 fp_elementwise and K3 fp_wire_round at GF(2^128) on the card, tree
against tree, the mdoc proof's K1 and K3 time split by mode and size, and
candidate GF(2^128) products apart.

    python3 tools/gf2_bench.py [--roots DIR ...] [--only k1 k3 diag proof]
                               [--out FILE]

Each root (a checkout of this repository; default: this one) runs in a
child process of its own, in the order given, so `--roots old . . old`
times two trees in turns on one card.  A child

  - builds the root's csrc/fp_ops.cu and csrc/wire_round.cu with
    `nvcc -Xptxas -v` (registers, stack and spills of every GF(2^128)
    kernel), then the root's other kernels;
  - diag: builds tools/gf2_diag.cu (this repository's) against the
    root's csrc/ and times each candidate product (the tree's
    fp_mul<G128>, the shift-and-XOR, spaced-multiply Karatsuba, with a's
    class words made once, a 4-bit window table a thread, a block's
    table of a fixed multiplier by bytes and by nibbles, and the two
    tables' builds): cycles a product in one thread (a chain of
    dependent products) and ps a product over a full grid (CUDA events),
    the products of every candidate held equal;
  - k1: K1 [gf2_128] against its plain version on the card, device ms
    warm and with the L2 flushed (chip_smoke.py's device_ms), in every
    mode at 2^20 elements (torch.clone beside neg, torch.bitwise_xor
    beside add), mul at the Ligero tableau (266 x 3,230), hv and bind at
    the mdoc hash circuit's largest layer and at smaller sizes, hv and
    bind with 2 lanes;
  - k3: K3 [gf2_128] against its plain version on the mdoc hash
    circuit's layers 17, 18 and 20 (hv, Wh and Wo random), and with 2
    lanes at layer 20;
  - proof: the mdoc proof (circuits/mdoc/api.run_mdoc_prover), its golden
    bytes checked, then one profiled, each K1 and K3 [gf2_128] launch of
    it matched, in order, to the call that made it (the wrappers' calls
    logged through kernels.launch): K1's device ms by mode (mul split by
    b full, one element or broadcast) and by size (powers of 2), K3's by
    terms, and every kernel's device ms and launches.

Device times are chip_smoke.py's device_ms.  Prints one JSON line a child
and writes all of them, with the card's name and power limit, to --out
(default gf2_bench.json in the port's ignored build directory).  Needs a
card and nvcc.
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
N_ELTS = 1 << 20
MDOC_LAYERS = (17, 18, 20)
DIAG_PARTS = ("tree", "shift", "kara", "kara_pre", "window4", "table8",
              "table4", "build8", "build4")
MODES = ("mul", "add", "sub", "bind", "hv", "sqr", "neg", "eq", "is_zero",
         "select")
# the kernels of K1 and K3 [gf2_128] in a profiler record's name
K1_REC = re.compile(r"k_fp_elementwise<G128>|k_g128_[a-z0-9_]+")
K3_REC = re.compile(r"k_wire_partial<G128>|k_sum_partial<G128>|"
                    r"k_finish<G128>|k_wire_g128")


def ptxas_lines(log):
    """{mangled kernel: "registers ...; stack ..."} of the GF(2^128)
    kernels in nvcc -Xptxas -v output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(_Z\w+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur and ("G128" in cur or "g128" in cur):
            if "stack frame" in line or "Used" in line:
                out.setdefault(cur, []).append(line.split(":", 1)[-1]
                                               .strip())
    return {k: "; ".join(v) for k, v in out.items()}


def demangle(names):
    try:
        r = subprocess.run(["c++filt"], input="\n".join(names),
                           capture_output=True, text=True)
        return dict(zip(names, r.stdout.splitlines()))
    except OSError:
        return {n: n for n in names}


def build(kernels):
    """fp_ops.cu and wire_round.cu with -Xptxas -v, then every other
    stale kernel; returns the GF(2^128) kernels' ptxas lines and the
    seconds taken."""
    t0 = time.perf_counter()
    procs = []
    for src in ("fp_ops.cu", "wire_round.cu"):
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
    kernels.build_all()
    ptx = ptxas_lines(log)
    dm = demangle(list(ptx))
    return {dm.get(k, k): v for k, v in ptx.items()}, \
        time.perf_counter() - t0


def sass_counts(kernels, libs):
    """{kernel: SASS instructions} of the GF(2^128) kernels in the
    libraries `libs` (cuobjdump -sass), or why there are none."""
    exe = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    out = {}
    for lib in libs:
        r = subprocess.run([exe, "-sass", lib], capture_output=True,
                           text=True)
        if r.returncode:
            return "cuobjdump exited %d" % r.returncode
        cur = None
        for line in r.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = m.group(1) if ("G128" in m.group(1) or "g128" in
                                     m.group(1)) else None
                if cur:
                    out[cur] = 0
            elif cur and re.search(r"/\*[0-9a-f]{4,}\*/", line):
                out[cur] += 1
    dm = demangle(list(out))
    return {dm.get(k, k).split("(")[0]: v for k, v in out.items()}


def diag_rows(torch, kernels, root, clock_mhz):
    """tools/gf2_diag.cu's candidates against the root's csrc/."""
    src = os.path.join(HERE, "tools", "gf2_diag.cu")
    lib = os.path.join(kernels.build_dir(), "libgf2_diag.so")
    r = subprocess.run([kernels.nvcc_path()] + kernels.NVCC_FLAGS +
                       ["-Xptxas", "-v", "-I",
                        os.path.join(root, "longfellow_zk_tpu_torch",
                                     "csrc"), "-o", lib, src],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed for gf2_diag.cu:\n" + r.stdout +
                           r.stderr)
    dl = ctypes.CDLL(lib)
    P = ctypes.c_void_p
    dl.diag_g128_lat.argtypes = [ctypes.c_int, ctypes.c_int, P, P, P]
    dl.diag_g128_grid.argtypes = [ctypes.c_int, ctypes.c_int, P, P,
                                  ctypes.c_int, P]
    dev = "cuda"
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(16)

    def rand(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                             device=dev, generator=g)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    io = rand(4, 4)
    cyc = torch.zeros(1, dtype=torch.int64, device=dev)
    rows, chain = {}, {}
    iters = 64
    for part, name in enumerate(DIAG_PARTS):
        io2 = io.clone()
        runs = []
        for _ in range(3):
            assert dl.diag_g128_lat(part, iters, io2.data_ptr(),
                                    cyc.data_ptr(), stream()) == 0
            torch.cuda.synchronize()
            runs.append(int(cyc[0]))
        per = min(runs) / (1 if part >= 7 else iters)
        chain[name] = io2[2].clone()
        rows[name] = dict(cycles=per, ns=per / clock_mhz * 1e3)
    blocks = 2 * nsm
    n = blocks * 256
    gin = rand(n, 4)
    gout = torch.empty_like(gin)
    giters = 16
    outs = {}
    for part, name in enumerate(DIAG_PARTS[:7]):
        def fn(part=part):
            assert dl.diag_g128_grid(part, giters, gin.data_ptr(),
                                     gout.data_ptr(), blocks, stream()) == 0
            return gout
        outs[name] = fn().clone()
        ms, _ = _event_ms(torch, fn, 5)
        rows[name]["grid_ps"] = ms * 1e9 / (n * giters)
        rows[name]["grid_ms"] = ms
    # the products of every candidate (x <- x y, the same chain) agree
    ref = outs["shift"]
    ok = {k: bool(torch.equal(v, ref)) for k, v in outs.items()
          if k != "kara_pre"}
    ok.update({k: bool(torch.equal(chain[k], chain["shift"]))
               for k in ("tree", "kara", "window4", "table8", "table4")})
    for k, v in rows.items():
        print("  diag %-9s %8.1f cycles (%.1f ns) a product in one thread"
              "%s" % (k, v["cycles"], v["ns"],
                      "; %.2f ps a product over %d blocks" % (
                          v["grid_ps"], blocks) if "grid_ps" in v else ""),
              file=sys.stderr, flush=True)
    print("  diag agree with the shift-and-XOR: %s" % ok, file=sys.stderr)
    ptx = ptxas_lines(r.stdout + r.stderr)
    dm = demangle(list(ptx))
    sass = sass_counts(kernels, [lib])
    for k, v in (sass.items() if isinstance(sass, dict) else []):
        print("  diag sass %-40s %6d instructions" % (k, v),
              file=sys.stderr)
    return dict(rows=rows, agree=ok, blocks=blocks, grid_iters=giters,
                ptxas={dm.get(k, k): v for k, v in ptx.items()},
                sass_instructions=sass)


def _event_ms(torch, fn, reps):
    fn()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        ms.append(t0.elapsed_time(t1))
    ms.sort()
    return ms[len(ms) // 2], ms


def _row(cs, torch, fn, pfn, nbytes, library=None, iters=20):
    out = fn()
    err = cs.max_err(out, pfn())
    warm = cs.device_ms(fn, iters)
    cold = cs.device_ms(fn, iters, cold=True)
    row = dict(err=err, ms=warm.ms, ms_by=warm.by, cold_ms=cold.ms,
               bytes_bound_ms=cs.bound_ms(nbytes, 0)[0])
    if library is not None:
        row["library_ms"] = cs.device_ms(library, iters).ms
        row["library_cold_ms"] = cs.device_ms(library, iters,
                                              cold=True).ms
    return row


def mdoc_hash(dev):
    from longfellow_zk_tpu_torch.circuits.mdoc import api as mdoc_api
    _, c_hash = mdoc_api.load_circuits(open(os.path.join(
        HERE, "artifacts", "mdoc_v7_1attr.zst"), "rb").read())
    return c_hash


def k1_rows(cs, torch, dev):
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
    from longfellow_zk_tpu_torch.sumcheck.prover import quad_tensors

    F = gf2_128()
    pm = fpm.plain_of(F)
    rng = __import__("numpy").random.default_rng(16)
    api = cs.FieldApi(cs.Rows(), dev, rng, N_ELTS)
    elts = api.fast_elts(F)
    a, b, cond = api.operands(elts)
    r1 = elts(1)[0]
    code = {"mul": fpm.MUL, "add": fpm.ADD, "sub": fpm.SUB, "sqr": fpm.SQR,
            "neg": fpm.NEG, "eq": fpm.EQ, "is_zero": fpm.IS_ZERO,
            "select": fpm.SELECT}
    rows = {}

    def put(key, row):
        rows[key] = row
        print("  K1 %-34s err %d  warm %.5f  cold %.5f  bytes bound %.5f%s"
              % (key, row["err"], row["ms"], row["cold_ms"],
                 row["bytes_bound_ms"],
                 "  library %.5f / cold %.5f" % (row["library_ms"],
                                                 row["library_cold_ms"])
                 if "library_ms" in row else ""),
              file=sys.stderr, flush=True)

    for name, mode in code.items():
        y = a if mode in fpm.UNARY else b
        lib = {"neg": lambda: torch.clone(a),
               "add": lambda: torch.bitwise_xor(a, b)}.get(name)
        put("2^20 " + name, _row(
            cs, torch, lambda m=mode, y=y: fpm.fp_elementwise(F, m, a, y,
                                                              cond),
            lambda m=mode, y=y: pm.elementwise_plain(F, m, a, y, cond),
            api.mode_bytes(mode, 16), lib))
    put("2^20 mul_const", _row(
        cs, torch, lambda: fpm.fp_elementwise(F, fpm.MUL, a, r1),
        lambda: pm.elementwise_plain(F, fpm.MUL, a, r1), 32 * N_ELTS))
    tab = elts(266 * 3230).reshape(266, 3230, 4)
    put("mul 266 x 3230", _row(
        cs, torch, lambda: F.mul(tab, tab),
        lambda: pm.elementwise_plain(F, fpm.MUL, tab, tab),
        48 * 266 * 3230))
    col = elts(266).reshape(266, 1, 4)
    put("mul 266 x 3230 by a column", _row(
        cs, torch, lambda: F.mul(tab, col),
        lambda: pm.elementwise_plain(F, fpm.MUL, tab, col),
        32 * 266 * 3230))
    c_hash = mdoc_hash(dev)
    ly = max(range(c_hash.nl), key=lambda i: c_hash.layers[i].nterms)
    layer = c_hash.layers[ly]
    qd = quad_tensors(F, layer.quad, dev)
    T, nw = layer.nterms, 1 << layer.logw
    h0 = qd["h0"]
    hv, W = elts(T), elts(nw).reshape(1, nw, 4)
    r = elts(2)
    put("hv T=%d" % T, _row(
        cs, torch, lambda: F.hv_update(hv, h0, r1),
        lambda: pm.elementwise_plain(F, fpm.HV, hv, r1, h0), 36 * T))
    put("bind %d" % nw, _row(
        cs, torch, lambda: F.bind(W, r[:1]),
        lambda: pm.elementwise_plain(F, fpm.BIND, W, r[:1]), 24 * nw))
    for n in (1 << 8, 1 << 11, 1 << 14, 1 << 16, 1 << 17, 1 << 18):
        x, hh = elts(n), h0[:n].contiguous()
        put("hv T=%d" % n, _row(
            cs, torch, lambda x=x, hh=hh: F.hv_update(x, hh, r1),
            lambda x=x, hh=hh: pm.elementwise_plain(F, fpm.HV, x, r1, hh),
            36 * n))
        x = elts(n).reshape(1, n, 4)
        put("bind %d" % n, _row(
            cs, torch, lambda x=x: F.bind(x, r[:1]),
            lambda x=x: pm.elementwise_plain(F, fpm.BIND, x, r[:1]),
            24 * n))
    # two lanes, each its own challenge (a strided view, as the prover
    # passes them)
    r2 = elts(6).reshape(2, 3, 4)[:, 1]
    T2 = 1 << 16
    hv2, W2, hh = elts(2 * T2).reshape(2, T2, 4), elts(2 * 4096).reshape(
        2, 4096, 4), h0[:T2].contiguous()
    put("hv 2 lanes T=%d" % T2, _row(
        cs, torch, lambda: F.hv_update(hv2, hh, r2),
        lambda: pm.elementwise_plain(F, fpm.HV, hv2, r2, hh), 72 * T2))
    put("bind 2 lanes 4096", _row(
        cs, torch, lambda: F.bind(W2, r2),
        lambda: pm.elementwise_plain(F, fpm.BIND, W2, r2), 48 * 4096))
    return rows


def k3_rows(cs, torch, dev):
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
    from longfellow_zk_tpu_torch.sumcheck.prover import quad_tensors

    F = gf2_128()
    pm = fpm.plain_of(F)
    rng = __import__("numpy").random.default_rng(17)
    elts = cs.elts_of(F, rng, dev)
    c_hash = mdoc_hash(dev)
    rows = {}
    for ly in MDOC_LAYERS:
        layer = c_hash.layers[ly]
        qd = quad_tensors(F, layer.quad, dev)
        T, N = layer.nterms, 1 << layer.logw
        h0, h1 = qd["h0"], qd["h1"]
        hv, Wh, Wo = elts(T), elts(N), elts(N)
        n_even = int((h0 & 1).eq(0).sum())
        row = _row(cs, torch,
                   lambda: fpm.fp_wire_sums(F, hv, Wh, Wo, h0, h1),
                   lambda: pm.wire_sums_plain(F, hv, Wh, Wo, h0, h1),
                   T * 24 + 32 * N + 32)
        row.update(T=T, n_even=n_even,
                   bound_ms=cs.bound_ms(T * 24 + 32 * N + 32,
                                        144 * (2 * T + n_even))[0])
        key = "layer %d" % ly
        rows[key] = row
        if ly == MDOC_LAYERS[-1]:
            hv2, Wh2, Wo2 = (elts(2 * m).reshape(2, m, 4)
                             for m in (T, N, N))
            lane = _row(cs, torch,
                        lambda: fpm.fp_wire_sums(F, hv2, Wh2, Wo2, h0, h1),
                        lambda: pm.wire_sums_plain(F, hv2, Wh2, Wo2, h0,
                                                   h1),
                        2 * (T * 24 + 32 * N + 32))
            rows[key + " 2 lanes"] = lane
        for k in [key] + ([key + " 2 lanes"] if ly == MDOC_LAYERS[-1]
                          else []):
            print("  K3 %-18s T %d  err %d  warm %.5f  cold %.5f" % (
                k, T, rows[k]["err"], rows[k]["ms"], rows[k]["cold_ms"]),
                file=sys.stderr, flush=True)
    return rows


def _bucket(n):
    return "2^%d" % max(0, (int(n) - 1).bit_length())


def mdoc_proof(cs, torch, kernels, dev):
    """The mdoc proof: golden bytes, then one profiled with the K1 and K3
    [gf2_128] launches split."""
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
    calls = []
    launch = kernels.launch

    def logged(name, nl, *args):
        # K1: mode, out, a, b, h, n, row, bdiv, bmod; K3: mode, out,
        # scratch, hv, Wh, Wo, h, ho, T, A, R, B, nblk
        if name == "fp_elementwise[gf2_128]":
            mode, n, bdiv, bmod = args[0], args[5], args[7], args[8]
            kind = ""
            if mode == 0:
                kind = (" b full" if bdiv == 1 and bmod >= n else
                        " b one" if bmod == 1 else " b broadcast")
            calls.append(("K1", MODES[mode] + kind, n, nl))
        elif name == "fp_wire_round[gf2_128]":
            calls.append(("K3", "wire" if args[0] == 0 else "sum",
                          args[8] if args[0] == 0 else args[9] * args[10],
                          nl))
        return launch(name, nl, *args)

    cuda = torch.autograd.DeviceType.CUDA
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
    by, recs = {}, {"K1": [], "K3": []}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or "spin_kernel" in e.name():
            continue
        ms = (e.end_ns() - e.start_ns()) / 1e6
        v = by.setdefault(e.name(), [0.0, 0])
        v[0] += ms
        v[1] += 1
        for k, rx in (("K1", K1_REC), ("K3", K3_REC)):
            if rx.search(e.name()):
                recs[k].append((e.start_ns(), ms))
    busy = sum(v[0] for v in by.values())
    split = {}
    for k in ("K1", "K3"):
        mine = [c for c in calls if c[0] == k]
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
    print("  mdoc proof: golden bytes %s, %.1f ms wall, %.3f ms device busy"
          % (same, wall, busy), file=sys.stderr, flush=True)
    for k, s in split.items():
        print("    %s [gf2_128] %.3f ms, %d launches (%d records)" % (
            k, s["ms"], s["launches"], s["records"]), file=sys.stderr)
        for mode, m in sorted(s.get("by_mode", {}).items(),
                              key=lambda kv: -kv[1]["ms"]):
            print("      %-14s %8.3f ms %5d launches  %s" % (
                mode, m["ms"], m["launches"], " ".join(
                    "%s:%.3f/%d" % (z, v[0], v[1])
                    for z, v in sorted(m["by_size"].items(),
                                       key=lambda kv: int(kv[0][2:])))),
                file=sys.stderr)
    for name, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:14]:
        print("    %9.3f ms %6d  %s" % (ms, n, name[:90]), file=sys.stderr,
              flush=True)
    return dict(golden=same, wall_ms=wall, busy_ms=busy, split=split,
                kernels=by)


def child(root, only, clock_mhz):
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
    ptx, build_s = build(kernels)
    for k, v in ptx.items():
        print("  ptxas %s: %s" % (k[:100], v), file=sys.stderr)
    sass = sass_counts(kernels, [kernels._lib_path(src) for src in
                                 ("fp_ops.cu", "wire_round.cu")])
    for k, v in (sass.items() if isinstance(sass, dict) else []):
        print("  sass %-50s %6d instructions" % (k[:50], v),
              file=sys.stderr)
    res = dict(root=root, build_s=build_s, ptxas=ptx,
               sass_instructions=sass)
    dev = torch.device("cuda")
    if "diag" in only:
        res["diag"] = diag_rows(torch, kernels, root, clock_mhz)
    if "k1" in only:
        res["k1"] = k1_rows(cs, torch, dev)
    if "k3" in only:
        res["k3"] = k3_rows(cs, torch, dev)
    if "proof" in only:
        res["mdoc"] = mdoc_proof(cs, torch, kernels, dev)
    print(json.dumps(res))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="*", default=[HERE])
    ap.add_argument("--out", help="default: gf2_bench.json in the port's "
                    "build directory")
    ap.add_argument("--only", nargs="*",
                    default=["diag", "k1", "k3", "proof"])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--clock", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.only, args.clock)
    if args.out is None:
        sys.path.insert(0, HERE)
        from longfellow_zk_tpu_torch.native import build_dir
        args.out = os.path.join(build_dir(), "gf2_bench.json")
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
                            "--only"] + args.only,
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
           for part in ("k1", "k3") for k, row in res.get(part, {}).items()
           if row["err"]]
    bad += [(res["root"], "mdoc") for res in results
            if "mdoc" in res and not res["mdoc"]["golden"]]
    bad += [(res["root"], "diag", k) for res in results
            for k, v in res.get("diag", {}).get("agree", {}).items()
            if not v]
    if bad:
        print("FAIL: not exact:", bad)
    print("wrote", args.out)
    return 1 if failed or bad else 0


if __name__ == "__main__":
    sys.exit(main())
