#!/usr/bin/env python3
"""K1 fp_elementwise on the card, tree against tree (by default at
P-521 and the ML-DSA prime), and the costs of the old layouts apart.

    python3 tools/k1_bench.py [--roots DIR ...] [--fields p521 fp24]
                              [--no-diag] [--out FILE]

Each root (a checkout of this repository; default: this one) runs in a
child process of its own, in the order given, so `--roots old . . old`
times two trees in turns on one card.  A child builds the root's
`csrc/fp_ops.cu` alone with `nvcc -Xptxas -v` (the registers, stack and
spills of each [p521] and [fp24] kernel), then, at 2^20 random canonical
elements, holds K1 at each instance of --fields (tags: fp128, fp256,
fp256k1, gf2_128, fp24, fp64, p256n, p256k1n, p384, p521) in every mode
of the field API (mul, add, sub, sqr, neg, eq, is_zero, select,
mul_const) to its plain version on the card and times it: device ms
back to back and with the L2 flushed before each call (chip_smoke.py's
device_ms), call ms by CUDA events twice, the host's ms to enqueue a
call, the caching allocator's cudaMalloc and retry counts over the call
loop, and where one PyTorch call computes the same function (eq,
is_zero, select; GF(2^128)'s add and neg) that call, timed the same two
ways.  The first child of this repository's own root also
times tools/k1_diag.cu's microkernels (17-word copies with word or tile
loads and stores; the ML-DSA add with and without the 64-bit index
division) and then, in a process of its own, asks the profiler for
CUPTI's sector counts of one [p521] add.

Prints one JSON line a child and writes all of them to --out (default
k1_bench.json in the port's ignored build directory, beside the CUPTI
trace).  Needs a card and nvcc.
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
MODES = ("mul", "add", "sub", "sqr", "neg", "eq", "is_zero", "select",
         "mul_const")
# CUPTI metrics of the stores and loads of one kernel
METRICS = ["l1tex__t_requests_pipe_lsu_mem_global_op_st.sum",
           "l1tex__t_sectors_pipe_lsu_mem_global_op_st.sum",
           "l1tex__t_requests_pipe_lsu_mem_global_op_ld.sum",
           "l1tex__t_sectors_pipe_lsu_mem_global_op_ld.sum",
           "dram__bytes_read.sum", "dram__bytes_write.sum"]


def ptxas_lines(log):
    """{kernel: "N registers, S bytes stack, spills"} of the [p521] and
    [fp24] kernels in nvcc -Xptxas -v output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(_Z\w+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur and ("P521" in cur or "FP24" in cur):
            if "stack frame" in line or "Used" in line:
                out.setdefault(cur, []).append(line.split(":", 1)[-1]
                                               .strip())
    return {k: "; ".join(v) for k, v in out.items()}


def build_fp_ops(kernels):
    """Builds csrc/fp_ops.cu alone (with -Xptxas -v) into the root's
    build directory; returns the ptxas lines."""
    src = os.path.join(kernels.CSRC, "fp_ops.cu")
    lib = kernels._lib_path("fp_ops.cu")
    tmp = lib + ".%d.tmp" % os.getpid()
    cmd = [kernels.nvcc_path()] + kernels.NVCC_FLAGS + \
        ["-Xptxas", "-v", "-o", tmp, src]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("nvcc failed:\n" + r.stdout + r.stderr)
    os.replace(tmp, lib)
    return ptxas_lines(r.stdout + r.stderr), time.perf_counter() - t0


def demangle(names):
    try:
        r = subprocess.run(["c++filt"], input="\n".join(names),
                           capture_output=True, text=True)
        return dict(zip(names, r.stdout.splitlines()))
    except OSError:
        return {n: n for n in names}


def alloc_counts(torch):
    s = torch.cuda.memory_stats()
    return (s.get("num_device_alloc", 0), s.get("num_alloc_retries", 0))


def k1_fields():
    """K1's instances: tag -> field."""
    from longfellow_zk_tpu_torch.fields import fp24 as f24m
    from longfellow_zk_tpu_torch.fields import fp_instances as fi
    from longfellow_zk_tpu_torch.fields.gf2 import gf2_128

    return {"fp128": fi.fp128, "fp256": fi.p256_base,
            "fp256k1": fi.p256k1_base, "gf2_128": gf2_128,
            "fp24": f24m.fp24, "fp64": fi.fp64, "p256n": fi.p256_scalar,
            "p256k1n": fi.p256k1_scalar, "p384": fi.p384_base,
            "p521": fi.p521_base}


def time_rows(cs, torch, fields):
    """The K1 rows of one root at the instances `fields` (tags of
    k1_fields()): {"p521 add": {...}, ...}."""
    from longfellow_zk_tpu_torch.fields import fp as fpm

    rng = __import__("numpy").random.default_rng(14)
    dev = torch.device("cuda")
    rows = {}
    code = {"mul": fpm.MUL, "add": fpm.ADD, "sub": fpm.SUB, "sqr": fpm.SQR,
            "neg": fpm.NEG, "eq": fpm.EQ, "is_zero": fpm.IS_ZERO,
            "select": fpm.SELECT}
    for tag in fields:
        F = k1_fields()[tag]()
        gf = F.kCharacteristicTwo
        api = cs.FieldApi(cs.Rows(), dev, rng, N_ELTS)
        a, b, cond = api.operands(api.fast_elts(F))
        eb = 4 * F.nlimb
        pm = fpm.plain_of(F)
        c = 0xC0FFEE << 100 if gf else (0xC0FFEE << 100) % F.p
        cl = F.to_limbs(c, dev)
        for name in MODES:
            if name == "mul_const":
                def fn():
                    return F.mul_const(a, c)

                def pfn():
                    return pm.elementwise_plain(F, fpm.MUL, a, cl)
                nbytes, mode = 2 * eb * N_ELTS, fpm.MUL
            else:
                mode = code[name]
                y = a if mode in fpm.UNARY else b

                def fn(m=mode, y=y):
                    return fpm.fp_elementwise(F, m, a, y, cond)

                def pfn(m=mode, y=y):
                    return pm.elementwise_plain(F, m, a, y, cond)
                nbytes = api.mode_bytes(mode, eb)
            ops = cs.MUL_OPS[tag] * N_ELTS if mode in (fpm.MUL, fpm.SQR) \
                else 0
            out = fn()
            err = cs.max_err(out, pfn())
            warm = cs.device_ms(fn, 20)
            cold = cs.device_ms(fn, 20, cold=True)
            calls = [cs.call_ms(fn, 80).ms for _ in range(2)]
            torch.cuda.synchronize()
            n0 = alloc_counts(torch)
            t0 = time.perf_counter()
            for _ in range(80):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3 / 80
            torch.cuda.synchronize()
            n1 = alloc_counts(torch)
            lib = {"eq": lambda: torch.all(a == b, -1),
                   "is_zero": lambda: torch.all(a == 0, -1),
                   "select": lambda: torch.where(cond[:, None], a, b)}
            if gf:
                lib.update(add=lambda: torch.bitwise_xor(a, b),
                           neg=lambda: torch.clone(a))
            lib = lib.get(name)
            row = dict(err=err, ms=warm.ms, ms_by=warm.by, cold_ms=cold.ms,
                       cold_by=cold.by, call_ms=calls, host_enqueue_ms=host_ms,
                       device_allocs=n1[0] - n0[0],
                       alloc_retries=n1[1] - n0[1],
                       bound_ms=cs.bound_ms(nbytes, ops)[0])
            if lib is not None:
                row["library_ms"] = cs.device_ms(lib, 20).ms
                row["library_cold_ms"] = cs.device_ms(lib, 20, cold=True).ms
            rows["%s %s" % (tag, name)] = row
            print("  %s %-9s err %d  warm %.5f  cold %.5f  call %s  "
                  "enqueue %.4f  bound %.5f%s" % (
                      tag, name, err, warm.ms, cold.ms,
                      " / ".join("%.4f" % v for v in calls), host_ms,
                      row["bound_ms"],
                      "  library %.5f / cold %.5f" % (
                          row["library_ms"], row["library_cold_ms"])
                      if lib else ""), file=sys.stderr, flush=True)
    return rows


def diag_rows(cs, torch, kernels):
    """tools/k1_diag.cu's microkernels at 2^20 elements, device ms warm
    and cold."""
    src = os.path.join(HERE, "tools", "k1_diag.cu")
    lib = os.path.join(kernels.build_dir(), "libk1_diag.so")
    subprocess.run([kernels.nvcc_path()] + kernels.NVCC_FLAGS +
                   ["-o", lib, src], check=True)
    dl = ctypes.CDLL(lib)
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    dl.diag_copy17.argtypes = [ctypes.c_int, P, P, LL, P]
    dl.diag_add1.argtypes = [ctypes.c_int, P, P, P, LL, LL, LL, P]
    n, dev = N_ELTS, "cuda"
    g = torch.Generator(device=dev).manual_seed(14)
    x17 = torch.randint(-2**31, 2**31 - 1, (n, 17), dtype=torch.int32,
                        device=dev, generator=g)
    y17 = torch.empty_like(x17)
    a1 = torch.randint(0, 8380417, (n,), dtype=torch.int32, device=dev,
                       generator=g)
    b1 = torch.randint(0, 8380417, (n,), dtype=torch.int32, device=dev,
                       generator=g)
    o1 = torch.empty_like(a1)
    rows = {}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    names = {0: "word loads, word stores", 1: "word loads, tile stores",
             2: "tile loads, word stores", 3: "tile loads, tile stores"}
    for v, what in names.items():
        def fn(v=v):
            assert dl.diag_copy17(v, y17.data_ptr(), x17.data_ptr(), n,
                                  stream()) == 0
            return y17
        fn()
        ok = bool(torch.equal(y17, x17))
        rows["copy17 " + what] = dict(
            ok=ok, ms=cs.device_ms(fn, 20).ms,
            cold_ms=cs.device_ms(fn, 20, cold=True).ms,
            bound_ms=cs.bound_ms(2 * 68 * n, 0)[0])
    want = None
    for v, what in {0: "one a thread, b at (i / bdiv) % bmod in 64 bits",
                    1: "one a thread, b at i",
                    2: "four a thread (uint4), b at i"}.items():
        def fn(v=v):
            assert dl.diag_add1(v, o1.data_ptr(), a1.data_ptr(),
                                b1.data_ptr(), n, 1, n, stream()) == 0
            return o1
        out = fn().clone()
        want = out if want is None else want
        rows["add1 " + what] = dict(
            ok=bool(torch.equal(out, want)), ms=cs.device_ms(fn, 20).ms,
            cold_ms=cs.device_ms(fn, 20, cold=True).ms,
            bound_ms=cs.bound_ms(12 * n, 0)[0])
    for k, r in rows.items():
        print("  diag %-60s %s  warm %.5f  cold %.5f  bound %.5f" % (
            k, r["ok"], r["ms"], r["cold_ms"], r["bound_ms"]),
              file=sys.stderr, flush=True)
    return rows


def sector_counts(torch):
    """CUPTI's per-kernel metrics for one K1 [p521] add, from the
    profiler's trace, or why there are none."""
    from torch.profiler import ProfilerActivity, profile
    from torch._C._profiler import _ExperimentalConfig
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.fields import fp_instances as fi

    F = fi.p521_base()
    a = torch.zeros((N_ELTS, 17), dtype=torch.int32, device="cuda")
    fpm.fp_elementwise(F, fpm.ADD, a, a)
    torch.cuda.synchronize()
    cfg = _ExperimentalConfig(profiler_metrics=METRICS,
                              profiler_measure_per_kernel=True)
    with profile(activities=[ProfilerActivity.CUDA],
                 experimental_config=cfg) as prof:
        fpm.fp_elementwise(F, fpm.ADD, a, a)
        torch.cuda.synchronize()
    from longfellow_zk_tpu_torch.native import build_dir

    path = os.path.join(build_dir(), "k1_cupti_trace.json")
    prof.export_chrome_trace(path)
    text = open(path).read()
    found = {m: re.findall(r'"%s": *([0-9.e+]+)' % re.escape(m), text)
             for m in METRICS}
    return {m: v for m, v in found.items() if v} or \
        "no metric in the trace (%d bytes)" % len(text)


def child(root, diag, fields):
    sys.path.insert(0, root)
    import torch
    from longfellow_zk_tpu_torch import kernels
    if os.path.dirname(os.path.abspath(kernels.__file__)) != os.path.join(
            os.path.abspath(root), "longfellow_zk_tpu_torch"):
        raise RuntimeError("imported the port from %s" % kernels.__file__)
    # this repository's chip_smoke.py (a root has its own), for its timing
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    ptx, build_s = build_fp_ops(kernels)
    dm = demangle(list(ptx))
    res = dict(root=root, build_s=build_s,
               ptxas={dm.get(k, k): v for k, v in ptx.items()})
    for k, v in res["ptxas"].items():
        print("  ptxas %s: %s" % (k, v), file=sys.stderr)
    res["rows"] = time_rows(cs, torch, fields)
    if diag:
        res["diag"] = diag_rows(cs, torch, kernels)
    print(json.dumps(res))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="*", default=[HERE])
    ap.add_argument("--out", help="default: k1_bench.json in the port's "
                    "build directory")
    ap.add_argument("--fields", nargs="*", default=["p521", "fp24"])
    ap.add_argument("--no-diag", action="store_true",
                    help="skip tools/k1_diag.cu and the CUPTI metrics")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--diag", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--sectors", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.diag, args.fields)
    if args.sectors:
        sys.path.insert(0, HERE)
        import torch
        print(json.dumps({"sectors": sector_counts(torch)}))
        return 0
    if args.out is None:
        sys.path.insert(0, HERE)
        from longfellow_zk_tpu_torch.native import build_dir
        args.out = os.path.join(build_dir(), "k1_bench.json")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card:", smi, flush=True)
    results, diag_done, failed = [], False, False
    for root in args.roots:
        root = os.path.abspath(root)
        diag = not (diag_done or args.no_diag) and root == HERE
        diag_done |= diag
        print("== %s%s" % (root, " (+ diag)" if diag else ""), flush=True)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", root, "--fields"] + args.fields +
                           (["--diag"] if diag else []),
                           stdout=subprocess.PIPE, text=True)
        if r.returncode:
            print("FAIL: the child for %s exited %d" % (root, r.returncode))
            failed = True
            continue
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["card"] = smi
        results.append(res)
        print(json.dumps(res), flush=True)
    sectors = None
    if not args.no_diag:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--sectors"], stdout=subprocess.PIPE, text=True)
        sectors = (json.loads(r.stdout.strip().splitlines()[-1])["sectors"]
                   if r.returncode == 0 and r.stdout.strip()
                   else "the profiler's process exited %d" % r.returncode)
        print("CUPTI metrics of one [p521] add:", sectors)
    with open(args.out, "w") as f:
        json.dump(dict(card=smi, results=results, sectors=sectors), f,
                  indent=1)
    return 1 if failed or any(
        row["err"] for res in results for row in res["rows"].values()) \
        else 0


if __name__ == "__main__":
    sys.exit(main())
