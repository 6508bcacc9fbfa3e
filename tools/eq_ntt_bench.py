#!/usr/bin/env python3
"""The EQ tables (K24 eq_table, or the step-by-step build it replaced) and
K4 fp_ntt on the card, tree against tree, and each proof's device time
split by kernel.

    python3 tools/eq_ntt_bench.py [--roots DIR ...] [--only eq ntt proof]
                                  [--out FILE]

Each root (a checkout of this repository, or a directory that holds a
copy of its `longfellow_zk_tpu_torch/`; default: this one) runs in a
child process of its own, in the order given, so `--roots old . . old`
times two trees in turns on one card.  A child builds the root's kernels
(`kernels.build_all`), then

  - eq: at each proof's largest table, the prover's dot (mode 2,
    EQ(G0, .) + alpha EQ(G1, .) over 2^logv outputs, its challenges views
    of rows as the prover's) at 1 and 8 lanes and the verifier's input
    tables there (mode 1, two lanes): the root's F.eq_table where it has
    one (K24), else its _raw_eq2_dev / _eq_dev (K1 and a torch.stack a
    step); device ms (chip_smoke.py device_ms), the port's launches a
    call, a hash of the output (every root gets the same inputs from one
    seed, so the hashes must agree) and chip_smoke.py's eq_table_bound;
  - ntt: K4 at the proofs' tableaus (18 x 2,048 Fp128, 14 x 2,048 Fp2,
    450 x 4,096 residues of 18 primes) and on one row of 2^20 points
    (Fp128, Fp2): device ms, launches a call, the output's hash; where the
    root has ntt_plan, both routes (ntt_plan's, 1 where a thread block
    cluster holds a row: one launch; ntt_plan_two's, 2: the four-step
    split through a scratch, two launches);
  - proof: the SHA-256, ECDSA, mdoc and bitaddr proofs (chip_smoke.py's,
    tools/k9k1_bench.py proof_runs), each held to its golden bytes, then
    one profiled: every kernel's device ms and launches (the port's by
    name, torch's by name and by call site: tools/k3hv_bench.py's ranges,
    so the CatArrayBatchedCopy of an EQ build shows where it came from),
    the device busy ms, and each port kernel instance's launches in the
    proof (kernels.LAUNCHES).

Prints one JSON line a child and writes all of them, with the card's name
and power limit, to --out (default eq_ntt_bench.json in the port's
ignored build directory).  Needs a card and nvcc.
"""

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "tools"))


def _hash(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def _largest_logv(circ):
    return max([circ.logv] + [ly.logw for ly in circ.layers[:-1]])


def eq_rows(cs, torch, kernels, dev):
    """The EQ tables at each proof's largest layer."""
    import numpy as np
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.sumcheck import prover as spm
    from k9k1_bench import load_proofs

    rng = np.random.default_rng(19)
    k24 = hasattr(fpm, "fp_eq_table")
    rows = {}
    for pname, pr in load_proofs().items():
        F, tag, circ = pr.F, pr.tag, pr.circ
        elts = cs.bulk_elts(F, rng, dev)
        logv = _largest_logv(circ)
        logw = max(ly.logw for ly in circ.layers)
        one = F.to_limbs(1, dev)
        for lanes in (1, 8):
            rw = elts(lanes * logv * 8).reshape(
                (lanes, logv, 2, 4) + F.elt_shape)
            ab = elts(2 * lanes).reshape((lanes, 2) + F.elt_shape)
            g0, g1, alpha = rw[:, :, 0, 3], rw[:, :, 1, 3], ab[:, 0]
            n = 1 << logv
            if k24:
                def fn(g0=g0, g1=g1, alpha=alpha, n=n):
                    return F.eq_table(g0, n, alpha, g1)
            else:
                def fn(g0=g0, g1=g1, alpha=alpha, n=n):
                    return spm._raw_eq2_dev(F, logv, n, g0, g1, alpha, one)
            put(rows, cs, kernels, "%s dot [%s] 2^%d lanes %d" % (
                pname, tag, logv, lanes), fn,
                cs.eq_table_bound(tag, logv, n, lanes, 2)[0])
        # the verifier's EQ(H0, .), EQ(H1, .) over 2^logw
        hq = elts(2 * logw).reshape((2, logw) + F.elt_shape)
        if k24:
            def fn(hq=hq):
                return F.eq_table(hq, 1 << logw)
        else:
            def fn(hq=hq):  # two calls, as the parent's verifier made
                return tuple(spm._eq_dev(F, logw, 1 << logw, hq[b], one)
                             for b in (0, 1))
        put(rows, cs, kernels, "%s inputs [%s] 2^%d x 2" % (pname, tag, logw),
            fn, cs.eq_table_bound(tag, logw, 1 << logw, 2, 1)[0])
    return rows


def put(rows, cs, kernels, key, fn, bound):
    import torch
    n0 = sum(kernels.LAUNCHES.values())
    out = fn()
    launches = sum(kernels.LAUNCHES.values()) - n0
    t = cs.device_ms(fn, 20)
    b, by = bound
    if isinstance(out, tuple):
        out = torch.stack(out)
    rows[key] = dict(ms=t.ms, ms_by=t.by, launches=launches, hash=_hash(out),
                     bound_ms=b, bound_by=by, call_ms=cs.call_ms(fn, 40).ms)
    print("  %-42s %.5f ms (call %.5f)  %d launches  bound %.5f ms (%s)  %s"
          % (key, t.ms, rows[key]["call_ms"], launches, b, by,
             rows[key]["hash"]), file=sys.stderr, flush=True)


def ntt_rows(cs, torch, kernels, dev):
    """K4 at the tableaus and at 2^20 points, each route the root has."""
    import numpy as np
    from longfellow_zk_tpu_torch.fields import fp2 as fp2m
    from longfellow_zk_tpu_torch.fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER, P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X,
        P256_FP2_ROOT_Y, fp128, p256_base)
    from longfellow_zk_tpu_torch.fields.multiprime import MultiPrimeField
    from longfellow_zk_tpu_torch.transforms import ntt as nm

    rng = np.random.default_rng(4)
    routes = ((nm.ntt_plan, nm.ntt_plan_two) if hasattr(nm, "ntt_plan")
              else (None,))
    F, FB = fp128(), p256_base()
    F2 = fp2m.Fp2(FB)
    mp = MultiPrimeField(18)
    nt = {"fp128": nm.NTT(F, P128_OMEGA, P128_OMEGA_ORDER, dev),
          "fp256x2": nm.NTT(F2, (P256_FP2_ROOT_X, P256_FP2_ROOT_Y),
                            P256_FP2_ROOT_ORDER, dev),
          "crt": nm.NTT(mp, mp.omegas, mp.omega_order, dev)}
    fields = {"fp128": F, "fp256x2": F2, "crt": mp}
    rows = {}
    for tag, nrows, logn in (("fp128", 18, 11), ("fp256x2", 14, 11),
                             ("crt", 450, 12), ("fp128", 1, 20),
                             ("fp256x2", 1, 20)):
        Fx, n = fields[tag], 1 << logn
        eb = 4 * int(np.prod(Fx.elt_shape))
        if tag == "crt":
            w = np.stack([rng.integers(0, p, (nrows // 18) * n)
                          for p in mp.primes]).astype(np.uint32)
            x = torch.as_tensor(w.view(np.int32), device=dev).reshape(
                nrows, n, 1)
        else:
            w = cs.bulk_elts(FB if tag == "fp256x2" else F, rng, dev)
            x = w(nrows * n * (2 if tag == "fp256x2" else 1)).reshape(
                (nrows, n) + tuple(Fx.elt_shape))
        tw = nt[tag].twiddles(n, False)
        for planner in routes:
            if planner is None:
                def fn():
                    return nm.fp_ntt(Fx, x, tw)
            else:
                def fn(planner=planner):
                    return nm.ntt_run(Fx, x, tw, planner)
            put(rows, cs, kernels, "K4[%s] %d x 2^%d%s" % (
                tag, nrows, logn, "" if planner is None else " route %d" % (
                    planner(n, nrows, eb).route)), fn,
                cs.bound_ms(2 * eb * nrows * n + eb * (n - 1),
                            cs.MUL_OPS[tag] * nrows * (n // 2) * (logn - 1)))
    return rows


def proof_rows(cs, torch, kernels, dev):
    """Each proof: golden bytes, then one profiled and split."""
    from torch.profiler import ProfilerActivity, profile
    from k3hv_bench import install_sites, short, site_of
    from k9k1_bench import load_proofs, proof_runs

    cuda = torch.autograd.DeviceType.CUDA
    res = {}
    for name, prove, golden in proof_runs(cs, torch, dev, load_proofs()):
        same = prove() == golden
        prove()
        torch.cuda.synchronize()
        kernels.reset_launches()
        undo = install_sites(torch)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(cs.HEAD_PAD):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                t = time.perf_counter()
                prove()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
        finally:
            undo()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        by = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda or "spin_kernel" in e.name() or \
                    e.name().startswith("site "):
                continue
            v = by.setdefault(short(e.name()), [0.0, 0])
            v[0] += (e.end_ns() - e.start_ns()) / 1e6
            v[1] += 1
        busy = sum(v[0] for v in by.values())
        sites = {}
        for e in prof.events():
            if e.device_type == cuda or not getattr(e, "kernels", None):
                continue
            for k in e.kernels:
                if cs.PORT_KERNEL.search(k.name):
                    continue
                key = "%s | %s" % (short(k.name), site_of(e))
                v = sites.setdefault(key, [0.0, 0])
                v[0] += k.duration / 1e3
                v[1] += 1
        print("  %s proof: golden bytes %s, %.1f ms wall, %.3f ms device "
              "busy" % (name, same, wall, busy), file=sys.stderr, flush=True)
        for kn, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:40]:
            print("    %9.3f ms %6d  %s" % (ms, n, kn), file=sys.stderr)
        print("    torch's kernels by call site:", file=sys.stderr)
        for key, (ms, n) in sorted(sites.items(),
                                   key=lambda kv: -kv[1][0])[:15]:
            print("      %8.3f ms %5d  %s" % (ms, n, key), file=sys.stderr)
        print("    launches: %s" % json.dumps(launches), file=sys.stderr,
              flush=True)
        res[name] = dict(golden=same, wall_ms=wall, busy_ms=busy,
                         kernels=by, torch_sites=sites, launches=launches)
    return res


def child(root, only):
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
    t0 = time.perf_counter()
    logs = kernels.build_all(verbose=True)
    res = dict(root=root, build_s=time.perf_counter() - t0)
    res["ptxas"] = {src: [ln.split("ptxas info    : ")[-1]
                          for ln in log.splitlines() if "registers" in ln]
                    for src, log in logs.items()
                    if src in ("eq_table.cu", "ntt.cu")}
    dev = torch.device("cuda")
    from longfellow_zk_tpu_torch.transforms import ntt as nm
    res["fp_ntt_signature"] = str(inspect.signature(nm.fp_ntt))
    if "eq" in only:
        res["eq"] = eq_rows(cs, torch, kernels, dev)
    if "ntt" in only:
        res["ntt"] = ntt_rows(cs, torch, kernels, dev)
    if "proof" in only:
        res["proofs"] = proof_rows(cs, torch, kernels, dev)
    print(json.dumps(res, default=str))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="*", default=[HERE])
    ap.add_argument("--out", help="default: eq_ntt_bench.json in the port's "
                    "build directory")
    ap.add_argument("--only", nargs="*", default=["eq", "ntt", "proof"])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.only)
    if args.out is None:
        sys.path.insert(0, HERE)
        from longfellow_zk_tpu_torch.native import build_dir
        args.out = os.path.join(build_dir(), "eq_ntt_bench.json")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card:", smi, flush=True)
    results, failed = [], False
    for root in args.roots:
        root = os.path.abspath(root)
        print("== %s" % root, flush=True)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", root, "--only"] + args.only,
                           stdout=subprocess.PIPE, text=True)
        if r.returncode:
            print("FAIL: the child for %s exited %d" % (root, r.returncode))
            failed = True
            continue
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["card"] = smi
        results.append(res)
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, results=results), f, indent=1)
    # every root's outputs on the same inputs agree; every golden equal
    bad = [(res["root"], k) for res in results
           for k, v in res.get("proofs", {}).items() if not v["golden"]]
    for part in ("eq", "ntt"):
        hashes = {}
        for res in results:
            for k, row in res.get(part, {}).items():
                hashes.setdefault(k.rsplit(" route", 1)[0], set()).add(
                    row["hash"])
        bad += [(part, k) for k, h in hashes.items() if len(h) > 1]
    if bad:
        print("FAIL: not exact:", bad)
    print("wrote", args.out)
    return 1 if failed or bad else 0


if __name__ == "__main__":
    sys.exit(main())
