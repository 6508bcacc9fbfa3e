#!/usr/bin/env python3
"""The layer prologue (torch's gathers or K23 layer_hv) and K3
fp_wire_round on the card, tree against tree: each proof's device time
split by call site and by K3 launch.

    python3 tools/k3hv_bench.py [--roots DIR ...] [--only proof k3]
                                [--out FILE]

Each root (a checkout of this repository, or a directory that holds a
copy of its `longfellow_zk_tpu_torch/`; default: this one) runs in a
child process of its own, in the order given, so `--roots old . . old`
times two trees in turns on one card.  A child builds the root's kernels
(`kernels.build_all`), then

  - proof: the SHA-256, ECDSA, mdoc and bitaddr proofs of chip_smoke.py,
    each held to its golden bytes, then one profiled (torch.profiler with
    input shapes) and split:
      * torch's own kernels (every device record that is not a port
        kernel k_*) by the call site that launched them: the torch calls
        of the paths (indexing, stack, cat, shifts, where, gather, ...)
        run wrapped in a profiler range named by the innermost frame in
        the port's package and the one outside `fields/` that called it
        ("sumcheck/prover.py:518 <- ..."), with device ms, launches and
        the index count (the largest input's first axis) of each aten
        op, so `vectorized_gather_kernel`, `CatArrayBatchedCopy` and the
        int `BUnaryFunctor` show where they come from;
      * K3 by launch: each record of K3's kernels matched, in order, to
        the wrapper call that made it (kernels.launch logged): instance,
        mode (wire or sum), T (terms, or the summed axis), lanes or
        outputs, nblk, and the call's bound (chip_smoke.py bound_ms: the
        bytes hv, h, ho and Wh, Wo once, or the products 2 T + the even
        h's, as PERF.md section 6 counts them), the partial kernel and
        the finish (`k_finish`) apart;
      * K23 layer_hv (where the root has it) by launch: instance, terms,
        lanes, bound (chip_smoke.py layer_hv_bytes, or the products);
      * every kernel's device ms and launches, and the device busy ms;
  - k3: K3 at each proof's largest layer (mode 0, shift 0, lanes 1 and
    8) and its Ligero row sums (mode 1), and the layer prologue at the
    same layer (the root's `F.layer_hv` if it has it, else the parent's
    torch gather, where and K1 product, then the merge plan's
    permutation), device ms against chip_smoke.py's bound.

Device times of `k3` are chip_smoke.py's device_ms.  Prints one JSON line
a child and writes all of them, with the card's name and power limit, to
--out (default k3hv_bench.json in the port's ignored build directory).
Needs a card and nvcc.
"""

import argparse
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "tools"))

K3_REC = re.compile(r"(?:^|[^A-Za-z0-9_])k_(?:wire|sum_partial|finish|"
                    r"axis_sum)\w*")
K23_REC = re.compile(r"(?:^|[^A-Za-z0-9_])k_layer_hv\w*")
PORT_REC = re.compile(r"(?:^|[^A-Za-z0-9_]|_Z\d+)k_[a-z0-9_]+")
PKG = "longfellow_zk_tpu_torch" + os.sep


# the call site of a wrapped torch call (install_sites): the innermost
# frame of the port's package and the innermost one outside its fields/
def _site():
    mine = []
    f = sys._getframe(2)
    while f is not None and len(mine) < 8:
        fn = f.f_code.co_filename
        if PKG in fn:
            mine.append("%s:%d" % (fn.split(PKG, 1)[1], f.f_lineno))
        f = f.f_back
    if not mine:
        return "outside the package"
    outer = next((m for m in mine if not m.startswith("fields")), None)
    return mine[0] if outer in (None, mine[0]) else "%s <- %s" % (
        mine[0], outer)


def install_sites(torch):
    """Wraps the torch calls that launch torch's own kernels on the
    paths (indexing, stack and cat, shifts, where, gather, index_select,
    copies) so that each runs in a profiler range named by its call site;
    returns a function that undoes it."""
    from torch.profiler import record_function
    targets = [(torch.Tensor, n) for n in (
        "__getitem__", "__setitem__", "__rshift__", "__and__", "__eq__",
        "index_select", "contiguous", "repeat", "to", "all", "sum")] + \
        [(torch, n) for n in ("stack", "cat", "where", "gather", "zeros",
                              "arange", "as_tensor")]
    saved = []
    for owner, n in targets:
        fn = getattr(owner, n)

        def wrapped(*a, __fn=fn, **kw):
            with record_function("site " + _site()):
                return __fn(*a, **kw)
        saved.append((owner, n, fn))
        setattr(owner, n, wrapped)

    def undo():
        for owner, n, fn in saved:
            setattr(owner, n, fn)
    return undo


def site_of(e):
    """The call site of a profiler event: its nearest "site" range."""
    while e is not None:
        if e.name.startswith("site "):
            return e.name[5:]
        e = e.cpu_parent
    return "outside the wrapped calls"


def short(name):
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].replace("void ", "").strip()[:80]


def proof_rows(cs, torch, kernels, dev):
    """Each proof: golden bytes, then one profiled and split."""
    from torch.profiler import ProfilerActivity, profile
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.sumcheck import prover as spm
    from k9k1_bench import load_proofs, proof_runs

    cuda = torch.autograd.DeviceType.CUDA
    res = {}
    for name, prove, golden in proof_runs(cs, torch, dev, load_proofs()):
        same = prove() == golden
        prove()
        torch.cuda.synchronize()
        calls, pending, pending_g = [], [], []
        launch, wsums = kernels.launch, spm.fp_wire_sums
        lhv = getattr(fpm, "fp_layer_hv", None)

        def wire_sums(F, hv, Wh, Wo, h, ho, *a, **kw):
            # the hand's indices and the round's shift, for the bound
            pending.append((h, kw.get("s", a[0] if a else 0)))
            return wsums(F, hv, Wh, Wo, h, ho, *a, **kw)

        def layer_hv(F, dot, g, *a):
            pending_g.append(g)
            return lhv(F, dot, g, *a)

        def logged(kname, nl, *args):
            kind, tag = kname.split("[")
            if kind == "fp_wire_round":
                # mode, out, scratch, hv, Wh, Wo, h, ho, T, A, R, B, nblk
                hs = pending.pop(0) if args[0] == 0 and pending else None
                calls.append(("K3", tag[:-1], nl, args[0]) +
                             tuple(int(a) for a in args[8:13]) + (hs,))
            elif kind == "layer_hv":
                # the terms' g, for the distinct wires of the bound
                g = pending_g.pop(0) if pending_g else None
                calls.append(("K23", tag[:-1], nl, 0) + tuple(
                    int(a) for a in args[6:8]) + (0, 0, 0, g))
            return launch(kname, nl, *args)

        kernels.launch, spm.fp_wire_sums = logged, wire_sums
        if lhv is not None:
            fpm.fp_layer_hv = layer_hv
        undo = install_sites(torch)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                for _ in range(cs.HEAD_PAD):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                t = time.perf_counter()
                prove()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
        finally:
            undo()
            kernels.launch, spm.fp_wire_sums = launch, wsums
            if lhv is not None:
                fpm.fp_layer_hv = lhv
        by, k3r, k23r = {}, [], []
        for e in prof.profiler.kineto_results.events():
            # (the call-site ranges appear on the device too: not work)
            if e.device_type() != cuda or "spin_kernel" in e.name() or \
                    e.name().startswith("site "):
                continue
            ms = (e.end_ns() - e.start_ns()) / 1e6
            v = by.setdefault(short(e.name()), [0.0, 0])
            v[0] += ms
            v[1] += 1
            if K3_REC.search(e.name()):
                k3r.append((e.start_ns(), ms, short(e.name())))
            elif K23_REC.search(e.name()):
                k23r.append((e.start_ns(), ms, short(e.name())))
        busy = sum(v[0] for v in by.values())
        # torch's kernels by call site
        sites = {}
        for e in prof.events():
            if e.device_type == cuda or not getattr(e, "kernels", None):
                continue
            site = site_of(e)
            shapes = [s for s in (e.input_shapes or []) if s]
            nidx = max((s[0] for s in shapes
                        if isinstance(s, (list, tuple)) and s and
                        isinstance(s[0], int)), default=0)
            for k in e.kernels:
                if PORT_REC.search(k.name):
                    continue
                key = "%s | %s | %s" % (short(k.name), e.name, site)
                v = sites.setdefault(key, dict(ms=0.0, launches=0,
                                               index_count=0,
                                               shapes=str(shapes)[:120]))
                v["ms"] += k.duration / 1e3
                v["launches"] += 1
                v["index_count"] += int(nidx)
        # K3 and K23 launches matched to their calls, in order
        k3r.sort()
        k23r.sort()
        split = dict(K3=[], K23=[])
        its = dict(K3=iter(k3r), K23=iter(k23r))
        nrec = dict(K3=len(k3r), K23=len(k23r))
        need = dict(K3=0, K23=0)
        for c in calls:
            need[c[0]] += c[2]
        ok = {k: need[k] == nrec[k] for k in need}
        for (kind, tag, nl, mode, T, A, R, B, nblk, h) in calls:
            if not ok[kind]:
                continue
            recs = [next(its[kind]) for _ in range(nl)]
            eb = 16 if tag in ("fp128", "gf2_128") else 32
            mops = cs.MUL_OPS[tag]
            if kind == "K23":
                nb = None  # counted after the profile (distinct g)
                ops = mops * A * T
                row = dict(tag=tag, T=T, lanes=A)
                row["_g"] = h
            elif mode == 0:
                nb = A * T * eb + T * 8 + A * eb * (R + B) + 2 * A * eb
                row = dict(tag=tag, mode="wire", T=T, lanes=A, nblk=nblk)
                row["_h"] = h
                ops = None
            else:
                nb = eb * A * R * B + eb * A * B
                ops = 0
                row = dict(tag=tag, mode="sum", R=R, outputs=A * B,
                           nblk=nblk)
            row.update(ms=[r[1] for r in recs], kernels=[r[2] for r in recs],
                       nbytes=nb, ops=ops, mops=mops)
            split[kind].append(row)
        # bounds (the even h's counted after the profile)
        for row in split["K3"]:
            hs = row.pop("_h", None)
            if row["ops"] is None:
                n_even = row["T"] // 2 if hs is None else int(
                    (((hs[0].long() >> hs[1]) & 1) == 0).sum())
                row["ops"] = row["mops"] * row["lanes"] * (2 * row["T"] +
                                                           n_even)
            row["bound_ms"], row["bound_by"] = cs.bound_ms(row["nbytes"],
                                                           row["ops"])
        for row in split["K23"]:
            g = row.pop("_g")
            nd = row["T"] if g is None else int(torch.unique(g).numel())
            row["nbytes"] = cs.layer_hv_bytes(16 if row["tag"] in (
                "fp128", "gf2_128") else 32, row["T"], nd, row["lanes"])
            row["bound_ms"], row["bound_by"] = cs.bound_ms(row["nbytes"],
                                                           row["ops"])
        summary = {}
        for kind in ("K3", "K23"):
            for row in split[kind]:
                key = "%s[%s] %s" % (kind, row["tag"], row.get("mode", ""))
                s = summary.setdefault(key.strip(), dict(
                    calls=0, ms=0.0, bound_ms=0.0, by_kernel={}))
                s["calls"] += 1
                s["ms"] += sum(row["ms"])
                s["bound_ms"] += row["bound_ms"]
                for kn, ms in zip(row["kernels"], row["ms"]):
                    z = s["by_kernel"].setdefault(kn, [0.0, 0])
                    z[0] += ms
                    z[1] += 1
        print("  %s proof: golden bytes %s, %.1f ms wall, %.3f ms device "
              "busy; K3 records %d for %d launches, K23 %d for %d"
              % (name, same, wall, busy, nrec["K3"], need["K3"],
                 nrec["K23"], need["K23"]), file=sys.stderr, flush=True)
        for k, s in summary.items():
            print("    %-22s %4d calls %8.3f ms (bound %.3f ms)  %s" % (
                k, s["calls"], s["ms"], s["bound_ms"], " ".join(
                    "%s:%.3f/%d" % (kn, v[0], v[1])
                    for kn, v in s["by_kernel"].items())), file=sys.stderr)
        top = sorted(sites.items(), key=lambda kv: -kv[1]["ms"])
        print("    torch's kernels by call site:", file=sys.stderr)
        for key, v in top[:25]:
            print("      %8.3f ms %5d launches %10d indices  %s" % (
                v["ms"], v["launches"], v["index_count"], key),
                file=sys.stderr)
        for kn, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:14]:
            print("    %9.3f ms %6d  %s" % (ms, n, kn), file=sys.stderr,
                  flush=True)
        # per-T histogram of K3's wire launches (powers of 2)
        hist = {}
        for row in split["K3"]:
            key = "%s %s 2^%d" % (row["tag"], row["mode"], max(0, (
                row.get("T", row.get("R", 1)) - 1).bit_length()))
            z = hist.setdefault(key, [0.0, 0, 0.0])
            z[0] += sum(row["ms"])
            z[1] += 1
            z[2] += row["bound_ms"]
        res[name] = dict(golden=same, wall_ms=wall, busy_ms=busy,
                         kernels=by, torch_sites=sites, k3_k23=summary,
                         k3_by_size=hist, k3_calls=split["K3"],
                         k23_calls=split["K23"], matched=ok)
    return res


def k3_rows(cs, torch, dev):
    """K3 and the layer prologue alone at each proof's largest layer."""
    import numpy as np
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.sumcheck.prover import (
        SumcheckProver, quad_tensors)
    from k9k1_bench import load_proofs

    rng = np.random.default_rng(18)
    rows = {}

    def put(key, err, fn, nbytes, ops, iters=20):
        t = cs.device_ms(fn, iters)
        b, by = cs.bound_ms(nbytes, ops)
        rows[key] = dict(err=err, ms=t.ms, ms_by=t.by, bound_ms=b,
                         bound_by=by)
        print("  %-44s err %d  %.5f ms  bound %.5f ms (%s)"
              % (key, err, t.ms, b, by), file=sys.stderr, flush=True)

    for pname, pr in load_proofs().items():
        F, tag, circ = pr.F, pr.tag, pr.circ
        pm = fpm.plain_of(F)
        elts = cs.elts_of(F, rng, dev)
        eb, mops = 4 * F.nlimb, cs.MUL_OPS[tag]
        ly = max(range(circ.nl), key=lambda i: circ.layers[i].nterms)
        layer = circ.layers[ly]
        qd = quad_tensors(F, layer.quad, dev)
        T, N = layer.nterms, 1 << layer.logw
        h0, h1 = qd["h0"], qd["h1"]
        n_even = int(((h0 & 1) == 0).sum())
        for B in (1, 8):
            hv, Wh, Wo = elts(B * T), elts(B * N), elts(B * N)
            if B > 1:
                hv, Wh, Wo = (x.reshape(B, -1, F.nlimb) for x in (hv, Wh, Wo))
            err = cs.max_err(fpm.fp_wire_sums(F, hv, Wh, Wo, h0, h1),
                             pm.wire_sums_plain(F, hv, Wh, Wo, h0, h1))
            put("%s K3[%s] wire layer %d T %d lanes %d" % (
                pname, tag, ly, T, B), err,
                lambda hv=hv, Wh=Wh, Wo=Wo: fpm.fp_wire_sums(
                    F, hv, Wh, Wo, h0, h1),
                B * (T * eb + 2 * eb * N + 2 * eb) + 8 * T,
                B * mops * (2 * T + n_even))
        # small rounds (the later rounds of every layer)
        for Ts in (200, 1000, 8192):
            hv, Wh, Wo = elts(Ts), elts(2 * Ts), elts(2 * Ts)
            hs = torch.as_tensor(rng.integers(0, 2 * Ts, Ts, dtype=np.int32),
                                 device=dev)
            put("%s K3[%s] wire T %d" % (pname, tag, Ts),
                cs.max_err(fpm.fp_wire_sums(F, hv, Wh, Wo, hs, hs),
                           pm.wire_sums_plain(F, hv, Wh, Wo, hs, hs)),
                lambda hv=hv, Wh=Wh, Wo=Wo, hs=hs: fpm.fp_wire_sums(
                    F, hv, Wh, Wo, hs, hs),
                Ts * eb + 4 * eb * Ts + 8 * Ts, mops * 5 * Ts // 2)
        zrows = elts(18 * 681).reshape(18, 681, F.nlimb)
        put("%s K3[%s] sum 18 x 681" % (pname, tag),
            cs.max_err(F.lazy_sum(zrows, 0), pm.axis_sum_plain(F, zrows, 0)),
            lambda: F.lazy_sum(zrows, 0), eb * 18 * 681 + eb * 681, 0)
        # the layer prologue at this layer, one lane
        nv = circ.layers[ly - 1].nw if ly > 0 else circ.nv
        lognv = max(0, (nv - 1).bit_length())
        dot = elts(1 << lognv).reshape(1, 1 << lognv, F.nlimb)
        beta = elts(1)
        sp = SumcheckProver(F, dev)
        plan = sp._wm_for(layer.quad, layer.logw)
        nb = cs.layer_hv_bytes(eb, T, int(torch.unique(qd["g"]).numel()), 1)
        ops = mops * T
        if hasattr(F, "layer_hv"):
            ht = sp._hv_terms(layer.quad, layer.logw)

            def pro():
                return F.layer_hv(dot, ht["g"], ht["v"], ht["bmask"], beta)
            want = pm.layer_hv_plain(F, dot, ht["g"], ht["v"], ht["bmask"],
                                     beta)
            err = cs.max_err(pro(), want)
        else:
            def pro():
                vq = torch.where(qd["bmask"][:, None], beta[:, None],
                                 qd["v"])
                hv = F.mul(vq, dot[:, qd["g"]])
                return hv if plan is None else hv[:, plan["perm"]]
            err = 0
        put("%s prologue[%s] layer %d T %d" % (pname, tag, ly, T), err, pro,
            nb, ops)
    return rows


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
    kernels.build_all()
    res = dict(root=root, build_s=time.perf_counter() - t0)
    dev = torch.device("cuda")
    res["wire_sums_signature"] = str(inspect.signature(
        __import__("longfellow_zk_tpu_torch.fields.fp",
                   fromlist=["fp_wire_sums"]).fp_wire_sums))
    if "k3" in only:
        res["k3"] = k3_rows(cs, torch, dev)
    if "proof" in only:
        res["proofs"] = proof_rows(cs, torch, kernels, dev)
    print(json.dumps(res, default=str))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="*", default=[HERE])
    ap.add_argument("--out", help="default: k3hv_bench.json in the port's "
                    "build directory")
    ap.add_argument("--only", nargs="*", default=["k3", "proof"])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.only)
    if args.out is None:
        sys.path.insert(0, HERE)
        from longfellow_zk_tpu_torch.native import build_dir
        args.out = os.path.join(build_dir(), "k3hv_bench.json")
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
    bad = [(res["root"], k) for res in results
           for k, row in res.get("k3", {}).items() if row["err"]]
    bad += [(res["root"], k) for res in results
            for k, v in res.get("proofs", {}).items() if not v["golden"]]
    if bad:
        print("FAIL: not exact:", bad)
    print("wrote", args.out)
    return 1 if failed or bad else 0


if __name__ == "__main__":
    sys.exit(main())
