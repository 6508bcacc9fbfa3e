#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (name, count, power limit).
2. Builds the kernels K1-K4 from longfellow_zk_tpu_torch/csrc with nvcc.
3. Runs each kernel at the shapes of the Fp128 SHA-256 one-block proof,
   holds it against its plain PyTorch version on the same inputs (field
   arithmetic is exact: tolerance 0) and times both (device time from
   the profiler; the kernel's call time, back to back, by CUDA events).
4. Drives the port's main path: the SHA-256 one-block ZK proof through
   ZkProver.commit / ZkProver.prove under DeterministicEngine(), whose
   serialized bytes must equal the JAX package's golden proof
   (longfellow_zk_tpu_torch/testdata).  Counts each kernel's launches in
   that proof (each must be > 0), times 5 more proofs (median
   zk_sha256_1block_prove_ms) and profiles one for the device-busy share.
5. Prints the kernels line, the card line and, last, the result line.

Any failure exits non-zero before the result line.  Imports no JAX.
"""

import gzip
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
# 32-bit integer multiplies: 64 INT32 lanes per SM (half the 128 FP32
# lanes behind the data sheet's 67 TFLOP/s float32, which counts an FMA
# as 2)
INT32_OPS_PER_S = 67e12 / 4
MUL_OPS = 32                   # 16 wide 32x32->64 products per Fp mul


def bound_ms(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def call_ms(fn, iters):
    """Time of one call, back to back, by CUDA events: what a caller
    waits for, host-side launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters):
    """Device time of one call: the sum of the device activity that the
    profiler records over `iters` calls, divided by `iters`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    total_us = sum(e.device_time for e in prof.events()
                   if e.device_type == cuda)
    return total_us / 1e3 / iters


def max_err(a, b):
    torch.cuda.synchronize()
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from longfellow_zk_tpu_torch import kernels
    from longfellow_zk_tpu_torch.circuits.sha.sha256 import (
        SHA256_INIT, pack_block_witness, sha256_pad, transform_block_witness)
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER, fp128)
    from longfellow_zk_tpu_torch.proto.lfc1 import FP128_ID, read_circuit
    from longfellow_zk_tpu_torch.random_oracle.engine import (
        DeterministicEngine, SecureRandomEngine)
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
    from longfellow_zk_tpu_torch.sumcheck.prover import SumcheckProver
    from longfellow_zk_tpu_torch.transforms.ntt import NTT, fp_ntt, ntt_plain
    from longfellow_zk_tpu_torch.zk.proof import ZkProof
    from longfellow_zk_tpu_torch.zk.prover import ZkProver
    from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof

    # -- 1. the card ----------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("device:", name, "count:", count, "|", smi)
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    from longfellow_zk_tpu_torch.native import get_lib
    print("host SHA-256/AES:", "native C" if get_lib() is not None
          else "pure Python (no C compiler)")

    # -- 2. build -------------------------------------------------------
    t = time.perf_counter()
    logs = kernels.build_all(verbose=True)
    print("build: %.1f s (4 nvcc in parallel)" % (time.perf_counter() - t))
    for src, log in sorted(logs.items()):
        regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                if "registers" in ln]
        print("  %s: %s" % (src, "; ".join(regs)))

    dev = torch.device("cuda")
    F = fp128()
    circ = read_circuit(F, FP128_ID, gzip.open(os.path.join(
        REPO, "artifacts", "sha256_1block_fp128.lfc1.gz"), "rb").read())
    rng = np.random.default_rng(2024)

    def elts(n):
        return F.to_limbs([int.from_bytes(rng.bytes(16), "little") % F.p
                           for _ in range(n)], dev)

    # -- 3. each kernel against its plain version --------------------------
    rows = {}
    failures = []

    def record(kname, source, replaces, err, fn, plain_fn, nbytes, ops):
        b, by = bound_ms(nbytes, ops)
        ms, plain_ms = device_ms(fn, 50), device_ms(plain_fn, 3)
        rows[kname] = dict(name=kname, route="cuda", source=source,
                           replaces=replaces, launches=0, max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, bound_ms=b,
                           bound_by=by, library_ms=None,
                           call_ms=call_ms(fn, 200))
        print("kernel %-15s max_abs_err %d (tolerance 0)  device %.5f ms "
              "(call %.5f ms)  plain %.4f ms  bound %.5f ms (%s)" % (
                  kname, err, ms, rows[kname]["call_ms"], plain_ms, b, by))
        if err != 0:
            failures.append(kname)

    # K1 at 2^15 (a wire round) and 18 x 2048 (the tableau)
    err = 0
    for n in (1 << 15, 18 * 2048):
        a, b, r = elts(n), elts(n), elts(1)[0]
        h = torch.as_tensor(rng.integers(0, 1 << 15, n, dtype=np.int32),
                            device=dev)
        for mode in (fpm.MUL, fpm.ADD, fpm.SUB):
            err = max(err, max_err(fpm.fp_elementwise(F, mode, a, b),
                                   fpm.elementwise_plain(F, mode, a, b)))
        err = max(err, max_err(F.bind(a, r),
                               fpm.elementwise_plain(F, fpm.BIND, a, r)))
        err = max(err, max_err(F.hv_update(a, h, r),
                               fpm.elementwise_plain(F, fpm.HV, a, r, h)))
    b_tab = elts(18 * 2048).reshape(18, 2048, 4)
    print("K1 mul at 18 x 2048: device %.5f ms, bound %.5f ms" % (
        device_ms(lambda: F.mul(b_tab, b_tab), 50),
        bound_ms(48 * 18 * 2048, MUL_OPS * 18 * 2048)[0]))
    n = 1 << 15
    a, b = elts(n), elts(n)
    record("fp_elementwise", "longfellow_zk_tpu_torch/csrc/fp_ops.cu",
           "longfellow_zk_tpu/fields/fp.py:277", err,
           lambda: F.mul(a, b),
           lambda: fpm.elementwise_plain(F, fpm.MUL, a, b),
           48 * n, MUL_OPS * n)

    # K2 and K3 at the 72,534-term layer (layer 5)
    ly = max(range(circ.nl), key=lambda i: circ.layers[i].nterms)
    layer = circ.layers[ly]
    sp = SumcheckProver(F, dev)
    qd = sp._quad_dev(layer.quad)
    nv = circ.layers[ly - 1].nw
    starts, ends = sp._segments(layer.quad, nv)
    T = layer.nterms
    W = elts(layer.nw)
    V, ok = fpm.fp_eval_layer(F, W, qd["h0"], qd["h1"], qd["v"], qd["bmask"],
                              starts, ends)
    V2, ok2 = fpm.eval_layer_plain(F, W, qd["h0"], qd["h1"], qd["v"],
                                   qd["bmask"], starts, ends)
    err = max_err(V, V2) + int(bool(ok) != bool(ok2))
    x = elts(T)
    err = max(err, max_err(F.lazy_segment_sum(x, starts, ends),
                           fpm.segment_sum_plain(F, x, starts, ends)))
    record("fp_segment_sum", "longfellow_zk_tpu_torch/csrc/segsum.cu",
           "longfellow_zk_tpu/sumcheck/prover_device.py:372", err,
           lambda: fpm.fp_eval_layer(
               F, W, qd["h0"], qd["h1"], qd["v"], qd["bmask"], starts,
               ends),
           lambda: fpm.eval_layer_plain(
               F, W, qd["h0"], qd["h1"], qd["v"], qd["bmask"], starts,
               ends),
           T * (16 + 4 + 4 + 1) + 16 * layer.nw + nv * (16 + 8) + 4,
           2 * MUL_OPS * T)

    N = 1 << layer.logw
    hv, Wh, Wo = elts(T), elts(N), elts(N)
    h0, h1 = qd["h0"], qd["h1"]
    err = max_err(fpm.fp_wire_sums(F, hv, Wh, Wo, h0, h1),
                  fpm.wire_sums_plain(F, hv, Wh, Wo, h0, h1))
    err = max(err, max_err(F.lazy_sum(hv, 0), fpm.axis_sum_plain(F, hv, 0)))
    t15 = elts(15 * 681).reshape(15, 681, 4)
    err = max(err, max_err(F.lazy_sum(t15, 0),
                           fpm.axis_sum_plain(F, t15, 0)))
    n_even = int((h0 & 1).eq(0).sum())
    record("fp_wire_round", "longfellow_zk_tpu_torch/csrc/wire_round.cu",
           "longfellow_zk_tpu/sumcheck/prover_device.py:571", err,
           lambda: fpm.fp_wire_sums(F, hv, Wh, Wo, h0, h1),
           lambda: fpm.wire_sums_plain(F, hv, Wh, Wo, h0, h1),
           T * (16 + 4 + 4) + 2 * 16 * N + 32,
           MUL_OPS * (2 * T + n_even))

    # K4 at 18 x 2048 (the Ligero tableau encode)
    xr = elts(18 * 2048).reshape(18, 2048, 4)
    ntt = NTT(F, P128_OMEGA, P128_OMEGA_ORDER, dev)
    err = 0
    for inverse in (False, True):
        tw = ntt.twiddles(2048, inverse)
        err = max(err, max_err(fp_ntt(F, xr, tw), ntt_plain(F, xr, tw)))
    record("fp_ntt", "longfellow_zk_tpu_torch/csrc/ntt.cu",
           "longfellow_zk_tpu/transforms/ntt.py:94", err,
           lambda: fp_ntt(F, xr, tw),
           lambda: ntt_plain(F, xr, tw),
           2 * 16 * 18 * 2048 + 16 * 2047, MUL_OPS * 18 * 1024 * 10)
    if failures:
        print("FAIL: kernels disagree with their plain versions:", failures)
        return 1

    # -- 4. the main path: the SHA-256 one-block proof ----------------------
    meta = json.load(open(os.path.join(
        REPO, "longfellow_zk_tpu_torch", "testdata",
        "sha256_1block_fp128.proof.json")))
    golden = open(os.path.join(REPO, "longfellow_zk_tpu_torch", "testdata",
                               "sha256_1block_fp128.proof.bin"), "rb").read()
    padded = sha256_pad(meta["message"].encode())
    Wit = [F.of_scalar(1)] + [F.of_scalar((byte >> i) & 1)
                              for byte in padded for i in range(8)]
    Wit.extend(pack_block_witness(
        F, 4, [transform_block_witness(SHA256_INIT, padded)]))
    from longfellow_zk_tpu_torch.zk.testing import rs_factory_for
    rs = rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER, dev)

    def one_proof(engine):
        zkp = ZkProof(rate=meta["rate"], nreq=meta["nreq"])
        prover = ZkProver(circ, F, rs, rate=meta["rate"], nreq=meta["nreq"],
                          device=dev)
        ts = Transcript(meta["transcript_label"].encode(),
                        version=meta["version"])
        t0 = time.perf_counter()
        prover.commit(zkp, Wit, ts, engine)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        assert prover.prove(zkp, Wit, ts)
        torch.cuda.synchronize()
        phases.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        return write_zk_proof(zkp, circ, prover.param, F)

    phases = []

    kernels.reset_launches()
    t = time.perf_counter()
    proof = one_proof(DeterministicEngine())
    first_ms = (time.perf_counter() - t) * 1e3
    launches = dict(kernels.LAUNCHES)
    print("first proof: %.1f ms (uploads the circuit), %d bytes"
          % (first_ms, len(proof)))
    print("launches in one proof:", json.dumps(launches))
    if proof != golden:
        print("FAIL: proof bytes differ from the golden JAX proof")
        return 1
    print("proof bytes equal the golden JAX proof (%d bytes)" % len(golden))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        print("FAIL: kernels not launched on the main path:", missing)
        return 1
    for k, v in launches.items():
        rows[k]["launches"] = v

    times = []
    del phases[:]
    for _ in range(5):
        t = time.perf_counter()
        one_proof(SecureRandomEngine())
        times.append((time.perf_counter() - t) * 1e3)
    prove_ms = statistics.median(times)
    print("zk_sha256_1block_prove_ms: %.3f (median of 5: %s) on %s"
          % (prove_ms, ", ".join("%.1f" % x for x in times), smi))
    print("  commit %.1f ms, prove %.1f ms (medians)" % (
        statistics.median(c for c, _ in phases),
        statistics.median(p for _, p in phases)))

    import cProfile
    import pstats
    cp = cProfile.Profile()
    cp.enable()
    one_proof(SecureRandomEngine())
    cp.disable()
    st = pstats.Stats(cp).stats
    total = sum(v[2] for v in st.values())
    print("host profile of one proof (cProfile, %.1f ms of own time in "
          "all), by own time:" % (total * 1e3))
    for (fname, line, func), v in sorted(st.items(),
                                         key=lambda kv: -kv[1][2])[:14]:
        print("  %8.2f ms %7d calls  %s (%s:%d)" % (
            v[2] * 1e3, v[1], func, os.path.basename(fname), line))

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        one_proof(SecureRandomEngine())
        wall_ms = (time.perf_counter() - t) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.events():
        if e.device_type == cuda:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms > 0:
        print("profiled proof: %.1f ms wall, %.3f ms device busy "
              "(busy share %.4f)" % (wall_ms, busy_ms, busy_ms / wall_ms))
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print("  device %9.3f ms  %s" % (ms, kname[:90]))
    else:
        print("profiled proof: %.1f ms wall, device busy share not "
              "measured (the profiler recorded no device time)" % wall_ms)

    # -- 5. results ---------------------------------------------------------
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
