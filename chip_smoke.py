#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (name, count, power limit).
2. Builds the kernels K1-K23 from longfellow_zk_tpu_torch/csrc with nvcc.
3. Runs each kernel instance at the shapes of the proofs below, holds
   it against its plain PyTorch version on the same inputs (field
   arithmetic, hashing and the transcript states are exact: tolerance 0)
   and times both (device time from the profiler, or, where that falls
   below the bound because back-to-back calls found their inputs in the
   L2, by CUDA events with the L2 flushed before each call; the kernel's
   call time, back to back, by CUDA events):
   a. the Fp128 instances of K1-K4 at the SHA-256 proof's shapes (K3's
      wire mode also at 1-158,231 terms, the round's shifts 0-3, 1 and 8
      lanes, twice back to back, and K1's hv update by the same shifts,
      as at each instance of b, c and i);
   b. the P-256 instances of K1-K3, K4 over Fp2 and K5 at the ECDSA
      proof's shapes;
   c. the GF(2^128) instances of K1-K3 and K6 at the mdoc hash proof's
      shapes (K1 at 266 x 3,230, K2 and K3 on its 3,578,789-term layer,
      K6 on the 266-row tableau at (461, 4151) and (921, 4151)); K2's
      evaluation at hash layers 17, 18 and 20 and its merge folds at
      the stages of layer 18's plan (a segment of 525,422 terms), rows
      "fp_segment_sum[gf2_128] eval layer L" and "... fold layer 18
      stage S"; K1's products by one element at the largest layer, rows
      "fp_elementwise[gf2_128] hv" (its terms) and "... bind" (its
      wires; bound: the bytes or the reads of the element's table of
      multiples, g128_table_ms);
   d. K7 at the largest layer of the SHA-256 circuit (Fp128), of the
      mdoc signature circuit (P-256) and of the mdoc hash circuit
      (GF(2^128), 3,578,789 terms);
   e. K8 (SHA-256) on the leaf messages of the SHA-256 proof's commit,
      of the mdoc hash commit (4,288 bytes each) and on one 64-byte
      level of its Merkle tree;
   f. K9 (the Fiat-Shamir oracle) of each field, from random transcript
      states, every mode, at absorb lengths that cross the 55/56/64-byte
      boundaries; K10 (the hand-round tail) of each field on random
      rounds.  Their bound is the chain of dependent instructions of
      their one thread (a model, `chain_ms`);
   g. K11 (the constraint build), K12 (the vector A) and K9 mode 9 (the
      column choice) of each field, at the shapes of the SHA-256 proof
      (Fp128), of the ECDSA proof (P-256) and of the mdoc hash proof
      (GF(2^128)); K11 and K9 mode 9 against their chain;
   h. the lane axis of the batch prover (8 proofs in one launch): K1's
      bind and hv, K3, K9, K10, K11, K12 and K9 mode 9 [fp128] at the
      SHA-256 proof's shapes, 8 lanes (one of whose samples rejects), a
      row "<kernel> lanes=8" each;
   i. the secp256k1 instances of K1-K3, K7, K9-K12 at the bitaddr
      proof's shapes, and the CRT Reed-Solomon kernels at its tableau (25
      rows, 18 prime lanes, 4,096 points): K13 crt_to, K4 fp_ntt[crt],
      K14 mp_elementwise and K15 crt_from;
   j. the copy rounds of the plain sumcheck: K16 (copy_round_sums) of
      each field at a largest layer over copies (Fp128: the SHA-256
      circuit's x 64; P-256: the ECDSA circuit's x 8; secp256k1: the
      bitaddr circuit's x 8; GF(2^128): the mdoc hash circuit's x 2),
      and K10's cubic mode of each field on random rounds;
   k. the Reed-Solomon transforms: K17 (the matmul NTT's B-point block)
      at B = 16, 64 and 128 on the blocks of a 2^14-point transform, and
      at B = 128 on all 2^20 points (timed there); K18 (the half-complex
      RFFT's passes) in its three modes at the ECDSA tableau (14 rows of
      2,048); K19 and K20 (Nussbaumer's butterfly level and base case) of
      each prime field at the shapes that the bitaddr tableau's cyclic
      convolution (25 rows, padding 4,096) reaches;
   l. the field API that no proof path calls (the JAX package's tests
      drive it), at 2^20 elements a call: K1's modes sqr, neg, eq,
      is_zero, select and mul_const at every instance and its new
      instances fp24, fp64, p256n, p256k1n, and add at gf2_128; K21 (the
      inverse) at every instance; K5's modes; K22 (Fp24_6) in every mode;
      K2 and K3 [fp24]; each also against the host ints at 64 sampled
      elements, the inverses (checked and timed at 2^16 elements, then
      held to the identities at 2^20) as inv(a) a = 1 and inv(0) = 0, eq,
      is_zero and select (and GF(2^128)'s add and neg) beside one PyTorch
      call (library ms: torch.all, torch.where, torch.bitwise_xor,
      torch.clone), timed as the kernel's row is (cold where it is); K1
      [fp24] (four elements a thread) in every mode against its plain
      version where its paths split (n = 0, 1, 3, 127, 129, 65541; b
      full, one element, a row; the conditions full, a row, a column;
      operands at an offset, not 16-byte aligned); then a CUDA tensor of
      a field or mode without a kernel must raise;
   m. K9 at each proof's Ligero finish (the SHA-256, ECDSA, mdoc hash,
      mdoc signature and bitaddr proofs' ZkProver.param), from random
      states: its four response writes held to the host Transcript and
      timed against the chain of their compressions (printed), the
      y_quad[:r] write as row "fs_oracle[<tag>] <proof> responses" and
      its squeeze and samples as row "... draw", each against its plain
      version and its chain;
      K1 [fp256]'s bind, hv and bind_hv at the mdoc signature circuit's
      largest layer (rows "fp_elementwise[fp256] bind", "... hv", "...
      bind_hv");
   n. K23 (layer_hv, the layer prologue) at every layer of the SHA-256,
      mdoc signature, ECDSA, mdoc hash and bitaddr circuits, in the order
      of their wire rounds, 1 and 8 lanes, against its plain version; a
      row "layer_hv[<tag>]" at the largest layer of the SHA-256, mdoc
      signature, mdoc hash and bitaddr circuits, with one index_select
      of dot by g as its library call.
4. Drives the port's three prover paths, each with the launch counts set
   to zero just before it and read just after (every kernel instance of
   the path must have launched, K8-K12 included), its bytes under
   DeterministicEngine held against the golden proof in
   longfellow_zk_tpu_torch/testdata, the host transcript's state after
   each ZkProver.prove held against testdata/transcript_states.json, and
   its device chain, from the
   sumcheck's first round to the one fetch (the rounds, the constraints,
   the Ligero finish), under torch.cuda.set_sync_debug_mode("error")
   (any host synchronisation there fails the run); each proof's profile
   ends with a line of its device ms and launches a port kernel, the
   sums that rank the kernels for redesign, and the same by wrapper
   instance (K1's and K9's kernels of every mode together):
   a. the Fp128 SHA-256 one-block proof (the JAX package's bytes);
   b. the batched SHA-256 proofs (B = 8, zk/batch.py BatchZkProver, as
      bench.py's phase_sha_batch): lane 0 the golden's witness and tag,
      lanes 1-7 the messages msg0001..msg0007 under the tags
      bench1..bench7; lane 0 held to the golden, every lane to the scalar
      proof with its tag and the continued stream and to its final
      transcript state, the batch's launches to one scalar proof's, every
      lane verified; then 5 batches timed in turns with 5 runs of 8 scalar
      proofs (zk_sha256_batch8_per_proof_ms, ..._proofs_per_s, the
      phases), one profiled (3 device-to-host copies);
   c. the P-256 ECDSA signature proof (the JAX package's bytes);
   d. a batch of 2 ECDSA proofs, lane 0 the golden's (K4 [fp256x2] and K5
      on stacked lanes), held as in b, not timed;
   e. the mdoc presentation through circuits/mdoc/api.run_mdoc_prover
      (the GF(2^128) hash proof and the P-256 signature proof; the bytes
      of the port's CPU path, which the JAX verifier accepts);
   f. the secp256k1 bitaddr proof (a Bitcoin address's key, the circuit
      artifacts/bitaddr_p256k1.lfc1.gz) with the CRT Reed-Solomon code
      (K13-K15, K4 [crt]; the bytes of the port's CPU path, which the JAX
      verifier accepts).
   Then 5 more proofs under SecureRandomEngine() are timed (median), one
   is profiled on the host (cProfile, with its count of host field
   products) and one on the card (busy share, device-to-host and
   host-to-device copies).
   g. the plain sumcheck (SumcheckProver.prove_with_witness, no ZK) over
      the SHA-256 circuit with 64 copies: copy 0 the message b"abc",
      copy c the message msg000c (c = 1..63); the proof (every field
      element, the bindings and the final transcript state) held against
      testdata/sumcheck_sha256_copies64.json, 60 launches each of K16
      and K10's cubic mode, the rounds under the sync check; the port's
      verify accepts it and refuses a flip in a copy round's p(0) and one
      in a wc; 5 proofs and 5 verifications timed
      (sumcheck_sha256_copies64_prove_ms, ..._verify_ms), the device ms
      of the copy rounds against the wire rounds;
   h-j. the SHA-256, ECDSA and bitaddr proofs again, each with its
      Reed-Solomon code through another transform (rs_factory_with):
      the matmul NTT (K17 launched, K4 [fp128] not), the half-complex
      RFFT (K18 and K4 [fp256x2], K5 not) and Nussbaumer (K19 and K20,
      K13-K15 and K4 [crt] not); each held, as above, to the same golden
      bytes and transcript states under the sync check and timed, and
      the port's ZkVerifier with the same factory accepts the golden and
      refuses a one-bit flip;
   k. bench.py's phase_fft on its own inputs (np.random.default_rng(0)):
      fft_fp128_2e20_ms (MatmulNTT.fftb, held to K4's NTT.fftb, timed
      beside it), fft_fp256x2_2e20_ms (K4 [fp256x2], fftf(fftb(x)) = n x,
      two outputs against a host evaluation) and
      rs_encode_fp128_2e16_x3_ms (ReedSolomon(2^16, 3 2^16) through K4,
      held to the MatmulNTT route and at 4 points to a host barycentric
      evaluation), each a median of 5 between CUDA events.
   l. the last one-card instances, each against its plain version on
      the card as in section 3: the field API at P-384 and P-521 (K1's
      modes at 2^20 elements, K21 at 2^16; K1 [p521], a tile of elements
      a block, also at the split shapes of 3l), K2 and K3 at Goldilocks, the
      P-256 and secp256k1 orders, P-384 and P-521 (2^20 terms, a quarter
      p - 1), K13 and K15 at the P-256 order, the P-256 base field,
      P-384 and P-521, K4 [crt] and K14 at 26 and 35 lanes (the bitaddr
      tableau, 25 x 4,096), K19 and K20 over Fp2 (the ECDSA tableau, 14 x
      2,048; rows "... vs=26" and "... vs=35" for the lanes); then the
      path: rs_factory_for(F)(682, 4096).interpolate on 25 rows (the
      bitaddr commit's encode) over the P-256 order, P-384 and P-521,
      the launch counts zeroed before and read after each, held to the
      same call on the plain route on the card and at 8 points of 2 rows
      to host barycentric Lagrange, crt_rs_encode_<field>_ms timed; and
      the ECDSA proof with its Reed-Solomon code through the CRT
      convolution over the P-256 base field (K13, K15 [fp256], K4 [crt]
      and K14 launched, K4 [fp256x2] and K5 not) held to the golden bytes
      and states under the sync check, timed, its verifier with the same
      factory accepting the golden and refusing a flip.
   m. the multi-card paths (longfellow_zk_tpu_torch/parallel/smoke.py)
      at world = torch.cuda.device_count(), one process a card through
      parallel/launch.spawn and NCCL between them (one rank on one card:
      every sharded code path and collective call still runs): the
      sharded NTT at 2^20, the plain sumcheck over the SHA-256 circuit x
      64 copies with the copies sharded, ZkProver with the tableau rows
      sharded on the SHA-256, ECDSA and bitaddr goldens, BatchZkProver
      with the lanes sharded (8 SHA-256 lanes) and sharded_rs_encode,
      each exact against its golden and its one-card run, the launch
      counts of each set to zero just before it and read just after
      (every kernel of its path launched), timed beside the one-card run.
5. Drives the port's three verifier paths on those golden proofs, each
   with the launch counts set to zero just before the first verification
   and read just after (it must accept, K7 and the path's other kernels
   must have launched, and the transcript's state after each
   ZkVerifier.verify must be the committed one), then on a copy with one
   bit flipped (it
   must refuse); then times 5 verifications and profiles them as above:
   a. ZkVerifier on the SHA-256 proof; b. ZkVerifier on the ECDSA proof;
   c. circuits/mdoc/api.run_mdoc_verifier on the mdoc proof; d.
   ZkVerifier on the bitaddr proof.
6. Prints the kernels line, the card line and, last, the result line.

Any failure exits non-zero before the result line.  Imports no JAX.
"""

import copy
import dataclasses
import gc
import gzip
import hashlib
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time
import typing

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
TESTDATA = os.path.join(REPO, "longfellow_zk_tpu_torch", "testdata")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
T0 = time.perf_counter()       # the script's start, for the "at" stamps
# 32-bit integer multiplies: 64 INT32 lanes per SM (half the 128 FP32
# lanes behind the data sheet's 67 TFLOP/s float32, which counts an FMA
# as 2)
INT32_OPS_PER_S = 67e12 / 4
# 32x32->64 products per field product: 2 N^2 for N 32-bit words, three
# base products for an Fp2 product, 2 for a one-word Montgomery product
# of the CRT lanes ("crt"); a Montgomery reduction alone (a product by
# 1) N^2 + N (redc_ops) and a product of one word by N words N: the
# conversions of the CRT route.  A GF(2^128) product: no instruction of
# the card computes a carry-less product, so it counts the integer
# multiplies of the cheapest product known here, gf2.cuh's spaced-multiply
# Karatsuba: 9 32 x 32 carry-less products of 16 multiplies each (its
# squares, a spread of the bits, count none).  A product by one element
# that a whole launch or lane shares (K1's bind, hv and products by one
# element) counts instead its reads of that element's table of multiples
# in shared memory (g128_table_ms).
MUL_OPS = {"fp128": 32, "fp256": 128, "fp256k1": 128, "fp256x2": 3 * 128,
           "gf2_128": 9 * 16, "crt": 2, "fp24": 2, "fp64": 8, "p256n": 128,
           "p256k1n": 128, "p384": 2 * 12 ** 2, "p521": 2 * 17 ** 2}
# an Fp24_6 product in K22: 36 word products summed lazily and 6
# one-word Montgomery reductions of 2 multiplies each
FP24X6_MUL_OPS = 36 + 6 * 2
# a GF(2^128) inverse a^(2^128 - 2) by Itoh and Tsujii: 2^127 - 1 in
# floor(log2 127) + popcount(127) - 1 = 12 products (and 127 squares)
G128_INV_PRODUCTS = 12
# K1's table product (csrc/fp_ops.cu k_g128_lane): 16 reads of 16 bytes
# from shared memory a product, at 128 bytes a clock an SM, on the H100
# SXM's 132 SMs at the card's top SM clock (TOP_CLOCK_MHZ, read from
# nvidia-smi by main; 1,980 MHz until then)
G128_TAB_READ_BYTES = 16 * 16
SMEM_BYTES_PER_CLK = 128
N_SM = 132
TOP_CLOCK_MHZ = 1980.0


def g128_table_ms(nprod):
    """The least time of nprod products by one element through its table
    of multiples in shared memory."""
    return nprod * G128_TAB_READ_BYTES / (
        SMEM_BYTES_PER_CLK * N_SM * TOP_CLOCK_MHZ * 1e6) * 1e3


def table_bound(nbytes, nprod):
    """(ms, by) of a call that moves nbytes and makes nprod products by
    one element through the table."""
    tb, tt = bound_ms(nbytes, 0)[0], g128_table_ms(nprod)
    return max(tb, tt), ("bytes" if tb >= tt else "operations")


# 32-bit operations of one SHA-256 compression (K8): 64 rounds of about
# 17 (three funnel-shift rotations and a LOP3 for each sigma, the
# choice, the majority, 7 adds) and 48 schedule words of about 11
SHA_OPS_PER_BLOCK = 64 * 17 + 48 * 11
# K9 and K10 run one thread: the least time is the chain of dependent
# instructions, DEP_CYCLES cycles each at the card's top SM clock (a
# model that charges no memory latency): a SHA-256 compression 6 a
# round, the AES-256 key schedule 2 a word (52 words), an AES block 4 a
# round (14 rounds; the other counter blocks do not depend on it), a
# field product 2 N^2 dependent multiply-adds (GF(2^128): gf2.cuh's 144
# independent multiplies, which one thread starts one a cycle: 36 steps)
DEP_CYCLES = 4
SHA_CHAIN = 64 * 6
AES_KEY_CHAIN = 52 * 2
AES_BLOCK_CHAIN = 14 * 4
PROD_CHAIN = {"fp128": 32, "fp256": 128, "fp256k1": 128,
              "gf2_128": MUL_OPS["gf2_128"] // DEP_CYCLES, "crt": 2}
# K10's GF(2^128) product (csrc/rt_mul.cuh) takes b a byte a step: 16
# dependent steps of about 4 (the shift, the fold, the XOR); its eight
# masked sums a step do not depend on the last


def k10_chain_products(tag, cubic):
    """(products on K10's chain, steps a product): before the absorb the
    copy weight's (a hand-round) and, at a prime field, the natural form
    (its points 0-3 make the Horner steps adds) or, at GF(2^128), the
    Horner steps at x_2; after the draw its Montgomery form (a prime
    field) and the Newton steps."""
    prime = tag != "gf2_128"
    before = (0 if cubic else 1) + (1 if prime else (3 if cubic else 2))
    after = prime + (3 if cubic else 2)
    return before + after, (PROD_CHAIN[tag] if prime else 16 * 4)


def redc_ops(nwords):
    """32x32->64 products of one Montgomery reduction of N words."""
    return nwords * nwords + nwords


def bound_ms(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def layer_hv_bytes(eb, T, nd, lanes):
    """K23's bytes: a lane's hv written (T elements of eb bytes), its
    beta and its dot read once at each of the nd distinct output wires
    that the terms' g name; g (int32), v and bmask read once."""
    return lanes * (T + nd + 1) * eb + T * (4 + eb + 1)


def chain_ms(steps, clock_mhz):
    """The time of `steps` dependent instructions of one thread."""
    return steps * DEP_CYCLES / (clock_mhz * 1e6) * 1e3


class GcClock:
    """A gc.callbacks entry that adds up the ms the interpreter's garbage
    collector runs."""

    def __init__(self):
        self.ms, self._t0 = 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t0) * 1e3


class CallTime(typing.NamedTuple):
    ms: float       # one call, back to back, by CUDA events
    gc_ms: float    # the garbage collector's ms inside the timed loop
    host_ms: float  # the host's ms a call to enqueue the loop


def call_ms(fn, iters, collect=False):
    """CallTime of fn: one call, back to back, by CUDA events (what a
    caller waits for, host-side launch overhead included), the ms that
    the garbage collector held the timed loop and the host's enqueue time
    a call; with collect, gc.collect() first, so that the garbage of the
    measurement itself (the profiler's records) is not collected inside
    the loop."""
    for _ in range(3):
        fn()
    if collect:
        gc.collect()
    torch.cuda.synchronize()
    clock = GcClock()
    gc.callbacks.append(clock)
    try:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        host = (time.perf_counter() - h0) * 1e3 / iters
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(clock)
    return CallTime(t0.elapsed_time(t1) / iters, clock.ms, host)


def kernels_mod():
    """The port's kernels module (imported after the card check)."""
    from longfellow_zk_tpu_torch import kernels
    return kernels


# The profiler loses the first kernel records of a window, more of them
# the longer the process has run and the more it launched outside a
# window (none at first; 5 a window after 80 s in tools/
# profiler_records.py; 10 of 20 late in this script): device_ms opens
# each window with HEAD_PAD sleep kernels, which it loses instead and
# leaves out of the sum.
HEAD_PAD = 256


# the port's kernels (csrc/*.cu: every __global__ function is k_<name>),
# in a record's name demangled or mangled (_Z8k_fp_invI4P256E...)
PORT_KERNEL = re.compile(r"(?:^|[^A-Za-z0-9_]|_Z\d+)k_[a-z0-9_]+")


def _device_records(prof, flushes=0):
    """(kernel ns, records of the port's kernels, copy and fill ns, head
    records) of the device activity in a profiler's raw records; the
    head's sleep kernels (spin_kernel) are counted apart, and the
    `flushes` longest device-to-device copies (the L2 flushes of a cold
    window) left out (None for all four if fewer were kept)."""
    cuda = torch.autograd.DeviceType.CUDA
    kns = nport = other = nhead = 0
    dtod = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        if e.name().startswith("Memcpy DtoD"):
            dtod.append(e.end_ns() - e.start_ns())
        elif e.name().startswith(("Memcpy", "Memset")):
            other += e.end_ns() - e.start_ns()
        elif "spin_kernel" in e.name():
            nhead += 1
        else:
            kns += e.end_ns() - e.start_ns()
            nport += bool(PORT_KERNEL.search(e.name()))
    if len(dtod) < flushes:
        return None, None, None, None
    dtod.sort()
    return kns, nport, other + sum(dtod[:len(dtod) - flushes]), nhead


class Timing(typing.NamedTuple):
    ms: float    # device ms of one call
    by: str      # "profiler" (", cold L2"), or "events" (CUDA events:
    #              host gaps too)
    out: object  # the last call's output


def device_ms(fn, iters, warmup=3, cold=False):
    """The device time of one call of fn: the sum of the device activity
    that the profiler records over `iters` calls (after `warmup` calls
    and a head of HEAD_PAD sleep kernels; where `cold`, each call after
    an L2 flush, whose copy the sum leaves out), divided by `iters`, read
    from the profiler's raw records (its event tree takes seconds to
    build over a plain version's thousands of small ops).  One rule for the
    records: a window must keep a record of its head (so that the loss
    stopped there), a record of one of the port's kernels for each launch
    that its wrappers count (kernels.LAUNCHES; torch's own kernels do not
    stand in for a lost one), and some device activity; one that
    does not is profiled again, up to three times, and then fn is timed
    by CUDA events instead (the median of `iters` calls), which `by` and
    a note say."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    counts = kernels_mod().LAUNCHES
    flush = l2_flush if cold else (lambda: None)
    by = "profiler, cold L2" if cold else "profiler"
    for _ in range(3):
        n0 = sum(counts.values())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(HEAD_PAD):
                torch.cuda._sleep(1)
            for _ in range(iters):
                flush()
                out = fn()
            torch.cuda.synchronize()
        kns, nport, other, nhead = _device_records(prof,
                                                   iters if cold else 0)
        launches = sum(counts.values()) - n0
        if nhead and nport >= launches and kns + other > 0:
            return Timing((kns + other) / 1e6 / iters, by, out)
        print("  (the profiler kept %s of %d head records and %s records "
              "of the port's kernels of a window of %d launches: again)"
              % (nhead, HEAD_PAD, nport, launches))
    print("  (the profiler missed records three times: CUDA events, %d "
          "calls)" % iters)
    ms, _ = event_ms(fn, iters, warmup=0)
    return Timing(ms, "events", fn())


# A window of back-to-back calls on the same inputs finds in the 50 MB
# L2 what the last call left there, so a call on less than about twice
# that can read faster than HBM delivers: a row whose device time falls
# below its bound (which reads every input from HBM) is profiled again
# with the L2 flushed before each call (device_ms(cold=True)).
FLUSH_BYTES = 1 << 28
_FLUSH = []


def l2_flush():
    """A device-to-device copy of FLUSH_BYTES / 2 bytes, which reads and
    writes FLUSH_BYTES, five times the L2."""
    if not _FLUSH:
        _FLUSH.extend(torch.empty(FLUSH_BYTES // 2, dtype=torch.uint8,
                                  device="cuda") for _ in range(2))
    _FLUSH[1].copy_(_FLUSH[0])


def event_ms(fn, reps=5, warmup=1):
    """(median, all) of `reps` calls of fn, each synchronised and timed
    between CUDA events, after `warmup` calls."""
    for _ in range(warmup):
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
    return statistics.median(ms), ms


def max_err(a, b):
    torch.cuda.synchronize()
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


class Rows:
    """The kernels line: one row per kernel instance."""

    def __init__(self):
        self.rows = {}
        self.failures = []
        self.below_bound = []  # rows still below their bound when cold

    def record(self, kname, source, replaces, err, fn, plain_fn, nbytes,
               ops, bound=None, plain=None, library_fn=None, iters=50):
        """bound: (ms, "operations") where the bound is not the bytes or
        operations over the card's rates (a one-thread chain); plain: the
        plain version's Timing where the check already took it (plain_fn
        is then not run); library_fn: one PyTorch call that computes the
        same function (library_ms)."""
        b, by = bound or bound_ms(nbytes, ops)
        k = device_ms(fn, iters)
        if k.ms < b:
            cold = device_ms(fn, iters, cold=True)
            print("  (%s: device %.5f ms below its bound %.5f ms back to "
                  "back; %.5f ms (%s) with the L2 flushed before each "
                  "call)" % (kname, k.ms, b, cold.ms, cold.by))
            k = cold
            if k.ms < b:
                self.below_bound.append(kname)
                k = k._replace(by=k.by + ", below its bound: unverified")
        # the plain versions run thousands of small ops (one lane after
        # another for K9 and K10): one profiled call (the check just
        # before warmed it)
        plain = plain or device_ms(plain_fn, 1, warmup=0)
        # the library call timed as the kernel's row was: cold where the
        # row is (its warm time printed beside)
        lib = None
        if library_fn is not None:
            lib = device_ms(library_fn, iters)
            if "cold" in k.by:
                print("  (%s: library %.5f ms back to back)"
                      % (kname, lib.ms))
                lib = device_ms(library_fn, iters, cold=True)
        first = call_ms(fn, 4 * iters)
        row = dict(name=kname, route="cuda", source=source,
                   replaces=replaces, launches=0, max_abs_err=err, ms=k.ms,
                   plain_ms=plain.ms, bound_ms=b, bound_by=by,
                   library_ms=None if lib is None else lib.ms,
                   call_ms=first.ms, ms_by=k.by, plain_ms_by=plain.by)
        if first.gc_ms > 0 or first.ms > 3 * k.ms + 0.1:
            # a call far above its device time, or a loop that the
            # garbage collector held: timed again after a collection, with
            # the caching allocator's cudaMalloc and retry counts; where
            # the collector held the first loop, the row keeps the second
            s0 = torch.cuda.memory_stats()
            again = call_ms(fn, 4 * iters, collect=True)
            s1 = torch.cuda.memory_stats()
            print("  (%s: call %.5f ms, the garbage collector %.3f ms of its "
                  "loop, host %.5f ms a call; after a collection %.5f ms "
                  "(%.3f, host %.5f); %d cudaMalloc, %d retries; %.1f GB "
                  "reserved)"
                  % (kname, first.ms, first.gc_ms, first.host_ms, again.ms,
                     again.gc_ms, again.host_ms,
                     s1.get("num_device_alloc", 0) -
                     s0.get("num_device_alloc", 0),
                     s1.get("num_alloc_retries", 0) -
                     s0.get("num_alloc_retries", 0),
                     torch.cuda.memory_reserved() / 1e9))
            if first.gc_ms > 0:
                row.update(call_ms=again.ms, call_ms_first=first.ms,
                           call_gc_ms=first.gc_ms)
        if lib is not None:
            row["library_ms_by"] = lib.by
        self.rows[kname] = row
        print("kernel %-24s max_abs_err %d (tolerance 0)  device %.5f ms "
              "(call %.5f ms)  plain %.4f ms  bound %.5f ms (%s)%s  "
              "[at %.0f s]"
              % (kname, err, k.ms, row["call_ms"], plain.ms, b, by,
                 "" if lib is None else "  library %.5f ms" % lib.ms,
                 time.perf_counter() - T0))
        if err != 0:
            self.failures.append(kname)


def elts_of(F, rng, dev):
    """elts(n): n random elements of field F on the card."""
    def elts(n):
        if F.kCharacteristicTwo:
            return torch.as_tensor(
                rng.integers(-2**31, 2**31, (n, 4), dtype=np.int32),
                device=dev)
        return F.to_limbs([int.from_bytes(rng.bytes(4 * F.nlimb), "little")
                           % F.p for _ in range(n)], dev)
    return elts


def bulk_elts(F, rng, dev):
    """elts(n): n random canonical elements of F on the card, made in
    bulk: uniform words, the top one below p's top word (GF(2^128): any
    words)."""
    N = F.nlimb
    ptop = None if F.kCharacteristicTwo else F.p >> (32 * (N - 1))

    def elts(m):
        w = rng.integers(0, 1 << 32, (m, N), dtype=np.uint64)
        if ptop is not None:
            w[:, -1] %= ptop
        return torch.as_tensor(w.astype(np.uint32).view(np.int32),
                               device=dev)
    return elts


def check_fp_kernels(rows, F, circ, dev, tag, k1_n, k1_table, rng,
                     dblock=681):
    """K1-K3 of field F (instance `tag`) against their plain versions at
    the shapes of circuit `circ`: K1 at k1_n elements (a wire round) and
    at the tableau k1_table = (rows, n); K2 and K3 at the largest layer;
    the Ligero row sums at (rows, dblock)."""
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.sumcheck.prover import (
        SumcheckProver, quad_tensors)

    pm = fpm.plain_of(F)
    mops, eb = MUL_OPS[tag], 4 * F.nlimb
    elts = elts_of(F, rng, dev)
    err = 0
    for n in sorted({k1_n, k1_table[0] * k1_table[1]}):
        a, b, r = elts(n), elts(n), elts(1)[0]
        h = torch.as_tensor(rng.integers(0, 1 << 15, n, dtype=np.int32),
                            device=dev)
        for mode in (fpm.MUL, fpm.ADD, fpm.SUB):
            err = max(err, max_err(fpm.fp_elementwise(F, mode, a, b),
                                   pm.elementwise_plain(F, mode, a, b)))
        err = max(err, max_err(F.bind(a, r),
                               pm.elementwise_plain(F, fpm.BIND, a, r)))
        err = max(err, max_err(F.hv_update(a, h, r),
                               pm.elementwise_plain(F, fpm.HV, a, r, h)))
    nt = k1_table[0] * k1_table[1]
    b_tab = elts(nt).reshape(k1_table + (F.nlimb,))
    print("K1[%s] mul at %d x %d: device %.5f ms, bound %.5f ms" % (
        tag, k1_table[0], k1_table[1],
        device_ms(lambda: F.mul(b_tab, b_tab), 50).ms,
        bound_ms(3 * eb * nt, mops * nt)[0]))
    a, b = elts(k1_n), elts(k1_n)
    rows.record("fp_elementwise[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/fp_ops.cu",
                "longfellow_zk_tpu/fields/fp.py:277", err,
                lambda: F.mul(a, b),
                lambda: pm.elementwise_plain(F, fpm.MUL, a, b),
                3 * eb * k1_n, mops * k1_n)

    ly = max(range(circ.nl), key=lambda i: circ.layers[i].nterms)
    layer = circ.layers[ly]
    sp = SumcheckProver(F, dev)
    qd = quad_tensors(F, layer.quad, dev)
    nv = circ.layers[ly - 1].nw if ly > 0 else circ.nv
    starts, ends = sp._segments(layer.quad, nv)
    T = layer.nterms
    W = elts(layer.nw)
    print("K2/K3[%s] at layer %d: %d terms, nw %d, logw %d"
          % (tag, ly, T, layer.nw, layer.logw))
    V, ok = fpm.fp_eval_layer(F, W, qd["h0"], qd["h1"], qd["v"], qd["bmask"],
                              starts, ends)
    V2, ok2 = pm.eval_layer_plain(F, W, qd["h0"], qd["h1"], qd["v"],
                                   qd["bmask"], starts, ends)
    err = max_err(V, V2) + int(bool(ok) != bool(ok2))
    x = elts(T)
    err = max(err, max_err(F.lazy_segment_sum(x, starts, ends),
                           pm.segment_sum_plain(F, x, starts, ends)))
    # a product a term, and one more where the term's v is not one
    v_one = int((qd["v"] == F.to_limbs(1, dev)).all(-1).sum())
    rows.record("fp_segment_sum[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/segsum.cu",
                "longfellow_zk_tpu/sumcheck/prover_device.py:372", err,
                lambda: fpm.fp_eval_layer(
                    F, W, qd["h0"], qd["h1"], qd["v"], qd["bmask"], starts,
                    ends),
                lambda: pm.eval_layer_plain(
                    F, W, qd["h0"], qd["h1"], qd["v"], qd["bmask"], starts,
                    ends),
                T * (eb + 4 + 4 + 1) + eb * layer.nw + nv * (eb + 8) + 4,
                mops * (2 * T - v_one))

    N = 1 << layer.logw
    hv, Wh, Wo = elts(T), elts(N), elts(N)
    h0, h1 = qd["h0"], qd["h1"]
    err = max_err(fpm.fp_wire_sums(F, hv, Wh, Wo, h0, h1),
                  pm.wire_sums_plain(F, hv, Wh, Wo, h0, h1))
    err = max(err, check_k3_shapes(F, tag, dev, rng))
    err = max(err, max_err(F.lazy_sum(hv, 0), pm.axis_sum_plain(F, hv, 0)))
    # the Ligero row sums: the tableau's rows over the dblock width
    rws = elts(k1_table[0] * dblock).reshape(k1_table[0], dblock, F.nlimb)
    err = max(err, max_err(F.lazy_sum(rws, 0),
                           pm.axis_sum_plain(F, rws, 0)))
    n_even = int((h0 & 1).eq(0).sum())
    rows.record("fp_wire_round[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/wire_round.cu",
                "longfellow_zk_tpu/sumcheck/prover_device.py:571", err,
                lambda: fpm.fp_wire_sums(F, hv, Wh, Wo, h0, h1),
                lambda: pm.wire_sums_plain(F, hv, Wh, Wo, h0, h1),
                T * (eb + 4 + 4) + 2 * eb * N + 2 * eb,
                mops * (2 * T + n_even))


# the mdoc hash circuit's layers whose K2 launches the proof's K2 time
# is made of: mode 1 (the evaluation) at each, mode 0 (the term-merge
# folds) at the merge plan's stages of layer 18, whose first stage holds
# a segment of 525,422 terms
K2_MDOC_LAYERS = (17, 18, 20)
K2_MDOC_FOLDS = 18


def check_k2_mdoc(rows, F, circ, dev, rng):
    """K2 [gf2_128] at the mdoc hash circuit's shapes: rows "fp_segment_sum
    [gf2_128] eval layer L" (mode 1) and "... fold layer 18 stage S" (mode
    0 over the plan's segments), each against its plain version.  Bound:
    the bytes, or the products of mode 1 (one a term, and one more where
    the term's v is not one)."""
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.sumcheck.prover import (
        SumcheckProver, quad_tensors)

    pm = fpm.plain_of(F)
    eb = 4 * F.nlimb
    elts = elts_of(F, rng, dev)
    sp = SumcheckProver(F, dev)
    src = "longfellow_zk_tpu_torch/csrc/segsum.cu"
    for ly in K2_MDOC_LAYERS:
        layer = circ.layers[ly]
        nv = circ.layers[ly - 1].nw if ly > 0 else circ.nv
        qd = quad_tensors(F, layer.quad, dev)
        starts, ends = sp._segments(layer.quad, nv)
        T = layer.nterms
        args = (elts(layer.nw), qd["h0"], qd["h1"], qd["v"], qd["bmask"],
                starts, ends)
        V, ok = fpm.fp_eval_layer(F, *args)
        V2, ok2 = pm.eval_layer_plain(F, *args)
        v_one = int((qd["v"] == F.to_limbs(1, dev)).all(-1).sum())
        print("K2[gf2_128] eval layer %d: %d terms, %d segments (longest "
              "%d), v one at %d terms" % (
                  ly, T, nv, int((ends - starts).max()), v_one))
        rows.record("fp_segment_sum[gf2_128] eval layer %d" % ly, src,
                    "longfellow_zk_tpu/sumcheck/prover_device.py:383",
                    max_err(V, V2) + int(bool(ok) != bool(ok2)),
                    lambda: fpm.fp_eval_layer(F, *args),
                    lambda: pm.eval_layer_plain(F, *args),
                    T * (eb + 4 + 4 + 1) + eb * layer.nw + nv * (eb + 8) + 4,
                    MUL_OPS["gf2_128"] * (2 * T - v_one), iters=20)
        if ly != K2_MDOC_FOLDS:
            continue
        plan = sp._wm_for(layer.quad, layer.logw)
        n = T
        for si, ((_, s0, e0, _, _), most) in enumerate(
                zip(plan["stages"], plan["longest"])):
            x = elts(n)
            print("K2[gf2_128] fold layer %d stage %d: %d terms, %d "
                  "segments (longest %d)" % (ly, si, n, len(s0), most))
            rows.record("fp_segment_sum[gf2_128] fold layer %d stage %d"
                        % (ly, si), src,
                        "longfellow_zk_tpu/sumcheck/prover_device.py:167",
                        max_err(F.lazy_segment_sum(x, s0, e0, most),
                                pm.segment_sum_plain(F, x, s0, e0)),
                        lambda x=x, s0=s0, e0=e0, m=most:
                        F.lazy_segment_sum(x, s0, e0, m),
                        lambda x=x, s0=s0, e0=e0: pm.segment_sum_plain(
                            F, x, s0, e0),
                        eb * n + (eb + 8) * len(s0), 0, iters=20)
            n = len(s0)


def check_k1_gf2_mdoc(rows, F, circ, dev, rng):
    """K1 [gf2_128]'s products by one element at the mdoc hash circuit's
    largest layer: rows "fp_elementwise[gf2_128] hv" (its T terms, h its
    terms' h0) and "... bind" (its 2^logw wires to half), each against
    its plain version.  Bound: the bytes, or the table reads of one
    product an output (g128_table_ms)."""
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.sumcheck.prover import quad_tensors

    pm = fpm.plain_of(F)
    elts = elts_of(F, rng, dev)
    ly = max(range(circ.nl), key=lambda i: circ.layers[i].nterms)
    layer = circ.layers[ly]
    T, nw = layer.nterms, 1 << layer.logw
    h = quad_tensors(F, layer.quad, dev)["h0"]
    hv, W, r = elts(T), elts(nw).reshape(1, nw, 4), elts(1)
    print("K1[gf2_128] hv and bind at layer %d: %d terms, %d wires"
          % (ly, T, nw))
    src = "longfellow_zk_tpu_torch/csrc/fp_ops.cu"
    rows.record("fp_elementwise[gf2_128] hv", src,
                "longfellow_zk_tpu/sumcheck/prover_device.py:595",
                max_err(F.hv_update(hv, h, r[0]),
                        pm.elementwise_plain(F, fpm.HV, hv, r[0], h)),
                lambda: F.hv_update(hv, h, r[0]),
                lambda: pm.elementwise_plain(F, fpm.HV, hv, r[0], h),
                36 * T, 0, bound=table_bound(36 * T, T), iters=20)
    rows.record("fp_elementwise[gf2_128] bind", src,
                "longfellow_zk_tpu/sumcheck/prover_device.py:139",
                max_err(F.bind(W, r), pm.elementwise_plain(F, fpm.BIND, W,
                                                           r)),
                lambda: F.bind(W, r),
                lambda: pm.elementwise_plain(F, fpm.BIND, W, r),
                24 * nw, 0, bound=table_bound(24 * nw, nw // 2), iters=20)


def check_ntt(rows, F, ntt, tag, nrows, n, elts):
    """K4 instance `tag` at [nrows, n] against its plain version."""
    from longfellow_zk_tpu_torch.transforms.ntt import fp_ntt, ntt_plain

    eb = 4 * int(np.prod(F.elt_shape))
    xr = elts(nrows * n).reshape((nrows, n) + tuple(F.elt_shape))
    err = 0
    for inverse in (False, True):
        tw = ntt.twiddles(n, inverse)
        err = max(err, max_err(fp_ntt(F, xr, tw), ntt_plain(F, xr, tw)))
    logn = n.bit_length() - 1
    rows.record("fp_ntt[%s]" % tag, "longfellow_zk_tpu_torch/csrc/ntt.cu",
                "longfellow_zk_tpu/transforms/ntt.py:94", err,
                lambda: fp_ntt(F, xr, tw),
                lambda: ntt_plain(F, xr, tw),
                2 * eb * nrows * n + eb * (n - 1),
                MUL_OPS[tag] * nrows * (n // 2) * (logn - 1))


def check_crt(rows, F, dev, nrows, m, rng, tag="fp256k1", lanes=""):
    """The CRT Reed-Solomon kernels of target field F (instance `tag`) at
    a tableau of nrows rows of m points (the bitaddr proof's): K13 on
    nrows x m elements, K4 [crt] on the VS lanes of each row, K14 by a
    per-lane table broadcast over the rows (the convolution's product),
    K15 back; each against its plain version.  The K4 and K14 rows are
    named with the suffix `lanes` ("" at secp256k1; " vs=26" at P-384),
    and left out where lanes is None (a basis that another field's rows
    time)."""
    from longfellow_zk_tpu_torch.fields import multiprime as mpm
    from longfellow_zk_tpu_torch.transforms import crt_conv

    ctx = crt_conv.CRTContext(F, device=dev)
    mp = ctx.mp
    vs, n, N = mp.vs, nrows * m, F.nlimb
    x = elts_of(F, rng, dev)(n).reshape(nrows, m, N)
    z = ctx.to_crt(x)
    # each plain version checked and timed in one profiled call
    plain = device_ms(lambda: crt_conv.to_crt_plain(ctx, x), 1, warmup=0)
    err = max(max_err(z, plain.out), max_err(ctx.from_crt(z), x))
    src, crt_py = ("longfellow_zk_tpu_torch/csrc/crt.cu",
                   "longfellow_zk_tpu/transforms/crt_conv.py")
    mops = MUL_OPS["crt"]
    rows.record("crt_to[%s]" % tag, src, crt_py + ":86", err,
                lambda: ctx.to_crt(x), None,
                n * (4 * N + 4 * vs) + 4 * N * vs,
                n * (redc_ops(N) + N * vs * mops), plain=plain)
    tab = mp.to_limbs([np.array([int(rng.integers(0, q)) for q in mp.primes],
                                dtype=object) for _ in range(m)], dev)
    y = mpm.mp_elementwise(mp, mpm.MUL, z, tab)  # residues of no element
    if lanes is not None:
        check_crt_lanes(rows, mp, z, tab, nrows, m, lanes)
    plain = device_ms(lambda: crt_conv.from_crt_plain(ctx, y), 1, warmup=0)
    err = max_err(ctx.from_crt(y), plain.out)
    rows.record("crt_from[%s]" % tag, src, crt_py + ":101", err,
                lambda: ctx.from_crt(y), None,
                n * (4 * vs + 4 * N) + 4 * vs * (vs + N),
                # the natural residues, Garner, then the dot at its
                # least: VS digits times N-word constants, summed before
                # one reduction
                n * (mops * (vs + vs * (vs - 1) // 2) + vs * N +
                     redc_ops(N)), plain=plain)


def check_crt_lanes(rows, mp, z, tab, nrows, m, lanes):
    """K14 and K4 [crt] at VS = mp.vs lanes on the residues z [VS, nrows,
    m, 1] and a per-lane table tab [VS, m, 1]; rows named with the suffix
    `lanes`."""
    from longfellow_zk_tpu_torch.fields import multiprime as mpm
    from longfellow_zk_tpu_torch.transforms.ntt import NTT, fp_ntt, ntt_plain

    dev = z.device
    vs, n, mops = mp.vs, nrows * m, MUL_OPS["crt"]
    src = "longfellow_zk_tpu_torch/csrc/crt.cu"
    err = 0
    for mode in (mpm.MUL, mpm.ADD, mpm.SUB):
        for b in (tab, z):
            err = max(err, max_err(mpm.mp_elementwise(mp, mode, z, b),
                                   mpm.mp_elementwise_plain(mp, mode, z, b)))
    rows.record("mp_elementwise[crt]" + lanes, src,
                "longfellow_zk_tpu/fields/multiprime.py:233", err,
                lambda: mp.mul(z, tab),
                lambda: mpm.mp_elementwise_plain(mp, mpm.MUL, z, tab),
                4 * (2 * vs * n + vs * m), mops * vs * n)
    ntt = NTT(mp, mp.omegas, mp.omega_order, dev)
    zr = z.reshape(vs * nrows, m, 1)
    err = 0
    for inverse in (False, True):
        tw = ntt.twiddles(m, inverse)
        err = max(err, max_err(fp_ntt(mp, zr, tw), ntt_plain(mp, zr, tw)))
    logm = m.bit_length() - 1
    rows.record("fp_ntt[crt]" + lanes, "longfellow_zk_tpu_torch/csrc/ntt.cu",
                "longfellow_zk_tpu/transforms/ntt.py:94", err,
                lambda: fp_ntt(mp, zr, tw), lambda: ntt_plain(mp, zr, tw),
                2 * 4 * vs * n + 4 * vs * (m - 1),
                mops * vs * nrows * (m // 2) * (logm - 1))


def check_lch14(rows, F, dev, nrows, m, rng):
    """K6 at the hash tableau: nrows rows extended from 461 (block) and
    921 (dblock) values to m (block_enc), against its plain version."""
    from longfellow_zk_tpu_torch.transforms import lch14

    elts = elts_of(F, rng, dev)
    err, cases = 0, []
    for n in (461, 921):
        rs = lch14.LCH14ReedSolomon(n, m, F, dev)
        y = elts(nrows * n).reshape(nrows, n, 4)
        err = max(err, max_err(rs.interpolate(y), lch14.lch14_plain(
            F, lch14.EXTEND, y, rs.sched, m)))
        cases.append((n, rs, y))
    for n, rs, y in cases:
        sched = rs.sched
        nbf = sched.bf.shape[0]
        nbytes = 16 * nrows * (n + m) + sched.bf.numel() * 4 + \
            sched.tw.numel() * 4 + sched.passes.numel() * 4
        ops = MUL_OPS["gf2_128"] * nbf * nrows  # a product a butterfly
        print("K6[gf2_128] (%d, %d) x %d rows: %d butterflies a row in %d "
              "passes, device %.5f ms, bound %.5f ms (%s)" % (
                  n, m, nrows, nbf, sched.passes.shape[0],
                  device_ms(lambda: rs.interpolate(y), 20).ms,
                  *bound_ms(nbytes, ops)))
        if n == 461:
            rows.record("gf2_lch14[gf2_128]",
                        "longfellow_zk_tpu_torch/csrc/lch14.cu",
                        "longfellow_zk_tpu/transforms/lch14.py:298", err,
                        lambda: rs.interpolate(y),
                        lambda: lch14.lch14_plain(F, lch14.EXTEND, y,
                                                  rs.sched, m),
                        nbytes, ops)


def check_quad_bind(rows, F, circ, dev, tag, rng):
    """K7 instance `tag` against its plain version at the largest layer of
    `circ`: its uploaded terms, random EQ tables of the layer's widths
    and a random beta."""
    from longfellow_zk_tpu_torch.sumcheck import verifier as vm
    from longfellow_zk_tpu_torch.sumcheck.prover import quad_tensors

    ly = max(range(circ.nl), key=lambda i: circ.layers[i].nterms)
    layer = circ.layers[ly]
    logv = circ.layers[ly - 1].logw if ly > 0 else circ.logv
    nv, nw, T = 1 << logv, 1 << layer.logw, layer.nterms
    qd = quad_tensors(F, layer.quad, dev)
    elts = elts_of(F, rng, dev)
    args = (qd["g"], qd["h0"], qd["h1"], qd["v"], qd["bmask"], elts(nv),
            elts(nw), elts(nw), elts(1)[0])
    err = max_err(vm.fp_quad_bind(F, *args), vm.quad_bind_plain(F, *args))
    print("K7[%s] at layer %d: %d terms (%d beta-masked), logv %d, logw %d"
          % (tag, ly, T, int(qd["bmask"].sum()), logv, layer.logw))
    eb = 4 * F.nlimb
    rows.record("fp_quad_bind[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/quad_bind.cu",
                "longfellow_zk_tpu/sumcheck/verifier.py:55", err,
                lambda: vm.fp_quad_bind(F, *args),
                lambda: vm.quad_bind_plain(F, *args),
                T * (8 + 4 + 4 + 1 + eb) + (nv + 2 * nw + 2) * eb,
                3 * MUL_OPS[tag] * T)


def check_sha256(rows, dev, rng, shapes):
    """K8 against its plain version on each (label, n, mlen) of shapes
    and on the Merkle heap of the first; the row is timed on the first
    (the mdoc hash commit's leaves)."""
    from longfellow_zk_tpu_torch.merkle.merkle_dev import merkle_heap
    from longfellow_zk_tpu_torch.merkle.sha256_dev import (
        padded_len, sha256_msgs, sha256_msgs_plain)

    err, cases = 0, []
    for label, n, mlen in shapes:
        m = torch.as_tensor(rng.integers(0, 256, (n, mlen), dtype=np.uint8),
                            device=dev)
        err = max(err, max_err(sha256_msgs(m), sha256_msgs_plain(m)))
        cases.append((label, m))
    leaves = sha256_msgs(cases[0][1])
    heap = merkle_heap(leaves)
    # the heap against the plain version, level by level
    heap2 = heap.clone()
    n, hi = leaves.shape[0], leaves.shape[0]
    while hi > 1:
        lo = (hi + 1) // 2
        heap2[lo:hi] = sha256_msgs_plain(heap2[2 * lo : 2 * hi].reshape(
            hi - lo, 64))
        hi = lo
    err = max(err, max_err(heap, heap2))
    print("K8 heap of %d leaves: %d levels, device %.5f ms" % (
        n, (n - 1).bit_length(),
        device_ms(lambda: merkle_heap(leaves), 20).ms))
    for label, m in cases:
        n, mlen = m.shape
        blocks = n * (padded_len(mlen) // 64)
        b, by = bound_ms(n * (mlen + 32), SHA_OPS_PER_BLOCK * blocks)
        print("K8 %s: %d x %d bytes (%d blocks), device %.5f ms, bound "
              "%.5f ms (%s)" % (label, n, mlen, blocks,
                                device_ms(lambda: sha256_msgs(m), 20).ms, b,
                                by))
    m = cases[0][1]
    n, mlen = m.shape
    rows.record("sha256_msgs[bytes]", "longfellow_zk_tpu_torch/csrc/sha256.cu",
                "longfellow_zk_tpu/merkle/sha256_jax.py:41", err,
                lambda: sha256_msgs(m), lambda: sha256_msgs_plain(m),
                n * (mlen + 32),
                SHA_OPS_PER_BLOCK * n * (padded_len(mlen) // 64))


def _fs_states(F, rng, dev):
    """A random host transcript state on the card, twice."""
    from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript

    ts = Transcript(rng.bytes(5))
    ts.write_bytes(rng.bytes(int(rng.integers(0, 200))))
    fs = dfs.fs_init_from_host(ts, dev)
    return fs, fs.clone()


def _fs_off(fs):
    return int.from_bytes(bytes(fs[32:40].cpu().tolist()), "little") % 64


def check_fs_oracle(rows, F, dev, tag, rng, clock_mhz):
    """K9 instance `tag`, every mode, against the plain versions from
    random states (whole states compared), at absorb lengths that cross
    the 55/56/64-byte boundaries; the row is timed on a layer's alpha
    and beta (a squeeze and two samples)."""
    from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs

    elts = elts_of(F, rng, dev)
    err = 0
    same = max_err
    for n in (1, 7, 55, 56, 57, 63, 64, 65, 130):
        fs, fs2 = _fs_states(F, rng, dev)
        data = torch.as_tensor(rng.integers(0, 256, n, dtype=np.uint8),
                               device=dev)
        dfs.fs_absorb(F, fs, data)
        dfs.fs_absorb_plain(F, fs2, data)
        err = max(err, same(fs, fs2),
                  same(dfs.fs_getkey(F, fs), dfs.fs_getkey_plain(F, fs2)))
        xs = elts(n % 9 + 1)
        dfs.fs_write_elts(F, fs, xs)
        dfs.fs_write_elts_plain(F, fs2, xs)
        dfs.write_tagged_elts(F, fs, xs)
        dfs.write_tagged_elts_plain(F, fs2, xs)
        prf, prf2 = dfs.new_prf(dev), dfs.new_prf(dev)
        dfs.fs_squeeze(F, fs, prf)
        dfs.fs_squeeze_plain(F, fs2, prf2)
        err = max(err, same(fs, fs2), same(prf, prf2),
                  same(dfs.prf_bytes(F, prf, n),
                       dfs.prf_bytes_plain(F, prf2, n)),
                  same(dfs.dev_sample_elts(F, prf, 40),
                       dfs.dev_sample_elts_plain(F, prf2, 40)))
        out = dfs.dev_sample_elts(F, prf, 3, fs=fs)
        dfs.fs_squeeze_plain(F, fs2, prf2)
        err = max(err, same(out, dfs.dev_sample_elts_plain(F, prf2, 3)),
                  same(prf, prf2))
        key = dfs.fs_getkey(F, fs)
        dfs.prf_fresh(F, prf, key)
        dfs.prf_fresh_plain(F, prf2, key)
        err = max(err, same(prf, prf2))

    fs, fs2 = _fs_states(F, rng, dev)
    prf, prf2 = dfs.new_prf(dev), dfs.new_prf(dev)
    def begin():
        return dfs.dev_sample_elts(F, prf, 80, fs=fs)

    print("K9[%s] begin_circuit (a squeeze and 80 samples): device %.5f ms "
          "(call %.5f ms)" % (tag, device_ms(begin, 20).ms,
                              call_ms(begin, 50).ms))

    def plain():
        dfs.fs_squeeze_plain(F, fs2, prf2)
        return dfs.dev_sample_elts_plain(F, prf2, 2)

    def kernel():
        return dfs.dev_sample_elts(F, prf, 2, fs=fs)

    kernel()
    nblocks = int.from_bytes(bytes(prf[256:264].cpu().tolist()), "little")
    steps = (1 + (_fs_off(fs) >= 56)) * SHA_CHAIN + AES_KEY_CHAIN + \
        AES_BLOCK_CHAIN + (0 if F.kCharacteristicTwo else PROD_CHAIN[tag])
    print("K9[%s] chain of a squeeze and 2 samples: %d steps (%d AES "
          "blocks in all)" % (tag, steps, nblocks))
    rows.record("fs_oracle[%s]" % tag, "longfellow_zk_tpu_torch/csrc/fs.cu",
                "longfellow_zk_tpu/random_oracle/device_fs.py:339", err,
                kernel, plain, 0, 0,
                bound=(chain_ms(steps, clock_mhz), "operations"))


def check_k9_ligero(rows, F, tag, label, zp, dev, rng, clock_mhz):
    """K9 [tag] at a proof's Ligero finish (zk/fused.py ligero_finish_dev,
    zp its ZkProver), from random states: its four response writes
    (y_ldt, y_dot, y_quad[:r], y_quad[block:dblock], an array each), each
    held to the host Transcript and timed against the chain of its
    compressions (a conversion too: fs.cu), printed; row "fs_oracle[tag]
    <label> responses" is the y_quad[:r] write (the smallest: the plain
    version takes about 55 ms a SHA-256 block on the card, minutes for
    the four), against its plain version, which is checked and timed in
    one call between CUDA events; row "... draw", its squeeze and samples
    (u_ldt, alphal, alphaq, u_quad: one launch) against its plain version
    (whole states compared) and the chain of the squeeze's compressions
    and key schedule."""
    from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
    from longfellow_zk_tpu_torch.zk import fused

    p = zp.param
    stat = fused.fused_static(zp.circ, p, zp.lqc, zp.n_witness)
    elts = elts_of(F, rng, dev)
    prod = 0 if F.kCharacteristicTwo else PROD_CHAIN[tag]
    src = "longfellow_zk_tpu_torch/csrc/fs.cu"

    def chain(fs, n):
        nblk = (_fs_off(fs) + 9 + n * F.kBytes) // 64
        return nblk, chain_ms(nblk * SHA_CHAIN + prod, clock_mhz)

    err, out = 0, []
    for n in (p.block, p.dblock, p.r, p.dblock - p.block):
        fs, _ = _fs_states(F, rng, dev)
        ts = Transcript(b"")
        dfs.fs_state_to_host(ts, fs.cpu())
        y = elts(n)
        nblk, bound = chain(fs, n)
        dfs.fs_write_elts(F, fs, y)
        ts.write_elts(list(F.from_limbs(y.cpu())), F)
        err = max(err, int(bytes(fs.cpu().tolist()) != ts.export_state()))
        t = device_ms(lambda: dfs.fs_write_elts(F, fs, y), 20)
        out.append("%d elements %.5f ms (%d blocks, chain %.5f ms, %.2fx)"
                   % (n, t.ms, nblk, bound, t.ms / bound))
    print("K9[%s] %s response writes, held to the host Transcript (%s): %s"
          % (tag, label, "equal" if err == 0 else "DIFFERENT",
             "; ".join(out)))
    y = elts(p.r)
    fs, fs2 = _fs_states(F, rng, dev)
    bound = chain(fs, p.r)[1]
    dfs.fs_write_elts(F, fs, y)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    dfs.fs_write_elts_plain(F, fs2, y)
    t1.record()
    t1.synchronize()
    rows.record("fs_oracle[%s] %s responses" % (tag, label), src,
                "longfellow_zk_tpu/random_oracle/device_fs.py:254",
                max(err, max_err(fs, fs2)),
                lambda: dfs.fs_write_elts(F, fs, y),
                lambda: dfs.fs_write_elts_plain(F, fs2, y), 0, 0,
                bound=(bound, "operations"),
                plain=Timing(t0.elapsed_time(t1), "events", fs2), iters=20)

    m = p.nwqrow + stat.nl_constraints + 3 * p.nq + p.nqtriples
    fs, fs2 = _fs_states(F, rng, dev)
    prf, prf2 = dfs.new_prf(dev), dfs.new_prf(dev)

    def draw():
        return dfs.dev_sample_elts(F, prf, m, fs=fs)

    def dplain():
        dfs.fs_squeeze_plain(F, fs2, prf2)
        return dfs.dev_sample_elts_plain(F, prf2, m)

    err = max(max_err(draw(), dplain()), max_err(prf, prf2))
    steps = (1 + (_fs_off(fs) >= 56)) * SHA_CHAIN + AES_KEY_CHAIN + \
        AES_BLOCK_CHAIN + prod
    rows.record("fs_oracle[%s] %s draw" % (tag, label), src,
                "longfellow_zk_tpu/random_oracle/device_fs.py:339", err,
                draw, dplain, 0, 0,
                bound=(chain_ms(steps, clock_mhz), "operations"), iters=20)


def check_k1_hand_round(rows, F, tag, circ, dev, rng):
    """K1 [tag]'s updates of a hand-round at the largest layer of `circ`
    (the mdoc signature circuit's for [fp256]): rows "fp_elementwise[tag]
    bind" (its 2^logw wires to half), "... hv" (its T terms, h its terms'
    h0) and "... bind_hv" (both in one launch), each against its plain
    version."""
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.sumcheck.prover import quad_tensors

    pm = fpm.plain_of(F)
    eb, mops = 4 * F.nlimb, MUL_OPS[tag]
    elts = elts_of(F, rng, dev)
    ly = max(range(circ.nl), key=lambda i: circ.layers[i].nterms)
    layer = circ.layers[ly]
    T, nw = layer.nterms, 1 << layer.logw
    h = quad_tensors(F, layer.quad, dev)["h0"]
    hv, W, r = elts(T), elts(nw).reshape(1, nw, F.nlimb), elts(1)[0]
    print("K1[%s] bind, hv and bind_hv at layer %d: %d terms, %d wires"
          % (tag, ly, T, nw))
    src = "longfellow_zk_tpu_torch/csrc/fp_ops.cu"
    nb_bind, nb_hv = eb * (nw + nw // 2 + 1), eb * (2 * T + 1) + 4 * T
    rows.record("fp_elementwise[%s] bind" % tag, src,
                "longfellow_zk_tpu/sumcheck/prover_device.py:139",
                max_err(F.bind(W, r), pm.elementwise_plain(F, fpm.BIND, W,
                                                           r)),
                lambda: F.bind(W, r),
                lambda: pm.elementwise_plain(F, fpm.BIND, W, r),
                nb_bind, mops * nw // 2, iters=20)
    rows.record("fp_elementwise[%s] hv" % tag, src,
                "longfellow_zk_tpu/sumcheck/prover_device.py:595",
                max_err(F.hv_update(hv, h, r),
                        pm.elementwise_plain(F, fpm.HV, hv, r, h)),
                lambda: F.hv_update(hv, h, r),
                lambda: pm.elementwise_plain(F, fpm.HV, hv, r, h),
                nb_hv, mops * T, iters=20)
    got, want = F.bind_hv(W, hv, h, r), fpm.fp_bind_hv(F, W.cpu(), hv.cpu(),
                                                        h.cpu(), r.cpu())
    rows.record("fp_elementwise[%s] bind_hv" % tag, src,
                "longfellow_zk_tpu/sumcheck/prover_device.py:593",
                max(max_err(got[0], want[0].to(dev)),
                    max_err(got[1], want[1].to(dev))),
                lambda: F.bind_hv(W, hv, h, r),
                lambda: (pm.elementwise_plain(F, fpm.BIND, W, r),
                         pm.elementwise_plain(F, fpm.HV, hv, r, h)),
                nb_bind + nb_hv - eb, mops * (nw // 2 + T), iters=20)


# K3's wire mode at the term counts around a block and its grid (one block
# a lane up to 256 terms, which writes its sums directly), a mid and a
# large layer (8 lanes of the last two take the wide prime body); at
# GF(2^128) also the mdoc hash circuit's largest layer.  From
# K3_PLAIN_SHIFT0 terms the plain version runs at shift 0 only
K3_SIZES = (1, 255, 256, 257, 1000, 4097, (1 << 16) + 3, 158231)
K3_G128_LARGE = 3578789
K3_PLAIN_SHIFT0 = 158231


def check_k3_shapes(F, tag, dev, rng):
    """K3 [tag]'s wire mode (one launch a call) against its plain version
    at K3_SIZES (and K3_G128_LARGE at [gf2_128], one lane), the round's
    shifts 0-3 of h and ho (ho one further on, as on a round's second
    hand), 1 and 8 lanes, each twice back to back on the same scratch,
    and K1's hv update by the same shift at up to 4,097 terms; then every
    ticket of K3's scratch must be zero.  From K3_PLAIN_SHIFT0 terms,
    shifts 1-3 are held to the kernel at shift 0 on the indices shifted
    beforehand (the shift only moves the indices), which the plain
    version checks at shift 0.  Returns the largest error."""
    from longfellow_zk_tpu_torch.fields import fp as fpm

    pm = fpm.plain_of(F)
    elts = bulk_elts(F, rng, dev)
    err, ncall = 0, 0
    sizes = K3_SIZES + ((K3_G128_LARGE,) if F.kCharacteristicTwo else ())
    for T in sizes:
        N = 1 << max(4, (T - 1).bit_length())
        h = torch.as_tensor(rng.integers(0, N, T, dtype=np.int32),
                            device=dev)
        ho = torch.as_tensor(rng.integers(0, N, T, dtype=np.int32),
                             device=dev)
        for lanes in ((1,) if T == K3_G128_LARGE else (1, 8)):
            hv = elts(lanes * T).reshape(lanes, T, F.nlimb)
            Wh = elts(lanes * N).reshape(lanes, N, F.nlimb)
            r = elts(lanes)
            for s in range(4):
                n = N >> s
                Whs = Wh[:, :n].contiguous()
                Wo = Wh[:, n // 2 : n].contiguous()
                if s and T >= K3_PLAIN_SHIFT0:
                    want = fpm.fp_wire_sums(F, hv, Whs, Wo, h >> s,
                                            ho >> (s + 1))
                else:
                    want = pm.wire_sums_plain(F, hv, Whs, Wo, h, ho, s,
                                              s + 1)
                for _ in range(2):
                    err = max(err, max_err(
                        fpm.fp_wire_sums(F, hv, Whs, Wo, h, ho, s, s + 1),
                        want))
                    ncall += 1
                if T <= 4097:
                    err = max(err, max_err(
                        F.hv_update(hv, h, r, s),
                        pm.elementwise_plain(F, fpm.HV, hv, r, h, s)))
    torch.cuda.synchronize()
    left = sum(int(t.abs().sum()) for _, t in fpm._K3_SCRATCH.values())
    print("K3[%s] wire mode at %s terms, shifts 0-3 (from %d terms 1-3 "
          "against shift 0 on the shifted indices), lanes 1 and 8: %d "
          "calls, max_abs_err %d, tickets left %d" % (
              tag, ", ".join(map(str, sizes)), K3_PLAIN_SHIFT0, ncall, err,
              left))
    return err + left


def check_layer_hv(rows, F, tag, circs, dev, rng):
    """K23 [tag] (layer_hv) against its plain version at every layer of
    each circuit of `circs`, in the order of its wire rounds
    (SumcheckProver._hv_terms: the merge plan's permutation applied to
    the terms at upload), 1 and 8 lanes, beta a strided view as the
    prover's draws; the row "layer_hv[tag]" at the largest layer of the
    first circuit, one lane.  Bound: the bytes (layer_hv_bytes: hv
    written, dot read once at each distinct g, g, v and bmask read once)
    or the products; library: one index_select of dot by the terms' g
    (a part of the work)."""
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.sumcheck.prover import SumcheckProver

    elts = bulk_elts(F, rng, dev)
    sp = SumcheckProver(F, dev)
    eb, mops = 4 * F.nlimb, MUL_OPS[tag]
    err, nlayers = 0, 0
    for circ in circs:
        for ly, layer in enumerate(circ.layers):
            nv = circ.layers[ly - 1].nw if ly > 0 else circ.nv
            nv = 1 << max(0, (nv - 1).bit_length())
            ht = sp._hv_terms(layer.quad, layer.logw)
            for lanes in (1, 8):
                dot = elts(lanes * nv).reshape(lanes, nv, F.nlimb)
                ab = elts(2 * lanes).reshape(lanes, 2, F.nlimb)
                args = (dot, ht["g"], ht["v"], ht["bmask"], ab[:, 1])
                err = max(err, max_err(F.layer_hv(*args),
                                       fpm.layer_hv_plain(F, *args)))
            nlayers += 1
    circ = circs[0]
    ly = max(range(circ.nl), key=lambda i: circ.layers[i].nterms)
    layer = circ.layers[ly]
    nv = circ.layers[ly - 1].nw if ly > 0 else circ.nv
    nv = 1 << max(0, (nv - 1).bit_length())
    ht = sp._hv_terms(layer.quad, layer.logw)
    T = layer.nterms
    nd = int(torch.unique(ht["g"]).numel())
    dot = elts(nv).reshape(1, nv, F.nlimb)
    ab = elts(2).reshape(1, 2, F.nlimb)
    args = (dot, ht["g"], ht["v"], ht["bmask"], ab[:, 1])
    print("K23[%s] at every layer of %d circuit(s) (%d layers), 1 and 8 "
          "lanes: max_abs_err %d; the row at layer %d: %d terms, %d "
          "output wires (%d of them named by a term)" % (
              tag, len(circs), nlayers, err, ly, T, nv, nd))
    rows.record("layer_hv[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/layer_hv.cu",
                "longfellow_zk_tpu/sumcheck/prover_device.py:667", err,
                lambda: F.layer_hv(*args),
                lambda: fpm.layer_hv_plain(F, *args),
                layer_hv_bytes(eb, T, nd, 1), mops * T,
                library_fn=lambda: dot.index_select(1, ht["g"]), iters=20)


def check_round_tail(rows, F, dev, tag, rng, clock_mhz, cubic=False):
    """K10 instance `tag` (with `cubic`, its cubic mode, the copy rounds'
    tail) against its plain version on random rounds (fs, the claim and
    the row compared)."""
    from longfellow_zk_tpu_torch.fields.fp import round_consts
    from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs

    elts = elts_of(F, rng, dev)
    consts = round_consts(F, dev)
    npts = 4 if cubic else 3
    tail, plain = ((dfs.round_tail_cubic, dfs.round_tail_cubic_plain)
                   if cubic else (dfs.round_tail, dfs.round_tail_plain))
    err = 0
    for _ in range(8):
        fs, fs2 = _fs_states(F, rng, dev)
        x = elts(2 * npts + 1)
        claim, claim2 = x[0].clone(), x[0].clone()
        # the sums (with the copy weight eq0 for a hand-round) and the pad
        args = (x[1:npts],) if cubic else (x[1:3], x[3])
        pad = x[npts + 1 :]
        row = torch.empty((npts + 1, F.nlimb), dtype=torch.int32, device=dev)
        row2 = torch.empty_like(row)
        tail(F, fs, claim, row, *args, pad, consts)
        plain(F, fs2, claim2, row2, *args, pad, consts)
        err = max(err, max_err(fs, fs2), max_err(claim, claim2),
                  max_err(row, row2))
    off = _fs_off(fs)
    absorbed = (npts - 1) * (1 + F.kBytes)
    nprod, chain = k10_chain_products(tag, cubic)
    steps = ((off + absorbed) // 64 + 1 + ((off + absorbed) % 64 >= 56)) * \
        SHA_CHAIN + AES_KEY_CHAIN + AES_BLOCK_CHAIN + nprod * chain
    kname = "sumcheck_round_tail%s[%s]" % ("_cubic" if cubic else "", tag)
    print("K10%s[%s] chain of a round: %d steps"
          % (" cubic" if cubic else "", tag, steps))
    rows.record(kname, "longfellow_zk_tpu_torch/csrc/round_tail.cu",
                "longfellow_zk_tpu/sumcheck/prover_device.py:%d"
                % (543 if cubic else 571), err,
                lambda: tail(F, fs, claim, row, *args, pad, consts),
                lambda: plain(F, fs2, claim2, row2, *args, pad, consts),
                0, 0, bound=(chain_ms(steps, clock_mhz), "operations"))


def check_copy_round(rows, F, circ, nc, dev, tag, rng):
    """K16 instance `tag` against its plain version at the largest layer
    of `circ` over nc copies: its uploaded terms, random EQ, inputs W
    [nw, C] and hv.  Bound: W's rows the terms touch, EQ, the indices
    and hv read once; 7 products a copy pair and 3 a term."""
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.sumcheck.prover import quad_tensors

    ly = max(range(circ.nl), key=lambda i: circ.layers[i].nterms)
    layer = circ.layers[ly]
    qd = quad_tensors(F, layer.quad, dev)
    T, C = layer.nterms, 1 << (nc - 1).bit_length()
    elts = elts_of(F, rng, dev)
    EQ = elts(C)
    EQ[nc:] = 0
    W = elts(layer.nw * C).reshape(layer.nw, C, F.nlimb)
    W[:, nc:] = 0
    hv = elts(T)
    args = (EQ, W, qd["h0"], qd["h1"], hv)
    err = max_err(fpm.fp_copy_round_sums(F, *args),
                  fpm.copy_round_sums_plain(F, *args))
    touched = int(torch.unique(torch.cat([qd["h0"], qd["h1"]])).numel())
    print("K16[%s] at layer %d x %d copies: %d terms, nw %d (%d rows "
          "touched), C %d" % (tag, ly, nc, T, layer.nw, touched, C))
    eb = 4 * F.nlimb
    rows.record("copy_round_sums[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/copy_round.cu",
                "longfellow_zk_tpu/sumcheck/prover_device.py:519", err,
                lambda: fpm.fp_copy_round_sums(F, *args),
                lambda: fpm.copy_round_sums_plain(F, *args),
                (touched + 1) * C * eb + T * (8 + eb) + 3 * eb,
                (7 * (C // 2) + 3) * T * MUL_OPS[tag])


def check_fused(rows, F, circ, param, lqc, n_witness, dev, tag, rng,
                clock_mhz):
    """K11, K12 and K9 mode 9 of instance `tag` against their plain
    versions at the shapes of circuit `circ` with Ligero parameters
    `param`: K11 over every layer on random rows, claims and pads; K12
    on a random k and random challenges; the column choice of
    block_enc - dblock columns, nreq of them, from random states."""
    from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs
    from longfellow_zk_tpu_torch.zk import fused

    stat = fused.fused_static(circ, param, lqc, n_witness)
    tabs = fused.prepare(F, stat, dev)
    elts = elts_of(F, rng, dev)
    N, eb, p = F.nlimb, 4 * F.nlimb, param
    nl = circ.nl
    R = int(stat.lay[:, 0].sum())
    rws = elts(R * 8).reshape(R, 2, 4, N)
    scal = elts(4 * nl).reshape(nl, 4, N)
    wcpad = elts(2 * nl).reshape(nl, 2, N)
    args = (rws, scal, wcpad)
    err = max_err(fused.zk_constraints(F, tabs, *args),
                  fused.constraints_plain(F, stat.lay, *args, tabs.lag))
    maxlogw = int(stat.lay[:, 0].max())
    # the coefficient at p0 carries the chain: each hand-round a
    # difference, the scaling by L1(r) and a sum, one product; the
    # L_k(r) depend on r alone, all rounds' apart from the chain, so it
    # waits for one of them only (a difference and two products)
    steps = 2 * maxlogw * (PROD_CHAIN[tag] + 2) + 2 * PROD_CHAIN[tag] + 1
    print("K11[%s]: %d layers, %d rounds, max logw %d, %d coefficients "
          "(%d threads a block); chain of %d steps" % (
              tag, nl, 2 * R, maxlogw, stat.nk_layers, stat.nthreads,
              steps))
    rows.record("zk_constraints[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/constraints.cu",
                "longfellow_zk_tpu/zk/fused.py:139", err,
                lambda: fused.zk_constraints(F, tabs, *args),
                lambda: fused.constraints_plain(F, stat.lay, *args,
                                                tabs.lag), 0, 0,
                bound=(max(chain_ms(steps, clock_mhz),
                           bound_ms(eb * (R + 6 * nl + 6 + stat.nk_layers)
                                    + 16 * nl, 0)[0]), "operations"))

    k = elts(len(stat.ws))
    alphal, alphaq = elts(stat.nl_constraints), elts(3 * p.nq)
    A = fused.ligero_inner_product(F, tabs, k, alphal, alphaq)
    err = max_err(A, fused.inner_product_plain(
        F, tabs.ptr, tabs.ent, k, alphal, alphaq, p.nwqrow, p.r, p.w))
    nent = tabs.ent.shape[0]
    print("K12[%s]: A of %d x %d (%d linear terms, %d quadratic entries)"
          % (tag, p.nwqrow, p.block, len(stat.ws), 6 * p.nq))
    rows.record("ligero_inner_product[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/ligero_a.cu",
                "longfellow_zk_tpu/zk/fused.py:198", err,
                lambda: fused.ligero_inner_product(F, tabs, k, alphal,
                                                   alphaq),
                lambda: fused.inner_product_plain(
                    F, tabs.ptr, tabs.ent, k, alphal, alphaq,
                    p.nwqrow, p.r, p.w),
                eb * (p.nwqrow * p.block + len(stat.ws) +
                      stat.nl_constraints + 3 * p.nq) +
                4 * (p.nwqrow * p.w + 1) + 8 * nent,
                MUL_OPS[tag] * len(stat.ws))

    n, nreq = p.block_enc - p.dblock, p.nreq
    err = 0
    for _ in range(3):
        fs, fs2 = _fs_states(F, rng, dev)
        prf, prf2 = dfs.new_prf(dev), dfs.new_prf(dev)
        idx = dfs.dev_choose(F, fs, prf, n, nreq)
        err = max(err, max_err(idx, dfs.dev_choose_plain(F, fs2, prf2, n,
                                                         nreq)),
                  max_err(prf, prf2), max_err(fs, fs2))
    nblocks = int.from_bytes(bytes(prf[256:264].cpu().tolist()), "little")
    # the squeeze, the key schedule and one AES block (the counter blocks
    # do not depend on each other, nor on the walk), then per step the
    # draw's bytes, the mask and compare, two dependent accesses of the
    # walk's array: about 8 instructions
    steps = (1 + (_fs_off(fs) >= 56)) * SHA_CHAIN + AES_KEY_CHAIN + \
        AES_BLOCK_CHAIN + 8 * nreq
    print("K9[%s] CHOOSE: %d of %d columns, %d AES blocks; chain of %d "
          "steps" % (tag, nreq, n, nblocks, steps))
    rows.record("fs_choose[%s]" % tag, "longfellow_zk_tpu_torch/csrc/fs.cu",
                "longfellow_zk_tpu/random_oracle/device_fs.py:399", err,
                lambda: dfs.dev_choose(F, fs, prf, n, nreq),
                lambda: dfs.dev_choose_plain(F, fs2, prf2, n, nreq), 0, 0,
                bound=(chain_ms(steps, clock_mhz), "operations"))


LANES = 8
# a label whose transcript's first Fp128 draw is >= p, so that lane 1 of
# the lane rows rejects (tests/test_torch_device_fs.py REJECT_LABEL)
REJECT_LABEL = b"reject-1044179"


def check_lanes(rows, F, circ, param, lqc, n_witness, dev, rng, clock_mhz):
    """The lane axis (LANES proofs of a batch in one launch) of K1's bind
    and hv, K3, K9, K10, K11, K12 and K9 mode 9 [fp128] at the SHA-256
    proof's shapes, against the plain versions on the same inputs, one
    lane after another for K9 and K10 (their one-lane code); each a row
    "<kernel> lanes=8" whose bound counts the work of every lane (the
    chains run side by side: one lane's)."""
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.fields.fp import round_consts
    from longfellow_zk_tpu_torch.random_oracle import device_fs as dfs
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
    from longfellow_zk_tpu_torch.sumcheck.prover import quad_tensors
    from longfellow_zk_tpu_torch.zk import fused

    B, N, eb, tag = LANES, F.nlimb, 4 * F.nlimb, "fp128"
    mops = MUL_OPS[tag]
    elts = elts_of(F, rng, dev)
    sfx = " lanes=%d" % B
    src = "longfellow_zk_tpu_torch/csrc/"
    ly = max(range(circ.nl), key=lambda i: circ.layers[i].nterms)
    layer = circ.layers[ly]
    qd = quad_tensors(F, layer.quad, dev)
    T, nw = layer.nterms, 1 << layer.logw
    h0, h1 = qd["h0"], qd["h1"]
    # challenges as the sumcheck passes them: a strided view of the rows
    rws = elts(B * 4 * 8).reshape(B, 4, 2, 4, N)
    r = rws[:, 2, 1, 3]
    hv, Wh, Wo = (elts(B * n).reshape(B, n, N) for n in (T, nw, nw))
    pm = fpm.plain_of(F)
    err = max(max_err(F.bind(Wh, r), pm.elementwise_plain(F, fpm.BIND, Wh, r)),
              max_err(F.hv_update(hv, h0, r),
                      pm.elementwise_plain(F, fpm.HV, hv, r, h0)))
    print("lanes: K1/K3[%s] x %d at layer %d: %d terms, logw %d"
          % (tag, B, ly, T, layer.logw))
    rows.record("fp_elementwise[%s]%s" % (tag, sfx), src + "fp_ops.cu",
                "longfellow_zk_tpu/zk/batch.py:301", err,
                lambda: F.hv_update(hv, h0, r),
                lambda: pm.elementwise_plain(F, fpm.HV, hv, r, h0),
                2 * eb * B * T + 4 * T + eb * B, mops * B * T)
    err = max_err(fpm.fp_wire_sums(F, hv, Wh, Wo, h0, h1),
                  pm.wire_sums_plain(F, hv, Wh, Wo, h0, h1))
    n_even = int((h0 & 1).eq(0).sum())
    rows.record("fp_wire_round[%s]%s" % (tag, sfx), src + "wire_round.cu",
                "longfellow_zk_tpu/zk/batch.py:301", err,
                lambda: fpm.fp_wire_sums(F, hv, Wh, Wo, h0, h1),
                lambda: pm.wire_sums_plain(F, hv, Wh, Wo, h0, h1),
                8 * T + B * (eb * T + 2 * eb * nw + 2 * eb),
                mops * B * (2 * T + n_even))

    def states():
        """B random states [B, 104], lane 1 rejecting, and a copy."""
        out = []
        for b in range(B):
            ts = Transcript(REJECT_LABEL if b == 1 else rng.bytes(5))
            if b != 1:
                ts.write_bytes(rng.bytes(int(rng.integers(0, 200))))
            out.append(dfs.fs_init_from_host(ts, dev))
        fs = torch.stack(out)
        return fs, fs.clone()

    # K9: a squeeze and samples, absorbs, writes, bytes, the key
    fs, fs2 = states()
    prf, prf2 = dfs.new_prf(dev, B), dfs.new_prf(dev, B)

    def k9_plain(n):
        return torch.stack([(dfs.fs_squeeze_plain(F, fs2[b], prf2[b]),
                             dfs.dev_sample_elts_plain(F, prf2[b], n))[1]
                            for b in range(B)])

    err = max(max_err(dfs.dev_sample_elts(F, prf, 80, fs=fs), k9_plain(80)),
              max_err(prf, prf2))
    xs = elts(B * 5).reshape(B, 5, N)
    dfs.fs_write_elts(F, fs, xs)
    dfs.write_tagged_elts(F, fs, xs)
    for b in range(B):
        dfs.fs_write_elts_plain(F, fs2[b], xs[b])
        dfs.write_tagged_elts_plain(F, fs2[b], xs[b])
    dfs.fs_squeeze(F, fs, prf)
    err = max(err, max_err(fs, fs2), max_err(
        dfs.prf_bytes(F, prf, 33),
        torch.stack([(dfs.fs_squeeze_plain(F, fs2[b], prf2[b]),
                      dfs.prf_bytes_plain(F, prf2[b], 33))[1]
                     for b in range(B)])), max_err(prf, prf2))
    def squeezes(fs):
        """The compressions of a squeeze on the chain, the longest lane's."""
        return max(1 + (_fs_off(fs[b]) >= 56) for b in range(B))

    steps = squeezes(fs) * SHA_CHAIN + AES_KEY_CHAIN + AES_BLOCK_CHAIN + \
        PROD_CHAIN[tag]
    rows.record("fs_oracle[%s]%s" % (tag, sfx), src + "fs.cu",
                "longfellow_zk_tpu/zk/batch.py:301", err,
                lambda: dfs.dev_sample_elts(F, prf, 2, fs=fs),
                lambda: k9_plain(2), 0, 0,
                bound=(chain_ms(steps, clock_mhz), "operations"))

    # K10: a hand-round of every lane, rows and pads as strided views
    consts = round_consts(F, dev)
    fs, fs2 = states()
    x = elts(B * 3).reshape(B, 3, N)
    claim, claim2 = x[:, 0].contiguous(), x[:, 0].contiguous()
    a = x[:, 1:].contiguous()
    rrow = torch.zeros((B, 4, 2, 4, N), dtype=torch.int32, device=dev)
    rrow2 = rrow.clone()
    pads = elts(B * 24).reshape(B, 4, 2, 3, N)
    eq0 = x[0, 0].contiguous()

    def k10_plain():
        for b in range(B):
            dfs.round_tail_plain(F, fs2[b], claim2[b], rrow2[b, 1, 0], a[b],
                                 eq0, pads[b, 1, 0], consts)

    offs = [_fs_off(fs[b]) + 2 * (1 + F.kBytes) for b in range(B)]
    dfs.round_tail(F, fs, claim, rrow[:, 1, 0], a, eq0, pads[:, 1, 0],
                   consts)
    k10_plain()
    err = max(max_err(fs, fs2), max_err(claim, claim2),
              max_err(rrow, rrow2))
    nprod, chain = k10_chain_products(tag, False)
    steps = max(o // 64 + 1 + (o % 64 >= 56) for o in offs) * SHA_CHAIN + \
        AES_KEY_CHAIN + AES_BLOCK_CHAIN + nprod * chain
    rows.record("sumcheck_round_tail[%s]%s" % (tag, sfx),
                src + "round_tail.cu", "longfellow_zk_tpu/zk/batch.py:301",
                err, lambda: dfs.round_tail(F, fs, claim, rrow[:, 1, 0], a,
                                            eq0, pads[:, 1, 0], consts),
                k10_plain, 0, 0,
                bound=(chain_ms(steps, clock_mhz), "operations"))

    # K11 and K12 at the SHA geometry
    stat = fused.fused_static(circ, param, lqc, n_witness)
    tabs = fused.prepare(F, stat, dev)
    p, nl = param, circ.nl
    R = int(stat.lay[:, 0].sum())
    args = (elts(B * R * 8).reshape(B, R, 2, 4, N),
            elts(B * 4 * nl).reshape(B, nl, 4, N),
            elts(B * 2 * nl).reshape(B, nl, 2, N))
    err = max_err(fused.zk_constraints(F, tabs, *args),
                  fused.constraints_plain(F, stat.lay, *args, tabs.lag))
    maxlogw = int(stat.lay[:, 0].max())
    steps = 2 * maxlogw * (PROD_CHAIN[tag] + 2) + 2 * PROD_CHAIN[tag] + 1
    rows.record("zk_constraints[%s]%s" % (tag, sfx), src + "constraints.cu",
                "longfellow_zk_tpu/zk/batch.py:301", err,
                lambda: fused.zk_constraints(F, tabs, *args),
                lambda: fused.constraints_plain(F, stat.lay, *args,
                                                tabs.lag), 0, 0,
                bound=(max(chain_ms(steps, clock_mhz),
                           bound_ms(B * eb * (R + 6 * nl + stat.nk_layers)
                                    + eb * 6 + 16 * nl, 0)[0]),
                       "operations"))
    k = elts(B * len(stat.ws)).reshape(B, -1, N)
    al = elts(B * stat.nl_constraints).reshape(B, -1, N)
    aq = elts(B * 3 * p.nq).reshape(B, -1, N)
    err = max_err(fused.ligero_inner_product(F, tabs, k, al, aq),
                  fused.inner_product_plain(F, tabs.ptr, tabs.ent, k, al, aq,
                                            p.nwqrow, p.r, p.w))
    rows.record("ligero_inner_product[%s]%s" % (tag, sfx),
                src + "ligero_a.cu", "longfellow_zk_tpu/zk/batch.py:344",
                err, lambda: fused.ligero_inner_product(F, tabs, k, al, aq),
                lambda: fused.inner_product_plain(
                    F, tabs.ptr, tabs.ent, k, al, aq, p.nwqrow, p.r, p.w),
                B * eb * (p.nwqrow * p.block + len(stat.ws) +
                          stat.nl_constraints + 3 * p.nq) +
                4 * (p.nwqrow * p.w + 1) + 8 * tabs.ent.shape[0],
                mops * B * len(stat.ws))

    # K9 mode 9: the column choice of every lane
    n, nreq = p.block_enc - p.dblock, p.nreq
    fs, fs2 = states()
    prf, prf2 = dfs.new_prf(dev, B), dfs.new_prf(dev, B)

    def choose_plain():
        return torch.stack([dfs.dev_choose_plain(F, fs2[b], prf2[b], n, nreq)
                            for b in range(B)])

    err = max(max_err(dfs.dev_choose(F, fs, prf, n, nreq), choose_plain()),
              max_err(prf, prf2), max_err(fs, fs2))
    steps = squeezes(fs) * SHA_CHAIN + AES_KEY_CHAIN + AES_BLOCK_CHAIN + \
        8 * nreq
    rows.record("fs_choose[%s]%s" % (tag, sfx), src + "fs.cu",
                "longfellow_zk_tpu/zk/batch.py:375", err,
                lambda: dfs.dev_choose(F, fs, prf, n, nreq), choose_plain,
                0, 0, bound=(chain_ms(steps, clock_mhz), "operations"))


# the int8 tensor cores' dense rate (NVIDIA's data sheet): the bound of
# K17's byte products, 2 operations a multiply-add
INT8_OPS_PER_S = 1979e12


def check_matmul_ntt(rows, F, dev, rng):
    """K17 against its plain version on the blocks of a 2^14-point
    transform at B = 16, 64 and 128, both directions; then timed (and
    compared) on all 2^20 points at B = 128, the pass of bench.py's
    phase_fft.  Bound: the bytes of x, y and the matrix, or the u8
    multiply-adds (16 B)^2 a block on the int8 tensor cores."""
    from longfellow_zk_tpu_torch.fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER)
    from longfellow_zk_tpu_torch.transforms import matmul_ntt as mnt

    mm = mnt.MatmulNTT(F, P128_OMEGA, P128_OMEGA_ORDER, 128, dev)
    elts = elts_of(F, rng, dev)
    x = elts(1 << 14)
    err = 0
    for B in (16, 64, 128):
        for inverse in (False, True):
            G = mm.block_matrix(B, inverse)
            xb = x.reshape(-1, B, 4)
            err = max(err, max_err(mnt.fp_matmul_ntt(F, xb, G),
                                   mnt.matmul_ntt_plain(F, xb, G)))
    B, n = 128, 1 << 20
    G = mm.block_matrix(B, False)
    xb = elts(n).reshape(-1, B, 4)
    err = max(err, max_err(mnt.fp_matmul_ntt(F, xb, G),
                           mnt.matmul_ntt_plain(F, xb, G)))
    nbytes = 2 * 16 * n + 4 * G.numel()
    macs = (n // B) * (16 * B) ** 2
    tb, to = nbytes / HBM_BYTES_PER_S, 2 * macs / INT8_OPS_PER_S
    print("K17[fp128] at 2^20 points, B = %d: %d blocks, %.3g u8 "
          "multiply-adds" % (B, n // B, macs))
    rows.record("fp_matmul_ntt[fp128]",
                "longfellow_zk_tpu_torch/csrc/matmul_ntt.cu",
                "longfellow_zk_tpu/transforms/matmul_ntt.py:119", err,
                lambda: mnt.fp_matmul_ntt(F, xb, G),
                lambda: mnt.matmul_ntt_plain(F, xb, G), nbytes, 0,
                bound=(max(tb, to) * 1e3,
                       "bytes" if tb >= to else "operations"))


def check_rfft(rows, F2, omega2, order, dev, rng, nrows, n):
    """K18 in its three modes at the ECDSA tableau (nrows rows of n base
    elements), as one convolution runs them: split after the forward NTT,
    hc_mul by one broadcast spectrum, merge before the backward NTT; each
    against its plain version (hc_mul with full rows too).  Bound: each
    pass's rows read and written once (tables too), or its products: one
    Fp2 product (3 base products) an index but 0 (by w^0 = 1) in split
    and merge, whose halvings are no products, and in hc_mul but at 0
    and h (one base product each)."""
    from longfellow_zk_tpu_torch.transforms import rfft as rfm

    rf = rfm.RFFT(F2, omega2, order, dev)
    fw, bw = rf.w_tables(n)
    eb, h = 4 * F2.nlimb, n // 2
    elts = elts_of(F2.f, rng, dev)
    Z = elts(nrows * n).reshape(nrows, h, 2, F2.nlimb)
    hc = elts(nrows * n).reshape(nrows, n, F2.nlimb)
    hy = elts(n).reshape(1, n, F2.nlimb)
    cases = [(rfm.SPLIT, Z, None, fw, rf.inv2),
             (rfm.HC_MUL, hc, hy, None, None),
             (rfm.HC_MUL, hc, hc, None, None),
             (rfm.MERGE, hc, None, bw, rf.inv2)]
    err = 0
    for case in cases:
        err = max(err, max_err(rfm.rfft_pass(F2, *case),
                               rfm.rfft_pass_plain(F2, *case)))
    conv = [c for i, c in enumerate(cases) if i != 2]

    def run(fn):
        return lambda: [fn(F2, *case) for case in conv]

    row = nrows * n * eb
    nbytes = 6 * row + 2 * (h * 2 * eb) + n * eb
    rows.record("rfft_pass[fp256x2]",
                "longfellow_zk_tpu_torch/csrc/rfft.cu",
                "longfellow_zk_tpu/transforms/rfft.py:74", err,
                run(rfm.rfft_pass), run(rfm.rfft_pass_plain), nbytes,
                MUL_OPS["fp256"] * nrows * (3 * 3 * (h - 1) + 2))


def check_nussbaumer(rows, F, dev, tag, rng, nrows, n):
    """K19 and K20 of field F at the shapes that cyclic() of nrows rows of
    n points reaches (the bitaddr tableau: 25 rows, padding 4,096; the
    ECDSA tableau over Fp2: 14 rows, 2,048): K19 at every level of both
    directions of every negacyclic transform the recursion runs ([rows,
    M, r]: at 4,096 from negacyclic(n / 2) at [nrows, 64, 64] down to
    the inner negacyclic(64) at [64 nrows, 16, 8]); K20 at the base sizes
    4 (cyclic), 8, 16 and 32 (negacyclic), y with the rows of one tableau
    row (as the convolver's broadcast kernel).  Timed: K19's first
    forward level (bound: bytes) and K20 at 32 points (bound: n^2
    products a row of MUL_OPS[tag] multiplies each: 3 base products an
    Fp2 product).
    F is a prime field or Fp2 over one."""
    from longfellow_zk_tpu_torch.transforms import nussbaumer as nbm

    def levels(k, rr):
        """(M, r, rows) of negacyclic(k) on rr rows and its recursion."""
        if k <= nbm.K_SMALL:
            return []
        m, r = nbm._split(k)
        return [(2 * m, r, rr)] + levels(r, rr * 2 * m)

    shapes, k = [], n
    while k > 4:
        k //= 2
        shapes += levels(k, nrows)
    E = tuple(F.elt_shape)
    eb, ne = 4 * int(np.prod(E)), int(np.prod(E))
    if len(E) == 2:
        base = elts_of(F.f, rng, dev)

        def elts(k):
            return torch.stack([base(k), base(k)], dim=-2)
    else:
        elts = elts_of(F, rng, dev)
    err = 0
    timed = None
    for M, r, rr in shapes:
        A = elts(rr * M * r).reshape((rr, M, r) + E)
        m = M // 2
        w = r // m
        h = m
        while h >= 1:
            for inverse, step in ((False, w * (m // h)),
                                  (True, -w * (m // h))):
                err = max(err, max_err(
                    nbm.nb_butterfly(F, A, h, step, inverse),
                    nbm.nb_butterfly_plain(F, A, h, step, inverse)))
            h //= 2
        if timed is None:
            timed = A
    print("K19[%s] checked at [rows, M, r] = %s" % (
        tag, ", ".join("[%d, %d, %d]" % (rr, M, r) for M, r, rr in shapes)))
    rows.record("nb_butterfly[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/nussbaumer.cu",
                "longfellow_zk_tpu/transforms/nussbaumer.py:95", err,
                lambda: nbm.nb_butterfly(F, timed, 32, 1, False),
                lambda: nbm.nb_butterfly_plain(F, timed, 32, 1, False),
                2 * eb * timed.numel() // ne, 0)
    err = 0
    for k in (4, 8, 16, 32):
        x = elts(nrows * n // 2).reshape((nrows, -1, k) + E)
        y = elts(n // 2).reshape((1, -1, k) + E)
        for neg in ((False, True) if k > 4 else (False,)):
            x2, y2 = nbm._rows_of(x, y, len(E))
            err = max(err, max_err(nbm.nb_base_conv(F, x, y, neg)
                                   .reshape(x2.shape),
                                   nbm.nb_base_conv_plain(F, x2, y2, neg)))
    x2, y2 = nbm._rows_of(x, y, len(E))
    rows.record("nb_base_conv[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/nussbaumer.cu",
                "longfellow_zk_tpu/transforms/nussbaumer.py:63", err,
                lambda: nbm.nb_base_conv(F, x, y, True),
                lambda: nbm.nb_base_conv_plain(F, x2, y2, True),
                eb * (2 * x2.numel() + y2.numel()) // ne,
                MUL_OPS[tag] * x2.shape[0] * 32 * 32)


# section 3l: the field API at 2^20 elements, 64 of them against the
# host ints
API_N = 1 << 20
API_SAMPLE = 64
# the inverse rows are checked and timed at their first INV_N elements:
# the plain versions (Fermat over int64 limbs, Itoh-Tsujii for Fp24_6)
# take seconds each at 2^20, tens of seconds for the section
INV_N = 1 << 16
# the JAX functions each mode replaces: (prime field, GF(2^128), Fp2,
# Fp24_6), files under longfellow_zk_tpu/fields
API_REPLACES = {
    "mul": ("fp.py:443", None, None, "fp24.py:227"),
    "add": ("fp.py:245", "gf2.py:281", None, "fp24.py:218"),
    "sub": ("fp.py:255", None, None, "fp24.py:221"),
    "sqr": ("fp.py:457", "gf2.py:361", "fp2.py:175", "fp24.py:242"),
    "neg": ("fp.py:274", "gf2.py:286", "fp2.py:156", "fp24.py:224"),
    "eq": ("fp.py:500", "gf2.py:392", "fp2.py:193", "fp24.py:261"),
    "is_zero": ("fp.py:504", "gf2.py:395", "fp2.py:196", "fp24.py:264"),
    "select": ("fp.py:507", "gf2.py:398", "fp2.py:199", "fp24.py:267"),
    "mul_const": ("fp.py:460", "gf2.py:358", "fp2.py:178", None),
    "inv": ("fp.py:466", "gf2.py:378", "fp2.py:181", "fp24.py:245"),
}


def _inv_products(e):
    """Products of a left-to-right power by e: a square a bit after the
    first, a product a set bit after the first."""
    return e.bit_length() - 1 + bin(e).count("1") - 1


# An inverse's operations, by the cheapest known method: Fermat's a^(p -
# 2) (_inv_products(p - 2) products), or a var-time safegcd (Bernstein
# and Yang, as libsecp256k1's modinv32): the divsteps that this run's
# sampled inputs need (counted on the host), GCD_STEP_OPS word operations
# each on the low words (a var-time batch skips a run of even values by
# counting its trailing zeros), and per GCD_BATCH divsteps the 2 x 2
# transition matrix applied to (f, g) and to (d, e), d and e reduced: 10
# N multiply-adds.
GCD_STEP_OPS = 4
GCD_BATCH = 30


def _divsteps(p, x):
    """Bernstein-Yang divsteps from f = p, g = x until g = 0."""
    d, f, g, n = 1, p, x, 0
    while g:
        if d > 0 and g & 1:
            d, f, g = 1 - d, g, (g - f) >> 1
        else:
            d, g = 1 + d, (g + (g & 1) * f) >> 1
        n += 1
    return n


def inv_ops(F, tag, xs):
    """32-bit operations of one inverse in the prime field F (kernel
    instance `tag`) by the cheapest known method, the divsteps averaged
    over the nonzero natural values xs."""
    fermat = MUL_OPS[tag] * _inv_products(F.p - 2)
    nz = [x for x in xs if x]
    steps = sum(_divsteps(F.p, x) for x in nz) / len(nz)
    gcd = GCD_STEP_OPS * steps + -(-steps // GCD_BATCH) * 10 * F.nlimb
    return min(fermat, gcd)


def fp24x6_inv_ops(p):
    """32-bit operations of one Fp24_6 inverse by Itoh and Tsujii: with
    r = (p^6 - 1) / (p - 1) = 1 + p + ... + p^5, a^(r - 1) = w a^(p^5) for
    w = v v^(p^2), v = u u^p, u = a^p: 3 products and 4 Frobenius maps (6
    divides p - 1, so x^p = 7^((p - 1) / 6) x and a map scales five
    coefficients: 5 base products); the norm a^r = a a^(r - 1) lies in
    Fp, its constant coefficient 6 base products; one base inverse
    (Fermat's 43 products: at 23 bits fewer operations than a gcd's
    45-50 divsteps); a^(r - 1) scaled by it, 6 base products."""
    base = MUL_OPS["fp24"]
    return (3 * FP24X6_MUL_OPS + (4 * 5 + 6 + 6) * base +
            _inv_products(p - 2) * base)


class FieldApi:
    """The rows of the field API (sections 3l and 4l): operands of n
    random canonical elements on the card, each call against its plain
    version on the card (checked and timed in one profiled call) and the
    host ints at API_SAMPLE elements (`idx`: the first 12 and a sorted
    sample), a row each."""

    def __init__(self, rows, dev, rng, n=API_N):
        from longfellow_zk_tpu_torch.fields import fp as fpm

        self.rows, self.dev, self.rng, self.n = rows, dev, rng, n
        self.idx = self.sample(n)
        self.names = {fpm.MUL: "mul", fpm.ADD: "add", fpm.SUB: "sub",
                      fpm.SQR: "sqr", fpm.NEG: "neg", fpm.EQ: "eq",
                      fpm.IS_ZERO: "is_zero", fpm.SELECT: "select",
                      fpm.INV: "inv"}

    def sample(self, n):
        """The checked indices of n elements: 0-11 and a sorted sample."""
        return torch.as_tensor(np.concatenate([np.arange(12), np.sort(
            self.rng.choice(np.arange(12, n), API_SAMPLE - 12,
                            replace=False))]))

    @staticmethod
    def host_of(F, zero):
        """mode -> the host op on (x, y, t) (t: the condition)."""
        from longfellow_zk_tpu_torch.fields import fp as fpm

        return {fpm.MUL: lambda x, y, t: F.mul_i(x, y),
                fpm.ADD: lambda x, y, t: F.add_i(x, y),
                fpm.SUB: lambda x, y, t: F.sub_i(x, y),
                fpm.SQR: lambda x, y, t: F.mul_i(x, x),
                fpm.NEG: lambda x, y, t: F.neg_i(x),
                fpm.EQ: lambda x, y, t: x == y,
                fpm.IS_ZERO: lambda x, y, t: x == zero,
                fpm.SELECT: lambda x, y, t: x if t else y,
                fpm.INV: lambda x, y, t: zero if x == zero else F.inv_i(x)}

    @staticmethod
    def vals(F, t):
        v = F.from_limbs(t.cpu())
        return list(v) if isinstance(v, np.ndarray) else v

    def fast_elts(self, F):
        return bulk_elts(F, self.rng, self.dev)

    def operands(self, make, n=None):
        n = n or self.n
        a, b = make(n), make(n)
        b[::3] = a[::3]
        a[5:9] = 0
        b[7:9] = 0
        return a, b, torch.as_tensor(self.rng.random(n) < 0.5,
                                     device=self.dev)

    def check(self, kname, F, zero, kfn, pfn, a, b, cond, mode, host=None,
              one=None, idx=None):
        """(err, the plain version's Timing): kfn() against pfn() and the
        host op at the sampled elements idx; the inverse's identities
        where one is given."""
        idx = self.idx if idx is None else idx
        vals = self.vals
        out = kfn()
        plain = device_ms(pfn, 1, warmup=0)
        err = max_err(out, plain.out)
        xs, ys = vals(F, a[idx]), vals(F, b[idx])
        ts = cond[idx].tolist()
        got = out[idx].cpu().tolist() if out.dtype == torch.bool else \
            vals(F, out[idx])
        hfn = host or self.host_of(F, zero)[mode]
        bad = sum(g != hfn(x, y, t) for g, x, y, t in zip(got, xs, ys, ts))
        if bad:
            print("  %s: %d of %d sampled elements differ from the host ints"
                  % (kname, bad, API_SAMPLE))
        err += bad
        if one is not None:
            err += self.identity(kname, F, out, a, one)
        return err, plain

    @staticmethod
    def identity(kname, F, out, a, one):
        """1 unless out = inv(a): out a = 1 where a is nonzero, 0 where
        a is 0."""
        nz = ~F.is_zero(a)
        ok = bool(F.eq(F.mul(out[nz], a[nz]), one).all()) and \
            bool(F.is_zero(out[~nz]).all())
        print("  %s: inv(a) a = 1 on %d nonzero inputs, inv(0) = 0 on %d: %s"
              % (kname, int(nz.sum()), int((~nz).sum()), ok))
        return 0 if ok else 1

    def inv_row(self, kname, source, where, F, zero, inv, plain, a, b, cond,
                eb, ops_of, one):
        """An inverse row: inv and its plain version checked (against
        each other, the host ints and the identity) and timed at the
        first INV_N elements; then inv over all of a, timed once more and
        held to the identity there.  ops_of(vals): the operations of one
        inverse, from the natural values of the sampled inputs."""
        from longfellow_zk_tpu_torch.fields import fp as fpm

        n, idx = INV_N, self.sample(INV_N)
        a1, b1, c1 = a[:n], b[:n], cond[:n]
        self.run(kname, source, where, F, zero, lambda: inv(a1),
                 lambda: plain(a1), a1, b1, c1, fpm.INV, 2 * eb * n,
                 ops_of(self.vals(F, a1[idx])) * n, one=one, idx=idx)
        full = device_ms(lambda: inv(a), 3)
        print("  %s at all %d elements: device %.5f ms (%s)"
              % (kname, a.shape[0], full.ms, full.by))
        if self.identity(kname, F, full.out, a, one):
            self.rows.failures.append(kname + " at %d" % a.shape[0])

    def run(self, kname, source, where, F, zero, kfn, pfn, a, b, cond, mode,
            nbytes, ops, host=None, one=None, idx=None, bound=None):
        """One row: check(), then the timings (an inverse's over 5 calls,
        the others' over 20); bound as Rows.record's."""
        from longfellow_zk_tpu_torch.fields import fp as fpm

        err, plain = self.check(kname, F, zero, kfn, pfn, a, b, cond, mode,
                                host, one, idx)
        k = len(F.elt_shape)
        lib = None
        gf = getattr(F, "kCharacteristicTwo", False)
        if gf and mode == fpm.ADD:
            def lib():
                return torch.bitwise_xor(a, b)
        elif gf and mode == fpm.NEG:
            def lib():
                return torch.clone(a)
        elif mode == fpm.EQ:
            def lib():
                return torch.all((a == b).flatten(-k), -1)
        elif mode == fpm.IS_ZERO:
            def lib():
                return torch.all((a == 0).flatten(-k), -1)
        elif mode == fpm.SELECT:
            def lib():
                return torch.where(cond.reshape(cond.shape + (1,) * k), a, b)
        self.rows.record(kname, source, "longfellow_zk_tpu/fields/" + where,
                         err, kfn, None, nbytes, ops, bound=bound, plain=plain,
                         library_fn=lib,
                         iters=5 if mode == fpm.INV else 20)

    def mode_bytes(self, mode, eb, n=None):
        """The bytes a call must move: its operands read and its output
        written once (a select reads only the operand it chooses, and
        its conditions; eq and is_zero write one byte an element)."""
        from longfellow_zk_tpu_torch.fields import fp as fpm

        n = n or self.n
        return {fpm.MUL: 3, fpm.ADD: 3, fpm.SUB: 3, fpm.SQR: 2, fpm.NEG: 2,
                fpm.EQ: 2, fpm.IS_ZERO: 1, fpm.SELECT: 2,
                fpm.INV: 2}[mode] * eb * n + \
            (n if mode in (fpm.EQ, fpm.IS_ZERO, fpm.SELECT) else 0)

    def split_shapes(self, F, tag):
        """K1 [tag] (the one-word path, four elements a thread, or the
        12- and 17-word one, a tile of TILE_ELTS elements a block;
        csrc/fp_ops.cu) in every mode of the field API against its plain
        version on the card where the paths split: n = 0, 1, 3,
        TILE_ELTS - 1, TILE_ELTS + 1
        and 2^16 + 5 elements; b full, one element and a row over two
        rows; the conditions full, a row and a column; operands that are
        views one element into their tensors (not 16-byte aligned), alone
        and beside aligned ones.  A mismatch fails the run."""
        from longfellow_zk_tpu_torch.fields import fp as fpm

        tile = kernels_mod().k1_tile()
        elts, nl, bad, calls = self.fast_elts(F), F.nlimb, [], 0
        for n in (0, 1, 3, tile - 1, tile + 1, (1 << 16) + 5):
            a, b, cond = self.operands(elts, 2 * n + 2)
            x, y, c = a[:n], b[:n], cond[:n]
            xo, yo, co = a[1 : n + 1], b[1 : n + 1], cond[1 : n + 1]
            rows = a[: 2 * n].reshape(2, n, nl)
            cases = [(x, y, c), (xo, yo, co), (x, yo, c), (xo, y, co),
                     (x, b[n + 1], c), (xo, b[n + 1], co), (rows, yo, co),
                     (rows, y, cond[:2].reshape(2, 1))]
            for mode in (fpm.MUL, fpm.ADD, fpm.SUB, fpm.SQR, fpm.NEG,
                         fpm.EQ, fpm.IS_ZERO, fpm.SELECT):
                for k, (xx, yy, cc) in enumerate(cases):
                    got = fpm.fp_elementwise(F, mode, xx, yy, cc)
                    want = fpm.plain_of(F).elementwise_plain(F, mode, xx,
                                                             yy, cc)
                    calls += 1
                    if got.shape != want.shape or (
                            got.numel() and max_err(got, want)):
                        bad.append("n=%d %s case %d"
                                   % (n, self.names[mode], k))
        print("  fp_elementwise[%s] at the split shapes (n = 0, 1, 3, %d, "
              "%d, 65541; b full, one, a row; conditions full, a row, a "
              "column; views at an offset): %d of %d calls differ from the "
              "plain version%s [at %.0f s]"
              % (tag, tile - 1, tile + 1, len(bad), calls,
                 (": " + ", ".join(bad[:8])) if bad else "",
                 time.perf_counter() - T0))
        if bad:
            self.rows.failures.append("fp_elementwise[%s] split shapes"
                                      % tag)

    def prime_rows(self, F, tag, arith):
        """K1's modes `arith` (of mul, add, sub), sqr, neg, eq, is_zero,
        select, mul_const, and K21 of field F (instance `tag`; its row at
        INV_N elements, inv_row)."""
        from longfellow_zk_tpu_torch.fields import fp as fpm

        n, names, dev = self.n, self.names, self.dev
        gf = F.kCharacteristicTwo
        col = 1 if gf else 0
        pm = fpm.plain_of(F)
        eb, mops = 4 * F.nlimb, MUL_OPS[tag]
        zero = 0
        a, b, cond = self.operands(self.fast_elts(F))
        src = "longfellow_zk_tpu_torch/csrc/fp_ops.cu"
        modes = list(arith) + [fpm.SQR, fpm.NEG, fpm.EQ, fpm.IS_ZERO,
                               fpm.SELECT]
        for mode in modes:
            bb = a if mode in fpm.UNARY else b
            name = "fp_elementwise[%s]" % tag
            if mode != fpm.MUL:
                name += " " + names[mode]
            # (a GF(2^128) square spreads bits: no multiply)
            prods = mode == fpm.MUL or (mode == fpm.SQR and not gf)
            self.run(name, src, API_REPLACES[names[mode]][col], F, zero,
                     lambda m=mode, y=bb: fpm.fp_elementwise(F, m, a, y, cond),
                     lambda m=mode, y=bb: pm.elementwise_plain(F, m, a, y,
                                                               cond),
                     a, b, cond, mode, self.mode_bytes(mode, eb),
                     mops * n if prods else 0)
        c = (0xC0FFEE << 100) % F.p if not gf else 0xC0FFEE << 100
        cl = F.to_limbs(c, dev)
        # GF(2^128): a product by one element reads its table
        self.run("fp_elementwise[%s] mul_const" % tag, src,
                 API_REPLACES["mul_const"][col], F, zero,
                 lambda: F.mul_const(a, c),
                 lambda: pm.elementwise_plain(F, fpm.MUL, a, cl), a, b, cond,
                 fpm.MUL, 2 * eb * n, mops * n,
                 host=lambda x, y, t: F.mul_i(x, c),
                 bound=table_bound(2 * eb * n, n) if gf else None)
        self.inv_row("fp_inv[%s]" % tag, "longfellow_zk_tpu_torch/csrc/inv.cu",
                     API_REPLACES["inv"][col], F, zero, F.inv,
                     lambda x: pm.inv_plain(F, x), a, b, cond, eb,
                     lambda xs: G128_INV_PRODUCTS * mops if gf else
                     inv_ops(F, tag, xs), F.to_limbs(1, dev))


def check_field_api(rows, dev, rng):
    """Section 3l: the field device API that no proof path calls, at
    2^20 elements a call: K1's modes sqr, neg, eq, is_zero, select and
    mul_const at every instance, and mul (add, sub) at the new ones
    (fp24, fp64, p256n, p256k1n); K21 at every instance; K5's modes;
    K22's mul, sqr and inv (the inverses' rows at INV_N elements,
    inv_row), and Fp24_6's per-coefficient ops, which run
    as K1 [fp24] on the six words; K2 and K3 [fp24] (the sums of the
    small prime, which pass 2p).  Each call against its plain version on
    the card (the plain version checked and timed in one profiled call),
    64 sampled elements against the host ints (mul_i, inv_i, the 6-tuple
    ops of Fp24_6), and for K21 and K22's inverse inv(a) a = 1 on the
    nonzero inputs and inv(0) = 0; eq, is_zero and select with library
    ms (torch.all(a == b, -1), torch.where).  a is zero at 4 places and b
    equals a at every third.  Bound: inputs read and outputs written
    once (mode_bytes: a select reads the chosen operand), or the
    products (2 N^2 multiplies; an Fp24_6 product FP24X6_MUL_OPS; an
    inverse by the cheapest known method, inv_ops and fp24x6_inv_ops;
    GF(2^128): MUL_OPS a product, its mul_const the table reads of
    g128_table_ms, its inverse G128_INV_PRODUCTS products).  Last, a CUDA
    tensor of a field or mode without a kernel must raise."""
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.fields import fp2 as fp2m
    from longfellow_zk_tpu_torch.fields import fp24 as f24m
    from longfellow_zk_tpu_torch.fields import fp_instances as fi
    from longfellow_zk_tpu_torch.fields.gf2 import gf2_128

    api = FieldApi(rows, dev, rng)
    n, names = api.n, api.names
    check, run = api.check, api.run
    fast_elts, operands, mode_bytes = (api.fast_elts, api.operands,
                                       api.mode_bytes)
    k1_modes = [fpm.SQR, fpm.NEG, fpm.EQ, fpm.IS_ZERO, fpm.SELECT]
    new_tags = ("fp24", "fp64", "p256n", "p256k1n")
    fields = [(fi.fp128(), "fp128"), (fi.p256_base(), "fp256"),
              (fi.p256k1_base(), "fp256k1"), (gf2_128(), "gf2_128"),
              (f24m.fp24(), "fp24"), (fi.fp64(), "fp64"),
              (fi.p256_scalar(), "p256n"), (fi.p256k1_scalar(), "p256k1n")]
    print("== section 3l: the field API at %d elements [at %.0f s]"
          % (n, time.perf_counter() - T0))
    arith = [fpm.MUL, fpm.ADD, fpm.SUB]
    for F, tag in fields:
        api.prime_rows(F, tag, arith if tag in new_tags else
                       [fpm.ADD] if tag == "gf2_128" else [])
    api.split_shapes(f24m.fp24(), "fp24")

    # Fp2 over the P-256 base field: K5's modes and K21 [fp256x2]
    F2 = fp2m.Fp2(fi.p256_base())
    elts_b = fast_elts(F2.f)
    a, b, cond = operands(lambda m: torch.stack([elts_b(m), elts_b(m)],
                                                dim=-2))
    eb, zero = 64, (0, 0)
    src = "longfellow_zk_tpu_torch/csrc/fp2_ops.cu"
    for mode in k1_modes:
        bb = a if mode in fpm.UNARY else b
        run("fp2_elementwise[fp256x2] " + names[mode], src,
            API_REPLACES[names[mode]][2], F2, zero,
            lambda m=mode, y=bb: fp2m.fp2_elementwise(F2, m, a, y, cond),
            lambda m=mode, y=bb: fp2m.fp2_elementwise_plain(F2, m, a, y,
                                                            cond),
            a, b, cond, mode, mode_bytes(mode, eb),
            MUL_OPS["fp256x2"] * n if mode == fpm.SQR else 0)
    c2 = (12345, 678)
    c2l = F2.to_limbs(c2, dev)
    run("fp2_elementwise[fp256x2] mul_const", src,
        API_REPLACES["mul_const"][2], F2, zero, lambda: F2.mul_const(a, c2),
        lambda: fp2m.fp2_elementwise_plain(F2, fpm.MUL, a, c2l), a, b, cond,
        fpm.MUL, 2 * eb * n, MUL_OPS["fp256x2"] * n,
        host=lambda x, y, t: F2.mul_i(x, c2))
    # the norm re^2 + im^2, one base inverse, (re d, -im d)
    p = F2.f.p
    api.inv_row("fp_inv[fp256x2]", "longfellow_zk_tpu_torch/csrc/inv.cu",
                API_REPLACES["inv"][2], F2, zero, F2.inv,
                lambda x: fp2m.fp2_inv_plain(F2, x), a, b, cond, eb,
                lambda xs: inv_ops(F2.f, "fp256", [
                    (x[0] * x[0] + x[1] * x[1]) % p for x in xs]) +
                4 * MUL_OPS["fp256"], F2.to_limbs((1, 0), dev))

    # Fp24_6: K22's mul, sqr and inv
    F6 = f24m.Fp24_6(f24m.fp24())
    elts24 = fast_elts(F6.f)
    a, b, cond = operands(lambda m: elts24(6 * m).reshape(m, 6, 1))
    eb, zero = 24, (0,) * 6
    src = "longfellow_zk_tpu_torch/csrc/fp24x6.cu"
    for mode in (fpm.MUL, fpm.SQR):
        bb = a if mode in fpm.UNARY else b
        run("fp24x6_elementwise[fp24x6] " + names[mode], src,
            API_REPLACES[names[mode]][3], F6, zero,
            lambda m=mode, y=bb: f24m.fp24x6_elementwise(F6, m, a, y),
            lambda m=mode, y=bb: f24m.fp24x6_elementwise_plain(F6, m, a, y),
            a, b, cond, mode, mode_bytes(mode, eb), FP24X6_MUL_OPS * n)
    api.inv_row("fp24x6_elementwise[fp24x6] inv", src,
                API_REPLACES["inv"][3], F6, zero,
                lambda x: f24m.fp24x6_elementwise(F6, fpm.INV, x, x),
                lambda x: f24m.fp24x6_elementwise_plain(F6, fpm.INV, x, x),
                a, b, cond, eb, lambda xs: fp24x6_inv_ops(F6.f.p),
                F6.to_limbs(1, dev))
    # and the ops of each coefficient alone: K1 [fp24] on the six words
    # (its rows above), against K1's plain version on them and the host
    F = F6.f
    pm = fpm.plain_of(F)
    api = {fpm.ADD: lambda: F6.add(a, b), fpm.SUB: lambda: F6.sub(a, b),
           fpm.NEG: lambda: F6.neg(a), fpm.EQ: lambda: F6.eq(a, b),
           fpm.IS_ZERO: lambda: F6.is_zero(a),
           fpm.SELECT: lambda: F6.select(cond, a, b)}
    plain = {fpm.ADD: lambda: pm.elementwise_plain(F, fpm.ADD, a, b),
             fpm.SUB: lambda: pm.elementwise_plain(F, fpm.SUB, a, b),
             fpm.NEG: lambda: pm.elementwise_plain(F, fpm.NEG, a, a),
             fpm.EQ: lambda: pm.elementwise_plain(F, fpm.EQ, a, b).all(-1),
             fpm.IS_ZERO:
             lambda: pm.elementwise_plain(F, fpm.IS_ZERO, a, a).all(-1),
             fpm.SELECT: lambda: pm.elementwise_plain(F, fpm.SELECT, a, b,
                                                      cond[:, None])}
    errs = {}
    for mode in api:
        n0 = kernels_mod().LAUNCHES["fp_elementwise[fp24]"]
        errs[names[mode]], _ = check("Fp24_6 " + names[mode], F6, zero,
                                     api[mode], plain[mode], a, b, cond,
                                     mode)
        if kernels_mod().LAUNCHES["fp_elementwise[fp24]"] == n0:
            errs[names[mode]] += 1
    print("  Fp24_6 through K1 [fp24] on the six words (against the plain "
          "version and the host ints): %s" % errs)
    if any(errs.values()):
        rows.failures.append("Fp24_6 through K1 [fp24]")

    # K2 and K3 [fp24]: a quarter of the terms p - 1, so that the sums
    # pass 2p; held to numpy sums of the Montgomery words modulo p
    F = f24m.fp24()
    x = elts24(n)
    x[: n // 4] = F.to_limbs(F.p - 1, dev)
    nseg = 1 << 14
    g = np.sort(rng.integers(0, nseg, n))
    starts = torch.as_tensor(np.searchsorted(g, np.arange(nseg), "left")
                             .astype(np.int32), device=dev)
    ends = torch.as_tensor(np.searchsorted(g, np.arange(nseg), "right")
                           .astype(np.int32), device=dev)
    xw = x.cpu().numpy().view(np.uint32)[:, 0].astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(xw)])
    seg_want = (cs[ends.cpu().numpy()] - cs[starts.cpu().numpy()]) % F.p
    out = F.lazy_segment_sum(x, starts, ends)
    plain = device_ms(lambda: fpm.segment_sum_plain(F, x, starts, ends), 1,
                      warmup=0)
    err = max_err(out, plain.out) + int(
        (out.cpu().numpy()[:, 0].astype(np.int64) != seg_want).sum())
    rows.record("fp_segment_sum[fp24]",
                "longfellow_zk_tpu_torch/csrc/segsum.cu",
                "longfellow_zk_tpu/fields/fp.py:561", err,
                lambda: F.lazy_segment_sum(x, starts, ends), None,
                4 * n + 12 * nseg, 0, plain=plain, iters=20)
    x6 = elts24(6 * n).reshape(-1, 1 << 10, 6, 1)
    x6[:256] = F.to_limbs(F.p - 1, dev)
    out = F6.lazy_sum(x6, 1)
    plain = device_ms(lambda: fpm.axis_sum_plain(F, x6, 1), 1, warmup=0)
    w6 = x6.cpu().numpy().view(np.uint32)[..., 0].astype(np.int64)
    err = max_err(out, plain.out) + int(
        (out.cpu().numpy()[..., 0].astype(np.int64) !=
         w6.sum(axis=1) % F.p).sum())
    rows.record("fp_wire_round[fp24]",
                "longfellow_zk_tpu_torch/csrc/wire_round.cu",
                "longfellow_zk_tpu/fields/fp24.py:270", err,
                lambda: F6.lazy_sum(x6, 1), None,
                4 * 6 * n + 4 * 6 * (1 << 10), 0, plain=plain, iters=20)

    # no kernel, no fallback: a CUDA tensor of a field or mode without a
    # kernel raises
    M61 = fpm.PrimeField((1 << 61) - 1, "M61")
    m61 = M61.to_limbs([1, 2, 3], dev)
    F2x = fp2m.Fp2(fi.fp128())
    a2x = F2x.to_limbs([(1, 2)], dev)
    F6b = f24m.Fp24_6(f24m.fp24(), beta=3)
    a6b = F6b.to_limbs([(1, 2, 3, 4, 5, 6)], dev)
    refused = 0
    calls = [lambda: M61.mul(m61, m61), lambda: M61.inv(m61),
             lambda: M61.eq(m61, m61), lambda: M61.lazy_sum(m61, 0),
             lambda: F2x.inv(a2x), lambda: F2x.sqr(a2x),
             lambda: F6b.mul(a6b, a6b),
             lambda: fpm.fp_elementwise(M61, 11, m61, m61)]
    for call in calls:
        try:
            call()
        except (NotImplementedError, ValueError):
            refused += 1
    print("  fields or modes without a kernel: %d of %d CUDA calls refused"
          % (refused, len(calls)))
    if refused != len(calls):
        rows.failures.append("a CUDA call without a kernel ran")


def check_wide_sums(rows, api, F, tag):
    """K2 and K3 at instance `tag` (lazy_segment_sum and lazy_sum, which
    no path of that field calls): 2^20 terms, a quarter of them p - 1 (at
    P-521 the sums pass 2p below R), in 2^14 segments and as [2^10, 2^10]
    summed over axis 0; each against its plain version on the card and 8
    segments and 8 columns against the host ints.  Bound: the terms and
    the outputs (and the segment bounds) once."""
    from longfellow_zk_tpu_torch.fields import fp as fpm

    n, dev, rng = api.n, api.dev, api.rng
    eb = 4 * F.nlimb
    x = api.fast_elts(F)(n)
    x[: n // 4] = F.to_limbs(F.p - 1, dev)
    nseg = 1 << 14
    g = np.sort(rng.integers(0, nseg, n))
    st = np.searchsorted(g, np.arange(nseg), "left").astype(np.int32)
    en = np.searchsorted(g, np.arange(nseg), "right").astype(np.int32)
    starts = torch.as_tensor(st, device=dev)
    ends = torch.as_tensor(en, device=dev)
    out = F.lazy_segment_sum(x, starts, ends)
    plain = device_ms(lambda: fpm.segment_sum_plain(F, x, starts, ends), 1,
                      warmup=0)
    err = max_err(out, plain.out)
    for s in [0, 1, nseg // 2, nseg - 1] + list(rng.choice(nseg, 4)):
        want = sum(int(v) for v in np.ravel(F.from_limbs(
            x[st[s]:en[s]].cpu()))) % F.p if en[s] > st[s] else 0
        err += int(F.from_limbs(out[s].cpu()) != want)
    rows.record("fp_segment_sum[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/segsum.cu",
                "longfellow_zk_tpu/fields/fp.py:561", err,
                lambda: F.lazy_segment_sum(x, starts, ends), None,
                eb * n + (eb + 8) * nseg, 0, plain=plain, iters=20)
    x2 = x.reshape(1 << 10, 1 << 10, F.nlimb)
    out = F.lazy_sum(x2, 0)
    plain = device_ms(lambda: fpm.axis_sum_plain(F, x2, 0), 1, warmup=0)
    err = max_err(out, plain.out)
    for c in [0, 1, 1023] + list(rng.choice(1 << 10, 5)):
        want = sum(int(v) for v in np.ravel(F.from_limbs(
            x2[:, c].cpu()))) % F.p
        err += int(F.from_limbs(out[c].cpu()) != want)
    rows.record("fp_wire_round[%s]" % tag,
                "longfellow_zk_tpu_torch/csrc/wire_round.cu",
                "longfellow_zk_tpu/fields/fp.py:555", err,
                lambda: F.lazy_sum(x2, 0), None, eb * n + eb * (1 << 10), 0,
                plain=plain, iters=20)


def rs_interpolate_plain(rs, y):
    """rs.interpolate(y) of a ReedSolomon over the CRT convolution with
    every kernel's plain version, on y's device: the products by the
    binomials and the leading constants (K1), to_crt (K13), the forward
    and backward NTT of the residues (K4 [crt]), the product by the
    transformed kernel (K14), from_crt (K15)."""
    from longfellow_zk_tpu_torch.fields.fp import MUL, elementwise_plain
    from longfellow_zk_tpu_torch.fields import multiprime as mpm
    from longfellow_zk_tpu_torch.transforms import crt_conv
    from longfellow_zk_tpu_torch.transforms.ntt import ntt_plain

    F, ctx, inner = rs.F, rs.conv.ctx, rs.conv.inner
    mp, P = ctx.mp, inner.padding
    z = crt_conv.to_crt_plain(ctx, elementwise_plain(F, MUL, y, rs._binom))
    z = torch.cat([z, z.new_zeros(z.shape[:-2] + (P - inner.n, 1))], dim=-2)
    zh = ntt_plain(mp, z.reshape(-1, P, 1), inner.ntt.twiddles(P, True))
    zh = mpm.mp_elementwise_plain(mp, mpm.MUL, zh.reshape(z.shape),
                                  inner._yhat)
    zz = ntt_plain(mp, zh.reshape(-1, P, 1), inner.ntt.twiddles(P, False))
    T = crt_conv.from_crt_plain(ctx, zz.reshape(z.shape).narrow(
        -2, 0, inner.m).contiguous())
    tail = elementwise_plain(F, MUL, T[..., rs.n:, :].contiguous(),
                             rs._lead_tail)
    return torch.cat([y, tail], dim=-2)


def run_crt_route(F, tag, lanes, nrows, n, m, dev, kernels, rows, rng, smi):
    """Section 4l's path over field F (instance `tag`): rs_factory_for(F)
    (n, m).interpolate on nrows rows drawn from rng, with the launch counts
    set to zero just before it and read just after (K1, K13, K4 [crt],
    K14 and K15 must launch, no other kernel); the output against
    rs_interpolate_plain on the card and, at 8 points of 2 rows, against
    host barycentric Lagrange; then 5 encodes timed between CUDA events.
    The launches go to the kernel rows (K4's and K14's to the rows named
    with `lanes`, unless None).  Returns False on a failure."""
    from longfellow_zk_tpu_torch.zk.testing import rs_factory_for

    print("== section 4l: rs_factory_for(%s)(%d, %d).interpolate on %d rows "
          "(the CRT route) [at %.0f s]"
          % (F.name, n, m, nrows, time.perf_counter() - T0))
    rs = rs_factory_for(F, device=dev)(n, m)
    y = elts_of(F, rng, dev)(nrows * n).reshape(nrows, n, F.nlimb)
    k4, k14 = "fp_ntt[crt]", "mp_elementwise[crt]"
    expect = ["fp_elementwise[%s]" % tag, "crt_to[%s]" % tag, k4, k14,
              "crt_from[%s]" % tag]
    out, first_ms, launches, why = first_run(kernels, expect,
                                             lambda: rs.interpolate(y))
    print("first encode: %.1f ms; launches an encode: %s"
          % (first_ms, json.dumps(launches)))
    if why:
        print("FAIL:", why)
        return False
    err = max_err(out, rs_interpolate_plain(rs, y))
    bad = 0
    pts = sorted(int(v) for v in rng.choice(np.arange(n, m), 8,
                                            replace=False))
    for r in (0, nrows - 1):
        ys = [int(v) for v in F.from_limbs(y[r].cpu())]
        got = F.from_limbs(out[r, pts].cpu())
        bad += sum(int(g) != barycentric(F, ys, x) for g, x in zip(got, pts))
    print("the encode against its plain route on the card: max_abs_err %d "
          "(tolerance 0); %d of 16 points differ from host barycentric "
          "Lagrange (rows 0 and %d, points %s)"
          % (err, bad, nrows - 1, pts))
    if err or bad or out.shape != (nrows, m, F.nlimb):
        print("FAIL: the CRT encode over %s is wrong" % F.name)
        return False
    med, all_ms = event_ms(lambda: rs.interpolate(y))
    print("crt_rs_encode_%s_ms %.4f (median of 5 between CUDA events: %s; "
          "%s)" % (tag, med, ", ".join("%.4f" % v for v in all_ms), smi))
    for k, v in launches.items():
        if k in (k4, k14):
            if lanes is None:
                continue
            k += lanes
        rows.rows[k]["launches"] = v
    return True


def run_section_4l(rows, kernels, dev, rng, nrows, n, m, smi):
    """Section 4l, the rows: the field API at [p384] and [p521] (K1 at
    2^20 elements, K21 at 2^16); K2 and K3 at [fp64], [p256n],
    [p256k1n], [p384], [p521]; K13 and K15 at [p256n], [fp256], [p384],
    [p521] and K4 [crt] and K14 at 26 and 35 lanes, at the bitaddr
    tableau (nrows rows of m points); K19 and K20 [fp256x2] at the ECDSA
    Fp2 tableau (14 rows of 2,048); then the path: the CRT encode
    (n, m) over the P-256 order, P-384 and P-521 (run_crt_route).
    Returns False on a failure."""
    from longfellow_zk_tpu_torch.fields import fp as fpm
    from longfellow_zk_tpu_torch.fields import fp_instances as fi
    from longfellow_zk_tpu_torch.fields.fp2 import Fp2

    print("== section 4l: the last one-card instances [at %.0f s]"
          % (time.perf_counter() - T0))
    api = FieldApi(rows, dev, rng)
    wide = [(fi.p384_base(), "p384"), (fi.p521_base(), "p521")]
    for F, tag in wide:
        api.prime_rows(F, tag, [fpm.MUL, fpm.ADD, fpm.SUB])
    for F, tag in wide:
        api.split_shapes(F, tag)
    for F, tag in [(fi.fp64(), "fp64"), (fi.p256_scalar(), "p256n"),
                   (fi.p256k1_scalar(), "p256k1n")] + wide:
        check_wide_sums(rows, api, F, tag)
    for F, tag, lanes in [(fi.p256_scalar(), "p256n", None),
                          (fi.p256_base(), "fp256", None),
                          (fi.p384_base(), "p384", " vs=26"),
                          (fi.p521_base(), "p521", " vs=35")]:
        check_crt(rows, F, dev, nrows, m, rng, tag, lanes)
    F2 = Fp2(fi.p256_base())
    check_nussbaumer(rows, F2, dev, "fp256x2", rng, 14, 2048)
    if rows.failures:
        print("FAIL: kernels disagree with their plain versions:",
              rows.failures)
        return False
    for F, tag, lanes in [(fi.p256_scalar(), "p256n", None),
                          (fi.p384_base(), "p384", " vs=26"),
                          (fi.p521_base(), "p521", " vs=35")]:
        if not run_crt_route(F, tag, lanes, nrows, n, m, dev, kernels, rows,
                             rng, smi):
            return False
    return True


def zk_verify_fn(F, circ, rs, pub, meta, dev):
    """verify(data, phases): a ZkVerifier's recv_commitment + verify on the
    proof bytes data on `dev` (phases gets the ms of (construction and
    read_zk_proof, recv_commitment + verify)); False if data is not a
    proof."""
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
    from longfellow_zk_tpu_torch.zk.serialization import read_zk_proof
    from longfellow_zk_tpu_torch.zk.verifier import ZkVerifier

    def verify(data, phases):
        t0 = time.perf_counter()
        v = ZkVerifier(circ, F, rs, rate=meta["rate"], nreq=meta["nreq"],
                       device=dev)
        zkp = read_zk_proof(data, circ, v.param, F, meta["rate"],
                            meta["nreq"])
        if zkp is None:
            return False
        t1 = time.perf_counter()
        ts = Transcript(meta["transcript_label"].encode(),
                        version=meta["version"])
        v.recv_commitment(zkp, ts)
        ok, _ = v.verify(zkp, pub, ts)
        torch.cuda.synchronize()
        phases.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        return ok
    return verify


def flipped(data, i, bit):
    """data with bit `bit` of byte i flipped."""
    bad = bytearray(data)
    bad[i] ^= bit
    return bytes(bad)


def measure(metric, run, smi, phase_names):
    """Times 5 calls of run(phases) (median, min, max; the phase times,
    ms in the order of phase_names, that run appends to phases), then
    profiles one on the host (cProfile) and one on the card (busy share,
    top device operations)."""
    times, phases = [], []
    for _ in range(5):
        t = time.perf_counter()
        run(phases)
        times.append((time.perf_counter() - t) * 1e3)
    print("%s: %.3f (median of 5; min %.3f, max %.3f: %s) on %s"
          % (metric, statistics.median(times), min(times), max(times),
             ", ".join("%.1f" % x for x in times), smi))
    print("  " + ", ".join(
        "%s %.1f ms" % (nm, statistics.median(ph[i] for ph in phases))
        for i, nm in enumerate(phase_names)) + " (medians)")
    profile_one(run)
    return times


def profile_one(run):
    """Profiles one call of run(phases) on the host (cProfile) and one on
    the card (busy share, copies, top device operations).  Returns the
    copies of the card's call, {"DtoH": n, "HtoD": n}."""
    phases = []
    import cProfile
    import pstats
    cp = cProfile.Profile()
    cp.enable()
    run(phases)
    cp.disable()
    st = pstats.Stats(cp).stats
    total = sum(v[2] for v in st.values())
    print("host profile of one call (cProfile, %.1f ms of own time in "
          "all), by own time:" % (total * 1e3))
    for (fname, line, func), v in sorted(st.items(),
                                         key=lambda kv: -kv[1][2])[:14]:
        print("  %8.2f ms %7d calls  %s (%s:%d)" % (
            v[2] * 1e3, v[1], func, os.path.basename(fname), line))
    nprod = {f: sum(v[1] for (_, _, func), v in st.items() if func == f)
             for f in ("gf_mul_int", "mul_i")}
    print("host field products in the profiled call: %d gf_mul_int, %d "
          "mul_i calls" % (nprod["gf_mul_int"], nprod["mul_i"]))

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(phases)
        wall_ms = (time.perf_counter() - t) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.events():
        if e.device_type == cuda:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    copies = {d: sum(1 for e in prof.events() if e.device_type == cuda
                     and "Memcpy %s" % d in e.name) for d in ("DtoH", "HtoD")}
    print("copies in the profiled call: %d device-to-host, %d "
          "host-to-device" % (copies["DtoH"], copies["HtoD"]))
    busy_ms = sum(by_name.values())
    if busy_ms > 0:
        print("profiled call: %.1f ms wall, %.3f ms device busy "
              "(busy share %.4f)" % (wall_ms, busy_ms, busy_ms / wall_ms))
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print("  device %9.3f ms  %s" % (ms, kname[:90]))
        sums = port_kernel_sums(prof)
        print("port kernels of the profiled call (device ms, launches):",
              json.dumps(sums))
        print("port kernels by wrapper instance (device ms, launches):",
              json.dumps(wrapper_sums(sums)))
    else:
        print("profiled call: %.1f ms wall, device busy share not "
              "measured (the profiler recorded no device time)" % wall_ms)
    return copies


def port_kernel_sums(prof):
    """{port kernel instance: [device ms, launches]} over a profile's
    device records, by the kernel's name up to its arguments ("void
    k_round_tail<G128>(...)" -> "k_round_tail<G128>"), largest first."""
    cuda = torch.autograd.DeviceType.CUDA
    sums = {}
    for e in prof.events():
        if e.device_type != cuda or not PORT_KERNEL.search(e.name):
            continue
        k = e.name.split("(")[0].replace("void ", "").strip()
        v = sums.setdefault(k, [0.0, 0])
        v[0] += e.device_time / 1e3
        v[1] += 1
    return {k: [round(v[0], 3), v[1]] for k, v in
            sorted(sums.items(), key=lambda kv: -kv[1][0])}


# a port kernel's record name (up to its arguments) -> its wrapper's
# kernel and instance: K1's and K9's kernels of each mode together
WRAPPER_OF = ((re.compile(r"k_(?:fp_ew|fp_lane|fp_elementwise|fp_quad|"
                          r"fp_tile)<(\w+)"), "fp_elementwise<%s>"),
              (re.compile(r"k_g128_(?:ew|lane)<"), "fp_elementwise<G128>"),
              (re.compile(r"k_fs_(?:write|draw|step)<(\w+)"),
               "fs_oracle<%s>"))


def wrapper_sums(sums):
    """port_kernel_sums grouped by wrapper instance ("fp_elementwise<P256>"
    for K1's kernels of every mode at P-256, "fs_oracle<P256>" for K9's
    modes 0-8), largest first; other kernels as they are."""
    out = {}
    for k, (ms, n) in sums.items():
        key = k
        for rx, fmt in WRAPPER_OF:
            m = rx.search(k)
            if m:
                key = fmt % m.groups() if m.groups() else fmt
                break
        v = out.setdefault(key, [0.0, 0])
        v[0] += ms
        v[1] += n
    return {k: [round(v[0], 3), v[1]] for k, v in
            sorted(out.items(), key=lambda kv: -kv[1][0])}


def check_prove_syncs():
    """From here on, every prover's device chain, from the sumcheck's
    first round to its one fetch (ZkProver._prove_dev: the rounds, the
    constraints, the Ligero finish; the plain sumcheck's
    SumcheckProver._rounds), runs under
    torch.cuda.set_sync_debug_mode("error"): a host synchronisation there
    raises and fails the path."""
    from longfellow_zk_tpu_torch.sumcheck.prover import SumcheckProver
    from longfellow_zk_tpu_torch.zk.prover import ZkProver

    def checked(chain):
        def call(*args, **kwargs):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return chain(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return call

    ZkProver._prove_dev = checked(ZkProver._prove_dev)
    SumcheckProver._rounds = checked(SumcheckProver._rounds)


# the host transcript's exported state (hex) after each ZkProver.prove and
# ZkVerifier.verify since it was last emptied (record_states)
STATES = []


def record_states():
    """From here on, each ZkProver.prove and ZkVerifier.verify appends
    the exported state of its transcript to STATES when it returns."""
    from longfellow_zk_tpu_torch.zk.prover import ZkProver
    from longfellow_zk_tpu_torch.zk.verifier import ZkVerifier

    def recording(fn):
        def call(self, zkp, W, ts):
            out = fn(self, zkp, W, ts)
            STATES.append(ts.export_state().hex())
            return out
        return call

    ZkProver.prove = recording(ZkProver.prove)
    ZkVerifier.verify = recording(ZkVerifier.verify)


def states_differ(states, what):
    """Whether STATES differs from `states`, the committed states of the
    golden proof (testdata/transcript_states.json); prints which."""
    if STATES != states:
        print("FAIL: the transcript states after each %s differ from "
              "testdata/transcript_states.json: %s" % (what, STATES))
        return True
    print("transcript states after each %s (%d) equal "
          "testdata/transcript_states.json" % (what, len(states)))
    return False


def first_run(kernels, expect, fn):
    """fn() with the launch counts set to zero just before it and read
    just after: (its result, ms, launches of `expect`, failure or None).
    Fails if a kernel outside `expect` launched or one of it did not."""
    kernels.reset_launches()
    t = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t) * 1e3
    launches = {k: v for k, v in kernels.LAUNCHES.items() if k in expect}
    others = {k: v for k, v in kernels.LAUNCHES.items()
              if k not in expect and v}
    missing = [k for k in expect if launches.get(k, 0) == 0]
    why = None
    if others:
        why = "kernels of another field launched: %s" % others
    elif missing:
        why = "kernels not launched on the main path: %s" % missing
    return out, ms, launches, why


def run_path(label, metric, prove, golden, golden_what, states, kernels,
             rows, expect, smi, first_engine=None,
             phase_names=("commit", "prove"), rows_of=None):
    """Drives one prover path: the first proof (`first_engine`, by
    default DeterministicEngine()) with the launch counts set to zero
    just before it and read just after, its bytes held against `golden`
    and its transcript states against `states`; then `measure` under
    SecureRandomEngine().  `prove(engine, phases)`
    returns the proof bytes and appends its phase times (ms, in the order
    of phase_names) to phases.  The first proof's launches go to the
    kernel rows (only to those of rows_of if given).  Returns them, None
    on a failure."""
    from longfellow_zk_tpu_torch.random_oracle.engine import (
        DeterministicEngine, SecureRandomEngine)

    print("== %s [at %.0f s]" % (label, time.perf_counter() - T0))
    STATES.clear()
    proof, first_ms, launches, why = first_run(
        kernels, expect,
        lambda: prove(first_engine or DeterministicEngine(), []))
    print("first proof: %.1f ms (uploads the circuit), %d bytes"
          % (first_ms, len(proof)))
    print("launches in one proof:", json.dumps(launches))
    if proof != golden:
        print("FAIL: proof bytes differ from %s" % golden_what)
        return None
    print("proof bytes equal %s (%d bytes)" % (golden_what, len(golden)))
    if states_differ(states, "prove"):
        return None
    if why:
        print("FAIL:", why)
        return None
    for k, v in launches.items():
        if rows_of is None or k in rows_of:
            rows.rows[k]["launches"] = v
    measure(metric, lambda ph: prove(SecureRandomEngine(), ph), smi,
            phase_names)
    return launches


class BatchPhases:
    """While installed, the host clock of a batch's phases (ms): commit
    prep (each lane's pad and tableau rows on the host), device commit
    (LigeroProver.commit: the encode, hashes and heaps, one copy back),
    prove (ZkProver.prove_lanes but the assembly: the evaluation check,
    the uploads, the device chain, the one fetch) and assembly (each
    lane's proof from the fetch, its Merkle openings, write_zk_proof)."""

    def __init__(self):
        from longfellow_zk_tpu_torch.ligero.prover import LigeroProver
        from longfellow_zk_tpu_torch.sumcheck.prover import SumcheckProver
        from longfellow_zk_tpu_torch.zk import batch
        from longfellow_zk_tpu_torch.zk.prover import ZkProver

        self.ms = {}
        self.spots = [(ZkProver, "commit_lanes", "commit"),
                      (LigeroProver, "commit", "device commit"),
                      (ZkProver, "prove_lanes", "prove"),
                      (SumcheckProver, "_assemble", "assemble"),
                      (LigeroProver, "assemble", "assemble"),
                      (batch, "write_zk_proof", "write")]
        self.saved = [getattr(o, n) for o, n, _ in self.spots]

    def __enter__(self):
        for (o, n, key), fn in zip(self.spots, self.saved):
            setattr(o, n, self._timed(fn, key))
        return self

    def __exit__(self, *exc):
        for (o, n, _), fn in zip(self.spots, self.saved):
            setattr(o, n, fn)

    def _timed(self, fn, key):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms[key] = self.ms.get(key, 0.0) + \
                    (time.perf_counter() - t) * 1e3
        return call

    def take(self):
        """(commit prep, device commit, prove, assembly) since the last
        take."""
        m, self.ms = self.ms, {}

        def g(k):
            return m.get(k, 0.0)
        return (g("commit") - g("device commit"), g("device commit"),
                g("prove") - g("assemble"), g("assemble") + g("write"))


def run_batch_path(label, metric, F, circ, rs, Ws, tags, meta, golden, dev,
                   kernels, rows, expect, scalar_launches, smi, timed):
    """Drives the batch prover (zk/batch.py BatchZkProver) on the lanes
    Ws, lane i under transcript tag tags[i], from a fresh
    DeterministicEngine(), with the launch counts set to zero just before
    the batch and read just after: lane 0 (the golden's witness and tag)
    must equal `golden`, every lane the scalar ZkProver's proof with the
    same tag from one continued engine, every lane's final transcript
    state its scalar twin's, the launches of every kernel one scalar
    proof's (`scalar_launches`), and the port's ZkVerifier must accept
    every lane.  With `timed`, then times 5 batches under
    SecureRandomEngine() beside 5 runs of len(Ws) scalar proofs, in turns,
    and profiles one batch (its device-to-host copies must be one scalar
    proof's 3).  Returns False on a failure."""
    from longfellow_zk_tpu_torch.random_oracle.engine import (
        DeterministicEngine, SecureRandomEngine)
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
    from longfellow_zk_tpu_torch.zk.batch import BatchZkProver
    from longfellow_zk_tpu_torch.zk.proof import ZkProof
    from longfellow_zk_tpu_torch.zk.prover import ZkProver
    from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof

    print("== %s [at %.0f s]" % (label, time.perf_counter() - T0))
    B, rate, nreq = len(Ws), meta["rate"], meta["nreq"]

    def transcripts():
        return [Transcript(t, version=meta["version"]) for t in tags]

    bp = BatchZkProver(circ, F, rs, rate=rate, nreq=nreq, device=dev)

    def batch(engine, tss=None):
        out = bp.prove_batch(Ws, tss or transcripts(), engine)
        torch.cuda.synchronize()
        return out

    tss = transcripts()
    got, first_ms, launches, why = first_run(
        kernels, expect, lambda: batch(DeterministicEngine(), tss))
    print("first batch of %d: %.1f ms (uploads the lanes' tables), %s bytes"
          % (B, first_ms, ", ".join(str(len(g)) for g in got)))
    print("launches in one batch:", json.dumps(launches))
    if got[0] != golden:
        print("FAIL: lane 0 differs from the golden proof")
        return False
    print("lane 0 equals the golden proof (%d bytes)" % len(golden))

    def scalar(engine, i, W):
        zkp = ZkProof(rate=rate, nreq=nreq)
        prover = ZkProver(circ, F, rs, rate=rate, nreq=nreq, device=dev)
        ts = Transcript(tags[i], version=meta["version"])
        prover.commit(zkp, W, ts, engine)
        assert prover.prove(zkp, W, ts)
        return write_zk_proof(zkp, circ, prover.param, F), ts.export_state()

    eng = DeterministicEngine()
    twins = [scalar(eng, i, W) for i, W in enumerate(Ws)]
    bad = [i for i, (g, (w, _)) in enumerate(zip(got, twins)) if g != w]
    if bad:
        print("FAIL: lanes %s differ from their scalar proofs" % bad)
        return False
    if [ts.export_state() for ts in tss] != [st for _, st in twins]:
        print("FAIL: a lane's final transcript state differs from its "
              "scalar twin's")
        return False
    print("every lane equals the scalar proof with its tag and the "
          "continued stream, and ends its transcript in its twin's state")
    if why:
        print("FAIL:", why)
        return False
    if launches != scalar_launches:
        print("FAIL: the launches of a batch of %d differ from one scalar "
              "proof's %s" % (B, json.dumps(scalar_launches)))
        return False
    print("launches of the batch of %d equal one scalar proof's" % B)
    for i, (data, W) in enumerate(zip(got, Ws)):
        lane_meta = dict(meta, transcript_label=tags[i].decode())
        if zk_verify_fn(F, circ, rs, W[: circ.npub_in], lane_meta,
                        dev)(data, []) is not True:
            print("FAIL: the verifier refuses lane %d" % i)
            return False
    print("the port's ZkVerifier accepts all %d lanes on the card" % B)
    for k, v in launches.items():
        key = "%s lanes=%d" % (k, B)
        if key in rows.rows:
            rows.rows[key]["launches"] = v
    if not timed:
        return True

    bms, sms, phases = [], [], []
    with BatchPhases() as bph:
        for _ in range(5):
            t = time.perf_counter()
            batch(SecureRandomEngine())
            bms.append((time.perf_counter() - t) * 1e3)
            phases.append(bph.take())
            t = time.perf_counter()
            eng = SecureRandomEngine()
            for i, W in enumerate(Ws):
                scalar(eng, i, W)
            torch.cuda.synchronize()
            sms.append((time.perf_counter() - t) * 1e3)
            bph.take()
    per = [t / B for t in bms]
    rate_ = [B * 1e3 / t for t in bms]
    print("%s_per_proof_ms: %.3f (median of 5 batches of %d; min %.3f, max "
          "%.3f: %s) on %s" % (metric, statistics.median(per), B, min(per),
                               max(per), ", ".join("%.1f" % x for x in per),
                               smi))
    print("%s_proofs_per_s: %.3f (median of 5; min %.3f, max %.3f) on %s"
          % (metric, statistics.median(rate_), min(rate_), max(rate_), smi))
    print("  batch of %d: %.1f ms (median; min %.1f, max %.1f); " % (
        B, statistics.median(bms), min(bms), max(bms)) + ", ".join(
        "%s %.1f ms" % (nm, statistics.median(ph[i] for ph in phases))
        for i, nm in enumerate(("commit prep", "device commit", "prove",
                                "assembly"))) + " (medians)")
    sper = [t / B for t in sms]
    print("%d scalar proofs in turns with the batches: %.1f ms (median of "
          "5; min %.1f, max %.1f), %.3f ms a proof, %.3f proofs/s; the "
          "batch's proofs/s are %.2fx theirs" % (
              B, statistics.median(sms), min(sms), max(sms),
              statistics.median(sper), 1e3 / statistics.median(sper),
              statistics.median(sms) / statistics.median(bms)))
    copies = profile_one(lambda ph: batch(SecureRandomEngine()))
    if copies["DtoH"] != 3:
        print("FAIL: %d device-to-host copies in a batch, not 3"
              % copies["DtoH"])
        return False
    return True


def run_verifier_path(label, metric, verify, golden, states, bad, kernels,
                      rows, expect, smi, phase_names, timed=True):
    """Drives one verifier path: `verify(data, phases)` on the golden
    proof with the launch counts set to zero just before it and read just
    after (it must accept, end each ZkVerifier.verify in the state of
    `states`, and every kernel of `expect` launch; the counts go to the
    K7 rows), then on `bad`, a copy with one bit flipped
    (it must refuse); then, if timed, `measure` on the golden.  Returns
    False on a failure."""
    print("== %s [at %.0f s]" % (label, time.perf_counter() - T0))
    STATES.clear()
    ok, first_ms, launches, why = first_run(
        kernels, expect, lambda: verify(golden, []))
    print("first verification: %.1f ms, accepted: %s" % (first_ms, ok))
    print("launches in one verification:", json.dumps(launches))
    if ok is not True:
        print("FAIL: the golden proof is refused")
        return False
    if states_differ(states, "verify"):
        return False
    if why:
        print("FAIL:", why)
        return False
    for k, v in launches.items():
        if k.startswith("fp_quad_bind["):
            rows.rows[k]["launches"] = v
    if verify(bad, []) is not False:
        print("FAIL: a copy with one bit flipped is accepted")
        return False
    print("a copy with one bit flipped is refused")
    if timed:
        measure(metric, lambda ph: verify(golden, ph), smi, phase_names)
    return True


COPIES = 64
COPIES_LABEL = b"sha256-copies"


def listing(F, proof, aux, bindings, ts):
    """Every field element of a plain sumcheck proof as canonical hex (the
    format of testdata/sumcheck_sha256_copies64.json): per layer cp, hp,
    wc and the bound quad; the bindings q and g; the transcript's final
    state."""
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


def copy_split(prove):
    """Device ms of one proof: the copy rounds' own kernels (K16 and the
    K10 launches that follow one, its cubic mode), the wire rounds' (K3's
    wire sums and the K10 launches that follow them) and the rest (K1's
    binds and products, K2, K3's sums, K9, K23, copies; shared by
    both and by the evaluation), from the profiler's kernel names in
    stream order; and the wall ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        prove([])
        wall_ms = (time.perf_counter() - t) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    split = {"copy": 0.0, "wire": 0.0, "rest": 0.0}
    last = "rest"
    for e in sorted((e for e in prof.events() if e.device_type == cuda),
                    key=lambda e: e.time_range.start):
        ms = e.device_time / 1e3
        if "k_copy_round" in e.name:
            last = "copy"
            split["copy"] += ms
        elif "k_wire" in e.name:
            last = "wire"
            split["wire"] += ms
        elif "k_round_tail<" in e.name:
            split[last] += ms
        else:
            split["rest"] += ms
    return split, wall_ms


def run_copies_path(F, circ, W_host, dev, kernels, rows, smi):
    """Drives the plain sumcheck over the SHA-256 circuit with COPIES
    copies (copy c's witness W_host[c]): the proof of
    SumcheckProver.prove_with_witness on the card with the launch counts
    set to zero just before it and read just after (every kernel of the
    plain sumcheck launched, K16 and K10 cubic once a copy round: 60,
    nothing of another field; the rounds under the sync check), its
    listing and
    final transcript state held against
    testdata/sumcheck_sha256_copies64.json; the port's verify accepts it
    and refuses a one-bit flip in layer 0's first copy-round p(0) and one
    in a wc; then 5 proofs and 5 verifications timed, one profiled each,
    and the device ms of the copy rounds against the wire rounds.
    Returns False on a failure."""
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
    from longfellow_zk_tpu_torch.sumcheck.prover import SumcheckProver
    from longfellow_zk_tpu_torch.sumcheck.transcript_sumcheck import (
        TranscriptSumcheck)
    from longfellow_zk_tpu_torch.sumcheck.verifier import (
        bind_dense_host, verify)

    nc = len(W_host)
    print("== the plain sumcheck, SHA-256 x %d copies [at %.0f s]"
          % (nc, time.perf_counter() - T0))
    golden = json.load(open(os.path.join(
        TESTDATA, "sumcheck_sha256_copies64.json")))
    cc = dataclasses.replace(circ, nc=nc, logc=(nc - 1).bit_length())
    W0 = F.to_limbs([w for W in W_host for w in W], dev).reshape(
        (nc, cc.ninputs) + F.elt_shape)
    out = {}

    def prove(phases):
        t0 = time.perf_counter()
        ts = Transcript(COPIES_LABEL)
        tss = TranscriptSumcheck(ts, F)
        tss.write_input(W_host)
        t1 = time.perf_counter()
        proof, aux, b = SumcheckProver(F, dev).prove_with_witness(cc, W0, tss)
        torch.cuda.synchronize()
        phases.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        out.update(proof=proof, aux=aux, b=b, ts=ts)

    def verify_one(proof):
        ts = TranscriptSumcheck(Transcript(COPIES_LABEL), F)
        return verify(cc, proof, W_host, ts, F, device=dev)

    expect = [k for k in kernels.KERNELS if k.endswith("[fp128]") and
              k.startswith(("fp_elementwise[", "fp_segment_sum[",
                            "fp_wire_round[", "fs_oracle[",
                            "sumcheck_round_tail[", "copy_round_sums[",
                            "sumcheck_round_tail_cubic[", "layer_hv["))]
    _, first_ms, launches, why = first_run(kernels, expect,
                                           lambda: prove([]))
    print("first proof: %.1f ms (uploads the circuit's copy tables)"
          % first_ms)
    print("launches in one proof:", json.dumps(launches))
    got = listing(F, out["proof"], out["aux"], out["b"], out["ts"])
    if got != golden["listing"]:
        bad = [i for i, (a, b) in enumerate(zip(got["layers"],
                                                 golden["listing"]["layers"]))
               if a != b]
        print("FAIL: the proof differs from "
              "testdata/sumcheck_sha256_copies64.json (layers %s; q %s, g "
              "%s, state %s)" % (bad, got["q"] == golden["listing"]["q"],
                                 got["g"] == golden["listing"]["g"],
                                 got["transcript_state"] ==
                                 golden["listing"]["transcript_state"]))
        return False
    print("the proof's listing and final transcript state equal "
          "testdata/sumcheck_sha256_copies64.json (%s)" % golden["made_by"])
    if why:
        print("FAIL:", why)
        return False
    nround = cc.nl * cc.logc
    for k in ("copy_round_sums[fp128]", "sumcheck_round_tail_cubic[fp128]"):
        if launches[k] != nround:
            print("FAIL: %d %s launches, not %d" % (launches[k], k, nround))
            return False
    for k in ("copy_round_sums[fp128]", "sumcheck_round_tail_cubic[fp128]"):
        rows.rows[k]["launches"] = launches[k]

    proof = out["proof"]
    ok = verify_one(proof)
    bad_cp = copy.deepcopy(proof)
    bad_cp.layers[0].cp[0][0] ^= 1
    bad_wc = copy.deepcopy(proof)
    bad_wc.layers[0].wc[0] ^= 1
    refusals = (verify_one(bad_cp), verify_one(bad_wc))
    print("verify: %s; a flip in layer 0's first p(0): %s; a flip in a wc: "
          "%s" % (ok, refusals[0], refusals[1]))
    if ok != (True, "ok") or refusals != (
            (False, "claim != p(0) + p(1)"), (False, "got != claim (layer)")):
        print("FAIL: verify's verdicts differ from (True, ok), (False, "
              "claim != p(0) + p(1)), (False, got != claim (layer))")
        return False

    measure("sumcheck_sha256_copies64_prove_ms", prove, smi,
            ("write input", "prove"))
    split, wall = copy_split(prove)
    busy = sum(split.values())
    print("sumcheck_sha256_copies64 device ms of one proof: copy rounds "
          "%.3f (K16, K10 cubic), wire rounds %.3f (K3 wire sums, K10), "
          "the rest %.3f (K1, K2, K3 sums, K9, K23); %.1f ms wall, "
          "busy share %.4f on %s" % (split["copy"], split["wire"],
                                     split["rest"], wall, busy / wall, smi))

    def timed_verify(phases):
        t = time.perf_counter()
        assert verify_one(proof) == (True, "ok")
        phases.append(((time.perf_counter() - t) * 1e3,))

    # verify's binding of the inputs along the copies (its loop), alone
    t = time.perf_counter()
    W_cols = [[W_host[c][w] for c in range(nc)] for w in range(cc.ninputs)]
    for r in out["b"]["q"]:
        W_cols = [bind_dense_host(F, col, r) for col in W_cols]
    print("verify's input binding alone (%d columns of %d copies, %d "
          "products each, host): %.1f ms on %s" % (
              cc.ninputs, nc, nc - 1, (time.perf_counter() - t) * 1e3, smi))
    measure("sumcheck_sha256_copies64_verify_ms", timed_verify, smi,
            ("verify",))
    return True


def barycentric(F, ys, x):
    """The value at the point x of the polynomial of degree < len(ys)
    through (i, ys[i]), i = 0 .. len(ys) - 1 (x not among them)."""
    n, p = len(ys), F.p
    fact = [1] * n
    for i in range(1, n):
        fact[i] = fact[i - 1] * i % p
    ell, acc = 1, 0
    for j in range(n):
        ell = ell * (x - j) % p
    for i, y in enumerate(ys):
        w = fact[i] * fact[n - 1 - i] % p
        if (n - 1 - i) % 2:
            w = p - w
        acc = (acc + y * pow((x - i) * w % p, -1, p)) % p
    return ell * acc % p


def run_fft_phase(F, F2, omega2, order2, dev, kernels, smi):
    """bench.py's phase_fft on its own inputs (np.random.default_rng(0):
    limbs [8, 2^20] with the top limb & 0x7FFF, then limbs2 [2, 16, 2^20]
    likewise, the JAX package's Montgomery limbs) through the port's
    classes: MatmulNTT.fftb at 2^20 over Fp128 (held to K4's NTT.fftb,
    timed beside it), K4's Fp2 NTT.fftb at 2^20 (fftf(fftb(x)) = n x, two
    outputs against a host evaluation) and ReedSolomon(2^16, 3 2^16) over
    Fp128 through K4 (held to the MatmulNTT route and, at 4 points, to a
    host barycentric evaluation).  Each timed as a median of 5 between
    CUDA events.  Returns False on a failure."""
    from longfellow_zk_tpu_torch.fields.bridge import (
        fp2_from_jax, limbs_from_jax)
    from longfellow_zk_tpu_torch.fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER)
    from longfellow_zk_tpu_torch.transforms.matmul_ntt import MatmulNTT
    from longfellow_zk_tpu_torch.transforms.ntt import (
        NTT, ReedSolomon, _pow, make_fft_convolution_factory)

    print("== bench.py phase_fft on the port [at %.0f s]"
          % (time.perf_counter() - T0))
    n = 1 << 20
    rng = np.random.default_rng(0)
    limbs = rng.integers(0, 1 << 16, size=(8, n), dtype=np.uint32)
    limbs[7] &= 0x7FFF
    limbs2 = rng.integers(0, 1 << 16, size=(2, 16, n), dtype=np.uint32)
    limbs2[:, 15] &= 0x7FFF
    x = limbs_from_jax(limbs).to(dev)
    x2 = fp2_from_jax(limbs2).to(dev)
    ok = True

    mm = MatmulNTT(F, P128_OMEGA, P128_OMEGA_ORDER, 128, dev)
    nt = NTT(F, P128_OMEGA, P128_OMEGA_ORDER, dev)
    mm.prepare(n)
    nt.prepare(n)
    kernels.reset_launches()
    y = mm.fftb(x)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    same = torch.equal(y, nt.fftb(x))
    ok &= same and set(launches) == {"fp_matmul_ntt[fp128]",
                                     "fp_elementwise[fp128]"}
    t_mm, all_mm = event_ms(lambda: mm.fftb(x))
    t_k4, all_k4 = event_ms(lambda: nt.fftb(x))
    # bounds: the matmul route's three passes (B = 64, 128, 128; the int8
    # tensor cores) and two twiddle products; K4's n/2 (log n - 1)
    # products and its input, output and twiddles read or written once
    mm_ops = 2 * sum((n // B) * (16 * B) ** 2 for B in (64, 128, 128))
    b_mm = max(6 * 16 * n / HBM_BYTES_PER_S,
               mm_ops / INT8_OPS_PER_S + 2 * MUL_OPS["fp128"] * n /
               INT32_OPS_PER_S) * 1e3
    b_k4 = bound_ms(3 * 16 * n,
                    MUL_OPS["fp128"] * (n // 2) * (n.bit_length() - 2))
    print("fft_fp128_2e20_ms: %.4f (MatmulNTT.fftb, K17; median of 5: %s; "
          "bound %.5f ms), equal to K4's NTT.fftb: %s; K4 [fp128] NTT.fftb: "
          "%.4f ms (%s; bound %.5f ms, %s); launches of one transform: %s; "
          "on %s" % (
              t_mm, ", ".join("%.4f" % v for v in all_mm), b_mm, same, t_k4,
              ", ".join("%.4f" % v for v in all_k4), b_k4[0], b_k4[1],
              json.dumps(launches), smi))

    n2 = NTT(F2, omega2, order2, dev)
    n2.prepare(n)
    y2 = n2.fftb(x2)
    back = n2.fftf(y2)
    scaled = F2.mul_base(x2, F2.f.to_limbs(n, dev))
    round_trip = torch.equal(back, scaled)
    xs = F2.from_limbs(x2)
    w = n2._root_of_order(n, False)
    host = True
    for j in (1, 777777):
        wj = _pow(F2, w, j)
        acc = F2.of_scalar(0)
        for k in range(n - 1, -1, -1):
            acc = F2.add_i(F2.mul_i(acc, wj), tuple(xs[k]))
        host &= acc == F2.from_limbs(y2[j])
    ok &= round_trip and host
    t2, all2 = event_ms(lambda: n2.fftb(x2))
    print("fft_fp256x2_2e20_ms: %.4f (K4 [fp256x2] NTT.fftb; median of 5: "
          "%s); fftf(fftb(x)) = n x: %s; outputs 1 and 777777 equal a host "
          "evaluation: %s" % (t2, ", ".join("%.4f" % v for v in all2),
                              round_trip, host))

    k, m = 1 << 16, 3 << 16
    xr = x[:k].contiguous()
    rs4 = ReedSolomon(k, m, F, make_fft_convolution_factory(
        F, P128_OMEGA, P128_OMEGA_ORDER, dev), dev)
    rsm = ReedSolomon(k, m, F, make_fft_convolution_factory(
        F, P128_OMEGA, P128_OMEGA_ORDER, dev, ntt_impl=mm), dev)
    o4 = rs4.interpolate(xr)
    same_rs = torch.equal(o4, rsm.interpolate(xr))
    ys = [int(v) for v in F.from_limbs(xr)]
    pts = (k, k + 1, 2 * k + 12345, m - 1)
    bary = all(barycentric(F, ys, q) == F.from_limbs(o4[q]) for q in pts)
    ok &= same_rs and bary
    t_rs, all_rs = event_ms(lambda: rs4.interpolate(xr))
    t_rsm, _ = event_ms(lambda: rsm.interpolate(xr))
    print("rs_encode_fp128_2e16_x3_ms: %.4f (ReedSolomon(2^16, 3 2^16), "
          "K4; median of 5: %s), equal to the MatmulNTT route (%.4f ms): "
          "%s; points %s equal a host barycentric evaluation: %s" % (
              t_rs, ", ".join("%.4f" % v for v in all_rs), t_rsm, same_rs,
              list(pts), bary))
    if not ok:
        print("FAIL: a phase_fft check failed")
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from longfellow_zk_tpu_torch import kernels
    from longfellow_zk_tpu_torch.circuits.bitaddr.bitaddr import (
        BitaddrWitness)
    from longfellow_zk_tpu_torch.circuits.ecdsa.verify import compute_witness
    from longfellow_zk_tpu_torch.circuits.mdoc import api as mdoc_api
    from longfellow_zk_tpu_torch.circuits.mdoc.witness import (
        RequestedAttribute)
    from longfellow_zk_tpu_torch.circuits.mdoc.zk_spec import (
        find_zk_spec_by_version)
    from longfellow_zk_tpu_torch.circuits.sha.sha256 import (
        SHA256_INIT, pack_block_witness, sha256_pad, transform_block_witness)
    from longfellow_zk_tpu_torch.circuits.ripemd.reference import ripemd160
    from longfellow_zk_tpu_torch.ec.curves import (
        ecdsa_sign, p256_curve, p256k1_curve)
    from longfellow_zk_tpu_torch.fields import fp2 as fp2m
    from longfellow_zk_tpu_torch.fields.fp_instances import (
        P128_OMEGA, P128_OMEGA_ORDER, P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X,
        P256_FP2_ROOT_Y, fp128, p256_base, p256k1_base)
    from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
    from longfellow_zk_tpu_torch.proto.lfc1 import (
        FP128_ID, P256_ID, SECP_ID, read_circuit)
    from longfellow_zk_tpu_torch.random_oracle.engine import (
        DeterministicEngine)
    from longfellow_zk_tpu_torch.random_oracle.transcript import Transcript
    from longfellow_zk_tpu_torch.transforms.matmul_ntt import MatmulNTT
    from longfellow_zk_tpu_torch.transforms.ntt import (
        NTT, make_fft_convolution_factory)
    from longfellow_zk_tpu_torch.transforms.nussbaumer import (
        make_nussbaumer_convolution_factory)
    from longfellow_zk_tpu_torch.transforms.rfft import (
        make_rfft_ext_convolution_factory)
    from longfellow_zk_tpu_torch.zk.proof import ZkProof
    from longfellow_zk_tpu_torch.zk.prover import ZkProver
    from longfellow_zk_tpu_torch.zk.serialization import write_zk_proof
    from longfellow_zk_tpu_torch.transforms.crt_conv import (
        make_crt_convolution_factory)
    from longfellow_zk_tpu_torch.zk.testing import (
        rs_factory_for, rs_factory_with)

    # -- 1. the card ----------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("device:", name, "count:", count, "|", smi)
    print("torch", torch.__version__, "cuda", torch.version.cuda)
    global TOP_CLOCK_MHZ
    TOP_CLOCK_MHZ = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    print("top SM clock %.0f MHz (the one-thread chain bounds, the "
          "GF(2^128) table reads)" % TOP_CLOCK_MHZ)
    from longfellow_zk_tpu_torch.native import get_lib
    print("host SHA-256/AES:", "native C" if get_lib() is not None
          else "pure Python (no C compiler)")

    # -- 2. build -------------------------------------------------------
    t = time.perf_counter()
    logs = kernels.build_all(verbose=True)
    print("build: %.1f s (%d nvcc in parallel)"
          % (time.perf_counter() - t, len(logs)))
    for src, log in sorted(logs.items()):
        regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                if "registers" in ln]
        print("  %s: %s" % (src, "; ".join(regs)))

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    rows = Rows()

    # -- 3a. the Fp128 instances at the SHA-256 proof's shapes ----------------
    F = fp128()
    circ = read_circuit(F, FP128_ID, gzip.open(os.path.join(
        REPO, "artifacts", "sha256_1block_fp128.lfc1.gz"), "rb").read())
    check_fp_kernels(rows, F, circ, dev, "fp128", 1 << 15, (18, 2048), rng)
    check_ntt(rows, F, NTT(F, P128_OMEGA, P128_OMEGA_ORDER, dev), "fp128",
              18, 2048, elts_of(F, rng, dev))

    # -- 3b. the P-256 instances at the ECDSA proof's shapes ------------------
    FB = p256_base()
    F2 = fp2m.Fp2(FB)
    omega2 = (P256_FP2_ROOT_X, P256_FP2_ROOT_Y)
    ecirc = read_circuit(FB, P256_ID, gzip.open(os.path.join(
        REPO, "artifacts", "ecdsa_p256.lfc1.gz"), "rb").read())
    check_fp_kernels(rows, FB, ecirc, dev, "fp256", 1 << 13, (14, 2048), rng)
    elts_b = elts_of(FB, rng, dev)

    def elts2(n):
        return torch.stack([elts_b(n), elts_b(n)], dim=-2)

    check_ntt(rows, F2, NTT(F2, omega2, P256_FP2_ROOT_ORDER, dev),
              "fp256x2", 14, 2048, elts2)
    # K5 at 14 x 2048, the second operand a broadcast row (as the
    # convolution's yhat table)
    nt = 14 * 2048
    x2, y2 = elts2(nt).reshape(14, 2048, 2, FB.nlimb), elts2(2048)
    s2 = elts_b(nt).reshape(14, 2048, FB.nlimb)
    one = torch.zeros(FB.nlimb, dtype=torch.int32, device=dev)
    one[0] = 1
    err = 0
    for mode, b in ((fp2m.MUL, y2), (fp2m.ADD, y2), (fp2m.SUB, y2),
                    (fp2m.MUL_BASE, s2), (fp2m.MUL_BASE, one)):
        err = max(err, max_err(fp2m.fp2_elementwise(F2, mode, x2, b),
                               fp2m.fp2_elementwise_plain(F2, mode, x2, b)))
    rows.record("fp2_elementwise[fp256x2]",
                "longfellow_zk_tpu_torch/csrc/fp2_ops.cu",
                "longfellow_zk_tpu/fields/fp2.py:159", err,
                lambda: F2.mul(x2, y2),
                lambda: fp2m.fp2_elementwise_plain(F2, fp2m.MUL, x2, y2),
                64 * (2 * nt + 2048), MUL_OPS["fp256x2"] * nt)

    # -- 3c. the GF(2^128) instances at the mdoc hash proof's shapes ---------
    GF = gf2_128()
    circuit_bytes = open(os.path.join(REPO, "artifacts", "mdoc_v7_1attr.zst"),
                         "rb").read()
    c_sig, c_hash = mdoc_api.load_circuits(circuit_bytes)
    check_fp_kernels(rows, GF, c_hash, dev, "gf2_128", 266 * 3230,
                     (266, 3230), rng, dblock=921)
    check_k2_mdoc(rows, GF, c_hash, dev, rng)
    check_k1_gf2_mdoc(rows, GF, c_hash, dev, rng)
    check_lch14(rows, GF, dev, 266, 4151, rng)

    # -- 3d. K7 at the largest layer each verifier binds ------------------
    check_quad_bind(rows, F, circ, dev, "fp128", rng)
    check_quad_bind(rows, FB, c_sig, dev, "fp256", rng)
    check_quad_bind(rows, GF, c_hash, dev, "gf2_128", rng)

    # -- 3e. K8 at the commits' shapes ---------------------------------------
    mmeta = json.load(open(os.path.join(TESTDATA,
                                        "mdoc_v7_1attr.proof.json")))
    spec = find_zk_spec_by_version(mmeta["version"],
                                   len(mmeta["attributes"]))
    meta = json.load(open(os.path.join(TESTDATA,
                                       "sha256_1block_fp128.proof.json")))
    zp_sha = ZkProver(circ, F, None, rate=meta["rate"], nreq=meta["nreq"],
                      device=dev)
    rate, nreq = mdoc_api._rate_nreq(spec.version)
    zp_hash = ZkProver(c_hash, GF, None, rate=rate, nreq=nreq,
                       block_enc=spec.block_enc_hash, device=dev)
    lp_sha, lp_hash = zp_sha.param, zp_hash.param
    check_sha256(rows, dev, rng, [
        ("mdoc hash commit leaves", lp_hash.block_ext,
         32 + lp_hash.nrow * GF.kBytes),
        ("SHA-256 commit leaves", lp_sha.block_ext,
         32 + lp_sha.nrow * F.kBytes),
        ("a Merkle level", lp_hash.block_ext // 2, 64)])

    # -- 3f. K9 and K10 of each field -----------------------------------------
    clock_mhz = TOP_CLOCK_MHZ
    for Fx, tag in ((F, "fp128"), (FB, "fp256"), (GF, "gf2_128")):
        check_fs_oracle(rows, Fx, dev, tag, rng, clock_mhz)
        check_round_tail(rows, Fx, dev, tag, rng, clock_mhz)

    # -- 3g. K11, K12 and K9 mode 9 at the SHA-256, ECDSA and mdoc hash
    #        proofs' shapes ------------------------------------------------
    emeta = json.load(open(os.path.join(TESTDATA, "ecdsa_p256.proof.json")))
    zp_ecdsa = ZkProver(ecirc, FB, None, rate=emeta["rate"],
                        nreq=emeta["nreq"], device=dev)
    for zp, tag in ((zp_sha, "fp128"), (zp_ecdsa, "fp256"),
                    (zp_hash, "gf2_128")):
        check_fused(rows, zp.F, zp.circ, zp.param, zp.lqc, zp.n_witness,
                    dev, tag, rng, clock_mhz)

    # -- 3h. the lane axis (the batch prover's) at the SHA-256 shapes -------
    check_lanes(rows, F, circ, zp_sha.param, zp_sha.lqc, zp_sha.n_witness,
                dev, rng, clock_mhz)

    # -- 3i. the secp256k1 instances and the CRT kernels at the bitaddr
    #        proof's shapes ------------------------------------------------
    FK = p256k1_base()
    bmeta = json.load(open(os.path.join(TESTDATA,
                                        "bitaddr_p256k1.proof.json")))
    bcirc = read_circuit(FK, SECP_ID, gzip.open(os.path.join(
        REPO, bmeta["circuit"]), "rb").read())
    zp_bit = ZkProver(bcirc, FK, None, rate=bmeta["rate"],
                      nreq=bmeta["nreq"], device=dev)
    lp_bit = zp_bit.param
    print("bitaddr: %d layers, %d terms, tableau %d x %d (block %d, dblock "
          "%d)" % (bcirc.nl, sum(ly.nterms for ly in bcirc.layers),
                   lp_bit.nrow, lp_bit.block_enc, lp_bit.block,
                   lp_bit.dblock))
    check_fp_kernels(rows, FK, bcirc, dev, "fp256k1", 1 << 16,
                     (lp_bit.nrow, lp_bit.block_enc), rng,
                     dblock=lp_bit.dblock)
    check_crt(rows, FK, dev, lp_bit.nrow, lp_bit.block_enc, rng)
    check_quad_bind(rows, FK, bcirc, dev, "fp256k1", rng)
    check_fs_oracle(rows, FK, dev, "fp256k1", rng, clock_mhz)
    check_round_tail(rows, FK, dev, "fp256k1", rng, clock_mhz)
    check_fused(rows, FK, bcirc, lp_bit, zp_bit.lqc, zp_bit.n_witness, dev,
                "fp256k1", rng, clock_mhz)

    # -- 3j. the copy rounds: K16 at each field's largest layer over
    #        copies, K10's cubic mode ------------------------------------
    for Fx, cx, nc, tag in ((F, circ, COPIES, "fp128"), (FB, ecirc, 8, "fp256"),
                            (FK, bcirc, 8, "fp256k1"),
                            (GF, c_hash, 2, "gf2_128")):
        check_copy_round(rows, Fx, cx, nc, dev, tag, rng)
        check_round_tail(rows, Fx, dev, tag, rng, clock_mhz, cubic=True)

    # -- 3k. the Reed-Solomon transforms: K17 at 2^14 and 2^20 points, K18
    #        at the ECDSA tableau, K19 and K20 of each prime field at the
    #        shapes of the bitaddr tableau's recursion ---------------------
    check_matmul_ntt(rows, F, dev, rng)
    check_rfft(rows, F2, omega2, P256_FP2_ROOT_ORDER, dev, rng, 14, 2048)
    for Fx, tag in ((F, "fp128"), (FB, "fp256"), (FK, "fp256k1")):
        check_nussbaumer(rows, Fx, dev, tag, rng, lp_bit.nrow,
                         lp_bit.block_enc)

    # -- 3l. the field API no proof path calls, at 2^20 elements: K1's
    #        modes 5-9 and new instances, K21, K5's modes, K22, K2 and K3
    #        [fp24] ---------------------------------------------------------
    check_field_api(rows, dev, rng)

    # -- 3m. K9 at each proof's Ligero finish (its four response writes,
    #        its draw), K1 [fp256]'s bind, hv and bind_hv at the mdoc
    #        signature circuit's largest layer ---------------------------
    zp_sig = ZkProver(c_sig, FB, None, rate=rate, nreq=nreq,
                      block_enc=spec.block_enc_sig, device=dev)
    for Fx, tag, label, zp in ((F, "fp128", "sha", zp_sha),
                               (FB, "fp256", "ecdsa", zp_ecdsa),
                               (GF, "gf2_128", "mdoc hash", zp_hash),
                               (FB, "fp256", "mdoc sig", zp_sig),
                               (FK, "fp256k1", "bitaddr", zp_bit)):
        check_k9_ligero(rows, Fx, tag, label, zp, dev, rng, clock_mhz)
    check_k1_hand_round(rows, FB, "fp256", c_sig, dev, rng)

    # -- 3n. K23 (the layer prologue) at every layer of the five circuits,
    #        1 and 8 lanes; a row at each field's largest layer -----------
    for Fx, tag, cs in ((F, "fp128", [circ]), (FB, "fp256", [c_sig, ecirc]),
                        (GF, "gf2_128", [c_hash]),
                        (FK, "fp256k1", [bcirc])):
        check_layer_hv(rows, Fx, tag, cs, dev, rng)
    if rows.failures:
        print("FAIL: kernels disagree with their plain versions:",
              rows.failures)
        return 1

    def prover_kernels(*instances):
        """The ZK prover's kernels of those instances, all but K7, which
        only the verifier runs, K16 and K10's cubic mode, which only the
        plain sumcheck's copy rounds run, K17-K20, which only the
        Reed-Solomon routes of section 4h-4j run, K13 and K15 [fp256],
        which only section 4l's CRT route of the ECDSA proof runs, K21,
        which no path runs, and K8, which knows no field."""
        return [k for k in kernels.KERNELS if k.endswith(instances)
                and not k.startswith(("fp_quad_bind[", "copy_round_sums[",
                                      "sumcheck_round_tail_cubic[",
                                      "fp_matmul_ntt[", "rfft_pass[",
                                      "nb_butterfly[", "nb_base_conv[",
                                      "fp_inv["))
                and k not in ("crt_to[fp256]", "crt_from[fp256]")
                ] + ["sha256_msgs[bytes]"]

    check_prove_syncs()
    record_states()
    states = json.load(open(os.path.join(TESTDATA,
                                         "transcript_states.json")))

    def proof_fn(F, circ, rs, W, meta):
        def prove(engine, phases):
            zkp = ZkProof(rate=meta["rate"], nreq=meta["nreq"])
            prover = ZkProver(circ, F, rs, rate=meta["rate"],
                              nreq=meta["nreq"], device=dev)
            ts = Transcript(meta["transcript_label"].encode(),
                            version=meta["version"])
            t0 = time.perf_counter()
            prover.commit(zkp, W, ts, engine)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            assert prover.prove(zkp, W, ts)
            torch.cuda.synchronize()
            phases.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
            return write_zk_proof(zkp, circ, prover.param, F)
        return prove

    # -- 4a. the SHA-256 one-block proof ---------------------------------------
    golden = open(os.path.join(TESTDATA, "sha256_1block_fp128.proof.bin"),
                  "rb").read()

    def sha_witness(message):
        padded = sha256_pad(message)
        W = [F.of_scalar(1)] + [F.of_scalar((byte >> i) & 1)
                                for byte in padded for i in range(8)]
        W.extend(pack_block_witness(
            F, 4, [transform_block_witness(SHA256_INIT, padded)]))
        return W

    Wit = sha_witness(meta["message"].encode())
    rs = rs_factory_for(F, P128_OMEGA, P128_OMEGA_ORDER, device=dev)
    sha_launches = run_path("the Fp128 SHA-256 one-block proof",
                            "zk_sha256_1block_prove_ms",
                            proof_fn(F, circ, rs, Wit, meta), golden,
                            "the golden JAX proof",
                            states["sha256_1block_fp128"], kernels, rows,
                            prover_kernels("[fp128]"), smi)
    if sha_launches is None:
        return 1

    # -- 4b. the batched SHA-256 proofs (B = 8), as bench.py's phase_sha_batch:
    #        lane 0 the golden's, lanes 1-7 the messages msg0001..msg0007 --
    if not run_batch_path(
            "the batched SHA-256 proofs (B = %d)" % LANES,
            "zk_sha256_batch%d" % LANES, F, circ, rs,
            [Wit] + [sha_witness(b"msg%04d" % i) for i in range(1, LANES)],
            [meta["transcript_label"].encode()] +
            [b"bench%d" % i for i in range(1, LANES)], meta, golden, dev,
            kernels, rows, prover_kernels("[fp128]"), sha_launches, smi,
            timed=True):
        return 1

    # -- 4c. the P-256 ECDSA proof (the witness of bench.py's phase_ecdsa) -----
    egolden = open(os.path.join(TESTDATA, "ecdsa_p256.proof.bin"),
                   "rb").read()
    ec = p256_curve()

    def ecdsa_witness(seed):
        er = random.Random(seed)
        d = er.randrange(1, ec.order)
        pk = ec.normalize(ec.scalar_mult(ec.generator(), d))
        e = er.randrange(1, ec.order)
        r, s = ecdsa_sign(ec, d, e, er.randrange(1, ec.order))
        W = [FB.of_scalar(1), pk.x, pk.y, e % FB.p]
        W.extend(compute_witness(ec, pk.x, pk.y, e, r, s).fill())
        return W

    EW = ecdsa_witness(emeta["seed"])
    ers = rs_factory_for(FB, F2=F2, omega2=omega2,
                         omega_order=P256_FP2_ROOT_ORDER, device=dev)
    ecdsa_kernels = prover_kernels("[fp256]", "[fp256x2]")
    ecdsa_launches = run_path("the P-256 ECDSA proof", "ecdsa_zk_prover_ms",
                              proof_fn(FB, ecirc, ers, EW, emeta), egolden,
                              "the golden JAX proof", states["ecdsa_p256"],
                              kernels, rows, ecdsa_kernels, smi)
    if ecdsa_launches is None:
        return 1

    # -- 4d. a batch of 2 ECDSA proofs: K4 [fp256x2] and K5 on stacked lanes
    if not run_batch_path(
            "the batched P-256 ECDSA proofs (B = 2)", "ecdsa_zk_batch2",
            FB, ecirc, ers, [EW, ecdsa_witness(emeta["seed"] + 1)],
            [emeta["transcript_label"].encode(), b"bench1"], emeta, egolden,
            dev, kernels, rows, ecdsa_kernels, ecdsa_launches, smi,
            timed=False):
        return 1

    # -- 4e. the mdoc presentation, through run_mdoc_prover ------------------
    mgolden = open(os.path.join(TESTDATA, "mdoc_v7_1attr.proof.bin"),
                   "rb").read()
    ex = json.load(open(os.path.join(REPO, mmeta["examples"])))[
        mmeta["example"]]
    attrs = [RequestedAttribute(id=a["id"].encode(),
                                cbor_value=bytes.fromhex(a["cbor_value"]))
             for a in mmeta["attributes"]]

    def mdoc_prove(engine, phases):
        ph = []
        out = mdoc_api.run_mdoc_prover(
            circuit_bytes, bytes.fromhex(ex["mdoc"]), int(ex["pkx"], 16),
            int(ex["pky"], 16), bytes.fromhex(ex["transcript"]), attrs,
            ex["now"].encode(), spec, rng=engine, device=dev, phases=ph)
        phases.append(tuple(ph))
        return out

    if not run_path("the mdoc presentation (run_mdoc_prover)",
                    "mdoc_prover_ms", mdoc_prove, mgolden,
                    "the golden mdoc proof", states["mdoc_v7_1attr"],
                    kernels, rows,
                    prover_kernels("[gf2_128]", "[fp256]", "[fp256x2]"),
                    smi, first_engine=DeterministicEngine(
                        mmeta["engine_seed"].encode()),
                    phase_names=("hash commit", "sig commit", "hash prove",
                                 "sig prove")):
        return 1

    # -- 4f. the secp256k1 bitaddr proof, with the CRT Reed-Solomon code ----
    bgolden = open(os.path.join(TESTDATA, "bitaddr_p256k1.proof.bin"),
                   "rb").read()
    eck = p256k1_curve()
    sk = random.Random(bmeta["seed"]).randrange(1, eck.order)
    bw = BitaddrWitness(eck, FK)
    bw.compute_witness(sk)
    pk = eck.normalize(eck.scalar_mult(eck.generator(), sk))
    compressed = bytes([2 + (pk.y & 1)]) + pk.x.to_bytes(32, "big")
    addr = int.from_bytes(ripemd160(hashlib.sha256(compressed).digest()),
                          "big")
    assert bw.addr == addr
    BW = [FK.of_scalar(1), addr % FK.p] + bw.fill()
    brs = rs_factory_for(FK, device=dev)
    if run_path("the secp256k1 bitaddr proof (CRT Reed-Solomon)",
                "bitaddr_zk_prover_ms", proof_fn(FK, bcirc, brs, BW, bmeta),
                bgolden, "the golden bitaddr proof",
                states["bitaddr_p256k1"], kernels, rows,
                prover_kernels("[fp256k1]", "[crt]"), smi) is None:
        return 1

    # -- 4g. the plain sumcheck over the SHA-256 circuit x 64 copies -------
    if not run_copies_path(F, circ, [sha_witness(m) for m in (
            [b"abc"] + [b"msg%04d" % i for i in range(1, COPIES)])], dev,
            kernels, rows, smi):
        return 1

    # -- 4h. the SHA-256 proof, its Reed-Solomon code through the matmul NTT
    #        (K17 in place of K4 [fp128]) ---------------------------------
    mrs = rs_factory_with(F, make_fft_convolution_factory(
        F, P128_OMEGA, P128_OMEGA_ORDER, dev,
        ntt_impl=MatmulNTT(F, P128_OMEGA, P128_OMEGA_ORDER, 128, dev)), dev)
    mm_kernels = [k for k in prover_kernels("[fp128]")
                  if k != "fp_ntt[fp128]"] + ["fp_matmul_ntt[fp128]"]
    if run_path("the Fp128 SHA-256 proof, RS through the matmul NTT",
                "zk_sha256_1block_prove_matmul_ntt_ms",
                proof_fn(F, circ, mrs, Wit, meta), golden,
                "the golden JAX proof", states["sha256_1block_fp128"],
                kernels, rows, mm_kernels, smi,
                rows_of=("fp_matmul_ntt[fp128]",)) is None:
        return 1
    if not run_verifier_path(
            "the Fp128 SHA-256 verifier, RS through the matmul NTT", None,
            zk_verify_fn(F, circ, mrs, Wit[: circ.npub_in], meta, dev),
            golden, states["sha256_1block_fp128"], flipped(golden, 32, 1),
            kernels, rows,
            ["fp_elementwise[fp128]", "fp_quad_bind[fp128]",
             "fp_matmul_ntt[fp128]"], smi, None, timed=False):
        return 1

    # -- 4i. the P-256 ECDSA proof, its Reed-Solomon code through the
    #        half-complex RFFT (K18 and K4 [fp256x2], no K5) --------------
    rrs = rs_factory_with(FB, make_rfft_ext_convolution_factory(
        FB, F2, omega2, P256_FP2_ROOT_ORDER, dev), dev)
    rf_kernels = [k for k in ecdsa_kernels
                  if k != "fp2_elementwise[fp256x2]"] + \
        ["rfft_pass[fp256x2]"]
    if run_path("the P-256 ECDSA proof, RS through the half-complex RFFT",
                "ecdsa_zk_prover_rfft_ms",
                proof_fn(FB, ecirc, rrs, EW, emeta),
                egolden, "the golden JAX proof", states["ecdsa_p256"],
                kernels, rows, rf_kernels, smi,
                rows_of=("rfft_pass[fp256x2]",)) is None:
        return 1
    if not run_verifier_path(
            "the P-256 ECDSA verifier, RS through the half-complex RFFT",
            None, zk_verify_fn(FB, ecirc, rrs, EW[: ecirc.npub_in], emeta,
                               dev),
            egolden, states["ecdsa_p256"], flipped(egolden, 32, 1), kernels,
            rows,
            ["fp_elementwise[fp256]", "fp_quad_bind[fp256]",
             "fp_ntt[fp256x2]", "rfft_pass[fp256x2]"], smi, None,
            timed=False):
        return 1

    # -- 4j. the secp256k1 bitaddr proof, its Reed-Solomon code through
    #        Nussbaumer (K19, K20 in place of K13-K15 and K4 [crt]) -------
    nrs = rs_factory_with(FK, make_nussbaumer_convolution_factory(FK, dev),
                          dev)
    nb_kernels = [k for k in prover_kernels("[fp256k1]")
                  if k not in ("crt_to[fp256k1]", "crt_from[fp256k1]")] + \
        ["nb_butterfly[fp256k1]", "nb_base_conv[fp256k1]"]
    if run_path("the secp256k1 bitaddr proof, RS through Nussbaumer",
                "bitaddr_zk_prover_nussbaumer_ms",
                proof_fn(FK, bcirc, nrs, BW, bmeta), bgolden,
                "the golden bitaddr proof", states["bitaddr_p256k1"],
                kernels, rows, nb_kernels, smi,
                rows_of=("nb_butterfly[fp256k1]",
                         "nb_base_conv[fp256k1]")) is None:
        return 1
    if not run_verifier_path(
            "the secp256k1 bitaddr verifier, RS through Nussbaumer", None,
            zk_verify_fn(FK, bcirc, nrs, BW[: bcirc.npub_in], bmeta, dev),
            bgolden, states["bitaddr_p256k1"], flipped(bgolden, 32, 1),
            kernels, rows,
            ["fp_elementwise[fp256k1]", "fp_quad_bind[fp256k1]",
             "nb_butterfly[fp256k1]", "nb_base_conv[fp256k1]"], smi, None,
            timed=False):
        return 1

    # -- 4k. bench.py's phase_fft on its inputs ----------------------------
    if not run_fft_phase(F, F2, omega2, P256_FP2_ROOT_ORDER, dev, kernels,
                         smi):
        return 1

    # -- 4l. the last one-card instances (the field API at P-384 and P-521,
    #        K2 and K3 at five instances, K13 and K15 at four, K4 [crt] and
    #        K14 at 26 and 35 lanes, K19 and K20 [fp256x2]), the CRT encode
    #        at the bitaddr shape over the P-256 order, P-384 and P-521, and
    #        the ECDSA proof through the CRT convolution ------------------
    t4l = time.perf_counter()
    if not run_section_4l(rows, kernels, dev, rng, lp_bit.nrow, lp_bit.block,
                          lp_bit.block_enc, smi):
        return 1
    crs = rs_factory_with(FB, make_crt_convolution_factory(FB, dev), dev)
    crt_kernels = [k for k in ecdsa_kernels
                   if k not in ("fp_ntt[fp256x2]",
                                "fp2_elementwise[fp256x2]")] + \
        ["crt_to[fp256]", "crt_from[fp256]", "fp_ntt[crt]",
         "mp_elementwise[crt]"]
    if run_path("the P-256 ECDSA proof, RS through the CRT convolution",
                "ecdsa_zk_prover_crt_ms",
                proof_fn(FB, ecirc, crs, EW, emeta), egolden,
                "the golden JAX proof", states["ecdsa_p256"], kernels, rows,
                crt_kernels, smi,
                rows_of=("crt_to[fp256]", "crt_from[fp256]")) is None:
        return 1
    if not run_verifier_path(
            "the P-256 ECDSA verifier, RS through the CRT convolution", None,
            zk_verify_fn(FB, ecirc, crs, EW[: ecirc.npub_in], emeta, dev),
            egolden, states["ecdsa_p256"], flipped(egolden, 32, 1), kernels,
            rows,
            ["fp_elementwise[fp256]", "fp_quad_bind[fp256]", "crt_to[fp256]",
             "fp_ntt[crt]", "mp_elementwise[crt]", "crt_from[fp256]"], smi,
            None, timed=False):
        return 1
    print("section 4l: %.1f s" % (time.perf_counter() - t4l))

    # -- 4m. the multi-card paths at world = the cards visible (one process
    #        a card, NCCL): the sharded NTT, the sumcheck's sharded copy
    #        rounds, ZkProver and BatchZkProver on a mesh, sharded_rs_encode
    from longfellow_zk_tpu_torch.parallel import smoke as psmoke

    t4m = time.perf_counter()
    print("== section 4m: the multi-card paths at world %d [at %.0f s]"
          % (count, t4m - T0))
    torch.cuda.empty_cache()
    ok_m, _ = psmoke.run(count, timeout_s=600)
    print("section 4m: %.1f s" % (time.perf_counter() - t4m))
    if not ok_m:
        print("FAIL: a multi-card path differs from its golden or its "
              "one-card run, or left a kernel of its path unlaunched")
        return 1

    # -- 5. the verifiers on the golden proofs ------------------------------
    # the first sumcheck element of a ZK proof starts after the 32-byte root
    if not run_verifier_path(
            "the Fp128 SHA-256 one-block verifier",
            "zk_sha256_1block_verify_ms",
            zk_verify_fn(F, circ, rs, Wit[: circ.npub_in], meta, dev), golden,
            states["sha256_1block_fp128"], flipped(golden, 32, 1), kernels,
            rows,
            ["fp_elementwise[fp128]", "fp_quad_bind[fp128]",
             "fp_ntt[fp128]"], smi, ("read", "recv_commitment + verify")):
        return 1
    if not run_verifier_path(
            "the P-256 ECDSA verifier", "ecdsa_zk_verifier_ms",
            zk_verify_fn(FB, ecirc, ers, EW[: ecirc.npub_in], emeta,
                         dev),
            egolden, states["ecdsa_p256"], flipped(egolden, 32, 1), kernels,
            rows,
            ["fp_elementwise[fp256]", "fp_quad_bind[fp256]",
             "fp_ntt[fp256x2]", "fp2_elementwise[fp256x2]"], smi,
            ("read", "recv_commitment + verify")):
        return 1

    def mdoc_verify(data, phases):
        ph = []
        ok = mdoc_api.run_mdoc_verifier(
            circuit_bytes, int(ex["pkx"], 16), int(ex["pky"], 16),
            bytes.fromhex(ex["transcript"]), attrs, ex["now"].encode(), data,
            ex["doc_type"].encode(), spec, device=dev, phases=ph)
        phases.append(tuple(ph))
        return ok

    # the bit that tests/test_torch_golden.py flips: the hash proof's
    # sumcheck part, after the 6 MACs and the root
    if not run_verifier_path(
            "the mdoc presentation verifier (run_mdoc_verifier)",
            "mdoc_verifier_ms", mdoc_verify, mgolden,
            states["mdoc_v7_1attr"], flipped(mgolden, 6 * 16 + 32 + 5, 0x10),
            kernels, rows,
            ["fp_elementwise[gf2_128]", "fp_quad_bind[gf2_128]",
             "gf2_lch14[gf2_128]", "fp_elementwise[fp256]",
             "fp_quad_bind[fp256]", "fp_ntt[fp256x2]",
             "fp2_elementwise[fp256x2]"], smi,
            ("read", "hash verify", "sig verify")):
        return 1

    if not run_verifier_path(
            "the secp256k1 bitaddr verifier", "bitaddr_zk_verifier_ms",
            zk_verify_fn(FK, bcirc, brs, BW[: bcirc.npub_in], bmeta, dev),
            bgolden, states["bitaddr_p256k1"], flipped(bgolden, 32, 1),
            kernels, rows,
            ["fp_elementwise[fp256k1]", "fp_quad_bind[fp256k1]",
             "crt_to[fp256k1]", "fp_ntt[crt]", "mp_elementwise[crt]",
             "crt_from[fp256k1]"], smi,
            ("read", "recv_commitment + verify")):
        return 1

    # -- 6. results ---------------------------------------------------------
    print("every phase passed in %.0f s" % (time.perf_counter() - T0))
    timed_by_events = [(r["name"], k) for r in rows.rows.values()
                       for k in ("ms_by", "plain_ms_by", "library_ms_by")
                       if not r.get(k, "profiler").startswith("profiler")]
    cold = [r["name"] for r in rows.rows.values() if "cold" in r["ms_by"]]
    print("%d kernel rows; times by CUDA events, not the profiler: %s; "
          "timed with a cold L2 (below their bound back to back): %s; "
          "below their bound with a cold L2 too (unverified): %s"
          % (len(rows.rows), timed_by_events or "none", cold or "none",
             rows.below_bound or "none"))
    print(json.dumps({"kernels": list(rows.rows.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
