"""Build, load and launch the port's hand-written CUDA kernels.

Each source under `csrc/` is compiled by its own `nvcc` (all started
together) into a shared library with a plain C interface, in the
package's ignored build directory `_build/`, at first use; the libraries
are loaded with ctypes.  Nothing here runs when the package is imported.
The sources share the field arithmetic of `csrc/fp.cuh`, templated on the
field (K3, K7 and K16 also the two-pass sum of `csrc/reduce.cuh`, K8-K10
the SHA-256 of `csrc/sha256.cuh`, K9 and K10 the Fiat-Shamir oracle of
`csrc/fs.cuh`, K10 alone its products of `csrc/rt_mul.cuh`, K4 [crt]
and K13-K15 the 32-bit prime lanes of `csrc/mp.cuh`); each kernel has one instance (and one C
entry point) per field.  K9's mode 9 (CHOOSE) has entry points of its own,
`fs_choose`, and so has K10's cubic mode (the copy rounds' tail),
`sumcheck_round_tail_cubic`, so that their launches are counted apart:

    K1 fp_elementwise  fp_ops.cu      P gf2_128 fp24 fp64 p256n p256k1n
                                      p384 p521      fields/fp.py
    K2 fp_segment_sum  segsum.cu      P gf2_128 fp24 fp64 p256n p256k1n
                                      p384 p521      fields/fp.py
    K3 fp_wire_round   wire_round.cu  P gf2_128 fp24 fp64 p256n p256k1n
                                      p384 p521      fields/fp.py
    K4 fp_ntt          ntt.cu         fp128 fp256x2 crt
                                                     transforms/ntt.py
    K5 fp2_elementwise fp2_ops.cu     fp256x2        fields/fp2.py
    K6 gf2_lch14       lch14.cu       gf2_128        transforms/lch14.py
    K7 fp_quad_bind    quad_bind.cu   P gf2_128      sumcheck/verifier.py
    K8 sha256_msgs     sha256.cu      bytes          merkle/sha256_dev.py
    K9 fs_oracle       fs.cu          P gf2_128      random_oracle/device_fs.py
    K9 mode 9 fs_choose
                       fs.cu          P gf2_128      random_oracle/device_fs.py
    K10 sumcheck_round_tail
                       round_tail.cu  P gf2_128      random_oracle/device_fs.py
    K10 cubic sumcheck_round_tail_cubic
                       round_tail.cu  P gf2_128      random_oracle/device_fs.py
    K11 zk_constraints constraints.cu P gf2_128      zk/fused.py
    K12 ligero_inner_product
                       ligero_a.cu    P gf2_128      zk/fused.py
    K13 crt_to         crt.cu         fp256k1 p256n fp256 p384 p521
                                                     transforms/crt_conv.py
    K14 mp_elementwise crt.cu         crt            fields/multiprime.py
    K15 crt_from       crt.cu         fp256k1 p256n fp256 p384 p521
                                                     transforms/crt_conv.py
    K16 copy_round_sums
                       copy_round.cu  P gf2_128      fields/fp.py
    K17 fp_matmul_ntt  matmul_ntt.cu  fp128          transforms/matmul_ntt.py
    K18 rfft_pass      rfft.cu        fp256x2        transforms/rfft.py
    K19 nb_butterfly   nussbaumer.cu  P fp256x2      transforms/nussbaumer.py
    K20 nb_base_conv   nussbaumer.cu  P fp256x2      transforms/nussbaumer.py
    K21 fp_inv         inv.cu         P gf2_128 fp24 fp64 p256n p256k1n
                                      p384 p521 fp256x2
                                                     fields/fp.py, gf2.py,
                                                     fp2.py
    K22 fp24x6_elementwise
                       fp24x6.cu      fp24x6         fields/fp24.py
    K23 layer_hv       layer_hv.cu    P gf2_128      fields/fp.py

(P: the prime fields fp128, fp256 and fp256k1.  fp128: p = 2^128 -
2^108 + 1; fp256: the P-256 base field; fp256x2: Fp2 over it; fp256k1:
the secp256k1 base field; fp24: the ML-DSA prime 2^23 - 2^13 + 1, one
word; fp24x6: its sextic extension Fp24_6; fp64: 2^64 - 2^32 + 1, two
words; p256n and p256k1n: the P-256 and secp256k1 group orders; p384
and p521: the NIST P-384 and P-521 base fields, 12 and 17 words; crt:
the multi-prime field of the CRT convolution, 32-bit residue lanes
modulo the primes of csrc/mp.cuh, any number of lanes up to 40 (18 for
the 256-bit fields, 26 for P-384, 35 for P-521); gf2_128: GF(2^128),
csrc/gf2.cuh; bytes: K8 hashes bytes and knows no field.)  K1's modes
5-9 (sqr, neg, eq, is_zero, select), K5's, K21 and K22 (Fp24_6's mul,
sqr and inv; its per-coefficient ops are K1 [fp24] on the six words),
and K2 and K3 at fp64, p256n, p256k1n, p384 and p521 are the field API
that no proof path calls (the JAX package's tests drive it):
chip_smoke.py's sections 3l and 4l check them on the card.  K1's bind
and hv, K3, K9 (mode 9 too), K10 (its cubic mode too), K11, K12 and K23
take a lane axis: the proofs of a batch (zk/batch.py) run in the launches of
one proof.  A kernel's name
here is "kernel[instance]".  `LAUNCHES` counts, per instance, the CUDA
launches its wrapper made (K2: one a call, its route one kernel or two); a run sets the counts to zero with
`reset_launches()` and reads them after.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import re
import shutil
import subprocess
import threading

import torch

from .native import PKG_DIR, build_dir

CSRC = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# the instances of K1-K3: every prime field of fields/fp_instances.py and
# GF(2^128)
_PRIME_API = ("fp128", "fp256", "fp256k1", "gf2_128", "fp24", "fp64", "p256n",
              "p256k1n", "p384", "p521")
# the target fields of the CRT convolution's conversions (K13, K15)
_CRT_TARGETS = ("fp256k1", "p256n", "fp256", "p384", "p521")

# kernel -> (source, argtypes, instances); the C entry point of an
# instance is "<kernel>_<instance>"
_SOURCES = {
    "fp_elementwise": ("fp_ops.cu", [_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL,
                                     _P, _P, _LL, _I, _P],
                       _PRIME_API),
    "fp_segment_sum": ("segsum.cu", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _I, _LL, _I, _P, _P],
                       _PRIME_API),
    "fp_wire_round": ("wire_round.cu", [_I, _P, _P, _P, _P, _P, _P, _P, _LL,
                                        _LL, _LL, _LL, _I, _I, _I, _I, _P, _P],
                      _PRIME_API),
    "fp_ntt": ("ntt.cu", [_P, _P, _P, _LL, _I, _LL, _P],
               ("fp128", "fp256x2", "crt")),
    "fp2_elementwise": ("fp2_ops.cu", [_I, _P, _P, _P, _P, _LL, _LL, _LL,
                                       _P], ("fp256x2",)),
    "gf2_lch14": ("lch14.cu", [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _P], ("gf2_128",)),
    "fp_quad_bind": ("quad_bind.cu", [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _LL, _I, _P, _P],
                     ("fp128", "fp256", "fp256k1", "gf2_128")),
    "sha256_msgs": ("sha256.cu", [_P, _P, _LL, _I, _P], ("bytes",)),
    "fs_oracle": ("fs.cu", [_I, _P, _P, _P, _P, _LL, _I, _LL, _LL, _P],
                  ("fp128", "fp256", "fp256k1", "gf2_128")),
    "fs_choose": ("fs.cu", [_P, _P, _P, _LL, _LL, _I, _P],
                  ("fp128", "fp256", "fp256k1", "gf2_128")),
    "sumcheck_round_tail": ("round_tail.cu", [_P, _P, _P, _P, _P, _P, _P, _I,
                                              _LL, _LL, _P],
                            ("fp128", "fp256", "fp256k1", "gf2_128")),
    "sumcheck_round_tail_cubic": ("round_tail.cu", [_P, _P, _P, _P, _P, _P,
                                                    _I, _LL, _LL, _P],
                                  ("fp128", "fp256", "fp256k1", "gf2_128")),
    "zk_constraints": ("constraints.cu", [_P, _I, _I, _P, _P, _P, _P, _P, _I,
                                          _LL, _LL, _P],
                       ("fp128", "fp256", "fp256k1", "gf2_128")),
    "ligero_inner_product": ("ligero_a.cu", [_P, _P, _P, _P, _P, _P, _LL, _I,
                                             _I, _I, _I, _LL, _LL, _LL, _P],
                             ("fp128", "fp256", "fp256k1", "gf2_128")),
    "crt_to": ("crt.cu", [_P, _P, _P, _LL, _I, _P], _CRT_TARGETS),
    "mp_elementwise": ("crt.cu", [_I, _P, _P, _P, _LL, _I, _LL, _LL, _LL, _P],
                       ("crt",)),
    "crt_from": ("crt.cu", [_P, _P, _P, _P, _LL, _I, _P], _CRT_TARGETS),
    "copy_round_sums": ("copy_round.cu", [_P, _P, _P, _P, _P, _P, _P, _LL,
                                          _LL, _I, _P],
                        ("fp128", "fp256", "fp256k1", "gf2_128")),
    "fp_matmul_ntt": ("matmul_ntt.cu", [_P, _P, _P, _LL, _I, _P],
                      ("fp128",)),
    "rfft_pass": ("rfft.cu", [_I, _P, _P, _P, _P, _P, _LL, _LL, _LL, _P],
                  ("fp256x2",)),
    "nb_butterfly": ("nussbaumer.cu", [_P, _P, _LL, _I, _I, _I, _LL, _I, _P],
                     ("fp128", "fp256", "fp256k1", "fp256x2")),
    "nb_base_conv": ("nussbaumer.cu", [_P, _P, _P, _LL, _I, _LL, _I, _P],
                     ("fp128", "fp256", "fp256k1", "fp256x2")),
    "fp_inv": ("inv.cu", [_P, _P, _LL, _P],
               ("fp24", "fp64", "fp128", "fp256", "fp256k1", "p256n",
                "p256k1n", "p384", "p521", "gf2_128", "fp256x2")),
    "fp24x6_elementwise": ("fp24x6.cu", [_I, _P, _P, _P, _LL, _LL, _LL, _P],
                           ("fp24x6",)),
    "layer_hv": ("layer_hv.cu", [_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL,
                                 _P], ("fp128", "fp256", "fp256k1", "gf2_128")),
}

# "kernel[instance]" -> (source, C entry point, argtypes)
KERNELS = {"%s[%s]" % (k, inst): (src, "%s_%s" % (k, inst), argtypes)
           for k, (src, argtypes, insts) in _SOURCES.items()
           for inst in insts}

LAUNCHES = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_fns = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def k1_tile() -> int:
    """TILE_ELTS of csrc/fp_ops.cu: the elements of a block of K1's 12-
    and 17-word path, where it splits into whole tiles and a ragged
    one."""
    with open(os.path.join(CSRC, "fp_ops.cu")) as f:
        return int(re.search(r"constexpr int TILE_ELTS = (\d+);",
                             f.read()).group(1))


def k1_g128_splits() -> tuple:
    """(G128_LANE_MIN, G128_TAB_MIN) of csrc/fp_ops.cu: the elements a row
    from which K1 [gf2_128] multiplies by one element a row on its lane
    path, and the elements of a call from which that path reads a table
    of the element's multiples."""
    with open(os.path.join(CSRC, "fp_ops.cu")) as f:
        src = f.read()
    return tuple(int(re.search(r"constexpr long long %s = (\d+);" % k,
                               src).group(1))
                 for k in ("G128_LANE_MIN", "G128_TAB_MIN"))


@functools.lru_cache(maxsize=None)
def k2_chunks() -> tuple:
    """(SEG_K, SEG_NT) of csrc/segsum.cu: the most terms a thread of
    K2's scan takes and its threads a block, which size its scratch."""
    with open(os.path.join(CSRC, "segsum.cu")) as f:
        src = f.read()
    return tuple(int(re.search(r"constexpr int %s = (\d+);" % k,
                               src).group(1)) for k in ("SEG_K", "SEG_NT"))


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: str) -> str:
    return os.path.join(build_dir(), "lib" + src.replace(".cu", ".so"))


def _stale(src: str) -> bool:
    """True if src's library is missing or older than src or any header."""
    out = _lib_path(src)
    if not os.path.exists(out):
        return True
    deps = [os.path.join(CSRC, src)] + glob.glob(os.path.join(CSRC, "*.cuh"))
    return os.path.getmtime(out) < max(os.path.getmtime(d) for d in deps)


def build_all(verbose: bool = False) -> dict:
    """Compiles every stale kernel library, one nvcc per source, all in
    parallel.  Returns {source: compiler output}; raises on a failure."""
    nvcc = nvcc_path()
    srcs = sorted({src for src, _, _ in KERNELS.values()})
    procs = {}
    for src in srcs:
        if not _stale(src):
            continue
        tmp = "%s.%d.tmp" % (_lib_path(src), os.getpid())
        cmd = [nvcc] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) + \
            ["-o", tmp, os.path.join(CSRC, src)]
        procs[src] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for src, (tmp, proc) in procs.items():
        logs[src] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(src)
        else:
            os.replace(tmp, _lib_path(src))
    if failed:
        raise RuntimeError("nvcc failed for %s:\n%s" % (
            ", ".join(failed), "\n".join(logs[s] for s in failed)))
    return logs


def _fn(name: str):
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _fns:
            src, entry, argtypes = KERNELS[name]
            if _stale(src):
                build_all()
            lib = ctypes.CDLL(_lib_path(src))
            f = getattr(lib, entry)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            lib.lfzk_cuda_error_string.argtypes = [ctypes.c_int]
            lib.lfzk_cuda_error_string.restype = ctypes.c_char_p
            _fns[name] = (f, lib.lfzk_cuda_error_string)
    return _fns[name]


def launch(name: str, nlaunches: int, *args) -> None:
    """Calls kernel `name`'s C entry point (which makes `nlaunches` CUDA
    launches on the current stream) and raises on a launch error."""
    f, errstr = _fn(name)
    rc = f(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("%s: CUDA launch failed: %s"
                           % (name, errstr(rc).decode()))
    LAUNCHES[name] += nlaunches
