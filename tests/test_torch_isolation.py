"""The port stands alone: importing every module of longfellow_zk_tpu_torch
loads neither JAX nor any module of the JAX package, and its entry points
refuse to run without a card unless the caller asks for the CPU.  Run in
a subprocess with `jax` blocked (sys.modules["jax"] = None)."""

import os
import subprocess
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions make many small torch ops; with the test
    workers on every core, a thread pool per op waits on descheduled
    threads.  One thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.path.insert(0, %(repo)r)
import longfellow_zk_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" and sys.modules[m] is not None
             or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "longfellow_zk_tpu" or m.startswith("longfellow_zk_tpu."))
assert not bad, bad
import torch
assert not torch.cuda.is_available()
for mod in ("fields.fp2", "ec.curves", "circuits.ecdsa.verify",
            "fields.gf2", "transforms.lch14", "circuits.mdoc.api",
            "circuits.mdoc.witness", "utils.zstd", "sumcheck.verifier",
            "ligero.verifier", "zk.verifier", "zk.serialization",
            "merkle.sha256_dev", "merkle.merkle_dev",
            "random_oracle.device_fs", "zk.fused", "zk.batch",
            "fields.multiprime", "transforms.crt_conv",
            "circuits.bitaddr.bitaddr", "circuits.ripemd.witness",
            "circuits.ecdsa.pk", "arrays.dense", "transforms.matmul_ntt",
            "transforms.rfft", "transforms.nussbaumer", "fields.fp24",
            "parallel.launch", "parallel.mesh", "parallel.ntt_sharded",
            "parallel.sumcheck_sharded", "parallel.smoke"):
    assert pkg.__name__ + "." + mod in names, mod
from longfellow_zk_tpu_torch.fields.fp_instances import (
    fp128, p256_base, p256k1_base, P128_OMEGA, P128_OMEGA_ORDER, P256_FP2_ROOT_X,
    P256_FP2_ROOT_Y, P256_FP2_ROOT_ORDER)
from longfellow_zk_tpu_torch.fields.fp2 import Fp2
from longfellow_zk_tpu_torch.fields.gf2 import gf2_128
from longfellow_zk_tpu_torch.circuits.mdoc.api import (
    run_mdoc_prover, run_mdoc_verifier)
from longfellow_zk_tpu_torch.sumcheck.circuit import Circuit
from longfellow_zk_tpu_torch.sumcheck.verifier import SumcheckVerifier
from longfellow_zk_tpu_torch.zk.verifier import ZkVerifier
from longfellow_zk_tpu_torch.zk.batch import BatchZkProver
from longfellow_zk_tpu_torch.sumcheck.prover import SumcheckProver
from longfellow_zk_tpu_torch.transforms.lch14 import LCH14ReedSolomon
from longfellow_zk_tpu_torch.zk.testing import rs_factory_for, rs_factory_with
from longfellow_zk_tpu_torch.transforms.matmul_ntt import MatmulNTT
from longfellow_zk_tpu_torch.transforms.ntt import make_fft_convolution_factory
from longfellow_zk_tpu_torch.transforms.rfft import (
    RFFT, RFFTExtConvolution, make_rfft_ext_convolution_factory)
from longfellow_zk_tpu_torch.transforms.nussbaumer import (
    NussbaumerConvolution, make_nussbaumer_convolution_factory)
from longfellow_zk_tpu_torch.fields.fp24 import Fp24_6, fp24
from longfellow_zk_tpu_torch.parallel.launch import spawn
from longfellow_zk_tpu_torch.parallel.mesh import make_mesh
OMEGA2 = (P256_FP2_ROOT_X, P256_FP2_ROOT_Y)
for make in (lambda: SumcheckProver(fp128()),
             lambda: SumcheckProver(gf2_128()),
             lambda: rs_factory_for(gf2_128()),
             lambda: LCH14ReedSolomon(5, 13, gf2_128()),
             lambda: run_mdoc_prover(b"", b"", 0, 0, b"", [], b"", None),
             lambda: run_mdoc_verifier(b"", 0, 0, b"", [], b"", b"", b"",
                                       None),
             lambda: ZkVerifier(Circuit(nv=1, logv=0, nc=1, logc=0, nl=0,
                                        ninputs=2, npub_in=1,
                                        subfield_boundary=0), fp128(), None,
                                rate=4, nreq=6),
             lambda: BatchZkProver(Circuit(nv=1, logv=0, nc=1, logc=0, nl=0,
                                           ninputs=2, npub_in=1,
                                           subfield_boundary=0), fp128(),
                                   None, rate=4, nreq=6),
             lambda: SumcheckVerifier(fp128()),
             lambda: rs_factory_for(fp128(), P128_OMEGA, P128_OMEGA_ORDER),
             lambda: SumcheckProver(p256_base()),
             lambda: rs_factory_for(p256k1_base()),
             lambda: rs_factory_for(p256_base(), F2=Fp2(p256_base()),
                                    omega2=(P256_FP2_ROOT_X, P256_FP2_ROOT_Y),
                                    omega_order=P256_FP2_ROOT_ORDER),
             lambda: MatmulNTT(fp128(), P128_OMEGA, P128_OMEGA_ORDER),
             lambda: make_fft_convolution_factory(
                 fp128(), P128_OMEGA, P128_OMEGA_ORDER,
                 ntt_impl=MatmulNTT(fp128(), P128_OMEGA, P128_OMEGA_ORDER,
                                    device="cpu")),
             lambda: RFFT(Fp2(p256_base()), OMEGA2, P256_FP2_ROOT_ORDER),
             lambda: RFFTExtConvolution(6, 20, p256_base(), Fp2(p256_base()),
                                        OMEGA2, P256_FP2_ROOT_ORDER, [1] * 20),
             lambda: make_rfft_ext_convolution_factory(
                 p256_base(), Fp2(p256_base()), OMEGA2, P256_FP2_ROOT_ORDER),
             lambda: NussbaumerConvolution(6, 20, p256k1_base(), [1] * 20),
             lambda: make_nussbaumer_convolution_factory(p256k1_base()),
             lambda: rs_factory_with(p256k1_base(),
                                     make_nussbaumer_convolution_factory(
                                         p256k1_base(), "cpu")),
             lambda: Fp24_6(fp24()).zeros((4,)),
             lambda: Fp24_6(fp24()).to_limbs([(1, 2, 3, 4, 5, 6)]),
             lambda: spawn(print, 1, "cuda")):
    try:
        make()
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("an entry point ran without a card")
SumcheckProver(fp128(), device="cpu")
try:
    make_mesh(1)
except RuntimeError as e:
    assert "initialised process group" in str(e)
else:
    raise AssertionError("a mesh without a process group")
print("IMPORTED", len(names))
"""


def _run(code, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_needs_a_device():
    r = _run(_CHECK % {"repo": REPO}, REPO)
    assert r.returncode == 0, r.stderr
    assert "IMPORTED" in r.stdout


def test_chip_smoke_imports_no_jax_and_refuses_the_cpu(tmp_path):
    """chip_smoke.py with JAX blocked and no card: exits non-zero with no
    result line, and the failure is not an import of JAX."""
    code = ("import runpy, sys\nsys.modules['jax'] = None\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path(%r, run_name='__main__')\n"
            % os.path.join(REPO, "chip_smoke.py"))
    r = _run(code, str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "jax" not in r.stderr.lower()


def test_sources_import_no_jax():
    """No import statement of the port or of chip_smoke.py names JAX or a
    module of the JAX package."""
    import ast

    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "longfellow_zk_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert not (m == "jax" or m.startswith(("jax.", "jaxlib"))
                            or m == "longfellow_zk_tpu"
                            or m.startswith("longfellow_zk_tpu.")), (path, m)
