"""The port's multi-card paths (longfellow_zk_tpu_torch/parallel, the mesh=
of the sumcheck, ZK and batch provers) on the CPU: four (and two) ranks
started by parallel/launch.spawn on the gloo backend, each running the
kernels' plain versions on one torch thread.  Each world is spawned once
for the module (tests/torch_parallel_ranks.py holds what its ranks run);
the tests assert on what the ranks returned, exactly (field elements as
canonical integers, proofs and transcript states as bytes):

  - ShardedNTT at n = 64 (radix 8) and n = 256 (radix 16) over four
    ranks against the port's one-card MatmulNTT, both directions, and at
    n = 64 against the JAX ShardedNTT on make_mesh(4, 1) (conftest's 8
    virtual devices; slow: its shard_map compiles for minutes);
  - sharded_copy_round_coeffs at T, nw, C = 24, 8, 32 on meshes (4, 1)
    and (2, 2) against the JAX copy_round_coeffs and
    sharded_copy_round_coeffs;
  - the plain sumcheck with the copy axis sharded: the mul-check circuit
    over 8 copies on (1, 4), (2, 2) and a world of 2 against
    testdata/sumcheck_copies_toy.json, over 12 copies (the last rank's
    block all padding) against the one-card run, over 3 copies with a
    pad (not divisible: replicated) against the listing;
  - ZkProver on (4, 1) for the toy Fp128 and P-256 proofs: the golden
    bytes and one final transcript state on every rank, the one-card
    run's (Fp128);
    with an engine that gives each rank its own stream, rank 0's decides;
  - BatchZkProver on (4, 1) with 4 lanes against the scalar ZkProver;
  - the error paths, and a rank that raises while another waits in a
    collective: spawn fails within its deadline.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longfellow_zk_tpu.fields.fp_instances import fp128 as jax_fp128
from longfellow_zk_tpu.parallel.mesh import make_mesh as jax_make_mesh
from longfellow_zk_tpu.parallel.ntt_sharded import ShardedNTT as JaxNTT
from longfellow_zk_tpu.parallel.sumcheck_sharded import (
    copy_round_coeffs as jax_coeffs,
    sharded_copy_round_coeffs as jax_sharded_coeffs)
from longfellow_zk_tpu_torch.fields.fp_instances import (
    P128_OMEGA, P128_OMEGA_ORDER, fp128)
from longfellow_zk_tpu_torch.parallel import launch
from longfellow_zk_tpu_torch.parallel.mesh import make_mesh, split

import torch_parallel_ranks as ranks
from test_torch_copies import (
    TOY_JSON, _toy_case, mul_check_witness, port_circuit as copies_circuit)
from test_torch_fused import _toy
from test_torch_golden import TOY_BLOCK_ENC, TOY_LABEL, TOY_NREQ, TOY_RATE
from test_sumcheck import _mul_check_circuit

# each spawn's deadline: a hung collective fails the test instead of the
# whole run
DEADLINE_S = 240


def _ints(F, rng, n):
    return [int.from_bytes(rng.bytes(16), "little") % F.p for _ in range(n)]


def _copy_inputs():
    rng = np.random.default_rng(11)
    F = fp128()
    T, nw, C = 24, 8, 32
    return dict(T=T, nw=nw, C=C, hv=_ints(F, rng, T), W=_ints(F, rng, nw * C),
                EQ=_ints(F, rng, C), h0=rng.integers(0, nw, T).tolist(),
                h1=rng.integers(0, nw, T).tolist())


def _sumcheck_cases():
    cases = {}
    for name in ("fp128_nc8", "fp128_nc3_pad"):
        jc, W_host, label, pad = _toy_case(name)
        cases[name] = (copies_circuit(jc), W_host, label, pad)
    jc = _mul_check_circuit(jax_fp128(), 12)
    cases["fp128_nc12"] = (copies_circuit(jc),
                           mul_check_witness(fp128(), 12, 22), b"nc12", None)
    return cases


def _tag(i):
    return TOY_LABEL if i == 0 else b"lane%d" % i


@pytest.fixture(scope="module")
def inputs():
    F = fp128()
    rng = np.random.default_rng(5)
    zk = {}
    for field in ("fp128", "p256"):
        _, _, _, circ, W, _, golden = _toy(field)
        with open(golden, "rb") as f:
            zk[field] = (circ, W, f.read())
    circ, W = zk["fp128"][:2]
    brng = np.random.default_rng(73)
    Ws = [W]
    for _ in range(3):
        a, b = _ints(F, brng, 2)
        Ws.append([F.mul_i(a, b), 1, a, b])
    return dict(
        ntt=[(64, 8, _ints(F, rng, 64)), (256, 16, _ints(F, rng, 256))],
        copy=_copy_inputs(), sumcheck=_sumcheck_cases(), zk=zk,
        zk_args=dict(label=TOY_LABEL, rate=TOY_RATE, nreq=TOY_NREQ,
                     block_enc=TOY_BLOCK_ENC),
        batch=dict(circ=circ, Ws=Ws, tags=[_tag(i) for i in range(4)]),
        listings=("fp128_nc8", "fp128_nc3_pad"))


@pytest.fixture(scope="module")
def world4(inputs):
    """The four ranks' results, spawned once for the module."""
    t = time.perf_counter()
    out = launch.spawn(ranks.world4, 4, "cpu", DEADLINE_S, args=(inputs,))
    print("world 4: %.1f s" % (time.perf_counter() - t))
    return out


@pytest.fixture(scope="module")
def listings():
    with open(TOY_JSON) as f:
        return json.load(f)


def _limbs_equal(a, b):
    return a.shape == b.shape and bool(torch.equal(a, b))


@pytest.mark.parametrize("n", [64, 256])
def test_sharded_ntt_matches_matmul_ntt(world4, inputs, n):
    """Every rank's gathered transform equals the one-card MatmulNTT's,
    fftb and fftf, and its own partition is its block of j2."""
    for r, res in enumerate(world4):
        got = res["ntt%d" % n]
        assert _limbs_equal(got["fftb"], got["one_card_fftb"])
        assert _limbs_equal(got["fftf"], got["one_card_fftf"])
        R = got["local"].shape[0]
        S = n // R
        want = got["one_card_fftb"].reshape(R, S, 4)[:, r * S // 4:
                                                     (r + 1) * S // 4]
        assert _limbs_equal(got["local"], want)
        # the one all_to_all: 3/4 of the rank's n/4 elements of 16 bytes
        assert got["sent"] == 3 * n // 4 * 16 // 4


@pytest.mark.slow
def test_sharded_ntt_matches_jax_sharded_ntt(world4, inputs):
    """The JAX ShardedNTT on a (4, 1) mesh of the virtual devices (its
    shard_map compiles for about 270 s on a CPU)."""
    n, radix, vals = inputs["ntt"][0]
    J = jax_fp128()
    snt = JaxNTT(J, P128_OMEGA, P128_OMEGA_ORDER, jax_make_mesh(4, 1),
                 radix=radix)
    want = list(J.from_limbs(np.asarray(snt.fftb(jnp.asarray(
        J.to_limbs(vals))))))
    assert list(fp128().from_limbs(world4[0]["ntt64"]["fftb"])) == want


@pytest.mark.parametrize("mesh", ["copy41", "copy22"])
def test_sharded_copy_round_coeffs_match_jax(world4, mesh):
    c = _copy_inputs()
    J, F = jax_fp128(), fp128()
    EQ = jnp.asarray(J.to_limbs(c["EQ"])).reshape(J.L, c["C"])
    W = jnp.asarray(J.to_limbs(c["W"])).reshape(J.L, c["nw"], c["C"])
    hv = jnp.asarray(J.to_limbs(c["hv"])).reshape(J.L, c["T"])
    h0 = jnp.asarray(np.array(c["h0"], np.int32))
    h1 = jnp.asarray(np.array(c["h1"], np.int32))
    shape = (4, 1) if mesh == "copy41" else (2, 2)
    ref = [int(J.from_limbs(np.asarray(x)))
           for x in jax_coeffs(J, EQ, W, hv, h0, h1)]
    jsh = [int(J.from_limbs(np.asarray(x))) for x in jax_sharded_coeffs(
        J, jax_make_mesh(*shape), EQ, W, hv, h0, h1)]
    assert jsh == ref
    for res in world4:
        assert [int(x) for x in F.from_limbs(res["copy_one_card"])] == ref
        assert [int(x) for x in F.from_limbs(res[mesh])] == ref


@pytest.mark.parametrize("mesh", ["m14", "m22"])
@pytest.mark.parametrize("name", ["fp128_nc8", "fp128_nc3_pad"])
def test_sharded_sumcheck_matches_listing(world4, listings, name, mesh):
    """Over 8 copies on 4 (and 2 x 2) ranks, every rank's proof, bindings
    and transcript state equal the JAX listing; over 3 copies (4 and 2
    do not divide 3) every rank proves them whole."""
    for res in world4:
        assert res["sc_" + name][mesh] == listings[name]


def test_sharded_sumcheck_with_a_padding_block(world4):
    """Over 12 copies on 4 ranks (blocks of 16 / 4: the last holds only
    padding and evaluates nothing) every rank's proof equals the one-card
    run's."""
    one = world4[0]["sc_fp128_nc12"]["one_card"]
    for res in world4:
        assert res["sc_fp128_nc12"]["m14"] == one
        assert res["sc_fp128_nc12"]["m22"] == one


def test_sharded_sumcheck_on_two_ranks(inputs, listings):
    cases = {k: inputs["sumcheck"][k] for k in ("fp128_nc8", "fp128_nc3_pad")}
    for res in launch.spawn(ranks.world2, 2, "cpu", DEADLINE_S,
                            args=(dict(sumcheck=cases),)):
        for name in cases:
            assert res[name] == listings[name]


@pytest.mark.parametrize("field", ["fp128", "p256"])
def test_zk_prover_rows_sharded(world4, inputs, field):
    """Every rank's proof on (4, 1) is the golden's bytes, and every rank
    ends its transcript in one state, the one-card proof's (Fp128)."""
    golden = inputs["zk"][field][2]
    state = world4[0]["zk_" + field]["m41"][1]
    for res in world4:
        assert res["zk_" + field]["m41"] == (golden, state)
        if field == "fp128":
            assert res["zk_fp128"]["one_card"] == (golden, state)


def test_zk_prover_rank_zero_stream_decides(world4, inputs):
    """Each rank's engine its own stream (rank 0 the golden's): every rank
    commits to rank 0's draws."""
    for res in world4:
        assert res["zk_own_streams"] == res["zk_fp128"]["one_card"]


def test_batch_prover_lanes_sharded(world4):
    """The 4 lanes over 4 ranks: every rank returns the 4 proofs in lane
    order, each the scalar ZkProver's (rank k made lane k's), and every
    lane's transcript ends in the scalar proof's state."""
    scalar = [res["batch_scalar"] for res in world4]
    for res in world4:
        blobs, states = res["batch"]
        assert blobs == [s[0] for s in scalar]
        assert states == [s[1] for s in scalar]


def test_error_paths(world4):
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(1, 1, device="cpu")
    for res in world4:
        assert "ValueError" in res["err_world"] and "(3, 1)" in \
            res["err_world"]
        assert "ValueError" in res["err_lanes"] and "3 lanes" in \
            res["err_lanes"]
        if not torch.cuda.is_available():
            assert "no CUDA device" in res["err_cuda"]
    with pytest.raises(ValueError, match="world"):
        launch.spawn(ranks.world2, 0, "cpu")
    assert split(25, 4) == [(0, 7), (7, 13), (13, 19), (19, 25)]


def test_a_rank_that_raises_fails_spawn_in_time():
    t = time.perf_counter()
    with pytest.raises(launch.RankError, match="rank 1 raised"):
        launch.spawn(ranks.raise_on_rank1, 2, "cpu", 120)
    assert time.perf_counter() - t < 60
