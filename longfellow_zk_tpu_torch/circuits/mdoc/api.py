"""The mdoc API: load_circuits, circuit_id, run_mdoc_prover,
run_mdoc_verifier.

Port of the JAX package's circuits/mdoc/api.py:38-311 (semantic twin of
the reference lib/circuits/mdoc/mdoc_zk.cc:150-712): the anonymous
credential proof is a pair of ZK proofs over one transcript, a GF(2^128)
hash/parse circuit and a P-256 signature circuit, linked through
Fiat-Shamir-keyed MACs on (e, dpkx, dpky).  The ZkProvers and
ZkVerifiers run on the card unless the caller asks for the CPU
(`device="cpu"`).
"""

from __future__ import annotations

import hashlib
import time
from typing import List, Tuple

import torch

from ...device import resolve_device
from ...ec.curves import p256_curve
from ...fields.fp2 import Fp2
from ...fields.fp_instances import (
    P256_FP2_ROOT_ORDER, P256_FP2_ROOT_X, P256_FP2_ROOT_Y, p256_base)
from ...fields.gf2 import gf2_128
from ...proto import lfc1
from ...random_oracle.engine import SecureRandomEngine
from ...random_oracle.transcript import Transcript
from ...utils.serialization import ReadBuffer
from ...utils.zstd import decompress
from ...zk.proof import ZkProof
from ...zk.prover import ZkProver
from ...zk.serialization import read_zk_proof, write_zk_proof
from ...zk.testing import rs_factory_for
from ...zk.verifier import ZkVerifier
from ..mac.mac import MACReference, fill_gf2k_bits
from .witness import (
    MdocError, MdocHashWitness, MdocSignatureWitness, RequestedAttribute,
    compute_transcript_hash)
from .zk_spec import ZkSpec

GF = gf2_128()
FB = p256_base()

_RS_FACTORIES = {}  # (field name, device) -> rs factory
_CIRCUIT_CACHE = {}  # sha256(circuit bytes) -> (c_sig, c_hash)


def _rs_factory(F, dev):
    """The Reed-Solomon factory of a half, cached per device: LCH14 for
    the hash half, convolution over Fp2 for the signature half."""
    key = (F.name, str(dev))
    if key not in _RS_FACTORIES:
        _RS_FACTORIES[key] = rs_factory_for(GF, device=dev) if F is GF else \
            rs_factory_for(FB, F2=Fp2(FB),
                           omega2=(P256_FP2_ROOT_X, P256_FP2_ROOT_Y),
                           omega_order=P256_FP2_ROOT_ORDER, device=dev)
    return _RS_FACTORIES[key]


def load_circuits(circuit_bytes: bytes):
    """zstd + LFC1: (signature circuit over the P-256 base field, hash
    circuit over GF(2^128)) (mdoc_zk.cc:436-462), cached by content hash
    (the circuits carry the prover's uploaded term tables)."""
    key = hashlib.sha256(circuit_bytes).digest()
    hit = _CIRCUIT_CACHE.get(key)
    if hit is not None:
        return hit
    buf = ReadBuffer(decompress(circuit_bytes))
    c_sig = lfc1.read_circuit_buf(FB, lfc1.P256_ID, buf)
    if c_sig is None:
        raise MdocError("CIRCUIT_PARSING_FAILURE")
    c_hash = lfc1.read_circuit_buf(GF, lfc1.GF2_128_ID, buf)
    if c_hash is None:
        raise MdocError("HASH_PARSING_FAILURE")
    if buf.remaining() != 0:
        raise MdocError("CIRCUIT_PARSING_FAILURE")
    _CIRCUIT_CACHE[key] = (c_sig, c_hash)
    return c_sig, c_hash


def circuit_id(circuit_bytes: bytes) -> str:
    """SHA256(cid_sig || cid_hash) hex (mdoc_circuit_id.cc:43-82)."""
    c_sig, c_hash = load_circuits(circuit_bytes)
    return hashlib.sha256(lfc1.circuit_id(FB, c_sig)
                          + lfc1.circuit_id(GF, c_hash)).hexdigest()


# ---------------------------------------------------------------------------
# public-input filling (mdoc_zk.cc:150-210)
# ---------------------------------------------------------------------------

def _text_len_hdr(n: int) -> bytes:
    if n < 24:
        return bytes([0x60 + n])
    return bytes([0x78, n])


def _fill_attribute_hash(out: List[int], attr: RequestedAttribute) -> None:
    """(mdoc_witness.h fill_attribute, v7 branch)."""
    v = [0] * (96 * 8)
    vbuf = bytearray(_text_len_hdr(len(attr.id)))
    vbuf += attr.id
    for j in range(min(len(vbuf), 32)):
        for k in range(8):
            v[j * 8 + k] = (vbuf[j] >> k) & 1
    for j in range(min(64, len(attr.cbor_value))):
        for k in range(8):
            v[(32 + j) * 8 + k] = (attr.cbor_value[j] >> k) & 1
    out.extend(GF.of_scalar(x) for x in v)
    ln = 1 + 17 + 1 + len(attr.id)
    out.extend(GF.of_scalar((ln >> i) & 1) for i in range(8))
    vlen = len(attr.cbor_value) + 12 + 1
    out.extend(GF.of_scalar((vlen >> i) & 1) for i in range(8))


def fill_hash_public(attrs: List[RequestedAttribute], now: bytes,
                     macs: List[int], av: int, version: int) -> List[int]:
    """The hash circuit's public inputs: the one-wire, the attributes,
    now, then the 6 MACs and av as full GF(2^128) elements."""
    out: List[int] = [GF.of_scalar(1)]
    for attr in attrs:
        _fill_attribute_hash(out, attr)
    assert len(now) == 20
    for b in now:
        out.extend(GF.of_scalar((b >> i) & 1) for i in range(8))
    out.extend(macs)
    out.append(av)
    return out


def fill_sig_public(pkx: int, pky: int, e2: int, macs: List[int],
                    av: int) -> List[int]:
    out: List[int] = [1, pkx, pky, e2 % FB.p]
    for m in list(macs) + [av]:
        out.extend(fill_gf2k_bits(m))
    return out


def hash_mac_index(num_attrs: int, version: int) -> int:
    """Wire index of the first MAC public input of the hash circuit
    (mdoc_zk.cc:61-64)."""
    return num_attrs * 8 * (96 + (1 if version < 7 else 2)) + 160 + 1


K_SIG_MAC_INDEX = 4  # (mdoc_zk.cc:98)


# ---------------------------------------------------------------------------
# prover (mdoc_zk.cc:398-546)
# ---------------------------------------------------------------------------

def mdoc_witnesses(c_sig, c_hash, mdoc: bytes, pkx: int, pky: int,
                   transcript: bytes, attrs: List[RequestedAttribute],
                   now: bytes, version: int, ap: List[int]):
    """(W_hash, W_sig, hash witness): both circuits' inputs with the MACs
    and av still zero, for the committed MAC keys ap."""
    hw = MdocHashWitness(len(attrs), GF, version)
    hw.compute_witness(mdoc, transcript, attrs)
    sw = MdocSignatureWitness(p256_curve(), FB)
    sw.compute_witness(pkx, pky, mdoc, transcript)

    W_hash = fill_hash_public(attrs, now, [0] * 6, 0, version)
    # private: e, dpkx, dpky bit strings (values mod p, LE bit order)
    for val in (hw.e_nat % FB.p, hw.dpkx_nat, hw.dpky_nat):
        W_hash.extend(GF.of_scalar((val >> i) & 1) for i in range(256))
    W_hash.extend(hw.fill_witness())
    for i in range(3):
        W_hash.extend(ap[2 * i : 2 * i + 2])
    assert len(W_hash) == c_hash.ninputs, (len(W_hash), c_hash.ninputs)

    W_sig = fill_sig_public(pkx, pky, sw.e2_nat, [0] * 6, 0)
    W_sig.extend(sw.fill_witness(ap))
    assert len(W_sig) == c_sig.ninputs, (len(W_sig), c_sig.ninputs)
    return W_hash, W_sig, hw


def _rate_nreq(version: int) -> Tuple[int, int]:
    """The Ligero rate and column count of a ZkSpec version."""
    return (4, 128) if version < 7 else (7, 132)


def run_mdoc_prover(circuit_bytes: bytes, mdoc: bytes, pkx: int, pky: int,
                    transcript: bytes, attrs: List[RequestedAttribute],
                    now: bytes, zk_spec: ZkSpec, rng=None, device=None,
                    phases: List = None) -> bytes:
    """The mdoc presentation proof: the MACs, then the hash proof and the
    signature proof (write_zk_proof bytes).  `device` as resolve_device;
    `phases`, if a list, receives the host-clock ms of (hash commit, sig
    commit, hash prove, sig prove), each ended by a device
    synchronisation."""
    dev = resolve_device(device)
    rng = rng or SecureRandomEngine()
    c_sig, c_hash = load_circuits(circuit_bytes)
    version = zk_spec.version

    ap = MACReference().sample(6, rng)
    W_hash, W_sig, hw = mdoc_witnesses(c_sig, c_hash, mdoc, pkx, pky,
                                       transcript, attrs, now, version, ap)

    # ---- two linked ZK proofs over one transcript ----
    rate, nreq = _rate_nreq(version)
    tp = Transcript(transcript, version=version)
    h_zk = ZkProof(rate=rate, nreq=nreq)
    s_zk = ZkProof(rate=rate, nreq=nreq)
    hash_p = ZkProver(c_hash, GF, _rs_factory(GF, dev), rate=rate,
                      nreq=nreq, block_enc=zk_spec.block_enc_hash,
                      device=dev)
    sig_p = ZkProver(c_sig, FB, _rs_factory(FB, dev), rate=rate, nreq=nreq,
                     block_enc=zk_spec.block_enc_sig, device=dev)
    t0 = [time.perf_counter()]

    def lap():
        if phases is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            phases.append((t - t0[0]) * 1e3)
            t0[0] = t

    hash_p.commit(h_zk, W_hash, tp, rng)
    lap()
    sig_p.commit(s_zk, W_sig, tp, rng)
    lap()

    # interactive MAC step: av from Fiat-Shamir after both commitments
    av = generate_mac_key(tp)
    macs, macs_b = compute_macs(
        [hw.e_nat % FB.p, hw.dpkx_nat, hw.dpky_nat], ap, av)
    _update_macs(W_sig, W_hash, len(attrs), version, macs, av)

    if not hash_p.prove(h_zk, W_hash, tp):
        raise MdocError("GENERAL_FAILURE")
    lap()
    if not sig_p.prove(s_zk, W_sig, tp):
        raise MdocError("GENERAL_FAILURE")
    lap()

    out = bytearray(macs_b)
    out += write_zk_proof(h_zk, c_hash, hash_p.param, GF)
    out += write_zk_proof(s_zk, c_sig, sig_p.param, FB)
    return bytes(out)


def generate_mac_key(ts: Transcript) -> int:
    return GF.of_bytes(ts.bytes(16))


def compute_macs(vals: List[int], ap: List[int], av: int
                 ) -> Tuple[List[int], bytes]:
    """(mdoc_zk.cc:124-140): 2 MACs per 32-byte value."""
    mac_ref = MACReference()
    macs: List[int] = []
    macs_b = bytearray()
    for i, v in enumerate(vals):
        pair = mac_ref.compute(av, ap[2 * i : 2 * i + 2],
                               int(v).to_bytes(32, "little"))
        macs.extend(pair)
        macs_b += int(pair[0]).to_bytes(16, "little")
        macs_b += int(pair[1]).to_bytes(16, "little")
    return macs, bytes(macs_b)


def _update_macs(W_sig: List, W_hash: List, num_attrs: int, version: int,
                 macs: List[int], av: int) -> None:
    """(mdoc_zk.cc:143-160)."""
    si = K_SIG_MAC_INDEX
    hi = hash_mac_index(num_attrs, version)
    for m in list(macs) + [av]:
        for j in range(128):
            W_sig[si] = (m >> j) & 1
            si += 1
        W_hash[hi] = m
        hi += 1


# ---------------------------------------------------------------------------
# verifier (mdoc_zk.cc:549-712)
# ---------------------------------------------------------------------------

def run_mdoc_verifier(circuit_bytes: bytes, pkx: int, pky: int,
                      transcript: bytes, attrs: List[RequestedAttribute],
                      now: bytes, proof: bytes, doc_type: bytes,
                      zk_spec: ZkSpec, device=None, phases: List = None
                      ) -> bool:
    """True if `proof` (run_mdoc_prover's bytes) proves the presentation
    of `attrs` for the issuer key (pkx, pky) and session `transcript`; a
    malformed or short proof is refused.  `device` as resolve_device;
    `phases`, if a list, receives the host-clock ms of (read, hash
    verify, sig verify), each ended by a device synchronisation."""
    dev = resolve_device(device)
    c_sig, c_hash = load_circuits(circuit_bytes)
    version = zk_spec.version
    rate, nreq = _rate_nreq(version)
    t0 = [time.perf_counter()]

    def lap():
        if phases is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            phases.append((t - t0[0]) * 1e3)
            t0[0] = t

    nmac = 6 * GF.kBytes
    if len(proof) < nmac:
        return False
    macs = [GF.of_bytes(proof[i : i + GF.kBytes])
            for i in range(0, nmac, GF.kBytes)]

    hash_v = ZkVerifier(c_hash, GF, _rs_factory(GF, dev), rate=rate,
                        nreq=nreq, block_enc=zk_spec.block_enc_hash,
                        device=dev)
    sig_v = ZkVerifier(c_sig, FB, _rs_factory(FB, dev), rate=rate,
                       nreq=nreq, block_enc=zk_spec.block_enc_sig,
                       device=dev)

    rest = proof[nmac:]
    h_zk, used = read_zk_proof(rest, c_hash, hash_v.param, GF, rate, nreq,
                               return_used=True)
    if h_zk is None:
        return False
    s_zk = read_zk_proof(rest[used:], c_sig, sig_v.param, FB, rate, nreq)
    if s_zk is None:
        return False

    tv = Transcript(transcript, version=version)
    hash_v.recv_commitment(h_zk, tv)
    sig_v.recv_commitment(s_zk, tv)
    av = generate_mac_key(tv)

    e2 = compute_transcript_hash(transcript, doc_type)
    pub_hash = fill_hash_public(attrs, now, macs, av, version)
    pub_sig = fill_sig_public(pkx, pky, e2, macs, av)
    if len(pub_hash) != c_hash.npub_in or len(pub_sig) != c_sig.npub_in:
        return False
    lap()

    ok1, _ = hash_v.verify(h_zk, pub_hash, tv)
    lap()
    ok2, _ = sig_v.verify(s_zk, pub_sig, tv)
    lap()
    return ok1 and ok2
