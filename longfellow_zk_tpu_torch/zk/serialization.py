"""ZK proof wire format, writer and reader, byte-exact twin of reference
lib/zk/zk_proof.h:46-374 (the JAX package's zk/serialization.py):

  [32-byte commitment root]
  [sumcheck proof: per layer, per wire round, p(0) and p(2) for both
   hands (p(1) implied), then wc0, wc1]
  [ligero proof: y_ldt, y_dot, y_quad_0, y_quad_2, nonces,
   run-length-encoded column openings (alternating full-field/subfield
   runs), merkle path with 4-byte LE count]
"""

from __future__ import annotations

from typing import Optional

from ..ligero.param import LigeroCommitment, LigeroParam, LigeroProof
from ..sumcheck.circuit import Circuit, LayerProof, Proof
from ..utils.serialization import ReadBuffer
from .proof import ZkProof

K_MAX_RUN_LEN = 1 << 25
K_MAX_NUM_DIGESTS = 1 << 25
DIGEST_LEN = 32
NONCE_LEN = 32


def write_zk_proof(zkp: ZkProof, circ: Circuit, param: LigeroParam, F) -> bytes:
    out = bytearray()
    out += zkp.com.root
    _write_sc_proof(out, zkp.proof, circ, F)
    _write_com_proof(out, zkp.com_proof, param, F)
    return bytes(out)


def _write_sc_proof(out: bytearray, pr: Proof, circ: Circuit, F) -> None:
    assert circ.logc == 0, "cannot write sc proof with logc != 0"
    for i, lp in enumerate(pr.layers):
        for wi in range(circ.layers[i].logw):
            for k in range(3):
                if k != 1:  # p(1) implied by constraints
                    out += F.to_bytes(lp.hp[0][wi][k])
                    out += F.to_bytes(lp.hp[1][wi][k])
        out += F.to_bytes(lp.wc[0])
        out += F.to_bytes(lp.wc[1])


def _write_com_proof(out: bytearray, pr: LigeroProof, p: LigeroParam,
                     F) -> None:
    for x in pr.y_ldt:
        out += F.to_bytes(x)
    for x in pr.y_dot:
        out += F.to_bytes(x)
    for x in pr.y_quad_0:
        out += F.to_bytes(x)
    for x in pr.y_quad_2:
        out += F.to_bytes(x)
    for nonce in pr.merkle_nonce:
        out += nonce
    # run-length encoded openings, row-major [nrow][nreq]
    flat = [pr.req[i][j] for i in range(p.nrow) for j in range(p.nreq)]
    ci = 0
    subfield_run = False
    n = len(flat)
    while ci < n:
        runlen = 0
        while (ci + runlen < n and runlen < K_MAX_RUN_LEN
               and F.in_subfield(flat[ci + runlen]) == subfield_run):
            runlen += 1
        out += runlen.to_bytes(4, "little")
        for i in range(ci, ci + runlen):
            if subfield_run:
                out += F.to_bytes_subfield(flat[i])
            else:
                out += F.to_bytes(flat[i])
        ci += runlen
        subfield_run = not subfield_run
    out += len(pr.merkle_path).to_bytes(4, "little")
    for d in pr.merkle_path:
        out += d


def read_zk_proof(data: bytes, circ: Circuit, param: LigeroParam, F,
                  rate: int, nreq: int, return_used: bool = False):
    """The ZkProof in `data`, or None if it is malformed or short (never
    raises for bad bytes).  With return_used, (proof, bytes read)."""
    buf = ReadBuffer(data)
    try:
        root = buf.bytes(DIGEST_LEN)
        proof = _read_sc_proof(buf, circ, F)
        if proof is None:
            return (None, 0) if return_used else None
        com_proof = _read_com_proof(buf, param, F)
        if com_proof is None:
            return (None, 0) if return_used else None
    except ValueError:
        return (None, 0) if return_used else None
    zkp = ZkProof(rate=rate, nreq=nreq, com=LigeroCommitment(root=root),
                  proof=proof, com_proof=com_proof)
    if return_used:
        return zkp, len(data) - buf.remaining()
    return zkp


def _read_sc_proof(buf: ReadBuffer, circ: Circuit, F) -> Optional[Proof]:
    if circ.logc != 0:
        return None
    pr = Proof()
    zero = F.of_scalar(0)
    for layer in circ.layers:
        lp = LayerProof(cp=[], hp=[[], []], wc=[None, None])
        polys = [[[zero, zero, zero] for _ in range(layer.logw)]
                 for _ in range(2)]
        for wi in range(layer.logw):
            for k in range(3):
                if k != 1:
                    for hi in range(2):
                        v = F.of_bytes(buf.bytes(F.kBytes))
                        if v is None:
                            return None
                        polys[hi][wi][k] = v
        lp.hp = polys
        for wi in range(2):
            v = F.of_bytes(buf.bytes(F.kBytes))
            if v is None:
                return None
            lp.wc[wi] = v
        pr.layers.append(lp)
    return pr


def _read_com_proof(buf: ReadBuffer, p: LigeroParam, F
                    ) -> Optional[LigeroProof]:
    pr = LigeroProof()

    def elts(n):
        out = []
        for _ in range(n):
            v = F.of_bytes(buf.bytes(F.kBytes))
            if v is None:
                raise ValueError("bad elt")
            out.append(v)
        return out

    pr.y_ldt = elts(p.block)
    pr.y_dot = elts(p.dblock)
    pr.y_quad_0 = elts(p.r)
    pr.y_quad_2 = elts(p.dblock - p.block)
    pr.merkle_nonce = [buf.bytes(NONCE_LEN) for _ in range(p.nreq)]
    # run-length encoded openings: alternating full-field and subfield
    # runs, the first a full-field one
    total = p.nreq * p.nrow
    flat = [None] * total
    ci = 0
    subfield_run = False
    while ci < total:
        runlen = int.from_bytes(buf.bytes(4), "little")
        if runlen >= K_MAX_RUN_LEN or ci + runlen > total:
            return None
        for i in range(ci, ci + runlen):
            if subfield_run:
                v = F.of_bytes_subfield(buf.bytes(F.kSubFieldBytes))
            else:
                v = F.of_bytes(buf.bytes(F.kBytes))
            if v is None:
                return None
            flat[i] = v
        ci += runlen
        subfield_run = not subfield_run
    pr.req = [[flat[i * p.nreq + j] for j in range(p.nreq)]
              for i in range(p.nrow)]
    sz = int.from_bytes(buf.bytes(4), "little")
    if sz < p.nreq or sz >= K_MAX_NUM_DIGESTS or sz > p.nreq * p.mc_pathlen:
        return None
    pr.merkle_path = [buf.bytes(DIGEST_LEN) for _ in range(sz)]
    return pr
