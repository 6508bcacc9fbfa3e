"""ZK proof wire format (the writer), byte-exact twin of reference lib/zk/zk_proof.h:46-374:

  [32-byte commitment root]
  [sumcheck proof: per layer, per wire round, p(0) and p(2) for both
   hands (p(1) implied), then wc0, wc1]
  [ligero proof: y_ldt, y_dot, y_quad_0, y_quad_2, nonces,
   run-length-encoded column openings (alternating full-field/subfield
   runs), merkle path with 4-byte LE count]
"""

from __future__ import annotations

from ..ligero.param import LigeroParam, LigeroProof
from ..sumcheck.circuit import Circuit, Proof
from .proof import ZkProof

K_MAX_RUN_LEN = 1 << 25


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
