"""Ligero verifier (reference lib/ligero/ligero_verifier.h:31-269); port
of the JAX package's ligero/verifier.py.

Host-side replay of the challenges, Merkle check over the opened
columns, then the three consistency checks (low-degree, linear/dot,
quadratic) at the opened column indices.  The Reed-Solomon re-encodes of
the responses and of the dot test's A rows run on `device` through the
shared rs_factory (K6 over GF(2^128), K4 + K5 over P-256, K4 over Fp128),
in the port's trailing-limb layout [rows, n, N]; only the opened columns
come back to the host.  The scalar loops over the nreq columns and the
inner-product vector stay host code, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..merkle.merkle import MerkleCommitmentVerifier
from .param import LigeroParam, LigeroProof, inner_product_vector, layout_Aext
from .transcript import (
    gen_alphal,
    gen_alphaq,
    gen_idx,
    gen_uldt,
    gen_uquad,
    write_commitment,
)


def _interpolate_full(F, rs_factory, ylen: int, block_enc: int, y: List,
                      device) -> torch.Tensor:
    """The RS extension of the ylen values y to block_enc values, as a
    [block_enc, N] tensor on `device`."""
    rs = rs_factory(ylen, block_enc)
    arr = F.to_limbs(list(y), device).reshape(1, ylen, -1)
    return rs.interpolate(arr)[0]


class LigeroVerifier:
    def __init__(self, p: LigeroParam, F, rs_factory, device=None):
        """rs_factory(n, m) -> encoder with .interpolate([..., n, N])
        returning [..., m, N] on `device`."""
        self.p = p
        self.F = F
        self.rs_factory = rs_factory
        self.device = resolve_device(device)

    def receive_commitment(self, commitment, ts):
        write_commitment(commitment, ts)

    def verify(self, commitment, proof: LigeroProof, ts, nl: int, llterm,
               hash_of_llterm: bytes, b: List, lqc) -> Tuple[bool, str]:
        p, F = self.p, self.F

        # replay the protocol to recover all challenges
        ts.write_bytes(hash_of_llterm)
        u_ldt = gen_uldt(p, ts, F)
        alphal = gen_alphal(nl, ts, F)
        alphaq = gen_alphaq(p, ts, F)
        u_quad = gen_uquad(p, ts, F)
        ts.write_elts(proof.y_ldt, F)
        ts.write_elts(proof.y_dot, F)
        ts.write_elts(proof.y_quad_0, F)
        ts.write_elts(proof.y_quad_2, F)
        idx = gen_idx(p, ts, F)

        if not self._merkle_check(commitment, proof, idx):
            return False, "merkle_check failed"
        if not self._low_degree_check(proof, idx, u_ldt):
            return False, "low_degree_check failed"

        A = inner_product_vector(F, p, nl, llterm, alphal, lqc, alphaq)
        if not self._dot_check(proof, idx, A):
            return False, "dot_check failed"
        # check the claimed inner product value
        want = F.of_scalar(0)
        for bi, al in zip(b, alphal):
            want = F.add_i(want, F.mul_i(bi, al))
        got = F.of_scalar(0)
        for j in range(p.w):
            got = F.add_i(got, proof.y_dot[p.r + j])
        if want != got:
            return False, "wrong dot product"

        if not self._quadratic_check(proof, idx, u_quad):
            return False, "quadratic_check failed"
        return True, "ok"

    # ------------------------------------------------------------------

    def _opened(self, idx) -> torch.Tensor:
        """The tableau columns of the opened indices, on the device."""
        return torch.as_tensor(np.asarray(idx, np.int64) + self.p.dblock,
                               device=self.device)

    def _merkle_check(self, commitment, proof, idx) -> bool:
        p, F = self.p, self.F
        cols = []
        for r in range(p.nreq):
            col = b"".join(F.to_bytes(proof.req[i][r]) for i in range(p.nrow))
            cols.append(col)
        mcv = MerkleCommitmentVerifier(p.block_ext, commitment.root)
        return mcv.verify(proof.merkle_path, cols, proof.merkle_nonce, idx)

    def _req_gather(self, ylen, y, idx) -> List:
        p = self.p
        yext = _interpolate_full(self.F, self.rs_factory, ylen, p.block_enc,
                                 y, self.device)
        return list(self.F.from_limbs(yext[self._opened(idx)]))

    def _low_degree_check(self, proof, idx, u_ldt) -> bool:
        p, F = self.p, self.F
        yc = list(proof.req[p.ildt])
        for i in range(p.nwqrow):
            u = u_ldt[i]
            row = proof.req[p.iw + i]
            yc = [F.add_i(yc[r], F.mul_i(u, row[r])) for r in range(p.nreq)]
        yp = self._req_gather(p.block, proof.y_ldt, idx)
        return yp == yc

    def _dot_check(self, proof, idx, A) -> bool:
        p, F = self.p, self.F
        yc = list(proof.req[p.idot])
        # one batched RS call for all nwqrow A rows, [nwqrow, block, N]
        rows = F.to_limbs([v for i in range(p.nwqrow)
                           for v in layout_Aext(F, p, i, A)],
                          self.device).reshape(p.nwqrow, p.block, -1)
        rs = self.rs_factory(p.block, p.block_enc)
        aext = F.from_limbs(rs.interpolate(rows)[:, self._opened(idx)])
        for i in range(p.nwqrow):
            arow = aext[i]
            wrow = proof.req[p.iw + i]
            for r in range(p.nreq):
                yc[r] = F.add_i(yc[r], F.mul_i(arow[r], wrow[r]))
        yp = self._req_gather(p.dblock, proof.y_dot, idx)
        return yp == yc

    def _quadratic_check(self, proof, idx, u_quad) -> bool:
        p, F = self.p, self.F
        yc = list(proof.req[p.iquad])
        iqx, iqy, iqz = p.iq, p.iq + p.nqtriples, p.iq + 2 * p.nqtriples
        for i in range(p.nqtriples):
            u = u_quad[i]
            xr = proof.req[iqx + i]
            yr = proof.req[iqy + i]
            zr = proof.req[iqz + i]
            for r in range(p.nreq):
                t = F.sub_i(zr[r], F.mul_i(xr[r], yr[r]))
                yc[r] = F.add_i(yc[r], F.mul_i(u, t))
        yquad = (list(proof.y_quad_0) + [F.of_scalar(0)] * p.w +
                 list(proof.y_quad_2))
        yp = self._req_gather(p.dblock, yquad, idx)
        return yp == yc
