"""Ligero parameters, proof container, and shared helpers.

Semantic twin of reference lib/ligero/ligero_param.h:33-452 (tableau
geometry: rows [X | XD | XEXT], blinding rows ILDT/IDOT/IQUAD, witness
rows, quadratic triple rows; see the design comment there and
docs/specs/ligero.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..merkle.merkle import merkle_tree_len


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


MAX_LG_SIZE = 28
MAX_SIZE = 1 << MAX_LG_SIZE


class LigeroParam:
    """Tableau layout (ligero_param.h:116-307)."""

    def __init__(self, nw: int, nq: int, rateinv: int, nreq: int,
                 block_enc: Optional[int] = None, subfield_bytes: int = None,
                 field_bytes: int = None):
        self.nw = nw
        self.nq = nq
        self.rateinv = rateinv
        self.nreq = nreq
        self.r = nreq
        self._subfield_bits = 8 * subfield_bytes if subfield_bytes else None
        self._field_bytes = field_bytes
        self._subfield_bytes = subfield_bytes
        if block_enc is None:
            best, best_size = 1, float("inf")
            e = 1
            while e <= (1 << 28):
                size = self._layout(e)
                if size < best_size:
                    best_size = size
                    best = e
                e *= 2
            self._layout(best)
        else:
            assert self._layout(block_enc) < float("inf"), "block_enc too large"
        self._sanity()

    def _layout(self, e: int) -> float:
        self.block_enc = e
        if self._subfield_bits is not None and self._subfield_bits <= MAX_LG_SIZE:
            if e >= (1 << self._subfield_bits):
                return float("inf")
        if e > MAX_SIZE or self.rateinv > MAX_SIZE or (e + 1) < (2 + self.rateinv):
            return float("inf")
        self.block = (e + 1) // (2 + self.rateinv)
        if self.block < self.r:
            return float("inf")
        self.w = self.block - self.r
        if self.w < self.r:
            return float("inf")
        self.dblock = 2 * self.block - 1
        if e < self.dblock:
            return float("inf")
        self.block_ext = e - self.dblock
        self.nwrow = ceildiv(self.nw, self.w)
        self.nqtriples = ceildiv(self.nq, self.w)
        self.nwqrow = self.nwrow + 3 * self.nqtriples
        self.nrow = self.nwqrow + 3
        if self.nrow >= MAX_SIZE // e:
            return float("inf")
        self.mc_pathlen = merkle_tree_len(self.block_ext) if self.block_ext else 0
        # proof-size estimate (ligero_param.h:260-294)
        fb = self._field_bytes or 16
        sfb = self._subfield_bytes or fb
        sz = 32
        sz += (self.mc_pathlen // 2) * self.nreq * 32
        sz += self.block * fb
        sz += self.dblock * fb
        sz += (self.dblock - self.w) * fb
        sz += self.nreq * 32  # nonces
        sz += self.nrow * self.nreq * sfb
        return sz

    def _sanity(self):
        assert self.block_enc > self.block
        self.ildt = 0
        self.idot = 1
        self.iquad = 2
        self.iw = 3
        self.iq = self.iw + self.nwrow
        assert self.nrow == self.iq + 3 * self.nqtriples


@dataclass
class LigeroCommitment:
    root: bytes = b""


@dataclass
class LigeroProof:
    y_ldt: List = None       # [block]
    y_dot: List = None       # [dblock]
    y_quad_0: List = None    # [r]
    y_quad_2: List = None    # [dblock - block]
    req: List = None         # [nrow][nreq]
    merkle_path: List = None   # list of digests
    merkle_nonce: List = None  # [nreq] 32-byte nonces


@dataclass
class LigeroLinearConstraint:
    """A[c, w] = k term of the linear system A w = b."""
    c: int
    w: int
    k: object


@dataclass
class LigeroQuadraticConstraint:
    """W[x] * W[y] == W[z]."""
    x: int
    y: int
    z: int


def inner_product_vector(F, p: LigeroParam, nl: int, llterm,
                         alphal: List, lqc, alphaq: List) -> List:
    """Grand dot-product vector A (ligero_param.h:382-421); host."""
    A = [F.of_scalar(0)] * (p.nwqrow * p.w)
    for term in llterm:
        assert term.w < p.nw and term.c < nl
        A[term.w] = F.add_i(A[term.w], F.mul_i(term.k, alphal[term.c]))
    ax0 = p.nwrow * p.w
    ay0 = ax0 + p.nqtriples * p.w
    az0 = ay0 + p.nqtriples * p.w
    for i in range(p.nqtriples):
        for j in range(p.w):
            iw = j + i * p.w
            if iw >= p.nq:
                break
            l = lqc[iw]
            A[ax0 + iw] = F.add_i(A[ax0 + iw], alphaq[iw][0])
            A[l.x] = F.sub_i(A[l.x], alphaq[iw][0])
            A[ay0 + iw] = F.add_i(A[ay0 + iw], alphaq[iw][1])
            A[l.y] = F.sub_i(A[l.y], alphaq[iw][1])
            A[az0 + iw] = F.add_i(A[az0 + iw], alphaq[iw][2])
            A[l.z] = F.sub_i(A[l.z], alphaq[iw][2])
    return A


def layout_Aext(F, p: LigeroParam, i: int, A: List) -> List:
    """Public 'witness block' for row i of A: [0]*r + A[i*w:(i+1)*w]
    (ligero_param.h:425-430)."""
    return [F.of_scalar(0)] * p.r + A[i * p.w : (i + 1) * p.w]
