"""Ligero Fiat-Shamir challenges (reference lib/ligero/ligero_transcript.h)."""

from __future__ import annotations

from typing import List


def write_commitment(commitment, ts) -> None:
    ts.write_bytes(commitment.root)


def gen_uldt(p, ts, F) -> List:
    return ts.elts(p.nwqrow, F)


def gen_alphal(nl: int, ts, F) -> List:
    return ts.elts(nl, F) if nl > 0 else []


def gen_alphaq(p, ts, F) -> List:
    """[nq][3] challenges."""
    if p.nq == 0:
        return []
    flat = ts.elts(3 * p.nq, F)
    return [flat[3 * i : 3 * i + 3] for i in range(p.nq)]


def gen_uquad(p, ts, F) -> List:
    return ts.elts(p.nqtriples, F) if p.nqtriples > 0 else []


def gen_idx(p, ts, F) -> List[int]:
    assert p.block_enc >= p.dblock
    assert p.block_enc - p.dblock >= p.nreq
    return ts.choose(p.block_enc - p.dblock, p.nreq)
