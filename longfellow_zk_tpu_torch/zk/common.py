"""ZK composition plumbing shared by prover and verifier.

Semantic twin of reference lib/zk/zk_common.h:33-451: the sumcheck
transcript is encrypted with a committed random pad; this module builds
the Ligero linear system A x = b whose satisfaction (over the committed
pad + witness) says "the decrypted transcript satisfies the sumcheck
verifier".  Per layer, the pad layout is

  [CLAIM_PAD[layer-1] | POLY_PAD[0..2*logw) | CLAIM_PAD[layer]]

where a poly pad is (dP(0), dP(2)) — the p(1) value is implied by
claim_{r-1} - p(0) — and a claim pad is (dWC0, dWC1, dWC0*dWC1); the
product entry makes the per-layer quadratic constraint (zk_common.h:149).

All of this is host-side scalar algebra over O(layers * logw) values,
which the verifier runs; the prover builds the same system on the card
(zk/fused.py), from the same positions.
"""

from __future__ import annotations

from typing import List, Tuple

from ..ligero.param import LigeroLinearConstraint, LigeroQuadraticConstraint
from ..sumcheck.circuit import Circuit, Proof
from ..sumcheck.eqs import eq_eval_host
from ..sumcheck.poly import eval_newton, newton_of_lagrange
from ..sumcheck.prover import _raw_eq2_dev
from ..sumcheck.transcript_sumcheck import TranscriptSumcheck
from ..sumcheck.verifier import bind_quad

HASH_OF_A = bytes([0xDE, 0xAD, 0xBE, 0xEF] + [0] * 28)


class PadLayout:
    """(zk_common.h:193-248)."""

    def __init__(self, logw: int):
        self.logw = logw

    def poly_pad(self, r: int, point: int) -> int:
        assert point in (0, 2)
        return 2 * r + (0 if point == 0 else 1)

    def claim_pad(self, n: int) -> int:
        return self.poly_pad(2 * self.logw, 0) + n

    def layer_size(self) -> int:
        return self.claim_pad(3)

    def ovp_claim_pad_m1(self, n: int) -> int:
        return n

    def ovp_poly_pad(self, r: int, point: int) -> int:
        return 3 + self.poly_pad(r, point)

    def ovp_claim_pad(self, n: int) -> int:
        return 3 + self.claim_pad(n)

    def ovp_layer_size(self) -> int:
        return self.ovp_claim_pad(3)


def pad_size(circ: Circuit) -> int:
    return sum(PadLayout(l.logw).layer_size() for l in circ.layers)


def setup_lqc(circ: Circuit, start_pad: int) -> List[LigeroQuadraticConstraint]:
    lqc = []
    pi = start_pad
    for layer in circ.layers:
        pl = PadLayout(layer.logw)
        lqc.append(LigeroQuadraticConstraint(
            x=pi + pl.claim_pad(0),
            y=pi + pl.claim_pad(1),
            z=pi + pl.claim_pad(2)))
        pi += pl.layer_size()
    return lqc


def initialize_sumcheck_fiat_shamir(ts, circ: Circuit, pub: List, F) -> None:
    """(zk_common.h:163-180): circuit id, public inputs, pro-forma output,
    correlation-intractability zeroes."""
    ts.write_bytes(circ.id)
    for i in range(circ.npub_in):
        ts.write_elt(pub[i], F)
    ts.write_elt(F.of_scalar(0), F)
    ts.write0(circ.nterms())


def _wpoly_lagrange_coef(F, x) -> List:
    """dot_interpolation for the degree-2 round polys (poly.h:126-149):
    coefficient vector V with P(x) = sum_k V[k] P(k)."""
    out = []
    for k in range(3):
        ident = [F.of_scalar(1) if i == k else F.of_scalar(0) for i in range(3)]
        out.append(eval_newton(F, newton_of_lagrange(F, ident), x))
    return out


class Expression:
    """known + sum_i symbolic[i] * pad[i] (zk_common.h:255-289)."""

    def __init__(self, nvar: int, F):
        self.F = F
        self.known = F.of_scalar(0)
        self.symbolic = [F.of_scalar(0)] * nvar

    def scale(self, k):
        F = self.F
        self.known = F.mul_i(self.known, k)
        self.symbolic = [F.mul_i(e, k) for e in self.symbolic]

    def axpy(self, var: int, known_value, k):
        F = self.F
        self.known = F.add_i(self.known, F.mul_i(k, known_value))
        self.symbolic[var] = F.add_i(self.symbolic[var], k)

    def axmy(self, var: int, known_value, k):
        F = self.F
        self.known = F.sub_i(self.known, F.mul_i(k, known_value))
        self.symbolic[var] = F.sub_i(self.symbolic[var], k)


def verifier_constraints(circ: Circuit, pub: List, proof: Proof, ts, pi: int,
                         F, device) -> Tuple[List[LigeroLinearConstraint],
                                             List, int]:
    """Symbolic replay of the sumcheck verifier (zk_common.h:49-136).

    Returns (a, b, num_constraints).  `ts` is the raw Transcript (the
    caller has already absorbed commitment + public inputs); it advances
    exactly like the real sumcheck transcript.  Each layer's quad is
    bound on `device` (K7).  The input-binding EQ array (one element per
    circuit input) is built on `device`.  The verifier's step: the
    prover builds the same constraints on the card (zk/fused.py).
    """
    tss = TranscriptSumcheck(ts, F)
    q, g = tss.begin_circuit()
    assert circ.logc == 0, "assuming that copies=1"

    claims = [F.of_scalar(0), F.of_scalar(0)]
    cla_logv = circ.logv
    cla_q = q
    cla_g = [g, list(g)]

    a: List[LigeroLinearConstraint] = []
    b: List = []
    ci = 0

    for ly in range(circ.nl):
        layer = circ.layers[ly]
        plr = proof.layers[ly]
        alpha, beta = tss.begin_layer()
        assert layer.logw > 0

        pl = PadLayout(layer.logw)
        expr = Expression(pl.ovp_layer_size(), F)
        # claim_{-1} = cl0 + alpha*cl1
        expr.axpy(pl.ovp_claim_pad_m1(0), claims[0], F.of_scalar(1))
        expr.axpy(pl.ovp_claim_pad_m1(1), claims[1], alpha)

        hb = [[], []]
        for rnd in range(layer.logw):
            for hand in range(2):
                r = 2 * rnd + hand
                hp = plr.hp[hand][rnd]
                rr = tss.round(hp)
                hb[hand].append(rr)
                lag = _wpoly_lagrange_coef(F, rr)
                # p_r(1) = claim_{r-1} - p_r(0)
                expr.axmy(pl.ovp_poly_pad(r, 0), hp[0], F.of_scalar(1))
                expr.scale(lag[1])
                expr.axpy(pl.ovp_poly_pad(r, 0), hp[0], lag[0])
                expr.axpy(pl.ovp_poly_pad(r, 2), hp[2], lag[2])

        quad = bind_quad(F, layer.quad, cla_logv, cla_g[0][:cla_logv],
                         cla_g[1][:cla_logv], alpha, beta, layer.logw,
                         hb[0], hb[1], device)
        eqv = eq_eval_host(F, circ.logc, circ.nc, cla_q, [])
        eqq = F.mul_i(eqv, quad)

        # finalize (zk_common.h:373-399)
        rhs = F.sub_i(F.mul_i(eqq, F.mul_i(plr.wc[0], plr.wc[1])), expr.known)
        lhs = list(expr.symbolic)
        lhs[pl.ovp_claim_pad(0)] = F.sub_i(lhs[pl.ovp_claim_pad(0)],
                                           F.mul_i(eqq, plr.wc[1]))
        lhs[pl.ovp_claim_pad(1)] = F.sub_i(lhs[pl.ovp_claim_pad(1)],
                                           F.mul_i(eqq, plr.wc[0]))
        lhs[pl.ovp_claim_pad(2)] = F.sub_i(lhs[pl.ovp_claim_pad(2)], eqq)
        b.append(rhs)
        i0 = pl.ovp_poly_pad(0, 0) if ly == 0 else pl.ovp_claim_pad_m1(0)
        for i in range(i0, len(lhs)):
            a.append(LigeroLinearConstraint(
                c=ci, w=(pi + i) - pl.ovp_poly_pad(0, 0), k=lhs[i]))
        ci += 1

        tss.write_elts(plr.wc)

        claims = [plr.wc[0], plr.wc[1]]
        cla_logv = layer.logw
        cla_q = []
        cla_g = [hb[0], hb[1]]
        pi += pl.layer_size()

    # input-binding constraint (zk_common.h:129-135, 406-439)
    alpha = ts.elt(F)
    plr = proof.layers[circ.nl - 1]
    got = F.add_i(plr.wc[0], F.mul_i(alpha, plr.wc[1]))

    ninp, npub = circ.ninputs, circ.npub_in
    # b_i = EQ(G0, i) + alpha * EQ(G1, i), on `device` (K1)
    bs = F.from_limbs(_raw_eq2_dev(
        F, cla_logv, ninp, F.to_limbs(list(cla_g[0][:cla_logv]), device),
        F.to_limbs(list(cla_g[1][:cla_logv]), device),
        F.to_limbs(alpha, device), F.to_limbs(1, device)))
    pub_binding = F.of_scalar(0)
    for i in range(ninp):
        b_i = int(bs[i])
        if i < npub:
            pub_binding = F.add_i(pub_binding, F.mul_i(b_i, pub[i]))
        else:
            a.append(LigeroLinearConstraint(c=ci, w=i - npub, k=b_i))

    pl0 = PadLayout(0)
    assert pi >= pl0.ovp_poly_pad(0, 0)
    claim_pad_m1 = pi - pl0.ovp_poly_pad(0, 0)
    mone = F.neg_i(F.of_scalar(1))
    a.append(LigeroLinearConstraint(c=ci, w=claim_pad_m1 + 0, k=mone))
    a.append(LigeroLinearConstraint(c=ci, w=claim_pad_m1 + 1, k=F.neg_i(alpha)))
    b.append(F.sub_i(got, pub_binding))
    return a, b, ci + 1
