"""The host quad binding of the sumcheck verifier (reference
lib/sumcheck/quad.h:188-210), which the ZK verifier-constraint replay
(zk/common.py) uses when it is given no bound quads."""

from __future__ import annotations

from .eqs import eq_array_host, raw_eq2_host


def bind_quad_host(F, quad, logv: int, g0, g1, alpha, beta, logw: int,
                   h0_ch, h1_ch):
    """bind_gh_all (quad.h:188-210): fully bound quad scalar (host
    reference implementation; O(terms) bigint ops)."""
    nv = 1 << logv
    eqg = raw_eq2_host(F, logv, nv, g0, g1, alpha)
    nw = 1 << logw
    eqh0 = eq_array_host(F, logw, nw, h0_ch)
    eqh1 = eq_array_host(F, logw, nw, h1_ch)
    s = F.of_scalar(0)
    for t in range(quad.nterms):
        v = quad.v[t]
        d = eqg[int(quad.g[t])]
        vq = F.mul_i(beta, d) if v == 0 else F.mul_i(v, d)
        vq = F.mul_i(vq, eqh0[int(quad.h0[t])])
        vq = F.mul_i(vq, eqh1[int(quad.h1[t])])
        s = F.add_i(s, vq)
    return s
