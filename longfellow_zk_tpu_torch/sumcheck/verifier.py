"""Sumcheck verifier (reference lib/sumcheck/verifier_layers.h:33-204 and
verifier.h:32-94); port of the JAX package's sumcheck/verifier.py.

The layer checks, the transcript and the input binding are host scalar
work, as in the JAX package.  The one O(terms) step of a layer, the
fully bound quad (the combined bind_gh_all form, quad.h:188-210), runs on
`device`: `bind_quad` builds the EQ arrays (K24) and sums the terms in K7
`fp_quad_bind` (csrc/quad_bind.cu), whose plain PyTorch version
(`quad_bind_plain`) is in this module too and runs for CPU tensors.
`bind_quad_host` is the JAX package's host loop, kept as the reference
the tests hold both to.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .. import kernels
from ..device import resolve_device
from ..fields.fp import MUL, _k3_scratch, check_elts, plain_of, route
from .circuit import (Challenge, Circuit, KMAX_COPIES, KMAX_LAYERS,
                      KMAX_OUTPUTS, LayerChallenge, Proof)
from .eqs import eq_array_host, eq_eval_host, raw_eq2_host
from .poly import eval_lagrange
from .prover import quad_tensors

# K7 grid: blocks of the first pass, at most
_K7_MAX_BLOCKS = 1024
# terms per chunk of the plain version (bounds its int64 temporaries)
_PLAIN_CHUNK = 1 << 16


@dataclass
class Claims:
    nv: int
    logv: int
    claim: List
    q: List
    g: List  # [2] lists


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


def quad_bind_plain(F, g, h0, h1, v, bmask, dot, eqh0, eqh1,
                    beta) -> torch.Tensor:
    """Plain version of K7: the field sum over t of (bmask[t] ? beta :
    v[t]) * dot[g[t]] * eqh0[h0[t]] * eqh1[h1[t]], one element [N]; the
    plain gathers, products (K1's) and sums (K3's), in chunks of terms."""
    pm = plain_of(F)
    parts = [F.zeros((), v.device)]
    for s in range(0, g.shape[0], _PLAIN_CHUNK):
        e = s + _PLAIN_CHUNK
        vq = torch.where(bmask[s:e, None], beta, v[s:e])
        t = pm.elementwise_plain(F, MUL, vq, dot[g[s:e]])
        t = pm.elementwise_plain(F, MUL, t, eqh0[h0[s:e].long()])
        t = pm.elementwise_plain(F, MUL, t, eqh1[h1[s:e].long()])
        parts.append(pm.axis_sum_plain(F, t, 0))
    return pm.axis_sum_plain(F, torch.stack(parts), 0)


def fp_quad_bind(F, g, h0, h1, v, bmask, dot, eqh0, eqh1,
                 beta) -> torch.Tensor:
    """K7 wrapper: the bound quad of one layer as one element [N] on the
    tensors' device (see quad_bind_plain)."""
    name = route("fp_quad_bind", F, g, h0, h1, v, bmask, dot, eqh0, eqh1,
                 beta)
    if name is None:
        return quad_bind_plain(F, g, h0, h1, v, bmask, dot, eqh0, eqh1, beta)
    T = g.shape[0]
    for t, tname in ((v, "v"), (dot, "dot"), (eqh0, "eqh0"),
                     (eqh1, "eqh1")):
        check_elts(t, tname, F.elt_shape)
    if beta.shape != tuple(F.elt_shape) or beta.dtype != torch.int32:
        raise ValueError("beta must be one int32 element")
    for t, tname, dt in ((g, "g", torch.int64), (h0, "h0", torch.int32),
                         (h1, "h1", torch.int32),
                         (bmask, "bmask", torch.bool)):
        if t.dtype != dt or t.shape != (T,) or not t.is_contiguous():
            raise ValueError("%s must be a contiguous %s [%d] tensor"
                             % (tname, dt, T))
    if v.shape[0] != T:
        raise ValueError("v must have one element per term")
    beta = beta.contiguous()
    nblk = max(1, min(_K7_MAX_BLOCKS, (T + 255) // 256))
    out = torch.empty(F.elt_shape, dtype=torch.int32, device=v.device)
    part, tick = _k3_scratch(v.device, F.nlimb * nblk, 1)
    kernels.launch(name, 1, out.data_ptr(), part.data_ptr(),
                   g.data_ptr(), h0.data_ptr(), h1.data_ptr(), v.data_ptr(),
                   bmask.data_ptr(), dot.data_ptr(), eqh0.data_ptr(),
                   eqh1.data_ptr(), beta.data_ptr(), T, nblk, tick.data_ptr())
    return out


def bind_quad(F, quad, logv: int, g0, g1, alpha, beta, logw: int, h0_ch,
              h1_ch, device):
    """bind_gh_all on `device` (the JAX package's bind_quad_device): the
    EQ arrays dot = EQ(G0, .) + alpha EQ(G1, .) over 2^logv outputs and
    EQ(H0, .), EQ(H1, .) over 2^logw inputs (K24: two launches, the
    input tables two lanes of one), then K7 over the
    layer's uploaded terms (the circuit reader has checked their wire
    indices against the layers' widths).  Returns the bound quad as a
    host element."""
    qd = quad_tensors(F, quad, device)
    nv, nw = 1 << logv, 1 << logw
    dot = F.eq_table(F.to_limbs(list(g0[:logv]), device), nv,
                     F.to_limbs(alpha, device),
                     F.to_limbs(list(g1[:logv]), device))
    eqh0, eqh1 = F.eq_table(F.to_limbs(
        list(h0_ch[:logw]) + list(h1_ch[:logw]), device).reshape(
            (2, logw) + F.elt_shape), nw)
    return F.from_limbs(fp_quad_bind(
        F, qd["g"], qd["h0"], qd["h1"], qd["v"], qd["bmask"], dot, eqh0,
        eqh1, F.to_limbs(beta, device)))


class SumcheckVerifier:
    """Layer verification returning input claims (VerifierLayers); the
    bound quads on `device`."""

    def __init__(self, F, device=None):
        self.F = F
        self.device = resolve_device(device)

    def circuit(self, circ: Circuit, proof: Proof, ts
                ) -> Tuple[Optional[Claims], Optional[Challenge], str]:
        F = self.F
        if len(proof.layers) < circ.nl:
            return None, None, "Proof size less than circuit layers"
        q, g = ts.begin_circuit()
        ch = Challenge(q=q, g=g, layers=[])
        cl = Claims(nv=circ.nv, logv=circ.logv,
                    claim=[F.of_scalar(0), F.of_scalar(0)],
                    q=q, g=[g, list(g)])
        why = self._layers(cl, circ, proof, ts, ch)
        if why is not None:
            return None, None, why
        return cl, ch, "ok"

    def _layers(self, cl: Claims, circ: Circuit, proof: Proof, ts,
                ch: Challenge) -> Optional[str]:
        F = self.F
        for ly in range(circ.nl):
            layer = circ.layers[ly]
            plr = proof.layers[ly]
            alpha, beta = ts.begin_layer()
            lch = LayerChallenge(alpha=alpha, beta=beta, cb=[], hb=[[], []])
            claim = F.add_i(cl.claim[0], F.mul_i(alpha, cl.claim[1]))

            # copy rounds
            for rnd in range(circ.logc):
                tp = plr.cp[rnd]
                if F.add_i(tp[0], tp[1]) != claim:
                    return "claim != p(0) + p(1)"
                r = ts.round(tp)
                lch.cb.append(r)
                claim = eval_lagrange(F, tp, r)

            # wire rounds
            for rnd in range(layer.logw):
                for hand in range(2):
                    tp = plr.hp[hand][rnd]
                    if F.add_i(tp[0], tp[1]) != claim:
                        return "claim != p(0) + p(1)"
                    r = ts.round(tp)
                    lch.hb[hand].append(r)
                    claim = eval_lagrange(F, tp, r)

            # final check: claim = EQ[Q,C] QUAD[G|R,L] W[R,C] W[L,C]
            bound_quad = bind_quad(
                F, layer.quad, cl.logv, cl.g[0][: cl.logv],
                cl.g[1][: cl.logv], alpha, beta, layer.logw,
                lch.hb[0], lch.hb[1], self.device)
            got = eq_eval_host(F, circ.logc, circ.nc, cl.q, lch.cb)
            got = F.mul_i(got, bound_quad)
            got = F.mul_i(got, plr.wc[0])
            got = F.mul_i(got, plr.wc[1])
            if got != claim:
                return "got != claim (layer)"
            ts.write_elts(plr.wc)
            ch.layers.append(lch)
            cl.nv = layer.nw
            cl.logv = layer.logw
            cl.claim = [plr.wc[0], plr.wc[1]]
            cl.q = lch.cb
            cl.g = [lch.hb[0], lch.hb[1]]
        return None


def bind_dense_host(F, vals: List, r) -> List:
    """Host Dense::bind along a flat list (zero-padded)."""
    out = []
    n = len(vals)
    for i in range((n + 1) // 2):
        lo = vals[2 * i]
        hi = vals[2 * i + 1] if 2 * i + 1 < n else F.of_scalar(0)
        out.append(F.add_i(lo, F.mul_i(r, F.sub_i(hi, lo))))
    return out


def verify(circ: Circuit, proof: Proof, W_host: List[List], ts, F,
           device=None) -> Tuple[bool, str]:
    """Full plain-sumcheck verification with direct input binding
    (verifier.h:39-91).  W_host: [nc][n_wires] per-copy wire values; ts a
    TranscriptSumcheck.  The bound quads on `device`."""
    if circ.nl > KMAX_LAYERS:
        return False, "too many layers"
    if circ.nc > KMAX_COPIES:
        return False, "too many copies"
    if circ.nv > KMAX_OUTPUTS:
        return False, "too many outputs"
    if circ.nl != len(circ.layers) or circ.nl != len(proof.layers):
        return False, "circuit and proof layer counts must match"

    ts.write_input(W_host)
    v = SumcheckVerifier(F, device)
    cl, ch, why = v.circuit(circ, proof, ts)
    if cl is None:
        return False, why

    # bind copy variables: W[wire][copy] -> flat per-wire scalars
    nwires = len(W_host[0])
    cols = [[W_host[c][w] for c in range(circ.nc)] for w in range(nwires)]
    for rnd in range(circ.logc):
        cols = [bind_dense_host(F, col, cl.q[rnd]) for col in cols]
    flat = [col[0] for col in cols]
    # bind gate variables for the two hands
    for hand in range(2):
        vals = list(flat)
        for rnd in range(cl.logv):
            vals = bind_dense_host(F, vals, cl.g[hand][rnd])
        if vals[0] != cl.claim[hand]:
            return False, "got != cl.claim[hand]"
    return True, "ok"
