"""The ZK prover's steps after the sumcheck, on the card: the Ligero
linear constraints (K11), the grand inner-product vector A (K12) and the
Ligero finish, every Fiat-Shamir step of it in K9.

Port of the JAX package's zk/fused.py (`FusedStatic`, `constraints_dev`,
`ligero_finish_dev`).  The JAX package traces the whole post-commit
prove as one program for small circuits only (its `fused_prove_fn`,
routed by a term limit); the port runs these functions as launches of
its one phased flow (zk/prover.py), for every circuit, so nothing here
packs or unpacks a program's output.

  - constraints_dev: the twin of zk/common.py verifier_constraints for
    the prover.  The constraint POSITIONS are static circuit geometry
    (FusedStatic); only the VALUES depend on the challenges, which K10
    left on the card.  Per layer, K11 (`zk_constraints`) replays the
    verifier's symbolic coefficient vector; the input binding then takes
    alpha_b from K9 and EQ(G0, .) + alpha_b EQ(G1, .) over the inputs from
    one K24 launch, closed by (-1, -alpha_b);
  - ligero_finish_dev: the twin of LigeroProver's host prove
    (ligero_prover.h:84-146): the HASH_OF_A write, the challenge draws
    (u_ldt, alphal, alphaq, u_quad from one stream), A in K12
    (`ligero_inner_product`), the responses (K1, K3, the RS kernels),
    the four response writes, the column choice (K9 mode 9) and the
    column gather.

The steps carry the prover's lane axis (the proofs of a batch,
zk/batch.py): k, the challenges, A, the responses and the choices are
[B, ...], FusedTables is shared, K11 and K12 run a grid row a lane.

Every table these steps read is uploaded before the sumcheck's first
round by `prepare`, which returns them as one FusedTables that each step
takes as an argument, so nothing between that round and the prover's
one fetch waits on the card.  For a CUDA tensor the wrappers launch
their kernels; for a CPU tensor they run the plain versions beside them
(`*_plain`, over the plain field ops of fields/fp.py and fields/gf2.py).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from .. import kernels
from ..fields.fp import ADD, MUL, SUB, check_elts, plain_of, route
from ..random_oracle import device_fs as dfs
from ..sumcheck.circuit import Circuit
from .common import HASH_OF_A, PadLayout


class FusedStatic:
    """Static (circuit-geometry) data of the constraint build and of A:
    the positions mirror zk/common.py verifier_constraints exactly (the
    JAX package's zk/fused.py:41-103).

    ws, cs      the position in the witness and the constraint of each
                linear term, in the order of the k vector: each layer's
                coefficients sym[i0:], the input binding's, the pair
                (-1, -alpha_b);
    qws, qcols, qneg
                the quadratic entries of A: for each of x, y, z of each
                quadratic constraint, a + entry of alphaq[qcol] at its
                row position and a - entry at the witness position;
    lay         K11's table, int32 [nl, 4]: (logw, i0, the layer's first
                round in the sumcheck's rows, its offset in k);
    ptr, ent    K12's plan: a CSR by position of A, ent [nent, 2] holding
                (t, cs[t]) for a linear term and (-1 - qcol, qneg) for a
                quadratic entry."""

    def __init__(self, circ: Circuit, p, lqc, n_witness: int):
        assert circ.logc == 0, "the constraint build assumes one copy"
        self.circ = circ
        self.p = p
        ws: List[int] = []
        cs: List[int] = []
        lay = []
        pi, roff = n_witness, 0
        for ly, layer in enumerate(circ.layers):
            pl = PadLayout(layer.logw)
            nvar = pl.ovp_layer_size()
            i0 = pl.ovp_poly_pad(0, 0) if ly == 0 else pl.ovp_claim_pad_m1(0)
            lay.append((layer.logw, i0, roff, len(ws)))
            for i in range(i0, nvar):
                ws.append((pi + i) - pl.ovp_poly_pad(0, 0))
                cs.append(ly)
            pi += pl.layer_size()
            roff += layer.logw
        self.nk_layers = len(ws)
        self.nthreads = 32 * -(-max(4 * layer.logw + 6
                                    for layer in circ.layers) // 32)
        # input-binding constraint (zk_common.h:129-135, 406-439)
        ci = circ.nl
        ws += [i - circ.npub_in for i in range(circ.npub_in, circ.ninputs)]
        cs += [ci] * (circ.ninputs - circ.npub_in)
        claim_pad_m1 = pi - PadLayout(0).ovp_poly_pad(0, 0)
        ws += [claim_pad_m1, claim_pad_m1 + 1]
        cs += [ci, ci]
        self.nl_constraints = ci + 1
        # lqc triples of inner_product_vector (ligero_param.h:382-421)
        ax0 = p.nwrow * p.w
        ay0 = ax0 + p.nqtriples * p.w
        az0 = ay0 + p.nqtriples * p.w
        qws, qcols, qneg = [], [], []
        for iw in range(p.nq):
            for j, base in enumerate((ax0, ay0, az0)):
                qws.append(base + iw)
                qcols.append(3 * iw + j)
                qneg.append(0)
            l = lqc[iw]
            for j, wpos in enumerate((l.x, l.y, l.z)):
                qws.append(wpos)
                qcols.append(3 * iw + j)
                qneg.append(1)
        self.ws = np.asarray(ws, np.int64)
        self.cs = np.asarray(cs, np.int32)
        self.qws = np.asarray(qws, np.int64)
        self.qcols = np.asarray(qcols, np.int32)
        self.qneg = np.asarray(qneg, np.int32)
        self.lay = np.asarray(lay, np.int32).reshape(-1, 4)
        # K12's plan: every entry of A, sorted by position
        nA = p.nwqrow * p.w
        pos = np.concatenate([self.ws, self.qws])
        assert pos.size == 0 or (pos.min() >= 0 and pos.max() < nA)
        src = np.concatenate([np.arange(len(ws), dtype=np.int32),
                              -1 - self.qcols])
        aux = np.concatenate([self.cs, self.qneg])
        order = np.argsort(pos, kind="stable")
        self.ptr = np.searchsorted(pos[order], np.arange(nA + 1)).astype(
            np.int32)
        self.ent = np.stack([src[order], aux[order]], axis=1).astype(
            np.int32)
        self._dev = {}  # prepare's FusedTables, by device


def fused_static(circ: Circuit, p, lqc, n_witness: int) -> FusedStatic:
    """The FusedStatic of (circ, p), built once and cached on the
    circuit."""
    cache = circ.__dict__.setdefault("_torch_cache", {})
    key = ("fused", p.nw, p.nq, p.w, p.r, p.nwrow, p.nqtriples, n_witness)
    if key not in cache:
        cache[key] = FusedStatic(circ, p, lqc, n_witness)
    return cache[key]


def lagrange3_consts(F, device) -> torch.Tensor:
    """K11's constants, int32 [6, N] on `device` in the kernels' form:
    the evaluation points x_0, x_1, x_2 of a hand-round polynomial (0, 1,
    2 for a prime field; 0, 1, g for GF(2^128): the host field's
    poly_evaluation_point) and the inverse denominators
    1 / prod_{j != k} (x_k - x_j) of its Lagrange basis (the JAX
    package's zk/fused.py:110 _lagrange3_consts)."""
    x = [F.poly_evaluation_point(k) for k in range(3)]
    inv_d = []
    for k in range(3):
        d = F.of_scalar(1)
        for j in range(3):
            if j != k:
                d = F.mul_i(d, F.sub_i(x[k], x[j]))
        inv_d.append(F.inv_i(d))
    return F.to_limbs(x + inv_d, device)


class FusedTables(NamedTuple):
    """What the steps after the sumcheck read besides its outputs, on the
    card: the static data (stat, on the host), K11's table (lay) and
    constants (lag), K12's plan (ptr, ent) and the bytes of the HASH_OF_A
    write."""

    stat: FusedStatic
    lay: torch.Tensor
    lag: torch.Tensor
    ptr: torch.Tensor
    ent: torch.Tensor
    hash_of_a: torch.Tensor


def prepare(F, stat: FusedStatic, device) -> FusedTables:
    """Every upload of constraints_dev and ligero_finish_dev, made before
    the sumcheck's first round, once per device (kept with stat, which
    belongs to one circuit and so to one field F)."""
    key = str(device)
    if key not in stat._dev:
        def up(a):
            return torch.as_tensor(a, device=device)
        stat._dev[key] = FusedTables(
            stat, up(stat.lay), lagrange3_consts(F, device), up(stat.ptr),
            up(stat.ent), dfs.bstr_tensor(HASH_OF_A, device))
    return stat._dev[key]


# ----------------------------------------------------------------------
# K11: the layers' constraint coefficients
# ----------------------------------------------------------------------

def constraints_plain(F, lay: np.ndarray, rows: torch.Tensor,
                      scal: torch.Tensor, wcpad: torch.Tensor,
                      lag: torch.Tensor) -> torch.Tensor:
    """Plain version of K11 (csrc/constraints.cu), every layer of every
    lane at once (rows [B, R, 2, 4, N], scal [B, nl, 4, N], wcpad [B, nl,
    2, N]): sym [B, nl, nvar_max, N], round by round, a layer with fewer
    rounds left as it is (the rows of the table lay, a host array, drive
    the loop); returns [B, nk, N] ([nk, N] without the lane axis)."""
    if scal.dim() == 3:
        return constraints_plain(F, lay, rows[None], scal[None],
                                 wcpad[None], lag)[0]
    ew = plain_of(F).elementwise_plain
    N = F.nlimb
    B, nl = rows.shape[0], lay.shape[0]
    logw = lay[:, 0].astype(np.int64)
    nv = int((4 * logw + 6).max())
    dev = rows.device
    one = F.to_limbs(1, dev)
    t = torch.arange(nv, device=dev)
    sym = torch.zeros((B, nl, nv, N), dtype=torch.int32, device=dev)
    sym[:, :, 0] = one
    sym[:, :, 1] = scal[:, :, 0]
    x0, x1, x2, d0, d1, d2 = lag.unbind(0)
    rr = rows.reshape(B, -1, 4, N)[:, :, 3]
    for rnd in range(2 * int(logw.max())):
        live = torch.as_tensor(2 * logw > rnd, device=dev)
        src = np.minimum(2 * lay[:, 2].astype(np.int64) + rnd,
                         rr.shape[1] - 1)
        r = rr[:, torch.as_tensor(src, device=dev)]             # [B, nl, N]
        a, b, c = ew(F, SUB, r, x0), ew(F, SUB, r, x1), ew(F, SUB, r, x2)
        L0 = ew(F, MUL, ew(F, MUL, b, c), d0)[:, :, None]
        L1 = ew(F, MUL, ew(F, MUL, a, c), d1)[:, :, None]
        L2 = ew(F, MUL, ew(F, MUL, a, b), d2)[:, :, None]
        at0 = ((t == 3 + rnd * 2)[None] & live[:, None])[..., None]
        at2 = ((t == 4 + rnd * 2)[None] & live[:, None])[..., None]
        sym = torch.where(at0, ew(F, SUB, sym, one), sym)
        sym = torch.where(live[:, None, None], ew(F, MUL, sym, L1), sym)
        sym = torch.where(at0, ew(F, ADD, sym, L0), sym)
        sym = torch.where(at2, ew(F, ADD, sym, L2), sym)
    c0 = torch.as_tensor(3 + 4 * logw, device=dev)[:, None, None]
    alpha, bq, wc0, wc1 = scal.unbind(2)
    tt1 = ew(F, MUL, bq, ew(F, SUB, wc1, wcpad[:, :, 1]))[:, :, None]
    tt0 = ew(F, MUL, bq, ew(F, SUB, wc0, wcpad[:, :, 0]))[:, :, None]
    tn = t[None, :, None]
    sym = torch.where(tn == c0, ew(F, SUB, sym, tt1), sym)
    sym = torch.where(tn == c0 + 1, ew(F, SUB, sym, tt0), sym)
    sym = torch.where(tn == c0 + 2, ew(F, SUB, sym, bq[:, :, None]), sym)
    return torch.cat([sym[:, ly, lay[ly, 1] : 4 * logw[ly] + 6]
                      for ly in range(nl)], dim=1)


def zk_constraints(F, tabs: FusedTables, rows: torch.Tensor,
                   scal: torch.Tensor, wcpad: torch.Tensor) -> torch.Tensor:
    """K11: the layers' part of the k vector, [stat.nk_layers, N].  rows
    [sum logw, 2, 4, N] are the sumcheck's rows (r at [..., 3, :]), scal
    [nl, 4, N] each layer's (alpha, bound quad, wc0, wc1) with wc the raw
    claims, wcpad [nl, 2, N] their pads.  With a leading lane axis on
    rows, scal and wcpad (the proofs of a batch), [B, nk_layers, N] in
    the one launch."""
    stat, lag = tabs.stat, tabs.lag
    nl = stat.lay.shape[0]
    lanes = scal.dim() == 4
    if not lanes:
        rows, scal, wcpad = rows[None], scal[None], wcpad[None]
    B, R = rows.shape[0], int(stat.lay[:, 0].sum())
    for t, nm, shape in ((rows, "rows", (B, R, 2, 4)),
                         (scal, "scal", (B, nl, 4)),
                         (wcpad, "wcpad", (B, nl, 2)), (lag, "lag", (6,))):
        check_elts(t, nm, F.elt_shape)
        if tuple(t.shape[: t.dim() - 1]) != shape:
            raise ValueError("%s must be [%s, N], got %s"
                             % (nm, ", ".join(map(str, shape)),
                                tuple(t.shape)))
    name = route("zk_constraints", F, rows, scal, wcpad, lag, tabs.lay)
    if name is None:
        out = constraints_plain(F, stat.lay, rows, scal, wcpad, lag)
    else:
        out = torch.empty((B, stat.nk_layers) + F.elt_shape,
                          dtype=torch.int32, device=rows.device)
        kernels.launch(name, 1, tabs.lay.data_ptr(), nl, stat.nthreads,
                       rows.data_ptr(), scal.data_ptr(), wcpad.data_ptr(),
                       lag.data_ptr(), out.data_ptr(), B, R, stat.nk_layers)
    return out if lanes else out[0]


def constraints_dev(F, tabs: FusedTables, outs: List[dict],
                    rows: torch.Tensor, pads, fs: torch.Tensor,
                    one: torch.Tensor) -> torch.Tensor:
    """The k vectors of the prover's linear constraints, [B, len(stat.ws),
    N], each aligned with stat.ws / stat.cs (the JAX package's
    zk/fused.py:139), from the sumcheck's device outputs of the lanes of
    fs [B, 104] (SumcheckProver._rounds: outs, rows; pads from its
    prepare).  The input binding samples alpha_b from a fresh squeeze of
    fs, which stays as it was (Transcript.elt after the last layer's
    write).  Nothing is read back."""
    circ = tabs.stat.circ
    B = fs.shape[0]
    scal = torch.stack([x for o in outs for x in
                        (o["alpha"], o["bq"], o["wc"][:, 0], o["wc"][:, 1])],
                       dim=1).reshape((B, circ.nl, 4) + F.elt_shape)
    wcpad = torch.stack([wc for *_, wc in pads], dim=1)
    k_layers = zk_constraints(F, tabs, rows, scal, wcpad)
    # input binding (zk_common.h:406-439)
    alpha_b = dfs.dev_sample_elts(F, dfs.new_prf(fs.device, B), 1,
                                  fs=fs)[:, 0]
    g0, g1 = outs[-1]["g"]
    vec = F.eq_table(g0, circ.ninputs, alpha_b, g1)
    pair = F.sub(torch.zeros_like(tabs.lag[:2]),
                 torch.stack([one.expand_as(alpha_b), alpha_b], dim=1))
    return torch.cat([k_layers, vec[:, circ.npub_in :], pair], dim=1)


# ----------------------------------------------------------------------
# K12: the grand inner-product vector A
# ----------------------------------------------------------------------

def inner_product_plain(F, ptr: torch.Tensor, ent: torch.Tensor,
                        k: torch.Tensor, alphal: torch.Tensor,
                        alphaq: torch.Tensor, nrow: int, r: int,
                        wd: int) -> torch.Tensor:
    """Plain version of K12 (csrc/ligero_a.cu) for lanes (k [B, nk, N],
    alphal and alphaq [B, ., N]): every entry's value in plan order, one
    segment sum by position a lane (K2's plain version), then the [B,
    nrow, r + wd] layout with r zeros a row ([nrow, r + wd] without the
    lane axis)."""
    if k.dim() == 2:
        return inner_product_plain(F, ptr, ent, k[None], alphal[None],
                                   alphaq[None], nrow, r, wd)[0]
    pm = plain_of(F)
    B = k.shape[0]
    src, aux = ent[:, 0].long(), ent[:, 1].long()
    isq = (src < 0)[:, None]
    kv = pm.elementwise_plain(F, MUL, k[:, src.clamp(min=0)],
                              alphal[:, torch.where(src < 0, 0, aux)])
    if alphaq.shape[1] == 0:
        alphaq = torch.zeros_like(alphal[:, :1])
    q = alphaq[:, (-1 - src).clamp(min=0)]
    qv = torch.where((aux == 1)[:, None], pm.elementwise_plain(
        F, SUB, torch.zeros_like(q), q), q)
    vals = torch.where(isq, qv, kv)
    A = torch.stack([pm.segment_sum_plain(F, vals[b], ptr[:-1], ptr[1:])
                     for b in range(B)])
    out = torch.zeros((B, nrow, r + wd) + F.elt_shape, dtype=torch.int32,
                      device=k.device)
    out[:, :, r:] = A.reshape((B, nrow, wd) + F.elt_shape)
    return out


def ligero_inner_product(F, tabs: FusedTables, k: torch.Tensor,
                         alphal: torch.Tensor,
                         alphaq: torch.Tensor) -> torch.Tensor:
    """K12: A laid out as the dot test's rows (layout_Aext), [nwqrow,
    block, N]: A[w] = sum of k[t] * alphal[cs[t]] over the linear terms at
    w, plus or minus alphaq[qcol] over the quadratic entries at w, at row
    w // p.w, column p.r + w % p.w.  With a leading lane axis on k,
    alphal and alphaq (the proofs of a batch), [B, nwqrow, block, N] in
    the one launch."""
    stat = tabs.stat
    p = stat.p
    lanes = k.dim() == 3
    k, alphal, alphaq = (t.contiguous() if lanes else t[None]
                         for t in (k, alphal, alphaq))
    B = k.shape[0]
    for t, nm, n in ((k, "k", len(stat.ws)),
                     (alphal, "alphal", stat.nl_constraints),
                     (alphaq, "alphaq", 3 * p.nq)):
        check_elts(t, nm, F.elt_shape)
        if t.dim() != 3 or tuple(t.shape[:2]) != (B, n):
            raise ValueError("%s must be [%d, N] a lane, got %s"
                             % (nm, n, tuple(t.shape)))
    name = route("ligero_inner_product", F, k, alphal, alphaq, tabs.ptr,
                 tabs.ent)
    if name is None:
        out = inner_product_plain(F, tabs.ptr, tabs.ent, k, alphal, alphaq,
                                  p.nwqrow, p.r, p.w)
    else:
        out = torch.empty((B, p.nwqrow, p.block) + F.elt_shape,
                          dtype=torch.int32, device=k.device)
        kernels.launch(name, 1, tabs.ptr.data_ptr(), tabs.ent.data_ptr(),
                       k.data_ptr(), alphal.data_ptr(), alphaq.data_ptr(),
                       out.data_ptr(), p.nwqrow, p.block, p.r, p.w, B,
                       len(stat.ws), stat.nl_constraints, 3 * p.nq)
    return out if lanes else out[0]


# ----------------------------------------------------------------------
# the Ligero finish
# ----------------------------------------------------------------------

def ligero_finish_dev(F, lp, tabs: FusedTables, fs: torch.Tensor,
                      k: torch.Tensor) -> dict:
    """The Ligero prover's responses and openings on the card for the
    lanes of fs [B, 104] (the JAX package's zk/fused.py:198 and its batch
    prover's jax.vmap of the responses and the gather, zk/batch.py:344,
    :375; reference ligero_prover.h:84-146), fs updated in place: the
    HASH_OF_A write; u_ldt, alphal, alphaq and u_quad from one stream (no
    write between them, ligero_transcript.h); A (K12); the three
    responses (lp._responses over its tableaus [B, nrow, block_enc, N]);
    the four response writes; the column choice from a fresh squeeze, one
    a lane; the column gather.  Returns device tensors with a leading
    lane axis: y_ldt [B, block, N], y_dot and y_quad [B, dblock, N], okq
    (the W part of y_quad is zero, bool [B]), idx int32 [B, nreq], cols
    [B, nrow, nreq, N]."""
    p = tabs.stat.p
    B = fs.shape[0]
    dfs.fs_absorb(F, fs, tabs.hash_of_a)
    prf = dfs.new_prf(fs.device, B)
    sizes = [p.nwqrow, tabs.stat.nl_constraints, 3 * p.nq, p.nqtriples]
    u_ldt, alphal, alphaq, u_quad = torch.split(
        dfs.dev_sample_elts(F, prf, sum(sizes), fs=fs), sizes, dim=1)
    A = ligero_inner_product(F, tabs, k, alphal, alphaq)
    y_ldt, y_dot, y_quad = lp._responses(u_ldt, A, u_quad)
    okq = (y_quad[:, p.r : p.r + p.w] == 0).flatten(1).all(1)
    for y in (y_ldt, y_dot, y_quad[:, : p.r], y_quad[:, p.block : p.dblock]):
        dfs.fs_write_elts(F, fs, y)
    idx = dfs.dev_choose(F, fs, prf, p.block_enc - p.dblock, p.nreq)
    T = lp.tableau
    at = (idx.to(torch.int64) + p.dblock)[:, None, :, None].expand(
        B, p.nrow, p.nreq, T.shape[-1])
    return dict(y_ldt=y_ldt, y_dot=y_dot, y_quad=y_quad, okq=okq, idx=idx,
                cols=torch.gather(T, 2, at))
