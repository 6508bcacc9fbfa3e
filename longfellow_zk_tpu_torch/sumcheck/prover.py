"""Layered sumcheck prover (GKR wire rounds), every round on the card,
its Fiat-Shamir transcript too.

Port of the JAX package's sumcheck/prover_device.py (semantic twin of the
reference ProverLayers, lib/sumcheck/prover_layers.h:37-497): its
`prove_with_witness` (:1050) and `_prove_core` / `_layer_fn` /
`_wire_scan` (:564-765).  The host transcript's state moves onto the card
once (random_oracle/device_fs.fs_init_from_host) and comes back once, in
the one fetch after the last layer (fs_state_to_host), as the JAX
package's does (:1062, :1138).  Between the two nothing waits for the
card: no round reads a value back.  `prove_with_witness` is that whole
flow, the sumcheck alone as the JAX package's (the comparison tests hold
it to that); the ZK prover (zk/prover.py) does not call it but takes its
steps apart: `evaluate` (the one read-back), `prepare` (the uploads),
`_rounds` (the device step, which leaves every layer's outputs and the
transcript on the card for the constraint build), `words` and
`_assemble` after its own fetch.

  - circuit evaluation, V[g] = sum v * W[h1] * W[h0] with the beta-mask
    zero check: K2 (fp_eval_layer); its ok flag is the one read before
    the rounds;
  - begin_circuit (2 x 40 challenges) and each layer's alpha and beta:
    K9 (device_fs.dev_sample_elts; layer 0 continues begin_circuit's
    PRF stream);
  - the layer prologue: the EQ tables from the challenge tensors (K1),
    then hv = (beta-flagged ? beta : v) * dot[g] in the order of the wire
    rounds (the merge plan's permutation applied to g, v and the flags
    once, at upload: _wm_for): K23 (F.layer_hv);
  - the copy rounds of a circuit with nc > 1 copies, logc = lg(nc)
    cubic rounds a layer before its wire rounds (prover_layers.h:415-496;
    the JAX package's _copy_scan, :519): K16 (fp_copy_round_sums) sums
    the round over terms and copy pairs, K10's cubic mode
    (device_fs.round_tail_cubic) takes the rest of the round, and K1
    binds the copy EQ array and the layer's inputs W [nw, C] along the
    copies (arrays/dense.bind); the bound EQ[0] weighs the wire rounds
    and the closing check.  The copy challenges of a layer bind the next
    layer's copy EQ (layer 0's are begin_circuit's q);
  - per hand-round, with the hand's indices h and the other's ho as
    uploaded and the round's shift an argument (h_t = h[t] >> s: the
    hands' indices move right one bit a round, so the second hand of a
    round reads ho one round further on), z_t = hv_t * W_o[ho_t],
        a0 = sum_{t: h_t even} z_t * W_h[h_t]
        a2 = sum_t (-1)^(h_t+1) * z_t * (W_h[h_t|1] - W_h[h_t & ~1])
    in K3 (fp_wire_sums, one launch); then K10 (device_fs.round_tail):
    the round polynomial, the pad, its absorb, the challenge r and the
    new claim, into the layer's row tensor; then the bind of W_h and the
    hv update by one K1 launch (F.bind_hv; two at GF(2^128)), reading r
    from that row;
  - wire-round term merging (terms with equal (h0, h1) summed into one,
    a host schedule from _wire_merge_plan): K2 (contiguous folds);
  - bound_quad, the sum of the fully bound hv: K3; the closing check
    claim = eq0 * bound_quad * wc0 * wc1 as a device flag; the wc write:
    K9.

The W arrays start at their padded power-of-two length, as in the JAX
package, and each bind keeps only the bound half (the JAX package keeps
the fixed shape, zero-filled, for its scan); the copies too are padded
to C = 2^logc with zeros.

Every step carries a leading lane axis B (the proofs of a batch of
witnesses of one circuit, zk/batch.py; the JAX package's jax.vmap of
these programs, zk/batch.py:301): W, hv, the pads, the claims, the rows
and the transcripts are [B, ...], the circuit's tables are shared, and a
hand-round of B proofs takes the launches of one.  A single proof is
B = 1.  Copies ride the same leading axis through the evaluation (the
inputs of copy c are its lane c, [nc, nw, N]); lanes and copies are
never both above 1 (the batch prover is ZK-only, and ZK refuses copies),
so the rounds of a circuit with copies take one transcript.

With a mesh (parallel/mesh.py; the JAX package's mesh= of
zk/prover.py:117-126, tests/test_mesh_prover.py
test_sumcheck_copy_axis_sharded_proof) the copies of a circuit whose nc
and C = 2^logc the mesh's cols axis (D ranks) divides are sharded: the
rank of cols index k holds copies [k C / D, (k + 1) C / D) of the padded
C, evaluates those (the ranks' satisfaction flags are all-reduced before
any rank returns), and runs the copy rounds on its block while it holds
two copies or more: K16 on its block and the D partials summed
(parallel/sumcheck_sharded.sharded_copy_round_coeffs), K10's cubic tail
on every rank (whose transcripts stay equal), the binds on its block.
With one copy a rank left, the D copies' EQ and W are all-gathered and
the last log2 D copy rounds and the wire rounds run on every rank, as
without a mesh.  Any other circuit runs replicated: every rank proves it
whole.  Every rank ends with the same proof and transcript state.

Proof bytes equal the JAX package's (tests/test_torch_sumcheck.py).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..arrays import dense
from ..fields.fp import (fp_copy_round_sums, fp_eval_layer, fp_wire_sums,
                         round_consts)
from ..parallel.mesh import mesh_device
from ..parallel.sumcheck_sharded import sharded_copy_round_coeffs
from ..random_oracle import device_fs as dfs
from .circuit import KMAX_BINDINGS, Circuit, LayerProof, Proof, ProofAux


def _eq_dev(F, logn: int, n: int, q: torch.Tensor,
            one: torch.Tensor) -> torch.Tensor:
    """EQ[Q, i] for 0 <= i < n as a tensor [n, N], from the challenges
    q [>= logn, N] on the card, by logn interleave steps
    (eqs.h:104-134); one is the field's 1 [N].  With a lane axis, q [B,
    >= logn, N] (one proof of a batch a lane) gives [B, n, N]."""
    lead, N = tuple(q.shape[:-2]), one.shape[-1]
    eq = one.expand(lead + (1, N))
    if logn == 0:
        return eq[..., :n, :]
    sizes = [n]
    for _ in range(logn):
        sizes.append((sizes[-1] + 1) // 2)
    for l in range(logn - 1, -1, -1):
        hi = F.mul(eq, q[..., l : l + 1, :])
        lo = F.sub(eq, hi)
        eq = torch.stack([lo, hi], dim=-2).reshape(lead + (-1, N))
        eq = eq[..., : sizes[l], :]
    return eq


def _raw_eq2_dev(F, logn: int, n: int, g0: torch.Tensor, g1: torch.Tensor,
                 alpha: torch.Tensor, one: torch.Tensor) -> torch.Tensor:
    """EQ(G0, i) + alpha * EQ(G1, i) (eqs.h:46-53); with lanes, g0 and g1
    [B, >= logn, N] and alpha [B, N]."""
    e0 = _eq_dev(F, logn, n, g0, one)
    e1 = _eq_dev(F, logn, n, g1, one)
    return F.add(e0, F.mul(e1, alpha.unsqueeze(-2)))


def _wire_merge_plan(h0: np.ndarray, h1: np.ndarray, logw: int):
    """Host-side static schedule for wire-round term merging.

    Terms with equal (h0, h1) behave identically for the rest of the
    layer (their hv updates and a0/a2 contributions depend only on the
    index bits), so they can be summed into one.  As rounds shift the
    indices right, more pairs collide.  Sorting once by the MSB-first
    Morton interleave of (h0, h1) makes every merge a CONTIGUOUS segment
    fold.

    Returns (perm, stages): perm int32[T]; stages = list of
    (nrounds, starts, ends, h0_rep, h1_rep) with nrounds summing to
    logw; stage s folds stage (s-1)'s arrays."""
    T = len(h0)
    key = np.zeros(T, np.int64)
    for b in range(logw):
        key |= ((h0.astype(np.int64) >> b) & 1) << (2 * b + 1)
        key |= ((h1.astype(np.int64) >> b) & 1) << (2 * b)
    perm = np.argsort(key, kind="stable").astype(np.int32)
    skey = key[perm]
    sh0, sh1 = h0[perm].astype(np.int32), h1[perm].astype(np.int32)

    # unique counts per shift
    uniq = [len(np.unique(skey >> np.int64(2 * k)))
            for k in range(logw + 1)]

    # Stage policy (the JAX package's, kept so both run the same
    # schedule): the initial dedup, plus one re-merge only when the pair
    # count drops hard AND stays big enough to matter.
    shifts = [0]
    k2 = next((k for k in range(1, logw - 1)
               if uniq[k] * 6 <= uniq[0]), None)
    if k2 is not None and uniq[0] >= 262_144:
        shifts.append(k2)

    stages = []
    prev_key = skey
    prev_h0, prev_h1 = sh0, sh1
    prev_n = T
    for si, k in enumerate(shifts):
        rel = k - (shifts[si - 1] if si else 0)
        gk = prev_key >> np.int64(2 * rel)
        _, starts = np.unique(gk, return_index=True)
        starts = np.sort(starts).astype(np.int32)
        ends = np.append(starts[1:], prev_n).astype(np.int32)
        h0_rep = (prev_h0[starts] >> rel).astype(np.int32)
        h1_rep = (prev_h1[starts] >> rel).astype(np.int32)
        nrounds = (shifts[si + 1] if si + 1 < len(shifts) else logw) - k
        stages.append((nrounds, starts, ends, h0_rep, h1_rep))
        prev_key, prev_h0, prev_h1 = gk[starts], h0_rep, h1_rep
        prev_n = len(starts)
    assert sum(s[0] for s in stages) == logw
    return perm, stages


def quad_tensors(F, quad, device) -> dict:
    """The tensors of a layer's quad on `device`, uploaded once per device
    (cached on the quad) and shared by the prover and the verifier: the
    terms in g order, g (int64), h0 and h1 (int32), v [T, N] with zeros
    stored as 1, and bmask (bool) marking the terms whose coefficient is
    the layer's beta; and their host copies g_np, h0_np, h1_np."""
    cache = quad.__dict__.setdefault("_torch_cache", {})
    key = ("quad", str(device))
    if key not in cache:
        g = np.asarray(quad.g, dtype=np.int64)
        h0 = np.asarray(quad.h0, dtype=np.int64)
        h1 = np.asarray(quad.h1, dtype=np.int64)
        bmask = np.asarray(quad.beta_mask())
        if quad.kidx is not None:
            tbl = F.to_limbs([1 if x == 0 else x for x in quad.ktable],
                             device)
            kidx = np.asarray(quad.kidx, dtype=np.int64)
        else:
            tbl = F.to_limbs([1 if x == 0 else x for x in quad.v], device)
            kidx = np.arange(len(g), dtype=np.int64)
        order = np.argsort(g, kind="stable")
        g, h0, h1, bmask, kidx = (g[order], h0[order], h1[order],
                                  bmask[order], kidx[order])
        cache[key] = dict(
            g=torch.as_tensor(g, device=device),
            h0=torch.as_tensor(h0.astype(np.int32), device=device),
            h1=torch.as_tensor(h1.astype(np.int32), device=device),
            v=tbl[torch.as_tensor(kidx, device=device)].contiguous(),
            bmask=torch.as_tensor(bmask, device=device),
            g_np=g, h0_np=h0, h1_np=h1)
    return cache[key]


class SumcheckProver:
    """Sumcheck prover; tensors on `device`.  Its steps carry a leading
    lane axis B: the proofs of a batch of witnesses of one circuit, each
    with its own transcript, pad and challenges, in the launches of one
    proof (the circuit's tables are shared); a single proof is the lane
    axis of length 1.  A circuit with nc > 1 copies is proved one proof
    at a time, its copies on the lane axis of the evaluation; with a
    mesh, sharded over its cols axis where the axis divides nc and C
    (see the module's docstring)."""

    # terms below this count aren't worth the merge prologue
    K_MERGE_MIN_TERMS = 4096

    def __init__(self, F, device=None, mesh=None):
        self.F = F
        self.mesh = mesh
        self.device = mesh_device(mesh, device)

    def copy_shard(self, circ: Circuit):
        """(lo, width): this rank's block [lo, lo + width) of the C padded
        copies when the copies are sharded (a mesh whose cols axis divides
        nc and C), else None."""
        if self.mesh is None or circ.logc == 0:
            return None
        D, C = self.mesh.size("cols"), 1 << circ.logc
        if circ.nc % D or C % D:
            return None
        width = C // D
        return self.mesh.index("cols") * width, width

    def _segments(self, quad, nv: int):
        """(starts, ends) int32 [nv]: output wire g's terms in g order."""
        cache = quad.__dict__.setdefault("_torch_cache", {})
        key = ("seg", str(self.device), nv)
        if key not in cache:
            g = quad_tensors(self.F, quad, self.device)["g_np"]
            wires = np.arange(nv)
            cache[key] = tuple(
                torch.as_tensor(np.searchsorted(g, wires, side=side)
                                .astype(np.int32), device=self.device)
                for side in ("left", "right"))
        return cache[key]

    def _lane_terms(self, quad, nv: int, nin: int, B: int):
        """K2 mode 1's arrays of a layer for B lanes flattened into one
        evaluation (h0, h1, v, bmask, starts, ends): lane b's inputs at b
        nin, its terms at b T, its outputs' segments after lane b - 1's;
        the layer's own arrays for one lane.  Made on the card from the
        uploaded ones and kept with the quad."""
        qd = quad_tensors(self.F, quad, self.device)
        starts, ends = self._segments(quad, nv)
        if B == 1:
            return qd["h0"], qd["h1"], qd["v"], qd["bmask"], starts, ends
        cache = quad.__dict__.setdefault("_torch_cache", {})
        key = ("lanes", str(self.device), nv, nin, B)
        if key not in cache:
            T = qd["h0"].shape[0]
            lane = torch.arange(B, dtype=torch.int32, device=self.device)

            def off(x, step):
                return (x[None] + lane[:, None] * step).reshape(-1)

            cache[key] = (off(qd["h0"], nin), off(qd["h1"], nin),
                          qd["v"].repeat(B, 1), qd["bmask"].repeat(B),
                          off(starts, T), off(ends, T))
        return cache[key]

    def _wm_for(self, quad, logw: int):
        """Device arrays of the term-merge plan, or None below the
        K_MERGE_MIN_TERMS threshold: its stages, each stage's longest
        fold, and "terms", the layer's terms in the plan's order (g as
        int32, v, bmask, h0 and h1 of quad_tensors, permuted once here by
        the host permutation, which is not kept on the card)."""
        cache = quad.__dict__.setdefault("_torch_cache", {})
        key = ("wm", str(self.device), logw, self.K_MERGE_MIN_TERMS)
        if key not in cache:
            qd = quad_tensors(self.F, quad, self.device)
            if len(qd["h0_np"]) < self.K_MERGE_MIN_TERMS:
                cache[key] = None
            else:
                perm, stages = _wire_merge_plan(qd["h0_np"], qd["h1_np"],
                                                logw)
                dev = self.device

                def t(a):
                    return torch.as_tensor(a, device=dev)

                pd = t(perm.astype(np.int64))
                terms = {k: qd[k][pd].contiguous() for k in ("v", "bmask")}
                for k in ("g", "h0", "h1"):
                    terms[k] = t(qd[k + "_np"][perm].astype(np.int32))
                # each stage's longest fold (K2 takes its scan past a
                # warp's reach: the first stages hold segments of 10^5
                # terms)
                cache[key] = dict(
                    terms=terms,
                    stages=[(nr, t(s), t(e), t(h0r), t(h1r))
                            for nr, s, e, h0r, h1r in stages],
                    longest=[int((e - s).max()) for _, s, e, _, _ in stages])
        return cache[key]

    def _hv_terms(self, quad, logw: int) -> dict:
        """The terms of a layer in the order its rounds take them, for
        K23's prologue and the copy rounds: g (int32), v, bmask, h0 and
        h1, the merge plan's "terms" where there is a plan, else the
        quad's g-ordered arrays (g as int32, kept with the quad; the
        verifier reads the g-ordered ones of quad_tensors)."""
        plan = self._wm_for(quad, logw)
        if plan is not None:
            return plan["terms"]
        cache = quad.__dict__.setdefault("_torch_cache", {})
        key = ("g32", str(self.device))
        qd = quad_tensors(self.F, quad, self.device)
        if key not in cache:
            cache[key] = qd["g"].to(torch.int32)
        return dict(g=cache[key], v=qd["v"], bmask=qd["bmask"], h0=qd["h0"],
                    h1=qd["h1"])

    # ------------------------------------------------------------------
    # circuit evaluation
    # ------------------------------------------------------------------

    def _eval(self, circ: Circuit, W0: torch.Tensor, lanes: int = 1):
        """(inputs per layer [B, nw, N], final V [B, nv, N], ok) for the
        lanes' inputs W0 [B, ninputs, N] (lanes = B: K2 takes one lane's
        route, so that a batch launches what one proof launches) or the
        copies' [nc, ninputs, N] (lanes = 1: the route of the whole
        table), one K2 call a layer for all of them; ok is a 0-dim bool
        tensor, false if an assert-zero term of any lane fails."""
        F = self.F
        B = W0.shape[0]
        nl = circ.nl
        inputs: List = [None] * nl
        inputs[nl - 1] = W0
        W = W0
        oks = []
        for l in range(nl - 1, -1, -1):
            nv = circ.layers[l - 1].nw if l > 0 else circ.nv
            terms = self._lane_terms(circ.layers[l].quad, nv, W.shape[1], B)
            V, ok = fp_eval_layer(F, W.reshape((-1,) + F.elt_shape), *terms,
                                  lanes=lanes)
            W = V.reshape((B, nv) + F.elt_shape)
            oks.append(ok)
            if l > 0:
                inputs[l - 1] = W
        return inputs, W, torch.stack(oks).all()

    def eval_circuit(self, circ: Circuit, W0: torch.Tensor):
        """W0: [ninputs, N], or [nc, ninputs, N] for a circuit with copies.
        Returns (inputs per layer, final V), each with W0's copy axis, or
        (None, None) if an assert-zero term of any copy fails."""
        one = W0.dim() == 1 + len(self.F.elt_shape)
        inputs, V, ok = self._eval(circ, W0[None] if one else W0)
        if not bool(ok.item()):
            return None, None
        if one:
            return [x[0] for x in inputs], V[0]
        return inputs, V

    def evaluate(self, circ: Circuit, W0: torch.Tensor):
        """(the circuit's inputs per layer, flags): W0 [B, ninputs, N],
        flags a bool [B] on the card, whether each lane's witness
        satisfies the circuit (every output zero, no assert-zero term
        failing; the latter is one flag for all lanes, so a failing one
        clears every lane's: the caller finds the lane by evaluating it
        alone).  Reading flags back is the one wait before the rounds."""
        inputs, V, ok = self._eval(circ, W0, W0.shape[0])
        return inputs, (V == 0).flatten(1).all(1) & ok

    # ------------------------------------------------------------------
    # proving
    # ------------------------------------------------------------------

    def prepare(self, circ: Circuit, pads: List[Optional[Proof]]):
        """Every upload the rounds need, made before them (the merge
        plans and the terms in their order, the lanes' pads, the
        constants; the quads went up with the evaluation): (pads, consts)
        for _rounds."""
        F, dev = self.F, self.device
        for layer in circ.layers:
            self._hv_terms(layer.quad, layer.logw)
        return self._pads_dev(circ, pads), dict(one=F.to_limbs(1, dev),
                                                rc=round_consts(F, dev))

    def prove_with_witness(self, circ: Circuit, W0: torch.Tensor, ts,
                           pad: Optional[Proof] = None):
        """Circuit evaluation + sumcheck (prover_layers.h:114-166) with
        the transcript on the card, one proof: W0 [ninputs, N], or [nc,
        ninputs, N] (copy c's inputs in row c) for a circuit with nc
        copies; ts a TranscriptSumcheck, its host transcript ends where
        the host prover's would.  Returns (proof, aux, bindings) with
        bindings = dict(q=[the last layer's copy challenges], g=[g0, g1],
        logv=...), or (None, None, None) if the witness of some copy does
        not satisfy the circuit (then the transcript is left
        untouched)."""
        if W0.dim() == 1 + len(self.F.elt_shape):
            W0 = W0[None]
        if W0.shape[0] != circ.nc:
            raise ValueError("W0 holds %d copies, the circuit %d"
                             % (W0.shape[0], circ.nc))
        shard = self.copy_shard(circ)
        if shard is not None:
            # this rank's copies only (none where its block is padding)
            lo, width = shard
            W0 = W0[lo : min(lo + width, circ.nc)]
        if W0.shape[0]:
            inputs, flags = self.evaluate(circ, W0)
            ok = flags.all()
        else:
            inputs, ok = [None] * circ.nl, True
        if not (bool(ok) if self.mesh is None else self.mesh.all_true(ok)):
            return None, None, None
        pads, consts = self.prepare(circ, [pad])
        fs = dfs.fs_init_from_host(ts.ts, self.device)[None]
        outs, _ = self._rounds(circ, inputs, fs, pads, consts)
        # the one fetch: every layer's rows, wc, bound quad and flag, and
        # the transcript's state
        host = torch.cat(self.words(outs) + [fs.view(torch.int32)], dim=1) \
            .cpu().numpy()
        return self._assemble(circ, pad, host[0], ts.ts)

    @staticmethod
    def words(outs: List[dict]) -> List[torch.Tensor]:
        """The layers' outputs as the flat int32 words _assemble reads, a
        row [B, ...] a lane: per layer its copy rows (none without
        copies), its rows, wc, bound quad and closing flag."""
        parts = []
        for o in outs:
            B = o["wc"].shape[0]
            parts += [o["cp"].reshape(B, -1), o["rows"].reshape(B, -1),
                      o["wc"].reshape(B, -1), o["bq"].reshape(B, -1),
                      o["ok"].to(torch.int32)[:, None]]
        return parts

    def _pads_dev(self, circ: Circuit, pads: List[Optional[Proof]]):
        """Each layer's pads of the lanes on the card, uploaded at once (the
        JAX package's _pads_dev, :1150): (cp [B, logc, 4, N], hp [B, logw,
        2, 3, N], wc [B, 2, N]); zeros for a lane without a pad."""
        F, dev = self.F, self.device
        B, logc = len(pads), circ.logc
        zero = F.of_scalar(0)
        vals, out = [], []
        for ly, layer in enumerate(circ.layers):
            for pad in pads:
                if pad is None:
                    vals += [zero] * (logc * 4 + layer.logw * 6)
                    continue
                for rnd in range(logc):
                    vals += list(pad.layers[ly].cp[rnd])
                for rnd in range(layer.logw):
                    for hand in range(2):
                        vals += list(pad.layers[ly].hp[hand][rnd])
            for pad in pads:
                vals += [zero] * 2 if pad is None else list(pad.layers[ly].wc)
        flat = F.to_limbs(vals, dev)
        off = 0
        for layer in circ.layers:
            n = logc * 4 + layer.logw * 6
            lane = flat[off : off + B * n].reshape((B, n) + F.elt_shape)
            off += B * n
            out.append((lane[:, : logc * 4].reshape(
                (B, logc, 4) + F.elt_shape),
                lane[:, logc * 4 :].reshape(
                    (B, layer.logw, 2, 3) + F.elt_shape),
                flat[off : off + 2 * B].reshape((B, 2) + F.elt_shape)))
            off += 2 * B
        return out

    def _rounds(self, circ: Circuit, inputs: List, fs: torch.Tensor, pads,
                consts):
        """The sumcheck from begin_circuit to the last layer's wc write,
        every step on the card, nothing read back, for the lanes of fs [B,
        104] (updated in place); a circuit with copies takes one lane, its
        inputs [nc, nw, N] a layer.  Returns (each layer's outputs, as
        device tensors; the rows of all layers' hand-rounds, [B, sum logw,
        2, 4, N], of which each layer's "rows" is a view)."""
        F, dev = self.F, self.device
        B = fs.shape[0]
        if circ.logc > 0 and B > 1:
            raise ValueError("a circuit with copies is proved one proof at "
                             "a time (lanes %d)" % B)
        prf = dfs.new_prf(dev, B)
        # begin_circuit: q (the copies' bindings), then g, from one stream
        qg = dfs.dev_sample_elts(F, prf, 2 * KMAX_BINDINGS, fs=fs)
        bnd_q, g_full = qg[:, :KMAX_BINDINGS], qg[:, KMAX_BINDINGS:]
        bnd_g = [g_full, g_full]
        WC = F.zeros((B, 2), dev)
        logv = circ.logv
        rows = torch.empty((B, sum(layer.logw for layer in circ.layers), 2, 4)
                           + F.elt_shape, dtype=torch.int32, device=dev)
        cps = torch.empty((B, circ.nl, circ.logc, 5) + F.elt_shape,
                          dtype=torch.int32, device=dev)
        outs, off = [], 0
        for ly, layer in enumerate(circ.layers):
            o = self._layer(fs, prf, ly > 0, circ, layer, logv, bnd_q, bnd_g,
                            inputs[ly], WC, pads[ly], consts, cps[:, ly],
                            rows[:, off : off + layer.logw])
            outs.append(o)
            bnd_q, bnd_g, WC = o["q"], o["g"], o["wc"]
            logv = layer.logw
            off += layer.logw
        return outs, rows

    def _layer(self, fs, prf, fresh: bool, circ: Circuit, layer, logv: int,
               bnd_q, bnd_g, W, WC, pad, consts, cp, rows) -> dict:
        """One layer (prover_layers.h:185-271; the JAX package's
        _layer_fn, and the jax.vmap of its batch prover over it,
        zk/batch.py:301), every lane at once: alpha and beta (a fresh
        squeeze unless this is layer 0, which continues begin_circuit's
        stream), the prologue, logc copy rounds (one lane; W [nc, nw, N]
        the copies' inputs), logw wire rounds of two hands each, the
        closing check and wc write.  cp [B, logc, 5, N] receives copy row
        [b, rnd] = [ev0, ev1, ev2, ev3, r] and rows [B, logw, 2, 4, N] row
        [b, rnd, hand] = [ev0, ev1, ev2, r] (the evaluations minus the
        pad)."""
        F, dev = self.F, self.device
        B = fs.shape[0]
        one, rc = consts["one"], consts["rc"]
        cp_pad, hp_pad, wc_pad = pad
        ab = dfs.dev_sample_elts(F, prf, 2, fs=fs if fresh else None)
        alpha, beta = ab[:, 0], ab[:, 1]
        claim = F.add(WC[:, 0], F.mul(alpha, WC[:, 1]))
        ht = self._hv_terms(layer.quad, layer.logw)
        dot = _raw_eq2_dev(F, logv, 1 << logv, bnd_g[0], bnd_g[1], alpha,
                           one)
        hv = F.layer_hv(dot, ht["g"], ht["v"], ht["bmask"], beta)
        # the copy rounds (prover_layers.h:415-496): EQ [1, C] over the
        # copies and the inputs W [nw, C] (copies inner, both zero past
        # nc), bound to each round's challenge; one copy: eq0 = 1
        eq0 = one
        if circ.logc > 0:
            C = 1 << circ.logc
            EQ = F.zeros((1, C), dev)
            EQ[:, : circ.nc] = _eq_dev(F, circ.logc, circ.nc, bnd_q, one)
            shard = self.copy_shard(circ)
            if shard is None:
                Wc = F.zeros((W.shape[1], C), dev)
                Wc[:, : circ.nc] = W.transpose(0, 1)
            else:
                # this rank's block of the copies (W: its real ones)
                lo, width = shard
                EQ = EQ[:, lo : lo + width].contiguous()
                Wc = F.zeros((layer.nw, width), dev)
                if W is not None:
                    Wc[:, : W.shape[0]] = W.transpose(0, 1)
            for rnd in range(circ.logc):
                if shard is not None and EQ.shape[1] == 1:
                    EQ, Wc = self._gather_copies(EQ, Wc)
                    shard = None
                if shard is None:
                    c = fp_copy_round_sums(F, EQ[0], Wc, ht["h0"], ht["h1"],
                                           hv[0])
                else:
                    c = sharded_copy_round_coeffs(F, self.mesh, EQ[0], Wc,
                                                  hv[0], ht["h0"], ht["h1"],
                                                  axis="cols")
                row = cp[:, rnd]
                dfs.round_tail_cubic(F, fs, claim, row, c[None],
                                     cp_pad[:, rnd], rc)
                EQ = dense.bind(F, EQ, row[:, 4])
                Wc = dense.bind(F, Wc, row[:, 4])
            if shard is not None:
                EQ, Wc = self._gather_copies(EQ, Wc)
            eq0 = EQ[0, 0]
            W = Wc.reshape((1, -1) + F.elt_shape)

        N = 1 << layer.logw
        Wh = torch.cat([W, F.zeros((B, N - W.shape[1]), dev)], dim=1)
        WH = [Wh, Wh]
        plan = self._wm_for(layer.quad, layer.logw)
        if plan is None:
            stages = [(layer.logw, None, None, ht["h0"], ht["h1"])]
            longest = [None]
        else:
            stages, longest = plan["stages"], plan["longest"]

        rnd = 0
        lane = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
        for (nr, starts, ends, h0, h1), most in zip(stages, longest):
            if starts is not None:
                # the lanes' segments, one after another
                T = hv.shape[1]
                hv = F.lazy_segment_sum(
                    hv.reshape((-1,) + F.elt_shape),
                    (starts[None] + lane * T).reshape(-1),
                    (ends[None] + lane * T).reshape(-1), most).reshape(
                        (B, -1) + F.elt_shape)
            h = (h0, h1)
            for sh in range(nr):
                for hand in range(2):
                    # the stage's indices as uploaded, shifted in the
                    # kernels: this hand's by the rounds of the stage so
                    # far, the other's one further on the second hand
                    a = fp_wire_sums(F, hv, WH[hand], WH[1 - hand], h[hand],
                                     h[1 - hand], sh, sh + hand)
                    row = rows[:, rnd, hand]
                    dfs.round_tail(F, fs, claim, row, a, eq0,
                                   hp_pad[:, rnd, hand], rc)
                    r_t = row[:, 3]
                    # the bound half: the hands' indices move right each
                    # round, so the zero tail is never read
                    WH[hand], hv = F.bind_hv(WH[hand], hv, h[hand], r_t, sh)
                rnd += 1

        bq = F.lazy_sum(hv, 1)
        wc = torch.stack([WH[0][:, 0], WH[1][:, 0]], dim=1)
        expected = F.mul(eq0, F.mul(bq, F.mul(wc[:, 0], wc[:, 1])))
        dfs.fs_write_elts(F, fs, F.sub(wc, wc_pad))
        return dict(cp=cp, rows=rows, wc=wc, bq=bq,
                    ok=(claim == expected).flatten(1).all(1),
                    q=cp[:, :, 4], g=[rows[:, :, 0, 3], rows[:, :, 1, 3]],
                    alpha=alpha)

    def _gather_copies(self, EQ: torch.Tensor, Wc: torch.Tensor):
        """EQ [1, 1, N] and Wc [nw, 1, N], this rank's one copy left of
        the sharded copy rounds, joined with the other ranks' of the cols
        axis: [1, D, N] and [nw, D, N] on every rank."""
        return (self.mesh.all_gather(EQ, "cols", dim=1),
                self.mesh.all_gather(Wc, "cols", dim=1))

    def _assemble(self, circ: Circuit, pad: Optional[Proof],
                  host: np.ndarray, host_ts):
        """The Proof, aux and bindings of one lane from its fetched words
        (the JAX package's _assemble, :1099); the host transcript takes
        the device state."""
        F = self.F
        N = F.nlimb
        logc = circ.logc
        proof = Proof()
        aux = ProofAux()
        off = 0
        for ly, layer in enumerate(circ.layers):
            n = (logc * 5 + layer.logw * 2 * 4 + 3) * N
            vals = F.from_limbs(torch.from_numpy(
                host[off : off + n].reshape(-1, N)))
            ok = host[off + n]
            off += n + 1
            assert ok, "sum != eq0*quad*wl*wr"
            cps = vals[: logc * 5].reshape(logc, 5)
            rows = vals[logc * 5 : -3].reshape(layer.logw, 2, 4)
            wc0, wc1, bq = vals[-3:]
            lp = LayerProof(cp=[list(cps[rnd, :4]) for rnd in range(logc)],
                            hp=[[], []], wc=[wc0, wc1])
            for rnd in range(layer.logw):
                for hand in range(2):
                    lp.hp[hand].append(list(rows[rnd, hand, :3]))
            if pad is not None:
                lp.wc = [F.sub_i(wc0, pad.layers[ly].wc[0]),
                         F.sub_i(wc1, pad.layers[ly].wc[1])]
            lp._bound_quad = bq
            proof.layers.append(lp)
            aux.bound_quad.append(bq)
        dfs.fs_state_to_host(host_ts, host[off:].astype("<i4").view(np.uint8))
        last = circ.layers[-1]
        g = [list(rows[:, hand, 3]) for hand in range(2)]
        return proof, aux, dict(q=list(cps[:, 4]), g=g, logv=last.logw)
