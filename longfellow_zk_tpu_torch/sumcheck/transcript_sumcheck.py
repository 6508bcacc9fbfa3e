"""Sumcheck-specific Fiat-Shamir framing on the host transcript
(reference lib/sumcheck/transcript_sumcheck.h:31-85).

The verifier (sumcheck/verifier.py) and the prover's replay of its
constraints (zk/common.py) run every step here.  The prover's sumcheck
runs the same steps on the card (random_oracle/device_fs: K9 for
begin_circuit, begin_layer and write_elts, K10 for round) and takes only
the host transcript `ts` from this wrapper, which it advances once, at
the end."""

from __future__ import annotations

from typing import List

from .circuit import KMAX_BINDINGS


class TranscriptSumcheck:
    def __init__(self, ts, F):
        self.ts = ts
        self.F = F

    def write_input(self, W_host_cols: List[List]):
        """W as [nc][n1] host scalars: written column by column
        (transcript_sumcheck.h:42-47)."""
        for col in W_host_cols:
            self.ts.write_elts(col, self.F)

    def begin_circuit(self):
        q = self.ts.elts(KMAX_BINDINGS, self.F)
        g = self.ts.elts(KMAX_BINDINGS, self.F)
        return q, g

    def begin_layer(self):
        alpha = self.ts.elt(self.F)
        beta = self.ts.elt(self.F)
        return alpha, beta

    def write_elts(self, es: List):
        self.ts.write_elts(es, self.F)

    def round(self, poly_evals: List):
        """Write poly evals except p(1) (implied), return challenge."""
        for i, e in enumerate(poly_evals):
            if i != 1:
                self.ts.write_elt(e, self.F)
        return self.ts.elt(self.F)
