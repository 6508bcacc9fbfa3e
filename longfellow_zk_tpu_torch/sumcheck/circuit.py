"""Layered sumcheck circuit representation.

Semantic twin of reference lib/sumcheck/circuit.h:29-147, with the quad
stored as flat index arrays (structure-of-arrays) instead of the
reference's delta-encoded iterator: the indices are static host numpy
data; the sumcheck prover uploads them, with the constants as field
tensors, once per device (sumcheck/prover.py).

A term (g, h0, h1, v) contributes v * W[h1, c] * W[h0, c] to output wire
g of each copy c; v == 0 marks an assert-zero term whose coefficient is
the per-layer beta challenge at proving time (quad.h:213-220).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

KMAX_LAYERS = 10000
KMAX_COPIES = 1 << 24
KMAX_OUTPUTS = 1 << 24
KMAX_BINDINGS = 40  # max 2^40 gates/wires/copies per layer (circuit.h:78)


class Quad:
    """Sparse quadratic form; one entry per term.

    Two storage modes (mirroring the reference's quad representations,
    lib/sumcheck/quad.h:31-55): an explicit per-term value list `v`, or
    the memory-graded (kidx, ktable) pair — 32-bit indices into a
    deduplicated constant table, which is how LFC1 stores terms and the
    only viable layout at mdoc scale (millions of terms, dozens of
    distinct constants)."""

    def __init__(self, g, h0, h1, v: Optional[List] = None,
                 kidx: Optional[np.ndarray] = None,
                 ktable: Optional[List] = None):
        self.g = g
        self.h0 = h0
        self.h1 = h1
        self._v = v
        self.kidx = kidx
        self.ktable = ktable
        assert (v is not None) or (kidx is not None and ktable is not None)
        self._beta_mask = None

    @property
    def v(self) -> List:
        if self._v is None:
            tbl = self.ktable
            self._v = [tbl[i] for i in self.kidx]
        return self._v

    @property
    def nterms(self) -> int:
        if self._v is not None:
            return len(self._v)
        return len(self.kidx)

    def beta_mask(self) -> np.ndarray:
        if self._beta_mask is None:
            if self.kidx is not None:
                zero = np.array([x == 0 for x in self.ktable], dtype=bool)
                self._beta_mask = zero[self.kidx]
            else:
                self._beta_mask = np.array([x == 0 for x in self._v],
                                           dtype=bool)
        return self._beta_mask


@dataclass
class Layer:
    nw: int  # number of inputs to this layer
    logw: int
    quad: Quad

    @property
    def nterms(self) -> int:
        return self.quad.nterms


@dataclass
class Circuit:
    nv: int  # outputs of one copy
    logv: int
    nc: int  # copies
    logc: int
    nl: int  # layers
    ninputs: int
    npub_in: int
    subfield_boundary: int
    layers: List[Layer] = field(default_factory=list)
    id: bytes = b"\x00" * 32

    def nterms(self) -> int:
        return sum(layer.nterms for layer in self.layers)


@dataclass
class LayerProof:
    cp: List  # [logc] CPoly: 4 evals each
    hp: List  # [2][logw] WPoly: 3 evals each
    wc: List  # 2 claims


@dataclass
class Proof:
    layers: List[LayerProof] = field(default_factory=list)


@dataclass
class ProofAux:
    """bound_quad per layer, used by the ZK composition (circuit.h:142)."""

    bound_quad: List = field(default_factory=list)


@dataclass
class LayerChallenge:
    alpha: object = None
    beta: object = None
    cb: List = field(default_factory=list)
    hb: List = field(default_factory=list)  # [2][logw]


@dataclass
class Challenge:
    q: List = field(default_factory=list)  # [kMaxBindings]
    g: List = field(default_factory=list)
    layers: List = field(default_factory=list)
