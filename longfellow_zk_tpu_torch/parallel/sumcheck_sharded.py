"""The copy rounds of the plain sumcheck with the copy axis sharded over
the mesh.

Port of the JAX package's parallel/sumcheck_sharded.py.  Each rank holds
a block of the copies of EQ and W, computes its partial cubic copy-round
coefficients (c0, c2, c3) with K16 (fields/fp.py fp_copy_round_sums,
the reference's evaluations_c, prover_layers.h:415-496), and the
partials of the D ranks are summed as field elements: all-gathered, then
one K3 sum (parallel/mesh.Mesh.sum).  The JAX package psums the byte
columns of its lazy accumulators and renormalises once; both give the
canonical sum, so the two are equal as integers.  An all_reduce of the
limbs would not be: NCCL adds integers, not residues mod p.  Every rank
ends with the same coefficients; the only traffic a round is D partials
of 3 elements.

Tensors are the port's (fields/fp.py): EQ [C, N], W [nw, C, N] (copies
inner), hv [T, N], h0 and h1 int32 [T]; the coefficients [3, N].
"""

from __future__ import annotations

import torch

from ..fields.fp import fp_copy_round_sums
from .mesh import Mesh


def copy_round_coeffs(F, EQ: torch.Tensor, W: torch.Tensor, hv: torch.Tensor,
                      h0: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
    """One card: (c0, c2, c3) [3, N] of a copy round over all C copies
    (K16), the twin of the JAX copy_round_coeffs."""
    return fp_copy_round_sums(F, EQ, W, h0, h1, hv)


def sharded_copy_round_coeffs(F, mesh: Mesh, EQ: torch.Tensor,
                              W: torch.Tensor, hv: torch.Tensor,
                              h0: torch.Tensor, h1: torch.Tensor,
                              axis: str = None) -> torch.Tensor:
    """(c0, c2, c3) [3, N] over the copies of every rank of the mesh's
    `axis` (its first unless named): EQ [C / D, N] and W [nw, C / D, N]
    are this rank's block of the copies (shard_copies), hv, h0 and h1
    the layer's, the same on every rank.  Equal to copy_round_coeffs
    over the whole, on every rank."""
    axis = axis or mesh.axis_names[0]
    D = mesh.size(axis)
    C = EQ.shape[0] * D
    assert C % (2 * D) == 0, "shard must hold whole copy pairs"
    return mesh.sum(F, fp_copy_round_sums(F, EQ, W, h0, h1, hv), axis)
