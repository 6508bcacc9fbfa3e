"""Multilinear array binding along one axis (reference lib/arrays/dense.h
:36-133; the JAX package's arrays/dense.py `bind` and `bind_all`).

Binding a variable folds each pair of neighbours along an axis into
out[i] = x[2i] + r (x[2i+1] - x[2i]), halving its length.  An odd length
counts as zero-padded (dense.h:77-85): the missing last neighbour is
zero.  The fold is K1's bind (fields/fp.py `fp_elementwise`, mode BIND):
the kernel for a CUDA tensor, its plain version for a CPU one.

Arrays are field tensors [..., N] (fields/fp.py, fields/gf2.py); `axis`
counts their element axes, the limb axis excluded (-1: the last element
axis), as the JAX package's counts the axes after its limb axis.  The
plain sumcheck binds its copy EQ array and each layer's inputs [nw, C]
along the copies with it (sumcheck/prover.py).
"""

from __future__ import annotations

import torch


def bind(F, x: torch.Tensor, r: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """x bound along element axis `axis`: out[i] = x[2i] + r (x[2i+1] -
    x[2i]), the axis' length halved (rounded up; an odd length counts as
    zero-padded).  r is one element [N], or one per lane [B, N] with the
    lanes x's leading axis (not the bound one)."""
    nd = x.dim() - len(F.elt_shape)
    axis = axis % nd
    y = x.movedim(axis, nd - 1)
    if y.shape[nd - 1] % 2:
        y = torch.cat([y, F.zeros(y.shape[: nd - 1] + (1,), y.device)],
                      dim=nd - 1)
    return F.bind(y.contiguous(), r).movedim(nd - 1, axis)


def bind_all(F, x: torch.Tensor, rs, axis: int = -1) -> torch.Tensor:
    """x bound along element axis `axis` to each challenge of rs in turn
    (a sequence of [N] elements, or a [k, N] tensor)."""
    for r in rs:
        x = bind(F, x, r, axis)
    return x
