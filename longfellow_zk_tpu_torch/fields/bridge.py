"""Carrying state between the JAX package's layout and this package's.

The JAX package holds a prime-field tensor as uint32[2N, ...]: 2N 16-bit
limbs on the leading axis (two for the ML-DSA prime, four for Fp64,
eight for Fp128, sixteen for P-256).  This package holds it as
int32[..., N]: N 32-bit limbs on the trailing axis.
An Fp2 tensor is planar there, uint32[2, 2N, ...] (re, im leading), and
int32[..., 2, N] here.  Both packages use Montgomery form with
R = 2^(32N), so the conversion moves bits and changes no value.  A
GF(2^128) tensor holds polynomial-basis bits on both sides: uint32[8, ...]
halfwords there, int32[..., 4] words here.  A multi-prime (CRT) tensor
is uint32[2, VS, ...] there (two 16-bit limbs a residue) and
int32[VS, ..., 1] here, both Montgomery with R = 2^32 a lane.  An
Fp24_6 tensor is uint32[6, 2, ...] there (six coefficients of two 16-bit
limbs) and int32[..., 6, 1] here.  The
wires of a circuit over nc copies lie [L, nw, nc] there (copies last)
and [nc, nw, N] here (copies leading, as the lanes of a batch: the
evaluation runs them through the lane path).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..sumcheck.circuit import Circuit, Layer, Quad


def limbs_from_jax(arr: np.ndarray) -> torch.Tensor:
    """uint32[2N, ...] (16-bit limbs, leading) -> int32[..., N] (CPU)."""
    a = np.asarray(arr, dtype=np.uint32)
    assert a.shape[0] in (2, 4, 8, 16), a.shape
    w = (a[0::2] & np.uint32(0xFFFF)) | ((a[1::2] & np.uint32(0xFFFF))
                                         << np.uint32(16))
    w = np.ascontiguousarray(np.moveaxis(w, 0, -1)).view(np.int32)
    return torch.from_numpy(w.copy())


def limbs_to_jax(t: torch.Tensor) -> np.ndarray:
    """int32[..., N] -> uint32[2N, ...] (16-bit limbs, leading)."""
    w = np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint32)
    assert w.shape[-1] in (1, 2, 4, 8), w.shape
    lo = w & np.uint32(0xFFFF)
    hi = w >> np.uint32(16)
    out = np.stack([lo, hi], axis=-1).reshape(w.shape[:-1] +
                                              (2 * w.shape[-1],))
    return np.ascontiguousarray(np.moveaxis(out, -1, 0))


def gf2_from_jax(arr: np.ndarray) -> torch.Tensor:
    """GF(2^128) uint32[8, ...] halfwords -> int32[..., 4] words (CPU)."""
    assert np.shape(arr)[0] == 8, np.shape(arr)
    return limbs_from_jax(arr)


def gf2_to_jax(t: torch.Tensor) -> np.ndarray:
    """GF(2^128) int32[..., 4] words -> uint32[8, ...] halfwords."""
    assert t.shape[-1] == 4, tuple(t.shape)
    return limbs_to_jax(t)


def copies_from_jax(arr: np.ndarray) -> torch.Tensor:
    """A prime-field or GF(2^128) array over copies, uint32[2N, nw, nc]
    (or [8, nw, nc]) -> int32[nc, nw, N] (CPU)."""
    return limbs_from_jax(arr).transpose(0, 1).contiguous()


def copies_to_jax(t: torch.Tensor) -> np.ndarray:
    """int32[nc, nw, N] -> uint32[2N, nw, nc] (copies last)."""
    return limbs_to_jax(t.transpose(0, 1))


def fp2_from_jax(arr: np.ndarray) -> torch.Tensor:
    """Fp2 uint32[2, 2N, ...] (planar re, im) -> int32[..., 2, N] (CPU)."""
    a = np.asarray(arr, dtype=np.uint32)
    assert a.shape[0] == 2, a.shape
    return torch.stack([limbs_from_jax(a[0]), limbs_from_jax(a[1])], dim=-2)


def fp2_to_jax(t: torch.Tensor) -> np.ndarray:
    """int32[..., 2, N] -> Fp2 uint32[2, 2N, ...] (planar re, im)."""
    assert t.shape[-2] == 2, tuple(t.shape)
    return np.stack([limbs_to_jax(t[..., 0, :]), limbs_to_jax(t[..., 1, :])])


def fp24x6_from_jax(arr: np.ndarray) -> torch.Tensor:
    """Fp24_6 uint32[6, 2, ...] (planar coefficients) -> int32[..., 6, 1]
    (CPU)."""
    a = np.asarray(arr, dtype=np.uint32)
    assert a.shape[:2] == (6, 2), a.shape
    return torch.stack([limbs_from_jax(a[i]) for i in range(6)], dim=-2)


def fp24x6_to_jax(t: torch.Tensor) -> np.ndarray:
    """int32[..., 6, 1] -> Fp24_6 uint32[6, 2, ...]."""
    assert tuple(t.shape[-2:]) == (6, 1), tuple(t.shape)
    return np.stack([limbs_to_jax(t[..., i, :]) for i in range(6)])


def circuit_from_arrays(F, nv: int, nc: int, ninputs: int, npub_in: int,
                        layers: Sequence[dict], subfield_boundary: int = 0,
                        circuit_id: bytes = b"\x00" * 32) -> Circuit:
    """This package's Circuit from numpy arrays.  Each layer is a dict with
    nw, logw, and per term g, h0, h1 (integer arrays) and v (uint32[2N, T]
    JAX Montgomery limbs of the term constants; 0 marks an assert-zero
    term)."""
    out = []
    for ly in layers:
        v = F.from_limbs(limbs_from_jax(ly["v"]))
        out.append(Layer(nw=int(ly["nw"]), logw=int(ly["logw"]),
                         quad=Quad(g=np.asarray(ly["g"]),
                                   h0=np.asarray(ly["h0"]),
                                   h1=np.asarray(ly["h1"]),
                                   v=[int(x) for x in np.ravel(v)])))
    logv = (nv - 1).bit_length() if nv > 1 else 0
    logc = (nc - 1).bit_length() if nc > 1 else 0
    return Circuit(nv=nv, logv=logv, nc=nc, logc=logc, nl=len(out),
                   ninputs=ninputs, npub_in=npub_in,
                   subfield_boundary=subfield_boundary, layers=out,
                   id=circuit_id)


def mp_from_jax(arr: np.ndarray) -> torch.Tensor:
    """Multi-prime uint32[2, VS, ...] (two 16-bit limbs a residue) ->
    int32[VS, ..., 1] words (CPU)."""
    a = np.asarray(arr, dtype=np.uint32)
    assert a.shape[0] == 2, a.shape
    w = (a[0] & np.uint32(0xFFFF)) | ((a[1] & np.uint32(0xFFFF))
                                      << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32)[..., None]
                            .copy())


def mp_to_jax(t: torch.Tensor) -> np.ndarray:
    """int32[VS, ..., 1] words -> multi-prime uint32[2, VS, ...]."""
    assert t.shape[-1] == 1, tuple(t.shape)
    w = np.ascontiguousarray(t.detach().cpu().numpy()[..., 0]).view(np.uint32)
    return np.stack([w & np.uint32(0xFFFF), w >> np.uint32(16)])
