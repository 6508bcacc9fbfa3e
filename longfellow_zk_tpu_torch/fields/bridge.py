"""Carrying state between the JAX package's layout and this package's.

The JAX package holds a prime-field tensor as uint32[L, ...]: L 16-bit
limbs on the leading axis (two for the ML-DSA prime, four for Fp64,
eight for Fp128, sixteen for P-256, 24 for P-384, 33 for P-521).  This
package holds it as int32[..., N]: N 32-bit limbs on the trailing axis.
An Fp2 tensor is planar there, uint32[2, 2N, ...] (re, im leading), and
int32[..., 2, N] here.  Both packages use Montgomery form.  Where L =
2N, both have R = 2^(32N), so the conversion moves bits and changes no
value (limbs_from_jax, limbs_to_jax).  At P-521, L = 33 and N = 17: R is
2^528 there and 2^544 here, so field_from_jax and field_to_jax convert
the values through host ints (x 2^16 mod p one way, x 2^-16 mod p the
other); the bit-moving functions refuse an odd limb count or 17 words.  A
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
    """uint32[2N, ...] (16-bit limbs, leading) -> int32[..., N] (CPU);
    only where both packages' R is 2^(32N) (not P-521: field_from_jax)."""
    a = np.asarray(arr, dtype=np.uint32)
    assert a.shape[0] in (2, 4, 8, 16, 24), a.shape
    w = (a[0::2] & np.uint32(0xFFFF)) | ((a[1::2] & np.uint32(0xFFFF))
                                         << np.uint32(16))
    w = np.ascontiguousarray(np.moveaxis(w, 0, -1)).view(np.int32)
    return torch.from_numpy(w.copy())


def limbs_to_jax(t: torch.Tensor) -> np.ndarray:
    """int32[..., N] -> uint32[2N, ...] (16-bit limbs, leading); not at
    17 words (field_to_jax)."""
    w = np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint32)
    assert w.shape[-1] in (1, 2, 4, 8, 12), w.shape
    lo = w & np.uint32(0xFFFF)
    hi = w >> np.uint32(16)
    out = np.stack([lo, hi], axis=-1).reshape(w.shape[:-1] +
                                              (2 * w.shape[-1],))
    return np.ascontiguousarray(np.moveaxis(out, -1, 0))


def _jax_shift(F) -> int:
    """log2 of this package's R over the JAX package's: 32 N - 16 L."""
    return 32 * F.nlimb - 16 * F.L


def field_from_jax(F, arr: np.ndarray) -> torch.Tensor:
    """A JAX tensor of prime field F, uint32[L, ...] Montgomery limbs
    (R = 2^(16 L)) -> this package's int32[..., N] (R = 2^(32 N), CPU):
    the limbs moved where the two R agree, else the values converted."""
    a = np.asarray(arr, dtype=np.uint32)
    assert a.shape[0] == F.L, (a.shape, F.L)
    shift = _jax_shift(F)
    if shift == 0:
        return limbs_from_jax(a)
    p, nb = F.p, 4 * F.nlimb
    raw = np.ascontiguousarray(np.moveaxis(a, 0, -1)).astype("<u2")
    raw = raw.reshape(-1, F.L).tobytes()
    step = 2 * F.L
    buf = b"".join(((int.from_bytes(raw[j : j + step], "little") << shift)
                    % p).to_bytes(nb, "little")
                   for j in range(0, len(raw), step))
    w = np.frombuffer(buf, dtype="<i4").reshape(a.shape[1:] + (F.nlimb,))
    return torch.from_numpy(w.copy())


def field_to_jax(F, t: torch.Tensor) -> np.ndarray:
    """This package's int32[..., N] of prime field F -> the JAX package's
    uint32[L, ...] Montgomery limbs (field_from_jax's inverse)."""
    shift = _jax_shift(F)
    if shift == 0:
        return limbs_to_jax(t)
    assert t.shape[-1] == F.nlimb, tuple(t.shape)
    p, nb = F.p, 4 * F.nlimb
    unshift = pow(1 << shift, -1, p)
    raw = np.ascontiguousarray(t.detach().cpu().numpy()).astype(
        "<i4").tobytes()
    buf = b"".join(((int.from_bytes(raw[j : j + nb], "little") * unshift)
                    % p).to_bytes(2 * F.L, "little")
                   for j in range(0, len(raw), nb))
    limbs = np.frombuffer(buf, dtype="<u2").reshape(
        tuple(t.shape[:-1]) + (F.L,)).astype(np.uint32)
    return np.ascontiguousarray(np.moveaxis(limbs, -1, 0))


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
