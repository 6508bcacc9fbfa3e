"""The NTT over Fp128 as products of byte blocks with constant matrices.

Port of the JAX package's transforms/matmul_ntt.py (`MatmulNTT`): a
recursive four-step decomposition n = R * S whose base cases, B-point
NTTs with B <= radix, are each one product of the inputs' bytes with a
constant matrix:

  - x * c mod p is linear in the bytes of x: x * c = sum_j byte_j(x) *
    (c * 2^(8 j) mod p), so the whole B-point transform out[k] = sum_n
    x[n] w^(n k) is one matrix M[(n, j), (k, b)] = byte b of (w^(n k)
    2^(8 j) mod p), and out[k] = sum_b col[k, b] 2^(8 b) mod p with the
    column sums col = bytes(x) @ M, each below 255^2 * 16 B < 2^27;
  - Montgomery forms pass through: mont(x) * w = mont(x * w) for a
    natural-form constant w, so the matrices hold natural powers of w and
    act on the Montgomery limbs as they are;
  - the twiddles between the two steps are all distinct: they stay an
    elementwise product (K1) with a table uploaded once.

The base case is kernel K17 `fp_matmul_ntt[fp128]` (csrc/matmul_ntt.cu):
the integer product with the matrix, then in the same kernel the byte
carry, the fold of 2^128 = 2^108 - 1 (mod p) and the reduction to the
canonical residue.  The JAX package splits the matrix into nibbles to
keep bf16 products exact in f32 and carries two padding bytes an input
(NBYTES_IN = 18) that only ever meet zeros for canonical input; the port
multiplies the 16 bytes of each canonical element by a u8 matrix in
32-bit integers.  For a CPU tensor the wrapper runs the plain version
(a float64 product, exact below 2^53, then the carry in int64 over 16-bit
limbs).  Tensors are int32 [..., n, 4] (fields/fp.py); the transforms run
along the element axis, with the semantics of transforms/ntt.NTT.fftb and
fftf.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..fields.fp import _join16, _renorm16, check_elts, route

NBYTES = 16     # bytes of an Fp128 element
TILE_E = 16     # output elements of a K17 column tile (csrc/matmul_ntt.cu)
TILE_K = 16     # packed matrix words of a K17 reduction step


def _padded(B: int) -> Tuple[int, int]:
    """(rows, columns) of K17's matrix for a B-point block: the 4 B packed
    words of the reduction and the 16 B byte columns, padded to whole
    tiles."""
    return (-(-4 * B // TILE_K) * TILE_K,
            -(-B // TILE_E) * TILE_E * NBYTES)


def block_matrix_words(p: int, w: int, B: int) -> np.ndarray:
    """The B-point NTT with root w (out[k] = sum_n x[n] w^(n k)) as K17's
    matrix, int32 [Kp, Cp] (`_padded(B)`): row 4 n + q, the four bytes
    j = 4 q .. 4 q + 3 of input element n packed little-endian into one
    word (a __dp4a operand); column tile * 256 + b * 16 + e, byte b of
    output element k = 16 tile + e.  Zero rows and columns pad the tiles.
    The JAX package's _ntt_matrices without its nibble split."""
    pw = [pow(w, e, p) for e in range(B)]
    buf = b"".join(((c << (8 * j)) % p).to_bytes(NBYTES, "little")
                   for c in pw for j in range(NBYTES))
    cb = np.frombuffer(buf, np.uint8).reshape(B, 4, 4, NBYTES)  # [e, q, t, b]
    cb = cb.astype(np.uint32)
    words = cb[:, :, 0] | (cb[:, :, 1] << 8) | (cb[:, :, 2] << 16) | \
        (cb[:, :, 3] << 24)                                      # [e, q, b]
    nk = np.outer(np.arange(B), np.arange(B)) % B                # w^(n k)
    g = words[nk].transpose(0, 2, 3, 1)                          # [n, q, b, k]
    Kp, Cp = _padded(B)
    Ep = Cp // NBYTES
    out = np.zeros((Kp, NBYTES, Ep), np.uint32)
    out[: 4 * B, :, :B] = g.reshape(4 * B, NBYTES, B)
    out = out.reshape(Kp, NBYTES, Ep // TILE_E, TILE_E).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(out).reshape(Kp, Cp).view(np.int32)


def matmul_ntt_plain(F, x: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Plain version of K17: the B-point transform of every block of x
    [blocks, B, 4] under K17's matrix G (block_matrix_words); any device.
    The column sums (< 2^27) of a float64 product are exact; the carry
    and the reduction mod p run in int64 over 16-bit limbs."""
    blocks, B = x.shape[0], x.shape[1]
    g = G.to(torch.int64) & 0xFFFFFFFF
    Kp, Cp = _padded(B)
    # [n q, tile, b, e], then the bytes t of each word: [n, q, tile, b, e, t]
    g = g.reshape(Kp, Cp // 256, NBYTES, TILE_E)[: 4 * B]
    sh = torch.arange(0, 32, 8, device=x.device)
    gb = ((g[..., None] >> sh) & 0xFF).reshape(B, 4, Cp // 256, NBYTES,
                                                TILE_E, 4)
    M = gb.permute(0, 1, 5, 2, 4, 3).reshape(B * NBYTES, Cp // NBYTES,
                                              NBYTES)[:, :B]
    M = M.reshape(B * NBYTES, B * NBYTES).to(torch.float64)  # [(n, j), (k, b)]
    xw = x.to(torch.int64) & 0xFFFFFFFF
    xb = ((xw[..., None] >> sh) & 0xFF).reshape(blocks, B * NBYTES)
    cols = torch.round(xb.to(torch.float64) @ M).to(torch.int64)
    cols = cols.reshape(blocks, B, NBYTES)
    cols16 = cols[..., 0::2] + (cols[..., 1::2] << 8)        # < 2^36
    return _join16(_renorm16(F, cols16))


def fp_matmul_ntt(F, x: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """K17 wrapper: the B-point NTT of every block of x [blocks, B, 4]
    (canonical Montgomery limbs), G K17's matrix for B (block_matrix_words
    on x's device).  Out of place."""
    name = route("fp_matmul_ntt", F, x, G)
    if name is None:
        return matmul_ntt_plain(F, x, G)
    check_elts(x, "x", F.elt_shape)
    if x.dim() != 3 or G.dtype != torch.int32 or not G.is_contiguous() or \
            tuple(G.shape) != _padded(x.shape[1]):
        raise ValueError("fp_matmul_ntt takes x [blocks, B, 4] and its "
                         "matrix %s, got %s and %s"
                         % (_padded(x.shape[1]), tuple(x.shape),
                            tuple(G.shape)))
    y = torch.empty_like(x)
    kernels.launch(name, 1, y.data_ptr(), x.data_ptr(), G.data_ptr(),
                   x.shape[0], x.shape[1])
    return y


class MatmulNTT:
    """fftb / fftf along the element axis of int32 [..., n, 4] over Fp128,
    by the four-step recursion with B-point blocks (B <= radix) in K17."""

    def __init__(self, F, omega: int, omega_order: int, radix: int = 128,
                 device=None):
        assert F.tag == "fp128", "the matmul NTT supports Fp128 only"
        assert radix >= 2 and radix & (radix - 1) == 0
        self.F = F
        self.omega = omega
        self.omega_order = omega_order
        self.radix = radix
        self.device = resolve_device(device)
        self._mats: Dict[Tuple[int, bool], torch.Tensor] = {}
        self._tws: Dict[Tuple[int, bool], torch.Tensor] = {}

    def _root(self, n: int, inverse: bool) -> int:
        assert self.omega_order % n == 0
        w = pow(self.omega, self.omega_order // n, self.F.p)
        return pow(w, -1, self.F.p) if inverse else w

    def block_matrix(self, B: int, inverse: bool) -> torch.Tensor:
        """K17's matrix of the B-point transform, on the device."""
        key = (B, inverse)
        if key not in self._mats:
            self._mats[key] = torch.from_numpy(block_matrix_words(
                self.F.p, self._root(B, inverse), B)).to(self.device)
        return self._mats[key]

    def twiddles(self, n: int, inverse: bool) -> torch.Tensor:
        """w^(r j2) for the step n = R S (R = radix), as Montgomery limbs
        [R, S, 4] on the device (the JAX package's _twiddle_limbs)."""
        key = (n, inverse)
        if key not in self._tws:
            F, R = self.F, self.radix
            S = n // R
            w = self._root(n, inverse)
            vals = []
            for r in range(R):
                wr = pow(w, r, F.p)
                cur = 1
                for _ in range(S):
                    vals.append(cur)
                    cur = cur * wr % F.p
            self._tws[key] = F.to_limbs(vals, self.device).reshape(R, S, 4)
        return self._tws[key]

    def prepare(self, n: int) -> None:
        """Uploads every matrix and twiddle table of size n, both
        directions, so that a transform of that size uploads nothing."""
        for inverse in (False, True):
            m = n
            while m > self.radix:
                self.twiddles(m, inverse)
                self.block_matrix(self.radix, inverse)
                m //= self.radix
            if m > 1:
                self.block_matrix(m, inverse)

    def _rec(self, x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
        """x [rows, n, 4] contiguous -> its transform, [rows, n, 4]."""
        if n <= self.radix:
            return fp_matmul_ntt(self.F, x, self.block_matrix(n, inverse))
        R = self.radix
        S = n // R
        rows = x.shape[0]
        # x[r + R s]: [rows, S, R] -> a row r of S: [rows R, S]
        X2 = x.reshape(rows, S, R, 4).transpose(1, 2).reshape(
            rows * R, S, 4).contiguous()
        Y = self._rec(X2, S, inverse).reshape(rows, R, S, 4)
        Z = self.F.mul(Y, self.twiddles(n, inverse))
        # the R-point transforms over r, one per j2: [rows S, R]
        Z2 = Z.transpose(1, 2).reshape(rows * S, R, 4).contiguous()
        A = self._rec(Z2, R, inverse).reshape(rows, S, R, 4)
        # output j = j1 S + j2
        return A.transpose(1, 2).reshape(rows, n, 4)

    def _transform(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        n = x.shape[-2]
        if n == 1:
            return x
        assert n & (n - 1) == 0, "length must be a power of 2"
        y = self._rec(x.reshape(-1, n, 4).contiguous(), n, inverse)
        return y.reshape(x.shape)

    def fftb(self, x: torch.Tensor) -> torch.Tensor:
        """Backward FFT: T[j] = sum_k F[k] W^{jk}."""
        return self._transform(x, inverse=False)

    def fftf(self, x: torch.Tensor) -> torch.Tensor:
        """Forward FFT: W^{-1}."""
        return self._transform(x, inverse=True)
