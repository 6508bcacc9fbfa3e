"""The NTT over Fp128 across the cards of a mesh axis: the four-step
decomposition with one all_to_all between its two halves.

Port of the JAX package's parallel/ntt_sharded.py (`ShardedNTT`).  With
n = R S and x[r + R s]:

  1. local S-point NTTs of the columns r, which the D ranks hold in
     blocks of R / D (MatmulNTT._rec: K17 blocks, K1 twiddles);
  2. the product by this rank's twiddle rows w^(r j2) (K1);
  3. the re-shard from the r split to a j2 split: the [R / D, S] block
     packed into D contiguous chunks of S / D columns, chunk j to rank j
     (torch.distributed.all_to_all_single; NCCL on the card), and the D
     chunks received stacked along r: the JAX package's
     all_to_all(split_axis=2, concat_axis=1, tiled=True);
  4. local R-point NTTs over r, one per j2 of this rank's block.

`fftb` and `fftf` take the JAX package's input partition and return its
output partition, in the port's [..., 4] limb layout: in, x viewed as
[S, R, 4] (element r + R s at [s, r]), this rank's columns
[:, k R / D : (k + 1) R / D]; out, the transform viewed as [R, S, 4]
(element j1 S + j2 at [j1, j2]), this rank's columns
[:, k S / D : (k + 1) S / D].  `shard_input` and `gather_output` cut a
whole transform into those partitions and join them.  The only traffic
between cards is the one transpose: n / D elements a rank, (D - 1) / D
of them sent.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..transforms.matmul_ntt import MatmulNTT
from .mesh import Mesh


class ShardedNTT:
    """fftb / fftf over Fp128 of n = R S points, sharded over one axis
    of a mesh (D ranks, a power of two)."""

    def __init__(self, F, omega: int, omega_order: int, mesh: Mesh,
                 axis: str = "rows", radix: int = 128):
        self.F = F
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.size(axis)
        self.mnt = MatmulNTT(F, omega, omega_order, radix=radix,
                             device=mesh.device)
        self._tws = {}

    @functools.lru_cache(maxsize=None)
    def _plan(self, n: int) -> Tuple[int, int]:
        """(R, S): R the transform radix of step 4, a multiple of the
        radix divisible by the ranks, S = n / R."""
        R = self.mnt.radix
        while (n % R != 0 or R % self.ndev != 0) and R < n:
            R *= 2
        assert n % R == 0 and R % self.ndev == 0 and \
            (n // R) % self.ndev == 0, \
            "need power-of-two mesh dividing a radix that divides n"
        return R, n // R

    def _twiddles(self, n: int, inverse: bool) -> torch.Tensor:
        """This rank's rows of w^(r j2): [R / D, S, 4] Montgomery limbs,
        r in its block (the JAX package's _twiddle_limbs, sharded)."""
        key = (n, inverse)
        if key not in self._tws:
            F = self.F
            R, S = self._plan(n)
            Rl = R // self.ndev
            r0 = self.mesh.index(self.axis) * Rl
            w = self.mnt._root(n, inverse)
            vals = []
            for r in range(r0, r0 + Rl):
                wr = pow(w, r, F.p)
                cur = 1
                for _ in range(S):
                    vals.append(cur)
                    cur = cur * wr % F.p
            self._tws[key] = F.to_limbs(vals, self.mesh.device).reshape(
                Rl, S, 4)
        return self._tws[key]

    def prepare(self, n: int) -> None:
        """Uploads every matrix and twiddle table of size n, both
        directions, so that a transform uploads nothing."""
        R, S = self._plan(n)
        for inverse in (False, True):
            self._twiddles(n, inverse)
        for m in (S, R):
            self.mnt.prepare(m)

    def shard_input(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's input partition [S, R / D, 4] of the whole x [n,
        4]."""
        n = x.shape[0]
        R, S = self._plan(n)
        Rl = R // self.ndev
        k = self.mesh.index(self.axis)
        return x.reshape(S, R, 4)[:, k * Rl : (k + 1) * Rl].contiguous()

    def gather_output(self, y: torch.Tensor) -> torch.Tensor:
        """The whole transform [n, 4] from every rank's output partition y
        [R, S / D, 4]."""
        R, Sd = y.shape[0], y.shape[1]
        return self.mesh.all_gather(y, self.axis, dim=1).reshape(
            R * Sd * self.ndev, 4)

    def _transform(self, xl: torch.Tensor, inverse: bool) -> torch.Tensor:
        F, mnt, D = self.F, self.mnt, self.ndev
        S, Rl = xl.shape[0], xl.shape[1]
        R = Rl * D
        n = R * S
        assert self._plan(n) == (R, S), "not this rank's partition"
        Sd = S // D
        # 1. the S-point transforms of this rank's columns r
        y = mnt._rec(xl.transpose(0, 1).contiguous(), S, inverse)
        # 2. the twiddles w^(r j2) of its rows
        z = F.mul(y, self._twiddles(n, inverse))          # [Rl, S, 4]
        # 3. j2 split: chunk j (columns j Sd .. (j + 1) Sd) to rank j; the
        #    chunks received are the rows r of ranks 0 .. D - 1
        z = self.mesh.all_to_all(
            z.reshape(Rl, D, Sd, 4).transpose(0, 1), self.axis)
        # 4. the R-point transforms over r, one per j2 of this rank
        a = mnt._rec(z.reshape(R, Sd, 4).transpose(0, 1).contiguous(), R,
                     inverse)                               # [Sd, R, 4]
        return a.transpose(0, 1).contiguous()              # [R, Sd, 4]

    def fftb(self, xl: torch.Tensor) -> torch.Tensor:
        """Backward FFT of this rank's input partition [S, R / D, 4]:
        its output partition [R, S / D, 4]."""
        return self._transform(xl, inverse=False)

    def fftf(self, xl: torch.Tensor) -> torch.Tensor:
        """Forward FFT (W^-1), partitions as fftb."""
        return self._transform(xl, inverse=True)
