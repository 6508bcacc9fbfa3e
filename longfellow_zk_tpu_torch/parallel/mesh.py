"""The device mesh of a multi-card run, and the row and copy partitions.

Port of the JAX package's parallel/mesh.py.  The JAX package places an
array's axes on a `jax.sharding.Mesh` of devices (`make_mesh`,
`shard_rows`, `shard_copies`) and lets XLA insert the collectives; the
port runs one process a card (parallel/launch.py) and each rank holds
its own slice, so the partitions here return this rank's slice and the
collectives are explicit torch.distributed calls (NCCL on the card,
gloo on the CPU), between the kernels:

  - `Mesh`: the world as a (rows, cols) grid, rank = row * n_cols + col,
    with one process sub-group per line of each axis (every rank creates
    all of them, in the same order);
  - `shard_rows` / `shard_copies`: this rank's slice of an axis over the
    mesh's "rows" / "cols" axis, a balanced split (25 rows over 4 ranks
    are 7, 6, 6, 6), and `Mesh.gather`, the slices put back together:
    NCCL's all_gather takes equal sizes, so each slice is padded to the
    largest and the padding dropped after (GSPMD pads uneven shards the
    same way);
  - `Mesh.sum`: a field sum over an axis, the ranks' partial sums
    all-gathered and summed as field elements (K3, `F.lazy_sum`); never
    an all_reduce of the limbs, which NCCL would add as integers;
  - `Mesh.broadcast_object` / `all_gather_object`: host values (the
    prover's random draws, the proofs) from rank 0 / from every rank;
  - `sharded_rs_encode`: the Reed-Solomon extension of this rank's rows.

`Mesh.sent_bytes` counts the bytes this rank's collectives send to the
others (a payload count: all_gather (D - 1) times its slice, all_to_all
(D - 1) / D of its tensor, a broadcast (D - 1) times the object at the
root).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

AXES = ("rows", "cols")


def split(n: int, parts: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each of `parts` balanced slices of range(n): the first
    n % parts slices one longer."""
    q, r = divmod(n, parts)
    out, lo = [], 0
    for k in range(parts):
        hi = lo + q + (k < r)
        out.append((lo, hi))
        lo = hi
    return out


class Mesh:
    """A (n_rows, n_cols) grid of the world's ranks, its axes named
    ("rows", "cols"); built by make_mesh on every rank."""

    axis_names = AXES

    def __init__(self, n_rows: int, n_cols: int, device):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.shape: Dict[str, int] = {"rows": n_rows, "cols": n_cols}
        self.coords = {"rows": self.rank // n_cols,
                       "cols": self.rank % n_cols}
        self.device = device
        self.sent_bytes = 0
        # one group per line of each axis, created by every rank in the
        # same order (dist.new_group's rule); a rank keeps its own lines
        self.groups = {}
        for c in range(n_cols):
            g = dist.new_group([r * n_cols + c for r in range(n_rows)])
            if c == self.coords["cols"]:
                self.groups["rows"] = g
        for r in range(n_rows):
            g = dist.new_group([r * n_cols + c for c in range(n_cols)])
            if r == self.coords["rows"]:
                self.groups["cols"] = g

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    # -- partitions ---------------------------------------------------------

    def bounds(self, n: int, axis: str = "rows") -> Tuple[int, int]:
        """[lo, hi) of this rank's slice of range(n) over `axis`."""
        return split(n, self.size(axis))[self.index(axis)]

    def shard(self, x: torch.Tensor, axis: str = "rows",
              dim: int = 0) -> torch.Tensor:
        """This rank's slice of x along `dim` over `axis` (a view)."""
        lo, hi = self.bounds(x.shape[dim], axis)
        return x.narrow(dim, lo, hi - lo)

    def gather(self, x: torch.Tensor, n: int, axis: str = "rows",
               dim: int = 0) -> torch.Tensor:
        """The slices x of every rank over `axis` (this rank's is x, of
        range(n) along `dim`) joined in rank order: the whole of length
        n, on every rank."""
        parts = split(n, self.size(axis))
        width = parts[0][1] - parts[0][0]
        dim = dim % x.dim()
        if x.shape[dim] < width:
            pad = list(x.shape)
            pad[dim] = width - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        pieces = self._all_gather(x, axis)
        return torch.cat([p.narrow(dim, 0, hi - lo)
                          for p, (lo, hi) in zip(pieces, parts)], dim=dim)

    # -- collectives ----------------------------------------------------------

    def _all_gather(self, x: torch.Tensor, axis: str) -> List[torch.Tensor]:
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size(axis))]
        dist.all_gather(out, x, group=self.groups[axis])
        self.sent_bytes += x.numel() * x.element_size() * (len(out) - 1)
        return out

    def all_gather(self, x: torch.Tensor, axis: str = "rows",
                   dim: int = 0) -> torch.Tensor:
        """Every rank's x (equal shapes) over `axis`, joined along dim in
        rank order."""
        return torch.cat(self._all_gather(x, axis), dim=dim)

    def all_to_all(self, x: torch.Tensor, axis: str = "rows") -> torch.Tensor:
        """x [D, ...] (D the axis' size): chunk j goes to the axis' rank j;
        returns [D, ...], chunk k from rank k."""
        x = x.contiguous()
        D = self.size(axis)
        if x.shape[0] != D:
            raise ValueError("all_to_all takes [%d, ...], got %s"
                             % (D, tuple(x.shape)))
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.groups[axis])
        self.sent_bytes += x.numel() * x.element_size() * (D - 1) // D
        return out

    def sum(self, F, x: torch.Tensor, axis: str = "rows") -> torch.Tensor:
        """The field sum over `axis` of every rank's x (canonical elements
        of F, equal shapes): the partials all-gathered, then one K3 sum."""
        return F.lazy_sum(self.all_gather(x[None], axis), 0)

    def all_true(self, flag) -> bool:
        """Whether flag (a bool, or a bool tensor's all) holds on every
        rank of the world; one host read."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        self.sent_bytes += 4 * (self.world - 1)
        return bool(t.item())

    def broadcast_object(self, obj=None, src: int = 0):
        """Rank src's obj (any picklable value) on every rank."""
        if self.rank == src:
            data = pickle.dumps(obj)
            n = torch.tensor([len(data)], dtype=torch.int64,
                             device=self.device)
        else:
            n = torch.zeros(1, dtype=torch.int64, device=self.device)
        dist.broadcast(n, src)
        if self.rank == src:
            buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(
                self.device)
            self.sent_bytes += len(data) * (self.world - 1)
        else:
            buf = torch.empty(int(n.item()), dtype=torch.uint8,
                              device=self.device)
        dist.broadcast(buf, src)
        return obj if self.rank == src else pickle.loads(
            buf.cpu().numpy().tobytes())

    def all_gather_object(self, obj, axis: str = "rows") -> List:
        """Every rank's obj over `axis`, in rank order."""
        data = pickle.dumps(obj)
        sizes = self.all_gather(torch.tensor([len(data)], dtype=torch.int64,
                                             device=self.device), axis)
        sizes = sizes.tolist()
        buf = torch.zeros(max(sizes), dtype=torch.uint8, device=self.device)
        buf[: len(data)] = torch.frombuffer(bytearray(data),
                                            dtype=torch.uint8).to(self.device)
        return [pickle.loads(p[:s].cpu().numpy().tobytes())
                for p, s in zip(self._all_gather(buf, axis), sizes)]

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def make_mesh(n_rows: int, n_cols: int = 1, device=None) -> Mesh:
    """The (n_rows, n_cols) mesh of the world's ranks, on this rank's
    device: cuda:<LOCAL_RANK> unless the caller passes device="cpu".
    Every rank calls it, with the same shape.  Raises when no process
    group is initialised or the world is not n_rows * n_cols."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/launch.spawn starts one a rank)")
    world = dist.get_world_size()
    if n_rows < 1 or n_cols < 1 or n_rows * n_cols != world:
        raise ValueError("a (%d, %d) mesh needs a world of %d ranks, the "
                         "process group has %d"
                         % (n_rows, n_cols, n_rows * n_cols, world))
    if device is None:
        device = "cuda:%d" % int(os.environ.get("LOCAL_RANK",
                                                dist.get_rank()))
    return Mesh(n_rows, n_cols, resolve_device(device))


def mesh_device(mesh: Optional[Mesh], device=None) -> torch.device:
    """The device of a prover given `device` and `mesh`: the mesh's when
    there is one (device, if passed too, must be it)."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError("device %s is not the mesh's %s"
                         % (device, mesh.device))
    return mesh.device


def shard_rows(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows of x (its axis `dim`) over the mesh's rows axis."""
    return mesh.shard(x, "rows", dim)


def shard_copies(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's copies of x (its axis `dim`) over the mesh's cols
    axis."""
    return mesh.shard(x, "cols", dim)


def sharded_rs_encode(rs, mesh: Optional[Mesh],
                      x: torch.Tensor) -> torch.Tensor:
    """The Reed-Solomon extension (rs.interpolate, [rows, n, N] -> [rows,
    m, N]) of this rank's rows x, shard_rows of the whole; `gather` joins
    the ranks' extensions (Mesh.gather).  A rank without rows encodes
    nothing."""
    if mesh is not None and x.shape[0] == 0:
        return x.new_zeros((0, rs.m) + tuple(x.shape[2:]))
    return rs.interpolate(x)
