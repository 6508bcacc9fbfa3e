"""Start the ranks of a multi-card run: one process a rank, each with one
device, joined in a torch.distributed process group.

The JAX package takes its devices from XLA (`jax.devices()`); the port
starts a process a card, as torch.distributed runs, and `spawn` is that
start for the tests (on the CPU, `gloo`) and for the card runs (NCCL):

    results = spawn(fn, world=4, device="cuda", timeout_s=600, args=(...))

runs fn(*args) in `world` fresh processes (the "spawn" start method) and
returns what each returned, in rank order.  In each rank the process
group is initialised (NCCL for "cuda", its device cuda:<rank>; gloo for
"cpu", on one torch thread: with every core busy, the plain versions'
thread pools slow ten-fold), RANK, LOCAL_RANK and WORLD_SIZE are set,
and parallel/mesh.make_mesh builds the mesh on it.  The ranks meet at a
file in a fresh temporary directory (no fixed port: several runs may
start at once).  For "cuda" the kernels are built in the parent before
any rank starts, so that the ranks only load their libraries.

The parent waits under one deadline: a rank that raises ends the run at
once (every rank is killed, and spawn raises with that rank's
traceback), as does a rank that dies, and the deadline's end kills them
all and raises TimeoutError.  A rank that waits in a collective for one
that failed therefore never hangs the caller.
"""

from __future__ import annotations

import datetime
import inspect
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import torch


class RankError(RuntimeError):
    """A rank raised; the message holds its rank and traceback."""


def _rank_main(fn, rank: int, world: int, device: str, init_method: str,
               timeout_s: float, args: Sequence, out) -> None:
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    try:
        kw = {}
        if device == "cuda":
            torch.cuda.set_device(rank)
            if "device_id" in inspect.signature(
                    dist.init_process_group).parameters:
                kw["device_id"] = torch.device("cuda", rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo", init_method=init_method,
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
        res = pickle.dumps(fn(*args))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        out.put((rank, False, traceback.format_exc()))
        return
    out.put((rank, True, res))
    dist.destroy_process_group()


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def spawn(fn: Callable, world: int, device: str = "cuda",
          timeout_s: float = 600.0, args: Sequence = ()) -> List:
    """fn(*args) in `world` ranks ("cuda": NCCL, one card a rank; "cpu":
    gloo); returns the ranks' results in rank order.  fn and args must
    pickle (fn a module-level function).  Raises RankError naming the
    first rank that raised or died, TimeoutError when the ranks outlast
    timeout_s; either way every rank is killed first."""
    if device not in ("cuda", "cpu"):
        raise ValueError("device must be 'cuda' or 'cpu', got %r" % device)
    if world < 1:
        raise ValueError("world must be at least 1, got %d" % world)
    if device == "cuda":
        from .. import kernels
        from ..device import resolve_device

        resolve_device("cuda")
        if torch.cuda.device_count() < world:
            raise RuntimeError("a world of %d needs %d cards, %d visible"
                               % (world, world, torch.cuda.device_count()))
        kernels.build_all()
    tmp = tempfile.mkdtemp(prefix="lfzk_rendezvous_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, device, init_method, timeout_s,
                               tuple(args), out))
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    results = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    "ranks %s did not finish within %.0f s"
                    % (sorted(set(range(world)) - set(results)), timeout_s))
            try:
                rank, ok, res = out.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RankError("rank %d died with exit code %s and no "
                                    "result" % (dead[0],
                                                procs[dead[0]].exitcode))
                continue
            if not ok:
                raise RankError("rank %d raised:\n%s" % (rank, res))
            results[rank] = pickle.loads(res)
        for p in procs:  # each leaves its process group, then ends
            p.join(max(1.0, min(30.0, deadline - time.monotonic())))
    finally:
        _kill(procs)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
