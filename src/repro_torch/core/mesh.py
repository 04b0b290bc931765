"""The mesh of an SPMD run and its five collectives.

The JAX engines are single-controller: one process holds stacked
``[nd, ...]`` arrays and ``shard_map`` runs the per-shard body with
``all_gather``, ``pmax``, ``psum``, ``psum_scatter`` and ``ppermute``
(`repro.core.distributed.shard_map_loop`). The port is SPMD on
``torch.distributed``: one process per shard, each holding its shard only.
A `Mesh` is a ``torch.distributed.device_mesh.DeviceMesh`` over the whole
process group plus the device this rank computes on, and it offers the
counterparts of those collectives:

  * `all_gather` — tiled (concatenated along dim 0, in mesh order), over
    the whole mesh or one mesh dimension;
  * `all_max` / `all_sum` — all-reduces. MAX keeps NaN winning, as
    ``lax.pmax`` and the kernels' folds do (the health word relies on it):
    the operands are gathered and folded with ``torch.amax``, since the
    backends' own MAX drops a NaN;
  * `psum_scatter` — a reduce-scatter over one mesh dimension;
  * `ppermute` — paired send/receive; a pair with this rank on both ends
    is a copy;
  * `gather_to` — every rank's tensor on rank 0's host (a checkpoint's
    leaves, written by rank 0).

The 1-D engines use the mesh flattened to one group (every dimension as
one, as the JAX 1-D engine takes every mesh axis as one), so this rank's
shard is its row-major position in the mesh. The 2-D engines take a
two-dimensional ("data", "model") mesh and use its dimensions' groups.

How a collective moves its tensors is fixed when the mesh is built, from
its backend: NCCL takes CUDA tensors as they are; gloo takes CPU tensors,
so on a CUDA device every operand is copied to host memory and the result
back. Nothing is chosen by catching an error. NCCL refuses two ranks on
one card, so several ranks on one card run gloo, with their kernels on
that card.

`init_mesh` joins (or starts) the process group and builds the mesh from
the environment, as ``torchrun`` sets it; `run_ranks` spawns a group of
ranks on this host with a deadline, as the tests and ``chip_smoke.py`` do.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "init_mesh", "build_mesh", "run_ranks"]

# torch 2.10 renamed the tensor collectives; older builds have only the
# old names (the new ones are chosen where they exist)
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class Mesh:
    """A device mesh over every rank of the process group, and this rank's
    device. `shard` is this rank's row-major position in the mesh (the
    1-D engines' shard index); `size` the number of ranks."""

    def __init__(self, device_mesh, device: torch.device):
        ranks = device_mesh.mesh.flatten().tolist()
        if ranks != list(range(dist.get_world_size())):
            raise ValueError("the mesh must hold every rank of the process "
                             "group, in rank order")
        self.dm = device_mesh
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        # gloo collectives take host tensors: on a card they go through
        # host memory (decided here, once)
        self._via_host = self.backend == "gloo" and self.device.type != "cpu"
        # as jax.sharding.Mesh: axis names, and axis -> size in mesh order
        self.axis_names = tuple(device_mesh.mesh_dim_names or ())
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.size = len(ranks)
        self.rank = dist.get_rank()
        self.shard = self.rank
        self.coord = tuple(device_mesh.get_coordinate())
        self._groups = {}

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, "
                f"rank={self.rank}, backend={self.backend}, "
                f"device={self.device})")

    # -- groups ---------------------------------------------------------------

    def group(self, dim=None):
        """The process group of mesh dimension `dim` (a name or an index),
        of several named dimensions (a tuple in mesh order: its ranks in
        row-major order over them), or of the whole mesh for None."""
        if dim is None:
            return dist.group.WORLD
        if not isinstance(dim, tuple):
            return self.dm.get_group(dim)
        if len(dim) == 1:
            return self.dm.get_group(dim[0])
        if set(dim) == set(self.axis_names):
            return dist.group.WORLD
        if dim not in self._groups:
            self._groups[dim] = self._new_group(dim)
        return self._groups[dim]

    def _new_group(self, dims: tuple):
        """Every rank creates every group of `dims` (all ranks call this in
        the same order: the runs are SPMD) and keeps its own."""
        import itertools

        sizes = tuple(self.shape.values())
        axes = [self.axis_names.index(d) for d in dims]
        if axes != sorted(axes):
            raise ValueError(f"mesh dimensions {dims} are not in mesh order "
                             f"{self.axis_names}")
        rest = [i for i in range(len(sizes)) if i not in axes]
        mine = None
        for other in itertools.product(*(range(sizes[i]) for i in rest)):
            ranks = []
            for inner in itertools.product(*(range(sizes[i]) for i in axes)):
                coord = [0] * len(sizes)
                for i, c in zip(rest, other):
                    coord[i] = c
                for i, c in zip(axes, inner):
                    coord[i] = c
                ranks.append(self.rank_at(coord))
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def group_size(self, dim=None) -> int:
        if dim is None:
            return self.size
        dims = dim if isinstance(dim, tuple) else (dim,)
        n = 1
        for d in dims:
            n *= self.shape[self.axis_names[d] if isinstance(d, int) else d]
        return n

    def index(self, dims) -> int:
        """This rank's row-major position over the named dimension(s)
        `dims` (a name or a tuple in mesh order)."""
        dims = dims if isinstance(dims, tuple) else (dims,)
        idx = 0
        for d in dims:
            idx = idx * self.shape[d] + self.coord[self.axis_names.index(d)]
        return idx

    def rank_at(self, coord: Sequence[int]) -> int:
        """The global rank at mesh coordinate `coord`."""
        return int(self.dm.mesh[tuple(coord)])

    # -- host staging ---------------------------------------------------------

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self._via_host else x

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self._via_host else x

    # -- the collectives ------------------------------------------------------

    def all_gather(self, x: torch.Tensor, dim=None) -> torch.Tensor:
        """Every rank's `x` (same shape on each) concatenated along dim 0 in
        mesh order, over the whole mesh or mesh dimension `dim`
        (``lax.all_gather(..., tiled=True)``)."""
        k = self.group_size(dim)
        if k == 1:
            return x.clone()
        xs = self._out(x.contiguous())
        out = xs.new_empty((k * xs.shape[0],) + tuple(xs.shape[1:]))
        _gather_into(out, xs, group=self.group(dim))
        return self._back(out)

    def all_max(self, x: torch.Tensor, dim=None) -> torch.Tensor:
        """Elementwise max over the ranks (``lax.pmax``), NaN winning."""
        k = self.group_size(dim)
        if k == 1:
            return x.clone()
        got = self.all_gather(x.reshape(1, -1), dim)
        return torch.amax(got.reshape(k, -1), dim=0).reshape(x.shape)

    def all_sum(self, x: torch.Tensor, dim=None) -> torch.Tensor:
        """Elementwise sum over the ranks (``lax.psum``)."""
        if self.group_size(dim) == 1:
            return x.clone()
        xs = self._out(x.contiguous()).clone()
        dist.all_reduce(xs, op=dist.ReduceOp.SUM, group=self.group(dim))
        return self._back(xs)

    def psum_scatter(self, x: torch.Tensor, dim) -> torch.Tensor:
        """Sum `x` over mesh dimension `dim` and keep this rank's piece of
        dim 0 (``lax.psum_scatter(..., tiled=True)``)."""
        k = self.group_size(dim)
        if k == 1:
            return x.clone()
        xs = self._out(x.contiguous())
        out = xs.new_empty((xs.shape[0] // k,) + tuple(xs.shape[1:]))
        _reduce_scatter(out, xs, op=dist.ReduceOp.SUM, group=self.group(dim))
        return self._back(out)

    def ppermute(self, x: torch.Tensor, send_to: int,
                 recv_from: int) -> torch.Tensor:
        """Send `x` to global rank `send_to` and return what `recv_from`
        sent here (one pair of ``lax.ppermute``'s permutation, seen from
        this rank). With this rank on both ends it is a copy."""
        if send_to == self.rank and recv_from == self.rank:
            return x.clone()
        xs = self._out(x.contiguous())
        out = torch.empty_like(xs)
        ops = [dist.P2POp(dist.isend, xs, send_to),
               dist.P2POp(dist.irecv, out, recv_from)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(out)

    def gather_to(self, x: torch.Tensor):
        """Every rank's `x` (same shape on each), in rank order, as host
        tensors on rank 0 (None on the others): each rank sends its tensor
        once."""
        if self.size == 1:
            return [x.cpu()]
        xs = self._out(x.contiguous())
        out = ([torch.empty_like(xs) for _ in range(self.size)]
               if self.rank == 0 else None)
        dist.gather(xs, out, dst=0)
        return None if out is None else [t.cpu() for t in out]

    def coord_of(self, rank: int) -> tuple:
        """The mesh coordinate of global rank `rank`."""
        hit = (self.dm.mesh == rank).nonzero()[0]
        return tuple(int(c) for c in hit)

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable `obj`, in rank order (checkpoints and the
        rare rebuild path only: it pickles)."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_mesh(shape: Optional[Sequence[int]] = None,
              dim_names: Optional[Sequence[str]] = None, *, device=None,
              backend: Optional[str] = None, init_method: str = "env://",
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout_s: float = 300.0) -> Mesh:
    """Join the process group (starting it if this process has not) and
    build a mesh of `shape` (default: one dimension over every rank) with
    `dim_names`.

    Rank, world size and the rendezvous come from the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``, as
    ``torchrun`` sets them) unless given. `device` defaults to
    ``cuda:{LOCAL_RANK}`` and raises without a card
    (`device.resolve_device`); `backend` defaults to NCCL on a card and
    gloo on the CPU. `timeout_s` bounds every collective of the group, so
    a hung peer fails the run instead of hanging it."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = resolve_device(f"cuda:{local}" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    backend = backend or _default_backend(dev)
    if not dist.is_initialized():
        kw = {}
        if rank is not None:
            kw.update(rank=rank, world_size=world_size)
        if backend == "nccl":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return build_mesh(shape, dim_names, device=dev)


def build_mesh(shape: Optional[Sequence[int]] = None,
               dim_names: Optional[Sequence[str]] = None, *,
               device) -> Mesh:
    """A mesh of `shape` over the live process group (every rank calls it
    with the same arguments: it creates the dimensions' groups)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (world,)
    if dim_names is None:
        dim_names = tuple(f"d{i}" for i in range(len(shape)))
    # the DeviceMesh's device type names the collectives' backend
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(kind, shape, mesh_dim_names=tuple(dim_names))
    return Mesh(dm, resolve_device(device))


# ---------------------------------------------------------------------------
# A group of ranks on this host, with a deadline
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, store, backend, timeout_s, args, out):
    try:
        # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        if backend == "nccl":
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            res = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:
        # the parent raises with this traceback; the rank exits non-zero
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world_size: int, *args, store_dir: str,
              backend: str = "gloo", timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in `world_size` spawned
    processes joined into one process group (`backend`, a ``file://``
    store under `store_dir`) and return their results in rank order.

    `fn` must be importable by name (a module-level function) and its
    result picklable; it builds its mesh with `build_mesh`. Each rank
    takes an equal share of the host's cores for its own threads. Every
    collective of the group times out after `timeout_s`, and the whole
    group must finish within twice that: a rank that fails or hangs
    fails the call (`RuntimeError` with the rank's traceback), and every
    process still alive is then killed."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world_size, store, backend, timeout_s, args, out),
        daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 2 * timeout_s
    results = {}
    try:
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"run_ranks: {world_size - len(results)} of "
                    f"{world_size} ranks did not finish within "
                    f"{2 * timeout_s:.0f} s")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if all(p.exitcode in (None, 0) for p in procs):
                    continue
                try:            # a rank died: its report may be in flight
                    rank, ok, val = out.get(timeout=5.0)
                except queue.Empty:
                    raise RuntimeError("run_ranks: a rank process died "
                                       "before reporting") from None
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{val}")
            results[rank] = val
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [results[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        if os.path.exists(store):
            os.remove(store)
