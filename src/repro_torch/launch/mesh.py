"""Production mesh construction.

Single pod: (16, 16) -> ('data', 'model')   [256 ranks]
Multi-pod:  (2, 16, 16) -> ('pod', 'data', 'model')  [512 ranks]

The JAX package's `repro.launch.mesh` on `torch.distributed`: one process
per rank, each joining the process group that `core.mesh.init_mesh` starts
from the environment (as ``torchrun`` sets it) and building the port's
`Mesh` over it. A mesh needs exactly its number of ranks: a world of
another size raises `ValueError` naming it; nothing falls back to a
smaller mesh.

Where a host has fewer cards than ranks of its own (several ranks on one
card), its ranks run gloo with their kernels on that card: NCCL refuses
two ranks on one card (`core.mesh`). Ranks with a card each run NCCL,
however many hosts the world spans (`placement`).

Functions, not module constants: importing this module starts no process
group. `abstract_mesh` gives the two attributes the spec functions of
`models.model` read (`shape`, `axis_names`) without any rank, for specs of
a mesh larger than this host.
"""
from __future__ import annotations

import os
import socket
from types import SimpleNamespace
from typing import Sequence

import torch
import torch.distributed as dist

from ..core.mesh import Mesh, init_mesh

__all__ = ["make_production_mesh", "make_local_mesh", "abstract_mesh",
           "placement", "world_size", "HW"]


def world_size() -> int:
    """The number of ranks: the live process group's, else torchrun's
    ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def abstract_mesh(shape: Sequence[int], axis_names: Sequence[str]):
    """A stand-in with a mesh's `shape` (axis -> size, in order) and
    `axis_names`, as `jax.sharding.AbstractMesh` gives them."""
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {tuple(shape)} for axes {tuple(axis_names)}")
    return SimpleNamespace(shape=dict(zip(axis_names, shape)),
                           axis_names=tuple(axis_names))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def placement(device=None) -> tuple:
    """This rank's device and its group's backend (None: NCCL on a card,
    gloo on the CPU), from the ranks on this host. The device is
    ``cuda:(LOCAL_RANK mod cards)`` unless `device` names another. The
    ranks on this host (torchrun's ``LOCAL_WORLD_SIZE``) take NCCL when
    each has a card of its own, and gloo when several share one: NCCL
    refuses two ranks on one card; without torchrun every rank counts as
    on this host. Ranks on other hosts do not enter the choice, so 256
    ranks over hosts of 8 cards run NCCL."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None or str(device) == "cuda":
        device = f"cuda:{local % cards}" if cards else "cuda"
    if torch.device(device).type != "cuda":
        return device, None
    return device, (None if on_host <= cards else "gloo")


def _join(shape, axes, device=None) -> Mesh:
    """Join (or start) the process group and build the mesh on this rank's
    `placement`. A world of one process outside torchrun starts its own
    group on localhost."""
    world = world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {tuple(shape)} mesh over {tuple(axes)} needs "
                         f"{n} ranks; the world size is {world}")
    device, backend = placement(device)
    kw = {}
    if not dist.is_initialized() and "MASTER_ADDR" not in os.environ:
        kw = dict(init_method=f"tcp://localhost:{_free_port()}", rank=0,
                  world_size=1)
    return init_mesh(shape, axes, device=device, backend=backend, **kw)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _join(shape, axes, device)


def make_local_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """Every rank of the world, split (data, model): (world //
    model_parallel, model_parallel)."""
    world = world_size()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model parallelism {model_parallel} does not "
                         f"divide the world size {world}")
    return _join((world // model_parallel, model_parallel),
                 ("data", "model"), device)


class HW:
    """NVIDIA H100 80GB HBM3 (SXM) per-card constants for the roofline
    (NVIDIA's data sheet)."""
    NAME = "NVIDIA H100 80GB HBM3"
    PEAK_FLOPS = 989e12        # dense bf16 on the tensor cores
    HBM_BW = 3.35e12           # bytes/s
    LINK_BW = 450e9            # NVLink 4, bytes/s per direction
    HBM_BYTES = 80e9
