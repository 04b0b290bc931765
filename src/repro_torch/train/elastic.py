"""Fault tolerance & elastic scaling policy.

A step is a pure function of (checkpoint, data cursor); the launcher treats
any failure as "restore last commit and continue", and a device-count change
as "rebuild the mesh and reshard at restore" (checkpoints are stored
unsharded, see checkpoint.py). For the PageRank engine, elasticity
additionally requires host repartitioning of the graph (`build_sharded` is
a pure function of (graph, nd, shard)) — `elastic_pagerank_resume` below
does exactly that.

Straggler mitigation: synchronous SPMD steps are bounded by the slowest
shard; the knobs provided are (a) `delta_every` — run k PageRank iterations
between convergence all-reduces, trading up to k-1 surplus iterations for
k× fewer global syncs, and (b) even-degree partitioning: `build_sharded`
assigns contiguous vertex blocks, and the hybrid layout's tile padding
equalizes per-shard edge work.

A port of the JAX package's `repro.train.elastic`. The resume is SPMD: each
rank builds its own shard of the new layout and takes its slice of the
checkpointed dense vectors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from ..core.graph import Graph
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["RunState", "run_with_restarts", "elastic_pagerank_resume"]


@dataclasses.dataclass
class RunState:
    step: int
    tree: Any
    extra: dict


def run_with_restarts(step_fn: Callable[[RunState], RunState],
                      init_fn: Callable[[], RunState],
                      ckpt_dir: str, *, total_steps: int,
                      ckpt_every: int = 50,
                      max_restarts: int = 3,
                      fail_injector: Optional[Callable[[int], None]] = None
                      ) -> RunState:
    """Generic restartable loop: restores the latest commit if present, runs
    `step_fn` until `total_steps`, checkpoints every `ckpt_every`, and on a
    RuntimeError or IOError restores and continues (up to max_restarts).
    `fail_injector` lets tests simulate node failures at chosen steps."""
    restarts = 0
    state = None
    while True:
        try:
            if state is None:
                last = latest_step(ckpt_dir)
                if last is not None:
                    proto = init_fn()
                    tree, extra, step = restore_checkpoint(ckpt_dir,
                                                           proto.tree)
                    state = RunState(step=step, tree=tree, extra=extra)
                else:
                    state = init_fn()
            while state.step < total_steps:
                if fail_injector is not None:
                    fail_injector(state.step)
                state = step_fn(state)
                if state.step % ckpt_every == 0 or state.step == total_steps:
                    save_checkpoint(ckpt_dir, state.step, state.tree,
                                    state.extra)
            return state
        except (RuntimeError, IOError):          # a (simulated) node failure
            restarts += 1
            if restarts > max_restarts:
                raise
            state = None                          # force restore


def elastic_pagerank_resume(g: Graph, ckpt_dir: str, new_nd: int,
                            d_p: int = 64, tile: int = 1024, *, shard: int,
                            device=None):
    """Resume PageRank under a different device count: build shard `shard`
    of the layout for `new_nd` on `device` (CUDA unless named) and take
    its [n_loc] slices of the checkpointed dense rank/flag vectors
    (``{"r": [n] f64, "dv": [n] bool}``). Returns (sharded_graph, r, dv);
    row `shard` of what JAX's `elastic_pagerank_resume` returns stacked."""
    # imported here: `core` imports the guard, whose journal imports this
    # package's checkpoints
    from ..core.distributed import build_sharded, shard_vector

    sg = build_sharded(g, new_nd, d_p=d_p, tile=tile, shard=shard,
                       device=device)
    like = {"r": np.empty(g.n, np.float64), "dv": np.empty(g.n, np.bool_)}
    tree, _, _ = restore_checkpoint(ckpt_dir, like)
    return (sg, shard_vector(tree["r"], new_nd, shard, device=sg.device),
            shard_vector(tree["dv"], new_nd, shard, device=sg.device))
