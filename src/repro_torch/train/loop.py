"""End-to-end training loop: data -> train_step -> checkpoint/restart.

The JAX package's `repro.train.loop`, on one device or on a mesh (one
process a rank, `models.LMModel(cfg, mesh=)`). The loop is
restart-safe: the step index, the weights and the optimizer state are in
the checkpoint, and the data is seekable by step (`data.batch_for` gives
the JAX package's tokens; every rank draws the global batch). The
checkpoint holds `(params, opt_state)` as the JAX loop writes it: JAX's
leaves, whole, in JAX's `tree_flatten` order, the pattern axis stacked
(`models.convert.jax_tree`), bf16 as byte views; so `repro.train.train`
resumes a run of this loop and this loop resumes one of it, on one
device or on a mesh of any shape. On a mesh each rank sends rank 0 its
shard of each leaf and rank 0 writes (as the mesh sessions do); every
rank maps a checkpoint's files and copies its shards out of them. The
history is equal on every rank.
"""
from __future__ import annotations

import time
from typing import Optional

from ..configs.base import ArchConfig
from ..data.pipeline import batch_for
from ..models import LMModel
from ..models.convert import (jax_tree, opt_state_from_jax, opt_tree,
                              unstack_jax_tree)
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["train", "save_train_state", "restore_train_state"]


def _state_tree(model: LMModel, opt, device):
    """(params, opt_state) in the JAX loop's tree, each whole leaf moved
    to `device` ("cpu" to write, "meta" for a restore's template). On a
    mesh rank 0 gathers each leaf; the other ranks return None."""
    cfg = model.cfg
    if device == "meta":
        return (jax_tree(model.abstract_params(), cfg),
                opt_tree(model.abstract_opt(), cfg))
    keep = model.mesh is None or model.mesh.rank == 0

    def move(t):
        return t.detach().to(device) if keep else None

    params = model.gathered_params(move)
    state = model.opt_gather(opt, move)
    return (jax_tree(params, cfg), opt_tree(state, cfg)) if keep else None


def save_train_state(ckpt_dir: str, step: int, model: LMModel, opt):
    """Checkpoint the model's weights and `opt` at `step` (on a mesh rank
    0 writes, the others return None once it has)."""
    tree = _state_tree(model, opt, "cpu")
    if model.mesh is None:
        return save_checkpoint(ckpt_dir, step, tree)
    path = save_checkpoint(ckpt_dir, step, tree) if model.mesh.rank == 0 \
        else None
    model.mesh.barrier()
    return path


def restore_train_state(ckpt_dir: str, model: LMModel, opt,
                        step: Optional[int] = None):
    """Load the checkpoint at `step` (the latest by default) into the
    model's weights (on a mesh, this rank's shards); returns (its
    optimizer state, shaped like `opt`, on the model's device; its
    step)."""
    # the files are mapped: each leaf is copied once, to the model's
    # device (on a mesh, only this rank's shards of it)
    tree, _, step = restore_checkpoint(
        ckpt_dir, _state_tree(model, opt, "meta"), step, mmap=True)
    params, state = tree
    model.load_full(unstack_jax_tree(params, model.cfg))
    state = opt_state_from_jax(state, model.cfg,
                               "cpu" if model.mesh else model.device)
    return model.opt_shard(state), step


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
          mesh=None, log_every: int = 10, seed: int = 0,
          fail_at: Optional[int] = None, device=None):
    """Returns (params, metrics_history): the model's `LMParams` (on a
    mesh, this rank's shards) and one dict of loss, aux, grad_norm, step
    and sec every `log_every` steps and at the last. On CUDA unless
    `device` names another (on a mesh, the mesh's device). `fail_at`
    injects one simulated failure (tested in
    tests/test_torch_train_ckpt.py)."""
    model = LMModel(cfg, mesh=mesh, device=device, seed=seed)
    opt = model.init_opt()
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        opt, start = restore_train_state(ckpt_dir, model, opt)
    history = []
    failed = False
    t0 = time.time()
    s = start
    while s < steps:
        b = batch_for(cfg, batch, seq, s, seed)
        if fail_at is not None and s == fail_at and not failed:
            failed = True
            raise RuntimeError(f"injected failure at step {s}")
        opt, metrics = model.train_step(opt, b)
        s += 1
        if s % log_every == 0 or s == steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = s
            m["sec"] = time.time() - t0
            history.append(m)
        if ckpt_dir and (s % ckpt_every == 0 or s == steps):
            save_train_state(ckpt_dir, s, model, opt)
    return model.params, history
