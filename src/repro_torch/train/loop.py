"""End-to-end training loop: data -> train_step -> checkpoint/restart.

The JAX package's `repro.train.loop` on one device. The loop is
restart-safe: the step index, the weights and the optimizer state are in
the checkpoint, and the data is seekable by step (`data.batch_for` gives
the JAX package's tokens). The checkpoint holds `(params, opt_state)` as
the JAX loop writes it: JAX's leaves in JAX's `tree_flatten` order, the
pattern axis stacked (`models.convert.jax_tree`), bf16 as byte views; so
`repro.train.train` resumes a run of this loop and this loop resumes one
of it.
"""
from __future__ import annotations

import time
from typing import Optional

from ..configs.base import ArchConfig
from ..data.pipeline import batch_for
from ..models import LMModel
from ..models.attention import later
from ..models.convert import (jax_tree, opt_state_from_jax, opt_tree,
                              unstack_jax_tree)
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["train", "save_train_state", "restore_train_state"]


def _state_tree(model: LMModel, opt, device):
    """(params, opt_state) in the JAX loop's tree, each leaf moved to
    `device` ("cpu" to write, "meta" for a restore's template)."""
    def move(t):
        return t.detach().to(device)

    return (jax_tree({k: move(v) for k, v in
                      model.params.state_dict().items()}, model.cfg),
            opt_tree(opt, model.cfg, move))


def save_train_state(ckpt_dir: str, step: int, model: LMModel, opt) -> str:
    """Checkpoint the model's weights and `opt` at `step`."""
    return save_checkpoint(ckpt_dir, step, _state_tree(model, opt, "cpu"))


def restore_train_state(ckpt_dir: str, model: LMModel, opt,
                        step: Optional[int] = None):
    """Load the checkpoint at `step` (the latest by default) into the
    model's weights; returns (its optimizer state, shaped like `opt`, on
    the model's device; its step)."""
    tree, _, step = restore_checkpoint(
        ckpt_dir, _state_tree(model, opt, "meta"), step)
    params, state = tree
    model.params.load_state_dict(unstack_jax_tree(params, model.cfg))
    return opt_state_from_jax(state, model.cfg, model.device), step


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
          mesh=None, log_every: int = 10, seed: int = 0,
          fail_at: Optional[int] = None, device=None):
    """Returns (params, metrics_history): the model's `LMParams` and one
    dict of loss, aux, grad_norm, step and sec every `log_every` steps and
    at the last. On CUDA unless `device` names another. `fail_at` injects
    one simulated failure (tested in tests/test_torch_train_ckpt.py)."""
    if mesh is not None:
        raise later("training on a mesh (mesh=)")
    model = LMModel(cfg, device=device, seed=seed)
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
