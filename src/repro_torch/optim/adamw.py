"""AdamW with f32 state, decoupled weight decay, global-norm clip.

The JAX package's `repro.optim.adamw` on dicts of tensors, with its
arithmetic in its order: the gradients are clipped to a global norm of
`clip` first (the norm reported is the one before the clip), then the
moments, the bias-corrected step and the decay in f32, and the new
parameter is cast to the parameter's dtype last.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm"]

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: Tree
    v: Tree


def _step0(params: Tree) -> torch.Tensor:
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params: Tree) -> AdamWState:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamWState(step=_step0(params), m=zeros,
                      v={k: z.clone() for k, z in zeros.items()})


def _clip_scale(grads: Tree, max_norm: float, norm=None):
    """(the factor that brings the global norm to at most `max_norm`, the
    global norm; `norm(grads)` computes it where given)."""
    if norm is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in grads.values()))
    else:
        gn = norm(grads)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float):
    """(grads as f32 scaled to a global norm of at most `max_norm`, the
    global norm before scaling)."""
    scale, gn = _clip_scale(grads, max_norm)
    return {k: g.float() * scale for k, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState, params: Tree, *, lr=3e-4,
                 b1=0.9, b2=0.95, eps=1e-8, wd=0.1, clip=1.0, norm=None):
    """Returns (new params, new AdamWState, global grad norm). The clip
    scales one leaf at a time (the same products as
    `clip_by_global_norm`), so no clipped copy of every gradient is held.
    On shards of the leaves, `norm(grads)` gives the global norm over
    every rank's shards (the update itself is element-wise)."""
    scale, gnorm = _clip_scale(grads, clip, norm)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    new_p, new_m, new_v = {}, {}, {}
    for k, g in grads.items():
        p = params[k]
        g = g.float() * scale
        m2 = b1 * state.m[k] + (1 - b1) * g
        v2 = b2 * state.v[k] + (1 - b2) * g * g
        u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        u = u + wd * p.float()
        new_p[k] = (p.float() - lr * u).to(p.dtype)
        new_m[k], new_v[k] = m2, v2
    return new_p, AdamWState(step=step, m=new_m, v=new_v), gnorm
