"""Adafactor (factored second moment) — for models whose AdamW state (8
bytes a parameter) does not fit beside the weights.

Factored along the two trailing dims for rank >= 2 tensors; full second
moment for vectors. No first moment (beta1 = 0), update clipping d=1.0,
relative step size replaced by fixed lr for simplicity (documented).

The JAX package's `repro.optim.adafactor` on dicts of tensors, f32 state
and f32 arithmetic in its order.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .adamw import _step0

__all__ = ["AdafactorState", "adafactor_init", "adafactor_update"]

Tree = Dict[str, torch.Tensor]


class AdafactorState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    vr: Tree                # row factors (or full v for rank-1)
    vc: Tree                # col factors (zeros placeholder for rank-1)


def _factored(p) -> bool:
    return p.dim() >= 2


def adafactor_init(params: Tree) -> AdafactorState:
    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    vr = {k: zeros(p.shape[:-1] if _factored(p) else p.shape, p)
          for k, p in params.items()}
    vc = {k: zeros(p.shape[:-2] + p.shape[-1:] if _factored(p) else (1,), p)
          for k, p in params.items()}
    return AdafactorState(step=_step0(params), vr=vr, vc=vc)


class _Whole:
    """The means of whole leaves: `mean(key, x, dim, leaf_dim)` over
    dimension `dim` of x (the leaf's dimension `leaf_dim`), `mean_all`
    over every element."""

    @staticmethod
    def mean(key, x, dim, leaf_dim, keepdim=False):
        return torch.mean(x, dim=dim, keepdim=keepdim)

    @staticmethod
    def mean_all(key, x):
        return torch.mean(x)


@torch.no_grad()
def adafactor_update(grads: Tree, state: AdafactorState, params: Tree, *,
                     lr=1e-3, decay=0.8, eps=1e-30, clip=1.0, wd=0.0,
                     stats=None):
    """Returns (new params, new AdafactorState, 0: JAX's Adafactor reports
    no gradient norm). On shards of the leaves, `stats` gives the means
    that span a sharded dimension (the factors' means and the update
    clip's RMS) over every rank's shards."""
    stats = stats or _Whole
    step = state.step + 1
    t = step.float()
    beta2 = 1.0 - t ** (-decay)
    new_p, new_vr, new_vc = {}, {}, {}
    for k, g in grads.items():
        p, vr, vc = params[k], state.vr[k], state.vc[k]
        g = g.float()
        g2 = g * g + eps
        if _factored(p):
            vr2 = beta2 * vr + (1 - beta2) * stats.mean(k, g2, -1, -1)
            vc2 = beta2 * vc + (1 - beta2) * stats.mean(k, g2, -2, -2)
            denom = (vr2[..., None] * vc2[..., None, :]
                     / torch.clamp(stats.mean(k, vr2, -1, -2, keepdim=True)
                                   [..., None], min=eps))
            u = g * torch.rsqrt(torch.clamp(denom, min=eps))
        else:
            vr2 = beta2 * vr + (1 - beta2) * g2
            vc2 = vc
            u = g * torch.rsqrt(torch.clamp(vr2, min=eps))
        # update clipping (RMS <= clip)
        rms = torch.sqrt(stats.mean_all(k, u * u) + 1e-12)
        u = u / torch.clamp(rms / clip, min=1.0)
        if wd:
            u = u + wd * p.float()
        new_p[k] = (p.float() - lr * u).to(p.dtype)
        new_vr[k], new_vc[k] = vr2, vc2
    zero = torch.zeros((), dtype=torch.float32, device=state.step.device)
    return new_p, AdafactorState(step=step, vr=new_vr, vc=new_vc), zero
