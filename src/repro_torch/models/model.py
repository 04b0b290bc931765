"""LMModel: the public serving step API.

The JAX package's `repro.models.LMModel` as an `nn.Module` that owns its
weights (`self.params`, a `transformer.LMParams`), so the steps take no
`params` argument; each returns what the JAX step returns:

- `prefill_step(batch)` -> (logits [B, V] at the last position, caches:
  one (k, v) [B, S, K, hd] pair per layer). On CUDA tensors every layer's
  attention runs the `flash_attention` kernel. The head (`lnf`, `unembed`)
  runs on the last position only: the same values as the JAX step's
  `logits[:, -1]`, without its [B, S, V] f32 tensor;
- `decode_step(cache, batch, pos)` -> (logits [B, 1, V], cache), the cache
  written in place at `pos`.

Inputs are dicts of tensors or numpy arrays ({"tokens": [B, S] int}), moved
to the model's device. The sharding specs, `train_step`, `loss` and the
optimizers come with the training slice (ROADMAP A9).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import transformer as tfm

__all__ = ["LMModel"]


class LMModel(nn.Module):
    """Step functions for one architecture on one device (CUDA unless
    `device` names another; raises without a card)."""

    def __init__(self, cfg: ArchConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = self.init_params(seed)

    def init_params(self, seed: int) -> tfm.LMParams:
        """Fresh weights drawn from `seed` on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return tfm.init_params(self.cfg, generator=gen, device=self.device)

    def init_cache(self, B: int, T: int) -> list:
        return tfm.init_cache(self.cfg, B, T, device=self.device)

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    @torch.no_grad()
    def prefill_step(self, batch):
        logits, caches, _ = tfm.forward_full(
            self.params, self.cfg, self._batch(batch), want_cache=True,
            last_only=True)
        return logits[:, -1], caches

    @torch.no_grad()
    def decode_step(self, cache, batch, pos: int):
        return tfm.forward_decode(self.params, self.cfg, cache,
                                  self._batch(batch), int(pos))
