"""LMModel: the public step API (serving and training).

The JAX package's `repro.models.LMModel` as an `nn.Module` that owns its
weights (`self.params`, a `transformer.LMParams`), so the steps take no
`params` argument; each returns what the JAX step returns:

- `prefill_step(batch)` -> (logits [B, V] at the last position, caches:
  one (k, v) [B, S, K, hd] pair per attention layer, one (ckv [B, S, r],
  k_rope [B, S, rope]) pair per MLA layer, and each recurrent layer's
  final f32 state, {"h", "conv"} for RG-LRU or {"s", "x_tm", "x_cm"} for
  RWKV-6, as `init_cache` lays it out). On CUDA tensors every attention
  layer runs the `flash_attention` kernel (an MLA layer its q/k width 192
  over v width 128 instance); the recurrences and
  the MoE layers' routing, expert products and combine are plain PyTorch
  on every device. The head (`lnf`, `unembed`)
  runs on the last position only: the same values as the JAX step's
  `logits[:, -1]`, without its [B, S, V] f32 tensor;
- `decode_step(cache, batch, pos)` -> (logits [B, 1, V], cache), the cache
  (bf16, or int8 codes and scales with `kv_cache_dtype="int8"`; MLA's
  latent {"ckv", "krope"}, read by the absorbed-matrix decode in plain
  PyTorch) written in place at `pos`, each recurrent layer's state
  replaced in place;
- `loss(batch)` -> (loss + 0.01 aux, {"loss", "aux"}), differentiable
  (aux: the MoE layers' summed load-balance loss, 0 without MoE);
- `train_step(opt_state, batch)` -> (opt_state, {"loss", "aux",
  "grad_norm"}): gradients of `min(cfg.microbatch, B)`-row microbatches
  summed in `cfg.grad_accum_dtype` and divided by their count, then one
  AdamW or Adafactor update (`cfg.optimizer`) written into `self.params`
  in place; the metrics are the microbatches' means, as in JAX. A leaf
  the loss does not read (`embed` under `embed_inputs`) gets a zero
  gradient, as JAX's autodiff gives it. AdamW's
  state is keyed like the weights; Adafactor's, whose factors and update
  clipping span a stacked leaf, by the JAX tree's paths with the pattern
  stacked (`convert.jax_paths`). On CUDA
  tensors every attention layer runs the `flash_attention` kernel
  twice (the forward and its recomputation under remat) and its backward
  kernel once a microbatch (with gemma2's window, soft-cap and head width
  256 too; an MLA layer at q/k width 192 over v width 128).

Inputs are dicts of tensors or numpy arrays ({"tokens": [B, S] int}, or
with `embed_inputs` {"embeddings": [B, S, d], "labels": [B, S] int}, and
{"positions": [B, 3, S] int} for M-RoPE, as `data.batch_for` gives
them), moved to the model's device. One device: `zero1`, `seq_parallel` and `pure_dp`
act on a mesh only, so they change nothing here (as in JAX with
`mesh=None`); the sharding specs come with ROADMAP A9.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..optim import (adafactor_init, adafactor_update, adamw_init,
                     adamw_update)
from . import transformer as tfm
from .convert import jax_paths, unstack_paths

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

    # ---- training ---------------------------------------------------------
    def _weights(self) -> dict:
        return dict(self.params.named_parameters())

    def _adafactor(self) -> bool:
        return self.cfg.optimizer == "adafactor"

    def init_opt(self):
        """Fresh optimizer state for `cfg.optimizer` over the weights."""
        w = {k: p.detach() for k, p in self._weights().items()}
        if self._adafactor():
            return adafactor_init(jax_paths(w, self.cfg))
        return adamw_init(w)

    def loss(self, batch):
        return tfm.loss_fn(self.params, self.cfg, self._batch(batch))

    def train_step(self, opt_state, batch):
        cfg = self.cfg
        b = self._batch(batch)
        B = b["embeddings" if cfg.embed_inputs else "tokens"].shape[0]
        mb = min(cfg.microbatch, B)
        if B % mb:
            raise ValueError(f"batch {B} is not a multiple of the "
                             f"microbatch {mb}")
        n_micro = B // mb
        acc_dt = getattr(torch, cfg.grad_accum_dtype)
        weights = self._weights()
        acc, losses, auxes = None, [], []
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in b.items()}
            total, metrics = tfm.loss_fn(self.params, cfg, micro)
            grads = torch.autograd.grad(total, list(weights.values()),
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, weights.values())]
            if acc is None:
                acc = [g.to(acc_dt) for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a += g.to(acc_dt)
            del grads, total
            losses.append(metrics["loss"].detach())
            auxes.append(metrics["aux"].detach())
        grads = {k: a.div_(n_micro) for k, a in zip(weights, acc)}
        del acc
        params = {k: p.detach() for k, p in weights.items()}
        if self._adafactor():
            new, opt_state, gn = adafactor_update(
                jax_paths(grads, cfg), opt_state, jax_paths(params, cfg))
            new = unstack_paths(new, cfg)
        else:
            new, opt_state, gn = adamw_update(grads, opt_state, params)
        del grads, params
        with torch.no_grad():
            for k, p in weights.items():
                p.copy_(new.pop(k))
        return opt_state, {"loss": torch.stack(losses).mean(),
                           "aux": torch.stack(auxes).mean(),
                           "grad_norm": gn}
