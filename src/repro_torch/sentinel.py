"""Sentinel-safe gathers: the torch spelling of ``jnp.take(..., mode="fill")``.

The layouts pad their id lists with a sentinel one past the end (``n`` for
vertex ids, ``cap_b`` / ``n_hi_cap`` / ``t_cap`` for slot and tile lists).
JAX drops or fills such ids silently; ``index_select`` and ``index_put_``
raise on them on the CPU and read or write out of bounds on CUDA. Every
site that meets a sentinel goes through one of two spellings instead:

  * a read clamps the id into range and masks the result (`take_fill`);
  * a write goes into a destination padded by one sink row at index ``n``
    (`with_sink`), which the caller slices off afterwards.
"""
from __future__ import annotations

import torch

__all__ = ["take_fill", "with_sink"]


def take_fill(x: torch.Tensor, ids: torch.Tensor, fill) -> torch.Tensor:
    """``x[ids]`` along dim 0, with ``fill`` wherever ``ids >= len(x)``."""
    cap = x.shape[0]
    shape = tuple(ids.shape) + tuple(x.shape[1:])
    got = x.index_select(0, ids.reshape(-1).clamp_max(cap - 1)).view(shape)
    live = (ids < cap).view(tuple(ids.shape) + (1,) * (x.dim() - 1))
    return torch.where(live, got, torch.full((), fill, dtype=x.dtype,
                                             device=x.device))


def with_sink(x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` with one extra row holding ``fill``: a write or read at id
    ``len(x)`` lands there instead of out of bounds."""
    return torch.cat([x, x.new_full((1,) + tuple(x.shape[1:]), fill)])
