"""Shared neural layers: norms, MLPs, rotary embeddings, initializers.

A copy of the JAX package's `repro.models.layers` on tensors, with the same
numerics:
  * parameters are dicts of tensors (the modules hold them in
    `nn.ParameterDict`s); compute dtype = the activations' dtype (bf16 by
    default), norm and softmax statistics in f32;
  * weights keep the JAX package's layouts ([d_in, ..., d_out]), so a
    JAX parameter tree carries over leaf for leaf (`models.convert`).
`dense_init` draws from a `torch.Generator`, which cannot reproduce
`jax.random`: tests carry the JAX weights across instead.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "rmsnorm", "layernorm", "norm_init", "apply_norm",
           "mlp_init", "mlp_apply", "rope_freqs", "apply_rope",
           "mrope_apply", "sinusoidal_positions", "softcap"]


def dense_init(shape, in_axis_size=None, dtype=torch.bfloat16, *,
               generator: torch.Generator, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±2, times
    1/sqrt(fan_in), drawn in f32 on `device` from `generator` (which lives
    on that device). Scaled in place: the largest leaves (DeepSeek-V3's
    [256, 7168, 2048] experts, 15 GB in f32) need no second f32 copy."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan_in))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype)


def rmsnorm(x, w, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def layernorm(x, w, b, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def norm_init(kind: str, d: int, dtype=torch.bfloat16, device=None) -> dict:
    if kind == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    # rmsnorm stores (scale - 1)
    return {"w": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(kind: str, x, p):
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def mlp_init(d: int, f: int, kind: str, dtype=torch.bfloat16, *,
             generator: torch.Generator, device=None) -> dict:
    kw = dict(dtype=dtype, generator=generator, device=device)
    if kind in ("swiglu", "geglu"):
        return {"wg": dense_init((d, f), **kw), "wu": dense_init((d, f), **kw),
                "wd": dense_init((f, d), in_axis_size=f, **kw)}
    return {"wu": dense_init((d, f), **kw),
            "wd": dense_init((f, d), in_axis_size=f, **kw)}


def mlp_apply(x, p, kind: str):
    if kind == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    elif kind == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wu"])
    else:  # gelu
        h = F.gelu(x @ p["wu"], approximate="tanh")
    return h @ p["wd"]


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    """Inverse frequencies [hd//2] (f32)."""
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x [..., S, H, hd]; positions broadcastable to [..., S] (int).
    Rotate-halves form (not interleaved), angles in f32, cast back."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)
    ang = positions.float()[..., None] * inv                   # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                         # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    return _rotate(x, cos, sin)


def mrope_apply(x, positions3, theta: float, sections=(16, 24, 24)):
    """Qwen2-VL M-RoPE: the hd/2 freq channels split into (t, h, w) groups,
    each rotated by its own position stream. x [B, S, H, hd]; positions3:
    [B, 3, S] (int). With three equal streams this is `apply_rope`."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not cover "
                         f"head width {hd}")
    inv = rope_freqs(hd, theta, x.device)                      # [hd/2]
    ang_all = positions3.float()[..., None] * inv              # [B,3,S,hd/2]
    parts, off = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[:, i, :, off:off + sec])
        off += sec
    ang = torch.cat(parts, dim=-1)                             # [B,S,hd/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    return _rotate(x, cos, sin)


def sinusoidal_positions(positions, d: int):
    """Classic transformer sinusoidal table for given positions [...]."""
    half = d // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap
