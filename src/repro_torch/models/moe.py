"""Mixture-of-Experts with capacity-bounded, sort-free dispatch.

A copy of the JAX package's `repro.models.moe` on tensors. Dispatch is
"token-choice with per-expert top-C": the router gives a [N, E] gate
matrix (top-k per token, f32); each expert then takes its top-C tokens by
gate (two top-k ops, no [N, E, C] one-hot, no sort), runs its SwiGLU on
them as one batched product over the experts, and the gated outputs are
added back at their tokens. Tokens past an expert's capacity are
dropped; spare capacity slots take zero-gate tokens, which add 0.
`torch.topk` and XLA's `top_k` may pick other zero-gate tokens for those
slots: the outputs and gradients do not depend on which.

The combine adds one expert at a time, in ascending order (`index_add_`
of that expert's C distinct rows, so no two writes meet): a token's
contributions are rounded in the order of JAX's scatter-add, and the
result is the same on every run (one `index_add_` over all experts at
once would add with atomics on CUDA, in an order that varies).

DeepSeek-V3's refinements, as in JAX: node-limited group routing
(`n_groups`, `group_top`: tokens restricted to the `group_top` expert
groups with the largest sum of their top-2 scores) and a low-precision
dispatch (`dispatch_dtype`: the dispatched tokens rounded through that
dtype, then the experts run in the model's).

On a mesh (`ctx`, a `shard.ShardCtx`), JAX's layout: the experts over
'data', each expert's d_ff over 'model', the shared expert's d_ff over
'model'. JAX states it with sharding constraints and GSPMD moves the
tokens (an all-to-all); here every rank routes the whole microbatch
(its rows gathered over the dp axes, its positions over 'model'), so the
gates, the capacity and each expert's top-C tokens are the same bits on
every rank and as one device's. A rank runs its experts on their
tokens over its d_ff columns, the partial sums are added over 'model',
and the experts' outputs [E, C, d] are all-gathered over 'data'. The
gates are applied after the gather and the combine is the one-device
one: every rank adds every expert in ascending order, then keeps its
rows and positions. The router reads its input whole, so its gradient
is whole on every rank (`ShardCtx.enter_pair`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import shard as sh
from .layers import dense_init, mlp_apply, mlp_init

__all__ = ["moe_init", "moe_apply", "capacity"]


def capacity(n_tokens: int, cfg_moe) -> int:
    c = int(math.ceil(n_tokens * cfg_moe.top_k * cfg_moe.capacity_factor
                      / cfg_moe.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def moe_init(d: int, moe, dtype, *, generator: torch.Generator,
             device=None) -> dict:
    """The router (f32 [d, E]), the experts' SwiGLU weights ([E, d, F],
    [E, d, F], [E, F, d]) and, with `n_shared`, a shared SwiGLU MLP of
    width F x n_shared (a nested group, "shared")."""
    E, Fe = moe.n_experts, moe.d_ff_expert
    kw = dict(dtype=dtype, generator=generator, device=device)
    p = {"router": dense_init((d, E), dtype=torch.float32,
                              generator=generator, device=device),
         "wg": dense_init((E, d, Fe), in_axis_size=d, **kw),
         "wu": dense_init((E, d, Fe), in_axis_size=d, **kw),
         "wd": dense_init((E, Fe, d), in_axis_size=Fe, **kw)}
    if moe.n_shared:
        p["shared"] = mlp_init(d, Fe * moe.n_shared, "swiglu", **kw)
    return p


def _route(x_flat, p, moe):
    """(dense gate matrix [N, E], f32, zeros off each token's top-k; the
    Switch-style load-balance aux loss)."""
    logits = x_flat.float() @ p["router"]                       # [N, E]
    if moe.router == "sigmoid":                                 # DeepSeek-V3
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    N, E = scores.shape
    if moe.n_groups and moe.group_top:
        # node-limited routing: score each expert group by the sum of its
        # top-2 affinities, keep only the top `group_top` groups
        g = scores.reshape(N, moe.n_groups, E // moe.n_groups)
        gscore = torch.topk(g, min(2, g.shape[-1]), dim=-1).values.sum(-1)
        gidx = torch.topk(gscore, moe.group_top, dim=-1).indices
        gmask = torch.zeros_like(gscore).scatter(1, gidx, 1.0)
        scores = (g * gmask[..., None]).reshape(N, E)
    top_vals, top_idx = torch.topk(scores, moe.top_k, dim=-1)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    gates = torch.zeros_like(scores).scatter(1, top_idx, top_vals)
    me = (gates > 0).float().mean(dim=0)      # fraction routed per expert
    pe = scores.mean(dim=0)                   # mean router prob per expert
    aux = E * torch.sum(me * pe)
    return gates, aux


def _expert_ffn(xe, p):
    """xe [E, C, d] -> [E, C, d], each expert's SwiGLU as one batched
    product."""
    h = F.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
    return torch.bmm(h, p["wd"])


def _dispatch(x_flat, idx, moe, dtype):
    """The experts' tokens [E', C, d] (x_flat's rows at idx [E', C]), in
    the model's dtype after the dispatch's rounding."""
    xe = x_flat[idx]
    if moe.dispatch_dtype != "bfloat16":
        # DeepSeek-V3-style low-precision dispatch; the experts run in the
        # model's dtype
        xe = xe.to(getattr(torch, moe.dispatch_dtype))
    return xe.to(dtype)


def _combine(ye, vals, idx, N):
    """The gated expert outputs added at their tokens: [N, d]."""
    ye = ye * vals[..., None].to(ye.dtype)
    out = torch.zeros((N, ye.shape[-1]), dtype=ye.dtype, device=ye.device)
    for e in range(ye.shape[0]):       # ascending: JAX's order, no atomics
        out.index_add_(0, idx[e], ye[e])
    return out


def moe_apply(x, p, moe, ctx=None):
    """x [B, S, d] -> ([B, S, d], aux loss (f32 scalar)). With `ctx` (a
    mesh): x and the output are this rank's rows and positions of the
    residual stream, `p` this rank's shards; aux is the whole
    microbatch's, the same on every rank."""
    if ctx is not None:
        return _moe_mesh(x, p, moe, ctx)
    B, S, d = x.shape
    N = B * S
    x_flat = x.reshape(N, d)
    gates, aux = _route(x_flat, p, moe)                         # [N, E]
    C = min(capacity(N, moe), N)   # decode: a single token caps capacity
    # per-expert top-C tokens (spare slots take zero-gate tokens: they add 0)
    vals, idx = torch.topk(gates.T, C, dim=-1)                  # [E, C]
    ye = _expert_ffn(_dispatch(x_flat, idx, moe, x.dtype), p)   # [E, C, d]
    out = _combine(ye, vals, idx, N)
    if "shared" in p:
        out = out + mlp_apply(x_flat, p["shared"], "swiglu")
    return out.reshape(B, S, d), aux


def _moe_mesh(x, p, moe, ctx):
    """`moe_apply` on this rank of a mesh (the module's docstring).
    'model' splits the experts' d_ff where `ctx.split["ffn_expert"]`,
    'data' the experts where `ctx.split["expert"]`; a dimension the specs
    leave whole is computed whole."""
    split, mesh = ctx.split, ctx.mesh
    f_split = ctx.tp > 1 and split["ffn_expert"]
    e_split = split["expert"] and mesh.shape["data"] > 1
    # the whole microbatch: rows over the dp axes, then positions over
    # 'model' (one view for d_ff columns, one read whole)
    h_part, h_whole = ctx.enter_pair(ctx.gather_rows(x))
    B, S, d = h_whole.shape
    N = B * S
    gates, aux = _route(h_whole.reshape(N, d), p, moe)          # [N, E]
    C = min(capacity(N, moe), N)
    vals, idx = torch.topk(gates.T, C, dim=-1)                  # [E, C]
    xin = (h_part if f_split else h_whole).reshape(N, d)
    mine = idx
    if e_split:
        n_loc = p["wg"].shape[0]
        e0 = mesh.index("data") * n_loc
        xin, mine = ctx.experts_in(xin), idx[e0:e0 + n_loc]
    ye = _expert_ffn(_dispatch(xin, mine, moe, x.dtype), p)     # [E', C, d]
    if f_split:
        ye = sh.reduce_from(ye, mesh, "model")
    if e_split:
        ye = ctx.experts_out(ye)                                # [E, C, d]
    out = ctx.leave(ctx.rows(_combine(ye, vals, idx, N).reshape(B, S, d)),
                    False)
    if "shared" in p:
        s_split = ctx.tp > 1 and split["shared"]
        hs = ctx.rows(h_part if s_split else h_whole)
        out = out + ctx.leave(mlp_apply(hs, p["shared"], "swiglu"), s_split)
    return out, aux
