"""Recurrent token mixers: RWKV-6 "Finch" and RG-LRU (RecurrentGemma/Griffin).

A copy of the JAX package's `repro.models.ssm` on tensors, with the same
numerics (f32 recurrences and gates, the model's dtype elsewhere) and the
same leaves, so a JAX parameter tree carries over leaf for leaf
(`models.convert`; RWKV's `mu` and `lora_b` are dicts of five leaves).

RWKV-6: data-dependent per-channel decay w_t, token-shift lerp with a
shared LoRA, per-head wkv state S [dk, dv]. A full sequence runs in
chunks of `cfg.rec.chunk` tokens: within a chunk every (t, s) pair
interacts through log-space decay ratios (JAX's `_wkv_chunk` formula),
the state carries the rest from one chunk into the next in order, as
JAX's `lax.scan` does. The chunks' own terms are computed 16 at a time
(`_wkv_chunks`), so the host issues a few launches a chunk, not ~25.

RG-LRU: h_t = a_t·h_{t-1} + sqrt(1-a_t^2)·(i_t ⊙ u_t) with a_t a
data-dependent diagonal decay. JAX runs `lax.associative_scan` over the
(a, b) composition monoid; here `_linear_scan` composes the same monoid
in log2(S) doubling steps (another association order: the same values to
f32 rounding).

No Pallas kernel lies behind either scan in the JAX package, so both run
as plain PyTorch on every device. Both expose single-step decode with a
constant-size state; `models.transformer` writes the new state into the
layer's cache dict. The full-sequence functions return states that own
their storage (copies, as JAX's jitted slices are): a view of the last
position would keep the whole [B, S, ·] activation alive.

On a mesh whose 'model' axis splits a mixer's weights (`ctx`, a
`shard.ShardCtx`; `LMModel`'s specs are JAX's), each rank runs its
columns, as GSPMD lays JAX's out: RG-LRU its `lru_width` columns (the
gates' [w, w] products read u whole, gathered over 'model' by
`ShardCtx.gather_cols`, whose backward sums the ranks' parts), RWKV-6
its d_model columns, which are its wkv heads (the decay LoRA's 64
columns gathered before `wb`; where 'model' cuts a head, r, k and v are
gathered and every rank runs every head, then keeps its columns after
the group norm), and its channel mix's d_ff columns (the receptance
gate gathered, since it multiplies a sum over them). A leaf every rank
holds whole (biases, Λ, the token-shift LoRA, u, the group norm) is
read for this rank's columns or heads (`ShardCtx.own`). The output is
this rank's part of the sum over 'model', and a recurrent state is
this rank's piece in `models.model.cache_specs`' layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init

__all__ = ["rwkv_init", "rwkv_time_mix", "rwkv_channel_mix", "rwkv_decode",
           "rwkv_init_state", "rglru_init", "rglru_apply", "rglru_decode",
           "rglru_init_state"]


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

_MIXES = ("r", "k", "v", "g", "w")


def rwkv_init(cfg, dtype, *, generator: torch.Generator, device=None) -> dict:
    d = cfg.d_model
    dk = cfg.rec.head_dim
    H = d // dk
    f = cfg.d_ff
    lora = 32
    kw = dict(dtype=dtype, generator=generator, device=device)
    f32 = dict(dtype=torch.float32, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        # token-shift mixing: base mus + shared-A LoRA
        "mu_x": zeros(d),
        "mu": {m: zeros(d) for m in _MIXES},
        "lora_a": dense_init((d, lora), **kw),
        "lora_b": {m: dense_init((lora, d), in_axis_size=lora, **kw)
                   for m in _MIXES},
        "wr": dense_init((d, d), **kw),
        "wk": dense_init((d, d), **kw),
        "wv": dense_init((d, d), **kw),
        "wg": dense_init((d, d), **kw),
        # decay: w_t = exp(-exp(w0 + tanh(x_w A_w) B_w))
        "w0": torch.full((d,), -6.0, **f32),
        "wa": dense_init((d, 64), **kw),
        "wb": dense_init((64, d), in_axis_size=64, **kw),
        "u": torch.zeros((H, dk), **f32),           # current-token bonus
        "ln_w": torch.ones((d,), dtype=dtype, device=device),
        "ln_b": zeros(d),
        "wo": dense_init((d, d), **kw),
        # channel mix
        "cm_mu_k": zeros(d), "cm_mu_r": zeros(d),
        "cm_wk": dense_init((d, f), **kw),
        "cm_wv": dense_init((f, d), in_axis_size=f, **kw),
        "cm_wr": dense_init((d, d), **kw),
    }


def _shift(x, x_prev=None):
    """[B,S,d] -> previous token (zeros / carried state at t=0)."""
    pad = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _token_shift(x, xs, p):
    delta = xs - x
    xxx = x + delta * p["mu_x"]
    a = torch.tanh(xxx @ p["lora_a"])
    return {m: x + delta * (p["mu"][m] + a @ p["lora_b"][m]) for m in _MIXES}


def _split(ctx, mixer: str):
    """`ctx` where 'model' splits the mixer's weights, else None."""
    return ctx if ctx is not None and ctx.sharded(mixer) else None


def _own(p, names, ctx) -> tuple:
    """Leaves every rank holds whole, cut to this rank's columns on a
    mesh (`ctx`), else as they are."""
    return tuple(p[n] if ctx is None else ctx.own(p[n]) for n in names)


def _decay(xw, p, ctx=None, own=False):
    """log w_t (<= 0), f32. With `ctx`: the LoRA's hidden layer gathered
    where 'model' splits `wa`'s columns; with `own`, this rank's columns
    of the result, else all d."""
    a = torch.tanh(xw.float() @ p["wa"].float())
    if ctx is not None and p["wa"].shape[1] != p["wb"].shape[0]:
        a = ctx.gather_cols(a)
    w0, wb = _own(p, ("w0", "wb"), ctx if own else None)
    return -torch.exp(w0 + a @ wb.float())


def _group_norm(x, w, b, H, eps=1e-5):
    """Per-head LayerNorm of the wkv output ([..., H, dk] flattened to d);
    the population variance, as `jnp.var`."""
    shp = x.shape
    xg = x.reshape(*shp[:-1], H, shp[-1] // H).float()
    mu = xg.mean(-1, keepdim=True)
    var = xg.var(-1, keepdim=True, correction=0)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(shp) * w.float() + b.float()).to(x.dtype)


def _wkv_chunks(r, k, v, wlog, u, s0):
    """n chunks of the wkv recurrence side by side (all f32): each chunk's
    terms by JAX's `_wkv_chunk` formula, then the states carried from one
    chunk into the next in order, as its `lax.scan` does.
    r,k,v: [B,n,C,H,dk]; wlog: [B,n,C,H,dk] (log decay, <=0); u: [H,dk];
    s0: [B,H,dk,dv]. Returns (out [B,n,C,H,dv], the state after chunk n)."""
    C = r.shape[2]
    lp = torch.cumsum(wlog, dim=2)                      # log w_1..t (incl.)
    lpx = lp - wlog                                     # log w_1..t-1 (excl.)
    # intra-chunk: token s reaches output t>s through decay w_{s+1}..w_{t-1}
    # (an exponent <= 0). For t <= s the exponent is >= 0 and can overflow:
    # it is set to -inf before exp, so that the masked ratio is 0 with a 0
    # gradient (JAX's where after exp gives the same values, but 0 x inf =
    # NaN in its gradient). A clamp at 0 would keep the values too, but cut
    # the gradient where rounding leaves t = s + 1's exponent just above 0.
    tri = (torch.arange(C, device=r.device)[:, None]
           > torch.arange(C, device=r.device)[None, :])[:, :, None, None]
    ratio = torch.exp((lpx[:, :, :, None] - lp[:, :, None, :]).masked_fill(
        ~tri, float("-inf")))                       # [B,n,C,C,H,dk] (t,s)
    # einsum("bthk,btshk,bshk->bths", r, ratio, k) by broadcasting: the
    # 3-operand einsum would copy the ratios into its batched layout
    scores = (r[:, :, :, None] * ratio * k[:, :, None]).sum(-1)
    o_intra = torch.einsum("bntsh,bnshv->bnthv", scores, v)
    o_diag = torch.einsum("bnthk,hk,bnthk->bnth", r, u, k)[..., None] * v
    # state update: S1 = diag(P_C) S0 + sum_s (k_s ⊙ P_C/P_s)^T v_s
    pc = torch.exp(lp[:, :, -1])                        # [B,n,H,dk]
    kfac = k * torch.exp(lp[:, :, -1:] - lp)            # k_s ⊙ P_C / P_s
    kv = torch.einsum("bnshk,bnshv->bnhkv", kfac, v)
    states, s = [], s0
    for c in range(r.shape[1]):
        states.append(s)
        s = pc[:, c, ..., None] * s + kv[:, c]
    # carry-in: token i<=0 reaches output t through decay w_1..w_{t-1}
    rp = r * torch.exp(lpx)
    o_carry = torch.einsum("bnchk,bnhkv->bnchv", rp, torch.stack(states, 1))
    return o_carry + o_intra + o_diag, s


# chunks computed side by side in rwkv_time_mix: 16 of 64 tokens hold their
# [B, 16, 64, 64, H, dk] f32 decay ratios in 1.07 GB at B 2 and rwkv6's
# 32 x 64 heads (all of a 2 x 8192 sequence's chunks would take 8.6 GB);
# one chunk at a time made the host issue ~25 launches a chunk, which set
# the time of a training step
_CHUNKS_SIDE_BY_SIDE = 16


def _wkv(r, k, v, wlog, u, s):
    """The wkv recurrence over a sequence's chunks, _CHUNKS_SIDE_BY_SIDE at
    a time. r,k,v,wlog: [B,n,C,H,dk]; s: the state before the first.
    Returns (out [B,n,C,H,dv], the state after the last)."""
    outs = []
    for c0 in range(0, r.shape[1], _CHUNKS_SIDE_BY_SIDE):
        part = slice(c0, c0 + _CHUNKS_SIDE_BY_SIDE)
        o, s = _wkv_chunks(r[:, part], k[:, part], v[:, part], wlog[:, part],
                           u, s)
        outs.append(o)
    return torch.cat(outs, dim=1), s


def _heads(mixed, p, cfg, ctx):
    """The time mix's per-token terms of the heads this rank runs: (r, k,
    v [B, S, H', dk] f32, g [B, S, d'], log w [B, S, H', dk], u [H', dk],
    the group norm's weight and bias [H' dk], whether 'model' cuts a
    head). One device, or a head 'model' cuts (then r, k and v are
    gathered and H' is every head): H' = H; else this rank's H / tp."""
    B, S, _ = mixed["r"].shape
    dk = cfg.rec.head_dim
    r, k, v = (mixed[m] @ p["w" + m] for m in ("r", "k", "v"))
    g = F.silu(mixed["g"] @ p["wg"])
    cut = ctx is not None and r.shape[-1] % dk != 0
    if cut:
        r, k, v = (ctx.gather_cols(t) for t in (r, k, v))
    own = ctx is not None and not cut
    wlog = _decay(mixed["w"], p, ctx, own=own)
    u = ctx.own(p["u"], 0) if own else p["u"]
    ln_w, ln_b = _own(p, ("ln_w", "ln_b"), ctx if own else None)
    H = r.shape[-1] // dk
    r, k, v, wlog = (t.reshape(B, S, H, dk) for t in (r, k, v, wlog))
    return r.float(), k.float(), v.float(), g, wlog, u, ln_w, ln_b, cut


def rwkv_time_mix(x, p, cfg, x_prev=None, s0=None, ctx=None):
    """Full-sequence RWKV-6 time mix. Returns (out, (x_last, s_final));
    on a mesh (`ctx`) out is this rank's part of the sum over 'model' and
    s_final its heads' (every head's where 'model' cuts one)."""
    B, S, _ = x.shape
    C = min(cfg.rec.chunk, S)
    if S % C:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {C}")
    ctx = _split(ctx, "rwkv")
    mixed = _token_shift(x, _shift(x, x_prev), p)
    r, k, v, g, wlog, u, ln_w, ln_b, cut = _heads(mixed, p, cfg, ctx)
    H, dk = r.shape[2], r.shape[3]
    r, k, v, wlog = (t.reshape(B, S // C, C, H, dk) for t in (r, k, v, wlog))
    s0 = (torch.zeros((B, H, dk, dk), dtype=torch.float32, device=x.device)
          if s0 is None else s0)
    o, s = _wkv(r, k, v, wlog, u, s0)
    o = o.reshape(B, S, H * dk)
    o = _group_norm(o.to(x.dtype), ln_w, ln_b, H)
    if cut:
        o = ctx.own(o)
    out = (o * g) @ p["wo"]
    return out, (x[:, -1].clone(), s)


def rwkv_channel_mix(x, p, x_prev=None, ctx=None):
    """(out, x_last). On a mesh (`ctx`) k's d_ff columns are this rank's,
    so `k @ cm_wv` is its part of the sum over 'model', and the
    receptance gate it multiplies is gathered whole from this rank's d
    columns: out is this rank's part of the sum."""
    ctx = _split(ctx, "rwkv")
    xs = _shift(x, x_prev)
    xk = x + (xs - x) * p["cm_mu_k"]
    xr = x + (xs - x) * p["cm_mu_r"]
    k = torch.square(torch.relu(xk @ p["cm_wk"]))
    gate = torch.sigmoid(xr @ p["cm_wr"])
    if ctx is not None:
        gate = ctx.gather_cols(gate)
    out = gate * (k @ p["cm_wv"])
    return out, x[:, -1].clone()


def rwkv_init_state(cfg, B: int, device=None) -> dict:
    d = cfg.d_model
    dk = cfg.rec.head_dim
    H = d // dk
    f32 = dict(dtype=torch.float32, device=device)
    return {"s": torch.zeros((B, H, dk, dk), **f32),
            "x_tm": torch.zeros((B, d), **f32),
            "x_cm": torch.zeros((B, d), **f32)}


def rwkv_decode(x, p, cfg, state, ctx=None):
    """Single-token step. x [B,1,d]; state {"s","x_tm","x_cm"}. Returns
    (time-mix output [B,1,d], the new state; its "x_cm" is the old one:
    the block's channel mix replaces it). On a mesh (`ctx`) as
    `rwkv_time_mix`: "s" holds this rank's heads (every head where
    'model' cuts one), "x_tm" and "x_cm" all d."""
    B = x.shape[0]
    ctx = _split(ctx, "rwkv")
    xt = x[:, 0].float()
    mixed = _token_shift(x, state["x_tm"][:, None].to(x.dtype), p)
    r, k, v, g, wlog, u, ln_w, ln_b, cut = _heads(mixed, p, cfg, ctx)
    r, k, v, g = r[:, 0], k[:, 0], v[:, 0], g[:, 0]
    w = torch.exp(wlog[:, 0])
    s = state["s"]
    # o_t = r·(u ⊙ (k ⊗ v) + S)
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    o = torch.einsum("bhk,bhkv->bhv", r, s + u[None, :, :, None] * kv)
    s_new = w[..., None] * s + kv
    o = _group_norm(o.reshape(B, -1).to(x.dtype), ln_w, ln_b, r.shape[1])
    if cut:
        o = ctx.own(o)
    out_tm = ((o * g) @ p["wo"])[:, None]
    return out_tm, {"s": s_new, "x_tm": xt, "x_cm": state["x_cm"]}


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin recurrent block)
# ---------------------------------------------------------------------------

def rglru_init(cfg, dtype, *, generator: torch.Generator,
               device=None) -> dict:
    d = cfg.d_model
    w = cfg.rec.lru_width or d
    cw = cfg.rec.conv_width
    kw = dict(dtype=dtype, generator=generator, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wx": dense_init((d, w), **kw),     # recurrent branch
        "wy": dense_init((d, w), **kw),     # gate branch
        "conv_w": dense_init((cw, w), **kw),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "wa": dense_init((w, w), **kw),     # recurrence gate
        "ba": torch.zeros((w,), **f32),
        "wi": dense_init((w, w), **kw),     # input gate
        "bi": torch.zeros((w,), **f32),
        "lam": torch.full((w,), 3.0, **f32),           # Λ (softplus)
        "wo": dense_init((w, d), in_axis_size=w, **kw),
    }


_C_RGLRU = 8.0


def _causal_conv(u, w, b, state=None):
    """Depthwise causal conv1d. u [B,S,w]; w [cw, w]; state [B, cw-1, w].
    The taps are summed in JAX's order, in u's dtype; the new state is the
    last cw-1 inputs in u's dtype."""
    cw = w.shape[0]
    S = u.shape[1]
    pad = (torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype,
                       device=u.device)
           if state is None else state.to(u.dtype))
    up = torch.cat([pad, u], dim=1)
    out = up[:, 0:S] * w[0]
    for i in range(1, cw):
        out = out + up[:, i:i + S] * w[i]
    return out + b, up[:, -(cw - 1):]


def _rglru_gates(u, p, ctx=None):
    """(a, b) of the recurrence; on a mesh (`ctx`) u holds this rank's
    columns, and the [w, w] gates read it whole."""
    uf = u.float()
    uw = uf if ctx is None else ctx.gather_cols(u).float()
    ba, bi, lam = _own(p, ("ba", "bi", "lam"), ctx)
    r = torch.sigmoid(uw @ p["wa"].float() + ba)
    i = torch.sigmoid(uw @ p["wi"].float() + bi)
    log_a = -_C_RGLRU * r * F.softplus(lam)             # [B,S,w] (<= 0)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    return a, b


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: the (a, b)
    monoid composed in log2(S) doubling steps (b_t += a_t b_{t-k}, then
    a_t *= a_t a_{t-k}, k = 1, 2, 4, ...), out of place for autograd."""
    S = a.shape[1]
    k = 1
    while k < S:
        b = torch.cat([b[:, :k], b[:, k:] + a[:, k:] * b[:, :-k]], dim=1)
        if 2 * k < S:
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def rglru_apply(x, p, cfg, state=None, ctx=None):
    """Full-sequence recurrent block. Returns (out, {"h", "conv"}); on a
    mesh (`ctx`) out is this rank's part of the sum over 'model' and the
    state its `lru_width` columns."""
    ctx = _split(ctx, "rec")
    u0 = x @ p["wx"]
    gate = F.gelu(x @ p["wy"], approximate="tanh")
    conv_state = None if state is None else state["conv"]
    u, conv_new = _causal_conv(u0, *_own(p, ("conv_w", "conv_b"), ctx),
                               conv_state)
    a, b = _rglru_gates(u, p, ctx)
    if state is not None:
        # inject carried h0 through the first step: b_0 += a_0 * h0
        b = torch.cat([b[:, :1] + a[:, :1] * state["h"][:, None], b[:, 1:]],
                      dim=1)
    h = _linear_scan(a, b)
    out = (h.to(x.dtype) * gate) @ p["wo"]
    return out, {"h": h[:, -1].clone(),
                 "conv": conv_new.to(torch.float32, copy=True)}


def rglru_init_state(cfg, B: int, device=None) -> dict:
    w = cfg.rec.lru_width or cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((B, w), **f32),
            "conv": torch.zeros((B, cfg.rec.conv_width - 1, w), **f32)}


def rglru_decode(x, p, cfg, state, ctx=None):
    """Single-step. x [B,1,d]. Returns (out, the new {"h", "conv"}); on a
    mesh as `rglru_apply`."""
    ctx = _split(ctx, "rec")
    u0 = x @ p["wx"]
    gate = F.gelu(x @ p["wy"], approximate="tanh")
    u, conv_new = _causal_conv(u0, *_own(p, ("conv_w", "conv_b"), ctx),
                               state["conv"])
    a, b = _rglru_gates(u, p, ctx)
    h = a[:, 0] * state["h"] + b[:, 0]
    out = (h[:, None].to(x.dtype) * gate) @ p["wo"]
    return out, {"h": h, "conv": conv_new.float()}
