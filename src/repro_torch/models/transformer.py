"""Decoder stack: layer-kind dispatch, one block per layer, remat, loss.

A copy of the JAX package's `repro.models.transformer`, every layer kind:
the dense attention kinds (`attn`, `attn_local`, `attn_global`), with the
bf16 or int8 KV cache (`kv_cache_dtype`), the MoE kind `attn_moe`
(attention, then `models.moe` in place of the MLP), DeepSeek-V3's MLA
kinds `mla_dense` (MLA, then the MLP) and `mla_moe` (MLA, then the MoE
layer with its shared expert), and the recurrent kinds `rec` (RG-LRU with
its MLP) and `rwkv` (RWKV-6's time mix and its own channel mix,
`models.ssm`). The JAX package
stacks the repeated pattern on a leading axis and drives it with
`lax.scan` (small HLO, flat compile time); PyTorch runs eagerly, so here
the layout (prefix, pattern × repeats, suffix) is unrolled into an
`nn.ModuleList` with one block per layer, in layer order (`layer_kinds`).
Each block is an `nn.ModuleDict` of groups ("ln1", "mix", "ln2", "ffn",
and "pn1"/"pn2" with post-norms; an `rwkv` block has no "ffn") holding
the JAX package's leaves under the same names in `nn.ParameterDict`s,
nested where JAX's group nests dicts (RWKV's `mu` and `lora_b`, MoE's
"shared").

Inputs: {"tokens" [B, S]} looked up in `embed`, or, with
`embed_inputs` (the audio and vision configs, whose frontends are stubs),
{"embeddings" [B, S, d]} cast to the model's dtype; M-RoPE takes
{"positions" [B, 3, S]} where given, else three equal streams.
Sinusoidal positions are added to the inputs. `embed` stays a leaf
either way (the serve loop feeds generated tokens' rows), as in JAX.
The weights are trainable parameters; the serving steps run under
`torch.no_grad()`.

Caches: a full sequence returns each attention layer's (k, v), each MLA
layer's latent (ckv [B, S, r], k_rope [B, S, rope]) and each recurrent
layer's final state ({"h", "conv"} or {"s", "x_tm", "x_cm"}, f32), as
JAX's prefill does; `init_cache` gives one dict per layer ({"ckv",
"krope"} for MLA) and a decode step writes every layer's new k/v, latent
or state into it in place.

Remat as in JAX (`jax.checkpoint` around each block): when autograd
records the forward and no cache is wanted, each block runs under
`torch.utils.checkpoint` and only the layer-boundary activations (and
each MoE layer's aux loss) are kept; the backward runs the block's
forward again. `loss_fn` is JAX's next-token cross entropy plus 0.01 x
the MoE layers' summed aux loss (decode discards aux, as JAX does).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn
from . import ssm
from .layers import (apply_norm, dense_init, mlp_apply, mlp_init, norm_init,
                     sinusoidal_positions, softcap)
from .moe import moe_apply, moe_init

__all__ = ["LMParams", "init_block", "apply_block", "init_params",
           "layer_kinds", "forward_full", "forward_decode", "init_cache",
           "loss_fn", "KIND_MIXER"]

KIND_MIXER = {
    "attn": "attn", "attn_local": "attn", "attn_global": "attn",
    "attn_moe": "attn", "mla_dense": "mla", "mla_moe": "mla",
    "rwkv": "rwkv", "rec": "rec",
}


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_kinds(cfg) -> List[str]:
    """The kind of every layer, in order: prefix, pattern × repeats,
    suffix."""
    pre, pat, reps, suf = cfg.layer_kinds()
    return list(pre) + list(pat) * reps + list(suf)


def _weights(tensors: dict) -> nn.ParameterDict:
    """A group of leaves as parameters; a nested dict (RWKV's `mu` and
    `lora_b`) becomes a nested group, read as `p["mu"]["r"]`, its
    state-dict keys "mix.mu.r" as JAX's tree paths."""
    return nn.ParameterDict({k: _weights(v) if isinstance(v, dict)
                             else nn.Parameter(v) for k, v in tensors.items()})


def _write(cache: dict, state: dict) -> dict:
    """A decode step's new recurrent state, copied into the layer's cache
    dict in place (the serve loop keeps the dict it passed in)."""
    for k, v in state.items():
        cache[k].copy_(v)
    return cache


# ---------------------------------------------------------------------------
# Per-block init / apply
# ---------------------------------------------------------------------------

def init_block(cfg, kind: str, *, generator: torch.Generator,
               device=None) -> nn.ModuleDict:
    dt = _dtype(cfg)
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    mixer = KIND_MIXER[kind]
    p = nn.ModuleDict()
    p["ln1"] = _weights(norm_init(cfg.norm, d, dt, device))
    if mixer == "rwkv":
        p["mix"] = _weights(ssm.rwkv_init(cfg, dt, **kw))
        p["ln2"] = _weights(norm_init(cfg.norm, d, dt, device))
        return p                      # rwkv carries its own channel mix
    if mixer == "rec":
        p["mix"] = _weights(ssm.rglru_init(cfg, dt, **kw))
    elif mixer == "mla":
        p["mix"] = _weights(attn.mla_init(cfg, dt, **kw))
    else:
        p["mix"] = _weights(attn.attn_init(cfg, dt, **kw))
    p["ln2"] = _weights(norm_init(cfg.norm, d, dt, device))
    if kind.endswith("_moe"):
        p["ffn"] = _weights(moe_init(d, cfg.moe, dt, **kw))
    else:
        p["ffn"] = _weights(mlp_init(d, cfg.d_ff, cfg.mlp, dt, **kw))
    if cfg.post_norm:
        p["pn1"] = _weights(norm_init(cfg.norm, d, dt, device))
        p["pn2"] = _weights(norm_init(cfg.norm, d, dt, device))
    return p


def apply_block(p, x, cfg, kind: str, *, positions=None, cache=None,
                pos=None, ctx=None, t_split=False):
    """mode is implied: cache None => full-sequence; else one-token decode.
    Returns (x, new_cache, aux): after a full sequence (k, v), MLA's
    (ckv, k_rope) or the recurrent layer's final state; after a decode
    step the same cache dict, its k/v, latent or state written in place;
    aux the MoE layer's load-balance loss (f32), None for the other kinds
    (JAX's 0, without a device tensor a layer). `ctx` (a mesh,
    `shard.ShardCtx`): x holds this rank's rows (and, with sequence
    parallelism, its positions); every token mixer (attention, MLA,
    RG-LRU, RWKV-6's time and channel mixes) and the MLP run on this
    rank's heads or columns between `ctx.enter` and `ctx.leave` where
    'model' splits their weights (`ctx.sharded`), a MoE layer on the
    whole microbatch (rows gathered over the dp axes, positions over
    'model'), its experts over 'data' and their d_ff over 'model'
    (`moe.moe_apply`). A decode step's cache
    is this rank's piece of it (`t_split`: its T over 'model',
    `attention.attn_decode`, `attention.mla_decode`); a prefill's (k, v)
    hold every kv head whose weights this rank holds, a recurrent
    layer's state this rank's piece of it."""
    aux = None
    mixer = KIND_MIXER[kind]
    sharded = ctx is not None and ctx.sharded(mixer)

    def enter(h):
        return h if ctx is None else ctx.enter(h, sharded)

    def leave(o):
        return o if ctx is None else ctx.leave(o, sharded)

    h = enter(apply_norm(cfg.norm, x, p["ln1"]))
    if mixer == "rwkv":               # time mix + its own channel mix
        if cache is None:
            o, (x_tm, s_fin) = ssm.rwkv_time_mix(h, p["mix"], cfg, ctx=ctx)
            st = {"s": s_fin, "x_tm": x_tm.float()}
        else:
            o, st = ssm.rwkv_decode(h, p["mix"], cfg, cache, ctx=ctx)
        x = x + leave(o)
        h2 = enter(apply_norm(cfg.norm, x, p["ln2"]))
        o2, x_cm = ssm.rwkv_channel_mix(
            h2, p["mix"], ctx=ctx,
            x_prev=None if cache is None else cache["x_cm"].to(h2.dtype))
        st["x_cm"] = x_cm.float()
        return x + leave(o2), st if cache is None else _write(cache, st), aux
    if mixer == "rec":
        if cache is None:
            o, new_cache = ssm.rglru_apply(h, p["mix"], cfg, ctx=ctx)
        else:
            o, st = ssm.rglru_decode(h, p["mix"], cfg, cache, ctx=ctx)
            new_cache = _write(cache, st)
    elif mixer == "mla":
        if cache is None:
            o, new_cache = attn.mla_apply(h, p["mix"], cfg, positions)
        else:
            o, new_cache = attn.mla_decode(h, p["mix"], cfg, cache, pos,
                                           ctx=ctx, t_split=t_split)
    elif cache is None and ctx is not None:
        o, new_cache = attn.attn_apply(
            h, p["mix"], cfg, kind, positions,
            kv=ctx.kv_heads(p["mix"]["wq"].shape[1]),
            whole_kv=not torch.is_grad_enabled())
    elif cache is None:
        o, new_cache = attn.attn_apply(h, p["mix"], cfg, kind, positions)
    else:
        o, new_cache = attn.attn_decode(h, p["mix"], cfg, kind, cache, pos,
                                        ctx=ctx, t_split=t_split)
    o = leave(o)
    if cfg.post_norm:
        o = apply_norm(cfg.norm, o, p["pn1"])
    x = x + o
    h = apply_norm(cfg.norm, x, p["ln2"])
    if kind.endswith("_moe"):
        # on a mesh: routing and capacity span the whole microbatch
        f, aux = moe_apply(h, p["ffn"], cfg.moe, ctx=ctx)
    elif ctx is not None:
        f = ctx.leave(mlp_apply(ctx.enter(h, ctx.split["ffn"]), p["ffn"],
                                cfg.mlp), ctx.split["ffn"])
    else:
        f = mlp_apply(h, p["ffn"], cfg.mlp)
    if cfg.post_norm:
        f = apply_norm(cfg.norm, f, p["pn2"])
    return x + f, new_cache, aux


# ---------------------------------------------------------------------------
# Whole-model parameters / forward
# ---------------------------------------------------------------------------

class LMParams(nn.Module):
    """The model's weights: `embed` [V, d], `unembed` [d, V], `lnf`, and
    `blocks`, one per layer (kinds in `kinds`). `keep(key, leaf)`, where
    given, replaces each leaf as it is drawn (a mesh rank's shard of it),
    keyed as the state dict keys it."""

    def __init__(self, cfg, *, generator: torch.Generator, device=None,
                 keep: Optional[Callable] = None):
        super().__init__()
        dt = _dtype(cfg)
        kw = dict(dtype=dt, generator=generator, device=device)
        keep = keep or (lambda key, t: t)
        self.embed = nn.Parameter(keep(
            "embed", dense_init((cfg.vocab, cfg.d_model), **kw)))
        self.unembed = nn.Parameter(keep(
            "unembed", dense_init((cfg.d_model, cfg.vocab), **kw)))
        self.lnf = _weights({k: keep(f"lnf.{k}", v) for k, v in
                             norm_init(cfg.norm, cfg.d_model, dt,
                                       device).items()})
        self.kinds = tuple(layer_kinds(cfg))
        self.blocks = nn.ModuleList()
        for i, kind in enumerate(self.kinds):
            block = init_block(cfg, kind, generator=generator, device=device)
            for name, p in block.named_parameters():
                p.data = keep(f"blocks.{i}.{name}", p.data)
            self.blocks.append(block)


def init_params(cfg, *, generator: torch.Generator, device=None,
                keep: Optional[Callable] = None) -> LMParams:
    return LMParams(cfg, generator=generator, device=device, keep=keep)


def _embed_inputs(params, cfg, batch, ctx=None):
    if cfg.embed_inputs:
        x = batch["embeddings"].to(_dtype(cfg))
        if ctx is not None:
            x = ctx.local_seq(x)
    elif ctx is not None:
        x = ctx.embed(params.embed, batch["tokens"])
    else:
        x = params.embed[batch["tokens"].long()]
    if cfg.embed_scale:
        x = (x.float() * (cfg.d_model ** 0.5)).to(x.dtype)
    return x


def _positions(cfg, batch, B, S, device):
    """[B, 3, S] for M-RoPE (the batch's "positions" where given), else
    [B, S]."""
    if cfg.rope == "mrope":
        if "positions" in batch:
            return batch["positions"]
        return torch.arange(S, device=device).expand(B, 3, S)
    return torch.arange(S, device=device).expand(B, S)


def _block_out(p, x, cfg, kind, positions, ctx=None):
    """One block under remat: (x, aux); the cache is dropped."""
    x, _, aux = apply_block(p, x, cfg, kind, positions=positions, ctx=ctx)
    return x, aux


def _run_stack(params, cfg, batch, want_cache=False, ctx=None
               ) -> Tuple[torch.Tensor, list, torch.Tensor]:
    """Every block over the whole sequence: (x before `lnf`, each layer's
    (k, v) or recurrent state with `want_cache`, else [], the layers'
    summed aux loss). Without a cache, a forward that autograd records
    runs each block under `torch.utils.checkpoint` (whose recomputation
    runs a mesh rank's collectives again, in the same order on every
    rank)."""
    x = _embed_inputs(params, cfg, batch, ctx)
    B = x.shape[0]
    S = batch["embeddings" if cfg.embed_inputs else "tokens"].shape[1]
    positions = _positions(cfg, batch, B, S, x.device)
    if cfg.rope == "sinusoidal":
        table = sinusoidal_positions(torch.arange(S, device=x.device),
                                     cfg.d_model).to(x.dtype)[None]
        x = x + (table if ctx is None else ctx.local_seq(table))
    remat = torch.is_grad_enabled() and not want_cache
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(params.blocks, params.kinds):
        if remat:
            # the blocks draw no random numbers: no RNG state to keep
            x, a = checkpoint(_block_out, p, x, cfg, kind, positions, ctx,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, c, a = apply_block(p, x, cfg, kind, positions=positions,
                                  ctx=ctx)
            if want_cache:
                caches.append(c)
        if a is not None:
            aux = aux + a
    return x, caches, aux


def _head(params, cfg, x, ctx=None, whole=False):
    """Final norm, unembedding in the activations' dtype, then f32 logits
    (soft-capped where the config says so; the cap is element-wise, so a
    mesh rank applies it to its vocabulary's logits). With `whole` (a
    serving step on a mesh, under no_grad: x holds every position it
    needs) the logits are gathered to the whole batch over the whole
    vocabulary (`ShardCtx.whole_logits`)."""
    x = apply_norm(cfg.norm, x, params.lnf)
    if ctx is not None and not whole:
        x = ctx.enter(x, ctx.split["vocab"])
    logits = softcap((x @ params.unembed).float(), cfg.logit_softcap)
    return ctx.whole_logits(logits) if whole else logits


def forward_full(params, cfg, batch, *, want_cache=False, last_only=False,
                 ctx=None):
    """Returns (logits [B,S,V] f32, caches, aux). `caches` (with
    want_cache) is one (k, v) [B,S,K,hd] pair per attention layer, one
    (ckv [B,S,r], k_rope [B,S,rope]) pair per MLA layer and the final
    state dict of each recurrent one; `aux` the MoE layers' summed
    load-balance loss (f32, 0 without MoE). With `last_only` the head runs
    on the last position only (logits [B,1,V]: the same values, without
    the [B,S,V] tensor). With `ctx` (a mesh; `batch` this rank's rows)
    the logits are this rank's rows over every position and its
    vocabulary shard; with `last_only` too (a prefill), the whole batch's
    over the whole vocabulary, the same bits on every rank (under
    sequence parallelism the last position comes from the rank that holds
    it), and the caches this rank's rows and kv heads."""
    x, caches, aux = _run_stack(params, cfg, batch, want_cache, ctx)
    if last_only:
        x = x[:, -1:] if ctx is None else ctx.last_position(x)
    logits = _head(params, cfg, x, ctx, whole=last_only and ctx is not None)
    return logits, (caches if want_cache else None), aux


def loss_fn(params, cfg, batch, ctx=None):
    """Next-token cross entropy (mean over predicted positions) from the
    f32 logits, plus 0.01 x the MoE aux loss. Returns (loss +
    0.01 aux, {"loss", "aux"}). The label logit is gathered: the same value
    as the JAX package's one-hot contraction, which exists there only to
    keep a model-sharded vocab axis local.

    With `ctx` (training on a mesh; `batch` this rank's rows) the loss is
    this rank's share: its tokens' sum over the microbatch's token count
    (the shares sum to the loss over the dp axes), the logsumexp and the
    label logit reduced over a vocabulary sharded on 'model'
    (`ShardCtx.cross_entropy`: the [B, S, V] logits are never gathered),
    and the aux loss, which every dp rank computes whole, counted once
    over them."""
    logits, _, aux = forward_full(params, cfg, batch, ctx=ctx)
    labels = batch["labels"] if "labels" in batch else batch["tokens"]
    lg = logits[:, :-1]
    tgt = labels[:, 1:].long()
    if ctx is not None:
        tok = ctx.cross_entropy(lg, tgt)
        loss = tok.sum() / (tok.numel() * ctx.ndp)
        return loss + 0.01 * aux / ctx.ndp, {"loss": loss, "aux": aux}
    lse = torch.logsumexp(lg, dim=-1)                          # [B, S-1]
    ll = torch.gather(lg, -1, tgt[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def forward_decode(params, cfg, cache, batch, pos: int, ctx=None,
                   t_split=None):
    """One-token step. batch: {"tokens" [B,1]} or {"embeddings" [B,1,d]};
    cache as init_cache(). Writes each layer's k/v at `pos`, or its new
    recurrent state, in place. Returns (logits [B,1,V], cache); the MoE
    layers' aux is discarded, as in JAX. With `ctx` (a mesh) `batch` and
    `cache` are this rank's rows and pieces (`t_split`: for each layer,
    whether its cache's T is over 'model'), and the logits the whole
    batch's over the whole vocabulary, the same bits on every rank."""
    x = _embed_inputs(params, cfg, batch, ctx)
    if cfg.rope == "sinusoidal":
        x = x + sinusoidal_positions(
            torch.tensor([pos], device=x.device), cfg.d_model
        ).to(x.dtype)[None]
    splits = t_split or [False] * len(cache)
    for p, kind, c, ts in zip(params.blocks, params.kinds, cache, splits):
        x, _, _ = apply_block(p, x, cfg, kind, cache=c, pos=pos, ctx=ctx,
                              t_split=ts)
    return _head(params, cfg, x, ctx, whole=ctx is not None), cache


def _cache_for_kind(cfg, kind, B, T, dt, device):
    mixer = KIND_MIXER[kind]
    if mixer == "rwkv":
        return ssm.rwkv_init_state(cfg, B, device)
    if mixer == "rec":
        return ssm.rglru_init_state(cfg, B, device)
    if mixer == "mla":
        return attn.init_mla_cache(cfg, B, T, dt, device)
    Tk = min(T, cfg.window) if kind == "attn_local" and cfg.window else T
    return attn.init_kv_cache(cfg, kind, B, Tk, dt, device)


def init_cache(cfg, B: int, T: int, device=None, local=None) -> list:
    """Decode cache sized for positions [0, T), one dict per layer: {"k",
    "v"} (+ "k_scale", "v_scale" with `kv_cache_dtype="int8"`) for
    attention, local windows clamping storage; the latent {"ckv",
    "krope"} for MLA; the constant-size f32 state for the recurrent kinds
    ({"h", "conv"} for `rec`, {"s", "x_tm", "x_cm"} for `rwkv`). With
    `local(layer, name, shape)` (a mesh rank's piece of each leaf: its
    shape) only the pieces are allocated, zero as the whole would be."""
    dt = _dtype(cfg)
    if local is None:
        return [_cache_for_kind(cfg, kind, B, T, dt, device)
                for kind in layer_kinds(cfg)]
    whole = [_cache_for_kind(cfg, kind, B, T, dt, "meta")
             for kind in layer_kinds(cfg)]
    return [{n: torch.zeros(local(i, n, tuple(t.shape)), dtype=t.dtype,
                            device=device) for n, t in c.items()}
            for i, c in enumerate(whole)]
