"""Attention: GQA (+bias/qk-norm/softcap/local-window), MLA, KV caches.

A copy of the JAX package's `repro.models.attention` on tensors:

- `chunked_attention` is the jnp online-softmax schedule, whole (window
  and soft-cap included): the plain version of full-sequence attention,
  which `attn_apply` runs on CPU tensors;
- on CUDA tensors `attn_apply` runs the `flash_attention` kernel through
  `kernels.flash_attn.FlashAttentionFn` (the model's [B, S, H, D] layout,
  kv heads mapped in the kernel; `attn_local`'s window and the config's
  `attn_softcap` computed in the kernel), whose backward is the
  `flash_attention_bwd` kernel (the window and the soft-cap too); on CPU
  tensors autograd differentiates `chunked_attention`, as JAX does;
- decode is single-query attention over the cache in plain PyTorch. The
  cache is written in place (JAX's `dynamic_update_slice` returns new
  arrays): `attn_decode` returns the same dict it was given. With
  `kv_cache_dtype="int8"` the cache holds int8 codes and f32 scales per
  (batch, position, kv head) (`quantize_kv`); each step writes the new
  codes and scales at its slot and dequantizes the whole cache to q's
  dtype (`dequantize_kv`), in plain PyTorch on both devices, as JAX does
  in `jnp`.

Qwen2-VL's M-RoPE (`rope="mrope"`) rotates q and k by three position
streams ([B, 3, S]); a decode step gives all three its position, as JAX
does.

DeepSeek-V3's multi-head latent attention (`mla_*`): q through a rank
`q_lora_rank` bottleneck, k and v decompressed per head from one
`kv_lora_rank` latent (`ckv`), a rotary part of width `qk_rope_dim` that
all heads share for k. `mla_apply` (prefill and training) materialises
k = [k_nope, k_rope broadcast over the heads] at q/k width 192 and v at
width 128, as JAX does, and runs `chunked_attention` on CPU tensors and
the `flash_attention` kernel (its 192 / 128 instantiation, through
`FlashAttentionFn`) on CUDA tensors; its cache is (ckv, k_rope).
`mla_decode` is JAX's absorbed-matrix form in plain PyTorch on both
devices: `wk_b` folded into q and `wv_b` applied after the softmax, so a
step reads the latent cache {"ckv" [B, T, r], "krope" [B, T, rope]}
(written in place) and never the per-head k and v. Training MLA on the
card differentiates through `FlashAttentionFn`, whose backward is the
`flash_attention_bwd` kernel's 192 / 128 instantiation. On a mesh whose
'model' axis splits MLA's heads (`wq_b`, `wk_b`, `wv_b`, `wo`), each rank
computes the latent whole and attends on its heads; its output is its
part of the sum over heads. With `shard_cache_t` the decode's latent
cache holds this rank's positions, and every head's absorbed query is
scored against them, the partials merged as `attn_decode` merges them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attn import FlashAttentionFn
from .layers import apply_rope, dense_init, mrope_apply, rmsnorm, softcap

__all__ = ["attn_init", "attn_apply", "attn_decode", "mla_init", "mla_apply",
           "mla_decode", "init_kv_cache", "init_mla_cache",
           "chunked_attention", "quantize_kv", "dequantize_kv", "NEG_INF"]

NEG_INF = -2.0 ** 30  # large-finite: avoids NaN rows for fully-masked blocks


def later(what: str) -> NotImplementedError:
    """The error of a feature that a later slice of the port brings."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP A9: the LM substrate, the rest)")


# ---------------------------------------------------------------------------
# Flash-style chunked causal attention (the plain version)
# ---------------------------------------------------------------------------

def _f32_einsum(spec, a, b):
    """einsum with f32 products and sums (JAX's preferred_element_type=f32:
    bf16 products are exact in f32)."""
    return torch.einsum(spec, a.float(), b.float())


def chunked_attention(q, k, v, *, chunk: int, window: Optional[int] = None,
                      cap: Optional[float] = None, q_offset=0):
    """q [B,S,H,D]; k,v [B,T,K,D] with H = G*K (GQA). Causal; optional
    sliding window and tanh soft-cap. Returns [B,S,H,D]."""
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    nq = max(1, S // chunk)
    cq = S // nq
    nk = max(1, T // chunk)
    ck = T // nk
    qb = q.reshape(B, nq, cq, K, G, D)
    dev = q.device
    outs = []
    for i in range(nq):
        qi = qb[:, i]                                   # [B,cq,K,G,D]
        qpos = q_offset + i * cq + torch.arange(cq, device=dev)
        m = torch.full((B, K, G, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, K, G, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, cq, K, G, Dv), dtype=torch.float32, device=dev)
        for j in range(nk):
            kj = k[:, j * ck:(j + 1) * ck]
            vj = v[:, j * ck:(j + 1) * ck]
            s = _f32_einsum("bqkgd,btkd->bkgqt", qi, kj) * scale
            s = softcap(s, cap)
            kpos = j * ck + torch.arange(ck, device=dev)
            allow = kpos[None, :] <= qpos[:, None]
            if window is not None:
                allow &= (qpos[:, None] - kpos[None, :]) < window
            s = torch.where(allow[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = _f32_einsum("bkgqt,btkd->bqkgd", p.to(vj.dtype), vj)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append(out.to(q.dtype))
    return torch.stack(outs, dim=1).reshape(B, S, H, Dv)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attn_init(cfg, dtype, *, generator: torch.Generator, device=None) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kw = dict(dtype=dtype, generator=generator, device=device)
    p = {"wq": dense_init((d, H, hd), in_axis_size=d, **kw),
         "wk": dense_init((d, K, hd), in_axis_size=d, **kw),
         "wv": dense_init((d, K, hd), in_axis_size=d, **kw),
         "wo": dense_init((H, hd, d), in_axis_size=H * hd, **kw)}
    zeros = dict(dtype=dtype, device=device)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), **zeros)
        p["bk"] = torch.zeros((K, hd), **zeros)
        p["bv"] = torch.zeros((K, hd), **zeros)
    if cfg.qk_norm:
        p["qn"] = torch.zeros((hd,), **zeros)
        p["kn"] = torch.zeros((hd,), **zeros)
    return p


def _proj(x, w):
    """einsum("bsd,dhe->bshe", x, w) as one matrix product."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).unflatten(-1, (h, e))


def _qkv(x, p, cfg, positions, kv=None):
    """q, k, v [B, S, heads, hd]. `kv` (a mesh rank's q heads over whole
    k / v weights, `shard.ShardCtx.kv_heads`): (lo, hi, idx), k and v of
    kv heads [lo, hi) only, then, with idx, one kv head per q head."""
    wk, wv = p["wk"], p["wv"]
    bk, bv = p.get("bk"), p.get("bv")
    if kv is not None:
        lo, hi, _ = kv
        wk, wv = wk[:, lo:hi], wv[:, lo:hi]
        if cfg.qkv_bias:
            bk, bv = bk[lo:hi], bv[lo:hi]
    q, k, v = _proj(x, p["wq"]), _proj(x, wk), _proj(x, wv)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + bk, v + bv
    if cfg.qk_norm:
        q, k = rmsnorm(q, p["qn"]), rmsnorm(k, p["kn"])
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        q = mrope_apply(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = mrope_apply(k, positions, cfg.rope_theta, cfg.mrope_sections)
    if kv is not None and kv[2] is not None:
        k, v = k[:, :, kv[2]], v[:, :, kv[2]]
    return q, k, v


def _out(o, wo):
    """einsum("bshe,hed->bsd", o, wo) as one matrix product."""
    h, e, d = wo.shape
    return o.flatten(-2) @ wo.reshape(h * e, d)


def attn_apply(x, p, cfg, kind: str, positions, kv=None, whole_kv=False):
    """Full-sequence (prefill and training). Returns (out, (k, v) for
    caching). Runs the flash_attention kernel (with its backward) on CUDA
    tensors, chunked_attention on CPU tensors. On a mesh rank `p` holds
    this rank's heads and `kv` says which kv heads they read (`_qkv`);
    the output is then this rank's part of the sum over heads. With
    `whole_kv` (a mesh prefill) the returned k / v hold every kv head
    whose weights this rank holds, not only those its q heads read."""
    if whole_kv and kv is not None:
        q, k_all, v_all = _qkv(x, p, cfg, positions)
        lo, hi, idx = kv
        k, v = k_all[:, :, lo:hi], v_all[:, :, lo:hi]
        if idx is not None:
            k, v = k[:, :, idx], v[:, :, idx]
    else:
        q, k, v = _qkv(x, p, cfg, positions, kv)
        k_all, v_all = k, v
    window = cfg.window if kind == "attn_local" else None
    cap = cfg.attn_softcap
    if q.device.type == "cpu":
        o = chunked_attention(q, k, v, chunk=cfg.attn_chunk, window=window,
                              cap=cap)
    else:
        o = FlashAttentionFn.apply(q, k, v, True, window, cap)
    return _out(o, p["wo"]), (k_all, v_all)


def _write_slot(cache, k, v, slot: int) -> None:
    """The new token's k / v (codes and scales with an int8 cache) into
    position `slot` of `cache`, in place."""
    kq, ks_ = quantize_kv(k, cache)
    vq, vs_ = quantize_kv(v, cache)
    cache["k"][:, slot] = kq[:, 0]
    cache["v"][:, slot] = vq[:, 0]
    if "k_scale" in cache:
        cache["k_scale"][:, slot] = ks_[:, 0]
        cache["v_scale"][:, slot] = vs_[:, 0]


def _decode_scores(q, kf, cfg, kind, slot: int, pos: int, T: int, t0=0):
    """Scores [B, Kc, G, 1, Tc] of q [B, 1, Kc·G, hd] against the cache's
    kv heads kf [B, Tc, Kc, hd] holding positions [t0, t0 + Tc) of a
    cache of T, soft-capped and masked as one device masks them."""
    B, _, Hq, hd = q.shape
    Tc, Kc = kf.shape[1], kf.shape[2]
    qg = q.reshape(B, 1, Kc, Hq // Kc, hd)
    s = _f32_einsum("bqkgd,btkd->bkgqt", qg, kf) / math.sqrt(hd)
    s = softcap(s, cfg.attn_softcap)
    tpos = t0 + torch.arange(Tc, device=q.device)
    if kind == "attn_local":
        valid = (tpos[None] <= slot) | (pos >= T)   # rolled window full
    else:
        valid = tpos[None] <= pos
    return torch.where(valid[None, None, None], s, NEG_INF)


def attn_decode(x, p, cfg, kind: str, cache, pos: int, ctx=None,
                t_split: bool = False):
    """One-token decode. x [B,1,d]; cache {"k","v"} [B,T,K,hd] (+ f32
    "k_scale", "v_scale" [B,T,K,1] if int8); pos = the current position
    (int). Local kinds roll mod window. Writes the new k/v (codes and
    scales) into `cache` in place and returns (out, cache).

    On a mesh (`ctx`, `shard.ShardCtx`) x holds this rank's rows and `p`
    its heads; `cache` is this rank's piece in `model.cache_specs`'
    layout. Heads over 'model': the cache holds this rank's kv heads (all
    K where 'model' does not divide them; then every rank writes all K),
    and each rank attends on its q heads. T over 'model' (`t_split`): the
    cache holds positions [m T', (m + 1) T') of every kv head; the new
    token's k / v are gathered over 'model' and written by the rank whose
    range holds the slot, q is gathered so that each rank scores its
    positions for every head, and the partial softmax statistics are
    merged over 'model' (`ShardCtx.merge_softmax`) before each rank keeps
    its heads' output for `wo`. The output is this rank's part of the
    sum over heads."""
    B = x.shape[0]
    shape = (B, 3, 1) if cfg.rope == "mrope" else (B, 1)
    positions = torch.full(shape, pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(x, p, cfg, positions)
    K = cfg.n_kv_heads
    mesh = ctx is not None and ctx.tp > 1
    Tl = cache["k"].shape[1]
    split = t_split and mesh
    T = Tl * ctx.tp if split else Tl
    slot = pos % T if kind == "attn_local" else pos  # rolling window slot
    if mesh and cache["k"].shape[2] == K and k.shape[2] != K:
        k, v = ctx.gather_heads(k), ctx.gather_heads(v)
    t0 = ctx.m * Tl if split else 0
    if not split or t0 <= slot < t0 + Tl:       # the rank that holds it
        _write_slot(cache, k, v, slot - t0)
    kf = dequantize_kv(cache["k"], cache.get("k_scale"), q.dtype)
    vf = dequantize_kv(cache["v"], cache.get("v_scale"), q.dtype)
    if not split:
        if mesh and ctx.split["attn"] and kf.shape[2] == K:
            lo, hi, idx = ctx.kv_map(q.shape[2])
            kf, vf = kf[:, :, lo:hi], vf[:, :, lo:hi]
            if idx is not None:
                kf, vf = kf[:, :, idx], vf[:, :, idx]
        s = _decode_scores(q, kf, cfg, kind, slot, pos, T)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,btkd->bqkgd", w.to(vf.dtype), vf)
        return _out(o.reshape(B, 1, q.shape[2], cfg.hd), p["wo"]), cache
    if ctx.split["attn"]:
        q = ctx.gather_heads(q)
    s = _decode_scores(q, kf, cfg, kind, slot, pos, T, t0)
    m = s.amax(dim=-1)                                   # [B, K, G, 1]
    e = torch.exp(s - m[..., None])
    o = _f32_einsum("bkgqt,btkd->bkgqd", e.to(vf.dtype), vf)
    o = ctx.merge_softmax(m, e.sum(dim=-1), o)           # [B, K, G, 1, hd]
    o = o.permute(0, 3, 1, 2, 4).reshape(B, 1, cfg.n_heads, cfg.hd)
    if ctx.split["attn"]:
        o = ctx.own(o, 2)
    return _out(o.to(q.dtype), p["wo"]), cache


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V3)
# ---------------------------------------------------------------------------

def mla_init(cfg, dtype, *, generator: torch.Generator, device=None) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    m = cfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    kw = dict(dtype=dtype, generator=generator, device=device)
    zeros = dict(dtype=dtype, device=device)
    return {
        "wq_a": dense_init((d, m.q_lora_rank), **kw),
        "qn": torch.zeros((m.q_lora_rank,), **zeros),
        "wq_b": dense_init((m.q_lora_rank, H, qk),
                           in_axis_size=m.q_lora_rank, **kw),
        "wkv_a": dense_init((d, m.kv_lora_rank + m.qk_rope_dim), **kw),
        "kvn": torch.zeros((m.kv_lora_rank,), **zeros),
        "wk_b": dense_init((m.kv_lora_rank, H, m.qk_nope_dim),
                           in_axis_size=m.kv_lora_rank, **kw),
        "wv_b": dense_init((m.kv_lora_rank, H, m.v_head_dim),
                           in_axis_size=m.kv_lora_rank, **kw),
        "wo": dense_init((H, m.v_head_dim, d),
                         in_axis_size=H * m.v_head_dim, **kw),
    }


def _mla_qkv_latent(x, p, cfg, positions):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope] rotated, ckv [B,S,r]
    normed, k_rope [B,S,1,rope] rotated)."""
    m = cfg.mla
    q_lat = rmsnorm(x @ p["wq_a"], p["qn"])
    q = _proj(q_lat, p["wq_b"])
    q_nope = q[..., :m.qk_nope_dim]
    q_rope = apply_rope(q[..., m.qk_nope_dim:], positions, cfg.rope_theta)
    kv_a = x @ p["wkv_a"]
    ckv = rmsnorm(kv_a[..., :m.kv_lora_rank], p["kvn"])
    k_rope = apply_rope(kv_a[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)                   # [B,S,1,rope]
    return q_nope, q_rope, ckv, k_rope


def mla_apply(x, p, cfg, positions):
    """Full-sequence MLA: per-head k/v decompressed from the latent
    (prefill and training). Runs the flash_attention kernel (q/k width
    192, v width 128 at the full config) on CUDA tensors, its gradient
    the flash_attention_bwd kernel at the same widths, and
    chunked_attention, under autograd, on CPU tensors. Returns (out, (ckv,
    k_rope [B,S,rope]) for caching). The heads are those `p` holds (a
    mesh rank's: its output is then its part of the sum over heads; the
    latent is every rank's whole)."""
    m = cfg.mla
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(x, p, cfg, positions)
    k_nope = _proj(ckv, p["wk_b"])
    v = _proj(ckv, p["wv_b"])
    H = p["wq_b"].shape[1]
    k = torch.cat([k_nope, k_rope.expand(k_rope.shape[:2]
                                         + (H, m.qk_rope_dim))], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    if q.device.type == "cpu":
        o = chunked_attention(q, k, v, chunk=cfg.attn_chunk)
    else:
        o = FlashAttentionFn.apply(q, k, v, True, None, None)
    return _out(o, p["wo"]), (ckv, k_rope[..., 0, :])


def mla_decode(x, p, cfg, cache, pos: int, ctx=None, t_split=False):
    """Absorbed-matrix MLA decode (DeepSeek-V3's weight absorption): the
    scores against the latent cache directly, so a step's cost does not
    grow with H x head width. cache {"ckv" [B,T,r], "krope" [B,T,rope]};
    writes position `pos` in place and returns (out, cache).

    On a mesh (`ctx`, `shard.ShardCtx`) `p` holds this rank's heads (all
    of them where 'model' does not divide them) and the output is this
    rank's part of the sum over heads. The cache is whole over 'model'
    (every rank writes the new latent), or with `t_split` holds positions
    [m T', (m + 1) T'): the rank whose range holds `pos` writes it, the
    absorbed queries of every head are gathered, and each rank's partial
    softmax statistics over its positions are merged over 'model'
    (`ShardCtx.merge_softmax`) before it keeps its heads for `wv_b`."""
    m = cfg.mla
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope, ckv_new, k_rope_new = _mla_qkv_latent(x, p, cfg,
                                                          positions)
    split = t_split and ctx is not None and ctx.tp > 1
    Tl = cache["ckv"].shape[1]
    t0 = ctx.m * Tl if split else 0
    if not split or t0 <= pos < t0 + Tl:        # the rank that holds it
        cache["ckv"][:, pos - t0] = ckv_new[:, 0].to(cache["ckv"].dtype)
        cache["krope"][:, pos - t0] = k_rope_new[:, 0, 0].to(
            cache["krope"].dtype)
    ckv = cache["ckv"].to(x.dtype)                      # [B,T,r]
    krope = cache["krope"].to(x.dtype)                  # [B,T,rope]
    # absorb W_k into q: q_eff [B,1,H,r]
    q_eff = torch.einsum("bshe,rhe->bshr", q_nope, p["wk_b"])
    heads = split and ctx.sharded("mla")
    if heads:
        q_eff, q_rope = ctx.gather_heads(q_eff), ctx.gather_heads(q_rope)
    s = (torch.einsum("bshr,btr->bhst", q_eff, ckv)
         + torch.einsum("bshe,bte->bhst", q_rope, krope)).float()
    s = s / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    valid = t0 + torch.arange(Tl, device=x.device) <= pos
    s = torch.where(valid[None, None, None], s, NEG_INF)
    if split:
        mx = s.amax(dim=-1)                             # [B, H, 1]
        e = torch.exp(s - mx[..., None])
        lat = _f32_einsum("bhst,btr->bhsr", e.to(ckv.dtype), ckv)
        lat = ctx.merge_softmax(mx, e.sum(dim=-1), lat)  # [B, H, 1, r]
        lat = lat.permute(0, 2, 1, 3).to(x.dtype)
        if heads:
            lat = ctx.own(lat, 2)
    else:
        w = torch.softmax(s, dim=-1)
        lat = torch.einsum("bhst,btr->bshr", w.to(ckv.dtype), ckv)
    o = torch.einsum("bshr,rhe->bshe", lat, p["wv_b"])  # [B,1,H,v]
    return _out(o, p["wo"]), cache


def init_mla_cache(cfg, B: int, T: int, dtype, device=None):
    m = cfg.mla
    return {"ckv": torch.zeros((B, T, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((B, T, m.qk_rope_dim), dtype=dtype,
                                 device=device)}


def quantize_kv(x, cache):
    """Per (B, T, K) head int8 quantization when the cache is int8: (codes
    int8, scales f32 [..., 1]), codes = round(x / scale) (half to even, as
    `jnp.round`) clipped to ±127, scale = max(amax, 1e-6) / 127; else (x in
    the cache's dtype, None)."""
    if cache.get("k_scale") is None and cache["k"].dtype != torch.int8:
        return x.to(cache["k"].dtype), None
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(x, scale, dtype):
    if x.dtype == torch.int8:
        return (x.float() * scale).to(dtype)
    return x.to(dtype)


def init_kv_cache(cfg, kind: str, B: int, T: int, dtype, device=None):
    """T already window-clamped by the caller for local kinds. An int8
    cache holds int8 k/v and f32 scales [B, T, K, 1]."""
    K, hd = cfg.n_kv_heads, cfg.hd
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros((B, T, K, hd), dtype=torch.int8,
                                 device=device),
                "v": torch.zeros((B, T, K, hd), dtype=torch.int8,
                                 device=device),
                "k_scale": torch.zeros((B, T, K, 1), dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros((B, T, K, 1), dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros((B, T, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((B, T, K, hd), dtype=dtype, device=device)}
