"""Architecture config system + registry.

A copy of the JAX package's `repro.configs.base`, field for field, so that
`dataclasses.asdict` of a config here equals the JAX one. ``layout``
describes the layer stacking as (prefix, pattern × repeats, suffix); the
port's stack unrolls it into one block per layer (`models.transformer`).
The port registers the configurations whose families it serves
(all ten of the JAX package's: `qwen2-1.5b`, `smollm-360m`, `qwen3-4b`,
`gemma2-9b`, `recurrentgemma-2b`, `rwkv6-1.6b`, `qwen2-vl-2b`,
`musicgen-large`, `dbrx-132b`, `deepseek-v3-671b`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "MoECfg", "MLACfg", "RecCfg", "register", "get_config",
           "list_configs", "smoke_config"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25
    router: str = "softmax"      # "softmax" | "sigmoid" (DeepSeek-V3)
    n_groups: int = 0            # DS-V3 node-limited routing: expert groups
    group_top: int = 0           # ... tokens routed to <= group_top groups
    dispatch_dtype: str = "bfloat16"   # "float8_e4m3fn": fp8 EP dispatch


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RecCfg:
    """Recurrent block config (RG-LRU / RWKV6)."""
    lru_width: Optional[int] = None   # defaults to d_model
    conv_width: int = 4               # RG-LRU temporal conv
    head_dim: int = 64                # rwkv6 wkv head size
    chunk: int = 64                   # chunked-recurrence length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # layer layout: prefix + pattern*repeats + suffix (kinds; see models/)
    prefix: Tuple[str, ...] = ()
    pattern: Tuple[str, ...] = ("attn",)
    repeats: Optional[int] = None           # default: fill n_layers
    suffix: Tuple[str, ...] = ()
    # attention details
    rope_theta: float = 10_000.0
    rope: str = "rope"           # rope|mrope|sinusoidal|none
    window: Optional[int] = None            # local-attention window
    attn_softcap: Optional[float] = None    # gemma2
    logit_softcap: Optional[float] = None   # gemma2
    qkv_bias: bool = False                  # qwen2
    qk_norm: bool = False                   # qwen3
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # qwen2-vl (t, h, w)
    mlp: str = "swiglu"          # swiglu|geglu|gelu
    norm: str = "rmsnorm"        # rmsnorm|layernorm
    post_norm: bool = False                 # gemma2 sandwich norms
    embed_scale: bool = False               # gemma2 sqrt(d) embed scaling
    embed_inputs: bool = False              # audio/vlm: frontend stub feeds embeddings
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    rec: Optional[RecCfg] = None
    # training / runtime
    dtype: str = "bfloat16"
    optimizer: str = "adamw"     # adamw|adafactor
    microbatch: int = 16         # global microbatch size for grad accumulation
    attn_chunk: int = 1024       # chunked-attention block size
    kv_cache_dtype: str = "bfloat16"        # or "int8" (quantized decode cache)
    grad_accum_dtype: str = "float32"       # bf16 for the MoE giants (memory)
    sub_quadratic: bool = False  # eligible for long_500k
    # --- distribution levers (EXPERIMENTS.md §Perf hillclimbs) ---
    zero1: bool = False          # shard grad accum + opt state over 'data'
    seq_parallel: bool = False   # shard layer-boundary activations' S over 'model'
    pure_dp: bool = False        # batch over ALL mesh axes, weights replicated
    shard_cache_t: bool = False  # decode cache: shard T over 'model'

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kinds(self) -> Tuple[Tuple[str, ...], Tuple[str, ...], int,
                                   Tuple[str, ...]]:
        """(prefix, pattern, repeats, suffix) with repeats resolved."""
        rest = self.n_layers - len(self.prefix) - len(self.suffix)
        reps = self.repeats
        if reps is None:
            assert rest % len(self.pattern) == 0, \
                f"{self.name}: {rest} layers not divisible by pattern " \
                f"{self.pattern}"
            reps = rest // len(self.pattern)
        assert len(self.prefix) + reps * len(self.pattern) + len(self.suffix) \
            == self.n_layers
        return self.prefix, self.pattern, reps, self.suffix


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # import side-effect registration
    from . import (dbrx_132b, deepseek_v3_671b,  # noqa: F401
                   gemma2_9b, musicgen_large, qwen2_1_5b, qwen2_vl_2b,
                   qwen3_4b, recurrentgemma_2b, rwkv6_1_6b, smollm_360m)


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: few layers, thin dims,
    tiny vocab/experts — keeps every structural feature of the arch."""
    pre, pat, reps, suf = cfg.layer_kinds()
    n_layers = len(pre) + len(pat) + len(suf)  # one pattern repeat
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, min(cfg.n_heads, 4))
    heads = (heads // kv) * kv or kv
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers, repeats=1,
        d_model=64, n_heads=heads, n_kv_heads=kv, d_ff=128,
        vocab=128, head_dim=16, microbatch=2, attn_chunk=32,
        mrope_sections=(2, 3, 3),
        window=min(cfg.window, 16) if cfg.window else None,
        dtype="float32",
    )
    if cfg.moe:
        # capacity_factor covers every token: token drops are legitimate in
        # training but would break the decode-vs-full parity smoke test
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=32,
            capacity_factor=8.0)
    if cfg.mla:
        changes["mla"] = MLACfg(q_lora_rank=32, kv_lora_rank=16,
                                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    if cfg.rec:
        changes["rec"] = dataclasses.replace(
            cfg.rec, lru_width=64 if cfg.rec.lru_width else None,
            head_dim=16, chunk=8)
    return dataclasses.replace(cfg, **changes)
