"""DBRX 132B [hf:databricks/dbrx-base; unverified]: 16-expert top-4 MoE.

40L d_model=6144 48H (GQA kv=8) expert d_ff=10752 vocab=100352.
"""
from .base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, head_dim=128,
    pattern=("attn_moe",),
    moe=MoECfg(n_experts=16, top_k=4, d_ff_expert=10752),
    rope_theta=500_000.0, qkv_bias=False,
    optimizer="adafactor", microbatch=16, grad_accum_dtype="bfloat16",
))
