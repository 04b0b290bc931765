"""Qwen2-VL 2B [arXiv:2409.12191; hf]: qwen2 backbone with M-RoPE
(temporal/height/width rotary sections). Vision frontend is a STUB: the
inputs are precomputed patch embeddings + 3-axis position ids.

28L d_model=1536 12H (GQA kv=2, head_dim 128) d_ff=8960 vocab=151936.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151_936, head_dim=128,
    qkv_bias=True, rope="mrope", rope_theta=1_000_000.0,
    embed_inputs=True,
))
