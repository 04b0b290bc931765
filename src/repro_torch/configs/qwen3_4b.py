"""Qwen3 4B [hf:Qwen/Qwen3-8B family; hf]: per-head QK-RMSNorm, GQA, no bias.

36L d_model=2560 32H (GQA kv=8, head_dim 128) d_ff=9728 vocab=151936.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151_936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
))
