"""Qwen2 1.5B [arXiv:2407.10671; hf]: GQA with QKV bias.

28L d_model=1536 12H (GQA kv=2, head_dim 128) d_ff=8960 vocab=151936.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151_936, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
))
