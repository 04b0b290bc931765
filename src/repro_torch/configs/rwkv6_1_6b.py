"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892; unverified]: attention-free,
data-dependent per-channel decay, token-shift LoRA mixing.

24L d_model=2048 d_ff=7168 vocab=65536; wkv head size 64 (32 heads).
Constant-size recurrent state => runs long_500k.
"""
from .base import ArchConfig, RecCfg, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65_536, head_dim=64,
    pattern=("rwkv",), rope="none",
    rec=RecCfg(head_dim=64, chunk=64),
    sub_quadratic=True,
))
