"""RecurrentGemma 2B (Griffin) [arXiv:2402.19427; hf]: RG-LRU recurrent blocks
+ local attention, 2:1 ratio, temporal conv width 4, GeGLU.

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000,
window 2048. Bounded state (window + LRU) => runs long_500k.
"""
from .base import ArchConfig, RecCfg, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256_000, head_dim=256,
    pattern=("rec", "rec", "attn_local"), repeats=8, suffix=("rec", "rec"),
    window=2048, mlp="geglu",
    rec=RecCfg(lru_width=2560, conv_width=4),
    sub_quadratic=True,
))
