"""Gemma-2 9B [arXiv:2408.00118; hf]: alternating local(4096)/global attention,
attn/logit soft-capping, GeGLU, sandwich norms, sqrt(d) embedding scale.

42L d_model=3584 16H (GQA kv=8, head_dim 256) d_ff=14336 vocab=256000.
long_500k is SKIPPED: global layers are full attention (DESIGN.md §5).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab=256_000, head_dim=256,
    pattern=("attn_local", "attn_global"), repeats=21,
    window=4096, attn_softcap=50.0, logit_softcap=30.0,
    mlp="geglu", post_norm=True, embed_scale=True,
))
