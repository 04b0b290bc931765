"""MusicGen-large [arXiv:2306.05284; hf]: decoder-only transformer over
EnCodec tokens. 48L d_model=2048 32H (MHA kv=32, head_dim 64) d_ff=8192
vocab=2048. Modality frontend (EnCodec) is a STUB: the inputs are
precomputed frame embeddings; sinusoidal positions, LayerNorm, GELU MLP.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, head_dim=64,
    rope="sinusoidal", mlp="gelu", norm="layernorm",
    embed_inputs=True,
))
