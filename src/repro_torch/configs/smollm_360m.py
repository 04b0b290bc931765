"""SmolLM 360M [hf:HuggingFaceTB/SmolLM; hf]: llama-arch small model.

32L d_model=960 15H (GQA kv=5, head_dim 64) d_ff=2560 vocab=49152.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49_152, head_dim=64,
))
