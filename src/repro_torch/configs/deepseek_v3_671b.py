"""DeepSeek-V3 671B [arXiv:2412.19437; hf]: MLA, 1 shared + 256 routed top-8.

61L d_model=7168 128H (kv=128) expert d_ff=2048 vocab=129280, MoE 256e
top-8. The first 3 layers are dense MLPs (d_ff 18432, per the paper); the
MTP head is omitted (a training-objective add-on, not a structural layer).
Adafactor: AdamW's m/v at 671B do not fit (as in the JAX package).
"""
from .base import ArchConfig, MLACfg, MoECfg, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab=129280, head_dim=128,
    prefix=("mla_dense",) * 3, pattern=("mla_moe",), repeats=58,
    moe=MoECfg(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
               router="sigmoid"),
    mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
               qk_rope_dim=64, v_head_dim=128),
    rope_theta=10_000.0, optimizer="adafactor", microbatch=16,
    grad_accum_dtype="bfloat16",
))
