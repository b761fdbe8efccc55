"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.
Source: [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, moe_d_ff=512, vocab_size=49155, n_experts=32,
    top_k=8, source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="granite-moe-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, moe_d_ff=32, vocab_size=256, n_experts=4, top_k=2, q_chunk=32,
)
