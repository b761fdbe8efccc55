"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8.  Source: [hf:Qwen/Qwen3-30B-A3B; hf].
Expert parallelism: 128 experts over the 16-way model axis (8 per chip);
remaining expert-weight dims FSDP-sharded over the data axis (DESIGN.md §6).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, head_dim=128, d_ff=0, moe_d_ff=1536,
    vocab_size=151936, n_experts=128, top_k=8, rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, moe_d_ff=32, vocab_size=256, n_experts=8,
    top_k=2, q_chunk=32,
)
