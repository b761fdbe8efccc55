"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
Source: [hf:Qwen/Qwen2.5-0.5B; hf] — GQA with QKV bias.
Note: 40 heads is not divisible by the 16-way model axis; GSPMD pads the head
dimension (documented in EXPERIMENTS.md §Roofline for this arch).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=13824, vocab_size=152064, qkv_bias=True,
    rope_theta=1000000.0, source="hf:Qwen/Qwen2.5-0.5B; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2.5-14b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab_size=256, qkv_bias=True, q_chunk=32,
)
