"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
Source: [hf:stabilityai/stablelm-2-1_6b; hf] — StableLM-2 family: partial
rotary (25%), LayerNorm, per-layer parallel residual omitted (simple pre-norm).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", n_layers=40, d_model=5120, n_heads=32,
    n_kv_heads=8, d_ff=13824, vocab_size=100352, partial_rotary=0.25,
    norm="layernorm", qkv_bias=False, rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-1_6b; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="stablelm-12b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab_size=256, partial_rotary=0.25,
    norm="layernorm", rope_theta=10000.0, q_chunk=32,
)
