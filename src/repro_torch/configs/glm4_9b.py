"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
Source: [hf:THUDM/glm-4-9b; hf] — RoPE (partial, 50%), extreme GQA (kv=2),
QKV bias.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096, n_heads=32,
    n_kv_heads=2, d_ff=13696, vocab_size=151552, qkv_bias=True,
    partial_rotary=0.5, source="hf:THUDM/glm-4-9b; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="glm4-9b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab_size=256, qkv_bias=True, partial_rotary=0.5,
    q_chunk=32,
)
