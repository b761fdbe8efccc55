"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
Source: [hf:meta-llama/Llama-3.2-1B; unverified] — tied embeddings, theta 500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense", n_layers=16, d_model=2048, n_heads=32,
    n_kv_heads=8, d_ff=8192, vocab_size=128256, rope_theta=500000.0,
    tie_embeddings=True, source="hf:meta-llama/Llama-3.2-1B; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="llama3.2-1b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab_size=256, rope_theta=500000.0,
    tie_embeddings=True, q_chunk=32,
)
