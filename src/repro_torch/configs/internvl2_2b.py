"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
Source: [arXiv:2404.16821; hf] — InternViT frontend (STUB: input_specs provides
precomputed patch embeddings, 256 tokens/image) + InternLM2-style dense GQA
backbone.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab_size=92553, n_vision_tokens=256,
    source="arXiv:2404.16821; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-2b-smoke", family="vlm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab_size=256, n_vision_tokens=8, q_chunk=32,
)
