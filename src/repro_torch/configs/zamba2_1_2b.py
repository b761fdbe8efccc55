"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=32000,
ssm_state=64.  Source: [arXiv:2411.15242; hf] — Mamba-2 backbone with a single
*shared* attention block invoked every `attn_every` SSM layers (Zamba2 pattern).
At long_500k the shared block uses a 4096-token sliding window (DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab_size=32000, ssm_state=64, d_conv=4,
    expand=2, ssm_heads=32, attn_every=6, sliding_window=4096,
    source="arXiv:2411.15242; hf",
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid", n_layers=5, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=160, vocab_size=256, ssm_state=8, d_conv=4, expand=2,
    ssm_heads=4, attn_every=2, sliding_window=64, q_chunk=32,
)
