"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) vocab=65024, ssm_state=16.
Source: [arXiv:2410.05355; unverified] — Mamba-1 architecture (selective scan),
expand=2 (d_inner=8192), d_conv=4.  Sub-quadratic: runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    vocab_size=65024, ssm_state=16, d_conv=4, expand=2,
    source="arXiv:2410.05355; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="falcon-mamba-7b-smoke", family="ssm", n_layers=2, d_model=64,
    vocab_size=256, ssm_state=8, d_conv=4, expand=2,
)
