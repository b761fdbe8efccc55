"""whisper-base [audio]: 6L d_model=512 8H d_ff=2048 vocab=51865 — enc-dec.
Source: [arXiv:2212.04356; unverified].  The conv/mel frontend is a STUB:
input_specs provides precomputed frame embeddings (B, 1500, 512) for the
encoder; shapes' seq_len applies to the decoder token stream.  GELU MLPs,
LayerNorm, learned-position-free (sinusoidal treated as part of the stub).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec", n_layers=6, d_model=512, n_heads=8,
    n_kv_heads=8, d_ff=2048, vocab_size=51865, n_enc_layers=6, enc_seq=1500,
    norm="layernorm", mlp="gelu", source="arXiv:2212.04356; unverified",
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-base-smoke", family="encdec", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=160, vocab_size=256, n_enc_layers=2,
    enc_seq=30, norm="layernorm", mlp="gelu", q_chunk=32,
)
