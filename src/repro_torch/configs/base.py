"""Model/run configuration system (the port's own copy of
`repro/configs/base.py`, kept field for field so that a configuration means
the same model in both packages).

`ModelConfig` is a frozen dataclass covering every assigned architecture
family (dense / ssm / hybrid / moe / encdec / vlm).  Each architecture file in
this package exports `CONFIG` (the exact published configuration) and
`SMOKE_CONFIG` (a reduced same-family configuration for CPU smoke tests).

`SHAPES` defines the assigned input-shape set for LM-family architectures;
`CELLS` enumerates the (arch x shape) dry-run cells including the documented
long_500k skips for pure full-attention architectures (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    mlp: str = "swiglu"
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba1/mamba2)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_heads: int = 0               # mamba2 heads
    # hybrid (zamba2): one shared attention block every `attn_every` ssm layers
    attn_every: int = 0
    sliding_window: int = 0          # used by hybrid attn at long context
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0                 # precomputed frame embeddings length
    # vlm
    n_vision_tokens: int = 0
    # numerics / execution
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"    # nothing | dots (save matmul outputs)
    q_chunk: int = 1024
    source: str = ""                 # provenance tag from the assignment table

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding shards evenly
        over any model axis <= 256 (Megatron-style vocab padding)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for 6ND roofline."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            attn = d * self.head_dim_ * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.head_dim_ * d
            mlp = 3 * d * self.d_ff
            return emb + L * (attn + mlp)
        if self.family == "moe":
            attn = d * self.head_dim_ * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.head_dim_ * d
            moe = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
            return emb + L * (attn + moe)
        if self.family == "ssm":
            di, N = self.d_inner, self.ssm_state
            blk = d * 2 * di + di * (self.d_conv + 2 * N + 2) + di * N + di * d
            return emb + L * blk
        if self.family == "hybrid":
            di, N = self.d_inner, self.ssm_state
            blk = d * 2 * di + di * (self.d_conv + 2 * N + 2) + di * N + di * d
            attn = 4 * d * d + 3 * d * self.d_ff
            return emb + L * blk + attn
        if self.family == "encdec":
            enc = self.n_enc_layers * (4 * d * d + 2 * d * self.d_ff)
            dec = L * (8 * d * d + 2 * d * self.d_ff)
            return emb + enc + dec
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.head_dim_ * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.head_dim_ * d
        moe = self.top_k * 3 * d * self.moe_d_ff + d * self.n_experts
        return emb + L * (attn + moe)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}

ARCH_IDS = (
    "stablelm-12b", "llama3.2-1b", "glm4-9b", "qwen2.5-14b", "falcon-mamba-7b",
    "internvl2-2b", "zamba2-1.2b", "qwen3-moe-235b-a22b", "granite-moe-1b-a400m",
    "whisper-base",
)

# Families with sub-quadratic sequence mixing run long_500k; pure
# full-attention archs skip it (DESIGN.md §5).
LONG_CONTEXT_ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")


def cell_runnable(arch_id: str, shape_name: str) -> Tuple[bool, str]:
    """Whether a dry-run cell is lowered, and the reason if skipped."""
    if shape_name == "long_500k" and arch_id not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: O(L^2) attention unrepresentable at 524288 (DESIGN.md §5)"
    return True, ""


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def all_cells():
    for a in ARCH_IDS:
        for s in SHAPES:
            yield a, s.name, *cell_runnable(a, s.name)
