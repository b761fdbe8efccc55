"""Unified model API (counterpart: `repro/models/api.py`):
`build_model(cfg)` and the shapes and dtypes of a cell's inputs and caches,
computed from the config without allocating anything (the reference uses
`jax.eval_shape`).

Batch dict conventions (integer tokens):
  train/prefill: {"tokens": (B, S)[, "labels": (B, S)][, "patch_embeds"]
                  [, "enc_frames"]}
  decode:        tokens (B, 1) + cache dict + pos (an int)

The mesh specs: each model's `param_specs(mode)` / `cache_specs()`, and
here `batch_specs`, `param_specs_with_dp` and `cache_specs_with_dp`, which
widen the "data" axis to a mesh's data-parallel axes (`launch.mesh.dp_axes`).
Specs are `repro_torch.sharding.P`; parameter specs are keyed by
`state_dict()` key.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike
from repro_torch.sharding import P, swap_dp

from .hybrid import HybridLM
from .ssm import MambaLM
from .transformer import TransformerLM
from .whisper import EncDecLM

Struct = Tuple[Tuple[int, ...], torch.dtype]      # (shape, dtype)

MODELS = {"dense": TransformerLM, "vlm": TransformerLM, "moe": TransformerLM,
          "ssm": MambaLM, "hybrid": HybridLM, "encdec": EncDecLM}


def model_class(cfg: ModelConfig):
    try:
        return MODELS[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}") from None


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None):
    """The model of `cfg` on `device` (default: the CUDA device, raising
    without one), its weights drawn from `generator` (one on that device;
    default: seeded with 0)."""
    return model_class(cfg)(cfg, device=device, generator=generator)


def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Struct]:
    """Shapes and dtypes of the train/prefill batch of one (arch, shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32
    if cfg.family == "vlm":
        s_text = S - cfg.n_vision_tokens
        return {"tokens": ((B, s_text), tok), "labels": ((B, s_text), tok),
                "patch_embeds": ((B, cfg.n_vision_tokens, cfg.d_model), torch.bfloat16)}
    batch = {"tokens": ((B, S), tok), "labels": ((B, S), tok)}
    if cfg.family == "encdec":
        batch["enc_frames"] = ((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return batch


def _dp(dp_axes):
    return tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]


def batch_specs(cfg: ModelConfig, dp_axes) -> Dict[str, P]:
    """Specs of `batch_struct`'s tensors: the batch dim over `dp_axes`, e.g.
    ("data",) or ("pod", "data")."""
    dp = _dp(dp_axes)
    specs = {"tokens": P(dp, None), "labels": P(dp, None)}
    if cfg.family == "vlm":
        specs["patch_embeds"] = P(dp, None, None)
    if cfg.family == "encdec":
        specs["enc_frames"] = P(dp, None, None)
    return specs


def param_specs_with_dp(model, mode: str, dp_axes) -> Dict[str, P]:
    """The model's parameter specs with the FSDP axis widened to dp_axes
    (multi-pod meshes)."""
    dp = _dp(dp_axes)
    return {k: swap_dp(s, dp) for k, s in model.param_specs(mode).items()}


def cache_specs_with_dp(model, dp_axes, batch_size: int = 0) -> Dict[str, P]:
    """The model's cache specs with the 'data' batch axis swapped for
    dp_axes; a batch of 1 (long_500k) is replicated."""
    dp = _dp(dp_axes)
    return {k: swap_dp(s, dp, replicate=batch_size == 1)
            for k, s in model.cache_specs().items()}


def param_structs(cfg: ModelConfig) -> Dict[str, Struct]:
    """Shapes and dtypes of the model's parameters by `state_dict()` key,
    from a model built on fake tensors (nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        model = build_model(cfg, device="cpu")
        return {k: (tuple(p.shape), p.dtype) for k, p in model.named_parameters()}


def decode_struct(cfg: ModelConfig, shape: ShapeConfig):
    """(tokens, cache, pos) shapes and dtypes of a decode cell: one new token
    against a cache of length shape.seq_len."""
    B, S = shape.global_batch, shape.seq_len
    return ((B, 1), torch.int32), model_class(cfg).cache_struct(cfg, B, S), ((), torch.int32)


def random_inputs(cfg: ModelConfig, batch: int, prompt_len: int,
                  generator: torch.Generator) -> dict:
    """A prompt of uniform tokens, with the stub frontends' inputs the
    family needs (VLM patch embeddings, encoder frames) as N(0, 1) in the
    parameters' dtype, drawn from `generator` on its device."""
    dev = generator.device
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=generator, device=dev)}
    dt = getattr(torch, cfg.param_dtype)
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.randn((batch, cfg.n_vision_tokens, cfg.d_model),
                                          generator=generator, device=dev).to(dt)
    if cfg.family == "encdec":
        out["enc_frames"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                        generator=generator, device=dev).to(dt)
    return out
