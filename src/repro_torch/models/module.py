"""The parameter container the port's LMs share: a module that registers a
nested dict of tensors (lists for the reference's stacked layer axes) as
parameters, so that `state_dict()` keys are the reference's tree paths with
the layer index inserted ("layers.3.attn.wq" for the reference's
`params["layers"]["attn"]["wq"][3]`).  Reading is by key, as in the
reference: `self.layers[3]["attn"]["wq"]`."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device


class ParamTree(nn.Module):
    """A nested dict of tensors as parameters, registered without
    gradients: serving runs forward only, and the train step
    (`train.train_step.make_train_step`) switches them on with
    `requires_grad_(True)`."""

    def __init__(self, tree: Optional[dict] = None):
        super().__init__()
        self._keys = []
        if tree:
            self.register_tree(tree)

    def register_tree(self, tree: dict) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, list):
                self.add_module(k, nn.ModuleList([ParamTree(x) for x in v]))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
            self._keys.append(k)

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._keys


class LM(ParamTree):
    """A model of the LM stack: its config and parameters, and decode caches
    allocated from the model class's `cache_struct(cfg, batch, max_len)`
    (name -> (shape, dtype))."""

    def init_cache(self, batch: int, max_len: int) -> dict:
        dev = self.embed["w"].device
        return {name: torch.zeros(shape, dtype=dt, device=dev)
                for name, (shape, dt) in self.cache_struct(self.cfg, batch, max_len).items()}


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def generator_for(device: DeviceLike, generator: Optional[torch.Generator]) -> torch.Generator:
    """The generator a model draws its weights from: the caller's, which
    must live on the model's device, or one seeded with 0 there."""
    dev = resolve_device(device)
    if generator is None:
        return torch.Generator(device=dev).manual_seed(0)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    return generator
