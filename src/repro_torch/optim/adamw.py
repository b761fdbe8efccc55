"""AdamW with a warm-up and cosine schedule (counterpart:
`repro/optim/adamw.py`), as plain functions on a dict or a list of tensors.

The reference's arithmetic, leaf by leaf: the gradient is clipped by the
global norm (`+ 1e-9` in the denominator), the moments `m` and `v` are
float32 whatever the parameter's dtype, and the update is computed in
float32 and rounded once into the parameter's dtype.  There is no float32
master copy, because the reference keeps none.  `torch.optim.AdamW` is not
used: its moments follow the parameter's dtype (bf16 for a bf16 model) and
it orders the decay and the bias correction otherwise.

`update` writes the parameters and the moments in place (the parameters
are the model's own, so the model trains) and returns them.  It walks the
leaves in chunks of at most CHUNK_ELEMENTS with `torch._foreach_*` ops, so
its float32 temporaries stay near the largest leaf's size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Sequence, Union

import torch

Tree = Union[dict, list, tuple]

CHUNK_ELEMENTS = 1 << 28      # float32 temporaries of one chunk: 1 GiB each


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    m: Tree
    v: Tree
    count: torch.Tensor            # int32, 0-d; the schedule starts at 1


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a dict (in its order) or a list / tuple."""
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def like(tree: Tree, values: Sequence[torch.Tensor]) -> Tree:
    """`values` in the structure of `tree` (a dict's keys, or a list)."""
    return dict(zip(tree, values)) if isinstance(tree, dict) else list(values)


def init(params: Tree) -> AdamWState:
    # zeros_like: a DTensor parameter gets moments of its placements
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
    device = zeros[0].device if zeros else None
    return AdamWState(m=like(params, zeros),
                      v=like(params, [torch.zeros_like(z) for z in zeros]),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def state_specs(param_specs) -> AdamWState:
    """The moments shard as the parameters do (ZeRO-style sharding comes
    from the FSDP axis of the parameter specs); the count is replicated."""
    from repro_torch.sharding import P
    return AdamWState(m=dict(param_specs), v=dict(param_specs), count=P())


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a tensor), in float32 as the reference's."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, the leaves' sums
    added in order (the reference's Python `sum`)."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _chunks(n_elements: Sequence[int]):
    """Consecutive index ranges of at most CHUNK_ELEMENTS elements each
    (a larger leaf alone)."""
    start, size = 0, 0
    for i, n in enumerate(n_elements):
        if i > start and size + n > CHUNK_ELEMENTS:
            yield start, i
            start, size = i, 0
        size += n
    if start < len(n_elements):
        yield start, len(n_elements)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Tree, state: AdamWState, params: Tree):
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}): the
    parameters, `m` and `v` updated in place, a new `count`."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = 1.0 - torch.pow(cfg.b1, count.float())
    b2c = 1.0 - torch.pow(cfg.b2, count.float())
    ps, gs, ms, vs = leaves(params), leaves(grads), leaves(state.m), leaves(state.v)
    for lo, hi in _chunks([p.numel() for p in ps]):
        p, m, v = ps[lo:hi], ms[lo:hi], vs[lo:hi]
        g = torch._foreach_mul([x.float() for x in gs[lo:hi]], clip)
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        gg = torch._foreach_mul(g, 1 - cfg.b2)               # ((1 - b2) g) g, as written
        torch._foreach_mul_(gg, g)
        del g
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_add_(v, gg)
        del gg
        step = torch._foreach_div(m, b1c)                    # mhat
        den = torch._foreach_div(v, b2c)                     # vhat
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        torch._foreach_div_(step, den)
        del den
        p32 = [x.float() for x in p]
        torch._foreach_add_(step, torch._foreach_mul(p32, cfg.weight_decay))
        torch._foreach_mul_(step, lr)
        new = torch._foreach_sub(p32, step)
        del step, p32
        for dst, src in zip(p, new):
            dst.copy_(src)
    return params, AdamWState(state.m, state.v, count), {"grad_norm": gnorm, "lr": lr}
