"""Int8 gradient compression with error feedback for the data-parallel
all-reduce (counterpart: `repro/optim/grad_compress.py`), on
`torch.distributed`.

Each rank keeps a float32 residual per leaf ("error feedback") and adds it
to its gradient before quantising.  `compressed_psum` agrees one scale a
leaf across ranks (an `all_reduce` of MAX on max |g + e|), sums the int8
payloads widened to int32 (an `all_reduce` of SUM, no overflow across
ranks), and divides by the world size.  The group is a gloo group on the
CPU or an NCCL group with one rank a card (`core/distributed.init_group`).
`torch.round` rounds half to even, as `jnp.round` does.

The reference's trainer promises a `--compress-grads` flag that its parser
does not have; the port's trainer has none either, and this module is
reached from its tests and from chip_smoke.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .adamw import Tree, leaves, like


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return amax / 127.0 + 1e-12


def _payload(gc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(gc / scale), -127, 127).to(torch.int8)


def quantize(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                          torch.Tensor]:
    """-> (int8 payload, float32 scale, new float32 residual)."""
    gc = g.float() + err
    scale = _scale(torch.max(torch.abs(gc)))
    q = _payload(gc, scale)
    return q, scale, gc - q.float() * scale


def init_error(params: Tree) -> Tree:
    return like(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for p in leaves(params)])


def compressed_psum(grads: Tree, errors: Tree, group: Optional[dist.ProcessGroup] = None):
    """All-reduce `grads` in int8 with error feedback over `group` (default:
    the world).  Returns (mean-reduced float32 grads, new residuals)."""
    n = dist.get_world_size(group)
    out, new_errors = [], []
    for g, e in zip(leaves(grads), leaves(errors)):
        gc = g.float() + e
        amax = torch.max(torch.abs(gc))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = _scale(amax)
        q = _payload(gc, scale)
        new_errors.append(gc - q.float() * scale)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        out.append(total.float() * scale / n)
    return like(grads, out), like(errors, new_errors)


def wire_bytes(params: Tree, compressed: bool) -> int:
    """Bytes a rank puts on the wire per all-reduce round: 1 a value for the
    int8 payload, 4 for float32 (the reference's count; the int32 widening
    of the sum and the scalar scales are not counted)."""
    per = 1 if compressed else 4
    return sum(p.numel() * per for p in leaves(params))
