"""Train step of the LM stack (counterpart: `repro/train/train_step.py`):
loss -> gradients (optionally over microbatches) -> AdamW.

Autograd stands where the reference's `jax.value_and_grad` does, through
the models' `loss` (each layer rematerialised per the config,
`models.layers.remat_block`).  The gradients come back in the parameters'
dtype and are cast to float32 before the clip, as the reference's are.
With `n_micro > 1` the batch is cut into `n_micro` microbatches along its
first axis; each microbatch's gradients (`torch.autograd.grad`, never
`.backward()` into bf16 `.grad` buffers) are added into float32 buffers
and scaled by 1 / n_micro at the end, and so is the loss, as the
reference's scan accumulates them.

The parameters are the model's own tensors (`train_params(model)`); the
step updates them in place, so the model trains, and returns them in the
reference's (params, opt_state, metrics) shape.

`state_tree` lays (params, opt_state) out as the reference's training
checkpoint does (the layer axes stacked), so either package resumes the
other's run; `load_state_tree` copies such a tree back into the live
tensors.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import convert
from repro_torch.optim import adamw


def train_params(model) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters by `state_dict()` key, with gradients on."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def split_microbatches(batch: Dict[str, torch.Tensor], n_micro: int):
    """`n_micro` batches of B / n_micro rows each, in order."""
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {k!r} of {x.shape[0]} rows does not split into "
                             f"{n_micro} microbatches")
    return [{k: x.chunk(n_micro)[i] for k, x in batch.items()} for i in range(n_micro)]


def make_grads_fn(model, n_micro: int = 1):
    """Returns grads_of(leaves, batch) -> (loss, float32 gradients of
    `leaves`, in order): the loss and gradients of the batch, averaged over
    `n_micro` microbatches."""

    def grads_of(leaves, batch):
        if n_micro == 1:
            loss = model.loss(batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), [g.float() for g in grads]
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for mb in split_microbatches(batch, n_micro):
            loss = model.loss(mb)
            grads = torch.autograd.grad(loss, leaves)
            torch._foreach_add_(acc, grads)            # float32 += g, exactly widened
            del grads
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / n_micro
        torch._foreach_mul_(acc, inv)
        return loss_sum * inv, acc

    return grads_of


def make_train_step(model, opt_cfg: adamw.AdamWConfig, n_micro: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics {"loss", "grad_norm", "lr"} (0-d tensors on the
    model's device).  `params` is `train_params(model)`."""
    grads_of = make_grads_fn(model, n_micro)

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(adamw.leaves(params), batch)
        params, opt_state, metrics = adamw.update(opt_cfg, adamw.like(params, grads),
                                                  opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def make_eval_step(model):
    def eval_step(batch):
        with torch.no_grad():
            return model.loss(batch)
    return eval_step


def state_tree(params, opt_state: adamw.AdamWState):
    """(params, opt_state) as the reference's `(params, opt_state)` tree, on
    the host: `CheckpointManager.save` writes it under the reference's keys
    (`0/layers/attn/wq`, `1/.m/...`, `1/.v/...`, `1/.count`)."""
    stack = convert.lm_tree_from_state
    return (stack(params), adamw.AdamWState(stack(opt_state.m), stack(opt_state.v),
                                            opt_state.count.detach().cpu()))


@torch.no_grad()
def load_state_tree(tree, params, opt_state: adamw.AdamWState) -> adamw.AdamWState:
    """Copy a `state_tree` layout (read back by `CheckpointManager.restore`)
    into the live parameters and moments; returns the state with the
    stored count."""
    saved_params, saved = tree
    for live, stored in ((params, saved_params), (opt_state.m, saved.m),
                         (opt_state.v, saved.v)):
        flat = convert.lm_state_from_numpy(stored)
        if sorted(flat) != sorted(live):
            raise ValueError("the checkpoint holds another model's tree")
        for k, t in live.items():
            t.copy_(flat[k])
    return adamw.AdamWState(opt_state.m, opt_state.v, saved.count.to(opt_state.count.device))
