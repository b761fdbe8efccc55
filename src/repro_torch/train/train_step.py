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

On a device mesh the parameters are DTensors (`sharding.distribute_model`
under the train specs), and so are the gradients, the float32
accumulators and the AdamW moments, in the parameters' placements; the
batch is sharded over the data-parallel axes (`models.api.batch_specs`),
and so is each microbatch, the same rows as the reference's.  `param_constraint`
({state_dict key: P}, e.g. the serve specs) is the reference's
`with_sharding_constraint`: the parameters are redistributed to it once at
the top of a step (one FSDP all-gather, not one a microbatch), each
microbatch's gradients are taken there and redistributed back to the
parameters' placements into the accumulators.  The step runs under
`implicit_replication`, so the plain tensors the models make count as
replicated.  Without DTensors none of this runs.

`state_tree` lays (params, opt_state) out as the reference's training
checkpoint does (the layer axes stacked), so either package resumes the
other's run; `load_state_tree` copies such a tree back into the live
tensors.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import convert, sharding
from repro_torch.optim import adamw


def train_params(model) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters by `state_dict()` key, with gradients on."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def _rows(x, n_micro: int, i: int):
    """Microbatch i of x's rows.  A DTensor batch is gathered whole, cut,
    and sharded again as it was (the batch is small beside the step)."""
    if not isinstance(x, DTensor):
        return x.chunk(n_micro)[i]
    return sharding.replicated(x, dims=[0]).chunk(n_micro)[i].redistribute(
        x.device_mesh, x.placements)


def split_microbatches(batch: Dict[str, torch.Tensor], n_micro: int):
    """`n_micro` batches of B / n_micro rows each, in order."""
    for k, x in batch.items():
        rows = x.shape[0]
        if rows % n_micro:
            raise ValueError(f"batch {k!r} of {rows} rows does not split into "
                             f"{n_micro} microbatches")
    return [{k: _rows(x, n_micro, i) for k, x in batch.items()} for i in range(n_micro)]


@contextlib.contextmanager
def _using(model, tensors: Mapping[str, torch.Tensor]):
    """The model reads `tensors` in place of its parameters of those keys."""
    owners = dict(model.named_modules())
    saved = []
    for key, t in tensors.items():
        owner, _, name = key.rpartition(".")
        mod = owners[owner]
        saved.append((mod, name, mod._parameters[name]))
        mod._parameters[name] = t
    try:
        yield
    finally:
        for mod, name, p in saved:
            mod._parameters[name] = p


def _sharded(leaves) -> bool:
    return bool(leaves) and isinstance(leaves[0], DTensor)


def make_grads_fn(model, n_micro: int = 1,
                  param_constraint: Optional[Mapping[str, sharding.P]] = None):
    """Returns grads_of(leaves, batch) -> (loss, float32 gradients of
    `leaves`, in order): the loss and gradients of the batch, averaged over
    `n_micro` microbatches.  `leaves` are the model's parameters in
    `named_parameters()` order; `param_constraint` as in make_train_step."""

    def grads_of(leaves, batch):
        sharded = _sharded(leaves)
        with implicit_replication() if sharded else contextlib.nullcontext():
            return _grads(leaves, batch, sharded)

    def _grads(leaves, batch, sharded):
        used, swap = leaves, contextlib.nullcontext()
        if param_constraint is not None and sharded:
            names = [k for k, _ in model.named_parameters()]
            used = [p.redistribute(p.device_mesh, sharding.placements(
                        param_constraint[k], p.device_mesh, p.dim())).detach().requires_grad_()
                    for k, p in zip(names, leaves)]
            swap = _using(model, dict(zip(names, used)))

        def back(grads):
            if used is leaves:
                return grads
            return [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, leaves)]

        with swap:
            if n_micro == 1:
                loss = model.loss(batch)
                grads = back(torch.autograd.grad(loss, used))
                return loss.detach(), [g.float() for g in grads]
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for mb in split_microbatches(batch, n_micro):
                loss = model.loss(mb)
                grads = back(torch.autograd.grad(loss, used))
                torch._foreach_add_(acc, grads)            # float32 += g, exactly widened
                del grads
                loss_sum = loss_sum + loss.detach()
            inv = 1.0 / n_micro
            torch._foreach_mul_(acc, inv)
            return loss_sum * inv, acc

    return grads_of


def _plain(t):
    """A DTensor metric as a plain tensor (whole on every rank)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(model, opt_cfg: adamw.AdamWConfig, n_micro: int = 1,
                    param_constraint: Optional[Mapping[str, sharding.P]] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics {"loss", "grad_norm", "lr"} (0-d tensors on the
    model's device).  `params` is `train_params(model)`.

    param_constraint: {state_dict key: P} the DTensor parameters are
    redistributed to once at the top of a step (ignored for plain
    parameters)."""
    grads_of = make_grads_fn(model, n_micro, param_constraint)

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(adamw.leaves(params), batch)
        with implicit_replication() if _sharded(adamw.leaves(params)) \
                else contextlib.nullcontext():
            params, opt_state, metrics = adamw.update(opt_cfg, adamw.like(params, grads),
                                                      opt_state, params)
        metrics = {k: _plain(v) for k, v in dict(metrics, loss=loss).items()}
        return params, opt_state, metrics

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
