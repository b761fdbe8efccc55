"""Pipeline parallelism: the SPMD microbatch pipeline over the ranks of a
process group (counterpart: `repro/launch/pipeline.py`).

Rank p holds stage p's parameters.  Activations flow stage to stage around
a ring of point-to-point sends (`dist.batch_isend_irecv`, the reference's
`ppermute` with its permutation i -> i + 1 mod n), and microbatches keep
every stage busy after the fill: n_micro + n_stages - 1 ticks, the
reference's schedule tick for tick, written by hand
(`torch.distributed.pipelining` wants `nn.Module` stages and schedules of
its own).

    out = spmd_pipeline(stage_fn, stage_params, x_microbatches, group)

stage_params: a tree (dict / list / tuple) of tensors with a leading axis
of n_stages (every rank passes the whole stack; rank p uses row p).
x_microbatches: (n_micro, mb, ...), the same on every rank.
Returns (n_micro, mb, ...) outputs as the last stage produced them, the
same on every rank (one all_reduce of the outputs masked to the last
stage's, the reference's psum).  A group of one rank hands each tick's
output to itself without a send.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map


def spmd_pipeline(stage_fn, stage_params, xs: torch.Tensor, group=None) -> torch.Tensor:
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_micro = xs.shape[0]
    ticks = n_micro + n_stages - 1
    local = tree_map(lambda a: a[stage], stage_params)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages) if group else (stage + 1) % n_stages
    prv = dist.get_global_rank(group, (stage - 1) % n_stages) if group else (stage - 1) % n_stages

    recv = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
    outs = torch.zeros_like(xs)
    for t in range(ticks):
        # stage 0 ingests microbatch t (while there is one); the others take
        # what the previous stage handed over last tick
        inp = xs[min(t, n_micro - 1)] if stage == 0 else recv
        out = stage_fn(local, inp)
        # the last stage commits microbatch t - n_stages + 1
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = out
        if n_stages == 1:
            recv = out
            continue
        out = out.contiguous()
        recv = torch.empty_like(out)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, out, nxt, group),
                                           dist.P2POp(dist.irecv, recv, prv, group)]):
            req.wait()
    mask = torch.tensor(1.0 if stage == n_stages - 1 else 0.0, dtype=xs.dtype,
                        device=xs.device)
    outs = outs * mask
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs
