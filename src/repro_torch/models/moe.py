"""Top-k MoE block with capacity-bounded sort-based dispatch (counterpart:
`repro/models/moe.py`).

  1. router: softmax over E experts in float32, top-k gates per token;
  2. flatten (token, expert) assignments, stable-sort them by expert id;
  3. position within the expert from an exclusive cumsum of the per-expert
     counts; assignments past capacity C = ceil(cf * T * k / E) are dropped;
  4. gather tokens into the (E, C, D) expert batch and run all experts as
     batched products (`layers.gather_rows`: a token read by k slots, and
     token 0 read by every unused slot, gets its gradient summed in a fixed
     order);
  5. combine: each token gathers its k slots' gated outputs (a dropped slot
     gives 0) and adds them in slot order.  The reference scatter-adds
     instead; the gather keeps float atomics out, so the combine gives the
     same bits run to run on the card.

On a device mesh (x a DTensor) every device routes the whole token batch
as above (the same indices everywhere: the capacity is the global one, as
in the reference) and then runs its own part of the (E, C) slots: the
experts its 'model' coordinate holds (the experts' dim is sharded over
'model') and a share of the capacity slots by its data-parallel
coordinate.  Its share of the combine is summed over the devices.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding import P

from . import layers as L


def moe_params(gen, cfg, dt):
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    return {
        "router": {"w": L.dense_init(gen, (D, E), torch.float32)},
        # fan_in is the leading axis, E, as in the reference
        "wg": L.dense_init(gen, (E, D, Fd), dt),
        "wu": L.dense_init(gen, (E, D, Fd), dt),
        "wd": L.dense_init(gen, (E, Fd, D), dt, scale=1.0 / math.sqrt(Fd)),
    }


def moe_specs(cfg, fsdp):
    """Experts over 'model' (expert parallelism), FSDP over `fsdp`."""
    return {
        "router": {"w": P(None, None)},
        "wg": P("model", fsdp, None),
        "wu": P("model", fsdp, None),
        "wd": P("model", None, fsdp),
    }


def capacity(cfg, n_tokens: int) -> int:
    return max(1, int(math.ceil(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)))


def moe_block(p, x, cfg):
    if isinstance(x, DTensor):
        return _moe_sharded(p, x, cfg)
    return _moe_local(p, x, cfg)


def _chunk_range(n: int, parts: int, i: int) -> tuple:
    """Part i of range(n) cut as `torch.chunk` cuts n into `parts`."""
    size = -(-n // parts)
    return min(n, i * size), min(n, (i + 1) * size)


def _moe_sharded(p, x, cfg):
    """moe_block on DTensors: each device's slots as plain tensors."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    n = mesh.ndim
    tp_dim = names.index("model")
    rep, part = [Replicate()] * n, [Partial()] * n
    coord = mesh.get_coordinate()
    dp_dims = [i for i in range(n) if i != tp_dim]
    dp_size, dp_rank = 1, 0
    for i in dp_dims:                                  # major to minor
        dp_size, dp_rank = dp_size * mesh.size(i), dp_rank * mesh.size(i) + coord[i]
    C = capacity(cfg, x.shape[0] * x.shape[1])
    e_rng = _chunk_range(cfg.n_experts, mesh.size(tp_dim), coord[tp_dim])
    c_rng = _chunk_range(C, dp_size, dp_rank)
    experts = [Shard(0) if i == tp_dim else Replicate() for i in range(n)]
    experts_grad = [Shard(0) if i == tp_dim else Partial() for i in range(n)]
    local = {"router": {"w": p["router"]["w"].redistribute(mesh, rep).to_local(
        grad_placements=part)}}
    for k in ("wg", "wu", "wd"):
        local[k] = p[k].redistribute(mesh, experts).to_local(grad_placements=experts_grad)
    if mesh.size() != dist.get_world_size():
        raise ValueError("the MoE block's mesh must span the process group")
    xl = x.redistribute(mesh, rep).to_local(grad_placements=part)
    out = _SumOverRanks.apply(_moe_local(local, xl, cfg, e_rng + c_rng))
    return DTensor.from_local(out, mesh, rep, run_check=False).redistribute(mesh, x.placements)


class _SumOverRanks(torch.autograd.Function):
    """Every rank's share summed on every rank (one all_reduce); the
    gradient passes unchanged, since each share reaches the sum once and
    every rank holds the sum's whole gradient."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad


def _moe_local(p, x, cfg, part=None):
    """The block on plain tensors; with `part` = (e_lo, e_hi, c_lo, c_hi)
    only those experts (p's expert weights hold just them) and capacity
    slots run, and the result is this part's share of the combine."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    xt = x.reshape(T, D)
    dev = x.device

    # 1. routing (float32)
    logits = xt.float() @ p["router"]["w"]
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.topk(probs, k, dim=-1)                  # (T, k)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)

    # 2-3. sort assignments by expert, in-expert positions, capacity drops
    e_flat = eids.reshape(-1)                                   # (T*k,)
    tok_flat = torch.arange(T * k, device=dev) // k
    order = torch.sort(e_flat, stable=True).indices
    e_sorted = e_flat[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, e_flat, torch.ones_like(e_flat))                     # bincount, no data-sized output
    start = torch.cumsum(counts, 0) - counts                    # exclusive prefix
    pos_in_e = torch.arange(T * k, device=dev) - start[e_sorted]
    dst = torch.where(pos_in_e < C, e_sorted * C + pos_in_e, E * C)   # E*C: dropped

    # slot E*C collects the dropped assignments and is cut off
    disp_tok = torch.zeros(E * C + 1, dtype=torch.long, device=dev)
    disp_tok[dst] = tok_flat[order]
    disp_tok = disp_tok[:E * C]

    # 4. expert batch (E, C, D); slots never written hold token 0 and are
    # read by no token
    if part is None:
        xe = L.gather_rows(xt, disp_tok).reshape(E, C, D)
    else:
        e_lo, e_hi, c_lo, c_hi = part
        mine = disp_tok.reshape(E, C)[e_lo:e_hi, c_lo:c_hi]
        xe = L.gather_rows(xt, mine.reshape(-1)).reshape(e_hi - e_lo, c_hi - c_lo, D)
    hg = F.silu(torch.bmm(xe, p["wg"]))
    hu = torch.bmm(xe, p["wu"])
    he = torch.bmm(hg * hu, p["wd"])                            # (E, C, D)

    # 5. combine: every assignment reads its slot's output (a dropped one
    # reads the zero row E*C), gated, summed over the k slots in order
    slot = torch.empty(T * k, dtype=torch.long, device=dev)
    slot[order] = dst
    n_rows = E * C
    if part is not None:        # this part's slots; the others read the zero row
        e, c = slot // C, slot % C
        n_rows = (e_hi - e_lo) * (c_hi - c_lo)
        held = (e >= e_lo) & (e < e_hi) & (c >= c_lo) & (c < c_hi)
        slot = torch.where(held, (e - e_lo) * (c_hi - c_lo) + (c - c_lo), n_rows)
    rows = torch.cat([he.reshape(n_rows, D).float(),
                      torch.zeros(1, D, dtype=torch.float32, device=dev)])
    contrib = (L.gather_rows(rows, slot) * gates.reshape(-1)[:, None]).reshape(T, k, D)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out.reshape(B, S, D).to(x.dtype)


def load_balance_loss(p, x, cfg):
    """Auxiliary load-balancing loss (Switch-style): E * sum_e f_e * p_e.
    No loss calls it, as in the reference."""
    B, S, D = x.shape
    T = B * S
    logits = x.reshape(T, D).float() @ p["router"]["w"]
    probs = torch.softmax(logits, dim=-1)
    _, eids = torch.topk(probs, cfg.top_k, dim=-1)
    f = torch.mean(F.one_hot(eids, cfg.n_experts).float(), dim=(0, 1))
    pmean = torch.mean(probs, dim=0)
    return cfg.n_experts * torch.sum(f * pmean)
