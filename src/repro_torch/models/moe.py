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
     gives 0) and adds them in float32 in slot order.  The reference scatter-adds
     instead; the gather keeps float atomics out, so the combine gives the
     same bits run to run on the card.

On a device mesh (x a DTensor) the tokens stay sharded by batch over the
data-parallel mesh dims, and the capacity and the drop set stay the
reference's global ones: C over the global microbatch, positions in
global token order.  Each device routes its own tokens, the data-parallel
ranks exchange their per-expert counts (E integers, one all-gather a
data-parallel mesh dim), and the exclusive prefix of the counts of the
ranks before it gives each of its assignments its global position in its
expert.  It then runs the experts its 'model' coordinate holds (the
experts' dim is sharded over 'model') on the kept slots of its own tokens,
at most min(C, its tokens) an expert (a static bound: a rank's tokens may
all pick one expert), and its share of each token's combine, the slots of
its experts in slot order, is added over 'model' by one all_reduce in
float32 (the collective's fixed order) and rounded once.  No token is
gathered.
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


def _counts_before(counts, mesh, dims) -> torch.Tensor:
    """The sum of `counts` (E,) over the ranks before this one along the
    data-parallel mesh `dims` (major to minor): one all_gather a dim."""
    coord = mesh.get_coordinate()
    before = torch.zeros_like(counts)
    total = counts
    for i in reversed(dims):                    # minor first: a block of ranks at a time
        size = mesh.size(i)
        parts = [torch.empty_like(total) for _ in range(size)]
        dist.all_gather(parts, total.contiguous(), group=mesh.get_group(i))
        before = before + sum(parts[:coord[i]], torch.zeros_like(counts))
        total = sum(parts, torch.zeros_like(counts))
    return before


def _moe_sharded(p, x, cfg):
    """moe_block on DTensors: each device's tokens and experts as plain
    tensors (see the module docstring)."""
    mesh = x.device_mesh
    n = mesh.ndim
    tp_dim = L.model_dim(mesh)
    xpl = [Replicate() if i == tp_dim else (Shard(0) if pl == Shard(0) else Replicate())
           for i, pl in enumerate(x.placements)]
    if xpl != list(x.placements):
        x = x.redistribute(mesh, xpl)
    split = [i for i in range(n) if xpl[i] == Shard(0)]     # the token shards, major first
    ranks = math.prod(mesh.size(i) for i in split)
    C = capacity(cfg, x.shape[0] * x.shape[1])
    tp, t = (1, 0) if tp_dim is None else (mesh.size(tp_dim), mesh.get_coordinate()[tp_dim])
    e_lo, e_hi = _chunk_range(cfg.n_experts, tp, t)

    def grads(model_pl):
        return [model_pl if i == tp_dim else (Partial() if i in split else Replicate())
                for i in range(n)]

    rep = [Replicate()] * n
    local = {"router": {"w": p["router"]["w"].redistribute(mesh, rep).to_local(
        grad_placements=grads(Partial()))}}
    experts = [Shard(0) if i == tp_dim else Replicate() for i in range(n)]
    for k in ("wg", "wu", "wd"):
        local[k] = p[k].redistribute(mesh, experts).to_local(grad_placements=grads(Shard(0)))
    xl = x.to_local(grad_placements=[Partial() if i == tp_dim else pl
                                     for i, pl in enumerate(xpl)])
    T_l = xl.shape[0] * xl.shape[1]
    part = (e_lo, e_hi, C if ranks == 1 else min(C, T_l),
            lambda counts: _counts_before(counts, mesh, split))
    out = _moe_local(local, xl, cfg, C, part)
    if tp > 1:
        out = L.sum_over(out, mesh.get_group(tp_dim))
    return DTensor.from_local(out.to(x.dtype), mesh, xpl, run_check=False)


def _moe_local(p, x, cfg, C=None, part=None):
    """The block on plain tensors; with capacity C (the global microbatch's)
    and `part` = (e_lo, e_hi, slots, counts_before), a device's share: its
    tokens x, its experts e_lo .. e_hi - 1 (p's expert weights hold just
    them) with `slots` slots each, an assignment's position in its expert
    offset by `counts_before(counts)` (the assignments of the ranks before
    it), and the float32 share of the combine its experts give."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T) if C is None else C
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
    if part is None:
        e_lo, e_hi, slots = 0, E, C
        kept = pos_in_e < C
    else:
        e_lo, e_hi, slots, counts_before = part
        kept = (pos_in_e + counts_before(counts)[e_sorted] < C) & (e_sorted >= e_lo) \
            & (e_sorted < e_hi)
    n_rows = (e_hi - e_lo) * slots
    dst = torch.where(kept, (e_sorted - e_lo) * slots + pos_in_e, n_rows)   # n_rows: dropped

    # slot n_rows collects the dropped assignments and is cut off
    disp_tok = torch.zeros(n_rows + 1, dtype=torch.long, device=dev)
    disp_tok[dst] = tok_flat[order]
    disp_tok = disp_tok[:n_rows]

    # 4. expert batch (experts, slots, D); slots never written hold token 0
    # and are read by no token
    xe = L.gather_rows(xt, disp_tok).reshape(e_hi - e_lo, slots, D)
    hg = F.silu(torch.bmm(xe, p["wg"]))
    hu = torch.bmm(xe, p["wu"])
    he = torch.bmm(hg * hu, p["wd"])                            # (experts, slots, D)

    # 5. combine: every assignment reads its slot's output (a dropped one,
    # or one of another device's experts, reads 0), gated, summed over the k
    # slots in order
    slot = torch.empty(T * k, dtype=torch.long, device=dev)
    slot[order] = dst
    out = _combine(he.reshape(n_rows, D), slot.reshape(T, k), gates).reshape(B, S, D)
    return out if part is not None else out.to(x.dtype)


def _combine(he, slot, gates):
    """The combine in float32: every token's k slot outputs (the rows of he
    (n_rows, D) its slots (T, k) read, 0 for slot n_rows) read in one
    gather, gated and added in slot order.  A row of he is read by one slot
    at most, so its gradient is that slot's, rounded once to he's dtype."""
    keep = slot < he.shape[0]
    read = L.gather_rows(he, torch.where(keep, slot, 0), keep)        # (T, k, D)
    out = read[:, 0].float() * gates[:, :1]
    for j in range(1, slot.shape[1]):
        out = out + read[:, j].float() * gates[:, j:j + 1]
    return out


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
