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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def capacity(cfg, n_tokens: int) -> int:
    return max(1, int(math.ceil(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)))


def moe_block(p, x, cfg):
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
    counts = torch.bincount(e_flat, minlength=E)
    start = torch.cumsum(counts, 0) - counts                    # exclusive prefix
    pos_in_e = torch.arange(T * k, device=dev) - start[e_sorted]
    dst = torch.where(pos_in_e < C, e_sorted * C + pos_in_e, E * C)   # E*C: dropped

    # slot E*C collects the dropped assignments and is cut off
    disp_tok = torch.zeros(E * C + 1, dtype=torch.long, device=dev)
    disp_tok[dst] = tok_flat[order]
    disp_tok = disp_tok[:E * C]

    # 4. expert batch (E, C, D); slots never written hold token 0 and are
    # read by no token
    xe = L.gather_rows(xt, disp_tok).reshape(E, C, D)
    hg = F.silu(torch.bmm(xe, p["wg"]))
    hu = torch.bmm(xe, p["wu"])
    he = torch.bmm(hg * hu, p["wd"])                            # (E, C, D)

    # 5. combine: every assignment reads its slot's output (a dropped one
    # reads the zero row E*C), gated, summed over the k slots in order
    slot = torch.empty(T * k, dtype=torch.long, device=dev)
    slot[order] = dst
    rows = torch.cat([he.reshape(E * C, D).float(),
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
