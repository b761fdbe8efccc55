"""Shared transformer building blocks: norms, RoPE, GQA attention, MLPs
(counterpart: `repro/models/layers.py`).

Parameters are nested dicts of tensors (`models.module.ParamTree` inside
the models), laid out as the reference's: a dense weight is (in, out) and is
applied as `x @ w`.  Each function keeps the reference's dtypes: norms,
RoPE angles, attention scores and values are float32 and are cast back to
the input's dtype; the products stay in the parameters' dtype, with float32
accumulation (`repro_torch.device` turns the reduced-precision bf16
reduction off).

Attention is query-chunked as in the reference: scores for one query chunk
at a time over that chunk's static key range, so prefill memory is
O(q_chunk * S) per head.  No library attention kernel is used: the port
computes the reference's own float32 function.

Training runs these functions under autograd.  The token embedding and
the MoE dispatch read rows through `gather_rows`, whose backward adds a
row's repeated gradients by a stable sort and a segment sum, never float
atomics, so a step on the card gives the same bits run to run.
`remat_block` is the reference's per-layer remat.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

NEG_INF = -1e30          # the reference's mask value


# ---------------------------------------------------------------------------
# initialisers (the port's own draws on a torch.Generator; parity tests
# carry the reference's weights across instead, `convert.lm_params_from_numpy`)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None):
    """N(0, 1) * scale, scale 1/sqrt(fan_in) by default (fan_in = shape[0])."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


def zeros(gen: torch.Generator, shape, dtype):
    return torch.zeros(shape, device=gen.device, dtype=dtype)


def full(gen: torch.Generator, shape, value: float, dtype):
    return torch.full(shape, value, device=gen.device, dtype=dtype)


# ---------------------------------------------------------------------------
# row gather with a deterministic backward
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g = grad.reshape(flat.shape[0], -1)
        order = torch.sort(flat, stable=True).indices
        rows, lengths = torch.unique_consecutive(flat[order], return_counts=True)
        sums = torch.segment_reduce(g[order].float(), "sum", lengths=lengths)
        out = torch.zeros((ctx.rows, g.shape[1]), dtype=grad.dtype, device=grad.device)
        out[rows] = sums.to(grad.dtype)
        return out.reshape(ctx.rows, *grad.shape[idx.dim():]), None


def gather_rows(table, idx):
    """`table[idx]` (idx any integer shape).  The gradient of a row read k
    times is its k gradients summed in float32 in index order (a stable sort
    and a segment sum) and rounded once to the table's dtype, where
    indexing's backward accumulates with float atomics on the card."""
    return _GatherRows.apply(table, idx)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def norm_params(gen, d_model: int, kind: str, dtype):
    if kind == "rmsnorm":
        return {"w": torch.ones((d_model,), device=gen.device, dtype=dtype)}
    return {"w": torch.ones((d_model,), device=gen.device, dtype=dtype),
            "b": zeros(gen, (d_model,), dtype)}


def apply_norm(x, p, kind: str):
    return rmsnorm(x, p["w"]) if kind == "rmsnorm" else layernorm(x, p["w"], p["b"])


# ---------------------------------------------------------------------------
# rotary position embeddings (partial-rotary capable, e.g. StableLM 25%)
# ---------------------------------------------------------------------------

def rope_freqs(rotary_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device)
                     / rotary_dim)


def apply_rope(x, positions, rotary_dim: int, theta: float):
    """x: (B, S, H, Dh); positions: (B, S) or (S,). Rotates the first
    rotary_dim channels as interleaved pairs; the rest pass through."""
    if rotary_dim == 0:
        return x
    freqs = rope_freqs(rotary_dim, theta, x.device)                 # (rd/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                      # (B, S, rd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    rot, rest = x[..., :rotary_dim].float(), x[..., rotary_dim:].float()
    r1, r2 = rot[..., ::2], rot[..., 1::2]
    out1 = r1 * cos - r2 * sin
    out2 = r2 * cos + r1 * sin
    rot = torch.stack([out1, out2], dim=-1).reshape(rot.shape)
    return torch.cat([rot, rest], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, causal / full / cross, query-chunked, sliding-window)
# ---------------------------------------------------------------------------

def attention_core(q, k, v, *, causal: bool, q_offset: int = 0, window: int = 0,
                   q_chunk: int = 1024):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D).  Returns (B, Sq, Hq, D).

    q_offset: global position of q[0] (decode writes and reads slot q_offset).
    window > 0 keeps only keys within `window` positions of the query.
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    kf = k.float()
    vf = v.float()

    def chunk_attn(qc, off: int, k_lo: int, k_hi: int):
        # grouped-head einsum: the KV tensors are never expanded to Hq heads
        cq = qc.shape[1]
        ks = kf[:, k_lo:k_hi]
        vs = vf[:, k_lo:k_hi]
        qg = qc.float().reshape(b, cq, hkv, rep, dh)
        scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, ks) * scale
        kpos = k_lo + torch.arange(k_hi - k_lo, device=q.device)
        qpos = off + torch.arange(cq, device=q.device)
        mask = torch.ones((cq, k_hi - k_lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window > 0:
            mask &= qpos[:, None] - kpos[None, :] < window
        scores = scores.masked_fill(~mask[None, None, None], NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhrqk,bkhd->bqhrd", probs, vs)
        return out.reshape(b, cq, hq, dh).to(q.dtype)

    if sq <= q_chunk:
        return chunk_attn(q, q_offset, 0, sk)

    # causal chunking with static per-chunk key ranges: query chunk i only
    # sees keys < (i+1)*c, from the window's lower bound on
    if causal and q_offset != 0:
        raise ValueError("chunked attention assumes offset 0")
    c = q_chunk
    pad = (-sq) % c
    qp = F.pad(q, (0, 0, 0, 0, 0, pad))
    outs = []
    for i in range(qp.shape[1] // c):
        qc = qp[:, i * c:(i + 1) * c]
        k_hi = min((i + 1) * c, sk) if causal else sk
        k_lo = max(0, i * c - window + 1) if (causal and window > 0) else 0
        k_lo = (k_lo // 128) * 128                     # the reference's aligned start
        outs.append(chunk_attn(qc, i * c, k_lo, k_hi))
    return torch.cat(outs, dim=1)[:, :sq]


def attn_params(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                qkv_bias: bool, dtype):
    p = {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), dtype),
        "wk": dense_init(gen, (d_model, n_kv * head_dim), dtype),
        "wv": dense_init(gen, (d_model, n_kv * head_dim), dtype),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), dtype),
    }
    if qkv_bias:
        p["bq"] = zeros(gen, (n_heads * head_dim,), dtype)
        p["bk"] = zeros(gen, (n_kv * head_dim,), dtype)
        p["bv"] = zeros(gen, (n_kv * head_dim,), dtype)
    return p


def attn_qkv(p, x, n_heads: int, n_kv: int, head_dim: int):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(b, s, n_heads, head_dim),
            k.reshape(b, s, n_kv, head_dim),
            v.reshape(b, s, n_kv, head_dim))


def attn_out(p, o):
    b, s, h, d = o.shape
    return o.reshape(b, s, h * d) @ p["wo"]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_params(gen, d_model: int, d_ff: int, dtype):
    return {"wg": dense_init(gen, (d_model, d_ff), dtype),
            "wu": dense_init(gen, (d_model, d_ff), dtype),
            "wd": dense_init(gen, (d_ff, d_model), dtype)}


def swiglu(p, x):
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def gelu_mlp_params(gen, d_model: int, d_ff: int, dtype):
    return {"w1": dense_init(gen, (d_model, d_ff), dtype),
            "b1": zeros(gen, (d_ff,), dtype),
            "w2": dense_init(gen, (d_ff, d_model), dtype),
            "b2": zeros(gen, (d_model,), dtype)}


def gelu_mlp(p, x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, mask=None):
    """logits: (B, S, V) any float dtype; labels: (B, S) int; mask: (B, S).

    Computed in float32; ignores positions where mask == 0.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

# products whose outputs a policy saves: "dots" those without a batch
# dimension (jax's dots_with_no_batch_dims_saveable), "dots_full" every one
# (dots_saveable); the rest of the block is recomputed in the backward
_SAVED = {"dots": ("mm", "addmm"), "dots_full": ("mm", "addmm", "bmm", "baddbmm")}


def _policy(saved, ctx, op, *args, **kwargs):
    name = op.overloadpacket.__name__
    return (ckpt.CheckpointPolicy.MUST_SAVE if name in saved
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_block(fn, cfg):
    """Per-layer remat with the config's policy while gradients are on:
    "nothing" recomputes the whole block in the backward (least memory),
    "dots" saves the outputs of products without a batch dimension,
    "dots_full" every product's.  Without gradients (prefill, decode) `fn`
    runs as it is."""
    if not cfg.remat:
        return fn
    kwargs = {}
    if cfg.remat_policy in _SAVED:
        policy = functools.partial(_policy, frozenset(_SAVED[cfg.remat_policy]))
        kwargs["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                 policy)
    elif cfg.remat_policy != "nothing":
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")

    def block(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return block
