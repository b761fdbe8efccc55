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

On a device mesh the parameters are DTensors (`repro_torch.sharding`) and
the functions run on DTensor as written, except where each device's part
runs as plain tensors (a `local_map` by hand, its results and gradients
carrying the right placements), sharded as the reference's specs shard:
`gather_rows` from a table sharded by rows over 'model' (a vocab-parallel
lookup: each device reads the rows of its shard, one all_reduce over
'model' adds them), `cross_entropy` (vocab-parallel: the max, the sum of
exponentials and the gold logit each all-reduced over 'model'),
`attention_core` (by q heads, each device with the kv head its q heads
read, or over a sequence-sharded decode cache with the softmax combined
across devices), `project_halves` (each device's columns of both halves,
one all_to_all of the weight's shard over 'model') and `write_slot`;
`split_heads` and `halves` gather a sharded dim only where a cut needs it,
and `batch_sharded` keeps the residual stream sharded by batch only.
The plain tensors the models make (positions, masks, RoPE frequencies,
scan states) count as replicated under
`torch.distributed.tensor.experimental.implicit_replication`, which the
sharded train step and the dry run turn on.  On plain tensors none of this
runs: the single-card path is unchanged.  `time_scan` is the SSM families'
loop over time.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import checkpoint as ckpt

from repro_torch import sharding

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
    """table[idx]; with `keep`, 0 where keep is False (those reads add
    nothing to the table's gradient)."""

    @staticmethod
    def forward(ctx, table, idx, keep=None):
        ctx.save_for_backward(idx, keep)
        ctx.rows = table.shape[0]
        out = table[idx]
        if keep is not None:
            out = torch.where(keep[..., None], out, torch.zeros((), dtype=out.dtype,
                                                                device=out.device))
        return out

    @staticmethod
    def backward(ctx, grad):
        idx, keep = ctx.saved_tensors
        flat = idx.reshape(-1)
        g = grad.reshape(flat.shape[0], -1)
        shape = (ctx.rows, *grad.shape[idx.dim():])
        if isinstance(grad, FakeTensor):
            # the dry run's fake tensors have no values to cut segments by:
            # the same sum, in some order, with the same shapes
            if keep is not None:
                g = g * keep.reshape(-1, 1)
            out = torch.zeros((ctx.rows, g.shape[1]), dtype=torch.float32, device=grad.device)
            out = out.index_add_(0, flat, g.float()).to(grad.dtype)
            return out.reshape(shape), None, None
        if keep is not None:
            sel = keep.reshape(-1)
            flat, g = flat[sel], g[sel]
        out = torch.zeros((ctx.rows, g.shape[1]), dtype=grad.dtype, device=grad.device)
        if flat.numel():
            order = torch.sort(flat, stable=True).indices
            rows, lengths = torch.unique_consecutive(flat[order], return_counts=True)
            sums = torch.segment_reduce(g[order].float(), "sum", lengths=lengths)
            out[rows] = sums.to(grad.dtype)
        return out.reshape(shape), None, None


class _SumOver(torch.autograd.Function):
    """Every rank's t summed over `group` (one all_reduce, in the
    collective's fixed order); the gradient passes unchanged, since each
    rank's t reaches the sum once and every rank of the group holds the
    sum's whole gradient (what follows runs alike on each)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(t, group):
    return _SumOver.apply(t, group)


def model_dim(mesh):
    """The index of the mesh's 'model' dim, or None."""
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def shard_offset(size: int, mesh, dim: int) -> int:
    """The first index of this device's chunk of `size` along mesh dim
    `dim` (DTensor's Shard: chunks of ceil(size / ways))."""
    return mesh.get_coordinate()[dim] * (-(-size // mesh.size(dim)))


def gather_rows(table, idx, keep=None):
    """`table[idx]` (idx any integer shape); with `keep` (a plain table
    only), 0 where keep is False, those reads adding nothing to the
    table's gradient.  The gradient of a row read k
    times is its k gradients summed in float32 in index order (a stable sort
    and a segment sum) and rounded once to the table's dtype, where
    indexing's backward accumulates with float atomics on the card.

    A DTensor table sharded by rows over 'model' (the reference's
    embedding, `P("model", fsdp)`) is read vocab-parallel: its other mesh
    dims gathered as FSDP gathers any weight, each device reads the rows of
    its own shard for its indices (idx a DTensor sharded on its leading
    dim, or a plain tensor every device holds whole) with the others 0, and
    one all_reduce over 'model' adds them (each row has one nonzero term:
    the lookup's bits); the rows come back sharded as idx is, and each
    shard's gradient keeps the sorted segment sum's order.  Any other
    DTensor table is gathered whole on every device."""
    if not isinstance(table, DTensor):
        return _GatherRows.apply(table, idx, keep)
    mesh = table.device_mesh
    idx = sharding.as_dtensor(idx, mesh)
    if any(isinstance(p, Shard) and p.dim != 0 for p in idx.placements):
        raise ValueError(f"indices sharded as {idx.placements}; only the leading dim may be")
    tp_dim = model_dim(mesh)
    if tp_dim is None or mesh.size(tp_dim) == 1 or table.placements[tp_dim] != Shard(0):
        split = [isinstance(p, Shard) for p in idx.placements]
        whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=[Partial() if s else Replicate() for s in split])
        rows = _GatherRows.apply(whole, idx.to_local())
        return DTensor.from_local(rows, mesh, idx.placements, run_check=False)
    ipl = [Replicate() if i == tp_dim else p for i, p in enumerate(idx.placements)]
    if ipl != list(idx.placements):
        idx = idx.redistribute(mesh, ipl)
    tpl = [Shard(0) if i == tp_dim else Replicate() for i in range(mesh.ndim)]
    grad = [Shard(0) if i == tp_dim else (Partial() if isinstance(p, Shard) else Replicate())
            for i, p in enumerate(ipl)]
    local = table.redistribute(mesh, tpl).to_local(grad_placements=grad)
    lo = shard_offset(table.shape[0], mesh, tp_dim)
    il = idx.to_local()
    keep = (il >= lo) & (il < lo + local.shape[0])
    rows = _GatherRows.apply(local, torch.where(keep, il - lo, 0), keep)
    rows = sum_over(rows, mesh.get_group(tp_dim))
    return DTensor.from_local(rows, mesh, ipl, run_check=False)


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
    DTensors go to `_attention_sharded`.
    """
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        return _attention_sharded(q, k, v, causal=causal, q_offset=q_offset, window=window,
                                  q_chunk=q_chunk)
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


def _attention_sharded(q, k, v, *, causal: bool, q_offset: int, window: int, q_chunk: int):
    """attention_core on DTensors, each device on its own part as plain
    tensors.  The batch stays sharded as q's is over the data-parallel mesh
    dims.  Over 'model': a cache sharded along its sequence (the
    reference's decode layout, `cache_specs`) stays so, each device
    attends over its keys and the softmax is combined by three all-reduces
    (max, sum, output); otherwise q, k and v are sharded by heads where
    both head counts divide; where the q heads divide and the kv heads
    divide the devices, q is sharded by heads and each device takes the one
    kv head its q heads read (q head i reads kv head i // (Hq / Hkv)) from k
    and v whole over 'model'; else all three are whole on every device."""
    mesh = (q if isinstance(q, DTensor) else k).device_mesh
    q, k, v = (sharding.as_dtensor(t, mesh) for t in (q, k, v))
    tp_dim = mesh.mesh_dim_names.index("model")
    tp = mesh.size(tp_dim)
    hq, hkv = q.shape[2], k.shape[2]
    by_seq = k.placements[tp_dim] == Shard(1)
    by_head = not by_seq and hq % tp == 0 and hkv % tp == 0
    by_q_head = not by_seq and not by_head and hq % tp == 0 and tp % hkv == 0
    pl = []
    for i, p in enumerate(q.placements):
        if i == tp_dim:
            pl.append(Shard(2) if by_head or by_q_head else Replicate())
        else:
            pl.append(Shard(0) if p == Shard(0) else Replicate())
    kv_pl = list(pl)
    if by_seq:
        kv_pl[tp_dim] = Shard(1)
    elif by_q_head:
        kv_pl[tp_dim] = Replicate()
    q = q.redistribute(mesh, pl)
    k, v = k.redistribute(mesh, kv_pl), v.redistribute(mesh, kv_pl)
    if by_q_head:
        # each device's kv head from k and v whole over 'model'; the
        # devices' gradients of them add up (Partial over 'model')
        kv_grad = [Partial() if i == tp_dim else p for i, p in enumerate(kv_pl)]
        ql = q.to_local(grad_placements=pl)
        kl, vl = (t.to_local(grad_placements=kv_grad) for t in (k, v))
        head = mesh.get_coordinate()[tp_dim] * (hq // tp) // (hq // hkv)
        out = attention_core(ql, kl[:, :, head:head + 1], vl[:, :, head:head + 1],
                             causal=causal, q_offset=q_offset, window=window,
                             q_chunk=q_chunk)
        return DTensor.from_local(out, mesh, pl, run_check=False)
    if not by_seq:
        out = attention_core(q.to_local(grad_placements=pl), k.to_local(grad_placements=pl),
                             v.to_local(grad_placements=pl), causal=causal,
                             q_offset=q_offset, window=window, q_chunk=q_chunk)
        return DTensor.from_local(out, mesh, pl, run_check=False)
    import torch.distributed._functional_collectives as funcol
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        raise NotImplementedError("sequence-sharded attention is a decode path (no backward)")
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    lo = mesh.get_coordinate()[tp_dim] * (-(-k.shape[1] // tp))
    b, sq, hq, dh = ql.shape
    hkv = kl.shape[2]
    qg = ql.float().reshape(b, sq, hkv, hq // hkv, dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, kl.float()) / math.sqrt(dh)
    kpos = lo + torch.arange(kl.shape[1], device=ql.device)
    qpos = q_offset + torch.arange(sq, device=ql.device)
    mask = torch.ones((sq, kl.shape[1]), dtype=torch.bool, device=ql.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    scores = scores.masked_fill(~mask[None, None, None], NEG_INF)
    group = (mesh, tp_dim)
    m_loc = scores.amax(dim=-1, keepdim=True)
    m = funcol.all_reduce(m_loc, "max", group)
    p = torch.exp(scores - m)
    den = funcol.all_reduce(p.sum(dim=-1, keepdim=True), "sum", group)
    num = funcol.all_reduce(torch.einsum("bhrqk,bkhd->bhrqd", p, vl.float()), "sum", group)
    out = (num / den).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(ql.dtype)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def write_slot(cache, x, pos: int) -> None:
    """cache[:, pos:pos + 1] = x, in place.  A DTensor cache sharded along
    its sequence is written by the device holding slot `pos`."""
    if not isinstance(cache, DTensor):
        cache[:, pos:pos + 1] = x
        return
    mesh = cache.device_mesh
    x = sharding.as_dtensor(x, mesh).redistribute(
        mesh, [Replicate() if pl == Shard(1) else pl for pl in cache.placements])
    local, xl = cache.to_local(), x.to_local()
    if xl.shape[2:] != local.shape[2:]:
        x = x.redistribute(mesh, [pl if pl == Shard(0) else Replicate() for pl in x.placements])
        xl = x.to_local()
    lo = 0
    for i, pl in enumerate(cache.placements):
        if pl == Shard(1):
            lo += mesh.get_coordinate()[i] * (-(-cache.shape[1] // mesh.size(i)))
    if lo <= pos < lo + local.shape[1]:
        local[:, pos - lo:pos - lo + 1] = xl


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
    return (split_heads(q, n_heads, head_dim), split_heads(k, n_kv, head_dim),
            split_heads(v, n_kv, head_dim))


def split_heads(x, heads: int, head_dim: int):
    """(B, S, heads * head_dim) -> (B, S, heads, head_dim).  A DTensor
    whose last dim is sharded over more devices than `heads` divides by is
    gathered along it first."""
    if isinstance(x, DTensor):
        ways = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                         if p == Shard(x.dim() - 1))
        if heads % ways:
            x = sharding.replicated(x, dims=[-1])
    return x.reshape(x.shape[0], x.shape[1], heads, head_dim)


def project_halves(h, w, n: int):
    """((h @ w)[..., :n], (h @ w)[..., n:]).  With a DTensor weight whose
    columns are sharded over 'model' in chunks that cut both halves evenly,
    each device projects its own columns of both halves (`_HalvesOfShard`:
    one all_to_all of the weight's shard over 'model', never the weight
    gathered), so the halves come out sharded by columns over 'model' as the
    weights that follow them (conv, dt, D, out_proj) are; otherwise the
    weight is cut (`halves` of its columns, gathered and sharded again) and
    each half projected.  The activations are never gathered."""
    if not isinstance(w, DTensor):
        return halves(h @ w, n)
    mesh = w.device_mesh
    tp_dim = model_dim(mesh)
    tp = 1 if tp_dim is None else mesh.size(tp_dim)
    if tp > 1 and w.placements[tp_dim] == Shard(1) and n % tp == 0 and w.shape[1] == 2 * n:
        return _project_halves_sharded(h, w, n, tp_dim)
    wa, wb = halves(w, n)
    return h @ wa, h @ wb


def _project_halves_sharded(h, w, n: int, tp_dim: int):
    mesh = w.device_mesh
    h = sharding.as_dtensor(h, mesh)
    hpl = [Replicate() if i == tp_dim else (Shard(0) if p == Shard(0) else Replicate())
           for i, p in enumerate(h.placements)]
    h = h.redistribute(mesh, hpl)
    split = [p == Shard(0) for p in hpl]
    wpl = [Shard(1) if i == tp_dim else Replicate() for i in range(mesh.ndim)]
    w_grad = [Shard(1) if i == tp_dim else (Partial() if split[i] else Replicate())
              for i in range(mesh.ndim)]
    wl = w.redistribute(mesh, wpl).to_local(grad_placements=w_grad)
    hl = h.to_local(grad_placements=[Partial() if i == tp_dim else p
                                     for i, p in enumerate(hpl)])
    both = _HalvesOfShard.apply(wl, mesh, tp_dim)                # (2, in, n / tp)
    opl = [Shard(hl.dim() - 1) if i == tp_dim else p for i, p in enumerate(hpl)]
    return tuple(DTensor.from_local(hl @ both[j], mesh, opl, run_check=False) for j in (0, 1))


class _HalvesOfShard(torch.autograd.Function):
    """Device t's shard of a (in, 2n) weight sharded by columns over the tp
    devices of mesh dim `dim` (columns [t c, (t + 1) c), c = 2n / tp, two
    chunks of q = n / tp) -> (2, in, q): columns [t q, (t + 1) q) of the
    first half and of the second, by one all_to_all over the dim.  Global
    chunk k of the 2 tp (chunk k of the first half for k < tp, chunk k - tp
    of the second after) goes to device k mod tp; device t sends its chunks
    2t and 2t + 1 and receives chunk t (from device t // 2) and chunk tp + t
    (from device (tp + t) // 2), in that order.  The backward sends the
    gradients back the same way."""

    @staticmethod
    def _plan(t: int, tp: int, rows: int):
        send = [0] * tp
        for k in (2 * t, 2 * t + 1):
            send[k % tp] += rows
        recv = [0] * tp
        for k in (t, tp + t):
            recv[k // 2] += rows
        return send, recv

    @staticmethod
    def forward(ctx, wl, mesh, dim):
        tp, t = mesh.size(dim), mesh.get_coordinate()[dim]
        d_in, q = wl.shape[0], wl.shape[1] // 2
        pieces = wl.reshape(d_in, 2, q).permute(1, 0, 2)          # chunks 2t, 2t + 1
        dests = [(2 * t) % tp, (2 * t + 1) % tp]
        order = [0, 1] if dests[0] < dests[1] else [1, 0]         # by destination rank
        send, recv = _HalvesOfShard._plan(t, tp, d_in)
        src = pieces[order].reshape(2 * d_in, q).contiguous()
        out = torch.empty_like(src)
        group = mesh.get_group(dim)
        dist.all_to_all_single(out, src, recv, send, group=group)
        ctx.mesh, ctx.dim, ctx.order = mesh, dim, order
        return out.reshape(2, d_in, q)                            # sources t // 2 < (tp + t) // 2

    @staticmethod
    def backward(ctx, grad):
        mesh, dim, order = ctx.mesh, ctx.dim, ctx.order
        tp, t = mesh.size(dim), mesh.get_coordinate()[dim]
        _, d_in, q = grad.shape
        send, recv = _HalvesOfShard._plan(t, tp, d_in)
        back = torch.empty((2 * d_in, q), dtype=grad.dtype, device=grad.device)
        dist.all_to_all_single(back, grad.reshape(2 * d_in, q).contiguous(), send, recv,
                               group=mesh.get_group(dim))
        pieces = torch.empty((2, d_in, q), dtype=grad.dtype, device=grad.device)
        pieces[order] = back.reshape(2, d_in, q)
        return pieces.permute(1, 0, 2).reshape(d_in, 2 * q), None, None


def halves(x, n: int):
    """(x[..., :n], x[..., n:]).  A DTensor sharded along its last dim is
    gathered along it, cut, and each half sharded again as x was."""
    if not isinstance(x, DTensor):
        return x[..., :n], x[..., n:]
    whole = sharding.replicated(x, dims=[-1])
    return tuple(h.redistribute(x.device_mesh, x.placements)
                 for h in (whole[..., :n], whole[..., n:]))


def attn_out(p, o):
    b, s, h, d = o.shape
    return batch_sharded(o.reshape(b, s, h * d) @ p["wo"])


def pointwise(fn, x):
    """fn(x) for an elementwise fn.  A DTensor runs fn on its local shard
    (partial sums added first) and keeps its placements, so the op needs no
    sharding rule of DTensor's: without one (softplus on torch 2.11) DTensor
    replicates the input whole on every device."""
    if not isinstance(x, DTensor):
        return fn(x)
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local(grad_placements=pl)), x.device_mesh, pl,
                              run_check=False, shape=x.shape, stride=x.stride())


def batch_sharded(x):
    """x sharded by batch only on a mesh: batch sharded as it is, whole
    over every other mesh dim (the partial sums of a row-parallel product
    are all-reduced, as Megatron's are).  The blocks' outputs, the residual
    stream, and the SSMs' small projections take this layout.  Left to
    itself DTensor may reduce-scatter them along the sequence, and a later
    product's flattening of (batch, sequence) then costs minutes of
    redistribution planning.  A plain tensor comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_params(gen, d_model: int, d_ff: int, dtype):
    return {"wg": dense_init(gen, (d_model, d_ff), dtype),
            "wu": dense_init(gen, (d_model, d_ff), dtype),
            "wd": dense_init(gen, (d_ff, d_model), dtype)}


def swiglu(p, x):
    return batch_sharded((F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"])


def gelu_mlp_params(gen, d_model: int, d_ff: int, dtype):
    return {"w1": dense_init(gen, (d_model, d_ff), dtype),
            "b1": zeros(gen, (d_ff,), dtype),
            "w2": dense_init(gen, (d_ff, d_model), dtype),
            "b2": zeros(gen, (d_model,), dtype)}


def gelu_mlp(p, x):
    # jax.nn.gelu's default is the tanh approximation
    return batch_sharded(F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, mask=None):
    """logits: (B, S, V) any float dtype; labels: (B, S) int; mask: (B, S).

    Computed in float32; ignores positions where mask == 0.
    """
    nll = _nll(logits, labels)
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _nll(logits, labels):
    """-log softmax(logits)[label] at every position, float32.  DTensor
    logits are read vocab-parallel over 'model' (the vocab dim sharded
    there, each device its own positions: labels sharded as logits are
    along the leading dims): each device's max, sum of exponentials and
    gold logit over its vocab shard, all-reduced over 'model' (max, sum,
    sum), so the whole vocab is never gathered; with no 'model' dim wider
    than 1, the vocab dim is gathered and the plain function runs."""
    if not isinstance(logits, DTensor):
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return logz - gold
    mesh = logits.device_mesh
    tp_dim = model_dim(mesh)
    if tp_dim is None or mesh.size(tp_dim) == 1:
        whole_v = sharding.replicated(logits, dims=[-1])
        if any(not isinstance(p, (Shard, Replicate)) for p in whole_v.placements):
            whole_v = whole_v.redistribute(mesh, [p if isinstance(p, Shard) else Replicate()
                                                  for p in whole_v.placements])
        labels = sharding.as_dtensor(labels, mesh).redistribute(mesh, whole_v.placements)
        nll = _nll(whole_v.to_local(), labels.to_local())
        return DTensor.from_local(nll, mesh, whole_v.placements, run_check=False)
    v_dim = logits.dim() - 1
    labels = sharding.as_dtensor(labels, mesh)
    # each device its own positions: the batch sharded as the labels' (or
    # the logits') is, a local slice where the logits hold it whole
    pl = [Shard(v_dim) if i == tp_dim else
          (Shard(0) if Shard(0) in (p, q) else Replicate())
          for i, (p, q) in enumerate(zip(logits.placements, labels.placements))]
    if pl != list(logits.placements):
        logits = logits.redistribute(mesh, pl)
    out_pl = [Replicate() if i == tp_dim else p for i, p in enumerate(pl)]
    lab = labels.redistribute(mesh, out_pl).to_local()
    ll = logits.to_local(grad_placements=pl).float()
    group = mesh.get_group(tp_dim)
    with torch.no_grad():                     # the max only steadies the exponentials
        m = ll.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    se = sum_over(torch.sum(torch.exp(ll - m[..., None]), dim=-1), group)
    lo = shard_offset(logits.shape[-1], mesh, tp_dim)
    keep = (lab >= lo) & (lab < lo + ll.shape[-1])
    gold = torch.gather(ll, -1, torch.where(keep, lab - lo, 0)[..., None].long())[..., 0]
    gold = sum_over(torch.where(keep, gold, 0.0), group)
    return DTensor.from_local(m + torch.log(se) - gold, mesh, out_pl, run_check=False)


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


def shard_hint(x, spec):
    """Redistribute a DTensor to `spec`'s placements on its own mesh; a
    plain tensor comes back unchanged (the reference's best-effort
    `with_sharding_constraint`, a no-op outside a mesh).  No model calls
    it, as in the reference."""
    if not isinstance(x, DTensor) or spec is None:
        return x
    return x.redistribute(x.device_mesh, sharding.placements(spec, x.device_mesh, x.dim()))


# ---------------------------------------------------------------------------
# loops over time (the SSM families' selective scans)
# ---------------------------------------------------------------------------

def _one_step_hook():
    """The `scaled` hook of an active dispatch mode that asks for one-step
    scans (the dry run's `roofline.TraceCostModel(one_step_scans=True)`),
    or None.  The dispatch mode stack, unlike a context variable, follows
    the work into the autograd engine's threads (remat's recompute)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        if getattr(mode, "one_step_scans", False):
            return mode.scaled
    return None


def time_scan(step, state, steps: int):
    """for t in range(steps): state, y_t = step(state, t).  Returns (the
    y_t stacked on dim 1, the last state).

    Under a trace that asks for one-step scans, step 0 runs once and counts
    for all `steps` (`scaled(steps)` yields mark(outputs), which makes
    their backward count so too), and its y stands for every step's
    (outputs of the right shape; nothing else sets the hook)."""
    hook = _one_step_hook()
    if hook is not None:
        with hook(steps) as mark:
            state, y = step(state, 0)
            mark((state, y))
        return _repeat_steps(y, steps), state
    ys = []
    for t in range(steps):
        state, y = step(state, t)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def _repeat_steps(y, steps: int):
    """y (B, ...) repeated along a new dim 1 of `steps`; a DTensor's shards
    keep their dims (shifted past the new one)."""
    if not isinstance(y, DTensor):
        return y.unsqueeze(1).expand(y.shape[0], steps, *y.shape[1:]).contiguous()
    pl = [Shard(p.dim + 1) if isinstance(p, Shard) and p.dim >= 1 else p for p in y.placements]
    local = y.to_local(grad_placements=y.placements)
    ys = local.unsqueeze(1).expand(local.shape[0], steps, *local.shape[1:]).contiguous()
    return DTensor.from_local(ys, y.device_mesh, pl, run_check=False)
