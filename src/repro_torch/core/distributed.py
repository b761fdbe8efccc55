"""Distributed bandwidth selection: the O(n^2) selectors split over the
ranks of a `torch.distributed` process group (beyond the paper).
Counterpart: `repro/core/distributed.py`, whose `Mesh` the group takes the
place of.

The sample x is replicated (every rank passes the same x, as the
reference's `P()` in_spec replicates it), each rank reduces its part of the
pair triangle, and one `all_reduce(SUM)` stands where each `psum` does.

Backend "torch" is the reference's algorithm: strided row ownership (rank p
owns rows p, p + P, p + 2P, ..., which balances the triangle's pairs), row
chunks of (chunk, n) slabs, and for the LSCV_h grid either the per-pair
quadratic form ("einsum") or the expansion S = qr + qx - 2 r M x^T with
its cross term one matrix product ("mxu").  `sharded_pairwise_reduce`
takes an arbitrary callable and stays on this path on every backend.

Backend "cuda" runs the hand kernels on each rank's contiguous share of the
kernel's triangle tiles (`kernels.triangle.share`): PLUGIN's Psi sums on
the pairwise kernel, and the LSCV_h grid on the lscv_grid kernel.  A rank
never holds S whole: it walks its share in runs of whole tile columns
(`kernels.lscv_grid.slab_walk`) whose column block of S (the sv_precompute
kernel's `cols=`) fits `slab_bytes` (SLAB_BYTES by default), one
sv_precompute and one lscv_grid launch a run, and adds the runs' sums in
order: O(slab_bytes + n d) bytes a rank where S takes n^2 floats.  The sums are the same sums with the kernels' rounding.  Every
rank must cut the same tiles, so the tile and the shapes are checked
across ranks before any launch.

`init_group` starts a group from a `file://` store: gloo on the CPU, NCCL
with one rank per card.
"""
from __future__ import annotations

import datetime
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.device import DTYPE, DeviceLike, resolve_backend, resolve_device

from . import gaussian as G
from .lscv import _as_rows, _inv, covariance, h_grid_for

# the sv_precompute kernel's name for each of the reference's two forms of S
_SV_ALGORITHM = {"mxu": "mxu", "einsum": "paper"}
# the most bytes of S a rank of the "cuda" LSCV_h grid holds at once
SLAB_BYTES = 512 << 20


def init_group(store_path: str, rank: int, world_size: int, device: DeviceLike = None,
               timeout_s: float = 300.0) -> torch.device:
    """Join the default process group through the file store at
    `store_path` (a path no earlier group used): gloo for the CPU, NCCL for
    the CUDA device `cuda:rank`.  Returns this rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store_path}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _rank_world(group) -> tuple:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("torch.distributed is not initialised: call "
                           "torch.distributed.init_process_group (or init_group) "
                           "on every rank first")
    return dist.get_rank(group), dist.get_world_size(group)


def _all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """One all_reduce(SUM) of t across the group (the reference's psum)."""
    out = t.reshape(-1).contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.reshape(t.shape)


def _same_on_every_rank(values: dict, group, device: torch.device) -> None:
    """Raise unless every rank holds the same integers `values`: one
    all_reduce(MAX) of (v, -v) gives each one's largest and smallest."""
    vals = [int(v) for v in values.values()]
    t = torch.tensor(vals + [-v for v in vals], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    hi, lo = t[:len(vals)].tolist(), [-v for v in t[len(vals):].tolist()]
    bad = {k: (a, b) for k, a, b in zip(values, lo, hi) if a != b}
    if bad:
        raise RuntimeError(f"the ranks disagree on {bad} (smallest, largest): their "
                           f"shares of the triangle would not cover it once")


def _strided_pairwise_partial(fun: Callable, x: torch.Tensor, p: int, n_dev: int,
                              chunk: int = 256) -> torch.Tensor:
    """Partial sum_{i<j, i mod P == p} fun(x_i - x_j) on one rank (1-D x)."""
    n = x.shape[0]
    rows_per_dev = -(-n // n_dev)
    c = max(1, min(chunk, rows_per_dev))
    cols = torch.arange(n, device=x.device)
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for start in range(0, rows_per_dev, c):
        row_idx = (start + torch.arange(c, device=x.device)) * n_dev + p
        ok = row_idx < n
        rows = x[torch.where(ok, row_idx, 0)]
        vals = fun(rows[:, None] - x[None, :])
        mask = ok[:, None] & (row_idx[:, None] < cols[None, :])
        acc = acc + torch.sum(torch.where(mask, vals, 0.0))
    return acc


def sharded_pairwise_reduce(fun: Callable, x, group=None, chunk: int = 256,
                            device: DeviceLike = None) -> torch.Tensor:
    """RR_fun (§5.4) over every rank of `group` (None: the default group),
    on `device` (default: the CUDA device)."""
    p, n_dev = _rank_world(group)
    x = torch.as_tensor(x, dtype=DTYPE, device=resolve_device(device))
    return _all_sum(_strided_pairwise_partial(fun, x, p, n_dev, chunk), group)


def sharded_plugin_psi_sums(x, g1, g2, group=None, chunk: int = 256,
                            backend: Optional[str] = None, device: DeviceLike = None):
    """Distributed Psi6 / Psi4 pairwise sums of PLUGIN (its O(n^2) stages):
    (sum_{i<j} K^(6)((x_i-x_j)/g1), sum_{i<j} K^(4)((x_i-x_j)/g2))."""
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    x = torch.as_tensor(x, dtype=DTYPE, device=dev)
    g1, g2 = (torch.as_tensor(g, dtype=DTYPE, device=dev).reshape(()) for g in (g1, g2))
    if backend == "torch":
        s6 = sharded_pairwise_reduce(lambda dx: G.k6(dx / g1), x, group, chunk, dev)
        s4 = sharded_pairwise_reduce(lambda dx: G.k4(dx / g2), x, group, chunk, dev)
        return s6, s4
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import pairwise_reduce as kpr
    from repro_torch.kernels.triangle import n_tri_tiles, share
    p, n_dev = _rank_world(group)
    n = x.shape[0]
    (tile,) = autotune.resolve("pairwise_scaled_ksum", {"n": n}, tile=(None, kpr.TILE))
    _same_on_every_rank({"n": n, "tile": tile}, group, dev)
    blocks = share(n_tri_tiles(-(-n // kpr.tile_for(n, tile))), p, n_dev)
    s6 = ops.pairwise_scaled_ksum(x, g1, kind="k6", tile=tile, blocks=blocks)
    s4 = ops.pairwise_scaled_ksum(x, g2, kind="k4", tile=tile, blocks=blocks)
    return _all_sum(s6, group), _all_sum(s4, group)


def _strided_grid_partial(x: torch.Tensor, sigma_inv: torch.Tensor, inv2: torch.Tensor,
                          inv4: torch.Tensor, n_h: int, c_k, c_kk, p: int, n_dev: int,
                          chunk: int, algorithm: str) -> torch.Tensor:
    """Rank p's strided rows folded into the per-h sums of T~ (eqs. 40-43);
    inv2 / inv4: (h chunks, h_chunk) of 1/(2h^2), 1/(4h^2), padded."""
    n = x.shape[0]
    rows_per_dev = -(-n // n_dev)
    c = max(1, min(chunk, rows_per_dev))
    cols = torch.arange(n, device=x.device)
    if algorithm == "mxu":
        mx = x @ sigma_inv                                 # (n, d), hoisted
        qx = torch.sum(mx * x, dim=1)                      # (n,)
    acc = torch.zeros((n_h,), dtype=x.dtype, device=x.device)
    for start in range(0, rows_per_dev, c):
        row_idx = (start + torch.arange(c, device=x.device)) * n_dev + p
        ok = row_idx < n
        rows = x[torch.where(ok, row_idx, 0)]
        if algorithm == "mxu":
            mr = rows @ sigma_inv                          # (c, d)
            qr = torch.sum(mr * rows, dim=1)               # (c,)
            s = qr[:, None] + qx[None, :] - 2.0 * (mr @ x.T)
        else:
            v = rows[:, None, :] - x[None, :, :]
            s = torch.einsum("rnd,de,rne->rn", v, sigma_inv, v)
        mask = (ok[:, None] & (row_idx[:, None] < cols[None, :])).to(s.dtype)
        sm = s * mask
        parts = []
        for i2, i4 in zip(inv2, inv4):                     # one (h_chunk, c, n) slab
            e2 = torch.exp(-sm[None] * i2[:, None, None]) * mask[None]
            e4 = torch.exp(-sm[None] * i4[:, None, None]) * mask[None]
            parts.append(torch.sum(c_kk * e4 - 2.0 * c_k * e2, dim=(1, 2)))
        acc = acc + torch.cat(parts)[:n_h]
    return acc


def sharded_lscv_h_grid(x, sigma_inv, h_grid, c_k, c_kk, group=None, chunk: int = 64,
                        h_chunk: int = 8, algorithm: str = "mxu",
                        backend: Optional[str] = None, device: DeviceLike = None,
                        slab_bytes: int = SLAB_BYTES) -> torch.Tensor:
    """Distributed LSCV_h grid: for every h, sum_{i<j} T~(S_ij; h) over the
    group (x: (n, d) replicated).  `algorithm` "einsum" forms each pair's
    quadratic form, "mxu" the expanded form with one matrix product a slab
    (on "cuda", the sv_precompute kernel's "paper" / "mxu" forms of S, in
    slabs of at most `slab_bytes`)."""
    if algorithm not in _SV_ALGORITHM:
        raise ValueError(f"unknown algorithm {algorithm!r}; expected one of "
                         f"{sorted(_SV_ALGORITHM)}")
    x = _as_rows(x, device)
    dev = x.device
    backend = resolve_backend(backend, dev)
    sigma_inv = torch.as_tensor(sigma_inv, dtype=DTYPE, device=dev)
    h_grid = torch.as_tensor(h_grid, dtype=DTYPE, device=dev)
    p, n_dev = _rank_world(group)
    n, n_h = x.shape[0], h_grid.shape[0]
    if backend == "torch":
        pad = (-n_h) % h_chunk
        zeros = torch.zeros((pad,), dtype=DTYPE, device=dev)
        inv2 = torch.cat([0.5 / (h_grid * h_grid), zeros]).reshape(-1, h_chunk)
        inv4 = torch.cat([0.25 / (h_grid * h_grid), zeros]).reshape(-1, h_chunk)
        part = _strided_grid_partial(x, sigma_inv, inv2, inv4, n_h, c_k, c_kk, p,
                                     n_dev, chunk, algorithm)
        return _all_sum(part, group)
    from repro_torch.kernels import lscv_grid as klg
    from repro_torch.kernels import ops
    from repro_torch.kernels.triangle import n_tri_tiles, share
    _same_on_every_rank({"n": n, "d": x.shape[1], "n_h": n_h}, group, dev)
    sigma_inv = sigma_inv.contiguous()
    part = torch.zeros((n_h,), dtype=DTYPE, device=dev)
    for begin, count, c0, c1 in klg.slab_walk(n, share(n_tri_tiles(-(-n // klg.TILE)), p, n_dev),
                                              slab_bytes):
        slab = ops.sv_matrix(x, sigma_inv, algorithm=_SV_ALGORITHM[algorithm], cols=(c0, c1))
        part = part + ops.lscv_grid_sums_from_s(slab, h_grid, c_k, c_kk,
                                                blocks=(begin, count), slab=(c0, n))
        del slab
    return _all_sum(part, group)


def distributed_lscv_h(x, group=None, n_h: int = 150, chunk: int = 64,
                       backend: Optional[str] = None, device: DeviceLike = None):
    """End-to-end LSCV_h (paper §6.2) over the ranks of `group`: returns
    (h, h_grid, g_values) as the reference does."""
    x = _as_rows(x, device)
    n, d = x.shape
    sigma = covariance(x)
    det_sigma = torch.linalg.det(sigma)
    sigma_inv = _inv(sigma)
    c_k, c_kk, r_k = G.lscv_h_consts(d, det_sigma)
    h_grid = h_grid_for(n, d, n_h, device=x.device)
    t_sums = sharded_lscv_h_grid(x, sigma_inv, h_grid, c_k, c_kk, group, chunk,
                                 backend=backend, device=x.device)
    g_values = h_grid ** (-d) * (2.0 / (n * n) * t_sums + r_k / n)
    return h_grid[torch.argmin(g_values)], h_grid, g_values
