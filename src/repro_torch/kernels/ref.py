"""Plain PyTorch versions of the port's kernels.
Counterpart: `repro/kernels/ref.py`.

Each function computes what its CUDA kernel computes, untiled, on any
device: the CPU tests use them, the `ops.py` wrappers take them for tensors
on the CPU, and `chip_smoke.py` holds each kernel against them on the card.
Where the reference forms a Phi difference as 0.5*(erf(zb/sqrt2) -
erf(za/sqrt2)), which cancels in the far tails, these take both terms from
the tail the pair sits in (`gaussian.phi_diff`), as the kernels do.  Work is cut into
row or query slabs so the card's memory holds the main path's shapes: the
reference builds the (n, n, d) differences of the quadratic forms at once,
which at n = 32 768, d = 3 would be 12 GiB; these build (rows, n, d) slabs
of at most QUAD_SLAB_ELEMS floats, and the triangle sums visit only the
columns right of each slab's first row.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import gaussian as G

_FUNS = {"k4": G.k4, "k6": G.k6, "gauss": G.phi}

ROW_SLAB = 2048      # pairwise rows per slab: (2048, n) floats at a time
QUERY_SLAB = 64      # queries per slab for the (q, n[, d]) AQP terms
QUAD_SLAB_ELEMS = 1 << 24   # floats of one (rows, cols, d) difference slab


def pairwise_scaled_ksum(x: torch.Tensor, g: torch.Tensor, kind: str
                         ) -> torch.Tensor:
    """sum_{i<j} K^(r)((x_i - x_j)/g)   (PLUGIN eqs. 16/18 inner sums)."""
    fun = _FUNS[kind]
    n = x.shape[0]
    inv_g = 1.0 / g.reshape(())
    cols = torch.arange(n, device=x.device)
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for start in range(0, n, ROW_SLAB):
        rows = x[start:start + ROW_SLAB]
        idx = start + torch.arange(rows.shape[0], device=x.device)
        vals = fun((rows[:, None] - x[None, :]) * inv_g)
        acc = acc + torch.sum(torch.where(idx[:, None] < cols[None, :],
                                          vals, 0.0))
    return acc


def aqp_batch_sums(x: torch.Tensor, h: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor):
    """Unscaled closed-form integrals of eqs. 9-10 for a query batch.
    x: (n,), h: scalar, a/b: (q,) -> (count_raw, sum_raw), each (q,)."""
    h = h.reshape(())
    inv_h = 1.0 / h
    cnt, sm = [], []
    for start in range(0, a.shape[0], QUERY_SLAB):
        za = (a[start:start + QUERY_SLAB, None] - x[None, :]) * inv_h
        zb = (b[start:start + QUERY_SLAB, None] - x[None, :]) * inv_h
        d_Phi = G.phi_diff(za, zb)
        cnt.append(torch.sum(d_Phi, dim=1))
        sm.append(torch.sum(x[None, :] * d_Phi - h * G.dens_diff(za, zb),
                            dim=1))
    if not cnt:
        z = torch.zeros((0,), dtype=x.dtype, device=x.device)
        return z, z.clone()
    return torch.cat(cnt), torch.cat(sm)


def aqp_box_sums(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, tgt: torch.Tensor):
    """Unscaled eq. 11 box integrals for a query batch (product kernel,
    diagonal bandwidth).  x: (n,d), h_diag: (d,), lo/hi: (q,d), tgt: (q,)
    int32 -> (count_raw, sum_raw), each (q,).  The SUM factor on the target
    axis is a select, not a division by its Phi difference."""
    inv_h = 1.0 / h_diag
    axis = torch.arange(x.shape[1], device=x.device)
    cnt, sm = [], []
    for start in range(0, lo.shape[0], QUERY_SLAB):
        za = (lo[start:start + QUERY_SLAB, None, :] - x[None]) * inv_h
        zb = (hi[start:start + QUERY_SLAB, None, :] - x[None]) * inv_h
        d_Phi = G.phi_diff(za, zb)                            # (qs, n, d)
        moment = x[None] * d_Phi - h_diag * G.dens_diff(za, zb)
        t = tgt[start:start + QUERY_SLAB].to(axis.dtype)
        factors = torch.where(axis[None, None, :] == t[:, None, None],
                              moment, d_Phi)
        cnt.append(torch.sum(torch.prod(d_Phi, dim=2), dim=1))
        sm.append(torch.sum(torch.prod(factors, dim=2), dim=1))
    if not cnt:
        z = torch.zeros((0,), dtype=x.dtype, device=x.device)
        return z, z.clone()
    return torch.cat(cnt), torch.cat(sm)


# --- LSCV: quadratic forms S_ij = (x_i - x_j)^T M (x_i - x_j) ---------------

def _quad_slabs(x: torch.Tensor, m: torch.Tensor):
    """Yield (start, s) for row slabs of the strict upper triangle: s is the
    (rows, n - start) block of S over rows start.. and columns start..,
    +inf where j <= i, so exp(-c * s) is 0 there."""
    n, d = x.shape
    rows_per = max(1, QUAD_SLAB_ELEMS // max(1, n * d))
    for start in range(0, n, rows_per):
        rows = x[start:start + rows_per]
        cols = x[start:]
        v = rows[:, None, :] - cols[None, :, :]              # (r, n - start, d)
        s = torch.sum((v @ m) * v, dim=-1)
        i = torch.arange(rows.shape[0], device=x.device)
        j = torch.arange(cols.shape[0], device=x.device)
        yield start, torch.where(i[:, None] < j[None, :], s, torch.inf)


def sv_matrix(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """S_ij = (x_i-x_j)^T M (x_i-x_j) on the strict upper triangle, else 0.
    x: (n, d), m: (d, d) -> (n, n)."""
    n = x.shape[0]
    out = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    for start, s in _quad_slabs(x, m):
        out[start:start + s.shape[0], start:] = torch.where(
            torch.isinf(s), 0.0, s)
    return out


def _t_h(s: torch.Tensor, c_k, c_kk) -> torch.Tensor:
    """T_H(s) = c_kk exp(-s/4) - 2 c_k exp(-s/2)  (eqs. 33-35, 40-42)."""
    return c_kk * torch.exp(-0.25 * s) - 2.0 * c_k * torch.exp(-0.5 * s)


def gh_fused_sum(x: torch.Tensor, h_inv: torch.Tensor, c_k, c_kk
                 ) -> torch.Tensor:
    """sum_{i<j} T_H(x_i - x_j)  (LSCV_H eq. 32 inner sum, fused §6.3).
    x: (n, d), h_inv: (d, d) -> 0-d."""
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for _, s in _quad_slabs(x, h_inv):
        acc = acc + torch.sum(_t_h(s, c_k, c_kk))
    return acc


def _grid_fold(acc: torch.Tensor, s: torch.Tensor, inv_h2: torch.Tensor,
               c_k, c_kk) -> torch.Tensor:
    """acc[h] += sum T~(s / h^2) over a slab masked with +inf (eq. 43)."""
    return acc + torch.stack([torch.sum(_t_h(s * inv_h2[t], c_k, c_kk))
                              for t in range(inv_h2.shape[0])])


def lscv_grid_sums(x: torch.Tensor, sigma_inv: torch.Tensor,
                   h_grid: torch.Tensor, c_k, c_kk) -> torch.Tensor:
    """Per-h inner sums of eq. (43): for each h on the grid,
    sum_{i<j} T~(x_i - x_j).  x: (n, d) -> (n_h,)."""
    inv_h2 = 1.0 / (h_grid * h_grid)
    acc = torch.zeros(h_grid.shape, dtype=x.dtype, device=x.device)
    for _, s in _quad_slabs(x, sigma_inv):
        acc = _grid_fold(acc, s, inv_h2, c_k, c_kk)
    return acc


def lscv_grid_sums_from_s(s_mat: torch.Tensor, h_grid: torch.Tensor, c_k,
                          c_kk) -> torch.Tensor:
    """The grid phase alone (§6.2 phase 2): `lscv_grid_sums` over a
    precomputed (n, n) S, reading its strict upper triangle only."""
    n = s_mat.shape[0]
    inv_h2 = 1.0 / (h_grid * h_grid)
    acc = torch.zeros(h_grid.shape, dtype=s_mat.dtype, device=s_mat.device)
    rows_per = max(1, QUAD_SLAB_ELEMS // max(1, n))
    j = torch.arange(n, device=s_mat.device)
    for start in range(0, n, rows_per):
        blk = s_mat[start:start + rows_per, start:]
        i = start + torch.arange(blk.shape[0], device=s_mat.device)
        s = torch.where(i[:, None] < j[None, start:], blk, torch.inf)
        acc = _grid_fold(acc, s, inv_h2, c_k, c_kk)
    return acc


# --- GROUP BY, full-H and scalar-h density evaluation -------------------------

def aqp_grouped_sums(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, glo: torch.Tensor, ghi: torch.Tensor,
                     g_axis: int, tgt: int):
    """Unscaled factored GROUP BY integrals (eq. 11): the shared-axes
    product crossed with G per-category windows on axis `g_axis`.  x: (n,d),
    h_diag/lo/hi: (d,) (the group axis's lo/hi ignored), glo/ghi: (G,) ->
    (count_raw, sum_raw), each (G,).  The first-moment factor sits on the
    shared product when the target is a kept axis, on the group factor when
    it is the group axis."""
    inv_h = 1.0 / h_diag
    za = (lo - x) * inv_h                                     # (n, d)
    zb = (hi - x) * inv_h
    d_Phi = G.phi_diff(za, zb)
    axis = torch.arange(x.shape[1], device=x.device)
    keep = axis != g_axis
    shared_cnt = torch.prod(torch.where(keep, d_Phi, 1.0), dim=1)
    xg = x[:, g_axis]
    hg = h_diag[g_axis]
    gza = (glo[None, :] - xg[:, None]) * (1.0 / hg)           # (n, G)
    gzb = (ghi[None, :] - xg[:, None]) * (1.0 / hg)
    g_Phi = G.phi_diff(gza, gzb)
    cnt = torch.sum(shared_cnt[:, None] * g_Phi, dim=0)
    if tgt == g_axis:
        g_moment = xg[:, None] * g_Phi - hg * G.dens_diff(gza, gzb)
        return cnt, torch.sum(shared_cnt[:, None] * g_moment, dim=0)
    moment = x * d_Phi - h_diag * G.dens_diff(za, zb)
    factors = torch.where(axis == tgt, moment, d_Phi)
    shared_sm = torch.prod(torch.where(keep, factors, 1.0), dim=1)
    return cnt, torch.sum(shared_sm[:, None] * g_Phi, dim=0)


def _node_densities(nodes: torch.Tensor, x: torch.Tensor, h_inv: torch.Tensor,
                    log_norm) -> torch.Tensor:
    """f_m = sum_i exp(log_norm - (node_m - x_i)^T H^-1 (node_m - x_i) / 2),
    in node slabs of at most QUAD_SLAB_ELEMS differences; the quadratic form
    contracts v = diff H^-1 before the second dot."""
    n, d = x.shape
    rows_per = max(1, QUAD_SLAB_ELEMS // max(1, n * d))
    parts = [torch.zeros((0,), dtype=x.dtype, device=x.device)]
    for start in range(0, nodes.shape[0], rows_per):
        diff = nodes[start:start + rows_per, None, :] - x[None]   # (r, n, d)
        quad = 0.5 * torch.sum((diff @ h_inv) * diff, dim=-1)
        parts.append(torch.sum(torch.exp(log_norm - quad), dim=1))
    return torch.cat(parts)


def inside_boxes(nodes: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
            ) -> torch.Tensor:
    """(q, m) indicator of node m inside box q (closed intervals)."""
    return torch.all((nodes[None] >= lo[:, None]) & (nodes[None] <= hi[:, None]),
                     dim=2)


def qmc_box_reduce(nodes: torch.Tensor, x: torch.Tensor, h_inv: torch.Tensor,
                   log_norm, lo: torch.Tensor, hi: torch.Tensor,
                   tgt: torch.Tensor):
    """Raw double sums of the fused QMC box reduction: for each box q, the
    sum over nodes inside it of the summed (not averaged) full-H Gaussian
    kernel values against the whole sample, and the same weighted by the
    node's target coordinate.  nodes: (m,d), x: (n,d), h_inv: (d,d),
    lo/hi: (q,d), tgt: (q,) -> (cnt_sums, sum_sums)."""
    f = _node_densities(nodes, x, h_inv, log_norm)
    cnt, sm = [], []
    for start in range(0, lo.shape[0], QUERY_SLAB):
        w = inside_boxes(nodes, lo[start:start + QUERY_SLAB],
                    hi[start:start + QUERY_SLAB]) * f[None, :]
        tvals = nodes.T[tgt[start:start + QUERY_SLAB].long()]      # (qs, m)
        cnt.append(torch.sum(w, dim=1))
        sm.append(torch.sum(w * tvals, dim=1))
    if not cnt:
        z = torch.zeros((0,), dtype=x.dtype, device=x.device)
        return z, z.clone()
    return torch.cat(cnt), torch.cat(sm)


POINT_SLAB = 4096    # evaluation points per slab of the density passes


def rff_density(points: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """Un-normalised RFF density dots: cos(points @ W.T + b) @ z.
    points: (m, d), w: (D, d), b/z: (D,) -> (m,)."""
    parts = [torch.zeros((0,), dtype=points.dtype, device=points.device)]
    for start in range(0, points.shape[0], POINT_SLAB):
        p = points[start:start + POINT_SLAB]
        parts.append(torch.cos(p @ w.T + b[None, :]) @ z)
    return torch.cat(parts)


def kde_eval(points: torch.Tensor, x: torch.Tensor, h) -> torch.Tensor:
    """f^(points) per eq. (3), Gaussian kernel.  points: (m, d), x: (n, d)
    -> (m,)."""
    n, d = x.shape
    h = torch.as_tensor(h, dtype=x.dtype, device=x.device).reshape(())
    norm = (2.0 * math.pi) ** (-d / 2.0) * h ** (-d)
    rows_per = max(1, QUAD_SLAB_ELEMS // max(1, n * d))
    parts = [torch.zeros((0,), dtype=x.dtype, device=x.device)]
    for start in range(0, points.shape[0], rows_per):
        diff = (points[start:start + rows_per, None, :] - x[None]) / h
        quad = 0.5 * torch.sum(diff * diff, dim=-1)
        parts.append(norm * torch.mean(torch.exp(-quad), dim=1))
    return torch.cat(parts)
