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

from .triangle import block_range, n_tri_tiles, pair_tile

_FUNS = {"k4": G.k4, "k6": G.k6, "gauss": G.phi}

ROW_SLAB = 2048      # pairwise rows per slab: (2048, n) floats at a time
QUERY_SLAB = 64      # queries per slab for the (q, n[, d]) AQP terms
QUAD_SLAB_ELEMS = 1 << 24   # floats of one (rows, cols, d) difference slab


def _upper(rows: torch.Tensor, cols: torch.Tensor, n: int, blocks, tile):
    """The strict upper triangle's mask over rows x cols, cut to the pairs
    of the (begin, count) range of tiles of side `tile` when blocks is
    given (a kernel launch's share of the triangle)."""
    mask = rows[:, None] < cols[None, :]
    if blocks is None:
        return mask
    begin, count = block_range(blocks, n_tri_tiles(-(-n // tile)))
    bx = pair_tile(rows[:, None], cols[None, :], tile)
    return mask & (bx >= begin) & (bx < begin + count)


def pairwise_scaled_ksum(x: torch.Tensor, g: torch.Tensor, kind: str,
                         blocks=None, tile=None) -> torch.Tensor:
    """sum_{i<j} K^(r)((x_i - x_j)/g)   (PLUGIN eqs. 16/18 inner sums);
    with `blocks`, over the pairs of that range of the kernel's tiles of
    side `tile` only."""
    fun = _FUNS[kind]
    n = x.shape[0]
    inv_g = 1.0 / g.reshape(())
    cols = torch.arange(n, device=x.device)
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for start in range(0, n, ROW_SLAB):
        rows = x[start:start + ROW_SLAB]
        idx = start + torch.arange(rows.shape[0], device=x.device)
        vals = fun((rows[:, None] - x[None, :]) * inv_g)
        acc = acc + torch.sum(torch.where(_upper(idx, cols, n, blocks, tile),
                                          vals, 0.0))
    return acc


def _batch_terms(x: torch.Tensor, h: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor):
    """Per (query, point) terms (c, s), each (q, n): eq. 9's Phi difference
    and eq. 10's x Phi difference - h phi difference."""
    h = h.reshape(())
    inv_h = 1.0 / h
    za = (a[:, None] - x[None, :]) * inv_h
    zb = (b[:, None] - x[None, :]) * inv_h
    d_Phi = G.phi_diff(za, zb)
    return d_Phi, x[None, :] * d_Phi - h * G.dens_diff(za, zb)


def _box_terms(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor, tgt: torch.Tensor):
    """Per (box, row) terms (c, s), each (q, n): eq. 11's product, and the
    product with the SUM factor on the target axis, taken by a select, not
    by a division of the product by its Phi difference."""
    inv_h = 1.0 / h_diag
    axis = torch.arange(x.shape[1], device=x.device)
    za = (lo[:, None, :] - x[None]) * inv_h
    zb = (hi[:, None, :] - x[None]) * inv_h
    d_Phi = G.phi_diff(za, zb)                                # (q, n, d)
    moment = x[None] * d_Phi - h_diag * G.dens_diff(za, zb)
    factors = torch.where(axis[None, None, :] == tgt.to(axis.dtype)[:, None, None],
                          moment, d_Phi)
    return torch.prod(d_Phi, dim=2), torch.prod(factors, dim=2)


def _slab_sums(terms, q: int, like: torch.Tensor, five: bool) -> torch.Tensor:
    """(2, q) sums of c and s, or with `five` (5, q) sums (c, s, c^2, s^2,
    c s), over the (c, s) of each QUERY_SLAB-query slab `terms(s0, s1)`."""
    out = torch.zeros((5 if five else 2, q), dtype=like.dtype, device=like.device)
    for s0 in range(0, q, QUERY_SLAB):
        c, s = terms(s0, s0 + QUERY_SLAB)
        parts = (c, s, c * c, s * s, c * s) if five else (c, s)
        out[:, s0:s0 + QUERY_SLAB] = torch.stack([torch.sum(v, dim=1) for v in parts])
    return out


def aqp_batch_moments(x: torch.Tensor, h: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """(5, q): the range terms' sums (c, s, c^2, s^2, c s) over the sample,
    eqs. 9-10 and the three second-moment sums of their CI.  x: (n,), h:
    scalar, a/b: (q,)."""
    return _slab_sums(lambda s0, s1: _batch_terms(x, h, a[s0:s1], b[s0:s1]),
                      a.shape[0], x, five=True)


def aqp_batch_sums(x: torch.Tensor, h: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor):
    """Unscaled closed-form integrals of eqs. 9-10 for a query batch.
    x: (n,), h: scalar, a/b: (q,) -> (count_raw, sum_raw), each (q,)."""
    two = _slab_sums(lambda s0, s1: _batch_terms(x, h, a[s0:s1], b[s0:s1]),
                     a.shape[0], x, five=False)
    return two[0], two[1]


def aqp_box_moments(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """(5, q): the box terms' sums (c, s, c^2, s^2, c s) over the sample,
    eq. 11 and the three second-moment sums of its CI.  x: (n, d), h_diag:
    (d,), lo/hi: (q, d), tgt: (q,) int32."""
    return _slab_sums(lambda s0, s1: _box_terms(x, h_diag, lo[s0:s1], hi[s0:s1],
                                                tgt[s0:s1]),
                      lo.shape[0], x, five=True)


def aqp_box_sums(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, tgt: torch.Tensor):
    """Unscaled eq. 11 box integrals for a query batch (product kernel,
    diagonal bandwidth).  x: (n,d), h_diag: (d,), lo/hi: (q,d), tgt: (q,)
    int32 -> (count_raw, sum_raw), each (q,)."""
    two = _slab_sums(lambda s0, s1: _box_terms(x, h_diag, lo[s0:s1], hi[s0:s1],
                                               tgt[s0:s1]),
                     lo.shape[0], x, five=False)
    return two[0], two[1]


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


def sv_matrix(x: torch.Tensor, m: torch.Tensor, cols=None) -> torch.Tensor:
    """S_ij = (x_i-x_j)^T M (x_i-x_j) on the strict upper triangle, else 0.
    x: (n, d), m: (d, d) -> (n, n).  `cols=(c0, c1)`: the column block
    S[:c1, c0:c1], each entry formed as the whole S's is."""
    n, d = x.shape
    if cols is not None:
        c0, c1 = (int(v) for v in cols)
        out = torch.zeros((c1, c1 - c0), dtype=x.dtype, device=x.device)
        per = max(1, QUAD_SLAB_ELEMS // max(1, (c1 - c0) * d))
        j = torch.arange(c0, c1, device=x.device)
        for a in range(0, c1, per):
            b = min(c1, a + per)
            v = x[a:b, None, :] - x[None, c0:c1, :]          # v[i, j] = x_i - x_j
            s = torch.sum((v @ m) * v, dim=-1)
            i = torch.arange(a, b, device=x.device)
            out[a:b] = torch.where(i[:, None] < j[None, :], s, 0.0)
        return out
    out = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    for start, s in _quad_slabs(x, m):
        out[start:start + s.shape[0], start:] = torch.where(
            torch.isinf(s), 0.0, s)
    return out


def _t_h(s: torch.Tensor, c_k, c_kk) -> torch.Tensor:
    """T_H(s) = c_kk exp(-s/4) - 2 c_k exp(-s/2)  (eqs. 33-35, 40-42)."""
    return c_kk * torch.exp(-0.25 * s) - 2.0 * c_k * torch.exp(-0.5 * s)


def gh_params(h_inv: torch.Tensor, c_k, c_kk) -> torch.Tensor:
    """The gh_fused kernel's rows of B bandwidths, (B, d d + 2): H_b^-1
    row-major, then c_k and c_kk.  h_inv: (B, d, d); c_k, c_kk: B values
    (numbers where B = 1), in h_inv's dtype and on its device."""
    b, d, _ = h_inv.shape

    def col(c):
        return torch.as_tensor(c, dtype=h_inv.dtype, device=h_inv.device).reshape(b, 1)
    return torch.cat([h_inv.reshape(b, d * d), col(c_k), col(c_kk)], dim=1)


def gh_fused_sums(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """sum_{i<j} T_H(x_i - x_j)  (LSCV_H eq. 32 inner sum, fused §6.3) of
    each bandwidth of params (B, d d + 2, as `gh_params` packs them).
    x: (n, d) -> (B,)."""
    d = x.shape[1]
    sums = []
    for row in params:
        acc = torch.zeros((), dtype=x.dtype, device=x.device)
        for _, s in _quad_slabs(x, row[:d * d].reshape(d, d)):
            acc = acc + torch.sum(_t_h(s, row[d * d], row[d * d + 1]))
        sums.append(acc)
    return torch.stack(sums)


def gh_fused_sum(x: torch.Tensor, h_inv: torch.Tensor, c_k, c_kk
                 ) -> torch.Tensor:
    """`gh_fused_sums` of one bandwidth.  x: (n, d), h_inv: (d, d) -> 0-d."""
    return gh_fused_sums(x, gh_params(h_inv[None], c_k, c_kk))[0]


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
                          c_kk, blocks=None, tile=None, slab=None) -> torch.Tensor:
    """The grid phase alone (§6.2 phase 2): `lscv_grid_sums` over a
    precomputed (n, n) S, reading its strict upper triangle only; with
    `blocks`, the pairs of that range of the kernel's tiles of side `tile`
    only.  `slab=(c0, n)`: s_mat is `sv_matrix(x, m, cols=(c0, c1))` of an
    n-point x, and only its pairs count."""
    if slab is not None:
        c0, n = (int(v) for v in slab)
        inv_h2 = 1.0 / (h_grid * h_grid)
        acc = torch.zeros(h_grid.shape, dtype=s_mat.dtype, device=s_mat.device)
        j = c0 + torch.arange(s_mat.shape[1], device=s_mat.device)
        per = max(1, QUAD_SLAB_ELEMS // max(1, s_mat.shape[1]))
        for a in range(0, s_mat.shape[0], per):
            i = torch.arange(a, min(s_mat.shape[0], a + per), device=s_mat.device)
            acc = _grid_fold(acc, torch.where(_upper(i, j, n, blocks, tile), s_mat[a:a + per],
                                              torch.inf), inv_h2, c_k, c_kk)
        return acc
    n = s_mat.shape[0]
    inv_h2 = 1.0 / (h_grid * h_grid)
    acc = torch.zeros(h_grid.shape, dtype=s_mat.dtype, device=s_mat.device)
    rows_per = max(1, QUAD_SLAB_ELEMS // max(1, n))
    j = torch.arange(n, device=s_mat.device)
    for start in range(0, n, rows_per):
        blk = s_mat[start:start + rows_per, start:]
        i = start + torch.arange(blk.shape[0], device=s_mat.device)
        s = torch.where(_upper(i, j[start:], n, blocks, tile), blk, torch.inf)
        acc = _grid_fold(acc, s, inv_h2, c_k, c_kk)
    return acc


# --- GROUP BY, full-H and scalar-h density evaluation -------------------------

def _grouped_terms(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, glo: torch.Tensor, ghi: torch.Tensor,
                   g_axis: int, tgt: int):
    """Per-row terms (c, s), each (n, G), of one GROUP BY family: c =
    shared_cnt * gPhi, and s with the first-moment factor on the shared
    product when the target is a kept axis, on the group factor when it is
    the group axis."""
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
    c = shared_cnt[:, None] * g_Phi
    if tgt == g_axis:
        g_moment = xg[:, None] * g_Phi - hg * G.dens_diff(gza, gzb)
        return c, shared_cnt[:, None] * g_moment
    moment = x * d_Phi - h_diag * G.dens_diff(za, zb)
    factors = torch.where(axis == tgt, moment, d_Phi)
    shared_sm = torch.prod(torch.where(keep, factors, 1.0), dim=1)
    return c, shared_sm[:, None] * g_Phi


def aqp_grouped_sums(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, glo: torch.Tensor, ghi: torch.Tensor,
                     g_axis: int, tgt: int):
    """Unscaled factored GROUP BY integrals (eq. 11): the shared-axes
    product crossed with G per-category windows on axis `g_axis`.  x: (n,d),
    h_diag/lo/hi: (d,) (the group axis's lo/hi ignored), glo/ghi: (G,) ->
    (count_raw, sum_raw), each (G,).  The first-moment factor sits on the
    shared product when the target is a kept axis, on the group factor when
    it is the group axis."""
    c, s = _grouped_terms(x, h_diag, lo, hi, glo, ghi, g_axis, tgt)
    return torch.sum(c, dim=0), torch.sum(s, dim=0)


def aqp_grouped_moments(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor, wlo: torch.Tensor, whi: torch.Tensor,
                        win, g_axis, tgt) -> torch.Tensor:
    """The five moment sums of F GROUP BY families: (F, 5, Gmax) with
    (sum c, sum s, sum c^2, sum s^2, sum c s) over the rows per (family,
    category), c and s the per-row terms of `aqp_grouped_sums`.  x: (n,d),
    h_diag: (d,), lo/hi: (F, d), wlo/whi: (W, Gmax) window tables; win,
    g_axis, tgt: F ints (family f's table, group axis, target axis)."""
    lo = torch.as_tensor(lo, device=x.device)
    hi = torch.as_tensor(hi, device=x.device)
    wlo = torch.as_tensor(wlo, device=x.device)
    whi = torch.as_tensor(whi, device=x.device)
    out = torch.zeros((lo.shape[0], 5, wlo.shape[1]), dtype=x.dtype, device=x.device)
    for f, (w, g, t) in enumerate(zip(win, g_axis, tgt)):
        c, s = _grouped_terms(x, h_diag, lo[f], hi[f], wlo[int(w)], whi[int(w)],
                              int(g), int(t))
        out[f] = torch.stack([torch.sum(c, dim=0), torch.sum(s, dim=0),
                              torch.sum(c * c, dim=0), torch.sum(s * s, dim=0),
                              torch.sum(c * s, dim=0)])
    return out


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


def _box_density_sums(nodes: torch.Tensor, f: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor, tgt: torch.Tensor):
    """For densities f: (S, m) at the nodes, the per-box sums over the nodes
    inside each box of f and of f times the node's target coordinate:
    (cnt_sums, sum_sums), each (S, q)."""
    cnt, sm = [], []
    for start in range(0, lo.shape[0], QUERY_SLAB):
        w = inside_boxes(nodes, lo[start:start + QUERY_SLAB],
                         hi[start:start + QUERY_SLAB])[None] * f[:, None, :]
        tvals = nodes.T[tgt[start:start + QUERY_SLAB].long()]      # (qs, m)
        cnt.append(torch.sum(w, dim=2))
        sm.append(torch.sum(w * tvals[None], dim=2))
    if not cnt:
        z = torch.zeros((f.shape[0], 0), dtype=f.dtype, device=f.device)
        return z, z.clone()
    return torch.cat(cnt, dim=1), torch.cat(sm, dim=1)


def qmc_box_reduce(nodes: torch.Tensor, x: torch.Tensor, h_inv: torch.Tensor,
                   log_norm, lo: torch.Tensor, hi: torch.Tensor,
                   tgt: torch.Tensor):
    """Raw double sums of the fused QMC box reduction: for each box q, the
    sum over nodes inside it of the summed (not averaged) full-H Gaussian
    kernel values against the whole sample, and the same weighted by the
    node's target coordinate.  nodes: (m,d), x: (n,d), h_inv: (d,d),
    lo/hi: (q,d), tgt: (q,) -> (cnt_sums, sum_sums)."""
    f = _node_densities(nodes, x, h_inv, log_norm)
    cnt, sm = _box_density_sums(nodes, f[None], lo, hi, tgt)
    return cnt[0], sm[0]


def qmc_box_reduce_split(nodes: torch.Tensor, x: torch.Tensor,
                         h_inv: torch.Tensor, log_norm, lo: torch.Tensor,
                         hi: torch.Tensor, tgt: torch.Tensor, splits: int):
    """`qmc_box_reduce` over the whole sample and over each of `splits`
    row chunks x[j c:(j + 1) c], c = n // splits: (cnt_sums, sum_sums), each
    (splits + 1, q), row 0 the whole sample (the chunks' densities plus the
    tail's, in that order), row 1 + j chunk j."""
    n = x.shape[0]
    splits = int(splits)
    if not 0 <= splits <= 16 or (n and splits > n):
        raise ValueError(f"splits={splits} must lie in [0, min(16, n={n})]")
    c = n // splits if splits else 0
    fs = [_node_densities(nodes, x[j * c:(j + 1) * c], h_inv, log_norm)
          for j in range(splits)]
    full = torch.zeros((nodes.shape[0],), dtype=x.dtype, device=x.device)
    for fj in fs:
        full = full + fj
    full = full + _node_densities(nodes, x[splits * c:], h_inv, log_norm)
    return _box_density_sums(nodes, torch.stack([full] + fs), lo, hi, tgt)


DRAW_SLAB = 1 << 15  # kernel draws per slab of the kernel-centred box sums


def draw_box_reduce(x: torch.Tensor, z: torch.Tensor, l_chol: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor, tgt: torch.Tensor,
                    splits: int):
    """Kernel-centred box sums: draw j of row i is y_ij = x_i + L z_{i K + j}
    (K = z.shape[0] // m, float32); for each closed box, the count of the
    draws inside it and the sum of their target coordinate, as float64
    (cnt_sums, sum_sums), each (splits + 1, q): row 1 + j over rows
    [j c, (j + 1) c) of x, c = m // splits, row 0 over the whole sample
    (the chunks' sums, then the tail's).  x: (m, d) with 1 <= d <= 8,
    z: (m K, d), l_chol: (d, d) lower triangular, lo/hi: (q, d), tgt: (q,)."""
    m, d = x.shape
    if not 1 <= d <= 8:
        raise ValueError(f"draw_box_reduce takes 1 <= d <= 8, got d={d}")
    splits = int(splits)
    if not 0 <= splits <= 16 or (m and splits > m):
        raise ValueError(f"splits={splits} must lie in [0, min(16, m={m})]")
    q = lo.shape[0]
    # columns 0..splits-1 the chunks, column `splits` the tail
    parts = torch.zeros((2, q, splits + 1), dtype=torch.float64, device=x.device)
    if m and q:
        draws = z.shape[0] // m
        c = m // splits if splits else m
        col = torch.clamp(torch.arange(m, device=x.device) // c, max=splits)
        tcol = tgt.long()
        rows_per = max(1, DRAW_SLAB // draws)
        for r0 in range(0, m, rows_per):
            r1 = min(m, r0 + rows_per)
            y = (torch.repeat_interleave(x[r0:r1], draws, dim=0)
                 + z[r0 * draws:r1 * draws] @ l_chol.T)
            w = inside_boxes(y, lo, hi).to(torch.float64)             # (q, draws)
            wy = w * y[:, tcol].T.to(torch.float64)
            for k, v in enumerate((w, wy)):
                parts[k].index_add_(1, col[r0:r1], v.view(q, r1 - r0, draws).sum(dim=2))
    whole = parts[:, :, :splits].sum(dim=2) + parts[:, :, splits]
    out = torch.cat([whole[:, None], parts[:, :, :splits].transpose(1, 2)], dim=1)
    return out[0], out[1]


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


def rff_density_blocks(points: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       z: torch.Tensor, n_blocks: int):
    """(blocks, estimate): `rff_density` over each feature block
    [k cb, (k + 1) cb), cb = D // n_blocks, as (n_blocks, m), and over all
    D features as the sum of the blocks and then the D mod n_blocks
    remainder features, (m,)."""
    nf = w.shape[0]
    n_blocks = int(n_blocks)
    if not 1 <= n_blocks <= max(nf, 1):
        raise ValueError(f"n_blocks={n_blocks} must lie in [1, D={nf}]")
    cb = nf // n_blocks
    blocks = [rff_density(points, w[k * cb:(k + 1) * cb], b[k * cb:(k + 1) * cb],
                          z[k * cb:(k + 1) * cb]) for k in range(n_blocks)]
    est = blocks[0]
    for blk in blocks[1:]:
        est = est + blk
    if n_blocks * cb < nf:
        est = est + rff_density(points, w[n_blocks * cb:], b[n_blocks * cb:],
                                z[n_blocks * cb:])
    return torch.stack(blocks), est


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
