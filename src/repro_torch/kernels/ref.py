"""Plain PyTorch versions of the port's kernels.
Counterpart: `repro/kernels/ref.py:17-27,68-86,154-166`.

Each function computes what its CUDA kernel computes, untiled, on any
device: the CPU tests use them, the `ops.py` wrappers take them for tensors
on the CPU, and `chip_smoke.py` holds each kernel against them on the card.
Where the reference forms a Phi difference as 0.5*(erf(zb/sqrt2) -
erf(za/sqrt2)), which cancels in the far tails, these take both terms from
the tail the pair sits in (`gaussian.phi_diff`), as the kernels do.  Work is cut into
row or query slabs so the card's memory holds the main path's shapes.
"""
from __future__ import annotations

import torch

from repro_torch.core import gaussian as G

_FUNS = {"k4": G.k4, "k6": G.k6, "gauss": G.phi}

ROW_SLAB = 2048      # pairwise rows per slab: (2048, n) floats at a time
QUERY_SLAB = 64      # queries per slab for the (q, n[, d]) AQP terms


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
