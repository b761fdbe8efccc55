"""Reduction building blocks of the paper (§5.2-5.5) as plain PyTorch.
Counterpart: `repro/core/reductions.py`.

  R(A)        = sum_i A_i                    (§5.2)  reduce_sum
  R_fun(A)    = sum_i fun(A_i)               (§5.3)  map_reduce
  RR_fun(A)   = sum_{i<j} fun(A_i - A_j)     (§5.4)  pairwise_reduce
  RR^v_fun(A) = sum_{i<j} fun(S_ij),         (§5.5)  pairwise_quadform_*
                S_ij = (x_i - x_j)^T M (x_i - x_j)

`pairwise_reduce` is the plain path PLUGIN takes and `pairwise_quadform_*`
the plain paths of the LSCV selectors; the hand-written kernels
(`kernels/csrc/*.cu`) tile the same triangle.  Row chunks keep the live
working set at O(chunk * n) (O(chunk * n * d) for the quadratic forms)
instead of O(n^2).
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def reduce_sum(a: torch.Tensor) -> torch.Tensor:
    """R(A) (§5.2)."""
    return torch.sum(a)


def kahan_sum(a: torch.Tensor) -> torch.Tensor:
    """Kahan-compensated sequential float32 sum — an accuracy oracle only;
    it runs element by element on the host."""
    s = np.float32(0.0)
    c = np.float32(0.0)
    for x in a.detach().reshape(-1).cpu().numpy().astype(np.float32):
        y = x - c
        t = s + y
        c = (t - s) - y
        s = t
    return torch.tensor(s, dtype=a.dtype, device=a.device)


def map_reduce(fun: Callable, a: torch.Tensor, chunk: int = 65536
               ) -> torch.Tensor:
    """R_fun(A) (§5.3): sum_i fun(A_i) for 1-D `a`, `chunk` values of fun
    live at a time."""
    acc = torch.zeros((), dtype=a.dtype, device=a.device)
    for start in range(0, a.shape[0], chunk):
        acc = acc + torch.sum(fun(a[start:start + chunk]))
    return acc


def pairwise_reduce(fun: Callable, x: torch.Tensor, chunk: int = 256
                    ) -> torch.Tensor:
    """RR_fun(A) (§5.4): sum_{i<j} fun(x_i - x_j) for 1-D x, one
    (chunk, n) row stripe of the pair matrix at a time, masked to the
    strict upper triangle."""
    n = x.shape[0]
    cols = torch.arange(n, device=x.device)
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for start in range(0, n, chunk):
        rows = x[start:start + chunk]
        row_idx = start + torch.arange(rows.shape[0], device=x.device)
        vals = fun(rows[:, None] - x[None, :])
        mask = row_idx[:, None] < cols[None, :]
        acc = acc + torch.sum(torch.where(mask, vals, 0.0))
    return acc


def pairwise_quadform_chunks(x: torch.Tensor, m: torch.Tensor,
                             chunk: int = 128) -> Callable:
    """The S(v) slabs of RR^v_fun (§5.5): S_ij = (x_i-x_j)^T M (x_i-x_j).

    Returns `scan_slabs(consume, init)`, which walks (chunk, n) row slabs of
    the quadratic forms in order and folds each into the carry with
    `consume(acc, s_slab, mask)`; `mask` marks the strict upper triangle.
    The shared backbone of the stored-S path, the fused LSCV_h grid and the
    LSCV_H objective (M = H^-1 changes per evaluation, §6.3).  x: (n, d)."""
    n = x.shape[0]
    c = max(1, min(chunk, n))
    cols = torch.arange(n, device=x.device)

    def scan_slabs(consume: Callable, init):
        acc = init
        for start in range(0, n, c):
            rows = x[start:start + c]
            row_idx = start + torch.arange(rows.shape[0], device=x.device)
            v = rows[:, None, :] - x[None, :, :]             # (c, n, d)
            s = torch.sum((v @ m) * v, dim=-1)                # quadratic forms
            mask = row_idx[:, None] < cols[None, :]
            acc = consume(acc, s, mask)
        return acc

    return scan_slabs


def pairwise_quadform_reduce(fun1: Callable, x: torch.Tensor, m: torch.Tensor,
                             chunk: int = 128) -> torch.Tensor:
    """RR^v_fun (§5.5 with §5.3 fused, as in the paper's LSCV_H GPU kernel,
    §6.3): sum_{i<j} fun1((x_i-x_j)^T M (x_i-x_j)), never materialising S."""
    scan_slabs = pairwise_quadform_chunks(x, m, chunk)

    def consume(acc, s, mask):
        return acc + torch.sum(torch.where(mask, fun1(s), 0.0))

    return scan_slabs(consume, torch.zeros((), dtype=x.dtype, device=x.device))


def pairwise_sv_matrix(x: torch.Tensor, m: torch.Tensor, chunk: int = 128
                       ) -> torch.Tensor:
    """The paper's §4.5 precompute: the dense (n, n) matrix of S(v) values
    with the diagonal and the lower triangle zeroed."""
    n = x.shape[0]
    out = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    scan_slabs = pairwise_quadform_chunks(x, m, chunk)

    def consume(carry: Tuple[torch.Tensor, int], s, mask):
        out, start = carry
        out[start:start + s.shape[0]] = torch.where(mask, s, 0.0)
        return out, start + s.shape[0]

    return scan_slabs(consume, (out, 0))[0]
