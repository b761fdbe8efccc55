"""Reduction building blocks of the paper (§5.2-5.4) as plain PyTorch.
Counterpart: `repro/core/reductions.py:27-101`.

  R(A)        = sum_i A_i                    (§5.2)  reduce_sum
  R_fun(A)    = sum_i fun(A_i)               (§5.3)  map_reduce
  RR_fun(A)   = sum_{i<j} fun(A_i - A_j)     (§5.4)  pairwise_reduce

`pairwise_reduce` is the plain path PLUGIN takes; the hand-written kernel
(`kernels/csrc/pairwise_reduce.cu`) tiles the same triangle.  Row chunks keep
the live working set at O(chunk * n) instead of O(n^2).
"""
from __future__ import annotations

from typing import Callable

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
