"""Triangular tile index math of the paper's Appendix A (eqs. 49/50).
Counterpart: `repro/kernels/triangle.py`.

A 1-D grid enumerates only the upper-triangle tiles (diagonal included) of
an n_tiles x n_tiles tile matrix, column-major:

  l = ceil((sqrt(8 bx + 9) - 3) / 2)      (eq. 49, tile column)
  q = bx - l (l + 1) / 2                  (eq. 50, tile row)

A float32 sqrt is off by one near perfect-square discriminants, so l is
corrected by +-1 against the closed-form block counts (eq. 66): column l is
right iff l(l+1)/2 <= bx < (l+1)(l+2)/2.  The CUDA kernel
(`csrc/pairwise_reduce.cu`) does the same in double precision.
"""
from __future__ import annotations

import torch


def n_tri_tiles(n_tiles: int) -> int:
    """Tiles in the upper triangle (diagonal included) of an
    n_tiles x n_tiles tile matrix (eq. 66 with l = n_tiles - 1)."""
    return n_tiles * (n_tiles + 1) // 2


def bx_to_ql(bx):
    """eqs. (49)/(50) with the +-1 correction.  Returns (q, l) = (row, col)
    as int64 tensors; `bx` is an int or an integer tensor."""
    bx = torch.as_tensor(bx, dtype=torch.int64)
    l0 = torch.ceil((torch.sqrt(8.0 * bx.to(torch.float32) + 9.0) - 3.0)
                    / 2.0).to(torch.int64)

    def ok(l):
        return (l * (l + 1) // 2 <= bx) & (bx < (l + 1) * (l + 2) // 2)

    l = torch.where(ok(l0 - 1), l0 - 1, torch.where(ok(l0), l0, l0 + 1))
    return bx - l * (l + 1) // 2, l


def ql_to_bx(q, l):
    """Inverse mapping: bx = l(l+1)/2 + q, valid for q <= l."""
    return l * (l + 1) // 2 + q
