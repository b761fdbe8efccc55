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

A launch of the pairwise or the LSCV grid kernel may take a contiguous
range of these tiles, `blocks = (begin, count)`: one rank's share of a
distributed sum (`share`, `core/distributed.py`).
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def share(n_tri: int, rank: int, world: int) -> Tuple[int, int]:
    """(begin, count): rank's contiguous part of n_tri tiles split over
    world ranks, the first n_tri % world ranks taking one tile more.  The
    tiles are enumerated column by column, so a contiguous part holds
    whole columns of nearly equal work."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a world of {world}")
    base, extra = divmod(n_tri, world)
    return rank * base + min(rank, extra), base + (rank < extra)


def block_range(blocks: Optional[Tuple[int, int]], n_tri: int) -> Tuple[int, int]:
    """`blocks` checked against n_tri tiles; None means (0, n_tri)."""
    if blocks is None:
        return 0, n_tri
    begin, count = (int(v) for v in blocks)
    if begin < 0 or count < 0 or begin + count > n_tri:
        raise ValueError(f"blocks {tuple(blocks)} outside the {n_tri} triangle tiles")
    return begin, count


def pair_tile(i: torch.Tensor, j: torch.Tensor, k: int) -> torch.Tensor:
    """The tile index bx of each pair i < j under tiles of side k."""
    return ql_to_bx(i // k, j // k)
