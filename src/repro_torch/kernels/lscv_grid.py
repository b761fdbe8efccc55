"""Launcher of the LSCV_h grid kernel (`csrc/lscv_grid.cu`): for every h on
the grid, sum_{i<j} c_kk exp(-S_ij/4h^2) - 2 c_k exp(-S_ij/2h^2) over a
precomputed S (§6.2 phase 2, eqs. 40-43).
Counterpart: `repro/kernels/lscv_grid.py` (`lscv_grid_sums`; its S
precompute is the sv_precompute kernel, composed in `ops.lscv_grid_sums`).
`blocks=(begin, count)` launches a contiguous range of the S tiles only
(one rank's share of a distributed grid, `triangle.share`); with
`slab=(c0, n)` S is a column block of S (`sv_matrix(..., cols=(c0, c1))`)
that holds every column of those tiles (`slab_walk`).
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from . import _build
from ._launch import (LaunchCounter, check_tensor, check_tile, ptr, raise_on,
                      scalar_arg, stream)
from .triangle import block_range, bx_to_ql, n_tri_tiles

TILE = 64           # side of an S tile in shared memory (kGridTile in the source)
H_TILE = 256        # grid points per pass of a block, one per thread
POLY_SHARE = 1 / 8   # terms on the FP32-pipe 2^x: kPolyTerms / (4 kGroup) in the source

NEG_QUARTER_LOG2E = -0.25 * math.log2(math.e)


launches = LaunchCounter("lscv_grid_sums")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("lscv_grid").lscv_grid_sums_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def column_start(l: int) -> int:
    """The first triangle tile (bx) of tile column l (eq. 66)."""
    return l * (l + 1) // 2


def slab_cols_of(begin: int, count: int, n: int, tile: int = TILE) -> tuple:
    """(c0, c1): the columns of S that the tiles begin .. begin + count - 1
    read, from their first tile column's to their last's."""
    l_a = int(bx_to_ql(begin)[1])
    l_b = int(bx_to_ql(begin + count - 1)[1])
    return l_a * tile, min(n, (l_b + 1) * tile)


def slab_walk(n: int, blocks=None, slab_bytes: int = 512 << 20, tile: int = TILE):
    """Yield (begin, count, c0, c1): the tiles of `blocks` (None: the whole
    triangle) as consecutive runs of whole tile columns (the range's ends
    may cut one), each with the columns (c0, c1) of S it reads, the fewest
    runs whose column blocks of S, c1 x (c1 - c0) float32, fit `slab_bytes`
    (a run takes at least one column, whatever its block)."""
    n_tri = n_tri_tiles(-(-n // tile))
    begin, count = block_range(blocks, n_tri)
    end = begin + count
    while begin < end:
        l_a = int(bx_to_ql(begin)[1])
        l_b = l_a
        while column_start(l_b + 1) < end:
            c1 = min(n, (l_b + 2) * tile)
            if 4 * (c1 - l_a * tile) * c1 > slab_bytes:
                break
            l_b += 1
        stop = min(end, column_start(l_b + 1))
        yield (begin, stop - begin) + slab_cols_of(begin, stop - begin, n, tile)
        begin = stop


def lscv_grid_sums_from_s(s: torch.Tensor, h_grid: torch.Tensor, c_k, c_kk,
                          h_tile: int, blocks=None, slab=None) -> torch.Tensor:
    """(n_h,) float32 on S's device.  s: (n, n) float32 CUDA, of which only
    the strict upper triangle is read; h_grid: (n_h,) float32 on the same
    device; c_k, c_kk: numbers or one-element tensors (read on the device;
    a number is copied there first); `blocks` the (begin, count) range of
    TILE-side tiles, None for all.  `slab=(c0, n)`: s is the column block
    S[:c1, c0:c1] of an n-point S, c0 a multiple of TILE, which must hold
    every column of the tiles launched.
    n == 0 or count 0 gives zeros and launches nothing."""
    check_tensor(s, "s", torch.float32, (None, None))
    if slab is None:
        n, col0 = s.shape[0], 0
        check_tensor(s, "s", torch.float32, (n, n))
    else:
        col0, n = (int(v) for v in slab)
        ld = s.shape[1]
        check_tensor(s, "s", torch.float32, (col0 + ld, ld))
        if col0 < 0 or col0 % TILE or col0 + ld > n:
            raise ValueError(f"a block of columns {col0} .. {col0 + ld} of an n={n} S "
                             f"(its first a multiple of {TILE})")
    check_tensor(h_grid, "h_grid", torch.float32, (None,), s.device)
    n_h = h_grid.shape[0]
    threads = min(check_tile(h_tile, "h_tile"), -(-n_h // 32) * 32)
    ck = scalar_arg(c_k, "c_k", s.device)
    ckk = scalar_arg(c_kk, "c_kk", s.device)
    if n == 0 or n_h == 0:
        return torch.zeros((n_h,), dtype=torch.float32, device=s.device)
    n_tri = n_tri_tiles(-(-n // TILE))
    if n_tri >= 2 ** 31:
        raise ValueError(f"n={n} needs {n_tri} tiles of {TILE}, beyond one grid")
    begin, count = block_range(blocks, n_tri)
    if count == 0:
        return torch.zeros((n_h,), dtype=torch.float32, device=s.device)
    if slab is not None:
        c0, c1 = slab_cols_of(begin, count, n)
        if c0 < col0 or c1 > col0 + s.shape[1]:
            raise ValueError(f"tiles {begin} .. {begin + count - 1} read columns {c0} .. "
                             f"{c1} of S, beyond the block's {col0} .. {col0 + s.shape[1]}")
    a_h = (NEG_QUARTER_LOG2E / (h_grid * h_grid)).contiguous()
    out = torch.empty((n_h,), dtype=torch.float32, device=s.device)
    partials = torch.empty((n_h, count), dtype=torch.float32, device=s.device)
    with torch.cuda.device(s.device):
        err = _fn()(ptr(s), n, col0, s.shape[1], ptr(a_h), n_h, ptr(ck), ptr(ckk), threads,
                    begin, count, ptr(partials), ptr(out), stream(s.device))
    raise_on(err, "lscv_grid_sums")
    launches.inc()
    return out
