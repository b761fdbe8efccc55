"""Launcher of the LSCV_h grid kernel (`csrc/lscv_grid.cu`): for every h on
the grid, sum_{i<j} c_kk exp(-S_ij/4h^2) - 2 c_k exp(-S_ij/2h^2) over a
precomputed S (§6.2 phase 2, eqs. 40-43).
Counterpart: `repro/kernels/lscv_grid.py` (`lscv_grid_sums`; its S
precompute is the sv_precompute kernel, composed in `ops.lscv_grid_sums`).
`blocks=(begin, count)` launches a contiguous range of the S tiles only
(one rank's share of a distributed grid, `triangle.share`).
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from . import _build
from ._launch import (LaunchCounter, check_tensor, check_tile, ptr, raise_on,
                      scalar_arg, stream)
from .triangle import block_range, n_tri_tiles

TILE = 64           # side of an S tile in shared memory (kGridTile in the source)
H_TILE = 256        # grid points per pass of a block, one per thread
POLY_SHARE = 1 / 8   # terms on the FP32-pipe 2^x: kPolyTerms / (4 kGroup) in the source

NEG_QUARTER_LOG2E = -0.25 * math.log2(math.e)


launches = LaunchCounter("lscv_grid_sums")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("lscv_grid").lscv_grid_sums_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lscv_grid_sums_from_s(s: torch.Tensor, h_grid: torch.Tensor, c_k, c_kk,
                          h_tile: int, blocks=None) -> torch.Tensor:
    """(n_h,) float32 on S's device.  s: (n, n) float32 CUDA, of which only
    the strict upper triangle is read; h_grid: (n_h,) float32 on the same
    device; c_k, c_kk: numbers or one-element tensors (read on the device;
    a number is copied there first); `blocks` the (begin, count) range of
    TILE-side tiles, None for all.
    n == 0 or count 0 gives zeros and launches nothing."""
    check_tensor(s, "s", torch.float32, (None, None))
    n = s.shape[0]
    check_tensor(s, "s", torch.float32, (n, n))
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
    a_h = (NEG_QUARTER_LOG2E / (h_grid * h_grid)).contiguous()
    out = torch.empty((n_h,), dtype=torch.float32, device=s.device)
    partials = torch.empty((n_h, count), dtype=torch.float32, device=s.device)
    with torch.cuda.device(s.device):
        err = _fn()(ptr(s), n, ptr(a_h), n_h, ptr(ck), ptr(ckk), threads, begin,
                    count, ptr(partials), ptr(out), stream(s.device))
    raise_on(err, "lscv_grid_sums")
    launches.inc()
    return out
