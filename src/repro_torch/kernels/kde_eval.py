"""Launcher of the direct KDE kernel (`csrc/kde_eval.cu`): the scalar-h
Gaussian density f^(p) = norm / n * sum_i exp(-||p - x_i||^2 / (2 h^2))
(paper eq. 3) with norm = (2 pi)^(-d/2) h^(-d), sums and normalisation in
one call of two kernels.
Counterpart: `repro/kernels/kde_eval.py` (`kde_eval`).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from ._launch import (GRID_Y_MAX, LaunchCounter, check_tensor, point_range, ptr,
                      raise_on, scalar_arg, sm_count, stream)

TILE = 4096         # most sample rows per block (a range, split over 32 lanes)
WARPS = 8           # warps per block (kWarps in the source)
# points per warp (registers) by the largest d that takes them: kPtsD4,
# kPtsD8 and kPtsD16 in the source
PTS_PER_WARP = {4: 8, 8: 4, 16: 2}
WAVES = 1           # waves of resident blocks the ranges aim at (two: 10 % slower at m = 513)
MAX_D = 16          # the kernel is instantiated for d = 1..16


launches = LaunchCounter("kde_eval")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("kde_eval").kde_eval_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def blocks_per_sm(index: int, d: int) -> int:
    """Blocks of the d-dimensional kernel that one SM of device `index`
    holds at once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        raise_on(_build.load("kde_eval").kde_eval_blocks_per_sm(d, ctypes.byref(out)),
                 "kde_eval occupancy")
    return out.value


def point_tile(d: int) -> int:
    """Evaluation points per block at dimension d."""
    return WARPS * next(p for top, p in sorted(PTS_PER_WARP.items()) if d <= top)


def row_range(n: int, m: int, d: int, sms: int, bps: int, tile: int = TILE) -> int:
    """Sample rows per block for m points over n rows: the ranges keep the
    grid (point tiles x ranges) within WAVES waves of resident blocks."""
    return point_range(n, -(-m // point_tile(d)), sms, bps, WAVES, tile)


def kde_eval(points: torch.Tensor, x: torch.Tensor, h, tile: int) -> torch.Tensor:
    """(m,) float32 densities.  points: (m, d), x: (n, d) float32 on one
    CUDA device with 1 <= d <= 16 and n >= 1; h: a number or one-element
    tensor (read on the device, never synced to the host); tile: the most
    rows per block, a multiple of 32.  m == 0 gives an empty result and
    launches nothing."""
    check_tensor(x, "x", torch.float32, (None, None))
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"kde_eval takes 1 <= d <= {MAX_D}, got d={d}")
    if n == 0:
        raise ValueError("kde_eval needs a non-empty sample")
    check_tensor(points, "points", torch.float32, (None, d), x.device)
    h_dev = scalar_arg(h, "h", x.device)
    tile = int(tile)
    if tile < 32 or tile % 32:
        raise ValueError(f"tile={tile} must be a positive multiple of 32")
    m = points.shape[0]
    if m == 0:
        return torch.empty((0,), dtype=torch.float32, device=x.device)
    index = x.device.index or 0
    rows = row_range(n, m, d, sm_count(index), blocks_per_sm(index, d), tile)
    n_ranges = -(-n // rows)
    if n_ranges > GRID_Y_MAX:
        raise ValueError(f"n={n} needs {n_ranges} ranges of {rows}; raise the tile")
    # one allocation: the (m,) densities, then their (m, ranges) partials
    buf = torch.empty((m * (1 + n_ranges),), dtype=torch.float32, device=x.device)
    partials = ctypes.c_void_p(buf.data_ptr() + 4 * m)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(points), m, ptr(x), n, d, ptr(h_dev), rows, partials, ptr(buf),
                    stream(x.device))
    raise_on(err, "kde_eval")
    launches.inc()
    return buf[:m]
