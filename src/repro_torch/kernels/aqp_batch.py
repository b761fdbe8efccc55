"""Launcher of the batched range-query kernel (`csrc/aqp_batch.cu`): the
unscaled eq. 9-10 sums of a query batch over a 1-D sample and the three
second-moment sums of their CI, in one launch.
Counterpart: `repro/kernels/aqp_batch.py` (`aqp_batch_sums`).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from ._launch import GRID_Y_MAX, LaunchCounter, check_tensor, fixed_range, ptr, raise_on, stream

TILE = 4096         # most sample points per block (a range, split over 32 lanes)
Q_TILE = 32         # queries per block: kRows (4) per warp x kWarps (8)
RANGES = 160        # point ranges n is cut into by default (224 points each at n = 32 768)


launches = LaunchCounter("aqp_batch_sums")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("aqp_batch").aqp_batch_moments_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def aqp_batch_moments(x: torch.Tensor, h: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, tile: int, ranges: int) -> torch.Tensor:
    """(5, q) float32: per query the sums over the sample of c (eq. 9's term)
    and s (eq. 10's) as (sum c, sum s, sum c^2, sum s^2, sum c s).  x: (n,),
    h: one element, a/b: (q,), all float32 on one CUDA device; tile: the
    most points per block, a multiple of 32; ranges: how many point ranges
    n is cut into at most (`fixed_range`).  The point ranges come from n,
    `tile` and `ranges` alone, so a query's sums are the same bits in any
    batch.  n == 0 or
    q == 0 gives zeros and launches nothing."""
    check_tensor(x, "x", torch.float32, (None,))
    check_tensor(h.reshape(1), "h", torch.float32, (1,), x.device)
    check_tensor(a, "a", torch.float32, (None,), x.device)
    check_tensor(b, "b", torch.float32, (a.shape[0],), x.device)
    tile = int(tile)
    if tile < 32 or tile % 32:
        raise ValueError(f"tile={tile} must be a positive multiple of 32")
    ranges = int(ranges)
    if ranges < 1:
        raise ValueError(f"ranges={ranges} must be positive")
    n, q = x.shape[0], a.shape[0]
    if n == 0 or q == 0:
        return torch.zeros((5, q), dtype=torch.float32, device=x.device)
    pts = fixed_range(n, ranges, 32, tile)
    n_ranges = -(-n // pts)
    if n_ranges > GRID_Y_MAX:
        raise ValueError(f"n={n} needs {n_ranges} ranges of {pts}; raise the tile")
    # one allocation: the (5, q) sums, then their (5, q, ranges) partials
    buf = torch.empty((5 * q * (1 + n_ranges),), dtype=torch.float32, device=x.device)
    out = buf[:5 * q].view(5, q)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), n, ptr(h.reshape(1)), ptr(a), ptr(b), q, pts,
                    ptr(buf[5 * q:]), ptr(out), stream(x.device))
    raise_on(err, "aqp_batch_sums")
    launches.inc()
    return out


def aqp_batch_sums(x: torch.Tensor, h: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, tile: int, ranges: int):
    """(count_raw, sum_raw), each (q,) float32: the first two rows of
    `aqp_batch_moments`'s launch."""
    five = aqp_batch_moments(x, h, a, b, tile=tile, ranges=ranges)
    return five[0], five[1]
