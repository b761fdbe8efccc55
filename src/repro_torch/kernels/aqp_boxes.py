"""Launcher of the batched box-query kernel (`csrc/aqp_boxes.cu`): the
unscaled eq. 11 sums of a box batch over a joint sample with diagonal
bandwidth and the three second-moment sums of their CI, in one launch.
Counterpart: `repro/kernels/aqp_boxes.py` (`aqp_box_sums`).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from ._launch import GRID_Y_MAX, LaunchCounter, check_tensor, fixed_range, ptr, raise_on, stream

TILE = 4096         # most sample rows per block (a range, split over 32 lanes)
Q_TILE = 32         # boxes per block: kRows (4) per warp x kWarps (8)
RANGES = 64         # row ranges n is cut into by default (512 rows each at n = 32 768)
MAX_D = 8           # the kernel is instantiated for d = 1..8


launches = LaunchCounter("aqp_box_sums")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("aqp_boxes").aqp_box_moments_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def aqp_box_moments(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, tgt: torch.Tensor, tile: int,
                    ranges: int) -> torch.Tensor:
    """(5, q) float32: per box the sums over the sample rows of c (eq. 11's
    product) and s (the product with the SUM factor on the target axis) as
    (sum c, sum s, sum c^2, sum s^2, sum c s).  x: (n, d) float32, h_diag:
    (d,) float32, lo/hi: (q, d) float32, tgt: (q,) int32 in [0, d) (another
    target gives NaN in the rows that hold s), all on one CUDA device;
    1 <= d <= 8; tile: the most rows per block, a multiple of 32; ranges:
    how many row ranges n is cut into at most (`fixed_range`).  The row
    ranges come from n, `tile` and `ranges` alone, so a box's sums are the
    same bits in any batch.  n == 0 or q == 0 gives zeros and launches nothing."""
    check_tensor(x, "x", torch.float32, (None, None))
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"aqp_box_sums takes 1 <= d <= {MAX_D}, got d={d}")
    check_tensor(h_diag, "h_diag", torch.float32, (d,), x.device)
    check_tensor(lo, "lo", torch.float32, (None, d), x.device)
    q = lo.shape[0]
    check_tensor(hi, "hi", torch.float32, (q, d), x.device)
    check_tensor(tgt, "tgt", torch.int32, (q,), x.device)
    tile = int(tile)
    if tile < 32 or tile % 32:
        raise ValueError(f"tile={tile} must be a positive multiple of 32")
    ranges = int(ranges)
    if ranges < 1:
        raise ValueError(f"ranges={ranges} must be positive")
    if n == 0 or q == 0:
        return torch.zeros((5, q), dtype=torch.float32, device=x.device)
    rows = fixed_range(n, ranges, 32, tile)
    n_ranges = -(-n // rows)
    if n_ranges > GRID_Y_MAX:
        raise ValueError(f"n={n} needs {n_ranges} ranges of {rows}; raise the tile")
    # one allocation: the (5, q) sums, then their (5, q, ranges) partials
    buf = torch.empty((5 * q * (1 + n_ranges),), dtype=torch.float32, device=x.device)
    out = buf[:5 * q].view(5, q)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), n, d, ptr(h_diag), ptr(lo), ptr(hi), ptr(tgt), q, rows,
                    ptr(buf[5 * q:]), ptr(out), stream(x.device))
    raise_on(err, "aqp_box_sums")
    launches.inc()
    return out


def aqp_box_sums(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, tgt: torch.Tensor, tile: int, ranges: int):
    """(count_raw, sum_raw), each (q,) float32: the first two rows of
    `aqp_box_moments`'s launch."""
    five = aqp_box_moments(x, h_diag, lo, hi, tgt, tile=tile, ranges=ranges)
    return five[0], five[1]
