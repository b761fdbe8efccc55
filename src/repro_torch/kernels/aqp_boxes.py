"""Launcher of the batched box-query kernel (`csrc/aqp_boxes.cu`): the
unscaled eq. 11 sums of a box batch over a joint sample with diagonal
bandwidth.  Counterpart: `repro/kernels/aqp_boxes.py` (`aqp_box_sums`).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import (GRID_Y_MAX, SMEM_MAX, LaunchCounter, check_tensor,
                      check_tile, ptr, raise_on, stream)

TILE = 256          # sample rows per block (one shared-memory chunk)
Q_TILE = 128        # queries per block, one per thread
MAX_D = 8           # the kernel is instantiated for d = 1..8


launches = LaunchCounter("aqp_box_sums")


def _fn():
    fn = _build.load("aqp_boxes").aqp_box_sums_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def aqp_box_sums(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, tgt: torch.Tensor, tile: int, q_tile: int):
    """(count_raw, sum_raw), each (q,) float32.  x: (n, d) float32, h_diag:
    (d,) float32, lo/hi: (q, d) float32, tgt: (q,) int32 in [0, d), all on
    one CUDA device; 1 <= d <= 8.  n == 0 or q == 0 gives zeros and launches
    nothing."""
    check_tensor(x, "x", torch.float32, (None, None))
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"aqp_box_sums takes 1 <= d <= {MAX_D}, got d={d}")
    check_tensor(h_diag, "h_diag", torch.float32, (d,), x.device)
    check_tensor(lo, "lo", torch.float32, (None, d), x.device)
    q = lo.shape[0]
    check_tensor(hi, "hi", torch.float32, (q, d), x.device)
    check_tensor(tgt, "tgt", torch.int32, (q,), x.device)
    cnt = torch.zeros((q,), dtype=torch.float32, device=x.device)
    sm = torch.zeros((q,), dtype=torch.float32, device=x.device)
    if n == 0 or q == 0:
        return cnt, sm
    tile = int(tile)
    if not 1 <= tile or tile * d * 4 > SMEM_MAX:
        raise ValueError(f"tile={tile} must be in [1, {SMEM_MAX // (4 * d)}] "
                         f"for d={d}")
    qk = min(check_tile(q_tile, "q_tile"), -(-q // 32) * 32)
    n_chunks = -(-n // tile)
    if n_chunks > GRID_Y_MAX:
        raise ValueError(f"n={n} needs {n_chunks} chunks of {tile}; raise the tile")
    partials = torch.empty((n_chunks, 2, q), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), n, d, ptr(h_diag), ptr(lo), ptr(hi), ptr(tgt), q,
                    tile, qk, ptr(partials), ptr(cnt), ptr(sm), stream(x.device))
    raise_on(err, "aqp_box_sums")
    launches.inc()
    return cnt, sm
