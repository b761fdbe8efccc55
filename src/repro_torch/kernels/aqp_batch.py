"""Launcher of the batched range-query kernel (`csrc/aqp_batch.cu`): the
unscaled eq. 9-10 sums of a query batch over a 1-D sample.
Counterpart: `repro/kernels/aqp_batch.py` (`aqp_batch_sums`).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import (GRID_Y_MAX, SMEM_MAX, LaunchCounter, check_tensor,
                      check_tile, ptr, raise_on, stream)

TILE = 512          # sample points per block (one shared-memory chunk)
Q_TILE = 128        # queries per block, one per thread


launches = LaunchCounter("aqp_batch_sums")


def _fn():
    fn = _build.load("aqp_batch").aqp_batch_sums_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def aqp_batch_sums(x: torch.Tensor, h: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, tile: int, q_tile: int):
    """(count_raw, sum_raw), each (q,) float32.  x: (n,), h: one element,
    a/b: (q,), all float32 CUDA.  n == 0 or q == 0 gives zeros and launches
    nothing."""
    check_tensor(x, "x", torch.float32, (None,))
    check_tensor(h.reshape(1), "h", torch.float32, (1,), x.device)
    check_tensor(a, "a", torch.float32, (None,), x.device)
    check_tensor(b, "b", torch.float32, (a.shape[0],), x.device)
    n, q = x.shape[0], a.shape[0]
    cnt = torch.zeros((q,), dtype=torch.float32, device=x.device)
    sm = torch.zeros((q,), dtype=torch.float32, device=x.device)
    if n == 0 or q == 0:
        return cnt, sm
    tile = int(tile)
    if not 1 <= tile or tile * 4 > SMEM_MAX:
        raise ValueError(f"tile={tile} must be in [1, {SMEM_MAX // 4}]")
    qk = min(check_tile(q_tile, "q_tile"), -(-q // 32) * 32)
    n_chunks = -(-n // tile)
    if n_chunks > GRID_Y_MAX:
        raise ValueError(f"n={n} needs {n_chunks} chunks of {tile}; raise the tile")
    partials = torch.empty((n_chunks, 2, q), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), n, ptr(h.reshape(1)), ptr(a), ptr(b), q, tile, qk,
                    ptr(partials), ptr(cnt), ptr(sm), stream(x.device))
    raise_on(err, "aqp_batch_sums")
    launches.inc()
    return cnt, sm
