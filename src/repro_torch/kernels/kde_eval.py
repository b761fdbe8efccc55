"""Launcher of the direct KDE kernel (`csrc/kde_eval.cu`): the scalar-h
Gaussian density f^(p) = norm / n * sum_i exp(-||p - x_i||^2 / (2 h^2))
(paper eq. 3), the kernel forming the sums and this launcher applying
norm / n = (2 pi)^(-d/2) h^(-d) / n after it, as the reference does.
Counterpart: `repro/kernels/kde_eval.py` (`kde_eval`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._launch import (GRID_Y_MAX, SMEM_MAX, LaunchCounter, check_tensor,
                      check_tile, device_scalars, ptr, raise_on, stream)

TILE = 1024         # sample rows per chunk (shared memory; fewer at large d)
P_TILE = 256        # evaluation points per block, one per thread
MAX_D = 16          # the kernel is instantiated for d = 1..16


launches = LaunchCounter("kde_eval")


def _fn():
    fn = _build.load("kde_eval").kde_eval_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kde_eval(points: torch.Tensor, x: torch.Tensor, h, tile: int,
             p_tile: int) -> torch.Tensor:
    """(m,) float32 densities.  points: (m, d), x: (n, d) float32 on one
    CUDA device with 1 <= d <= 16 and n >= 1; h: a number or one-element
    tensor (read on the device, never synced to the host).  m == 0 gives an
    empty result and launches nothing.  `tile` rows per chunk is capped so
    a chunk fits the block's shared memory."""
    check_tensor(x, "x", torch.float32, (None, None))
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"kde_eval takes 1 <= d <= {MAX_D}, got d={d}")
    if n == 0:
        raise ValueError("kde_eval needs a non-empty sample")
    check_tensor(points, "points", torch.float32, (None, d), x.device)
    m = points.shape[0]
    h_dev = device_scalars((h,), x.device)
    sums = torch.zeros((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return sums
    pk = check_tile(p_tile, "p_tile")
    k = min(int(tile), SMEM_MAX // (4 * d))
    if k < 1:
        raise ValueError(f"tile={tile} must be positive")
    n_chunks = -(-n // k)
    if n_chunks > GRID_Y_MAX:
        raise ValueError(f"n={n} needs {n_chunks} chunks of {k}; raise the tile")
    partials = torch.empty((n_chunks, m), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(points), m, ptr(x), n, d, ptr(h_dev), pk, k,
                    ptr(partials), ptr(sums), stream(x.device))
    raise_on(err, "kde_eval")
    launches.inc()
    hv = h_dev[0]
    norm = (2.0 * math.pi) ** (-d / 2.0) * hv ** (-d)
    return (norm / n) * sums
