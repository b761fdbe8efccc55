"""Launcher of the fused LSCV_H objective kernel (`csrc/gh_fused.cu`):
sum_{i<j} T_H(x_i - x_j) with T_H(s) = c_kk exp(-s/4) - 2 c_k exp(-s/2)
over s = (x_i - x_j)^T H^-1 (x_i - x_j) (§6.3, eqs. 32-35).
Counterpart: `repro/kernels/gh_fused.py` (`gh_fused_sum`).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import (LaunchCounter, check_tensor, check_tile, device_scalars,
                      ptr, raise_on, stream)
from .triangle import n_tri_tiles

TILE = 256          # rows (= threads) and columns of one triangle tile
MAX_D = 8           # the kernel is instantiated for d = 1..8


launches = LaunchCounter("gh_fused_sum")


def _fn():
    fn = _build.load("gh_fused").gh_fused_sum_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gh_fused_sum(x: torch.Tensor, h_inv: torch.Tensor, c_k, c_kk,
                 tile: int) -> torch.Tensor:
    """0-d float32 sum on x's device.  x: (n, d) float32 CUDA with
    1 <= d <= 8, h_inv: (d, d) float32 on the same device; c_k, c_kk:
    numbers or one-element tensors (read on the device, never synced to
    the host).  n < 2 gives 0 and launches nothing."""
    check_tensor(x, "x", torch.float32, (None, None))
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"gh_fused_sum takes 1 <= d <= {MAX_D}, got d={d}")
    check_tensor(h_inv, "h_inv", torch.float32, (d, d), x.device)
    out = torch.zeros((), dtype=torch.float32, device=x.device)
    if n < 2:
        return out
    k = min(check_tile(tile, "tile"), max(32, 1 << (n - 1).bit_length()))
    n_tri = n_tri_tiles(-(-n // k))
    if n_tri >= 2 ** 31:
        raise ValueError(f"n={n} with tile {k} needs {n_tri} blocks; raise the tile")
    consts = device_scalars((c_k, c_kk), x.device)
    partials = torch.empty((n_tri,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), n, d, ptr(h_inv), ptr(consts), k, ptr(partials),
                    ptr(out), stream(x.device))
    raise_on(err, "gh_fused_sum")
    launches.inc()
    return out
