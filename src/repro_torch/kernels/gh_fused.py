"""Launcher of the fused LSCV_H objective kernel (`csrc/gh_fused.cu`):
sum_{i<j} T_H(x_i - x_j) with T_H(s) = c_kk exp(-s/4) - 2 c_k exp(-s/2)
over s = (x_i - x_j)^T H^-1 (x_i - x_j) (§6.3, eqs. 32-35).
Counterpart: `repro/kernels/gh_fused.py` (`gh_fused_sum`).

The kernel walks the upper-triangle tiles of side K (eqs. 49/50), each
block with K / ROWS threads that own ROWS rows apiece; `tile_shape` picks K
and the grid, and `block_pairs` mirrors which pairs a block sums.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from ._launch import (LaunchCounter, check_tensor, check_tile, ptr, raise_on,
                      scalar_arg, stream)
from .triangle import bx_to_ql, n_tri_tiles

TILE = 512          # side K of a triangle tile: 128 threads x ROWS rows each
ROWS = 4            # rows per thread (kRows in the source)
MAX_D = 8           # the kernel is instantiated for d = 1..8


launches = LaunchCounter("gh_fused_sum")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("gh_fused").gh_fused_sum_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_shape(n: int, tile: int):
    """(K, threads, n_tri) of a launch over n rows: the tile side K is
    `tile` (a multiple of 32 in [32, 1024]) capped at the next power of two
    of n, then rounded up to a multiple of 128 (one warp of ROWS rows per
    thread); K / ROWS threads; n_tri blocks, one per upper-triangle tile."""
    k = min(check_tile(tile, "tile"), max(1, 1 << (n - 1).bit_length()))
    k = -(-k // (32 * ROWS)) * 32 * ROWS
    return k, k // ROWS, n_tri_tiles(-(-n // k))


def block_pairs(bx: int, n: int, k: int):
    """The pairs (i, j) that block bx adds, as (i, j) int64 tensors: thread
    t owns rows qK + rT + t (r < ROWS, T = K / ROWS threads), the block's
    columns are lK .. lK + K - 1; a tile off the diagonal whose columns all
    lie below n adds every (row, column), any other tile only i < j < n."""
    threads = k // ROWS
    q, l = (int(v) for v in bx_to_ql(bx))
    local = (torch.arange(ROWS)[:, None] * threads + torch.arange(threads)[None]).reshape(-1)
    cols = torch.arange(k)
    c_end = min(k, n - l * k)
    ii, cc = torch.meshgrid(local, cols, indexing="ij")
    if q == l or c_end < k:
        lim = ii if q == l else torch.full_like(ii, -1)
        keep = (cc > lim) & (cc < c_end)
        ii, cc = ii[keep], cc[keep]
    return q * k + ii.reshape(-1), l * k + cc.reshape(-1)


def gh_fused_sum(x: torch.Tensor, h_inv: torch.Tensor, c_k, c_kk,
                 tile: int) -> torch.Tensor:
    """0-d float32 sum on x's device.  x: (n, d) float32 CUDA with
    1 <= d <= 8, h_inv: (d, d) float32 on the same device; c_k, c_kk:
    numbers or one-element tensors (read on the device, a tensor never
    synced to the host, a number copied there first); `tile` as `tile_shape` takes it.  n < 2 gives 0 and
    launches nothing."""
    check_tensor(x, "x", torch.float32, (None, None))
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"gh_fused_sum takes 1 <= d <= {MAX_D}, got d={d}")
    check_tensor(h_inv, "h_inv", torch.float32, (d, d), x.device)
    k, threads, n_tri = tile_shape(n, tile)
    ck = scalar_arg(c_k, "c_k", x.device)
    ckk = scalar_arg(c_kk, "c_kk", x.device)
    if n < 2:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    if n_tri >= 2 ** 31:
        raise ValueError(f"n={n} with tile {k} needs {n_tri} blocks; raise the tile")
    out = torch.empty((), dtype=torch.float32, device=x.device)
    partials = torch.empty((n_tri,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), n, d, ptr(h_inv), ptr(ck), ptr(ckk), threads,
                    ptr(partials), ptr(out), stream(x.device))
    raise_on(err, "gh_fused_sum")
    launches.inc()
    return out
