"""Launcher of the triangular pairwise kernel (`csrc/pairwise_reduce.cu`):
sum_{i<j} K^(r)((x_i - x_j)/g) for PLUGIN's Psi6 and Psi4.
Counterpart: `repro/kernels/pairwise_reduce.py` (`pairwise_scaled_ksum`).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import (LaunchCounter, check_tensor, check_tile, ptr,
                      raise_on, stream)
from .triangle import n_tri_tiles

TILE = 256          # rows (= threads) and columns of one triangle tile

KINDS = {"k4": 0, "k6": 1, "gauss": 2}


launches = LaunchCounter("pairwise_scaled_ksum")


def _fn():
    fn = _build.load("pairwise_reduce").pairwise_scaled_ksum_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_for(n: int, tile: int) -> int:
    """The tile a launch uses: `tile`, shrunk to the next power of two >= n
    (at least one warp) for small n."""
    return min(check_tile(tile, "tile"), max(32, 1 << max(n - 1, 0).bit_length()))


def pairwise_scaled_ksum(x: torch.Tensor, g: torch.Tensor, kind: str,
                         tile: int) -> torch.Tensor:
    """0-d float32 sum on x's device.  x: (n,) float32 CUDA, g: one-element
    float32 CUDA tensor (read on the device, never synced to the host)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {sorted(KINDS)}")
    check_tensor(x, "x", torch.float32, (None,))
    check_tensor(g.reshape(1), "g", torch.float32, (1,), x.device)
    n = x.shape[0]
    out = torch.zeros((), dtype=torch.float32, device=x.device)
    if n < 2:
        return out
    k = tile_for(n, tile)
    n_tri = n_tri_tiles(-(-n // k))
    if n_tri >= 2 ** 31:
        raise ValueError(f"n={n} with tile {k} needs {n_tri} blocks; raise the tile")
    partials = torch.empty((n_tri,), dtype=torch.float32, device=x.device)
    g1 = g.reshape(1)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), n, ptr(g1), KINDS[kind], k, ptr(partials), ptr(out),
                    stream(x.device))
    raise_on(err, "pairwise_scaled_ksum")
    launches.inc()
    return out


def triangle_map(n_tri: int, device: torch.device):
    """(q, l) int32 tensors from the kernel's own device-side eqs. 49/50
    mapping of every block index < n_tri — for checks on the card."""
    fn = _build.load("pairwise_reduce").triangle_map_launch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    q = torch.empty((n_tri,), dtype=torch.int32, device=device)
    l = torch.empty((n_tri,), dtype=torch.int32, device=device)
    if n_tri:
        with torch.cuda.device(device):
            raise_on(fn(n_tri, ptr(q), ptr(l), stream(device)), "triangle_map")
    return q, l
