"""Launcher of the triangular pairwise kernel (`csrc/pairwise_reduce.cu`):
sum_{i<j} K^(r)((x_i - x_j)/g) for PLUGIN's Psi6 and Psi4.
Counterpart: `repro/kernels/pairwise_reduce.py` (`pairwise_scaled_ksum`).

The kernel walks the upper-triangle tiles of side K (eqs. 49/50), each
block with K / ROWS threads that own ROWS rows apiece; `tile_for` picks K,
and `block_pairs` mirrors which pairs a block sums.  `blocks=(begin,
count)` launches a contiguous range of the tiles only (one rank's share of a
distributed sum, `triangle.share`); None is the whole triangle.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from ._launch import (LaunchCounter, check_tensor, check_tile, ptr,
                      raise_on, stream)
from .triangle import block_range, bx_to_ql, n_tri_tiles

TILE = 512          # side K of a triangle tile: 128 threads x ROWS rows each
ROWS = 4            # rows per thread (kRows in the source)

KINDS = {"k4": 0, "k6": 1, "gauss": 2}


launches = LaunchCounter("pairwise_scaled_ksum")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("pairwise_reduce").pairwise_scaled_ksum_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_for(n: int, tile: int) -> int:
    """The tile side K a launch uses: `tile` (a multiple of 32 in
    [32, 1024]), shrunk to the next power of two >= n for small n, then
    rounded up to a multiple of 128 (one warp of ROWS rows per thread)."""
    k = min(check_tile(tile, "tile"), max(1, 1 << max(n - 1, 0).bit_length()))
    return -(-k // (32 * ROWS)) * 32 * ROWS


def block_pairs(b: int, n: int, k: int, begin: int = 0):
    """The pairs (i, j) that block b of a launch from tile `begin` adds
    (tile bx = begin + b), as (i, j) int64 tensors (each unordered pair
    once, not always with i < j): a tile off the diagonal adds every row
    against its columns below n; the diagonal tile of side m = min(k, n -
    qk) adds row a against column (a + o) mod m for o = 1 .. (m - 1) // 2,
    and for even m rows a < m / 2 also o = m / 2."""
    q, l = (int(v) for v in bx_to_ql(begin + b))
    if q != l:
        rows = torch.arange(k)
        cols = torch.arange(min(k, n - l * k))
        ii, cc = torch.meshgrid(rows, cols, indexing="ij")
        return q * k + ii.reshape(-1), l * k + cc.reshape(-1)
    m = min(k, n - q * k)
    a = torch.arange(m)
    offs = torch.arange(1, (m - 1) // 2 + 1)
    ii = a[:, None].expand(m, offs.numel()).reshape(-1)
    jj = ((a[:, None] + offs[None]) % m).reshape(-1)
    if m % 2 == 0:
        ii = torch.cat([ii, a[:m // 2]])
        jj = torch.cat([jj, a[:m // 2] + m // 2])
    return q * k + ii, q * k + jj


def pairwise_scaled_ksum(x: torch.Tensor, g: torch.Tensor, kind: str,
                         tile: int, blocks=None) -> torch.Tensor:
    """0-d float32 sum on x's device.  x: (n,) float32 CUDA, g: one-element
    float32 CUDA tensor (read on the device, never synced to the host);
    `tile` as `tile_for` takes it; `blocks` the (begin, count) range of
    triangle tiles, None for all.  n < 2 or count 0 gives 0 and launches
    nothing."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {sorted(KINDS)}")
    check_tensor(x, "x", torch.float32, (None,))
    check_tensor(g.reshape(1), "g", torch.float32, (1,), x.device)
    n = x.shape[0]
    k = tile_for(n, tile)
    if n < 2:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    n_tri = n_tri_tiles(-(-n // k))
    if n_tri >= 2 ** 31:
        raise ValueError(f"n={n} with tile {k} needs {n_tri} blocks; raise the tile")
    begin, count = block_range(blocks, n_tri)
    if count == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    buf = torch.empty((count + 1,), dtype=torch.float32, device=x.device)
    out = buf[count]
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), n, ptr(g), KINDS[kind], k, begin, count, ptr(buf),
                    ptr(out), stream(x.device))
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
