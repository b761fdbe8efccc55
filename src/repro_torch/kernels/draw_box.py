"""Launcher of the kernel-centred quasi-MC box kernel (`csrc/draw_box.cu`):
per box, the count of the sample rows' kernel draws y = x_i + L z inside
it and the sum of their target coordinate, over the whole sample and, in
the same launch, over each of S equal row chunks (the batch-means
replicates of the CI).
Counterpart: none; the JAX package integrates full-H boxes only over the
boxes' hull (`repro/kernels/qmc_reduce.py`).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from ._launch import SMEM_MAX, LaunchCounter, check_tensor, ptr, raise_on, stream

TILE_DRAWS = 1024   # draws a tile block forms in shared memory
MAX_D = 8           # the kernel is instantiated for d = 1..8
MAX_DRAWS = 1024    # draws a row: a tile holds at least one row's
MAX_SPLITS = 16     # row chunks per launch (kMaxSplits in the source)


launches = LaunchCounter("draw_box_reduce")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("draw_box").draw_box_reduce_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_rows(draws: int, tile: int) -> int:
    """Sample rows a tile block takes: as many whole rows' draws as `tile`
    draws hold, at least one row."""
    return max(1, int(tile) // int(draws))


def n_tiles(m: int, splits: int, rows: int) -> int:
    """Tiles of the launch's grid: `splits` chunks of m // splits rows, each
    cut into tiles of `rows` rows, then the tail likewise."""
    split = m // splits if splits else 0
    return splits * -(-split // rows) + -(-(m - splits * split) // rows)


def draw_box_reduce(x: torch.Tensor, z: torch.Tensor, l_chol: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor, tgt: torch.Tensor,
                    splits: int, tile: int):
    """(cnt_sums, sum_sums), each (splits + 1, q) float64: the draws
    y_ij = x_i + L z_{i K + j} (K = z.shape[0] // m) inside each closed box
    and the sum of their target coordinate, row 0 over the whole sample,
    row 1 + j over rows [j c, (j + 1) c) of x with c = m // splits (rows
    past splits * c enter row 0 only).  x: (m, d), z: (m K, d), l_chol:
    (d, d) lower triangular, lo/hi: (q, d) float32, tgt: (q,) int32, all on
    one CUDA device with 1 <= d <= 8 and 1 <= K <= 1024; 0 <= splits <= 16,
    and splits <= m when m > 0; `tile` draws a block (whole rows, at least
    one).  m or q == 0 gives zeros and launches nothing."""
    check_tensor(x, "x", torch.float32, (None, None))
    m, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"draw_box_reduce takes 1 <= d <= {MAX_D}, got d={d}")
    check_tensor(z, "z", torch.float32, (None, d), x.device)
    check_tensor(l_chol, "l_chol", torch.float32, (d, d), x.device)
    check_tensor(lo, "lo", torch.float32, (None, d), x.device)
    q = lo.shape[0]
    check_tensor(hi, "hi", torch.float32, (q, d), x.device)
    check_tensor(tgt, "tgt", torch.int32, (q,), x.device)
    splits = int(splits)
    if not 0 <= splits <= MAX_SPLITS or (m and splits > m):
        raise ValueError(f"splits={splits} must lie in [0, min({MAX_SPLITS}, m={m})]")
    if m == 0 or q == 0:
        zeros = torch.zeros((splits + 1, q), dtype=torch.float64, device=x.device)
        return zeros, zeros.clone()
    draws = z.shape[0] // m
    if not 1 <= draws <= MAX_DRAWS or z.shape[0] != m * draws:
        raise ValueError(f"z has {z.shape[0]} rows: m={m} times 1..{MAX_DRAWS} draws a row")
    rows = tile_rows(draws, tile)
    if rows * draws * -(-d // 4) * 16 > SMEM_MAX:
        raise ValueError(f"tile={tile} holds {rows * draws} draws of d={d}: over "
                         f"{SMEM_MAX} bytes of shared memory")
    chunks = n_tiles(m, splits, rows)
    partials = torch.empty((chunks, 2, q), dtype=torch.float32, device=x.device)
    out = torch.empty((2, splits + 1, q), dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), m, d, ptr(z), draws, ptr(l_chol), ptr(lo), ptr(hi), ptr(tgt),
                    q, splits, rows, ptr(partials), ptr(out), stream(x.device))
    raise_on(err, "draw_box_reduce")
    launches.inc()
    return out[0], out[1]
