"""Launcher of the quadratic-form precompute kernel (`csrc/sv_precompute.cu`):
the dense (n, n) matrix S_ij = (x_i - x_j)^T M (x_i - x_j) on the strict
upper triangle, 0 elsewhere (LSCV_h's §4.5 precompute, eq. 39).
Counterpart: `repro/kernels/sv_precompute.py` (`sv_matrix`).

`cols=(c0, c1)` forms a column block instead, S[:c1, c0:c1], c1 x (c1 -
c0) floats: the pairs of a run of the lscv_grid kernel's column-major
triangle tiles, so a distributed LSCV_h never holds S whole
(`core/distributed.py`).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import (GRID_Y_MAX, LaunchCounter, check_tensor, check_tile, ptr,
                      raise_on, stream)

TILE = 256          # columns of S per block, one per thread
ROWS = 32           # rows of S per block (kSvRows in the source)
MAX_D = 16          # the kernel is instantiated for d = 1..16
ALGORITHMS = ("paper", "mxu")


launches = LaunchCounter("sv_matrix")


def _fn():
    fn = _build.load("sv_precompute").sv_matrix_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def slab_cols(cols, n: int) -> tuple:
    """`cols` = (c0, c1) checked against n: 0 <= c0 <= c1 <= n."""
    c0, c1 = (int(v) for v in cols)
    if not 0 <= c0 <= c1 <= n:
        raise ValueError(f"columns {tuple(cols)} outside the n={n} columns of S")
    return c0, c1


def sv_matrix(x: torch.Tensor, m: torch.Tensor, tile: int,
              algorithm: str = "mxu", cols=None) -> torch.Tensor:
    """(n, n) float32 on x's device.  x: (n, d) float32 CUDA with
    1 <= d <= 16, m: (d, d) float32 on the same device.  Both `algorithm`s
    of the reference ("paper": eq. 60's loop, "mxu": the expanded form)
    name the same function; the kernel forms the difference x_i - x_j for
    either, so they give the same bits.  `cols=(c0, c1)`: the column block
    S[:c1, c0:c1], (c1, c1 - c0), each entry the whole S's bits."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; expected one of "
                         f"{ALGORITHMS}")
    check_tensor(x, "x", torch.float32, (None, None))
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"sv_matrix takes 1 <= d <= {MAX_D}, got d={d}")
    check_tensor(m, "m", torch.float32, (d, d), x.device)
    c0, c1 = (0, n) if cols is None else slab_cols(cols, n)
    out = torch.empty((c1, c1 - c0), dtype=torch.float32, device=x.device)
    if c1 == c0:
        return out
    k = check_tile(tile, "tile")
    if -(-c1 // ROWS) > GRID_Y_MAX:
        raise ValueError(f"{c1} rows need more than {GRID_Y_MAX} row blocks of {ROWS}")
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), n, d, ptr(m), k, c0, c1 - c0, ptr(out), stream(x.device))
    raise_on(err, "sv_matrix")
    launches.inc()
    return out
