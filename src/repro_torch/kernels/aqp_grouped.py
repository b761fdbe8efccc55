"""Launcher of the factored GROUP BY kernel (`csrc/aqp_grouped.cu`): the
unscaled eq. 11 sums of one GROUP BY family, a shared box crossed with G
per-category windows on the group axis.
Counterpart: `repro/kernels/aqp_grouped.py` (`aqp_grouped_sums`).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import (GRID_Y_MAX, SMEM_MAX, LaunchCounter, check_tensor, ptr,
                      raise_on, stream)

TILE = 128          # sample rows per block (one shared-memory chunk)
G_TILE = 64         # categories per block (kGroupTile in the source)
MAX_D = 8           # the kernel is instantiated for d = 1..8


launches = LaunchCounter("aqp_grouped_sums")


def _fn():
    fn = _build.load("aqp_grouped").aqp_grouped_sums_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def aqp_grouped_sums(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, glo: torch.Tensor, ghi: torch.Tensor,
                     g_axis: int, tgt: int, tile: int):
    """(count_raw, sum_raw), each (G,) float32.  x: (n, d) float32 with
    1 <= d <= 8, h_diag/lo/hi: (d,) float32 (the group axis's entries of
    lo/hi are ignored), glo/ghi: (G,) float32, all on one CUDA device;
    0 <= g_axis, tgt < d.  n == 0 or G == 0 gives zeros and launches
    nothing."""
    check_tensor(x, "x", torch.float32, (None, None))
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"aqp_grouped_sums takes 1 <= d <= {MAX_D}, got d={d}")
    for name, t in (("h_diag", h_diag), ("lo", lo), ("hi", hi)):
        check_tensor(t, name, torch.float32, (d,), x.device)
    check_tensor(glo, "glo", torch.float32, (None,), x.device)
    G = glo.shape[0]
    check_tensor(ghi, "ghi", torch.float32, (G,), x.device)
    g_axis, tgt = int(g_axis), int(tgt)
    if not (0 <= g_axis < d and 0 <= tgt < d):
        raise ValueError(f"g_axis={g_axis} and tgt={tgt} must lie in [0, {d})")
    cnt = torch.zeros((G,), dtype=torch.float32, device=x.device)
    sm = torch.zeros((G,), dtype=torch.float32, device=x.device)
    if n == 0 or G == 0:
        return cnt, sm
    k = int(tile)
    if not 1 <= k or 3 * k * 4 > SMEM_MAX:
        raise ValueError(f"tile={k} must be in [1, {SMEM_MAX // 12}]")
    if -(-G // G_TILE) > GRID_Y_MAX:
        raise ValueError(f"G={G} needs more than {GRID_Y_MAX} category tiles")
    partials = torch.empty((-(-n // k), 2, G), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), n, d, ptr(h_diag), ptr(lo), ptr(hi), ptr(glo),
                    ptr(ghi), G, g_axis, tgt, k, ptr(partials), ptr(cnt),
                    ptr(sm), stream(x.device))
    raise_on(err, "aqp_grouped_sums")
    launches.inc()
    return cnt, sm
