"""Launcher of the random-Fourier-feature eval kernel (`csrc/rff_eval.cu`):
the un-normalised feature dots cos(P W^T + b) @ z of a fitted RFF synopsis.
Counterpart: `repro/kernels/rff_eval.py` (`rff_density`).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import (GRID_Y_MAX, SMEM_MAX, LaunchCounter, check_tensor,
                      check_tile, ptr, raise_on, stream)

TILE = 256          # features per chunk (shared memory)
P_TILE = 256        # points per block, one per thread
MAX_D = 8           # the kernel is instantiated for d = 1..8


launches = LaunchCounter("rff_density")


def _fn():
    fn = _build.load("rff_eval").rff_density_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rff_density(points: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                z: torch.Tensor, tile: int, p_tile: int) -> torch.Tensor:
    """(m,) float32 raw dots.  points: (m, d), w: (D, d), b/z: (D,), all
    float32 on one CUDA device, 1 <= d <= 8.  m == 0 or D == 0 gives zeros
    and launches nothing."""
    check_tensor(points, "points", torch.float32, (None, None))
    m, d = points.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"rff_density takes 1 <= d <= {MAX_D}, got d={d}")
    check_tensor(w, "w", torch.float32, (None, d), points.device)
    nf = w.shape[0]
    check_tensor(b, "b", torch.float32, (nf,), points.device)
    check_tensor(z, "z", torch.float32, (nf,), points.device)
    out = torch.zeros((m,), dtype=torch.float32, device=points.device)
    if m == 0 or nf == 0:
        return out
    pk = check_tile(p_tile, "p_tile")
    fk = int(tile)
    if not 1 <= fk or fk * (d + 2) * 4 > SMEM_MAX:
        raise ValueError(f"tile={fk} must be in [1, {SMEM_MAX // (4 * (d + 2))}] "
                         f"for d={d}")
    n_chunks = -(-nf // fk)
    if n_chunks > GRID_Y_MAX:
        raise ValueError(f"D={nf} needs {n_chunks} chunks of {fk}; raise the tile")
    partials = torch.empty((n_chunks, m), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        err = _fn()(ptr(points), m, d, ptr(w), ptr(b), ptr(z), nf, pk, fk,
                    ptr(partials), ptr(out), stream(points.device))
    raise_on(err, "rff_density")
    launches.inc()
    return out
