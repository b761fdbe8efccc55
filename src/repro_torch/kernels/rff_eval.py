"""Launcher of the random-Fourier-feature eval kernel (`csrc/rff_eval.cu`):
the un-normalised feature dots cos(P W^T + b) @ z of a fitted RFF synopsis,
and in the same launch the dots of its B feature blocks.
Counterpart: `repro/kernels/rff_eval.py` (`rff_density`; its feature
blocks are `repro/synopses/rff.py`'s `_block_densities`).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from ._launch import (GRID_Y_MAX, SMEM_MAX, LaunchCounter, check_tensor,
                      check_tile, ptr, raise_on, stream)

TILE = 256          # features per sub-chunk (shared memory)
THREADS = 256       # threads per block, kPoints (4) points each
MAX_D = 8           # the kernel is instantiated for d = 1..8


launches = LaunchCounter("rff_density")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("rff_eval").rff_density_blocks_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def record_floats(d: int) -> int:
    """Floats of one feature's record in shared memory: w (d), b, z,
    padded to a multiple of 4."""
    return -(-(d + 2) // 4) * 4


def n_sub_chunks(nf: int, n_blocks: int, tile: int) -> int:
    """Sub-chunks of one launch: each of the n_blocks chunks of
    nf // n_blocks features and the remainder chunk, split into tiles."""
    cb = nf // n_blocks
    return n_blocks * -(-cb // tile) + -(-(nf - n_blocks * cb) // tile)


def rff_density_blocks(points: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       z: torch.Tensor, n_blocks: int, tile: int, threads: int):
    """(blocks, estimate): the (n_blocks, m) raw dots of the feature blocks
    [k cb, (k + 1) cb), cb = D // n_blocks (the D mod n_blocks remainder
    features are in no block), and the (m,) raw dot over all D features,
    the fixed-order sum of the blocks and the remainder; one launch.
    points: (m, d), w: (D, d), b/z: (D,), all float32 on one CUDA device,
    1 <= d <= 8, 1 <= n_blocks <= D.  m == 0 or D == 0 gives zeros and
    launches nothing."""
    check_tensor(points, "points", torch.float32, (None, None))
    m, d = points.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"rff_density takes 1 <= d <= {MAX_D}, got d={d}")
    check_tensor(w, "w", torch.float32, (None, d), points.device)
    nf = w.shape[0]
    check_tensor(b, "b", torch.float32, (nf,), points.device)
    check_tensor(z, "z", torch.float32, (nf,), points.device)
    n_blocks = int(n_blocks)
    if not 1 <= n_blocks <= max(nf, 1):
        raise ValueError(f"n_blocks={n_blocks} must lie in [1, D={nf}]")
    threads = check_tile(threads, "threads")
    fk = int(tile)
    if not 1 <= fk or fk * record_floats(d) * 4 > SMEM_MAX:
        raise ValueError(f"tile={fk} must be in [1, {SMEM_MAX // (4 * record_floats(d))}] "
                         f"for d={d}")
    if m == 0 or nf == 0:
        out = torch.zeros((n_blocks + 1, m), dtype=torch.float32, device=points.device)
        return out[1:], out[0]
    n_sub = n_sub_chunks(nf, n_blocks, fk)
    if n_sub > GRID_Y_MAX:
        raise ValueError(f"D={nf} needs {n_sub} sub-chunks of {fk}; raise the tile")
    buf = torch.empty((n_sub + n_blocks + 1, m), dtype=torch.float32,
                      device=points.device)
    out = buf[n_sub:]
    with torch.cuda.device(points.device):
        err = _fn()(ptr(points), m, d, ptr(w), ptr(b), ptr(z), nf, n_blocks,
                    threads, fk, ptr(buf), ptr(out), stream(points.device))
    raise_on(err, "rff_density")
    launches.inc()
    return out[1:], out[0]


def rff_density(points: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                z: torch.Tensor, tile: int, threads: int) -> torch.Tensor:
    """(m,) float32 raw dots: `rff_density_blocks` with one block, one
    launch."""
    return rff_density_blocks(points, w, b, z, 1, tile, threads)[1]
