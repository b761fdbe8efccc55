"""Launcher of the fused quasi-MC box kernel (`csrc/qmc_reduce.cu`): per box,
the raw double sums over Halton nodes inside it of the full-H Gaussian
kernel against the whole sample (eq. 6 integrated by quasi-MC).
Counterpart: `repro/kernels/qmc_reduce.py` (`qmc_box_reduce`).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._launch import (GRID_Y_MAX, SMEM_MAX, LaunchCounter, check_tensor,
                      check_tile, device_scalars, ptr, raise_on, stream)

TILE = 1024         # sample rows per chunk (shared memory)
M_TILE = 256        # nodes per block, one per thread
MAX_D = 8           # the kernel is instantiated for d = 1..8


launches = LaunchCounter("qmc_box_reduce")


def _fn():
    fn = _build.load("qmc_reduce").qmc_box_reduce_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def qmc_box_reduce(nodes: torch.Tensor, x: torch.Tensor, h_inv: torch.Tensor,
                   log_norm, lo: torch.Tensor, hi: torch.Tensor,
                   tgt: torch.Tensor, tile: int, m_tile: int):
    """(cnt_sums, sum_sums), each (q,) float32.  nodes: (m, d), x: (n, d),
    h_inv: (d, d) (contiguous: make cuSOLVER's column-major inverse so),
    lo/hi: (q, d) float32, tgt: (q,) int32, all on one CUDA device with
    1 <= d <= 8; log_norm: a number or one-element tensor (read on the
    device).  n, m or q == 0 gives zeros and launches nothing."""
    check_tensor(x, "x", torch.float32, (None, None))
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"qmc_box_reduce takes 1 <= d <= {MAX_D}, got d={d}")
    check_tensor(nodes, "nodes", torch.float32, (None, d), x.device)
    check_tensor(h_inv, "h_inv", torch.float32, (d, d), x.device)
    check_tensor(lo, "lo", torch.float32, (None, d), x.device)
    m, q = nodes.shape[0], lo.shape[0]
    check_tensor(hi, "hi", torch.float32, (q, d), x.device)
    check_tensor(tgt, "tgt", torch.int32, (q,), x.device)
    cnt = torch.zeros((q,), dtype=torch.float32, device=x.device)
    sm = torch.zeros((q,), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0 or q == 0:
        return cnt, sm
    mk = check_tile(m_tile, "m_tile")
    k = int(tile)
    if not 1 <= k or k * d * 4 > SMEM_MAX:
        raise ValueError(f"tile={k} must be in [1, {SMEM_MAX // (4 * d)}] for d={d}")
    n_chunks = -(-n // k)
    if n_chunks > GRID_Y_MAX:
        raise ValueError(f"n={n} needs {n_chunks} chunks of {k}; raise the tile")
    ln = device_scalars((log_norm,), x.device)
    partials = torch.empty((n_chunks, m), dtype=torch.float32, device=x.device)
    f = torch.empty((m,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(nodes), m, ptr(x), n, d, ptr(h_inv), ptr(ln), ptr(lo),
                    ptr(hi), ptr(tgt), q, mk, k, ptr(partials), ptr(f),
                    ptr(cnt), ptr(sm), stream(x.device))
    raise_on(err, "qmc_box_reduce")
    launches.inc()
    return cnt, sm
