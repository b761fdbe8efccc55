"""Launcher of the fused quasi-MC box kernel (`csrc/qmc_reduce.cu`): per box,
the raw double sums over Halton nodes inside it of the full-H Gaussian
kernel against the whole sample (eq. 6 integrated by quasi-MC), and in the
same launch against each of K equal row chunks of the sample (the
batch-means replicates of the full-H CI).
Counterpart: `repro/kernels/qmc_reduce.py` (`qmc_box_reduce`).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from ._launch import (GRID_Y_MAX, SMEM_MAX, LaunchCounter, check_tensor,
                      ptr, raise_on, scalar_arg, sm_count, stream)

TILE = 512          # sample rows per chunk (shared memory)
M_TILE = 512        # nodes per density block: 128 threads x 4 nodes each
ROWS = 4            # nodes per thread (kRows in the source)
MAX_D = 8           # the kernel is instantiated for d = 1..8
MAX_SPLITS = 16     # row chunks per launch (kMaxSplits in the source)
BOX_BLOCKS_PER_SM = 8   # stage-3 blocks of 256 threads the node slices aim at


launches = LaunchCounter("qmc_box_reduce")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("qmc_reduce").qmc_box_reduce_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def box_slices(q: int, m: int, sms: int) -> int:
    """Node slices per box of the indicator stage: enough (box, slice)
    blocks for BOX_BLOCKS_PER_SM on each of `sms` SMs, each slice at least
    1 024 nodes (4 per thread)."""
    return max(1, min(-(-m // 1024), -(-BOX_BLOCKS_PER_SM * sms // q)))


def n_chunks(n: int, splits: int, tile: int) -> int:
    """Row chunks of the launch's grid: `splits` chunks of n // splits rows,
    each cut into tiles of `tile` rows, then the tail likewise."""
    split = n // splits if splits else 0
    return splits * -(-split // tile) + -(-(n - splits * split) // tile)


def qmc_box_reduce_split(nodes: torch.Tensor, x: torch.Tensor,
                         h_inv: torch.Tensor, log_norm, lo: torch.Tensor,
                         hi: torch.Tensor, tgt: torch.Tensor, splits: int,
                         tile: int, m_tile: int):
    """(cnt_sums, sum_sums), each (splits + 1, q) float32: row 0 over the
    whole sample, row 1 + j over rows [j c, (j + 1) c) of x with
    c = n // splits (rows past splits * c enter row 0 only).  nodes: (m, d),
    x: (n, d), h_inv: (d, d) (contiguous: make cuSOLVER's column-major
    inverse so), lo/hi: (q, d) float32, tgt: (q,) int32, all on one CUDA
    device with 1 <= d <= 8; log_norm: a number or one-element tensor (read
    on the device); 0 <= splits <= 16, and splits <= n when n > 0.  n, m or
    q == 0 gives zeros and launches nothing."""
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
    splits = int(splits)
    if not 0 <= splits <= MAX_SPLITS or (n and splits > n):
        raise ValueError(f"splits={splits} must lie in [0, min({MAX_SPLITS}, n={n})]")
    if n == 0 or m == 0 or q == 0:
        z = torch.zeros((splits + 1, q), dtype=torch.float32, device=x.device)
        return z, z.clone()
    mk = int(m_tile)
    if mk % (32 * ROWS) or not 32 * ROWS <= mk <= 1024 * ROWS:
        raise ValueError(f"m_tile={mk} must be a multiple of {32 * ROWS} in "
                         f"[{32 * ROWS}, {1024 * ROWS}]")
    k = int(tile)
    if k < 4 or k % 4 or k * d * 4 > SMEM_MAX:
        raise ValueError(f"tile={k} must be a multiple of 4 in [4, "
                         f"{SMEM_MAX // (4 * d)}] for d={d}")
    chunks = n_chunks(n, splits, k)
    if chunks > GRID_Y_MAX:
        raise ValueError(f"n={n} needs {chunks} chunks of {k}; raise the tile")
    ln = scalar_arg(log_norm, "log_norm", x.device)
    slices = box_slices(q, m, sm_count(x.device.index or 0))
    n_out = splits + 1
    n_pad = -(-n_out // 4) * 4
    # one scratch buffer: the density partials, the nodes' densities (16-byte
    # aligned rows of n_pad floats) and the stage-3 partials
    sizes = (chunks * m, m * n_pad, slices * 2 * n_out * q)
    padded = [-(-v // 4) * 4 for v in sizes]
    work = torch.empty((sum(padded),), dtype=torch.float32, device=x.device)
    partials, f, box_partials = torch.split(work, padded)
    out = torch.empty((2, n_out, q), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(nodes), m, ptr(x), n, d, ptr(h_inv), ptr(ln), ptr(lo),
                    ptr(hi), ptr(tgt), q, splits, k, mk // ROWS, ptr(partials),
                    ptr(f), slices, ptr(box_partials), ptr(out), stream(x.device))
    raise_on(err, "qmc_box_reduce")
    launches.inc()
    return out[0], out[1]


def qmc_box_reduce(nodes: torch.Tensor, x: torch.Tensor, h_inv: torch.Tensor,
                   log_norm, lo: torch.Tensor, hi: torch.Tensor,
                   tgt: torch.Tensor, tile: int, m_tile: int):
    """(cnt_sums, sum_sums), each (q,) float32, over the whole sample: the
    launch of `qmc_box_reduce_split` with no row chunks."""
    cnt, sm = qmc_box_reduce_split(nodes, x, h_inv, log_norm, lo, hi, tgt, 0,
                                   tile=tile, m_tile=m_tile)
    return cnt[0], sm[0]
