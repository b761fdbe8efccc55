"""Launcher of the factored GROUP BY kernel (`csrc/aqp_grouped.cu`): for F
GROUP BY families of one synopsis (each a shared box crossed with per-
category windows on the group axis), the unscaled eq. 11 sums of every
(family, category) and the three second-moment sums of its CI, in one
launch.
Counterpart: `repro/kernels/aqp_grouped.py` (`aqp_grouped_sums`).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Sequence

import torch

from . import _build
from ._launch import GRID_Y_MAX, LaunchCounter, check_tensor, fixed_range, ptr, raise_on, stream

TILE = 1024         # most sample rows per block (walked in SUB-row chunks)
SUB = 32            # rows per shared-memory sub-chunk (kSub in the source)
FAM_TILE = 32       # families per tile (kFamTile in the source)
G_TILE = 64         # categories per block (kCatTile in the source)
MAX_D = 8           # the kernel is instantiated for d = 1..8
RANGES = 128        # row ranges n is cut into by default (256 rows each at n = 32 768)


launches = LaunchCounter("aqp_grouped_sums")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("aqp_grouped").aqp_grouped_moments_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def family_tiles(win: Sequence[int], g_axis: Sequence[int], tgt: Sequence[int]):
    """(order, tiles): the families sorted by (window table, group axis,
    target is the group axis), stably, and cut into tiles of at most
    FAM_TILE families that agree on all three; each tile is (window table,
    group axis, 1 if the target is the group axis, first index into order,
    family count)."""
    keys = [(int(w), int(g), int(int(t) == int(g))) for w, g, t in zip(win, g_axis, tgt)]
    order = sorted(range(len(keys)), key=keys.__getitem__)
    tiles = []
    i = 0
    while i < len(order):
        key = keys[order[i]]
        j = i + 1
        while j < len(order) and j - i < FAM_TILE and keys[order[j]] == key:
            j += 1
        tiles.append((*key, i, j - i))
        i = j
    return order, tiles


@lru_cache(maxsize=64)
def _family_table(win: tuple, g_axis: tuple, tgt: tuple, n_tables: int, d: int):
    """(pinned int32 table, tile count) of one family layout: the tiles,
    then the order, then the targets, as the kernel reads them.  Cached: a
    warm query's families repeat their layout, and the table is never
    written after it is made."""
    if not len(win) == len(g_axis) == len(tgt):
        raise ValueError("win, g_axis and tgt need one entry per family")
    if not all(0 <= w < n_tables for w in win):
        raise ValueError(f"window table indices must lie in [0, {n_tables})")
    if not all(0 <= g < d and 0 <= t < d for g, t in zip(g_axis, tgt)):
        raise ValueError(f"g_axis and tgt entries must lie in [0, {d})")
    order, tiles = family_tiles(win, g_axis, tgt)
    if len(tiles) > GRID_Y_MAX:
        raise ValueError(f"{len(tiles)} family tiles exceed the grid")
    flat = [v for t in tiles for v in t] + order + list(tgt)
    return torch.tensor(flat, dtype=torch.int32).pin_memory(), len(tiles)


def aqp_grouped_moments(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor, wlo: torch.Tensor, whi: torch.Tensor,
                        win: Sequence[int], g_axis: Sequence[int],
                        tgt: Sequence[int], tile: int, ranges: int) -> torch.Tensor:
    """(F, 5, Gmax) float32: for family f and category g, the sums over the
    sample rows of c = shared_cnt * gPhi and s (the SUM term) as (sum c,
    sum s, sum c^2, sum s^2, sum c s).  x: (n, d) float32 with 1 <= d <= 8,
    h_diag: (d,), lo/hi: (F, d) (each family's shared box; its group axis's
    entries ignored), wlo/whi: (W, Gmax) window tables (padded rows give
    values nobody reads), all on one CUDA device; win, g_axis, tgt: F host
    ints (family f's window table, group axis and target axis, each in
    range); tile: the most rows per block (at least SUB); ranges: how many
    row ranges n is cut into at most (`fixed_range`).  The row ranges come
    from n, `tile` and `ranges` alone, so a family's sums are the same bits
    whatever other families share the launch.  n, F or Gmax == 0
    gives zeros and launches nothing."""
    check_tensor(x, "x", torch.float32, (None, None))
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"aqp_grouped_sums takes 1 <= d <= {MAX_D}, got d={d}")
    check_tensor(h_diag, "h_diag", torch.float32, (d,), x.device)
    check_tensor(lo, "lo", torch.float32, (None, d), x.device)
    F = lo.shape[0]
    check_tensor(hi, "hi", torch.float32, (F, d), x.device)
    check_tensor(wlo, "wlo", torch.float32, (None, None), x.device)
    W, Gmax = wlo.shape
    check_tensor(whi, "whi", torch.float32, (W, Gmax), x.device)
    host, n_tiles = _family_table(tuple(map(int, win)), tuple(map(int, g_axis)),
                                  tuple(map(int, tgt)), W, d)
    if len(win) != F:
        raise ValueError(f"win, g_axis and tgt need one entry per family ({F})")
    if n == 0 or F == 0 or Gmax == 0:
        return torch.zeros((F, 5, Gmax), dtype=torch.float32, device=x.device)
    if -(-Gmax // G_TILE) > GRID_Y_MAX:
        raise ValueError(f"G={Gmax} exceeds the grid")
    k = int(tile)
    if k < SUB:
        raise ValueError(f"tile={k} must be at least {SUB}")
    ranges = int(ranges)
    if ranges < 1:
        raise ValueError(f"ranges={ranges} must be positive")
    rows = fixed_range(n, ranges, SUB, k)
    # pinned, so the copy does not wait for the card's earlier work
    table = host.to(x.device, non_blocking=True)
    n_tab = 5 * n_tiles
    partials = torch.empty((-(-n // rows), F, 5, Gmax), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((F, 5, Gmax), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(ptr(x), n, d, ptr(h_diag), ptr(lo), ptr(hi), ptr(wlo),
                    ptr(whi), Gmax, ptr(table), n_tiles, ptr(table[n_tab:]),
                    ptr(table[n_tab + F:]), F, rows, ptr(partials), ptr(out),
                    stream(x.device))
    raise_on(err, "aqp_grouped_sums")
    launches.inc()
    return out


def aqp_grouped_sums(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, glo: torch.Tensor, ghi: torch.Tensor,
                     g_axis: int, tgt: int, tile: int, ranges: int):
    """(count_raw, sum_raw), each (G,) float32, of one family: the launch of
    `aqp_grouped_moments` with F = 1.  x: (n, d) float32 with 1 <= d <= 8,
    h_diag/lo/hi: (d,) float32 (the group axis's entries of lo/hi are
    ignored), glo/ghi: (G,) float32, all on one CUDA device;
    0 <= g_axis, tgt < d."""
    check_tensor(lo, "lo", torch.float32, (None,))
    check_tensor(glo, "glo", torch.float32, (None,))
    five = aqp_grouped_moments(x, h_diag, lo[None], hi[None], glo[None],
                               ghi[None], [0], [g_axis], [tgt], tile=tile,
                               ranges=ranges)
    return five[0, 0], five[0, 1]
