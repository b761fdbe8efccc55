"""Launcher of the fused LSCV_H objective kernel (`csrc/gh_fused.cu`):
sum_{i<j} T_H(x_i - x_j) with T_H(s) = c_kk exp(-s/4) - 2 c_k exp(-s/2)
over s = (x_i - x_j)^T H^-1 (x_i - x_j) (§6.3, eqs. 32-35).
Counterpart: `repro/kernels/gh_fused.py` (`gh_fused_sum`).

The kernel walks the upper-triangle tiles of side K (eqs. 49/50), each
block with K / ROWS threads that own ROWS rows apiece; `tile_shape` picks K
and the grid, and `block_pairs` mirrors which pairs a block sums.
`gh_fused_sums` queues one launch per bandwidth of a batch (a Nelder-Mead
step's candidates), each row of its parameters packed as `ref.gh_params`
lays them out; `gh_fused_sum` is the batch of one.  Both launch through a
`Plan`, which resolves what every launch over the same x and rows reuses:
a fit builds one and launches through it at each round trip.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from ._launch import LaunchCounter, check_tensor, check_tile, raise_on, scalar_arg, stream
from .ref import gh_params
from .triangle import bx_to_ql, n_tri_tiles

TILE = 512          # side K of a triangle tile: 128 threads x ROWS rows each
ROWS = 4            # rows per thread (kRows in the source)
MAX_D = 8           # the kernel is instantiated for d = 1..8


launches = LaunchCounter("gh_fused_sum")


@lru_cache(maxsize=None)
def _fn():
    fn = _build.load("gh_fused").gh_fused_sum_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_shape(n: int, tile: int):
    """(K, threads, n_tri) of a launch over n rows: the tile side K is
    `tile` (a multiple of 32 in [32, 1024]) capped at the next power of two
    of n, then rounded up to a multiple of 128 (one warp of ROWS rows per
    thread); K / ROWS threads; n_tri blocks, one per upper-triangle tile."""
    k = min(check_tile(tile, "tile"), max(1, 1 << (n - 1).bit_length()))
    k = -(-k // (32 * ROWS)) * 32 * ROWS
    return k, k // ROWS, n_tri_tiles(-(-n // k))


def block_pairs(bx: int, n: int, k: int):
    """The pairs (i, j) that block bx adds, as (i, j) int64 tensors: thread
    t owns rows qK + rT + t (r < ROWS, T = K / ROWS threads), the block's
    columns are lK .. lK + K - 1; a tile off the diagonal whose columns all
    lie below n adds every (row, column), any other tile only i < j < n."""
    threads = k // ROWS
    q, l = (int(v) for v in bx_to_ql(bx))
    local = (torch.arange(ROWS)[:, None] * threads + torch.arange(threads)[None]).reshape(-1)
    cols = torch.arange(k)
    c_end = min(k, n - l * k)
    ii, cc = torch.meshgrid(local, cols, indexing="ij")
    if q == l or c_end < k:
        lim = ii if q == l else torch.full_like(ii, -1)
        keep = (cc > lim) & (cc < c_end)
        ii, cc = ii[keep], cc[keep]
    return q * k + ii.reshape(-1), l * k + cc.reshape(-1)


def _check_x(x: torch.Tensor, tile: int):
    """(n, d, threads, n_tri) of a launch over x, after its checks."""
    check_tensor(x, "x", torch.float32, (None, None))
    n, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"gh_fused_sum takes 1 <= d <= {MAX_D}, got d={d}")
    k, threads, n_tri = tile_shape(n, tile)
    if n >= 2 and n_tri >= 2 ** 31:
        raise ValueError(f"n={n} with tile {k} needs {n_tri} blocks; raise the tile")
    return n, d, threads, n_tri


def gh_fused_sum(x: torch.Tensor, h_inv: torch.Tensor, c_k, c_kk,
                 tile: int) -> torch.Tensor:
    """0-d float32 sum on x's device: `gh_fused_sums` of one bandwidth.
    x: (n, d) float32 CUDA with 1 <= d <= 8, h_inv: (d, d) float32 on the
    same device; c_k, c_kk: numbers or one-element tensors (a tensor never
    synced to the host, a number copied there first); `tile` as
    `tile_shape` takes it."""
    _, d, _, _ = _check_x(x, tile)
    check_tensor(h_inv, "h_inv", torch.float32, (d, d), x.device)
    ck = scalar_arg(c_k, "c_k", x.device)
    ckk = scalar_arg(c_kk, "c_kk", x.device)
    return gh_fused_sums(x, gh_params(h_inv[None], ck[None], ckk[None]), tile)[0]


class Plan:
    """What every gh_fused_sum launch over x for the rows of `params` (R, d
    d + 2; float32 on x's device, as `ref.gh_params` packs them) reuses,
    resolved once: the tile's threads and blocks, the output slots `out`
    (R,), one partials buffer, the stream and each row's argument pointers,
    by address arithmetic into `params` and `out`.  A fit builds one over
    its own `params` and rewrites their rows each round trip; a launch
    through it is then one ctypes call."""

    def __init__(self, x: torch.Tensor, params: torch.Tensor, tile: int):
        n, d, threads, n_tri = _check_x(x, tile)
        width = d * d + 2
        check_tensor(params, "params", torch.float32, (None, width), x.device)
        self.n, self.d, self.tile = n, d, tile
        self.params = params
        self.row_bytes = width * params.element_size()
        # n < 2 launches nothing: its sums are zeros
        self.out = (torch.zeros if n < 2 else torch.empty)(
            (params.shape[0],), dtype=torch.float32, device=x.device)
        self._keep = (x, torch.empty((max(n_tri, 1),), dtype=torch.float32,
                                     device=x.device))   # the pointers below are into these
        self.on_device = torch.cuda.device(x.device)
        p, o, f = params.data_ptr(), self.out.data_ptr(), params.element_size()
        s = stream(x.device)
        self.args = [(x.data_ptr(), n, d, p + b * self.row_bytes,
                      p + b * self.row_bytes + d * d * f, p + b * self.row_bytes + (d * d + 1) * f,
                      threads, self._keep[1].data_ptr(), o + b * f, s)
                     for b in range(params.shape[0])]
        self._outs = {}

    def out_rows(self, first: int, count: int) -> torch.Tensor:
        """`out[first:first + count]`, one view kept per range."""
        view = self._outs.get((first, count))
        if view is None:
            view = self._outs[(first, count)] = self.out[first:first + count]
        return view


def gh_fused_sums(x: torch.Tensor, params: torch.Tensor, tile: int,
                  plan: Plan = None) -> torch.Tensor:
    """(B,) float32 sums on x's device, one launch per row of `params`:
    (B, d d + 2) float32 on x's device, as `ref.gh_params` packs them.  Each
    launch reads its H^-1 and constants in place and writes its slot of the
    output; the B launches run in order on the stream and reuse one partials
    buffer, so each sum has the bits of a batch of one with the same row.
    `plan`: a `Plan` over x whose `params` hold these rows (a fit's, built
    once), launched through with nothing resolved again and returned as a
    view of its `out`; None, a plan of these rows.  n < 2 gives zeros and
    launches nothing."""
    if plan is None:
        plan = Plan(x, params, tile)
    first, rest = divmod(params.data_ptr() - plan.params.data_ptr(), plan.row_bytes)
    b = params.shape[0]
    if rest or first < 0 or first + b > plan.params.shape[0]:
        raise ValueError("gh_fused_sums: params must be rows of the plan's params")
    if plan.n >= 2:
        fn = _fn()
        with plan.on_device:
            for args in plan.args[first:first + b]:
                raise_on(fn(*args), "gh_fused_sum")
                launches.inc()
    return plan.out_rows(first, b)
