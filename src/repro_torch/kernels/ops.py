"""Engine-facing wrappers of the port's kernels.
Counterpart: `repro/kernels/ops.py`.

A wrapper launches the hand-written CUDA kernel when its input lies on a
CUDA device; the launcher checks every argument and raises on anything the
kernel does not take, and nothing falls back.  Only for a tensor on the CPU
does a wrapper take the kernel's plain PyTorch version (`ref.py`).  Each
launcher counts its launches (`launch_counts`).

Tiles resolve at call time, as the reference's do: explicit keyword > tuned
cache (`kernels/autotune.py`, keyed by the kernel and its bucketed shape) >
the launcher module's constant.  The range, box and GROUP BY kernels'
tunable is `ranges`, the count of sample ranges their launchers cut n into
(at the main path's shapes `tile` never binds); their cache key leaves out
the batch, so a tuned cut stays a function of n and d alone and a query's
bits do not depend on its micro-batch.

With `repro_torch.obs` enabled, a launch goes through
`tuning.profiled_call`, which records its fenced wall time, dispatch time
and a call count in the process-global registry under the kernel's name,
its shape labels and its resolved tiles; disabled (the default), the
wrapper calls the launcher directly.  The plain versions on the CPU are not
profiled.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import obs

from . import aqp_batch as _ab
from . import aqp_boxes as _abx
from . import aqp_grouped as _agr
from . import autotune as _tune
from . import draw_box as _db
from . import gh_fused as _gh
from . import kde_eval as _kde
from . import lscv_grid as _lg
from . import pairwise_reduce as _pr
from . import qmc_reduce as _qmc
from . import ref
from . import rff_eval as _rff
from . import sv_precompute as _sv
from .tuning import profiled_call

_COUNTERS = (_pr.launches, _ab.launches, _abx.launches, _sv.launches,
             _lg.launches, _gh.launches, _agr.launches, _qmc.launches,
             _rff.launches, _kde.launches, _db.launches)


def _run(kernel: str, fn, **labels):
    """Launch through `fn()`, profiled when obs is enabled."""
    if not obs.enabled():
        return fn()
    return profiled_call(kernel, fn, **labels)


def _d(x) -> int:
    return x.shape[1] if x.dim() > 1 else 1


def pairwise_scaled_ksum(x, g, kind="k4", tile=None, blocks=None):
    """`blocks=(begin, count)`: that range of the kernel's triangle tiles
    only (one rank's share, `triangle.share`); None, all of them."""
    if x.device.type == "cpu" and blocks is None:
        return ref.pairwise_scaled_ksum(x, g, kind)
    (tile,) = _tune.resolve("pairwise_scaled_ksum", {"n": x.shape[0]},
                            tile=(tile, _pr.TILE))
    if x.device.type == "cpu":
        return ref.pairwise_scaled_ksum(x, g, kind, blocks=blocks,
                                        tile=_pr.tile_for(x.shape[0], tile))
    return _run("pairwise_scaled_ksum",
                lambda: _pr.pairwise_scaled_ksum(x, g, kind, tile=tile, blocks=blocks),
                n=x.shape[0], kind=kind, tile=tile)


def _range_tiles(kernel, shape, mod, tile, ranges):
    return _tune.resolve(kernel, shape, tile=(tile, mod.TILE),
                         ranges=(ranges, mod.RANGES))


def aqp_batch_sums(x, h, a, b, tile=None, ranges=None):
    if x.device.type == "cpu":
        return ref.aqp_batch_sums(x, h, a, b)
    tile, ranges = _range_tiles("aqp_batch_sums", {"n": x.shape[0], "G": a.shape[0]},
                                _ab, tile, ranges)
    return _run("aqp_batch_sums",
                lambda: _ab.aqp_batch_sums(x, h, a, b, tile=tile, ranges=ranges),
                n=x.shape[0], G=a.shape[0], tile=tile, q_tile=_ab.Q_TILE, ranges=ranges)


def aqp_batch_moments(x, h, a, b, tile=None, ranges=None):
    """The five moment sums (5, q) of a range batch in one launch of the
    aqp_batch kernel: rows 0-1 the estimate's, all five the CI's."""
    if x.device.type == "cpu":
        return ref.aqp_batch_moments(x, h, a, b)
    tile, ranges = _range_tiles("aqp_batch_sums", {"n": x.shape[0], "G": a.shape[0]},
                                _ab, tile, ranges)
    return _run("aqp_batch_sums",
                lambda: _ab.aqp_batch_moments(x, h, a, b, tile=tile, ranges=ranges),
                n=x.shape[0], G=a.shape[0], tile=tile, q_tile=_ab.Q_TILE, ranges=ranges,
                moments=5)


def aqp_box_sums(x, h_diag, lo, hi, tgt, tile=None, ranges=None):
    if x.device.type == "cpu":
        return ref.aqp_box_sums(x, h_diag, lo, hi, tgt)
    shape = {"n": x.shape[0], "d": x.shape[1], "G": lo.shape[0]}
    tile, ranges = _range_tiles("aqp_box_sums", shape, _abx, tile, ranges)
    return _run("aqp_box_sums",
                lambda: _abx.aqp_box_sums(x, h_diag, lo, hi, tgt, tile=tile, ranges=ranges),
                **shape, tile=tile, q_tile=_abx.Q_TILE, ranges=ranges)


def aqp_box_moments(x, h_diag, lo, hi, tgt, tile=None, ranges=None):
    """The five moment sums (5, q) of a box batch in one launch of the
    aqp_boxes kernel: rows 0-1 the estimate's, all five the CI's."""
    if x.device.type == "cpu":
        return ref.aqp_box_moments(x, h_diag, lo, hi, tgt)
    shape = {"n": x.shape[0], "d": x.shape[1], "G": lo.shape[0]}
    tile, ranges = _range_tiles("aqp_box_sums", shape, _abx, tile, ranges)
    return _run("aqp_box_sums",
                lambda: _abx.aqp_box_moments(x, h_diag, lo, hi, tgt, tile=tile,
                                             ranges=ranges),
                **shape, tile=tile, q_tile=_abx.Q_TILE, ranges=ranges, moments=5)


def sv_matrix(x, m, tile=None, algorithm="mxu", cols=None):
    """`cols=(c0, c1)`: the column block S[:c1, c0:c1] only; None, the
    whole S."""
    if x.device.type == "cpu":
        if algorithm not in _sv.ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        return ref.sv_matrix(x, m, cols=cols)
    shape = {"n": x.shape[0], "d": _d(x)}
    (tile,) = _tune.resolve("sv_matrix", shape, tile=(tile, _sv.TILE))
    return _run("sv_matrix", lambda: _sv.sv_matrix(x, m, tile=tile, algorithm=algorithm,
                                                   cols=cols),
                **shape, tile=tile, algorithm=algorithm)


def gh_fused_sum(x, h_inv, c_k, c_kk, tile=None):
    if x.device.type == "cpu":
        return ref.gh_fused_sum(x, h_inv, c_k, c_kk)
    shape = {"n": x.shape[0], "d": _d(x)}
    (tile,) = _tune.resolve("gh_fused_sum", shape, tile=(tile, _gh.TILE))
    return _run("gh_fused_sum", lambda: _gh.gh_fused_sum(x, h_inv, c_k, c_kk, tile=tile),
                **shape, tile=tile)


def gh_fused_sums(x, params, tile=None):
    """The (B,) sums of B bandwidths, one gh_fused_sum launch each, queued
    back to back: rows of `params` as `ref.gh_params` packs them.  With obs
    enabled each launch is profiled (and fenced) on its own, so that
    `kernel.calls` stays a count of launches."""
    if x.device.type == "cpu":
        return ref.gh_fused_sums(x, params)
    shape = {"n": x.shape[0], "d": _d(x)}
    (tile,) = _tune.resolve("gh_fused_sum", shape, tile=(tile, _gh.TILE))
    if not obs.enabled():
        return _gh.gh_fused_sums(x, params, tile=tile)
    return torch.cat([profiled_call("gh_fused_sum",
                                    lambda row=row: _gh.gh_fused_sums(x, row, tile=tile),
                                    **shape, tile=tile)
                      for row in params.split(1)])


def lscv_grid_sums_from_s(s, h_grid, c_k, c_kk, h_tile=None, blocks=None, slab=None):
    """`blocks=(begin, count)`: that range of the kernel's S tiles only (one
    rank's share, `triangle.share`); None, all of them.  `slab=(c0, n)`: s
    is `sv_matrix(x, m, cols=(c0, c1))` of an n-point x, holding every
    column of those tiles (`lscv_grid.slab_walk`)."""
    if s.device.type == "cpu":
        if blocks is None and slab is None:
            return ref.lscv_grid_sums_from_s(s, h_grid, c_k, c_kk)
        return ref.lscv_grid_sums_from_s(s, h_grid, c_k, c_kk, blocks=blocks, tile=_lg.TILE,
                                         slab=slab)
    shape = {"n": s.shape[0] if slab is None else int(slab[1]), "G": h_grid.shape[0]}
    (h_tile,) = _tune.resolve("lscv_grid_sums", shape, h_tile=(h_tile, _lg.H_TILE))
    return _run("lscv_grid_sums",
                lambda: _lg.lscv_grid_sums_from_s(s, h_grid, c_k, c_kk, h_tile=h_tile,
                                                  blocks=blocks, slab=slab),
                **shape, h_tile=h_tile)


def lscv_grid_sums(x, sigma_inv, h_grid, c_k, c_kk, tile=None, h_tile=None):
    """The sv_precompute kernel, then the grid kernel over its S (as the
    reference's `lscv_grid_sums` runs its phase 1 first); S (4 GiB at
    n = 32 768) is freed on return."""
    if x.device.type == "cpu":
        return ref.lscv_grid_sums(x, sigma_inv, h_grid, c_k, c_kk)
    return lscv_grid_sums_from_s(sv_matrix(x, sigma_inv, tile=tile), h_grid,
                                 c_k, c_kk, h_tile=h_tile)


def aqp_grouped_sums(x, h_diag, lo, hi, glo, ghi, g_axis, tgt, tile=None, ranges=None):
    if x.device.type == "cpu":
        return ref.aqp_grouped_sums(x, h_diag, lo, hi, glo, ghi, int(g_axis),
                                    int(tgt))
    shape = {"n": x.shape[0], "d": x.shape[1], "G": glo.shape[0]}
    tile, ranges = _range_tiles("aqp_grouped_sums", shape, _agr, tile, ranges)
    return _run("aqp_grouped_sums",
                lambda: _agr.aqp_grouped_sums(x, h_diag, lo, hi, glo, ghi, g_axis, tgt,
                                              tile=tile, ranges=ranges),
                **shape, tile=tile, g_tile=_agr.G_TILE, ranges=ranges)


def aqp_grouped_moments(x, h_diag, lo, hi, wlo, whi, win, g_axis, tgt, tile=None,
                        ranges=None):
    """The five moment sums (F, 5, Gmax) of F GROUP BY families in one
    launch of the aqp_grouped kernel; win / g_axis / tgt are host ints."""
    if x.device.type == "cpu":
        return ref.aqp_grouped_moments(x, h_diag, lo, hi, wlo, whi, win, g_axis,
                                       tgt)
    shape = {"n": x.shape[0], "d": x.shape[1], "G": wlo.shape[1]}
    tile, ranges = _range_tiles("aqp_grouped_sums", shape, _agr, tile, ranges)
    return _run("aqp_grouped_sums",
                lambda: _agr.aqp_grouped_moments(x, h_diag, lo, hi, wlo, whi, win, g_axis,
                                                 tgt, tile=tile, ranges=ranges),
                **shape, F=lo.shape[0], tile=tile, g_tile=_agr.G_TILE, ranges=ranges)


def _qmc_tiles(x, nodes, lo, tile, m_tile):
    shape = {"n": x.shape[0], "d": x.shape[1], "G": lo.shape[0], "m": nodes.shape[0]}
    return shape, _tune.resolve("qmc_box_reduce", shape, tile=(tile, _qmc.TILE),
                                m_tile=(m_tile, _qmc.M_TILE))


def qmc_box_reduce(nodes, x, h_inv, log_norm, lo, hi, tgt, tile=None, m_tile=None):
    if x.device.type == "cpu":
        return ref.qmc_box_reduce(nodes, x, h_inv, log_norm, lo, hi, tgt)
    shape, (tile, m_tile) = _qmc_tiles(x, nodes, lo, tile, m_tile)
    return _run("qmc_box_reduce",
                lambda: _qmc.qmc_box_reduce(nodes, x, h_inv, log_norm, lo, hi, tgt,
                                            tile=tile, m_tile=m_tile),
                **shape, tile=tile, m_tile=m_tile)


def qmc_box_reduce_split(nodes, x, h_inv, log_norm, lo, hi, tgt, splits, tile=None,
                         m_tile=None):
    """`qmc_box_reduce` over the whole sample and over `splits` equal row
    chunks in one launch: (cnt_sums, sum_sums), each (splits + 1, q)."""
    if x.device.type == "cpu":
        return ref.qmc_box_reduce_split(nodes, x, h_inv, log_norm, lo, hi, tgt,
                                        splits)
    shape, (tile, m_tile) = _qmc_tiles(x, nodes, lo, tile, m_tile)
    return _run("qmc_box_reduce",
                lambda: _qmc.qmc_box_reduce_split(nodes, x, h_inv, log_norm, lo, hi, tgt,
                                                  splits, tile=tile, m_tile=m_tile),
                **shape, tile=tile, m_tile=m_tile, splits=splits)


def draw_box_reduce(x, z, l_chol, lo, hi, tgt, splits, tile=None):
    """The kernel-centred box sums of the draws y = x_i + L z over the whole
    sample and over `splits` equal row chunks in one launch: (cnt_sums,
    sum_sums), each (splits + 1, q) float64.  `tile`: draws a block forms
    (whole rows)."""
    if x.device.type == "cpu":
        return ref.draw_box_reduce(x, z, l_chol, lo, hi, tgt, splits)
    shape = {"n": x.shape[0], "d": x.shape[1], "G": lo.shape[0],
             "K": z.shape[0] // max(x.shape[0], 1)}
    (tile,) = _tune.resolve("draw_box_reduce", shape, tile=(tile, _db.TILE_DRAWS))
    return _run("draw_box_reduce",
                lambda: _db.draw_box_reduce(x, z, l_chol, lo, hi, tgt, splits, tile=tile),
                **shape, tile=tile, splits=splits)


def _rff_tiles(points, w, tile, threads):
    # the reference's labels: n the feature count, G the point count
    shape = {"n": w.shape[0], "d": points.shape[1], "G": points.shape[0]}
    return shape, _tune.resolve("rff_density", shape, tile=(tile, _rff.TILE),
                                threads=(threads, _rff.THREADS))


def rff_density(points, w, b, z, tile=None, threads=None):
    if points.device.type == "cpu":
        return ref.rff_density(points, w, b, z)
    shape, (tile, threads) = _rff_tiles(points, w, tile, threads)
    return _run("rff_density",
                lambda: _rff.rff_density(points, w, b, z, tile=tile, threads=threads),
                **shape, tile=tile, threads=threads)


def rff_density_blocks(points, w, b, z, n_blocks, tile=None, threads=None):
    """(blocks (n_blocks, m), estimate (m,)): the raw dots of the feature
    blocks and of all the features, in one launch of the rff_eval kernel."""
    if points.device.type == "cpu":
        return ref.rff_density_blocks(points, w, b, z, n_blocks)
    shape, (tile, threads) = _rff_tiles(points, w, tile, threads)
    return _run("rff_density",
                lambda: _rff.rff_density_blocks(points, w, b, z, n_blocks, tile=tile,
                                                threads=threads),
                **shape, tile=tile, threads=threads, blocks=n_blocks)


def kde_eval(points, x, h, tile=None):
    """f^(points; x, h) (eq. 3); points (m, d) or (m,), x (n, d) or (n,)."""
    if x.dim() == 1:
        x = x[:, None]
    if points.dim() == 1:
        points = points[:, None]
    if x.device.type == "cpu":
        return ref.kde_eval(points, x, h)
    points, x = points.contiguous(), x.contiguous()
    (tile,) = _tune.resolve("kde_eval", {"n": x.shape[0], "G": points.shape[0]},
                            tile=(tile, _kde.TILE))
    return _run("kde_eval", lambda: _kde.kde_eval(points, x, h, tile=tile),
                n=x.shape[0], d=x.shape[1], G=points.shape[0], tile=tile)


def launch_counts() -> Dict[str, int]:
    """{kernel: launches since the last reset}."""
    return {c.kernel: c.value for c in _COUNTERS}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        c.reset()
