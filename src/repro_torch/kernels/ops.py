"""Engine-facing wrappers of the port's kernels.
Counterpart: `repro/kernels/ops.py`.

A wrapper launches the hand-written CUDA kernel when its input lies on a
CUDA device; the launcher checks every argument and raises on anything the
kernel does not take, and nothing falls back.  Only for a tensor on the CPU
does a wrapper take the kernel's plain PyTorch version (`ref.py`).  Tiles
are the launcher modules' constants; the LSCV wrappers keep the reference's
`tile` / `h_tile` keywords, None meaning those constants.  Each launcher
counts its launches (`launch_counts`).
"""
from __future__ import annotations

from typing import Dict

from . import aqp_batch as _ab
from . import aqp_boxes as _abx
from . import aqp_grouped as _agr
from . import gh_fused as _gh
from . import kde_eval as _kde
from . import lscv_grid as _lg
from . import pairwise_reduce as _pr
from . import qmc_reduce as _qmc
from . import ref
from . import rff_eval as _rff
from . import sv_precompute as _sv

_COUNTERS = (_pr.launches, _ab.launches, _abx.launches, _sv.launches,
             _lg.launches, _gh.launches, _agr.launches, _qmc.launches,
             _rff.launches, _kde.launches)


def pairwise_scaled_ksum(x, g, kind="k4"):
    if x.device.type == "cpu":
        return ref.pairwise_scaled_ksum(x, g, kind)
    return _pr.pairwise_scaled_ksum(x, g, kind, tile=_pr.TILE)


def aqp_batch_sums(x, h, a, b):
    if x.device.type == "cpu":
        return ref.aqp_batch_sums(x, h, a, b)
    return _ab.aqp_batch_sums(x, h, a, b, tile=_ab.TILE)


def aqp_batch_moments(x, h, a, b):
    """The five moment sums (5, q) of a range batch in one launch of the
    aqp_batch kernel: rows 0-1 the estimate's, all five the CI's."""
    if x.device.type == "cpu":
        return ref.aqp_batch_moments(x, h, a, b)
    return _ab.aqp_batch_moments(x, h, a, b, tile=_ab.TILE)


def aqp_box_sums(x, h_diag, lo, hi, tgt):
    if x.device.type == "cpu":
        return ref.aqp_box_sums(x, h_diag, lo, hi, tgt)
    return _abx.aqp_box_sums(x, h_diag, lo, hi, tgt, tile=_abx.TILE)


def aqp_box_moments(x, h_diag, lo, hi, tgt):
    """The five moment sums (5, q) of a box batch in one launch of the
    aqp_boxes kernel: rows 0-1 the estimate's, all five the CI's."""
    if x.device.type == "cpu":
        return ref.aqp_box_moments(x, h_diag, lo, hi, tgt)
    return _abx.aqp_box_moments(x, h_diag, lo, hi, tgt, tile=_abx.TILE)


def sv_matrix(x, m, tile=None, algorithm="mxu"):
    if x.device.type == "cpu":
        if algorithm not in _sv.ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        return ref.sv_matrix(x, m)
    return _sv.sv_matrix(x, m, tile=tile or _sv.TILE, algorithm=algorithm)


def gh_fused_sum(x, h_inv, c_k, c_kk, tile=None):
    if x.device.type == "cpu":
        return ref.gh_fused_sum(x, h_inv, c_k, c_kk)
    return _gh.gh_fused_sum(x, h_inv, c_k, c_kk, tile=tile or _gh.TILE)


def lscv_grid_sums_from_s(s, h_grid, c_k, c_kk, h_tile=None):
    if s.device.type == "cpu":
        return ref.lscv_grid_sums_from_s(s, h_grid, c_k, c_kk)
    return _lg.lscv_grid_sums_from_s(s, h_grid, c_k, c_kk,
                                     h_tile=h_tile or _lg.H_TILE)


def lscv_grid_sums(x, sigma_inv, h_grid, c_k, c_kk, tile=None, h_tile=None):
    """The sv_precompute kernel, then the grid kernel over its S (as the
    reference's `lscv_grid_sums` runs its phase 1 first); S (4 GiB at
    n = 32 768) is freed on return."""
    if x.device.type == "cpu":
        return ref.lscv_grid_sums(x, sigma_inv, h_grid, c_k, c_kk)
    return lscv_grid_sums_from_s(sv_matrix(x, sigma_inv, tile=tile), h_grid,
                                 c_k, c_kk, h_tile=h_tile)


def aqp_grouped_sums(x, h_diag, lo, hi, glo, ghi, g_axis, tgt):
    if x.device.type == "cpu":
        return ref.aqp_grouped_sums(x, h_diag, lo, hi, glo, ghi, int(g_axis),
                                    int(tgt))
    return _agr.aqp_grouped_sums(x, h_diag, lo, hi, glo, ghi, g_axis, tgt,
                                 tile=_agr.TILE)


def aqp_grouped_moments(x, h_diag, lo, hi, wlo, whi, win, g_axis, tgt):
    """The five moment sums (F, 5, Gmax) of F GROUP BY families in one
    launch of the aqp_grouped kernel; win / g_axis / tgt are host ints."""
    if x.device.type == "cpu":
        return ref.aqp_grouped_moments(x, h_diag, lo, hi, wlo, whi, win, g_axis,
                                       tgt)
    return _agr.aqp_grouped_moments(x, h_diag, lo, hi, wlo, whi, win, g_axis,
                                    tgt, tile=_agr.TILE)


def qmc_box_reduce(nodes, x, h_inv, log_norm, lo, hi, tgt):
    if x.device.type == "cpu":
        return ref.qmc_box_reduce(nodes, x, h_inv, log_norm, lo, hi, tgt)
    return _qmc.qmc_box_reduce(nodes, x, h_inv, log_norm, lo, hi, tgt,
                               tile=_qmc.TILE, m_tile=_qmc.M_TILE)


def qmc_box_reduce_split(nodes, x, h_inv, log_norm, lo, hi, tgt, splits):
    """`qmc_box_reduce` over the whole sample and over `splits` equal row
    chunks in one launch: (cnt_sums, sum_sums), each (splits + 1, q)."""
    if x.device.type == "cpu":
        return ref.qmc_box_reduce_split(nodes, x, h_inv, log_norm, lo, hi, tgt,
                                        splits)
    return _qmc.qmc_box_reduce_split(nodes, x, h_inv, log_norm, lo, hi, tgt,
                                     splits, tile=_qmc.TILE, m_tile=_qmc.M_TILE)


def rff_density(points, w, b, z):
    if points.device.type == "cpu":
        return ref.rff_density(points, w, b, z)
    return _rff.rff_density(points, w, b, z, tile=_rff.TILE,
                            threads=_rff.THREADS)


def rff_density_blocks(points, w, b, z, n_blocks):
    """(blocks (n_blocks, m), estimate (m,)): the raw dots of the feature
    blocks and of all the features, in one launch of the rff_eval kernel."""
    if points.device.type == "cpu":
        return ref.rff_density_blocks(points, w, b, z, n_blocks)
    return _rff.rff_density_blocks(points, w, b, z, n_blocks, tile=_rff.TILE,
                                   threads=_rff.THREADS)


def kde_eval(points, x, h):
    """f^(points; x, h) (eq. 3); points (m, d) or (m,), x (n, d) or (n,)."""
    if x.dim() == 1:
        x = x[:, None]
    if points.dim() == 1:
        points = points[:, None]
    if x.device.type == "cpu":
        return ref.kde_eval(points, x, h)
    return _kde.kde_eval(points.contiguous(), x.contiguous(), h, tile=_kde.TILE)


def launch_counts() -> Dict[str, int]:
    """{kernel: launches since the last reset}."""
    return {c.kernel: c.value for c in _COUNTERS}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        c.reset()
