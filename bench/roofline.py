"""Operations and bytes of the hand kernels' work, and the H100's peaks:
the yardstick of every `<kernel>_roofline` metric.

Frozen copy of `chip_smoke.py`'s `bound_ms` counts.  A call's bound is the
larger of its bytes (each input read once, each output written once) over
the HBM bandwidth and its FLOPs over the FP32 peak outside the tensor cores,
an FMA two FLOPs and an exp one.  It counts what these inputs need, whatever
a kernel does: a kernel that a later change replaces is held to the same
work.  Per pair of sample rows (n(n-1)/2 pairs):

  sv_matrix       d subtractions and the quadratic form: d^2 + 3d - 1;
                  writes the n x n matrix S
  lscv_grid_sums  per (pair, grid h): the scale, the exp, two FMAs: 6;
                  reads the strict upper triangle of S once
  gh_fused_sum    d subtractions, the quadratic form, the exp, two FMAs:
                  d^2 + 3d + 4
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FP32 = 67e12        # FLOP/s, outside the tensor cores
PEAK_BYTES = 3.35e12     # bytes/s of HBM3


def _bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FP32)


def sv_matrix_s(n: int, d: int) -> float:
    pairs = n * (n - 1) // 2
    return _bound_s(4 * n * d + 4 * d * d + 4 * n * n, (d * d + 3 * d - 1) * pairs)


def lscv_grid_sums_s(n: int, n_h: int) -> float:
    pairs = n * (n - 1) // 2
    return _bound_s(4 * pairs + 8 * n_h + 8, 6 * n_h * pairs)


def gh_fused_sum_s(n: int, d: int) -> float:
    pairs = n * (n - 1) // 2
    return _bound_s(4 * n * d + 4 * d * d + 12, (d * d + 3 * d + 4) * pairs)


def share_pct(bound_s_each: float, launches: int, device_s: float):
    """The launches' bound over their device time, in percent; None when the
    window holds none of them."""
    if not launches or device_s <= 0.0:
        return None
    return 100.0 * bound_s_each * launches / device_s
