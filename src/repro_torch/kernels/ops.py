"""Engine-facing wrappers of the port's kernels.
Counterpart: `repro/kernels/ops.py`.

A wrapper launches the hand-written CUDA kernel when its input lies on a
CUDA device; the launcher checks every argument and raises on anything the
kernel does not take, and nothing falls back.  Only for a tensor on the CPU
does a wrapper take the kernel's plain PyTorch version (`ref.py`).  Tiles
are the launcher modules' constants.  Each launcher counts its launches
(`launch_counts`).
"""
from __future__ import annotations

from typing import Dict

from . import aqp_batch as _ab
from . import aqp_boxes as _abx
from . import pairwise_reduce as _pr
from . import ref

_COUNTERS = (_pr.launches, _ab.launches, _abx.launches)


def pairwise_scaled_ksum(x, g, kind="k4"):
    if x.device.type == "cpu":
        return ref.pairwise_scaled_ksum(x, g, kind)
    return _pr.pairwise_scaled_ksum(x, g, kind, tile=_pr.TILE)


def aqp_batch_sums(x, h, a, b):
    if x.device.type == "cpu":
        return ref.aqp_batch_sums(x, h, a, b)
    return _ab.aqp_batch_sums(x, h, a, b, tile=_ab.TILE, q_tile=_ab.Q_TILE)


def aqp_box_sums(x, h_diag, lo, hi, tgt):
    if x.device.type == "cpu":
        return ref.aqp_box_sums(x, h_diag, lo, hi, tgt)
    return _abx.aqp_box_sums(x, h_diag, lo, hi, tgt, tile=_abx.TILE,
                             q_tile=_abx.Q_TILE)


def launch_counts() -> Dict[str, int]:
    """{kernel: launches since the last reset}."""
    return {c.kernel: c.value for c in _COUNTERS}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        c.reset()
