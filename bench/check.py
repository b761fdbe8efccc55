"""The comparison that decides `correct`: the program's outputs of the
window against the plain reference (`bench/reference.py`).

Numbers compared, each against its limit in `bench/limits/<cell>.json`:

  reservoir_mismatch  reservoirs (per column and joint, per refresh) whose
                      retained rows differ from the reference's replay of
                      the same stream; exact, limit 0
  h_gap               LSCV_h: g_ref(h_program) - min over the grid of g_ref,
                      over |that min|, the worst fit checked
  H_shortfall         LSCV_H: g_ref(H_program) - g_ref(H_ref) over the
                      reference's own descent g_ref(H_start) - g_ref(H_ref),
                      H_ref from the reference's Nelder-Mead (same start
                      rule, same iterations); positive where the program's
                      H is worse, the worst fit checked
  answer_err          |estimate - reference| over the reference's CI
                      half-width (over 1e-9 |reference| on the exact paths,
                      whose interval has no width), the worst answer checked
  ci_err              |half-width - reference's| over the reference's
                      half-width, the worst KDE answer checked

`checks` lists each as {"value", "limit"}; a number without a reading in a
cell (no fit of that kind) is left out.

Read beside them and not compared: `stream_err.median` and `stream_err.max`,
the program's estimates against the stream's exact answers (what the
synopses approximate, not what the reference computes).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np


def answer_errors(program: np.ndarray, ref: Sequence[tuple]) -> Dict[str, float]:
    """program: (q, 3) estimate, ci_lo, ci_hi; ref: q (estimate, ci_lo, ci_hi)."""
    r = np.asarray(ref, np.float64)
    p = np.asarray(program, np.float64)
    half_r = 0.5 * (r[:, 2] - r[:, 1])
    half_p = 0.5 * (p[:, 2] - p[:, 1])
    scale = np.maximum(half_r, 1e-9 * np.abs(r[:, 0])) + 1e-300
    ans = np.abs(p[:, 0] - r[:, 0]) / scale
    kde = half_r > 0
    ci = np.abs(half_p[kde] - half_r[kde]) / half_r[kde] if kde.any() else np.zeros(0)
    return {"answer_err": float(np.max(ans)) if ans.size else 0.0,
            "ci_err": float(np.max(ci)) if ci.size else 0.0}


def stream_errors(estimates: np.ndarray, exact: np.ndarray) -> Dict[str, float]:
    """Median and max of |estimate - exact| / |exact| over the entries
    whose exact answer is not 0 and whose estimate is finite (a non-finite
    one is counted as failed); none: an empty dict."""
    est, ex = np.asarray(estimates, np.float64), np.asarray(exact, np.float64)
    nz = (ex != 0.0) & np.isfinite(est)
    if not nz.any():
        return {}
    rel = np.abs(est[nz] - ex[nz]) / np.abs(ex[nz])
    return {"stream_err.median": float(np.median(rel)), "stream_err.max": float(np.max(rel))}


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, checks): every reading within its limit (a NaN reading
    fails), a reading with no limit is a fault of the harness."""
    checks = {}
    ok = True
    for name, value in readings.items():
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        lim = float(limits[name])
        checks[name] = {"value": value, "limit": lim}
        if not (isinstance(value, (int, float)) and math.isfinite(value) and value <= lim):
            ok = False
    return ok, checks


def worst(values: List[float]) -> float:
    return float(max(values)) if values else 0.0
