"""Nelder-Mead simplex minimiser (paper §4.4 LSCV_H, ref. [27]).
Counterpart: `repro/core/nelder_mead.py`.

The reference runs the simplex as a `lax.while_loop` that evaluates the
k + 1 shrink points at every step, used or not.  Here the loop runs on the
host over objective values: the simplex is a numpy float32 array, so a
step's bookkeeping (centroid, candidates, sort, spread tests) costs no
torch operator dispatch, and the objective takes a batch of points, so that
one round trip to wherever it evaluates (LSCV_H's sums run on the card)
serves every point the step knows before it reads a value.  The start
simplex is one batch of k + 1 points; each step's reflection, expansion and
contraction are one batch of 3; a shrink is one batch of k + 1, evaluated
only when the step accepts no point, which is the same function with fewer
evaluations.  `nfev` counts 3 per step, plus k + 1 for a shrink, as the
reference counts them.  Every operation rounds in float32, as the
reference's do; the centroid adds the simplex's rows in order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import obs


class NMResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    it: int
    nfev: int


def _values(fun: Callable, points: np.ndarray) -> np.ndarray:
    """One round trip: the float32 values of a batch of points, on the host
    (one `nm.eval` span each, whose `points` add up to `nfev`).  `fun` gets
    the points as a zero-copy CPU tensor view and returns a tensor or an
    array."""
    # repro: allow[instrument-drift] port span, listed in repro_torch.obs's docstring
    with obs.span("nm.eval", points=points.shape[0]):
        out = fun(torch.from_numpy(points))
        if isinstance(out, torch.Tensor):
            out = out.detach().to("cpu", torch.float32).numpy()
        return np.asarray(out, np.float32).reshape(points.shape[0])


def _sort(simplex: np.ndarray, values: np.ndarray):
    order = np.argsort(values, kind="stable")
    return simplex[order], values[order]


def minimize(fun: Callable, x0, *, init_scale: float = 0.1,
             max_iter: int = 200, xtol: float = 1e-6, ftol: float = 1e-9
             ) -> NMResult:
    """Minimise `fun: R^k -> R` starting at x0: `minimize_batch` over a
    batch objective that calls `fun` on each point in turn.  `fun` takes a
    (k,) float32 CPU tensor and returns a one-element tensor or a number."""
    def batch(points: torch.Tensor) -> torch.Tensor:
        return torch.stack([torch.as_tensor(fun(p)).detach().to("cpu", torch.float32)
                            .reshape(()) for p in points])
    return minimize_batch(batch, x0, init_scale=init_scale, max_iter=max_iter,
                          xtol=xtol, ftol=ftol)


def minimize_batch(fun: Callable, x0, *, init_scale: float = 0.1,
                   max_iter: int = 200, xtol: float = 1e-6, ftol: float = 1e-9
                   ) -> NMResult:
    """Minimise starting at x0 over a batch objective: `fun` takes a (B, k)
    float32 CPU tensor of points and returns their B values (a tensor or an
    array).  Standard NM coefficients (alpha=1, gamma=2, rho=0.5,
    sigma=0.5)."""
    x0 = torch.as_tensor(x0, dtype=torch.float32).detach().cpu().reshape(-1).numpy()
    k = x0.shape[0]
    # float32 constants: a Python float beside a numpy float32 scalar would
    # widen the arithmetic to float64 under numpy 1.x
    scale, two, half = np.float32(init_scale), np.float32(2.0), np.float32(0.5)
    xtol, ftol = np.float32(xtol), np.float32(ftol)
    # Initial simplex: x0 plus per-axis perturbations (scaled to |x0| where nonzero).
    steps = np.where(np.abs(x0) > np.float32(1e-8), scale * np.abs(x0), scale)
    simplex = np.concatenate([x0[None, :], x0[None, :] + np.diag(steps)])
    values = _values(fun, simplex)
    it, nfev = 0, k + 1

    simplex, values = _sort(simplex, values)
    while it < max_iter:
        spread_f = values[-1] - values[0]
        spread_x = np.max(np.abs(simplex - simplex[0]))
        if not (spread_f > ftol or spread_x > xtol):
            break
        best, worst, second_worst = values[0], values[-1], values[-2]
        centroid = np.add.reduce(simplex[:-1], axis=0) / np.float32(k)
        xr = centroid + (centroid - simplex[-1])           # reflection
        xe = centroid + two * (centroid - simplex[-1])     # expansion
        xc = centroid + half * (simplex[-1] - centroid)    # contraction
        fr, fe, fc = _values(fun, np.stack([xr, xe, xc]))

        use_exp = bool(fr < best) and bool(fe < fr)
        use_ref = bool(fr < second_worst) and not use_exp
        use_con = bool(fc < worst) and not use_exp and not use_ref
        if use_exp or use_ref or use_con:
            # `_sort` made simplex and values afresh: written in place
            simplex[-1] = xe if use_exp else (xr if use_ref else xc)
            values[-1] = fe if use_exp else (fr if use_ref else fc)
            nfev += 3
        else:                                               # shrink
            simplex = simplex[0][None, :] + half * (simplex - simplex[0][None, :])
            values = _values(fun, simplex)
            nfev += 3 + k + 1
        simplex, values = _sort(simplex, values)
        it += 1
    return NMResult(x=torch.from_numpy(simplex[0].copy()),
                    fun=torch.from_numpy(values[:1].copy()).reshape(()), it=it, nfev=nfev)
