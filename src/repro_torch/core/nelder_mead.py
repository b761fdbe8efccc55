"""Nelder-Mead simplex minimiser (paper §4.4 LSCV_H, ref. [27]).
Counterpart: `repro/core/nelder_mead.py`.

The reference runs the simplex as a `lax.while_loop` that evaluates the
k + 1 shrink points at every step, used or not.  Here the loop runs on the
host over objective values: the simplex is a float32 tensor on the CPU and
the objective takes a batch of points, so that one round trip to wherever
it evaluates (LSCV_H's sums run on the card) serves every point the step
knows before it reads a value.  The start simplex is one batch of k + 1
points; each step's reflection, expansion and contraction are one batch of
3; a shrink is one batch of k + 1, evaluated only when the step accepts no
point, which is the same function with fewer evaluations.  `nfev` counts 3
per step, plus k + 1 for a shrink, as the reference counts them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import obs


class NMResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    it: int
    nfev: int


def _values(fun: Callable, points: torch.Tensor) -> torch.Tensor:
    """One round trip: the values of a batch of points, on the host (one
    `nm.eval` span each, whose `points` add up to `nfev`)."""
    # repro: allow[instrument-drift] port span, listed in repro_torch.obs's docstring
    with obs.span("nm.eval", points=points.shape[0]):
        return torch.as_tensor(fun(points)).detach().to("cpu", torch.float32).reshape(
            points.shape[0])


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
    float32 CPU tensor of points and returns their B values.  Standard NM
    coefficients (alpha=1, gamma=2, rho=0.5, sigma=0.5)."""
    x0 = torch.as_tensor(x0, dtype=torch.float32).detach().cpu().reshape(-1)
    k = x0.shape[0]
    # Initial simplex: x0 plus per-axis perturbations (scaled to |x0| where nonzero).
    steps = torch.where(torch.abs(x0) > 1e-8, init_scale * torch.abs(x0),
                        torch.tensor(init_scale, dtype=torch.float32))
    simplex = torch.cat([x0[None, :], x0[None, :] + torch.diag(steps)], dim=0)
    values = _values(fun, simplex)
    it, nfev = 0, k + 1

    def sort(simplex, values):
        order = torch.argsort(values, stable=True)
        return simplex[order], values[order]

    simplex, values = sort(simplex, values)
    while it < max_iter:
        spread_f = values[-1] - values[0]
        spread_x = torch.max(torch.abs(simplex - simplex[0]))
        if not (spread_f > ftol or spread_x > xtol):
            break
        best, worst, second_worst = values[0], values[-1], values[-2]
        centroid = torch.mean(simplex[:-1], dim=0)
        xr = centroid + (centroid - simplex[-1])           # reflection
        xe = centroid + 2.0 * (centroid - simplex[-1])     # expansion
        xc = centroid + 0.5 * (simplex[-1] - centroid)     # contraction
        fr, fe, fc = _values(fun, torch.stack([xr, xe, xc]))

        use_exp = bool(fr < best) and bool(fe < fr)
        use_ref = bool(fr < second_worst) and not use_exp
        use_con = bool(fc < worst) and not use_exp and not use_ref
        if use_exp or use_ref or use_con:
            simplex = simplex.clone()
            values = values.clone()
            simplex[-1] = xe if use_exp else (xr if use_ref else xc)
            values[-1] = fe if use_exp else (fr if use_ref else fc)
            nfev += 3
        else:                                               # shrink
            simplex = simplex[0][None, :] + 0.5 * (simplex - simplex[0][None, :])
            values = _values(fun, simplex)
            nfev += 3 + k + 1
        simplex, values = sort(simplex, values)
        it += 1
    return NMResult(x=simplex[0], fun=values[0], it=it, nfev=nfev)
