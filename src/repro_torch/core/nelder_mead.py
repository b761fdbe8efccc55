"""Nelder-Mead simplex minimiser (paper §4.4 LSCV_H, ref. [27]).
Counterpart: `repro/core/nelder_mead.py`.

The reference runs the simplex as a `lax.while_loop` that evaluates the
k + 1 shrink points at every step, used or not.  Here the loop runs on the
host over objective values: the simplex is a float32 tensor on the CPU, the
objective may evaluate anywhere (LSCV_H's runs on the card), and each
evaluation syncs its value to the host once.  The shrink points are
evaluated only when the step accepts no point, which is the same function
with fewer evaluations; `nfev` counts 3 per step, plus k + 1 for a shrink,
as the reference counts them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class NMResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    it: int
    nfev: int


def _value(fun: Callable, p: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(fun(p)).detach().to("cpu", torch.float32).reshape(())


def minimize(fun: Callable, x0, *, init_scale: float = 0.1,
             max_iter: int = 200, xtol: float = 1e-6, ftol: float = 1e-9
             ) -> NMResult:
    """Minimise `fun: R^k -> R` starting at x0.  Standard NM coefficients
    (alpha=1, gamma=2, rho=0.5, sigma=0.5).  `fun` takes a (k,) float32 CPU
    tensor and returns a one-element tensor or a number."""
    x0 = torch.as_tensor(x0, dtype=torch.float32).detach().cpu().reshape(-1)
    k = x0.shape[0]
    # Initial simplex: x0 plus per-axis perturbations (scaled to |x0| where nonzero).
    steps = torch.where(torch.abs(x0) > 1e-8, init_scale * torch.abs(x0),
                        torch.tensor(init_scale, dtype=torch.float32))
    simplex = torch.cat([x0[None, :], x0[None, :] + torch.diag(steps)], dim=0)
    values = torch.stack([_value(fun, p) for p in simplex])
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
        fr = _value(fun, xr)
        xe = centroid + 2.0 * (centroid - simplex[-1])     # expansion
        fe = _value(fun, xe)
        xc = centroid + 0.5 * (simplex[-1] - centroid)     # contraction
        fc = _value(fun, xc)

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
            values = torch.stack([_value(fun, p) for p in simplex])
            nfev += 3 + k + 1
        simplex, values = sort(simplex, values)
        it += 1
    return NMResult(x=simplex[0], fun=values[0], it=it, nfev=nfev)
