"""Approximate query processing on KDE synopses (paper §4.3, eqs. 9-11).
Counterpart: `repro/core/aqp.py`.

  COUNT(a<=X<=b)  ~= n * Integral_a^b f^(x) dx                  (eq. 9)
  SUM(X; a..b)    ~= n * Integral_a^b x f^(x) dx                (eq. 10)
  AVG             = SUM / COUNT                                 (§4.3)

with the Gaussian closed forms

  Integral_a^b K_h(x - Xi) dx    = Phi((b-Xi)/h) - Phi((a-Xi)/h)
  Integral_a^b x K_h(x - Xi) dx  = Xi [Phi(.)]_a^b - h [phi((x-Xi)/h)]_a^b

and, for axis-aligned boxes under a diagonal bandwidth, their per-axis
product (eq. 11).  Selectors "plugin", "silverman", "lscv_h" (one scalar
h, broadcast to every axis) and "lscv_H" (a full bandwidth matrix) are
ported.  A full-H synopsis answers boxes by deterministic quasi-MC on
Halton nodes (`box_qmc_terms`); `count_1d_numeric` / `sum_1d_numeric` are
the trapezoid cross-checks of eqs. 9-10 through `kde_eval`.  `Query` and
`QueryBatch` are the legacy 1-D surface over the engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DTYPE, DeviceLike, resolve_backend, resolve_device
from repro_torch.kernels import ref as kref

from . import gaussian as G
from .kde import kde_eval, kde_eval_H, silverman_h
from .lscv import lscv_H, lscv_h
from .plugin import plugin_bandwidth

# Slab of queries evaluated at once by the plain (q, n[, d]) passes.
Q_CHUNK = 64


def canonical_selector(selector: str) -> str:
    """Case-normalized selector name for cache and engine group keys;
    "lscv_h" and "lscv_H" are different selectors and stay distinct."""
    low = selector.lower()
    if low == "lscv_h" and selector.endswith("H"):
        return "lscv_H"
    return low


def count_1d(x: torch.Tensor, h: torch.Tensor, a, b) -> torch.Tensor:
    """eq. (9), closed form: n * mean_i [Phi((b-Xi)/h) - Phi((a-Xi)/h)]."""
    n = x.shape[0]
    za = (a - x) / h
    zb = (b - x) / h
    return n * torch.mean(G.phi_diff(za, zb))


def sum_1d(x: torch.Tensor, h: torch.Tensor, a, b) -> torch.Tensor:
    """eq. (10), closed form for the Gaussian kernel."""
    za = (a - x) / h
    zb = (b - x) / h
    term_mu = x * G.phi_diff(za, zb)
    term_h = -h * G.dens_diff(za, zb)
    return torch.sum(term_mu + term_h)


def count_box_diag(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    """eq. (11) for an axis-aligned box under a diagonal bandwidth.
    x: (n,d), h_diag/lo/hi: (d,)."""
    n = x.shape[0]
    za = (lo[None, :] - x) / h_diag[None, :]
    zb = (hi[None, :] - x) / h_diag[None, :]
    return n * torch.mean(torch.prod(G.phi_diff(za, zb), dim=1))


def sum_box_diag(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor, target: int) -> torch.Tensor:
    """SUM of axis `target` over a box (eq. 11 x eq. 10): axis t's factor
    is the 1-D first-moment closed form, selected, not divided."""
    za = (lo[None, :] - x) / h_diag[None, :]
    zb = (hi[None, :] - x) / h_diag[None, :]
    d_Phi = G.phi_diff(za, zb)
    moment = x * d_Phi - h_diag[None, :] * G.dens_diff(za, zb)
    axis = torch.arange(x.shape[1], device=x.device)
    factors = torch.where(axis[None, :] == target, moment, d_Phi)
    return torch.sum(torch.prod(factors, dim=1))


def count_1d_numeric(x: torch.Tensor, h, a: float, b: float,
                     n_grid: int = 513) -> torch.Tensor:
    """eq. (9) by trapezoid quadrature — the generic path the paper
    describes, kept as a cross-check of the closed form; the density runs
    through `kde_eval` (its kernel on a CUDA tensor)."""
    grid = torch.linspace(float(a), float(b), n_grid, dtype=DTYPE, device=x.device)
    f = kde_eval(grid, x, h, device=x.device)
    return x.shape[0] * torch.trapezoid(f, grid)


def sum_1d_numeric(x: torch.Tensor, h, a: float, b: float,
                   n_grid: int = 513) -> torch.Tensor:
    """eq. (10) by trapezoid quadrature (see `count_1d_numeric`)."""
    grid = torch.linspace(float(a), float(b), n_grid, dtype=DTYPE, device=x.device)
    f = kde_eval(grid, x, h, device=x.device)
    return x.shape[0] * torch.trapezoid(grid * f, grid)


def _halton(n: int, d: int) -> np.ndarray:
    """Deterministic quasi-MC nodes in the unit cube (for full-H boxes):
    float64 radical inverses in the first d primes, rounded to float32 — the
    reference's nodes, bit for bit."""
    primes = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37][:d]
    out = np.zeros((n, d))
    for k, p in enumerate(primes):
        rem = np.arange(1, n + 1).astype(np.float64)
        base = np.zeros(n)
        denom = p
        while rem.max() > 0:
            base += (rem % p) / denom
            rem = rem // p
            denom *= p
        out[:, k] = base
    return out.astype(np.float32)


def box_qmc_terms(x: torch.Tensor, H: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor, target: int = 0, n_qmc: int = 4096):
    """Full-matrix-H box integrals by deterministic quasi-MC, returning
    (count, sum_target) from one density evaluation on x's device:
    count = n vol mean(f), sum = n vol mean(node_t f)."""
    n, d = x.shape
    unit = torch.as_tensor(_halton(n_qmc, d), device=x.device)
    nodes = lo[None, :] + unit * (hi - lo)[None, :]
    f = kde_eval_H(nodes, x, H, device=x.device)
    vol = torch.prod(hi - lo)
    return n * vol * torch.mean(f), n * vol * torch.mean(nodes[:, target] * f)


def count_box_H(x: torch.Tensor, H: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, n_qmc: int = 4096) -> torch.Tensor:
    """Full-matrix-H COUNT over a box via quasi-Monte-Carlo on the box."""
    return box_qmc_terms(x, H, lo, hi, n_qmc=n_qmc)[0]


def sum_box_H(x: torch.Tensor, H: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor, target: int = 0, n_qmc: int = 4096) -> torch.Tensor:
    """Full-matrix-H SUM of axis `target` over a box (quasi-MC)."""
    return box_qmc_terms(x, H, lo, hi, target=target, n_qmc=n_qmc)[1]


@dataclass
class KDESynopsis:
    """A fitted density synopsis for one numeric column (or column set).

    `x` is the retained sample on the device.  `h` is a 0-d bandwidth for
    1-D synopses, or a (d,) diagonal bandwidth (one PLUGIN / silverman h per
    axis, the product-kernel form of eq. 11), or LSCV_h's 0-d h for any d;
    `H` is LSCV_H's full (d, d) bandwidth matrix.  Exactly one of `h` / `H`
    is set.
    """
    x: torch.Tensor
    h: Optional[torch.Tensor] = None
    H: Optional[torch.Tensor] = None
    n_source: int = 0
    selector: str = "plugin"

    @classmethod
    def fit(cls, data, selector: str = "plugin", max_sample: int = 4096,
            seed: int = 0, backend: Optional[str] = None,
            device: DeviceLike = None) -> "KDESynopsis":
        """Fit on `device` (default: the CUDA device) with `backend` (None:
        the device's default; the reference fits LSCV_H on its plain path
        whatever it is given).  Above `max_sample` rows a uniform subsample
        is drawn with a seeded torch.Generator — it cannot reproduce the
        reference's jax.random rows."""
        dev = resolve_device(device)
        backend = resolve_backend(backend, dev)
        with obs.span("synopsis.fit", backend=backend, selector=selector) as sp:
            data = torch.as_tensor(data, dtype=DTYPE, device=dev)
            sp.set(n=min(data.shape[0], max_sample),
                   d=1 if data.dim() == 1 else data.shape[1])
            return cls._fit(data, selector, max_sample, seed, backend, dev)

    @classmethod
    def _fit(cls, data: torch.Tensor, selector: str, max_sample: int, seed: int,
             backend: str, dev: torch.device) -> "KDESynopsis":
        n_source = data.shape[0]
        if n_source > max_sample:   # numerosity reduction (paper §2.1)
            gen = torch.Generator().manual_seed(seed)
            idx = torch.randperm(n_source, generator=gen)[:max_sample]
            sample = data[idx.to(dev)]
        else:
            sample = data
        if selector == "lscv_h":
            res = lscv_h(sample, backend=backend, device=dev)
            return cls(x=sample, h=res.h, n_source=n_source, selector=selector)
        if selector == "lscv_H":
            res = lscv_H(sample, backend=backend, device=dev)
            return cls(x=sample, H=res.H, n_source=n_source, selector=selector)
        if selector == "plugin":
            def fit_axis(col):
                return plugin_bandwidth(col, backend=backend, device=dev).h
        elif selector == "silverman":
            fit_axis = silverman_h
        else:
            raise ValueError(f"unknown selector {selector!r}")
        if sample.dim() == 1:
            h = fit_axis(sample)
        else:
            # the paper's selectors are univariate (§4.4): the multi-d
            # product kernel takes one h per axis
            h = torch.stack([fit_axis(sample[:, j].contiguous())
                             for j in range(sample.shape[1])])
        return cls(x=sample, h=h, n_source=n_source, selector=selector)

    # --- queries ----------------------------------------------------------
    def _scale(self) -> float:
        """Scale factor from retained sample to the full relation."""
        return self.n_source / self.x.shape[0]

    def _require_h(self) -> None:
        # the reference's 1-D closed forms and h_diag fail on a full-H
        # synopsis too (its h is None): only the box queries take H
        if self.H is not None:
            raise ValueError("a full-H (LSCV_H) synopsis has no scalar or "
                             "diagonal h; query it with count_box / sum_box")

    def count(self, a: float, b: float) -> torch.Tensor:
        self._require_h()
        if self.x.dim() == 1:
            return self._scale() * count_1d(self.x, self.h, a, b)
        raise ValueError("use count_box for multi-d synopses")

    def sum(self, a: float, b: float) -> torch.Tensor:
        self._require_h()
        if self.x.dim() == 1:
            return self._scale() * sum_1d(self.x, self.h, a, b)
        raise ValueError("1-D only")

    def avg(self, a: float, b: float) -> torch.Tensor:
        return _avg_or_zero(self.count(a, b), self.sum(a, b))

    def _as_rows(self) -> torch.Tensor:
        return self.x[:, None] if self.x.dim() == 1 else self.x

    def h_diag(self) -> torch.Tensor:
        """Per-axis bandwidth vector (a scalar h broadcast to every axis)."""
        self._require_h()
        d = self._as_rows().shape[1]
        return torch.broadcast_to(self.h.to(DTYPE), (d,)).contiguous()

    def _target_index(self, target) -> int:
        d = self._as_rows().shape[1]
        t = 0 if target is None else int(target)
        if not 0 <= t < d:
            raise ValueError(f"target axis {t} out of range for d={d}")
        return t

    def _box(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=DTYPE, device=self.x.device)

    def count_box(self, lo, hi) -> torch.Tensor:
        """COUNT over an axis-aligned box: eq. 11's product form under a
        scalar or diagonal h, quasi-MC under a full H."""
        x, lo, hi = self._as_rows(), self._box(lo), self._box(hi)
        if self.H is not None:
            return self._scale() * count_box_H(x, self.H, lo, hi)
        return self._scale() * count_box_diag(x, self.h_diag(), lo, hi)

    def sum_box(self, lo, hi, target: Optional[int] = None) -> torch.Tensor:
        """SUM of axis `target` (default axis 0) over an axis-aligned box."""
        x, lo, hi = self._as_rows(), self._box(lo), self._box(hi)
        t = self._target_index(target)
        if self.H is not None:
            return self._scale() * sum_box_H(x, self.H, lo, hi, target=t)
        return self._scale() * sum_box_diag(x, self.h_diag(), lo, hi, t)

    def avg_box(self, lo, hi, target: Optional[int] = None) -> torch.Tensor:
        return _avg_or_zero(self.count_box(lo, hi), self.sum_box(lo, hi, target))

    def merge(self, other: "KDESynopsis", max_sample: int = 4096,
              seed: int = 0) -> "KDESynopsis":
        """Union the retained samples and refit the bandwidth on the union,
        on this synopsis's device.  Above `max_sample` rows the union is
        subsampled as `fit` does, with a seeded torch.Generator: not the
        reference's jax.random rows."""
        merged = torch.cat([self.x, other.x], dim=0)
        out = KDESynopsis.fit(merged, selector=self.selector, max_sample=max_sample,
                              seed=seed, device=self.x.device)
        out.n_source = self.n_source + other.n_source
        return out

    def query_batch(self, queries: Sequence["Query"],
                    backend: Optional[str] = None) -> np.ndarray:
        """Answer COUNT / SUM / AVG range queries (`Query`, or its field
        tuples) in one batched pass."""
        queries = [q if isinstance(q, Query) else Query(*q) for q in queries]
        return run_legacy_queries(queries, self, backend=backend)

    def query_box_batch(self, queries, backend: Optional[str] = None) -> np.ndarray:
        """Answer COUNT / SUM / AVG box queries (`BoxQuery`, or its field
        tuples, eq. 11) in one batched pass."""
        from .aqp_multid import BoxQuery, run_legacy_boxes
        queries = [q if isinstance(q, BoxQuery) else BoxQuery(*q) for q in queries]
        return run_legacy_boxes(queries, self, backend=backend)


# --- batched closed forms -----------------------------------------------------

OP_COUNT, OP_SUM, OP_AVG = 0, 1, 2
OP_CODES = {"count": OP_COUNT, "sum": OP_SUM, "avg": OP_AVG}

# COUNT below this is an empty selection for AVG purposes (see _avg_or_zero).
AVG_MIN_COUNT = 1e-3


def _avg_or_zero(counts, sums):
    """AVG = SUM / COUNT, 0 for (effectively) empty selections, where the
    ratio is 0/0 noise amplified by 1/count."""
    return torch.where(counts > AVG_MIN_COUNT,
                       sums / torch.clamp_min(counts, 1e-12), 0.0)


def _select_op(ops, counts, sums):
    avgs = _avg_or_zero(counts, sums)
    return torch.where(ops == OP_COUNT, counts,
                       torch.where(ops == OP_SUM, sums, avgs))


def batch_query_1d(x: torch.Tensor, h: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, ops: torch.Tensor, scale: float,
                   backend: str = "torch") -> torch.Tensor:
    """Answer a mixed COUNT/SUM/AVG batch against one 1-D synopsis.
    x: (n,) sample; a/b/ops: (q,); scale: sample->relation factor.
    backend="cuda" runs the (queries x sample) reduction in the aqp_batch
    kernel, backend="torch" its plain version (`kernels/ref.py`)."""
    if backend == "cuda":
        from repro_torch.kernels import ops as kops
        cnt_raw, sum_raw = kops.aqp_batch_sums(x, h, a, b)
    else:
        cnt_raw, sum_raw = kref.aqp_batch_sums(x, h, a, b)
    return _select_op(ops, scale * cnt_raw, scale * sum_raw)


# --- the legacy 1-D surface -----------------------------------------------------
#
# `Query` / `QueryBatch` predate the declarative engine; `QueryBatch.run` is a
# deprecated shim that compiles to AqpQuery specs (`core/aqp_query.py`).

@dataclass(frozen=True)
class Query:
    """One aggregate range query: OP(column) WHERE a <= column <= b."""
    op: str                        # "count" | "sum" | "avg"
    a: float
    b: float
    column: Optional[str] = None   # None when run against a single synopsis

    def __post_init__(self):
        if self.op not in OP_CODES:
            raise ValueError(f"unknown op {self.op!r}; expected one of {sorted(OP_CODES)}")


@dataclass
class QueryBatch:
    """A heterogeneous batch of legacy queries, grouped by column.  The
    reference's `plan` (device arrays for its old jitted pass) has no
    counterpart: the engine plans."""
    queries: Sequence[Query]
    _groups: Dict[Optional[str], List[int]] = field(init=False, repr=False)

    def __post_init__(self):
        self.queries = [q if isinstance(q, Query) else Query(*q) for q in self.queries]
        groups: Dict[Optional[str], List[int]] = {}
        for i, q in enumerate(self.queries):
            groups.setdefault(q.column, []).append(i)
        self._groups = groups

    def __len__(self) -> int:
        return len(self.queries)

    @property
    def columns(self) -> List[Optional[str]]:
        return list(self._groups)

    def run(self, synopses, backend: Optional[str] = None) -> np.ndarray:
        """Deprecated: compiles to AqpQuery specs and executes them through
        the engine; answers in submission order."""
        import warnings

        warnings.warn(
            "QueryBatch.run is deprecated; build AqpQuery specs and execute "
            "them through repro_torch.core.aqp_query.QueryEngine (or "
            "TelemetryStore.query)", DeprecationWarning, stacklevel=2)
        return run_legacy_queries(self.queries, synopses, backend=backend)


def run_legacy_queries(queries: Sequence[Query], synopses,
                       backend: Optional[str] = None) -> np.ndarray:
    """Execute legacy `Query` objects through the engine against a synopsis
    or a {column: synopsis} mapping (the body of `QueryBatch.run` and
    `KDESynopsis.query_batch`)."""
    from .aqp_query import execute_specs, from_query
    return execute_specs([from_query(q) for q in queries], synopses, backend=backend)
