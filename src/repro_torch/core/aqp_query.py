"""Declarative AQP queries and the engine that answers them.
Counterpart: `repro/core/aqp_query.py`.

  `AqpQuery`    — COUNT/SUM/AVG under a conjunction of predicate terms:
      Range(column, a, b)   a <= column <= b        (eqs. 9-10 closed forms)
      Box(columns, lo, hi)  axis-aligned box        (eq. 11 product kernel)
      Eq(column, value)     dictionary/categorical equality (code +- 1/2)
  `QueryEngine` — normalizes a heterogeneous batch against a
                  `TelemetryStore`, groups it by (column tuple, selector) and
                  answers each group in one batched pass:

      path         synopsis               pass
      -----------  ---------------------  ---------------------------------
      exact        categorical sketch     per-code counts, zero-width CI
      exact:cm     count-min sketch       bounded-error counts, the CI of the
                                          over-count bound
      range1d      1-D sample, scalar h   closed forms (`batch_query_1d`;
                                          the aqp_batch kernel on ":cuda")
      box          rows, diagonal h       eq. 11 (`batch_query_box`; the
                                          aqp_boxes kernel on ":cuda")
      box:grouped  rows, diagonal h       one GROUP BY family in a factored
                                          pass (`batch_query_box_grouped`;
                                          the aqp_grouped kernel on ":cuda")
      qmc          rows, full H           quasi-MC on shared Halton nodes,
                                          one exact density pass per group
                                          (`batch_query_qmc`; the qmc_reduce
                                          kernel on ":cuda")
      qmc:rff      rows, full H           the same nodes, densities from a
                                          fitted RFF synopsis (the rff_eval
                                          kernel on the card)

  `AqpResult`   — estimate, path, confidence interval, synopsis version.

Synopses of every selector plan onto these paths: PLUGIN and silverman fits
with their per-axis h, LSCV_h fits with one h broadcast to every axis, and
LSCV_H fits (a full H, 1-D columns included) onto `qmc`.  A full-H group's
density backend is `kde_backend`: "exact", "rff", or "auto", which takes
RFF from KDE_CROSSOVER sample rows up.  The reference reads the crossover
and the RFF feature count from environment knobs; here they are the module
constants KDE_CROSSOVER and DEFAULT_RFF_FEATURES, with QueryEngine keywords
`kde_crossover` and `rff_features`.

Tiered reservoirs: a `tier` budget resolves each group against one tier of
a `TieredReservoir` (its own synopsis, plan and cache entries), and
`QueryEngine.progressive` answers tier by tier up to the full sample, whose
round is bit-identical to `execute`.  `execute_specs` and the legacy
`Query` / `BoxQuery` bridges run against bare synopses or a mapping of them.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_backend

from .aqp import (OP_CODES, OP_COUNT, OP_SUM, KDESynopsis, _select_op,
                  batch_query_1d, canonical_selector)
from .aqp_ci import (DEFAULT_CI_LEVEL, box_answers_and_se, moments_1d,
                     moments_box, norm_ppf, qmc_answers_and_se, qmc_subsample_se,
                     range_answers_and_se, se_from_moments, t_ppf)
from .aqp_multid import (batch_query_box, batch_query_box_grouped,
                         batch_query_qmc, batch_query_qmc_rff,
                         grouped_family_moments, qmc_rff_answers_and_se,
                         qmc_rff_se)
from .kde import kde_eval_H

ColumnKey = Union[None, str, Tuple[str, ...]]

EQ_HALFWIDTH = 0.5   # dictionary codes are unit-spaced: `== v` is v +- 1/2
WIDE = 1e30          # "unconstrained axis": Phi saturates to {0,1}, phi to 0

# --- density backends of the full-H path --------------------------------------
#
# "exact" evaluates eq. 6 against the whole sample (O(n) per node); "rff" a
# fitted random-Fourier-feature synopsis (O(D) per node after an O(n D) fit
# per reservoir version); "auto" takes RFF from KDE_CROSSOVER sample rows up.
KDE_BACKENDS = ("auto", "exact", "rff")
KDE_CROSSOVER = 16384
DEFAULT_RFF_FEATURES = 2048
# one-shot accuracy gate at fit time: mean relative density error on probe
# points from the fitted sample; above the tolerance the fit is cached as
# degraded and its group answers on the exact pass
RFF_GATE_PROBES = 32
RFF_GATE_TOL = 0.15


def _resolve_kde_backend(requested: Optional[str], default: str, n: int,
                         crossover: int = KDE_CROSSOVER) -> str:
    name = requested or default or "auto"
    if name == "auto":
        return "rff" if n >= crossover else "exact"
    return name


def _rff_cache_key(col, n_features: int):
    """SynopsisCache column key of a fitted RFF synopsis: suffixed, so it
    sits beside the group's exact synopsis entry."""
    if isinstance(col, tuple):
        return col + (f"#rff{n_features}",)
    return f"{col}#rff{n_features}"


# --- tier addressing (TieredReservoir, repro_torch.data.aqp_store) ----------

def _effective_tier(res, tier: Optional[int]) -> Optional[int]:
    """Normalize a tier request against a reservoir: None, any request
    against a plain reservoir, and a request for the top tier of a
    `TieredReservoir` all mean the full sample (None), so full-accuracy
    requests share cache keys and plans with untiered execution."""
    n_tiers = getattr(res, "n_tiers", None)
    if tier is None or n_tiers is None:
        return None
    t = max(0, min(int(tier), n_tiers - 1))
    return None if t >= n_tiers - 1 else t


def _tier_key(col, tier: Optional[int]):
    """A synopsis-cache column key suffixed with the tier, so a tier's
    synopsis sits beside the full sample's entry."""
    if tier is None:
        return col
    if isinstance(col, tuple):
        return col + (f"#tier{tier}",)
    return f"{col}#tier{tier}"


# --- predicate terms --------------------------------------------------------

@dataclass(frozen=True)
class Range:
    """a <= column <= b.  `column=None` addresses a bare (unnamed) synopsis."""
    column: Optional[str]
    a: float
    b: float

    def __post_init__(self):
        object.__setattr__(self, "a", float(self.a))
        object.__setattr__(self, "b", float(self.b))


@dataclass(frozen=True)
class Eq:
    """Dictionary/categorical equality: column == value.

    Dictionary-coded columns hold unit-spaced numeric codes, so equality is
    the range [value - halfwidth, value + halfwidth] over the code axis — the
    KDE mass the synopsis assigns to that code's bucket.
    """
    column: Optional[str]
    value: float
    halfwidth: float = EQ_HALFWIDTH

    def __post_init__(self):
        object.__setattr__(self, "value", float(self.value))
        object.__setattr__(self, "halfwidth", float(self.halfwidth))
        if self.halfwidth <= 0:
            raise ValueError(f"Eq halfwidth must be positive, got {self.halfwidth}")


@dataclass(frozen=True)
class Box:
    """Axis-aligned box: lo_j <= columns_j <= hi_j.  `columns=None` addresses
    the positional axes of a bare (unnamed) multi-d synopsis."""
    columns: Optional[Tuple[str, ...]]
    lo: Tuple[float, ...]
    hi: Tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(self, "lo", tuple(float(v) for v in np.ravel(self.lo)))
        object.__setattr__(self, "hi", tuple(float(v) for v in np.ravel(self.hi)))
        if len(self.lo) != len(self.hi):
            raise ValueError(f"lo/hi dimensionality mismatch: "
                             f"{len(self.lo)} vs {len(self.hi)}")
        if self.columns is not None:
            object.__setattr__(self, "columns", tuple(self.columns))
            if len(self.columns) != len(self.lo):
                raise ValueError(f"box has {len(self.lo)} axes but names "
                                 f"{len(self.columns)} columns")


Predicate = Union[Range, Box, Eq]


@dataclass(frozen=True)
class GroupBy:
    """GROUP BY over a dictionary column.  `values=None` discovers the code
    set from the store's reservoir sample at execution time."""
    column: str
    values: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.values is not None:
            object.__setattr__(self, "values",
                               tuple(float(v) for v in self.values))


@dataclass(frozen=True)
class AqpQuery:
    """One declarative aggregate: COUNT/SUM/AVG of `target` under the
    conjunction of `predicates`, optionally per `group_by` category.

    `selector` overrides the engine's bandwidth selector for this query only
    (the engine groups by (columns, selector)).  `kde_backend` overrides the
    engine's density backend for this query only ("auto" | "exact" |
    "rff"); only the full-H (qmc) path reads it.
    """
    aggregate: str                               # "count" | "sum" | "avg"
    predicates: Tuple[Predicate, ...] = ()
    target: Optional[Union[str, int]] = None     # SUM/AVG column (or axis)
    group_by: Optional[Union[str, "GroupBy"]] = None
    selector: Optional[str] = None               # per-query selector override
    kde_backend: Optional[str] = None            # per-query density backend

    def __post_init__(self):
        agg = str(self.aggregate).lower()
        if agg not in OP_CODES:
            raise ValueError(f"unknown aggregate {self.aggregate!r}; "
                             f"expected one of {sorted(OP_CODES)}")
        object.__setattr__(self, "aggregate", agg)
        if self.kde_backend is not None:
            kb = str(self.kde_backend).lower()
            if kb not in KDE_BACKENDS:
                raise ValueError(f"unknown kde_backend {self.kde_backend!r}; "
                                 f"expected one of {KDE_BACKENDS}")
            object.__setattr__(self, "kde_backend", kb)
        preds = self.predicates
        if isinstance(preds, (Range, Box, Eq)):
            preds = (preds,)
        preds = tuple(preds)
        for p in preds:
            if not isinstance(p, (Range, Box, Eq)):
                raise TypeError(f"predicate terms must be Range/Box/Eq, "
                                f"got {type(p).__name__}")
        object.__setattr__(self, "predicates", preds)
        if isinstance(self.group_by, str):
            object.__setattr__(self, "group_by", GroupBy(self.group_by))
        if self.group_by is not None and not isinstance(self.group_by, GroupBy):
            raise TypeError("group_by must be a column name or GroupBy")
        if agg == "count":
            if self.target is not None:
                raise ValueError("COUNT takes no target column")
            if not preds and self.group_by is None:
                raise ValueError("COUNT needs at least one predicate term")
        elif not preds and self.target is None:
            raise ValueError("SUM/AVG needs a predicate term or a target column")


@dataclass(frozen=True)
class AqpResult:
    """One answered aggregate.

    estimate         — the approximate answer
    path             — "range1d" | "box" | "box:grouped" | "qmc" | "exact",
                       with a ":cuda" suffix when the hand-written kernels
                       ran the KDE pass, or "qmc:rff" when the full-H
                       densities came from the RFF synopsis
    ci_lo / ci_hi    — confidence interval at `ci_level`: analytic
                       product-kernel variance on range1d / box /
                       box:grouped, subsample batch-means on qmc, feature-
                       block batch-means on qmc:rff, zero width on exact.
                       Infinite endpoints mean no finite bound (AVG over an
                       effectively empty selection).
    ci_level         — nominal coverage of [ci_lo, ci_hi] (default 0.95)
    n_effective      — rows behind the answer: the retained sample size on
                       the KDE paths, the sketch's row count on exact
    rel_width        — deprecated accuracy proxy (narrowest constrained axis
                       in bandwidths); 0.0 on exact, inf when unconstrained
    synopsis_version — reservoir version of the synopsis that answered it
    group            — group_by category code (None outside GROUP BY)
    query            — the originating AqpQuery spec
    """
    estimate: float
    path: str
    rel_width: float
    synopsis_version: int
    group: Optional[float] = None
    query: Optional[AqpQuery] = None
    ci_lo: float = float("nan")
    ci_hi: float = float("nan")
    ci_level: float = DEFAULT_CI_LEVEL
    n_effective: int = 0

    @property
    def ci_width(self) -> float:
        return self.ci_hi - self.ci_lo

    def __float__(self) -> float:
        return self.estimate


# --- normalization: AqpQuery -> one axis-aligned box per (sub-)query --------

@dataclass
class _Compiled:
    """One execution unit: an axis-aligned box (possibly with wide, i.e.
    unconstrained, axes) plus the aggregate opcode and target axis."""
    slot: int                            # output row
    query: AqpQuery
    group: Optional[float]
    cols: Optional[Tuple[str, ...]]      # None -> positional (bare synopsis)
    lo: List[float]
    hi: List[float]
    constrained: List[bool]              # wide target fills are False
    op: int
    tgt: int
    selector: Optional[str]
    all_eq: bool = False                 # every interval is a code window
    group_axis: Optional[int] = None     # axis of the group_by column
    kde_backend: Optional[str] = None    # per-query density backend


def _compile(query: AqpQuery, slot: int,
             group_value: Optional[float] = None) -> _Compiled:
    """Normalize one query (plus its group term) to a canonical box: terms
    merge per column by interval intersection, SUM/AVG targets outside the
    predicate columns get a wide (unconstrained) axis."""
    intervals: "Dict[Union[str, int], List]" = {}
    eq_only: "Dict[Union[str, int], bool]" = {}
    named: Optional[bool] = None

    def add(key, lo_v, hi_v, is_named, is_eq=False):
        nonlocal named
        if named is None:
            named = is_named
        elif named != is_named:
            raise ValueError("cannot mix named and positional (column=None) "
                             "predicate terms in one AqpQuery")
        eq_only[key] = eq_only.get(key, True) and is_eq
        ent = intervals.get(key)
        if ent is None:
            intervals[key] = [float(lo_v), float(hi_v), True]
        else:
            ent[0] = max(ent[0], float(lo_v))
            ent[1] = min(ent[1], float(hi_v))
            if ent[1] < ent[0]:           # empty conjunction -> zero measure
                ent[1] = ent[0]

    for p in query.predicates:
        if isinstance(p, Range):
            add(p.column if p.column is not None else 0, p.a, p.b,
                p.column is not None)
        elif isinstance(p, Eq):
            add(p.column if p.column is not None else 0,
                p.value - p.halfwidth, p.value + p.halfwidth,
                p.column is not None, is_eq=True)
        else:
            if p.columns is None:
                for j, (lo_v, hi_v) in enumerate(zip(p.lo, p.hi)):
                    add(j, lo_v, hi_v, False)
            else:
                for c, lo_v, hi_v in zip(p.columns, p.lo, p.hi):
                    add(c, lo_v, hi_v, True)

    # Implicit-target resolution runs BEFORE the group term is appended:
    # "SUM(b) WHERE ... GROUP BY code" has one predicate column even though
    # the executed box gains the code axis.
    tgt = 0
    if query.aggregate in ("sum", "avg"):
        t = query.target
        if t is None:
            if len(intervals) != 1:
                raise ValueError("SUM/AVG needs an explicit target unless "
                                 "exactly one predicate column is given")
        elif isinstance(t, bool):
            raise TypeError("target must be a column name or axis index")
        elif isinstance(t, (int, np.integer)):
            if not 0 <= int(t) < len(intervals):
                raise ValueError(f"target axis {t} out of range for "
                                 f"d={len(intervals)}")
            tgt = int(t)
        else:
            if named is False:
                raise ValueError("a string target needs named predicate "
                                 "columns")
            if t not in intervals:
                named = True
                intervals[t] = [-WIDE, WIDE, False]
                eq_only[t] = False
            tgt = list(intervals).index(t)

    if group_value is not None:
        g = query.group_by
        # the group term is a dictionary-code window, i.e. an Eq term
        add(g.column, group_value - EQ_HALFWIDTH, group_value + EQ_HALFWIDTH,
            True, is_eq=True)

    if named is False:
        keys = sorted(intervals)
        if keys != list(range(len(keys))):
            raise ValueError(f"positional predicate axes must be contiguous "
                             f"from 0, got {keys}")
        items = [(k, intervals[k]) for k in keys]
        cols = None
    else:
        items = list(intervals.items())
        cols = tuple(k for k, _ in items)
    group_axis = None
    if group_value is not None and cols is not None:
        group_axis = cols.index(query.group_by.column)
    return _Compiled(
        slot=slot, query=query, group=group_value, cols=cols,
        lo=[e[0] for _, e in items], hi=[e[1] for _, e in items],
        constrained=[e[2] for _, e in items], op=OP_CODES[query.aggregate],
        tgt=tgt, selector=query.selector,
        all_eq=all(eq_only[k] for k, _ in items), group_axis=group_axis,
        kde_backend=query.kde_backend)


def _reorder(c: _Compiled, new_cols: Tuple[str, ...]) -> _Compiled:
    """Permute a compiled box to a tracked joint's axis order."""
    perm = [c.cols.index(col) for col in new_cols]
    return _Compiled(
        slot=c.slot, query=c.query, group=c.group, cols=new_cols,
        lo=[c.lo[j] for j in perm], hi=[c.hi[j] for j in perm],
        constrained=[c.constrained[j] for j in perm], op=c.op,
        tgt=perm.index(c.tgt), selector=c.selector, all_eq=c.all_eq,
        group_axis=None if c.group_axis is None else perm.index(c.group_axis),
        kde_backend=c.kde_backend)


# --- group plans and synopsis resolution ------------------------------------

@dataclass
class _GroupPlan:
    """Execution plan for one (column tuple, selector) group: the resolved
    synopsis, its path, per-axis bandwidths for the accuracy proxy and the
    sample->relation scale.  Cached keyed on the synopsis version."""
    syn: KDESynopsis
    kind: str                 # "range1d" | "box" | "qmc"
    h_axes: np.ndarray
    scale: float

    @property
    def x_rows(self) -> torch.Tensor:
        return self.syn.x[:, None] if self.syn.x.dim() == 1 else self.syn.x


def _make_plan(syn: KDESynopsis) -> _GroupPlan:
    if syn.H is not None:
        kind = "qmc"
        h_axes = np.sqrt(np.diag(syn.H.detach().cpu().numpy().astype(np.float64)))
    else:
        kind = "range1d" if syn.x.dim() == 1 else "box"
        h_axes = syn.h_diag().detach().cpu().numpy().astype(np.float64)
    return _GroupPlan(syn=syn, kind=kind, h_axes=h_axes,
                      scale=syn.n_source / syn.x.shape[0])


class PlanCache:
    """Version-keyed memo of `_GroupPlan`s, owned by a QueryEngine: an entry
    whose version differs from the reservoir's current one misses."""

    def __init__(self):
        self._entries: Dict[object, Tuple[int, _GroupPlan]] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key, version: int) -> Optional[_GroupPlan]:
        ent = self._entries.get(key)
        if ent is not None and ent[0] == version:
            self.hits += 1
            return ent[1]
        self.misses += 1
        return None

    def put(self, key, version: int, plan: _GroupPlan) -> None:
        self._entries[key] = (version, plan)

    def entries(self) -> List[Tuple[object, int]]:
        """[(key, version)] of every live entry."""
        return [(key, version) for key, (version, _plan) in self._entries.items()]

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries)}


class _StoreResolver:
    """Maps a compiled query to (group key, plan, version) against a
    TelemetryStore: single columns use the per-column reservoirs, multi-column
    boxes match a tracked joint (exact tuple first, then by column set,
    reordering the box to the joint's axis order).  Fits run on `backend`;
    RFF density synopses have `rff_features` features.

    `tier` (a `TieredReservoir` tier, None for the full sample) rides in the
    group key (column, selector, tier), so a coarse round and a full round
    over one column resolve to their own plans and synopses; plans are
    cached under (group key, backend)."""

    def __init__(self, store, selector: str, backend: str,
                 plans: Optional[PlanCache] = None,
                 rff_features: int = DEFAULT_RFF_FEATURES,
                 tier: Optional[int] = None):
        self.store = store
        self.selector = selector
        self.backend = backend
        self.plans = plans
        self.rff_features = rff_features
        self.tier = tier

    def key_for(self, c: _Compiled):
        """(group key, reordered compiled, reservoir version) — no fitting."""
        sel = canonical_selector(c.selector or self.selector)
        if c.cols is None:
            raise ValueError("every query must name a column when running "
                             "against a TelemetryStore")
        if len(c.cols) == 1:
            col = c.cols[0]
            res = self.store.columns.get(col)
            if res is None:
                raise KeyError(f"unknown column {col!r}; "
                               f"have {sorted(self.store.columns)}")
            return (col, sel, _effective_tier(res, self.tier)), c, res.version
        cols = c.cols
        joints = self.store.joints
        if cols not in joints:
            match = next((k for k in joints if set(k) == set(cols)), None)
            if match is not None:
                c = _reorder(c, match)
                cols = match
            else:
                raise KeyError(f"no joint reservoir for columns {cols!r}; "
                               f"call track_joint({cols!r}) before add_batch "
                               f"(have {sorted(joints)})")
        res = joints[cols]
        return (cols, sel, _effective_tier(res, self.tier)), c, res.version

    def plan_for(self, key, version: int) -> _GroupPlan:
        """Fit-or-fetch the group's plan for the given reservoir version;
        plans, like fits, are kept per backend."""
        if self.plans is not None:
            plan = self.plans.get((key, self.backend), version)
            if plan is not None:
                return plan
        col, sel, tier = key
        if isinstance(col, tuple):
            syn = self.store.joint_synopsis(col, sel, backend=self.backend, tier=tier)
        else:
            syn = self.store.synopsis(col, sel, backend=self.backend, tier=tier)
        plan = _make_plan(syn)
        if self.plans is not None:
            self.plans.put((key, self.backend), version, plan)
        return plan

    def __call__(self, c: _Compiled):
        key, c2, version = self.key_for(c)
        return key, c2, self.plan_for(key, version), version

    def density_for(self, key, version: int, plan: _GroupPlan):
        """Fit-or-fetch the RFF density synopsis of a resolved full-H group;
        the fitted `RFFSynopsis`, or None for the exact pass.

        Fits live in the store's SynopsisCache beside the group's exact
        synopsis, keyed (column#rffD, selector, backend) and invalidated by
        version like every entry.  A fit that fails the one-shot probe gate
        (mean relative density error on the first RFF_GATE_PROBES sample
        rows, against eq. 6) is cached degraded, so it is not refitted, and
        this returns None for it ever after."""
        from repro_torch.synopses import RFFSynopsis

        col, sel, tier = key
        syn = plan.syn
        if syn.H is None:
            return None
        ckey = _rff_cache_key(_tier_key(col, tier), self.rff_features)
        cache = self.store.cache
        hit = cache.get(ckey, sel, version, backend=self.backend)
        if hit is not None:
            return None if hit.degraded else hit
        x = plan.x_rows
        # the seed is a function of the (column, selector) identity, so a
        # refit after a version bump draws the same frequencies
        seed = zlib.crc32(repr((ckey, sel)).encode()) & 0x7FFFFFFF
        rff = RFFSynopsis.fit(x, syn.H, n_features=self.rff_features, seed=seed)
        probes = x[:RFF_GATE_PROBES]
        f_exact = np.asarray(kde_eval_H(probes, x, syn.H, device=x.device).cpu(),
                             np.float64)
        f_rff = np.asarray(rff.eval_batch(probes).cpu(), np.float64)
        denom = max(float(np.mean(f_exact)), 1e-300)
        rff.probe_rel_err = float(np.mean(np.abs(f_rff - f_exact)) / denom)
        rff.degraded = rff.probe_rel_err > RFF_GATE_TOL
        rff.n_source = syn.n_source
        rff.selector = sel
        cache.put(ckey, sel, version, rff, backend=self.backend)
        return None if rff.degraded else rff

    def try_exact(self, c: _Compiled):
        """Sketch answer for an all-Eq single-column query when the column's
        sketch covers its whole stream: (estimate, version, path, ci_lo,
        ci_hi, n_effective), or None for the KDE path.  A `CategoricalSketch`
        answers on "exact" with a zero-width CI; a `CountMinSketch` on
        "exact:cm" with the CI of its deterministic over-count bound
        (one-sided for COUNT, asymmetric for SUM), or None when its window
        is too wide to enumerate or the stream went off its grid."""
        if not c.all_eq or c.cols is None or len(c.cols) != 1:
            return None
        col = c.cols[0]
        sketch = self.store.categoricals.get(col)
        res = self.store.columns.get(col)
        if sketch is None or res is None or not sketch.exact_for(res.n_seen):
            return None
        terms = sketch.range_terms(c.lo[0], c.hi[0])
        if terms is None:
            return None
        cnt, sm = terms
        if c.op == OP_COUNT:
            est = float(cnt)
        elif c.op == OP_SUM:
            est = float(sm)
        else:
            est = float(sm / cnt) if cnt > 0 else 0.0
        n_eff = int(sketch.n_rows)
        range_err = getattr(sketch, "range_err", None)
        if range_err is None:
            return est, res.version, sketch.path, est, est, n_eff
        err = range_err(c.lo[0], c.hi[0])
        if err is None:
            return None
        cnt_err, sum_pos, sum_neg = err
        if c.op == OP_COUNT:
            ci_lo, ci_hi = max(0.0, est - cnt_err), est
        elif c.op == OP_SUM:
            # over-counted positive codes inflate the sum, negative ones
            # deflate it
            ci_lo, ci_hi = sm - sum_pos, sm + sum_neg
        elif cnt <= 0:
            ci_lo, ci_hi = -float("inf"), float("inf")
        else:
            nums = (sm - sum_pos, sm + sum_neg)
            dens = [d for d in (float(cnt), float(max(0, cnt - cnt_err))) if d > 0]
            ratios = [n / d for n in nums for d in dens]
            ci_lo, ci_hi = min(ratios), max(ratios)
        return est, res.version, sketch.path, ci_lo, ci_hi, n_eff


class _MappingResolver:
    """Resolution against a bare synopsis or a {column(s): synopsis}
    mapping, the legacy context (no store, no versions), on `backend`."""

    def __init__(self, synopses, backend: str):
        self.synopses = synopses
        self.backend = backend
        self._plans: Dict[int, _GroupPlan] = {}   # keyed on synopsis identity

    def _plan(self, syn: KDESynopsis) -> _GroupPlan:
        plan = self._plans.get(id(syn))
        if plan is None:
            plan = self._plans[id(syn)] = _make_plan(syn)
        return plan

    def __call__(self, c: _Compiled):
        d = len(c.lo)
        if isinstance(self.synopses, KDESynopsis):
            if c.cols is not None:
                noun = "column" if d == 1 else "columns"
                raise ValueError(f"queries name columns but a single synopsis "
                                 f"was given; pass a {{{noun}: synopsis}} "
                                 f"mapping")
            return None, c, self._plan(self.synopses), 0
        if c.cols is None:
            if d == 1:
                raise ValueError("queries must name a column when running "
                                 "against a synopsis mapping")
            raise ValueError("queries must name their columns when running "
                             "against a synopsis mapping")
        key = c.cols[0] if len(c.cols) == 1 else c.cols
        if key not in self.synopses:
            have = sorted(self.synopses, key=str)
            if len(c.cols) == 1:
                raise KeyError(f"no synopsis for column {key!r}; have {have}")
            raise KeyError(f"no joint synopsis for columns {key!r}; "
                           f"have {have}")
        return key, c, self._plan(self.synopses[key]), 0


# --- execution --------------------------------------------------------------

def _rel_width(c: _Compiled, h_axes: np.ndarray) -> float:
    widths = [(hi - lo) / h for lo, hi, k, h
              in zip(c.lo, c.hi, c.constrained, h_axes) if k]
    return float(min(widths)) if widths else float("inf")


# Batch shapes are quantized as in the reference: small batches round up to
# the next power of two (floor 8), larger ones to the next multiple of 64;
# padded rows repeat the last real row and are sliced off after the pass.
_PAD_STEP = 64


def _pad_count(n: int) -> int:
    if n >= _PAD_STEP:
        return -(-n // _PAD_STEP) * _PAD_STEP
    return max(8, 1 << max(n - 1, 0).bit_length())


def _pad_rows(arr: np.ndarray, m: int) -> np.ndarray:
    pad = m - arr.shape[0]
    if pad <= 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])


def _run_group(key, plan: _GroupPlan, entries: List[_Compiled],
               backend: str, n_qmc: int = 4096,
               ci_level: float = DEFAULT_CI_LEVEL, kde_backend: str = "auto",
               rff=None, kde_crossover: int = KDE_CROSSOVER
               ) -> List[Tuple[float, str, float, float, int]]:
    """Answer one resolved group in batched passes; returns one
    (estimate, path label, ci_lo, ci_hi, n_effective) per entry, in entry
    order.  On the "torch" backend the CI comes from a separate pass
    (moments, or batch-means on the full-H paths); on the "cuda" backend
    every group's CI sums come from the estimate's own launch: a range or
    box group's moment sums, a full-H group's batch-means chunks, the GROUP
    BY families' moment sums and an RFF group's feature blocks.

    GROUP BY families — entries expanded from one query that differ only on
    the group column's code window — are peeled off onto the factored
    grouped pass when the group runs the diagonal-bandwidth box path.
    Full-H entries whose density backend resolves to "rff" take the RFF
    pass when a fitted, non-degraded synopsis is given (`rff`); every other
    full-H entry takes the exact pass."""
    syn = plan.syn
    x = plan.x_rows
    d_syn = x.shape[1]
    for c in entries:
        if len(c.lo) != d_syn:
            if len(c.lo) == 1:
                raise ValueError(
                    "multi-dimensional synopses answer box predicates, "
                    "not scalar ranges; add one term per axis")
            raise ValueError(f"synopsis for {key} is {d_syn}-d but its "
                             f"queries are {len(c.lo)}-d boxes")

    families: List[List[_Compiled]] = []
    rest: List[_Compiled] = []
    if plan.kind == "box":
        by_query: Dict[int, List[_Compiled]] = {}
        for c in entries:
            if c.group is not None and c.group_axis is not None:
                by_query.setdefault(id(c.query), []).append(c)
            else:
                rest.append(c)
        for fam in by_query.values():
            if len(fam) >= 2:
                families.append(fam)
            else:
                rest.extend(fam)
    else:
        rest = list(entries)

    dev = x.device
    n_eff = int(x.shape[0])
    p = 0.5 + ci_level / 2.0
    suffix = "" if backend == "torch" else f":{backend}"

    rff_entries: List[_Compiled] = []
    if plan.kind == "qmc" and rff is not None:
        exact: List[_Compiled] = []
        for c in rest:
            if _resolve_kde_backend(c.kde_backend, kde_backend, n_eff,
                                    kde_crossover) == "rff":
                rff_entries.append(c)
            else:
                exact.append(c)
        rest = exact

    out: Dict[int, Tuple[float, str, float, float, int]] = {}

    def emit(group, ans, se, q_ci, path):
        ans_np = ans.detach().cpu().numpy().astype(np.float64)
        for c, est, s in zip(group, ans_np, np.asarray(se, np.float64)):
            est = float(est)
            out[id(c)] = (est, path, est - q_ci * s, est + q_ci * s, n_eff)

    def padded(group, m):
        """(ops, lo, hi, tgt) host arrays of a group padded to m rows."""
        return (_pad_rows(np.asarray([c.op for c in group], np.int32), m),
                _pad_rows(np.asarray([c.lo for c in group], np.float64), m),
                _pad_rows(np.asarray([c.hi for c in group], np.float64), m),
                _pad_rows(np.asarray([c.tgt for c in group], np.int32), m))

    def on_dev(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    if rest:
        n = len(rest)
        ops_np, lo, hi, tgt = padded(rest, _pad_count(n))
        if plan.kind == "qmc":
            path = "qmc" + suffix
            if backend == "cuda":
                # one plan and one launch: the estimate and its K CI chunks
                ans, se, dof = qmc_answers_and_se(x, syn.H, lo, hi, tgt, ops_np,
                                                  plan.scale, syn.n_source, n_qmc)
            else:
                ans = batch_query_qmc(x, syn.H, lo, hi, tgt, ops_np, plan.scale,
                                      n_qmc=n_qmc, backend=backend)
                se, dof = qmc_subsample_se(x, syn.H, lo, hi, tgt, ops_np,
                                           syn.n_source, n_qmc, backend=backend)
            q_ci = t_ppf(p, dof)
        elif plan.kind == "range1d":
            a, b = on_dev(lo[:, 0]), on_dev(hi[:, 0])
            path = "range1d" + suffix
            if backend == "cuda":
                # one launch: the estimate's sums and the CI's
                ans, se = range_answers_and_se(syn.x, syn.h, a, b, ops_np, plan.scale,
                                               n_eff)
            else:
                ans = batch_query_1d(syn.x, syn.h, a, b, on_dev(ops_np, np.int32),
                                     plan.scale, backend=backend)
                se = se_from_moments(ops_np, moments_1d(syn.x, syn.h, a, b),
                                     plan.scale, n_eff)
            q_ci = norm_ppf(p)
        else:
            lo_t, hi_t, tgt_t = on_dev(lo), on_dev(hi), on_dev(tgt, np.int32)
            path = "box" + suffix
            h_diag = syn.h_diag()
            if backend == "cuda":
                # one launch: the estimate's sums and the CI's
                ans, se = box_answers_and_se(x, h_diag, lo_t, hi_t, tgt_t, ops_np,
                                             plan.scale, n_eff)
            else:
                ans = batch_query_box(x, h_diag, lo_t, hi_t, tgt_t,
                                      on_dev(ops_np, np.int32), plan.scale,
                                      backend=backend)
                se = se_from_moments(ops_np, moments_box(x, h_diag, lo_t, hi_t, tgt_t),
                                     plan.scale, n_eff)
            q_ci = norm_ppf(p)
        emit(rest, ans[:n], se[:n], q_ci, path)

    if rff_entries:
        n = len(rff_entries)
        ops_np, lo, hi, tgt = padded(rff_entries, _pad_count(n))
        # feature-block batch-means: the exact path's sample-chunk CI would
        # cost the O(n) pass this backend avoids
        if backend == "cuda":
            # one plan and one launch: the density and its feature blocks
            ans, se, dof = qmc_rff_answers_and_se(rff, x, syn.H, lo, hi, tgt, ops_np,
                                                  plan.scale, syn.n_source, n_qmc)
        else:
            ans = batch_query_qmc_rff(x, syn.H, rff, lo, hi, tgt, ops_np,
                                      plan.scale, n_qmc=n_qmc)
            se, dof = qmc_rff_se(rff, x, syn.H, lo, hi, tgt, ops_np, syn.n_source,
                                 n_qmc)
        emit(rff_entries, ans[:n], se[:n], t_ppf(p, dof), "qmc:rff")

    if families and backend == "cuda":
        # every family in one launch of the aqp_grouped kernel, whose five
        # moment sums give each category's estimate and CI (no moment pass)
        g_axes = [fam[0].group_axis for fam in families]
        five = grouped_family_moments(
            x, syn.h_diag(), [(fam[0].lo, fam[0].hi) for fam in families],
            [([c.lo[g] for c in fam], [c.hi[g] for c in fam])
             for fam, g in zip(families, g_axes)],
            g_axes, [fam[0].tgt for fam in families])
        fam_ops = np.asarray([fam[0].op for fam in families], np.int32)[:, None]
        ans = _select_op(torch.as_tensor(fam_ops), plan.scale * five[:, 0],
                         plan.scale * five[:, 1])
        se = se_from_moments(np.broadcast_to(fam_ops, ans.shape), five.unbind(1),
                             plan.scale, n_eff)
        for fam, a, s in zip(families, ans, se):
            emit(fam, a[:len(fam)], s[:len(fam)], norm_ppf(p), "box:grouped" + suffix)
    else:
        for fam in families:
            g_axis = fam[0].group_axis
            gm = _pad_count(len(fam))
            glo = _pad_rows(np.asarray([c.lo[g_axis] for c in fam], np.float32), gm)
            ghi = _pad_rows(np.asarray([c.hi[g_axis] for c in fam], np.float32), gm)
            h_diag = syn.h_diag()
            ans = batch_query_box_grouped(x, h_diag, fam[0].lo, fam[0].hi, glo, ghi,
                                          g_axis=g_axis, tgt=fam[0].tgt, op=fam[0].op,
                                          scale=plan.scale, backend=backend)
            # the family's moments run on the per-entry full boxes (each entry's
            # box carries its group window from _compile)
            _, flo, fhi, ftgt = padded(fam, gm)
            mom = moments_box(x, h_diag, on_dev(flo), on_dev(fhi), on_dev(ftgt, np.int32))
            se = se_from_moments(np.full(gm, fam[0].op, np.int32), mom, plan.scale, n_eff)
            emit(fam, ans[:len(fam)], se[:len(fam)], norm_ppf(p), "box:grouped" + suffix)

    return [out[id(c)] for c in entries]


def _execute(compiled: Sequence[_Compiled], n_out: int, resolver, backend: str,
             n_qmc: int = 4096, ci_level: float = DEFAULT_CI_LEVEL,
             kde_backend: str = "auto",
             kde_crossover: int = KDE_CROSSOVER) -> List[AqpResult]:
    """Answer compiled queries: sketches first (when the resolver offers
    them), then group the rest by resolved synopsis, answer each group in
    batched passes on its path and scatter back to submission order.  The
    mapping resolver has neither sketches nor an RFF fit cache."""
    results: List[Optional[AqpResult]] = [None] * n_out
    try_exact = getattr(resolver, "try_exact", None)
    density_for = getattr(resolver, "density_for", None)
    remaining: List[_Compiled] = []
    for c in compiled:
        hit = try_exact(c) if try_exact is not None else None
        if hit is not None:
            est, version, path, ci_lo, ci_hi, n_eff = hit
            results[c.slot] = AqpResult(
                estimate=est, path=path, rel_width=0.0,
                synopsis_version=version, group=c.group, query=c.query,
                ci_lo=ci_lo, ci_hi=ci_hi, ci_level=ci_level,
                n_effective=n_eff)
        else:
            remaining.append(c)

    groups: "Dict[object, dict]" = {}
    for c in remaining:
        key, c2, plan, version = resolver(c)
        g = groups.setdefault(key, {"plan": plan, "version": version,
                                    "entries": []})
        g["entries"].append(c2)

    for key, g in groups.items():
        plan: _GroupPlan = g["plan"]
        entries: List[_Compiled] = g["entries"]
        rff = None
        if plan.kind == "qmc":
            # fit-or-fetch the RFF synopsis only when some entry wants it
            n_rows = int(plan.x_rows.shape[0])
            if density_for is not None and any(
                    _resolve_kde_backend(c.kde_backend, kde_backend, n_rows,
                                         kde_crossover) == "rff"
                    for c in entries):
                rff = density_for(key, g["version"], plan)
        answered = _run_group(key, plan, entries, backend, n_qmc,
                              ci_level=ci_level, kde_backend=kde_backend,
                              rff=rff, kde_crossover=kde_crossover)
        for c, (est, path, ci_lo, ci_hi, n_eff) in zip(entries, answered):
            results[c.slot] = AqpResult(
                estimate=est, path=path,
                rel_width=_rel_width(c, plan.h_axes),
                synopsis_version=g["version"], group=c.group, query=c.query,
                ci_lo=ci_lo, ci_hi=ci_hi, ci_level=ci_level,
                n_effective=n_eff)
    return results


# --- the facade -------------------------------------------------------------

class QueryEngine:
    """Single entry point for AQP batches against a `TelemetryStore`.

        engine = QueryEngine(store)                # or store.engine()
        results = engine.execute([
            AqpQuery("count", (Range("loss", 1.0, 4.0),)),
            AqpQuery("avg", (Box(("loss", "latency_ms"), (1, 20), (4, 60)),),
                     target="latency_ms"),
            AqpQuery("count", (Eq("model_id", 2),)),
        ])

    `backend` None picks the kernel path ("cuda") on a CUDA store and the
    plain path ("torch") on a CPU store.  `kde_backend` picks the density
    backend of full-H groups ("auto" | "exact" | "rff"); "auto" takes RFF
    from `kde_crossover` sample rows up (default KDE_CROSSOVER), fitted
    with `rff_features` features (default DEFAULT_RFF_FEATURES).
    """

    def __init__(self, store, selector: str = "plugin",
                 backend: Optional[str] = None, n_qmc: int = 4096,
                 max_groups: int = 64, ci_level: float = DEFAULT_CI_LEVEL,
                 kde_backend: str = "auto", kde_crossover: Optional[int] = None,
                 rff_features: Optional[int] = None):
        if kde_backend not in KDE_BACKENDS:
            raise ValueError(f"unknown kde_backend {kde_backend!r}; "
                             f"expected one of {KDE_BACKENDS}")
        self.store = store
        self.selector = selector
        self.backend = resolve_backend(backend, store.device)
        self.n_qmc = n_qmc
        self.max_groups = max_groups
        self.ci_level = ci_level
        self.kde_backend = kde_backend
        self.kde_crossover = KDE_CROSSOVER if kde_crossover is None else int(kde_crossover)
        self.rff_features = (DEFAULT_RFF_FEATURES if rff_features is None
                             else int(rff_features))
        self.plans = PlanCache()

    def compile(self, queries: Union[AqpQuery, Sequence[AqpQuery]]
                ) -> List[_Compiled]:
        """Normalize specs to execution units (one per GROUP BY category),
        slotted in submission order."""
        if isinstance(queries, AqpQuery):
            queries = [queries]
        compiled: List[_Compiled] = []
        for q in queries:
            if not isinstance(q, AqpQuery):
                raise TypeError(f"QueryEngine.execute takes AqpQuery specs, "
                                f"got {type(q).__name__}")
            for gv in self._group_values(q):
                compiled.append(_compile(q, len(compiled), group_value=gv))
        return compiled

    def resolver(self, selector: Optional[str] = None,
                 backend: Optional[str] = None,
                 tier: Optional[int] = None) -> _StoreResolver:
        """Store resolver wired to this engine's version-keyed plan cache;
        `tier` budgets resolution to one tier of a `TieredReservoir` (None:
        the full sample; plain reservoirs ignore it)."""
        return _StoreResolver(self.store, selector or self.selector,
                              backend or self.backend, plans=self.plans,
                              rff_features=self.rff_features, tier=tier)

    def run_compiled(self, compiled: Sequence[_Compiled],
                     selector: Optional[str] = None,
                     backend: Optional[str] = None,
                     tier: Optional[int] = None,
                     kde_backend: Optional[str] = None) -> List[AqpResult]:
        """Execute pre-compiled units (slots must be 0..n-1)."""
        backend = resolve_backend(backend or self.backend, self.store.device)
        return _execute(compiled, len(compiled),
                        self.resolver(selector, backend, tier=tier), backend,
                        n_qmc=self.n_qmc, ci_level=self.ci_level,
                        kde_backend=kde_backend or self.kde_backend,
                        kde_crossover=self.kde_crossover)

    def execute(self, queries: Union[AqpQuery, Sequence[AqpQuery]],
                selector: Optional[str] = None,
                backend: Optional[str] = None, mode: str = "batch",
                kde_backend: Optional[str] = None):
        """Answer a batch of AqpQuery specs; one AqpResult per query (one per
        group value for GROUP BY queries).  `mode="progressive"` returns the
        `progressive` generator of (tier, results) rounds instead.
        `kde_backend` overrides the engine's density backend for this batch
        ("auto" | "exact" | "rff", full-H path only)."""
        if mode == "progressive":
            return self.progressive(queries, selector=selector, backend=backend,
                                    kde_backend=kde_backend)
        if mode != "batch":
            raise ValueError(f"unknown mode {mode!r}; "
                             f"expected 'batch' or 'progressive'")
        return self.run_compiled(self.compile(queries), selector=selector,
                                 backend=backend, kde_backend=kde_backend)

    def progressive(self, queries: Union[AqpQuery, Sequence[AqpQuery]],
                    selector: Optional[str] = None,
                    backend: Optional[str] = None,
                    kde_backend: Optional[str] = None):
        """Anytime execution over `TieredReservoir` tiers: yields (tier,
        List[AqpResult]) rounds from the smallest tier up.  The last round
        runs on the full sample and is bit-identical to `execute`; a store
        without tiered reservoirs gives that one round only."""
        compiled = self.compile(queries)
        res = self.resolver(selector, backend)
        n_tiers = 1
        for c in compiled:
            key, _c2, _version = res.key_for(c)
            col = key[0]
            reg = self.store.joints if isinstance(col, tuple) else self.store.columns
            n_tiers = max(n_tiers, getattr(reg.get(col), "n_tiers", 1))
        for t in range(n_tiers):
            tier = t if t < n_tiers - 1 else None
            yield t, self.run_compiled(compiled, selector=selector, backend=backend,
                                       tier=tier, kde_backend=kde_backend)

    def answers(self, queries, **kw) -> np.ndarray:
        """`execute`, reduced to the estimates (submission order)."""
        return np.asarray([r.estimate for r in self.execute(queries, **kw)],
                          np.float64)

    def _group_values(self, q: AqpQuery) -> List[Optional[float]]:
        if q.group_by is None:
            return [None]
        gb = q.group_by
        if gb.values is not None:
            return list(gb.values)
        res = self.store.columns.get(gb.column)
        if res is None:
            raise KeyError(f"unknown group_by column {gb.column!r}; "
                           f"have {sorted(self.store.columns)}")
        codes = np.unique(np.round(res.sample().astype(np.float64)))
        strata = getattr(res, "codes", None)
        if callable(strata):
            # a stratified TieredReservoir: codes whose last uniform
            # representative was displaced keep their result row
            codes = np.unique(np.concatenate(
                [codes, np.round(np.asarray(strata(), np.float64))]))
        if codes.size == 0:
            raise ValueError(f"group_by column {gb.column!r} has no data")
        if codes.size > self.max_groups:
            raise ValueError(
                f"group_by {gb.column!r} has {codes.size} distinct codes "
                f"(max_groups={self.max_groups}); pass "
                f"GroupBy({gb.column!r}, values=...) to pin the categories")
        return [float(v) for v in codes]


# --- legacy bridges (Query / BoxQuery and their batch shims) ------------------

def from_query(q) -> AqpQuery:
    """Compile a legacy 1-D `Query` to an AqpQuery spec."""
    return AqpQuery(q.op, (Range(q.column, q.a, q.b),))


def from_box_query(q) -> AqpQuery:
    """Compile a legacy `BoxQuery` to an AqpQuery spec."""
    target = None if q.op == "count" else q.target_index()
    return AqpQuery(q.op, (Box(q.columns, q.lo, q.hi),), target=target)


def execute_specs(specs: Sequence[AqpQuery], synopses,
                  backend: Optional[str] = None, n_qmc: int = 4096) -> np.ndarray:
    """Execute AqpQuery specs against a bare synopsis or a {column(s):
    synopsis} mapping; estimates in submission order.  `backend` None takes
    the default of the synopses' device.  GROUP BY and per-query selectors
    need a store, so specs carrying them are refused."""
    for q in specs:
        if q.group_by is not None:
            raise ValueError("group_by needs a store-backed QueryEngine; "
                             "execute_specs runs against pre-fitted synopses")
        if q.selector is not None:
            raise ValueError("a per-query selector override needs a "
                             "store-backed QueryEngine; execute_specs runs "
                             "against pre-fitted synopses")
    first = synopses if isinstance(synopses, KDESynopsis) else next(iter(synopses.values()))
    backend = resolve_backend(backend, first.x.device)
    compiled = [_compile(q, i) for i, q in enumerate(specs)]
    res = _execute(compiled, len(compiled), _MappingResolver(synopses, backend),
                   backend, n_qmc=n_qmc)
    return np.asarray([r.estimate for r in res], np.float64)
