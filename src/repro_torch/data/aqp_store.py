"""AQP telemetry store: bounded reservoir samples per column (and per
tracked column tuple), tiered reservoir ladders for progressive answers,
per-code sketches for dictionary columns (exact counts, or a count-min
table), and KDE synopses fitted on demand and cached by reservoir version.
Counterpart: `repro/data/aqp_store.py` (Reservoir, MultiReservoir,
TieredReservoir, CategoricalSketch, CountMinSketch, SynopsisCache,
TelemetryStore).

Reservoirs and sketches stay numpy on the host with
`np.random.default_rng(seed)`, the same code as the reference, so both
packages keep bit-identical samples, merges, tiers, strata and count-min
tables of one stream.  Synopsis tensors live on the store's device.  One
deliberate difference: `_fit_cached` fits with the engine's backend (the
reference always fits on its plain path), so on the card PLUGIN's Psi6 and
Psi4 run through the pairwise kernel, LSCV_h through the sv_precompute and
lscv_grid kernels and LSCV_H's objective through the gh_fused kernel.

The cache also holds the RFF density synopses of full-H groups, beside
their exact synopses, sized by their own `nbytes`, and the synopses of
tiers below the top under tier-suffixed column keys (`_tier_key`).

Each store owns a metrics registry (`store.metrics`, `repro_torch.obs`):
the cache's and the ingest path's instruments, and every admission
session's counters, which `stats()["admission"]` sums.  `subscribe` tells
listeners (admission sessions) the reservoir versions each `add_batch`
bumped, and `session` opens an `AqpSession` over the store's shared engine.

Not ported yet, raising NotImplementedError when asked for: checkpoints
(ROADMAP queue 1.12: `to_state`, and the `state()` of the reservoirs and
sketches; `repro_torch.convert.store_from_state` reads a reference
snapshot).
"""
from __future__ import annotations

import copy
import threading
import time
import weakref
import zlib
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import obs
from repro_torch.core.aqp import KDESynopsis, Query, canonical_selector
from repro_torch.core.aqp_multid import BoxQuery
from repro_torch.core.aqp_query import _effective_tier, _tier_key
from repro_torch.device import DeviceLike, resolve_backend, resolve_device

ColumnKey = Union[str, Tuple[str, ...]]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue {item})")


class Reservoir:
    """Algorithm-R reservoir sample with a deterministic RNG.

    `version` counts accepted updates; synopsis caches key on it.
    Subclasses set `_row_shape` to sample whole rows (MultiReservoir).
    """

    def __init__(self, capacity: int = 4096, seed: int = 0,
                 _row_shape: Tuple[int, ...] = ()):
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self.buf = np.empty((capacity, *_row_shape), np.float32)
        self.n_seen = 0
        self.n_filled = 0
        self.version = 0

    def _coerce(self, values: np.ndarray) -> np.ndarray:
        return np.asarray(values, np.float32).ravel()

    def _spawn(self, seed: int) -> "Reservoir":
        return type(self)(self.capacity, seed=seed)

    def add(self, values: np.ndarray) -> None:
        values = self._coerce(values)
        if values.shape[0] == 0:
            return
        self.version += 1
        k = 0
        if self.n_filled < self.capacity and self.n_seen == self.n_filled:
            k = min(self.capacity - self.n_filled, values.shape[0])
            self.buf[self.n_filled: self.n_filled + k] = values[:k]
            self.n_filled += k
            self.n_seen += k
        rest = values[k:]
        if rest.shape[0]:
            # Vectorised algorithm-R acceptance, one slot draw per element;
            # replacement stays bounded by n_filled, and fancy assignment
            # keeps the last write of a duplicated slot (sequential order).
            stream_idx = self.n_seen + np.arange(rest.shape[0])
            j = self.rng.integers(0, stream_idx + 1)
            accept = j < self.n_filled
            self.buf[j[accept]] = rest[accept]
            self.n_seen += rest.shape[0]

    def sample(self) -> np.ndarray:
        return self.buf[: self.n_filled].copy()

    def load_state(self, buf: np.ndarray, meta: Dict[str, object]) -> None:
        """Load the reference's `Reservoir.state()` (buffer, counters,
        version and RNG bit-generator state)."""
        n_filled = int(meta["n_filled"])
        if n_filled > self.capacity or buf.shape[0] != n_filled:
            raise ValueError(f"reservoir state has {buf.shape[0]} rows for "
                             f"n_filled={n_filled}, capacity={self.capacity}")
        self.buf[:n_filled] = np.asarray(buf, np.float32)
        self.n_filled = n_filled
        self.n_seen = int(meta["n_seen"])
        self.version = int(meta["version"])
        self.rng.bit_generator.state = meta["rng"]

    def merge(self, other: "Reservoir") -> "Reservoir":
        """Weighted union: each side contributes in proportion to the stream
        size its sample stands for (n_seen), not its retained size, so
        chained merges keep the mixture right.  The child's seed is drawn
        from this reservoir's RNG first, which moves it as the reference's
        does."""
        out = self._spawn(seed=int(self.rng.integers(1 << 31)))
        s1, s2 = self.sample(), other.sample()
        total = self.n_seen + other.n_seen
        if total == 0:
            return out
        w1 = self.n_seen / total
        w2 = other.n_seen / total
        # cap the merged sample so the n_seen proportions are reachable from
        # the retained points: k <= len(s_i) / w_i
        k = min(self.capacity, len(s1) + len(s2))
        if w1 > 0:
            k = min(k, int(len(s1) / w1))
        if w2 > 0:
            k = min(k, int(len(s2) / w2))
        take1 = int(out.rng.binomial(k, w1))
        take1 = min(len(s1), max(take1, k - len(s2)))
        take2 = k - take1
        pick1 = out.rng.choice(len(s1), take1, replace=False) if take1 else []
        pick2 = out.rng.choice(len(s2), take2, replace=False) if take2 else []
        buf = np.concatenate([s1[pick1], s2[pick2]]).astype(np.float32)
        out.rng.shuffle(buf)
        out.buf[: len(buf)] = buf
        out.n_filled = len(buf)
        out.n_seen = total
        out.version = 1
        return out


class MultiReservoir(Reservoir):
    """Row-sampling reservoir over a tuple of columns, so a joint density
    can be fitted (per-column reservoirs decorrelate the columns)."""

    def __init__(self, columns: Sequence[str], capacity: int = 4096,
                 seed: int = 0):
        self.columns = tuple(columns)
        if len(self.columns) < 2:
            raise ValueError("MultiReservoir needs >= 2 columns; use Reservoir "
                             "for a single column")
        self.backfilled = False   # seeded from per-column reservoirs (store)
        super().__init__(capacity, seed, _row_shape=(len(self.columns),))

    def _coerce(self, values: np.ndarray) -> np.ndarray:
        rows = np.asarray(values, np.float32)
        if rows.ndim != 2 or rows.shape[1] != len(self.columns):
            raise ValueError(f"expected rows of shape (m, {len(self.columns)}) "
                             f"for columns {self.columns}, got {rows.shape}")
        return rows

    def _spawn(self, seed: int) -> "MultiReservoir":
        return MultiReservoir(self.columns, self.capacity, seed=seed)

    def merge(self, other: "Reservoir") -> "Reservoir":
        if not isinstance(other, MultiReservoir) or other.columns != self.columns:
            raise ValueError(f"cannot merge joint reservoirs over different "
                             f"columns: {self.columns} vs "
                             f"{getattr(other, 'columns', None)}")
        out = super().merge(other)
        out.backfilled = self.backfilled or other.backfilled   # sticky
        return out

    def load_state(self, buf: np.ndarray, meta: Dict[str, object]) -> None:
        super().load_state(buf, meta)
        self.backfilled = bool(meta.get("backfilled", False))


class TieredReservoir:
    """A geometric ladder of reservoirs: tier i holds
    `capacity >> (n_tiers-1-i)` rows and the top tier is the full-capacity
    sample.  Every row is offered to every tier independently, so each tier
    is a uniform sample of the whole stream: progressive execution answers
    from tier 0 first and refines tier by tier until the top tier gives the
    untiered answer.

    `strat_column` keeps a small side reservoir per distinct code of one
    column, so rare GROUP BY groups keep coverage; strata feed group
    discovery (`codes()`, `stratum()`), estimates come from the uniform
    tiers.  `columns=None` samples scalars, a tuple whole rows.  `version`,
    `n_seen` and `n_filled` are the top tier's, so caches key on it
    unchanged.  `state()` is not ported yet (ROADMAP queue 1.12)."""

    backfilled = False   # tiered joints are never seeded from marginals

    def __init__(self, capacity: int = 4096, n_tiers: int = 4, seed: int = 0,
                 columns: Optional[Sequence[str]] = None,
                 strat_column: Optional[str] = None,
                 strata_capacity: int = 64, max_strata: int = 256):
        if n_tiers < 1:
            raise ValueError(f"n_tiers must be >= 1, got {n_tiers}")
        if capacity >> (n_tiers - 1) < 1:
            raise ValueError(f"capacity {capacity} too small for {n_tiers} "
                             f"tiers (tier 0 would be empty)")
        self.capacity = capacity
        self.n_tiers = n_tiers
        self.seed = seed
        self.columns = tuple(columns) if columns is not None else None
        self.strat_column = strat_column
        self.strata_capacity = strata_capacity
        self.max_strata = max_strata
        self._strat_axis: Optional[int] = None
        if strat_column is not None and self.columns is not None:
            if strat_column not in self.columns:
                raise ValueError(f"strat_column {strat_column!r} not in "
                                 f"columns {self.columns}")
            self._strat_axis = self.columns.index(strat_column)
        self.tiers = [self._spawn_member(capacity >> (n_tiers - 1 - i), seed + i)
                      for i in range(n_tiers)]
        self.strata: Dict[float, Reservoir] = {}
        self.strata_overflow = False

    def _spawn_member(self, cap: int, seed: int) -> Reservoir:
        if self.columns is None:
            return Reservoir(cap, seed=seed)
        return MultiReservoir(self.columns, cap, seed=seed)

    @property
    def version(self) -> int:
        return self.tiers[-1].version

    @property
    def n_seen(self) -> int:
        return self.tiers[-1].n_seen

    @property
    def n_filled(self) -> int:
        return self.tiers[-1].n_filled

    def _stratum_seed(self, code: float) -> int:
        return (self.seed + 7919
                + zlib.crc32(np.float32(code).tobytes()) % 100003)

    def add(self, values: np.ndarray) -> None:
        # lower tiers, then strata, then the top tier last: its version bump
        # is what readers key on, so it comes after every other member moved
        values = self.tiers[-1]._coerce(np.asarray(values, np.float32))
        if values.shape[0] == 0:
            return
        for tier in self.tiers[:-1]:
            tier.add(values)
        if self.strat_column is not None:
            codes = values if self._strat_axis is None \
                else values[:, self._strat_axis]
            for code in np.unique(codes):
                if np.isnan(code):
                    continue
                key = float(code)
                res = self.strata.get(key)
                if res is None:
                    if len(self.strata) >= self.max_strata:
                        # no NEW strata; existing ones keep updating
                        self.strata_overflow = True
                        continue
                    res = self._spawn_member(self.strata_capacity,
                                             self._stratum_seed(key))
                    self.strata[key] = res
                res.add(values[codes == code])
        self.tiers[-1].add(values)

    def sample(self, tier: Optional[int] = None) -> np.ndarray:
        """The retained sample of one tier (default: the full top tier)."""
        if tier is None:
            return self.tiers[-1].sample()
        tier = max(0, min(int(tier), self.n_tiers - 1))
        return self.tiers[tier].sample()

    def tier_sizes(self) -> List[int]:
        return [t.n_filled for t in self.tiers]

    def codes(self) -> List[float]:
        """Distinct stratification codes seen so far (sorted): the GROUP BY
        discovery set the engine unions with the uniform sample's codes."""
        return sorted(self.strata)

    def stratum(self, code: float) -> Optional[np.ndarray]:
        res = self.strata.get(float(np.float32(code)))
        return None if res is None else res.sample()

    def merge(self, other: "TieredReservoir") -> "TieredReservoir":
        if not isinstance(other, TieredReservoir) \
                or other.n_tiers != self.n_tiers \
                or other.columns != self.columns \
                or other.strat_column != self.strat_column:
            raise ValueError(
                f"cannot merge tiered reservoirs with different shape: "
                f"{(self.n_tiers, self.columns, self.strat_column)} vs "
                f"{(getattr(other, 'n_tiers', None), getattr(other, 'columns', None), getattr(other, 'strat_column', None))}")
        out = TieredReservoir(
            self.capacity, self.n_tiers,
            seed=int(self.tiers[-1].rng.integers(1 << 31)),
            columns=self.columns, strat_column=self.strat_column,
            strata_capacity=self.strata_capacity, max_strata=self.max_strata)
        out.tiers = [a.merge(b) for a, b in zip(self.tiers, other.tiers)]
        for key in set(self.strata) | set(other.strata):
            a, b = self.strata.get(key), other.strata.get(key)
            out.strata[key] = a.merge(b) if a is not None and b is not None \
                else copy.deepcopy(a if a is not None else b)
        out.strata_overflow = self.strata_overflow or other.strata_overflow
        return out

    @classmethod
    def from_state(cls, arrays: Dict[str, np.ndarray],
                   meta: Dict[str, object]) -> "TieredReservoir":
        """Load the reference's `TieredReservoir.state()`: every tier and
        stratum with its RNG state."""
        cols = meta.get("columns")
        out = cls(capacity=int(meta["capacity"]), n_tiers=int(meta["n_tiers"]),
                  seed=int(meta["seed"]), columns=tuple(cols) if cols else None,
                  strat_column=meta.get("strat_column"),
                  strata_capacity=int(meta["strata_capacity"]),
                  max_strata=int(meta["max_strata"]))
        for i, m in enumerate(meta["tiers"]):
            out.tiers[i].load_state(arrays[f"tier{i}/buf"], m)
        for j, ent in enumerate(meta["strata"]):
            code = float(ent["code"])
            res = out._spawn_member(out.strata_capacity, out._stratum_seed(code))
            res.load_state(arrays[f"strata/{j}/buf"], ent["meta"])
            out.strata[code] = res
        out.strata_overflow = bool(meta.get("strata_overflow", False))
        return out


class CategoricalSketch:
    """Exact per-code frequency sketch for a dictionary column: Eq-term
    aggregates are answered from the counts, with no smoothing and no
    scaling, while `n_rows` equals the reservoir's `n_seen` (the sketch saw
    the whole stream).  Past `max_codes` distinct codes the column is not
    dictionary-like: the sketch marks itself `overflowed` and the exact path
    turns itself off."""

    path = "exact"    # AqpResult.path label when this sketch answers

    def __init__(self, max_codes: int = 4096):
        self.counts: Dict[float, int] = {}
        self.n_rows = 0
        self.max_codes = max_codes
        self.overflowed = False

    def add(self, values: np.ndarray) -> None:
        # float32, as Reservoir._coerce: a code must count under the same
        # rounded value on the exact path and in the KDE sample
        values = np.asarray(values, np.float32).ravel()
        if values.shape[0] == 0:
            return
        if not self.overflowed:
            codes, counts = np.unique(values, return_counts=True)
            for c, k in zip(codes, counts):
                self.counts[float(c)] = self.counts.get(float(c), 0) + int(k)
            if len(self.counts) > self.max_codes:
                self.overflowed = True
                self.counts.clear()
        # n_rows last: a reader mid-update sees n_rows < n_seen and routes
        # to the KDE path instead of serving half-updated counts as exact
        self.n_rows += values.shape[0]

    def exact_for(self, n_seen: int) -> bool:
        """True when the sketch covers the column's entire stream."""
        return not self.overflowed and self.n_rows == n_seen

    def range_terms(self, lo: float, hi: float) -> Tuple[int, float]:
        """(COUNT, SUM of code values) over codes in [lo, hi] — exact."""
        cnt = 0
        sm = 0.0
        for code, k in list(self.counts.items()):
            if lo <= code <= hi:
                cnt += k
                sm += code * k
        return cnt, sm

    @classmethod
    def from_state(cls, arrays: Dict[str, np.ndarray],
                   meta: Dict[str, object]) -> "CategoricalSketch":
        """Load the reference's `CategoricalSketch.state()`."""
        out = cls(max_codes=int(meta["max_codes"]))
        out.n_rows = int(meta["n_rows"])
        out.overflowed = bool(meta["overflowed"])
        out.counts = {float(c): int(k) for c, k
                      in zip(arrays["codes"], arrays["counts"])}
        return out

    def merge(self, other: "CategoricalSketch") -> "CategoricalSketch":
        out = CategoricalSketch(max_codes=min(self.max_codes, other.max_codes))
        out.n_rows = self.n_rows + other.n_rows
        out.overflowed = self.overflowed or other.overflowed
        if not out.overflowed:
            out.counts = dict(self.counts)
            for c, k in other.counts.items():
                out.counts[c] = out.counts.get(c, 0) + k
            if len(out.counts) > out.max_codes:
                out.overflowed = True
                out.counts.clear()
        return out

    def stats(self) -> Dict[str, object]:
        return {"kind": "exact", "codes": len(self.counts),
                "rows": self.n_rows, "overflowed": self.overflowed}


_CM_MAX = (1 << 32) - 1      # uint32 saturation cap of CountMinSketch cells


class CountMinSketch:
    """Bounded-error per-code counts for dictionary columns too wide for
    `CategoricalSketch`: a (depth x width) table of uint32 counters, one
    cell per row through multiply-shift hashes of the code's float32 bits
    (multipliers from `np.random.default_rng(seed)`), a code's estimate the
    MIN of its cells.  Estimates only over-count; with probability >=
    1 - exp(-depth) by at most `err_bound()` = ceil(e / width * n_rows).
    Answers carry the path label "exact:cm" under the exact sketch's
    coverage gate.

    `conservative=True` raises a code's cells only to its estimate plus its
    batch count (Estan & Varghese): same bound, lower realised error.  Adds
    saturate at 2^32 - 1 and count `saturated`; any saturation drops the
    coverage gate, since a clipped cell may under-count.  Range answers
    walk the declared code lattice `grid_origin + k * grid_step`; a value
    seen off it sets `off_grid`, after which `range_terms` / `range_err`
    return None and the engine answers from the KDE.  The hashes stay in
    numpy's wrapping uint64 arithmetic, as in the reference.  `state()` is
    not ported yet (ROADMAP queue 1.12)."""

    path = "exact:cm"

    def __init__(self, width: int = 2048, depth: int = 4, seed: int = 0,
                 max_enumerate: int = 64, conservative: bool = False,
                 grid_step: float = 1.0, grid_origin: float = 0.0):
        if width < 1 or depth < 1:
            raise ValueError(f"width/depth must be >= 1, got {width}x{depth}")
        if not grid_step > 0:
            raise ValueError(f"grid_step must be > 0, got {grid_step}")
        self.width = width
        self.depth = depth
        self.seed = seed
        self.conservative = conservative
        self.max_enumerate = max_enumerate   # widest code window enumerated
        self.grid_step = float(grid_step)
        self.grid_origin = float(grid_origin)
        self.off_grid = False                # any value seen off the lattice
        self.table = np.zeros((depth, width), np.uint32)
        self.saturated = 0                   # cumulative cell-clip events
        self.n_rows = 0
        self.overflowed = False              # a count-min sketch never overflows
        rng = np.random.default_rng(seed)
        # odd multipliers of the multiply-shift hashes, deterministic in
        # `seed` so merged tables line up
        self._mul = (rng.integers(1, 1 << 61, size=depth, dtype=np.uint64)
                     * np.uint64(2) + np.uint64(1))
        self._add = rng.integers(0, 1 << 61, size=depth, dtype=np.uint64)

    def _hash(self, codes: np.ndarray, row: int) -> np.ndarray:
        bits = np.asarray(codes, np.float32).view(np.uint32).astype(np.uint64)
        mixed = (self._mul[row] * bits + self._add[row]) >> np.uint64(33)
        return (mixed % np.uint64(self.width)).astype(np.int64)

    def add(self, values: np.ndarray) -> None:
        # float32, as Reservoir._coerce: a code buckets under the same
        # rounded value on the exact path and in the KDE sample
        values = np.asarray(values, np.float32).ravel()
        if values.shape[0] == 0:
            return
        if not self.off_grid:
            # snap to the declared lattice and compare float32 bit patterns
            k = np.rint((values.astype(np.float64) - self.grid_origin)
                        / self.grid_step)
            snapped = np.asarray(self.grid_origin + k * self.grid_step,
                                 np.float32)
            if not np.array_equal(snapped.view(np.uint32),
                                  values.view(np.uint32)):
                self.off_grid = True
        if self.conservative:
            # per distinct code: every estimate read from the pre-batch
            # table, then its cells raised to at most estimate + batch count
            codes, counts = np.unique(values, return_counts=True)
            idx = np.stack([self._hash(codes, r) for r in range(self.depth)])
            cur = np.stack([self.table[r, idx[r]] for r in range(self.depth)])
            target = cur.astype(np.int64).min(axis=0) + counts
            over = target > _CM_MAX
            if over.any():                   # saturate, don't wrap
                self.saturated += int(over.sum())
                target = np.minimum(target, _CM_MAX)
            target = target.astype(np.uint32)
            for r in range(self.depth):
                np.maximum.at(self.table[r], idx[r], target)
        else:
            # int64 for the add (uint32 would wrap), clipped back
            for r in range(self.depth):
                inc = np.bincount(self._hash(values, r), minlength=self.width)
                new = self.table[r].astype(np.int64) + inc
                over = new > _CM_MAX
                if over.any():
                    self.saturated += int(over.sum())
                    new = np.minimum(new, _CM_MAX)
                self.table[r] = new.astype(np.uint32)
        # n_rows last, as in CategoricalSketch.add
        self.n_rows += values.shape[0]

    def estimate(self, code: float) -> int:
        """Estimated count of one code: min over its depth cells (>= truth)."""
        idx = [self._hash(np.asarray([code], np.float32), r)[0]
               for r in range(self.depth)]
        return int(min(self.table[r, i] for r, i in zip(range(self.depth), idx)))

    def exact_for(self, n_seen: int) -> bool:
        """Coverage gate: the sketch saw the column's whole stream and no
        cell saturated (a clipped cell voids the error bound)."""
        return self.n_rows == n_seen and self.saturated == 0

    def _grid_codes(self, lo: float, hi: float) -> Optional[List[float]]:
        """Deduplicated float32 lattice codes in [lo, hi], or None past
        `max_enumerate` grid points; the epsilon keeps a bound that sits on
        a grid point inside."""
        step, origin = self.grid_step, self.grid_origin
        first = int(np.ceil((lo - origin) / step - 1e-9))
        last = int(np.floor((hi - origin) / step + 1e-9))
        if last < first:
            return []
        if last - first + 1 > self.max_enumerate:
            return None
        out: List[float] = []
        seen = set()
        for k in range(first, last + 1):
            # grid points beyond float32 resolution alias to one cell
            code32 = float(np.float32(origin + k * step))
            if code32 not in seen:
                seen.add(code32)
                out.append(code32)
        return out

    def range_terms(self, lo: float, hi: float) -> Optional[Tuple[int, float]]:
        """(COUNT, SUM of code values) over lattice codes in [lo, hi], or None
        when the window is too wide to enumerate or the stream went off the
        grid (the engine then answers from the KDE)."""
        if self.off_grid:
            return None
        codes = self._grid_codes(lo, hi)
        if codes is None:
            return None
        cnt = 0
        sm = 0.0
        for code32 in codes:
            k = self.estimate(code32)
            cnt += k
            sm += code32 * k
        return cnt, sm

    def err_bound(self) -> int:
        """Counts overshoot by at most this many rows, w.p. >= 1-exp(-depth)."""
        return int(np.ceil(np.e / self.width * self.n_rows))

    def range_err(self, lo: float, hi: float
                  ) -> Optional[Tuple[int, float, float]]:
        """(count error, positive sum error, negative sum error) bounding a
        `range_terms(lo, hi)` answer, or None where it is None: COUNT's
        truth lies in [est - count_err, est], SUM's in [est - sum_pos_err,
        est + sum_neg_err] (over-counted negative codes pull the sum down)."""
        if self.off_grid:
            return None
        codes = self._grid_codes(lo, hi)
        if codes is None:
            return None
        eb = self.err_bound()
        cnt_err = 0
        sum_pos = 0.0
        sum_neg = 0.0
        for code32 in codes:
            cnt_err += eb
            if code32 >= 0:
                sum_pos += eb * code32
            else:
                sum_neg += eb * (-code32)
        return cnt_err, sum_pos, sum_neg

    def merge(self, other: "CountMinSketch") -> "CountMinSketch":
        # the hash parameters themselves, not the seed: a sketch loaded from
        # a snapshot keeps its stored multipliers
        if (self.width, self.depth) != (other.width, other.depth) \
                or not np.array_equal(self._mul, other._mul) \
                or not np.array_equal(self._add, other._add):
            raise ValueError(
                f"cannot merge count-min sketches with different geometry: "
                f"{(self.width, self.depth, self.seed)} vs "
                f"{(other.width, other.depth, other.seed)} "
                f"(or unequal hash parameters)")
        if (self.grid_step, self.grid_origin) != (other.grid_step,
                                                  other.grid_origin):
            raise ValueError(
                f"cannot merge count-min sketches over different code grids: "
                f"step/origin {(self.grid_step, self.grid_origin)} vs "
                f"{(other.grid_step, other.grid_origin)}")
        out = CountMinSketch(self.width, self.depth, self.seed,
                             max_enumerate=min(self.max_enumerate,
                                               other.max_enumerate),
                             conservative=self.conservative and other.conservative,
                             grid_step=self.grid_step,
                             grid_origin=self.grid_origin)
        out._mul = self._mul.copy()
        out._add = self._add.copy()
        summed = self.table.astype(np.int64) + other.table.astype(np.int64)
        over = summed > _CM_MAX
        out.saturated = self.saturated + other.saturated + int(over.sum())
        if over.any():
            summed = np.minimum(summed, _CM_MAX)
        out.table = summed.astype(np.uint32)
        out.n_rows = self.n_rows + other.n_rows
        out.off_grid = self.off_grid or other.off_grid
        return out

    def stats(self) -> Dict[str, object]:
        return {"kind": "cm", "rows": self.n_rows, "overflowed": False,
                "width": self.width, "depth": self.depth,
                "conservative": self.conservative,
                "grid_step": self.grid_step, "grid_origin": self.grid_origin,
                "off_grid": self.off_grid, "saturated": self.saturated,
                "err_bound": self.err_bound()}

    @classmethod
    def from_state(cls, arrays: Dict[str, np.ndarray],
                   meta: Dict[str, object]) -> "CountMinSketch":
        """Load the reference's `CountMinSketch.state()`: its stored hash
        parameters, and int64 tables of older snapshots clipped to the
        uint32 cap as saturations."""
        out = cls(int(meta["width"]), int(meta["depth"]), int(meta["seed"]),
                  max_enumerate=int(meta["max_enumerate"]),
                  conservative=bool(meta.get("conservative", False)),
                  grid_step=float(meta.get("grid_step", 1.0)),
                  grid_origin=float(meta.get("grid_origin", 0.0)))
        out.off_grid = bool(meta.get("off_grid", False))
        out._mul = np.asarray(arrays["mul"], np.uint64)
        out._add = np.asarray(arrays["add"], np.uint64)
        out.saturated = int(meta.get("saturated", 0))
        raw = np.asarray(arrays["table"], np.int64).reshape(out.depth, out.width)
        over = raw > _CM_MAX
        if over.any():
            out.saturated += int(over.sum())
            raw = np.minimum(raw, _CM_MAX)
        out.table = raw.astype(np.uint32)
        out.n_rows = int(meta["n_rows"])
        return out


_SKETCH_KINDS = {"exact": CategoricalSketch, "cm": CountMinSketch}


def _entry_nbytes(syn) -> int:
    """Device bytes of a cached synopsis: a KDESynopsis's sample and
    bandwidth (`h` or `H`), or a density backend's own `nbytes` (an RFF
    synopsis holds no sample, only its (W, b, z))."""
    if not isinstance(syn, KDESynopsis):
        return int(syn.nbytes)
    return sum(int(t.nbytes) for t in (syn.x, syn.h, syn.H) if t is not None)


class SynopsisCache:
    """Fitted synopses (KDESynopsis, or a density backend such as an
    RFFSynopsis under a "#rff" column key) keyed by (column-or-tuple,
    selector, backend), each stored with the reservoir version it was
    fitted at: a lookup at another version
    misses, so reservoir updates invalidate implicitly.  An LRU bounded by
    `max_entries` and, optionally, `max_bytes`.  Thread-safe: every field is
    guarded by one lock.  With a `metrics` registry, hits, misses,
    evictions, entries and bytes are mirrored there (`aqp.cache.*`)."""

    def __init__(self, max_entries: int = 128,
                 max_bytes: Optional[int] = None,
                 metrics: Optional[obs.MetricsRegistry] = None):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        # (column-or-tuple, selector, backend) -> (version, synopsis, nbytes)
        self._entries: OrderedDict = OrderedDict()  # guarded-by: _lock
        self.hits = 0          # guarded-by: _lock
        self.misses = 0        # guarded-by: _lock
        self.evictions = 0     # guarded-by: _lock
        self.oversize = 0      # guarded-by: _lock
        self._bytes = 0        # guarded-by: _lock
        self._lock = threading.Lock()
        # registry mirror, its instruments resolved once here
        if metrics is not None:
            self._m_hits = metrics.counter("aqp.cache.hits")
            self._m_misses = metrics.counter("aqp.cache.misses")
            self._m_evictions = metrics.counter("aqp.cache.evictions")
            self._m_entries = metrics.gauge("aqp.cache.entries")
            self._m_bytes = metrics.gauge("aqp.cache.bytes")
        else:
            self._m_hits = self._m_misses = self._m_evictions = None
            self._m_entries = self._m_bytes = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def get(self, column: ColumnKey, selector: str, version: int, *,
            backend: str) -> Optional[KDESynopsis]:
        key = (column, canonical_selector(selector), backend)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent[0] == version:
                self.hits += 1
                if self._m_hits is not None:
                    self._m_hits.inc()
                self._entries.move_to_end(key)        # LRU: refresh recency
                return ent[1]
            self.misses += 1
            if self._m_misses is not None:
                self._m_misses.inc()
            return None

    def put(self, column: ColumnKey, selector: str, version: int,
            syn: KDESynopsis, *, backend: str) -> None:
        key = (column, canonical_selector(selector), backend)
        nb = _entry_nbytes(syn)
        with self._lock:
            if self.max_bytes is not None and nb > self.max_bytes:
                # an entry that can never fit must not flush the whole cache
                self.oversize += 1
                if key in self._entries:
                    self._bytes -= self._entries.pop(key)[2]
                return
            if key in self._entries:
                self._bytes -= self._entries.pop(key)[2]
            self._entries[key] = (version, syn, nb)
            self._bytes += nb
            while (len(self._entries) > self.max_entries
                   or (self.max_bytes is not None
                       and self._bytes > self.max_bytes)):
                _, (_, _, ev_nb) = self._entries.popitem(last=False)
                self._bytes -= ev_nb
                self.evictions += 1
                if self._m_evictions is not None:
                    self._m_evictions.inc()
            if self._m_entries is not None:
                self._m_entries.set(len(self._entries))
                self._m_bytes.set(self._bytes)

    def peek(self, column: ColumnKey, selector: str, version: int, *,
             backend: str) -> Optional[KDESynopsis]:
        """`get` without counting a hit or a miss and without refreshing
        the entry's recency."""
        key = (column, canonical_selector(selector), backend)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent[0] == version:
                return ent[1]
            return None

    def invalidate(self, column: Optional[ColumnKey] = None) -> None:
        """Drop every entry of `column` (all backends and selectors), or
        every entry when it is None."""
        with self._lock:
            if column is None:
                self._entries.clear()
                self._bytes = 0
                return
            for key in [k for k in self._entries if k[0] == column]:
                self._bytes -= self._entries.pop(key)[2]

    def entries(self) -> List[Tuple[Tuple[Hashable, str, str], int, KDESynopsis]]:
        """A consistent snapshot of the live entries in LRU order:
        [((column, selector, backend), version, synopsis)]."""
        with self._lock:
            return [(key, version, syn) for key, (version, syn, _nb)
                    in self._entries.items()]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries), "bytes": self._bytes,
                    "evictions": self.evictions, "oversize": self.oversize}


class TelemetryStore:
    """Streams telemetry columns into reservoirs and answers AqpQuery batches
    from KDE synopses on `device` (default: the CUDA device; pass
    `device="cpu"` for the plain path on the CPU).  `metrics` shares a
    registry (default: the store's own)."""

    def __init__(self, capacity: int = 4096, seed: int = 0,
                 cache_entries: int = 128, cache_bytes: Optional[int] = None,
                 device: DeviceLike = None,
                 metrics: Optional[obs.MetricsRegistry] = None):
        self.device = resolve_device(device)
        # reads of the registries are unlocked by design (query paths
        # tolerate a stale view); every mutation holds _write_lock
        self.columns: Dict[str, Reservoir] = {}         # guarded-by: _write_lock (writes)
        self.joints: Dict[Tuple[str, ...], MultiReservoir] = {}  # guarded-by: _write_lock (writes)
        self.categoricals: Dict[str, CategoricalSketch] = {}  # guarded-by: _write_lock (writes)
        self.capacity = capacity
        self.seed = seed
        # engine, admission and cache instruments land here, so co-hosted
        # stores and tests stay apart
        self.metrics = metrics if metrics is not None else obs.MetricsRegistry()
        self.cache = SynopsisCache(max_entries=cache_entries,
                                   max_bytes=cache_bytes, metrics=self.metrics)
        self._listeners: List[Callable[[Dict[ColumnKey, int]], None]] = []  # guarded-by: _write_lock
        self._sessions: List["weakref.ref"] = []        # guarded-by: _write_lock
        # shared engines keyed (selector, backend): query() routes through
        # these so plan caches persist across calls
        self._engines: Dict[Tuple[str, str], object] = {}  # guarded-by: _write_lock (writes)
        self._write_lock = threading.RLock()

    def _col_seed(self, name: str) -> int:
        # crc32, not hash(): string hashing is randomised per process
        return self.seed + zlib.crc32(name.encode()) % 1000

    def track_joint(self, columns: Sequence[str], backfill: bool = True) -> None:
        """Register a joint (row) reservoir over a column tuple.  Columns
        already tracked seed it with their current samples zip-aligned
        (pseudo-rows, flagged `backfilled`); `backfill=False` starts empty."""
        key = tuple(columns)
        with self._write_lock:
            if key in self.joints:
                return
            res = MultiReservoir(key, self.capacity,
                                 seed=self._col_seed("|".join(key)))
            if backfill and all(c in self.columns
                                and self.columns[c].n_filled > 0
                                for c in key):
                samples = [self.columns[c].sample() for c in key]
                k = min(s.shape[0] for s in samples)  # zip-aligned window
                res.add(np.stack([s[:k] for s in samples], axis=1))
                # the window stands in for the paired stream the per-column
                # reservoirs summarize: its stream size is theirs, not k
                res.n_seen = min(self.columns[c].n_seen for c in key)
                res.backfilled = True
            self.joints[key] = res

    def track_tiered(self, columns: ColumnKey, n_tiers: int = 4,
                     strat_column: Optional[str] = None,
                     strata_capacity: int = 64, max_strata: int = 256) -> None:
        """Make a column (str) or a joint tuple a `TieredReservoir`, before
        its first `add_batch` (a reservoir that has seen rows cannot become
        one): tier 0 answers from a 1/2^(n_tiers-1) sample, progressive
        execution refines tier by tier, and the top tier gives the untiered
        answers.  `strat_column` keeps a small per-code side sample for rare
        GROUP BY groups."""
        if isinstance(columns, str):
            name: ColumnKey = columns
            registry: Dict = self.columns
            seed = self._col_seed(columns)
            if strat_column is not None and strat_column != columns:
                raise ValueError(f"strat_column {strat_column!r} must equal "
                                 f"the tracked column {columns!r} for 1-D "
                                 f"tiered reservoirs")
            member_cols = None
            strat = columns if strat_column is not None else None
        else:
            name = tuple(columns)
            registry = self.joints
            seed = self._col_seed("|".join(name))
            member_cols = name
            strat = strat_column
        with self._write_lock:
            existing = registry.get(name)
            if isinstance(existing, TieredReservoir):
                return
            if existing is not None and existing.n_seen > 0:
                raise ValueError(f"cannot convert reservoir {name!r} with "
                                 f"{existing.n_seen} rows seen to tiered; "
                                 f"call track_tiered before add_batch")
            registry[name] = TieredReservoir(
                self.capacity, n_tiers=n_tiers, seed=seed,
                columns=member_cols, strat_column=strat,
                strata_capacity=strata_capacity, max_strata=max_strata)

    def track_categorical(self, column: str, max_codes: int = 4096,
                          kind: str = "exact", width: int = 2048,
                          depth: int = 4, conservative: bool = False,
                          grid_step: float = 1.0,
                          grid_origin: float = 0.0) -> None:
        """Register a per-code sketch for a dictionary column, before the
        column's first `add_batch` (the Eq path needs the sketch to cover the
        whole stream).  kind="exact" keeps one counter per code up to
        `max_codes` codes; kind="cm" a (depth x width) `CountMinSketch`
        (path "exact:cm"), with `conservative` updates and the code lattice
        `grid_step` / `grid_origin` for range enumeration."""
        with self._write_lock:
            if column in self.categoricals:
                return
            if kind == "exact":
                if conservative:
                    raise ValueError("conservative update is a count-min "
                                     "mode; kind='exact' counts are already "
                                     "exact")
                if (grid_step, grid_origin) != (1.0, 0.0):
                    raise ValueError("grid_step/grid_origin are count-min "
                                     "parameters; kind='exact' enumerates "
                                     "its actual codes and needs no grid")
                self.categoricals[column] = CategoricalSketch(
                    max_codes=max_codes)
            elif kind == "cm":
                # seeded from the column name alone, not the store's seed:
                # merged tables add cell-wise only under the same hashes
                self.categoricals[column] = CountMinSketch(
                    width=width, depth=depth,
                    seed=zlib.crc32(column.encode()) % 1000,
                    conservative=conservative,
                    grid_step=grid_step, grid_origin=grid_origin)
            else:
                raise ValueError(f"unknown sketch kind {kind!r}; "
                                 f"expected one of {sorted(_SKETCH_KINDS)}")

    def subscribe(self, fn: Callable[[Dict[ColumnKey, int]], None]
                  ) -> Callable[[], None]:
        """Version-change notification: `fn` is called after every
        `add_batch` with {column or joint tuple: new version} for each
        reservoir it bumped.  Returns the unsubscribe function.  Admission
        sessions re-key their pending micro-batches with it."""
        with self._write_lock:
            self._listeners.append(fn)

        def unsubscribe() -> None:
            with self._write_lock:
                try:
                    self._listeners.remove(fn)
                except ValueError:
                    pass
        return unsubscribe

    def _register_session(self, session) -> None:
        """Track an admission session (weakly) so `stats()` counts the live
        ones; called by `AqpSession.__init__`."""
        with self._write_lock:
            self._sessions = [r for r in self._sessions if r() is not None]
            self._sessions.append(weakref.ref(session))

    def to_state(self) -> None:
        raise _not_ported("store checkpoints", "1.12")

    def add_batch(self, stats: Dict[str, np.ndarray]) -> None:
        # joint rows are built before any reservoir changes: a ragged batch
        # fails without leaving the per-column reservoirs ahead of the joints
        joint_rows = {}
        for cols in self.joints:
            if all(c in stats for c in cols):
                arrays = [np.asarray(stats[c], np.float32).ravel() for c in cols]
                sizes = {c: a.shape[0] for c, a in zip(cols, arrays)}
                if len(set(sizes.values())) > 1:
                    raise ValueError(f"joint {cols} needs row-aligned columns, "
                                     f"got lengths {sizes}")
                joint_rows[cols] = np.stack(arrays, axis=1)
        t_ingest = time.perf_counter() if obs.enabled() else 0.0
        with self._write_lock:
            for name, values in stats.items():
                if name not in self.columns:
                    self.columns[name] = Reservoir(self.capacity,
                                                   seed=self._col_seed(name))
                res = self.columns[name]
                res.add(values)
                self.metrics.counter("aqp.ingest.rows", column=name).inc(
                    np.asarray(values).size)
                self.metrics.gauge("aqp.reservoir.fill", column=name).set(
                    res.n_filled / max(res.capacity, 1))
                sketch = self.categoricals.get(name)
                if sketch is not None:
                    sketch.add(values)
                    eb = getattr(sketch, "err_bound", None)
                    if eb is not None:
                        self.metrics.gauge("aqp.sketch.err_bound",
                                           column=name).set(eb())
            for cols, rows in joint_rows.items():
                self.joints[cols].add(rows)
            self.metrics.counter("aqp.ingest.batches").inc()
            if self._listeners:
                bumped: Dict[ColumnKey, int] = {
                    name: self.columns[name].version for name in stats}
                for cols in joint_rows:
                    bumped[cols] = self.joints[cols].version
                for fn in list(self._listeners):
                    fn(bumped)
        if t_ingest:
            self.metrics.histogram("aqp.ingest.us").observe(
                (time.perf_counter() - t_ingest) * 1e6)

    def synopsis(self, column: str, selector: str = "plugin",
                 backend: Optional[str] = None,
                 tier: Optional[int] = None) -> KDESynopsis:
        """The column's synopsis; `tier` fits one tier of a tiered column
        (None, or the top tier, is the full sample)."""
        res = self.columns.get(column)
        if res is None:
            raise KeyError(f"unknown column {column!r}; "
                           f"have {sorted(self.columns)}")
        return self._fit_cached(column, res, selector, backend, tier=tier)

    def joint_synopsis(self, columns: Sequence[str], selector: str = "plugin",
                       backend: Optional[str] = None,
                       tier: Optional[int] = None) -> KDESynopsis:
        """Joint synopsis over a tracked column tuple: per-axis diagonal
        bandwidths (plugin / silverman), scalar LSCV_h, or full-H LSCV_H."""
        key = tuple(columns)
        res = self.joints.get(key)
        if res is None:
            raise KeyError(f"no joint reservoir for columns {key!r}; call "
                           f"track_joint({key!r}) before add_batch "
                           f"(have {sorted(self.joints)})")
        return self._fit_cached(key, res, selector, backend, tier=tier)

    def _fit_cached(self, key: ColumnKey, res, selector: str,
                    backend: Optional[str],
                    tier: Optional[int] = None) -> KDESynopsis:
        """Fit-or-fetch at the reservoir's current version, fitting with
        `backend` (None: the device's default).  Each backend keeps its own
        cache entry, so an answer never depends on which backend fitted a
        column first.  A tier below the top keeps its own entry under the
        tier-suffixed key and scales against the full stream (`n_source =
        res.n_seen`): every tier is a uniform sample of it."""
        selector = canonical_selector(selector)
        backend = resolve_backend(backend, self.device)
        tier = _effective_tier(res, tier)
        ckey = _tier_key(key, tier)
        syn = self.cache.get(ckey, selector, res.version, backend=backend)
        if syn is None:
            data = res.sample() if tier is None else res.sample(tier)
            syn = KDESynopsis.fit(data, selector=selector,
                                  max_sample=self.capacity, backend=backend,
                                  device=self.device)
            syn.n_source = res.n_seen
            self.cache.put(ckey, selector, res.version, syn, backend=backend)
        return syn

    # -- queries ------------------------------------------------------------

    def engine(self, **kwargs):
        """A fresh QueryEngine over this store."""
        from repro_torch.core.aqp_query import QueryEngine
        return QueryEngine(self, **kwargs)

    def shared_engine(self, selector: str = "plugin",
                      backend: Optional[str] = None):
        """The store-owned engine for (selector, backend), created on first
        use; its plan cache persists across `query()` calls."""
        from repro_torch.device import resolve_backend
        key = (canonical_selector(selector),
               resolve_backend(backend, self.device))
        with self._write_lock:
            eng = self._engines.get(key)
            if eng is None:
                eng = self.engine(selector=key[0], backend=key[1])
                self._engines[key] = eng
            return eng

    def session(self, selector: str = "plugin", backend: Optional[str] = None,
                **kwargs):
        """A streaming admission session over the shared engine of
        (selector, backend): clients submit AqpQuery specs and get futures,
        micro-batches coalesce across them and flush on a watermark or a
        deadline (`repro_torch.core.aqp_admission`).  Other keywords
        (watermark, max_delay, ...) go to `AqpSession`."""
        return self.shared_engine(selector, backend).session(**kwargs)

    def query(self, queries, selector: str = "plugin",
              backend: Optional[str] = None, mode: str = "batch"):
        """Answer a mixed batch of AqpQuery specs in one engine call; returns
        AqpResult rows in submission order.  `mode="progressive"` returns
        the engine's (tier, results) generator instead
        (`QueryEngine.progressive`)."""
        return self.shared_engine(selector, backend).execute(queries,
                                                             mode=mode)

    def count(self, column: str, a: float, b: float, selector: str = "plugin") -> float:
        return float(self.synopsis(column, selector).count(a, b))

    def avg(self, column: str, a: float, b: float, selector: str = "plugin") -> float:
        return float(self.synopsis(column, selector).avg(a, b))

    def fraction(self, column: str, a: float, b: float, selector: str = "plugin") -> float:
        res = self.columns[column]
        return self.count(column, a, b, selector) / max(res.n_seen, 1)

    def query_batch(self, queries: Sequence[Query], selector: str = "plugin",
                    backend: Optional[str] = None) -> np.ndarray:
        """Answer legacy 1-D range queries (`Query`, or its field tuples)
        through the engine; synopses come from the cache."""
        from repro_torch.core.aqp_query import QueryEngine, from_query

        queries = [q if isinstance(q, Query) else Query(*q) for q in queries]
        return QueryEngine(self, selector=selector, backend=backend).answers(
            [from_query(q) for q in queries])

    def query_box_batch(self, queries: Sequence[BoxQuery], selector: str = "plugin",
                        backend: Optional[str] = None) -> np.ndarray:
        """Answer legacy box queries (`BoxQuery`, or its field tuples, eq.
        11) through the engine; joint synopses come from the cache."""
        from repro_torch.core.aqp_query import QueryEngine, from_box_query

        queries = [q if isinstance(q, BoxQuery) else BoxQuery(*q) for q in queries]
        return QueryEngine(self, selector=selector, backend=backend).answers(
            [from_box_query(q) for q in queries])

    def stats(self) -> Dict[str, object]:
        """Cache counters, stream sizes per reservoir, which joints were
        backfilled, sketch coverage, and the admission counters of every
        session opened on the store."""
        cats = {}
        for name, sketch in self.categoricals.items():
            ent = sketch.stats()
            res = self.columns.get(name)
            ent["exact"] = res is not None and sketch.exact_for(res.n_seen)
            cats[name] = ent
        return {
            "cache": self.cache.stats(),
            "columns": {name: res.n_seen for name, res in self.columns.items()},
            "joints": {key: res.n_seen for key, res in self.joints.items()},
            "backfilled": {key: res.backfilled for key, res in self.joints.items()},
            "categoricals": cats,
            "admission": self._admission_stats(),
        }

    def _admission_stats(self) -> Dict[str, object]:
        """Admission counters summed over every session ever opened on this
        store, from the metrics registry: the counters are labelled by
        session and outlive it, so the sums hold after a session closes and
        is collected; only `sessions` (registered now) and `pending` (live
        depth gauges) reflect the present."""
        with self._write_lock:
            live = [r for r in self._sessions if r() is not None]
        reg = self.metrics
        agg: Dict[str, object] = {"sessions": len(live)}
        for k in ("submitted", "executed", "flushes", "coalesced",
                  "invalidations", "blocked", "shed", "fit_requeued"):
            agg[k] = int(reg.sum_counter(f"aqp.admission.{k}"))
        agg["pending"] = int(reg.sum_gauge("aqp.admission.depth"))
        flush_reasons: Dict[str, int] = {}
        for labels, n in reg.collect_counters("aqp.admission.flush_reason"):
            reason = labels.get("reason", "?")
            flush_reasons[reason] = flush_reasons.get(reason, 0) + int(n)
        agg["flush_reasons"] = flush_reasons
        batch_rows = reg.sum_counter("aqp.admission.batch_rows")
        agg["mean_batch"] = batch_rows / agg["flushes"] if agg["flushes"] else 0.0
        return agg

    def merge(self, other: "TelemetryStore") -> "TelemetryStore":
        """The union of two stores on this store's device: reservoirs and
        tiers by weighted merge, sketches by adding counts; what only one
        side tracks is deep-copied (a one-sided sketch no longer covers the
        merged stream, so its exact path turns off)."""
        out = TelemetryStore(self.capacity, self.seed,
                             cache_entries=self.cache.max_entries,
                             cache_bytes=self.cache.max_bytes, device=self.device)
        for mine, theirs, dest in ((self.columns, other.columns, out.columns),
                                   (self.joints, other.joints, out.joints),
                                   (self.categoricals, other.categoricals,
                                    out.categoricals)):
            for name in set(mine) | set(theirs):
                if name in mine and name in theirs:
                    dest[name] = mine[name].merge(theirs[name])
                else:
                    # deep copy: later updates of a source must not leak in
                    dest[name] = copy.deepcopy(mine.get(name) or theirs[name])
        return out
