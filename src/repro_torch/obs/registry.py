"""Thread-safe metrics registry: counters, gauges, latency histograms.
Counterpart: `repro/obs/registry.py`, copied (the port imports nothing of
`repro`), with the same snapshot and `state()` formats.

  `Counter`    — monotone float/int accumulator (`inc`)
  `Gauge`      — last-write-wins instantaneous value (`set`/`inc`/`max`)
  `Histogram`  — fixed log-spaced buckets with exact count/sum/min/max and
                 interpolated percentile summaries (p50/p95/p99)
  `MetricsRegistry`
               — the keyed collection: metrics are addressed by
                 (name, sorted label set) and created on first touch;
                 `snapshot()` renders everything to a plain JSON-safe dict,
                 `state()`/`load_state()` round-trip the exact bucket counts
                 so cumulative counters can ride in a checkpoint.

Every metric guards its mutable state with its own lock, so concurrent
updates from query, flusher and producer threads lose no increments.
Instruments are cheap enough to stay always-on; the expensive
instrumentation (span tracing, device-fenced latency timing, kernel
profiling) is gated separately in `repro_torch.obs`.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Default latency buckets in microseconds: a 1-2-5 series from 1 us to 10 s.
# Fixed (not adaptive) so histograms merge across processes and snapshots.
LATENCY_BUCKETS_US: Tuple[float, ...] = tuple(
    m * 10 ** e for e in range(7) for m in (1.0, 2.0, 5.0)) + (1e7,)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    """Canonical hashable label set; values stringified so a snapshot's JSON
    round-trip reproduces the same keys."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotone accumulator.  `inc` is atomic under the instrument's lock."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: float = 0.0):
        self._lock = threading.Lock()
        self._value = value    # guarded-by: _lock

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            v = self._value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Instantaneous value (queue depth, reservoir fill, error bound)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: float = 0.0):
        self._lock = threading.Lock()
        self._value = value    # guarded-by: _lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def max(self, v: float) -> None:
        """High-water-mark update (e.g. max queue depth)."""
        with self._lock:
            if v > self._value:
                self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            v = self._value
        return int(v) if float(v).is_integer() else v


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max.

    Percentiles interpolate linearly inside the winning bucket (standard
    Prometheus-style estimation); min/max clamp the ends so p50 of a
    single-observation histogram is that observation.
    """

    __slots__ = ("_lock", "_le", "_counts", "count", "sum", "_min", "_max")

    def __init__(self, buckets: Optional[Iterable[float]] = None):
        # RLock: summary() holds it across its percentile() calls
        self._lock = threading.RLock()
        self._le = tuple(sorted(buckets)) if buckets is not None \
            else LATENCY_BUCKETS_US                # guarded-by: _lock
        self._counts = [0] * (len(self._le) + 1)   # guarded-by: _lock
        self.count = 0                             # guarded-by: _lock
        self.sum = 0.0                             # guarded-by: _lock
        self._min = float("inf")                   # guarded-by: _lock
        self._max = float("-inf")                  # guarded-by: _lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            # the bucket search must read _le under the lock: _load() can
            # swap _le/_counts for a restored bucket layout, and an index
            # computed against the old _le can land out of range (or in the
            # wrong bucket) of the new _counts
            # (bisect without the import: bucket lists are short, 22 entries)
            i = 0
            for le in self._le:
                if v <= le:
                    break
                i += 1
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Interpolated p-quantile (p in [0, 1]) from the bucket counts."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = p * self.count
            acc = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                lo = self._le[i - 1] if i > 0 else max(0.0, self._min)
                hi = self._le[i] if i < len(self._le) else self._max
                if acc + c >= rank:
                    frac = (rank - acc) / c
                    est = lo + frac * (hi - lo)
                    return min(max(est, self._min), self._max)
                acc += c
            return self._max

    def summary(self) -> Dict[str, float]:
        # one lock scope for the whole row (the lock is re-entrant, so the
        # nested percentile() calls are fine): a concurrent observe cannot
        # produce a summary whose count and percentiles disagree
        with self._lock:
            return {
                "count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self._min if self.count else 0.0,
                "max": self._max if self.count else 0.0,
                "p50": self.percentile(0.50), "p95": self.percentile(0.95),
                "p99": self.percentile(0.99),
            }

    def _dump(self) -> Dict[str, object]:
        with self._lock:
            return {"le": list(self._le), "counts": list(self._counts),
                    "count": self.count, "sum": self.sum,
                    "min": self._min if self.count else None,
                    "max": self._max if self.count else None}

    def _load(self, d: Dict[str, object]) -> None:
        with self._lock:
            self._le = tuple(float(x) for x in d["le"])
            self._counts = [int(c) for c in d["counts"]]
            self.count = int(d["count"])
            self.sum = float(d["sum"])
            self._min = float("inf") if d.get("min") is None else float(d["min"])
            self._max = float("-inf") if d.get("max") is None else float(d["max"])


class MetricsRegistry:
    """Keyed metric collection: one instrument per (name, label set).

    Instruments are created on first touch and never removed, so counters
    from retired components (e.g. a closed `AqpSession`) keep contributing
    to aggregates — the store-level admission stats were previously dropped
    when a session was garbage-collected.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {label key -> instrument}.  (writes): the table attributes
        # are never rebound after __init__; readers only pass the reference
        # into _get/_collect, which do all dict mutation under the lock.
        self._counters: Dict[str, Dict[LabelKey, Counter]] = {}      # guarded-by: _lock (writes)
        self._gauges: Dict[str, Dict[LabelKey, Gauge]] = {}          # guarded-by: _lock (writes)
        self._histograms: Dict[str, Dict[LabelKey, Histogram]] = {}  # guarded-by: _lock (writes)

    def _get(self, table, name: str, labels: Dict[str, object], factory):
        key = _label_key(labels)
        with self._lock:
            by_label = table.setdefault(name, {})
            inst = by_label.get(key)
            if inst is None:
                inst = by_label[key] = factory()
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, name, labels, Gauge)

    def histogram(self, name: str, buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        return self._get(self._histograms, name, labels,
                         lambda: Histogram(buckets))

    # -- aggregation (the stats()-view API) ----------------------------------

    def _collect(self, table, name: str, match: Dict[str, object]
                 ) -> List[Tuple[Dict[str, str], object]]:
        want = {str(k): str(v) for k, v in match.items()}
        with self._lock:
            items = list(table.get(name, {}).items())
        out = []
        for key, inst in items:
            labels = dict(key)
            if all(labels.get(k) == v for k, v in want.items()):
                out.append((labels, inst))
        return out

    def collect_counters(self, name: str, **match):
        return [(lb, c.value) for lb, c in
                self._collect(self._counters, name, match)]

    def collect_gauges(self, name: str, **match):
        return [(lb, g.value) for lb, g in
                self._collect(self._gauges, name, match)]

    def collect_histograms(self, name: str, **match):
        return [(lb, h) for lb, h in
                self._collect(self._histograms, name, match)]

    def sum_counter(self, name: str, **match) -> float:
        total = sum(v for _lb, v in self.collect_counters(name, **match))
        return int(total) if float(total).is_integer() else total

    def sum_gauge(self, name: str, **match) -> float:
        total = sum(v for _lb, v in self.collect_gauges(name, **match))
        return int(total) if float(total).is_integer() else total

    def sum_histogram(self, name: str, **match) -> Tuple[float, int]:
        """(sum, count) pooled across every matching label set."""
        hs = self.collect_histograms(name, **match)
        return (sum(h.sum for _lb, h in hs), sum(h.count for _lb, h in hs))

    # -- snapshot / durability ----------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Plain JSON-safe dict of every instrument: the `--metrics-out`
        export format (counters/gauges as values, histograms as percentile
        summaries)."""
        with self._lock:
            counters = {n: list(t.items()) for n, t in self._counters.items()}
            gauges = {n: list(t.items()) for n, t in self._gauges.items()}
            hists = {n: list(t.items()) for n, t in self._histograms.items()}
        return {
            "counters": {n: [{"labels": dict(k), "value": c.value}
                             for k, c in entries]
                         for n, entries in counters.items()},
            "gauges": {n: [{"labels": dict(k), "value": g.value}
                           for k, g in entries]
                       for n, entries in gauges.items()},
            "histograms": {n: [{"labels": dict(k), **h.summary()}
                               for k, h in entries]
                           for n, entries in hists.items()},
        }

    def state(self) -> Dict[str, object]:
        """Durable JSON-safe state (exact bucket counts, not summaries) —
        can ride in a checkpoint manifest so cumulative counters survive a
        restart."""
        with self._lock:
            counters = {n: list(t.items()) for n, t in self._counters.items()}
            gauges = {n: list(t.items()) for n, t in self._gauges.items()}
            hists = {n: list(t.items()) for n, t in self._histograms.items()}
        return {
            "counters": [{"name": n, "labels": dict(k), "value": c.value}
                         for n, entries in counters.items()
                         for k, c in entries],
            "gauges": [{"name": n, "labels": dict(k), "value": g.value}
                       for n, entries in gauges.items()
                       for k, g in entries],
            "histograms": [{"name": n, "labels": dict(k), **h._dump()}
                           for n, entries in hists.items()
                           for k, h in entries],
        }

    def load_state(self, state: Dict[str, object]) -> None:
        """Restore instruments from `state()` output.  Existing instruments
        with the same (name, labels) are overwritten: restore replaces, it
        does not merge."""
        for ent in state.get("counters", ()):
            # repro: allow[instrument-drift] restores names a state() wrote
            c = self.counter(str(ent["name"]), **ent.get("labels", {}))
            with c._lock:
                c._value = float(ent["value"])
        for ent in state.get("gauges", ()):
            # repro: allow[instrument-drift] restores names a state() wrote
            g = self.gauge(str(ent["name"]), **ent.get("labels", {}))
            g.set(float(ent["value"]))
        for ent in state.get("histograms", ()):
            # repro: allow[instrument-drift] restores names a state() wrote
            h = self.histogram(str(ent["name"]), buckets=ent["le"],
                               **ent.get("labels", {}))
            h._load(ent)
