"""AQP telemetry store: bounded reservoir samples per column (and per
tracked column tuple), exact per-code sketches for dictionary columns, and
KDE synopses fitted on demand and cached by reservoir version.
Counterpart: `repro/data/aqp_store.py` (Reservoir, MultiReservoir,
CategoricalSketch, SynopsisCache, TelemetryStore).

Reservoirs stay numpy on the host with `np.random.default_rng(seed)`, the
same code as the reference, so both packages keep bit-identical samples of
one stream.  Synopsis tensors live on the store's device.  One deliberate
difference: `_fit_cached` fits with the engine's backend (the reference
always fits on its plain path), so on the card PLUGIN's Psi6 and Psi4 run
through the pairwise kernel, LSCV_h through the sv_precompute and lscv_grid
kernels and LSCV_H's objective through the gh_fused kernel.

The cache also holds the RFF density synopses of full-H groups, beside
their exact synopses, sized by their own `nbytes`.

Not ported yet, raising NotImplementedError when asked for: tiered
reservoirs (ROADMAP queue 1.7), count-min sketches (queue 1.7), version
subscriptions and admission sessions (queue 1.11) and checkpoints (queue
1.12; `repro_torch.convert.store_from_state` reads a reference snapshot).
"""
from __future__ import annotations

import threading
import zlib
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.aqp import KDESynopsis, canonical_selector
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

    def load_state(self, buf: np.ndarray, meta: Dict[str, object]) -> None:
        super().load_state(buf, meta)
        self.backfilled = bool(meta.get("backfilled", False))


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
    guarded by one lock."""

    def __init__(self, max_entries: int = 128,
                 max_bytes: Optional[int] = None):
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

    def get(self, column: ColumnKey, selector: str, version: int, *,
            backend: str) -> Optional[KDESynopsis]:
        key = (column, canonical_selector(selector), backend)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent[0] == version:
                self.hits += 1
                self._entries.move_to_end(key)        # LRU: refresh recency
                return ent[1]
            self.misses += 1
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

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries), "bytes": self._bytes,
                    "evictions": self.evictions, "oversize": self.oversize}


class TelemetryStore:
    """Streams telemetry columns into reservoirs and answers AqpQuery batches
    from KDE synopses on `device` (default: the CUDA device; pass
    `device="cpu"` for the plain path on the CPU)."""

    def __init__(self, capacity: int = 4096, seed: int = 0,
                 cache_entries: int = 128, cache_bytes: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        # reads of the registries are unlocked by design (query paths
        # tolerate a stale view); every mutation holds _write_lock
        self.columns: Dict[str, Reservoir] = {}         # guarded-by: _write_lock (writes)
        self.joints: Dict[Tuple[str, ...], MultiReservoir] = {}  # guarded-by: _write_lock (writes)
        self.categoricals: Dict[str, CategoricalSketch] = {}  # guarded-by: _write_lock (writes)
        self.capacity = capacity
        self.seed = seed
        self.cache = SynopsisCache(max_entries=cache_entries,
                                   max_bytes=cache_bytes)
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

    def track_categorical(self, column: str, max_codes: int = 4096,
                          kind: str = "exact") -> None:
        """Register an exact per-code sketch for a dictionary column, before
        the column's first `add_batch` (the exact Eq path needs the sketch to
        cover the whole stream)."""
        if kind == "cm":
            raise _not_ported("the count-min sketch (kind='cm')", "1.7")
        if kind != "exact":
            raise ValueError(f"unknown sketch kind {kind!r}; expected "
                             f"'exact' or 'cm'")
        with self._write_lock:
            if column not in self.categoricals:
                self.categoricals[column] = CategoricalSketch(
                    max_codes=max_codes)

    def track_tiered(self, *args, **kwargs) -> None:
        raise _not_ported("TieredReservoir (track_tiered)", "1.7")

    def subscribe(self, fn) -> None:
        raise _not_ported("version subscriptions", "1.11")

    def session(self, *args, **kwargs) -> None:
        raise _not_ported("admission sessions", "1.11")

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
        with self._write_lock:
            for name, values in stats.items():
                if name not in self.columns:
                    self.columns[name] = Reservoir(self.capacity,
                                                   seed=self._col_seed(name))
                self.columns[name].add(values)
                sketch = self.categoricals.get(name)
                if sketch is not None:
                    sketch.add(values)
            for cols, rows in joint_rows.items():
                self.joints[cols].add(rows)

    def synopsis(self, column: str, selector: str = "plugin",
                 backend: Optional[str] = None) -> KDESynopsis:
        res = self.columns.get(column)
        if res is None:
            raise KeyError(f"unknown column {column!r}; "
                           f"have {sorted(self.columns)}")
        return self._fit_cached(column, res, selector, backend)

    def joint_synopsis(self, columns: Sequence[str], selector: str = "plugin",
                       backend: Optional[str] = None) -> KDESynopsis:
        """Joint synopsis over a tracked column tuple: per-axis diagonal
        bandwidths (plugin / silverman), scalar LSCV_h, or full-H LSCV_H."""
        key = tuple(columns)
        res = self.joints.get(key)
        if res is None:
            raise KeyError(f"no joint reservoir for columns {key!r}; call "
                           f"track_joint({key!r}) before add_batch "
                           f"(have {sorted(self.joints)})")
        return self._fit_cached(key, res, selector, backend)

    def _fit_cached(self, key: ColumnKey, res: Reservoir, selector: str,
                    backend: Optional[str]) -> KDESynopsis:
        """Fit-or-fetch at the reservoir's current version, fitting with
        `backend` (None: the device's default).  Each backend keeps its own
        cache entry, so an answer never depends on which backend fitted a
        column first."""
        selector = canonical_selector(selector)
        backend = resolve_backend(backend, self.device)
        syn = self.cache.get(key, selector, res.version, backend=backend)
        if syn is None:
            syn = KDESynopsis.fit(res.sample(), selector=selector,
                                  max_sample=self.capacity, backend=backend,
                                  device=self.device)
            syn.n_source = res.n_seen
            self.cache.put(key, selector, res.version, syn, backend=backend)
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

    def query(self, queries, selector: str = "plugin",
              backend: Optional[str] = None, mode: str = "batch"):
        """Answer a mixed batch of AqpQuery specs in one engine call; returns
        AqpResult rows in submission order."""
        return self.shared_engine(selector, backend).execute(queries,
                                                             mode=mode)
