"""Admission and micro-batch scheduling for the AQP QueryEngine.
Counterpart: `repro/core/aqp_admission.py`.

One batched pass answers a thousand range queries for barely more than one,
but concurrent callers of `QueryEngine.execute` each pay their own
planning, launches and host work.  Here callers submit `AqpQuery` specs and
get futures back, while the session coalesces pending specs across callers
into micro-batches and flushes them through the engine's execution core.

  `AdmissionQueue` — pure bookkeeping: pending entries bucketed by
                     (column tuple, selector, tier, synopsis version),
                     per-bucket oldest-submit timestamps, queue depth.  No
                     locking and no execution: the session owns both.
  `AqpSession`     — the long-lived, thread-safe admission surface:

      session = store.session(watermark=32, max_delay=0.005)
      fut = session.submit(AqpQuery("count", (Range("loss", 1, 4),)))
      fut.result(timeout=5)   # AqpResult (a list of them for GROUP BY specs)

Priority classes: a submission's `priority` maps to a tier budget over the
store's `TieredReservoir`s ("coarse" -> tier 0, "full" -> the whole sample
by default; `priority_tiers` changes the map).  The tier rides in the bucket
key, so a coarse ticket never queues behind, or coalesces into, a
full-sample pass: it flushes on its own small-sample plan and reports a
wider confidence interval.  Columns without tiered reservoirs ignore the
budget.

A bucket flushes when it reaches `watermark` pending queries (inline, on the
submitting thread), when its oldest entry ages past `max_delay` (a daemon
flusher thread, or `poll()` for single-threaded callers), on `flush()`
(reason "manual") and on `close()` (reason "close").  Flushes run through
`QueryEngine.run_compiled`, the engine's own execution, so a session's
answers are bit-identical to `execute()` of the same specs however they
were coalesced.  On the "cuda" backend that rests on the range, box and
GROUP BY kernels cutting the sample from its size alone
(`kernels/_launch.fixed_range`): a query's sums do not depend on what else
rides in its micro-batch.  Full-H answers (paths qmc, qmc:rff) are the
exception, in the reference as here: their Halton nodes span the hull of
the boxes that share a group, and the node count follows the narrowest of
them, so such an answer depends on its micro-batch's boxes.

Backpressure: `max_pending` bounds the pending set (unbounded by default).
At the bound the `overflow` policy parks the submitting thread until a
flush frees room ("block") or raises `AdmissionFull` ("shed"); both are
counted in `stats()` and in `store.stats()["admission"]`.

Version invalidation: the session subscribes to the store's version-change
notifications; when `add_batch` bumps a reservoir, pending buckets keyed to
the stale version are re-keyed to the new one (`stats()["invalidations"]`),
so a flush never mixes synopsis versions and results carry the version
that answered them.

Flushes launch kernels from the submitting thread (watermark), the flusher
thread (deadline) and fit workers: each launch goes on the launching
thread's current CUDA stream, and its outputs are read back on that thread.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch import obs
from repro_torch.device import resolve_backend

from .aqp_query import AqpQuery, AqpResult, QueryEngine, _Compiled, _tier_key

FLUSH_WATERMARK = "watermark"
FLUSH_DEADLINE = "deadline"
FLUSH_MANUAL = "manual"
FLUSH_CLOSE = "close"
FLUSH_FIT = "fit"        # re-flush after an offloaded synopsis fit lands

# Selectors whose first fit is superlinear (the paper's O(n^2) LSCV passes):
# with `fit_offload=True` a bucket needing one of these fits hands the fit to
# a worker thread instead of stalling the flusher (canonical names, see
# `canonical_selector`; the scalar and full-matrix LSCV pair stay distinct).
SLOW_SELECTORS = frozenset({"lscv_h", "lscv_H"})

# priority class -> tier budget: "coarse" answers from the smallest tier of
# a TieredReservoir, "full" from the whole sample (None = no budget)
DEFAULT_PRIORITY_TIERS: Dict[str, Optional[int]] = {"full": None, "coarse": 0}

# Session ids label each session's registry counters.  The pid component
# keeps ids distinct across serving processes: a registry restored from
# another process's state carries its counters, and a new session reusing
# an old label would resume (inflate) the dead session's totals.
_SESSION_IDS = itertools.count(1)


def _new_session_id() -> str:
    return f"{os.getpid():x}.{next(_SESSION_IDS)}"


class AdmissionFull(RuntimeError):
    """submit() refused: the session is at `max_pending` and its overflow
    policy is "shed".  The caller should retry later or back off."""


class _Ticket:
    """One submission: a future plus the scatter state for its compiled parts
    (GROUP BY specs expand to one part per category)."""

    __slots__ = ("future", "parts", "remaining", "single", "failed")

    def __init__(self, n_parts: int, single: bool):
        self.future: Future = Future()
        self.parts: List[Optional[AqpResult]] = [None] * n_parts
        self.remaining = n_parts
        self.single = single
        self.failed = False


class _Pending:
    """One compiled execution unit awaiting flush.  `ctx` carries the submit
    span's (trace_id, span_id) across the submit->flusher thread hop so the
    flush span can parent onto it (None when tracing is disabled)."""

    __slots__ = ("compiled", "ticket", "part", "submitted_at", "ctx")

    def __init__(self, compiled: _Compiled, ticket: _Ticket, part: int,
                 submitted_at: float, ctx: Optional[Tuple[int, int]] = None):
        self.compiled = compiled
        self.ticket = ticket
        self.part = part
        self.submitted_at = submitted_at
        self.ctx = ctx


# (column-or-tuple, selector, tier-or-None, version)
BucketKey = Tuple[object, str, Optional[int], int]


class AdmissionQueue:
    """Pending micro-batches keyed by (column tuple, selector, tier,
    synopsis version).  Pure data structure — the owning session serializes
    access."""

    def __init__(self):
        self.buckets: "OrderedDict[BucketKey, List[_Pending]]" = OrderedDict()
        self.depth = 0

    def add(self, key: BucketKey, pending: _Pending) -> int:
        bucket = self.buckets.setdefault(key, [])
        bucket.append(pending)
        self.depth += 1
        return len(bucket)

    def pop(self, key: BucketKey) -> List[_Pending]:
        bucket = self.buckets.pop(key, [])
        self.depth -= len(bucket)
        return bucket

    def pop_all(self) -> List[Tuple[BucketKey, List[_Pending]]]:
        out = list(self.buckets.items())
        self.buckets.clear()
        self.depth = 0
        return out

    def oldest(self, key: BucketKey) -> float:
        return self.buckets[key][0].submitted_at

    def first_due(self, now: float, max_delay: float,
                  skip: frozenset = frozenset()) -> Optional[BucketKey]:
        """The longest-waiting bucket whose deadline has passed, if any.
        Buckets in `skip` (fit-in-progress) are passed over — their deadline
        is deliberately on hold until the offloaded fit lands."""
        best = None
        best_ts = None
        for key, bucket in self.buckets.items():
            if key in skip:
                continue
            ts = bucket[0].submitted_at
            if now - ts >= max_delay and (best_ts is None or ts < best_ts):
                best, best_ts = key, ts
        return best

    def next_deadline(self, max_delay: float) -> Optional[float]:
        if not self.buckets:
            return None
        return min(b[0].submitted_at for b in self.buckets.values()) + max_delay

    def rekey(self, stale: BucketKey, fresh: BucketKey) -> int:
        """Move a stale-version bucket under the bumped version's key; the
        merged bucket keeps the earliest submit time first so deadlines hold."""
        moved = self.buckets.pop(stale, [])
        if not moved:
            return 0
        bucket = self.buckets.setdefault(fresh, [])
        bucket.extend(moved)
        bucket.sort(key=lambda p: p.submitted_at)
        return len(moved)


class AqpSession:
    """Streaming admission over a `QueryEngine` (see module docstring).

    watermark  — flush a bucket as soon as it holds this many pending queries
                 (None disables size-triggered flushes)
    max_delay  — seconds a pending query may wait before its bucket flushes
                 (None disables deadline flushes; with both disabled only
                 `flush()`/`close()` drain the queue)
    auto_flush — run the deadline flusher on a daemon thread; pass False for
                 single-threaded callers and tests, and pump via `poll()`
    max_pending — bound on the pending queue depth (None: unbounded).  At
                 the bound, `overflow` decides: "block" parks the submitting
                 thread until a flush frees room (needs a flusher — the
                 auto_flush thread, watermark flushes from other submitters,
                 or an external poll()er); "shed" raises `AdmissionFull`
                 immediately so the caller can back off.  A single spec
                 whose compiled parts alone exceed the bound (a wide GROUP
                 BY) is admitted once the queue is empty rather than
                 deadlocking.  Both outcomes are counted in `stats()`.
    time_fn    — injectable clock (tests drive deadlines deterministically)
    priority_tiers — {class name: tier budget} (default: "full" -> None,
                 "coarse" -> 0); `submit(query, priority=...)` picks one
    default_priority — class used when submit() gets no explicit priority
    fit_offload — guard against slow first fits: when a due bucket's
                 selector is in `SLOW_SELECTORS` and its synopsis is not yet
                 in the store cache (an O(n^2) LSCV fit stands between the
                 flush and its answers), hand the fit to a worker thread and
                 leave the bucket queued (skipped by the deadline scan)
                 instead of stalling the flusher — other buckets keep
                 flushing on time.  The worker re-flushes the bucket with
                 reason "fit" once the synopsis lands; deferred queries are
                 counted in `stats()["fit_requeued"]`.
    """

    def __init__(self, engine: QueryEngine, watermark: Optional[int] = 32,
                 max_delay: Optional[float] = 0.005, auto_flush: bool = True,
                 selector: Optional[str] = None, backend: Optional[str] = None,
                 max_pending: Optional[int] = None, overflow: str = "block",
                 time_fn: Callable[[], float] = time.monotonic,
                 priority_tiers: Optional[Dict[str, Optional[int]]] = None,
                 default_priority: str = "full",
                 fit_offload: bool = False):
        if watermark is not None and watermark < 1:
            raise ValueError(f"watermark must be >= 1, got {watermark}")
        if max_delay is not None and max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {max_delay}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if overflow not in ("block", "shed"):
            raise ValueError(f"overflow must be 'block' or 'shed', "
                             f"got {overflow!r}")
        self.priority_tiers = dict(priority_tiers
                                   if priority_tiers is not None
                                   else DEFAULT_PRIORITY_TIERS)
        if default_priority not in self.priority_tiers:
            raise ValueError(
                f"default_priority {default_priority!r} not in "
                f"priority_tiers {sorted(self.priority_tiers)}")
        self.default_priority = default_priority
        self.engine = engine
        self.watermark = watermark
        self.max_delay = max_delay
        self.max_pending = max_pending
        self.overflow = overflow
        self.selector = selector or engine.selector
        self.backend = resolve_backend(backend or engine.backend, engine.store.device)
        self.time_fn = time_fn
        self.fit_offload = fit_offload
        self._auto_flush = auto_flush
        self._lock = threading.RLock()
        self._wakeup = threading.Condition(self._lock)
        self._queue = AdmissionQueue()      # guarded-by: _lock
        # BucketKeys with a fit in flight
        self._fitting: set = set()          # guarded-by: _lock
        self._closed = False                # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        store = engine.store
        # Counters live in the store's metrics registry, labelled with this
        # session's id, not on the session object: the registry outlives the
        # session, so `store.stats()["admission"]` aggregates every session
        # ever opened.  The attribute names (`session.submitted`, ...) are
        # read-only views below.
        self.sid = _new_session_id()
        metrics = getattr(store, "metrics", None)
        if metrics is None:
            metrics = obs.MetricsRegistry()     # engine over a bare store
        self.metrics = metrics
        sid = self.sid
        self._c_submitted = metrics.counter("aqp.admission.submitted",
                                            session=sid)
        self._c_executed = metrics.counter("aqp.admission.executed",
                                           session=sid)
        self._c_flushes = metrics.counter("aqp.admission.flushes",
                                          session=sid)
        self._c_coalesced = metrics.counter("aqp.admission.coalesced",
                                            session=sid)
        self._c_invalidations = metrics.counter("aqp.admission.invalidations",
                                                session=sid)
        self._c_blocked = metrics.counter("aqp.admission.blocked",
                                          session=sid)
        self._c_shed = metrics.counter("aqp.admission.shed", session=sid)
        self._c_fit_requeued = metrics.counter("aqp.admission.fit_requeued",
                                               session=sid)
        self._c_batch_rows = metrics.counter("aqp.admission.batch_rows",
                                             session=sid)
        self._g_depth = metrics.gauge("aqp.admission.depth", session=sid)
        self._g_max_depth = metrics.gauge("aqp.admission.max_depth",
                                          session=sid)
        self._h_batch = metrics.histogram(
            "aqp.admission.batch_size",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
            session=sid)
        # A session abandoned without close() may hold pending entries its
        # flusher never drains (the thread exits when the weakref dies);
        # zero its depth gauge at collection so store-level `pending` does
        # not leak phantom queries forever.
        weakref.finalize(self, self._g_depth.set, 0.0)
        unsub = getattr(store, "subscribe", None)
        self._unsubscribe = None
        if unsub is not None:
            # subscribe through a weakref: a store outlives its sessions, and
            # a strong listener would pin every un-close()d session (and its
            # flusher thread) for the store's lifetime
            ref = weakref.ref(self)

            def _notify(bumped):
                session = ref()
                if session is None:
                    unsubscribe()          # self-clean once collected
                else:
                    session._on_versions(bumped)
            unsubscribe = unsub(_notify)
            self._unsubscribe = unsubscribe
        register = getattr(store, "_register_session", None)
        if register is not None:
            register(self)

    # -- client surface ------------------------------------------------------

    def submit(self, query: AqpQuery,
               priority: Optional[str] = None) -> Future:
        """Admit one spec; returns a future resolving to its `AqpResult`
        (a list of them for GROUP BY specs, in category order).  Compilation
        and synopsis-key resolution run synchronously, so malformed specs and
        unknown columns raise here, not inside the future.

        `priority` picks a class from `priority_tiers` (default
        `default_priority`): its tier budget keys the pending bucket, so
        coarse-tier tickets flush on small-sample plans without queueing
        behind full-accuracy passes."""
        name = self.default_priority if priority is None else priority
        if name not in self.priority_tiers:
            raise ValueError(f"unknown priority {name!r}; "
                             f"have {sorted(self.priority_tiers)}")
        tier = self.priority_tiers[name]
        # The submit span is the root of the query's trace; its ctx rides on
        # every _Pending so the flush (another thread) can parent onto it.
        with obs.span("admission.submit", aggregate=query.aggregate,
                      priority=name, session=self.sid) as sp:
            parts = self.engine.compile(query)
            resolver = self.engine.resolver(self.selector, self.backend, tier=tier)
            keyed = []
            for c in parts:
                key3, c2, version = resolver.key_for(c)
                keyed.append((key3 + (version,), c2))
            ticket = _Ticket(len(parts), single=query.group_by is None)
            due: List[BucketKey] = []
            with self._lock:
                if self._closed:
                    raise RuntimeError("cannot submit to a closed AqpSession")
                self._admit(len(keyed))
                now = self.time_fn()
                for part, (key, c) in enumerate(keyed):
                    size = self._queue.add(
                        key, _Pending(c, ticket, part, now, ctx=sp.ctx))
                    if self.watermark is not None and size >= self.watermark:
                        due.append(key)
                self._c_submitted.inc()
                self.metrics.counter("aqp.admission.priority",
                                     session=self.sid, priority=name).inc()
                self._g_depth.set(self._queue.depth)
                self._g_max_depth.max(self._queue.depth)
                if self._auto_flush and self.max_delay is not None \
                        and self._thread is None:
                    self._start_flusher()
                self._wakeup.notify_all()
        # Past-deadline buckets flush first (oldest-first, via poll): without
        # this, a lone sub-watermark ticket whose deadline has passed would
        # keep waiting for the background flusher even while fresh submits
        # prove the session is alive.
        if self.max_delay is not None:
            self.poll()
        for key in due:
            self._flush_key(key, FLUSH_WATERMARK)
        return ticket.future

    def submit_many(self, queries: Sequence[AqpQuery],
                    priority: Optional[str] = None) -> List[Future]:
        return [self.submit(q, priority=priority) for q in queries]

    def execute(self, queries: Union[AqpQuery, Sequence[AqpQuery]]):
        """Submit-and-wait convenience: admit the specs, flush anything still
        pending from them, and return results like `QueryEngine.execute`
        (GROUP BY rows flattened in place)."""
        single = isinstance(queries, AqpQuery)
        futs = self.submit_many([queries] if single else list(queries))
        self.flush()
        out: List[AqpResult] = []
        for fut in futs:
            res = fut.result()
            out.extend(res if isinstance(res, list) else [res])
        return out

    def poll(self, now: Optional[float] = None) -> int:
        """Flush every bucket whose max-delay deadline has passed; returns the
        number of buckets flushed.  The manual pump for auto_flush=False."""
        if self.max_delay is None:
            return 0
        flushed = 0
        while True:
            with self._lock:
                key = self._queue.first_due(
                    self.time_fn() if now is None else now, self.max_delay,
                    skip=frozenset(self._fitting))
            if key is None:
                return flushed
            flushed += self._flush_key(key, FLUSH_DEADLINE)

    def flush(self) -> int:
        """Flush every pending bucket now; returns queries flushed."""
        return self._flush_all(FLUSH_MANUAL)

    def close(self) -> None:
        """Stop the flusher, flush everything still pending (reason "close"),
        and detach from the store.  Idempotent; submit() afterwards raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._wakeup.notify_all()
            thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)
        self._flush_all(FLUSH_CLOSE)
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None

    def __enter__(self) -> "AqpSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def pending(self) -> int:
        with self._lock:
            return self._queue.depth

    # Counter attributes: views over this session's registry instruments.

    @property
    def submitted(self) -> int:
        return int(self._c_submitted.value)

    @property
    def executed(self) -> int:
        return int(self._c_executed.value)

    @property
    def flushes(self) -> int:
        return int(self._c_flushes.value)

    @property
    def coalesced(self) -> int:
        return int(self._c_coalesced.value)

    @property
    def invalidations(self) -> int:
        return int(self._c_invalidations.value)

    @property
    def blocked(self) -> int:
        return int(self._c_blocked.value)

    @property
    def shed(self) -> int:
        return int(self._c_shed.value)

    @property
    def fit_requeued(self) -> int:
        return int(self._c_fit_requeued.value)

    @property
    def max_depth(self) -> int:
        return int(self._g_max_depth.value)

    @property
    def flush_reasons(self) -> Dict[str, int]:
        return {labels["reason"]: int(n) for labels, n in
                self.metrics.collect_counters("aqp.admission.flush_reason",
                                              session=self.sid)}

    @property
    def priority_counts(self) -> Dict[str, int]:
        return {labels["priority"]: int(n) for labels, n in
                self.metrics.collect_counters("aqp.admission.priority",
                                              session=self.sid)}

    def stats(self) -> Dict[str, object]:
        """This session's counters as a dict: a view over the metrics
        registry (each value is also there under `aqp.admission.*` with the
        `session=sid` label)."""
        with self._lock:
            pending = self._queue.depth
        flushes = self.flushes
        mean_batch = (self._c_batch_rows.value / flushes
                      if flushes else 0.0)
        return {
            "submitted": self.submitted,
            "executed": self.executed,
            "pending": pending,
            "flushes": flushes,
            "coalesced": self.coalesced,
            "mean_batch": mean_batch,
            "flush_reasons": self.flush_reasons,
            "invalidations": self.invalidations,
            "max_pending": self.max_pending,
            "blocked": self.blocked,
            "shed": self.shed,
            "fit_requeued": self.fit_requeued,
            "max_depth": self.max_depth,
            "priorities": self.priority_counts,
            "plan_cache": self.engine.plans.stats(),
        }

    # -- internals -----------------------------------------------------------

    # Idle flusher threads re-check liveness at this cadence; it bounds both
    # how long an abandoned (never close()d) session stays pinned by its own
    # thread and the latency of noticing closure without a wakeup.
    _FLUSHER_TICK = 0.5

    # Blocked submitters re-check capacity at this cadence even without a
    # wakeup, so an external poll()er draining the queue out-of-band still
    # unblocks them promptly.
    _BLOCK_TICK = 0.05

    def _admit(self, n_parts: int) -> None:  # guarded-by: _lock
        """Enforce the max_pending bound (lock held).  A ticket whose parts
        alone exceed the bound is admitted once the queue is empty — refusing
        it forever (shed) or parking it forever (block) would deadlock wide
        GROUP BY specs behind a bound meant for queue depth."""
        if self.max_pending is None:
            return

        def over() -> bool:  # guarded-by: _lock
            return (self._queue.depth > 0
                    and self._queue.depth + n_parts > self.max_pending)

        if not over():
            return
        if self.overflow == "shed":
            self._c_shed.inc()
            raise AdmissionFull(
                f"admission queue at max_pending={self.max_pending} "
                f"({self._queue.depth} pending); resubmit later")
        self._c_blocked.inc()
        while over():
            self._wakeup.wait(timeout=self._BLOCK_TICK)
            if self._closed:
                raise RuntimeError(
                    "AqpSession closed while submit was blocked on "
                    "max_pending")

    def _start_flusher(self) -> None:  # guarded-by: _lock
        self._thread = threading.Thread(
            target=AqpSession._flusher_main, args=(weakref.ref(self),),
            name="aqp-admission-flusher", daemon=True)
        self._thread.start()

    @staticmethod
    def _flusher_main(ref: "weakref.ref") -> None:
        # Holds the session only via weakref between iterations (and for at
        # most _FLUSHER_TICK inside one): when the last external reference
        # drops without close(), the thread notices and exits so the session
        # can be collected.
        while True:
            session = ref()
            if session is None or session._closed:
                return
            with session._wakeup:
                deadline = session._queue.next_deadline(session.max_delay)
                tick = AqpSession._FLUSHER_TICK
                if deadline is None:
                    timeout = tick
                else:
                    timeout = min(max(deadline - session.time_fn(), 0.0), tick)
                if timeout > 0:
                    session._wakeup.wait(timeout=timeout)
                if session._closed:
                    return
            session.poll()
            session = None          # drop the strong ref before sleeping again

    def _on_versions(self, bumped: Dict[object, int]) -> None:
        """Store notification: add_batch bumped these reservoir versions.
        Re-key affected pending buckets so the flush executes (and reports)
        against the fresh synopsis version."""
        with self._lock:
            for key in list(self._queue.buckets):
                colkey, sel, tier, version = key
                fresh = bumped.get(colkey)
                if fresh is not None and fresh != version:
                    self._c_invalidations.inc(self._queue.rekey(
                        key, (colkey, sel, tier, fresh)))

    def _flush_key(self, key: BucketKey, reason: str) -> int:
        if self.fit_offload and reason != FLUSH_FIT \
                and self._maybe_offload(key):
            return 0
        with self._lock:
            pendings = self._queue.pop(key)
            if pendings:
                self._g_depth.set(self._queue.depth)
                self._wakeup.notify_all()     # free submitters at max_pending
        if not pendings:
            return 0
        self._run_flush(key, pendings, reason)
        return 1

    def _maybe_offload(self, key: BucketKey) -> bool:
        """True when this bucket's flush would block on a slow synopsis fit
        and the fit was handed to (or is already with) a worker thread; the
        bucket stays queued — skipped by the deadline scan — until the
        worker re-flushes it with reason "fit"."""
        colkey, sel, tier, version = key
        if sel not in SLOW_SELECTORS:
            return False
        cache = getattr(self.engine.store, "cache", None)
        peek = getattr(cache, "peek", None)
        if peek is None:
            return False
        if peek(_tier_key(colkey, tier), sel, version,
                backend=self.backend) is not None:
            return False                      # already fitted: flush inline
        with self._lock:
            if self._closed or key not in self._queue.buckets:
                return False
            if key in self._fitting:
                return True                   # a worker is already on it
            self._fitting.add(key)
            self._c_fit_requeued.inc(len(self._queue.buckets[key]))
        threading.Thread(
            target=AqpSession._fit_worker, args=(weakref.ref(self), key),
            name="aqp-admission-fit", daemon=True).start()
        return True

    @staticmethod
    def _fit_worker(ref: "weakref.ref", key: BucketKey) -> None:
        """Run one slow synopsis fit off the flusher thread, then re-flush
        the bucket that was waiting on it (reason "fit").  A fit failure is
        left for the flush to raise again: it lands in the tickets' futures
        through the flush's error path rather than dying here."""
        session = ref()
        if session is None:
            return
        colkey, sel, tier, version = key
        try:
            resolver = session.engine.resolver(sel, session.backend, tier=tier)
            with obs.span("admission.fit", key=colkey, selector=sel,
                          tier=tier, session=session.sid):
                resolver.plan_for((colkey, sel, tier), version)
        except BaseException:    # the flush below raises it into the futures
            pass
        finally:
            with session._lock:
                session._fitting.discard(key)
            session._flush_key(key, FLUSH_FIT)

    def _flush_all(self, reason: str) -> int:
        with self._lock:
            batches = self._queue.pop_all()
            if batches:
                self._g_depth.set(0)
                self._wakeup.notify_all()     # free submitters at max_pending
        total = 0
        for key, pendings in batches:
            self._run_flush(key, pendings, reason)
            total += len(pendings)
        return total

    def _run_flush(self, key: BucketKey, pendings: List[_Pending],
                   reason: str) -> None:
        """Execute one micro-batch through the engine core and scatter the
        results (or the failure) onto the waiting tickets.  The bucket key
        carries the tier budget, so a coarse-priority batch executes on its
        tier's plan rather than the full sample."""
        compiled = []
        for i, p in enumerate(pendings):
            p.compiled.slot = i
            compiled.append(p.compiled)
        error: Optional[BaseException] = None
        results: List[AqpResult] = []
        # Parent the flush span onto the oldest pending's submit span: the
        # trace started at submit() continues here even though the flush runs
        # on a different thread (the ctx tuple made the hop explicitly).
        t0 = time.perf_counter()
        with obs.span("admission.flush", parent=pendings[0].ctx,
                      reason=reason, batch=len(pendings), key=key[0],
                      tier=key[2], session=self.sid):
            try:
                results = self.engine.run_compiled(
                    compiled, selector=self.selector, backend=self.backend,
                    tier=key[2])
            except BaseException as exc:        # surface through the futures
                error = exc
        if obs.enabled():
            self.metrics.histogram("aqp.admission.flush_us",
                                   session=self.sid).observe(
                (time.perf_counter() - t0) * 1e6)
        done: List[_Ticket] = []
        with self._lock:
            self._c_flushes.inc()
            self.metrics.counter("aqp.admission.flush_reason",
                                 session=self.sid, reason=reason).inc()
            self._c_batch_rows.inc(len(pendings))
            self._h_batch.observe(len(pendings))
            self._c_executed.inc(len(pendings))
            if len(pendings) > 1:
                self._c_coalesced.inc(len(pendings))
            for p in pendings:
                t = p.ticket
                if error is not None:
                    t.failed = True
                else:
                    t.parts[p.part] = results[p.compiled.slot]
                t.remaining -= 1
                if t.remaining == 0:
                    done.append(t)
        # futures resolve outside the lock: done-callbacks may re-enter the
        # session (e.g. a client submitting its next query inline)
        for t in done:
            if t.failed:
                t.future.set_exception(
                    error if error is not None
                    else RuntimeError("admission flush failed"))
            else:
                t.future.set_result(t.parts[0] if t.single else list(t.parts))
