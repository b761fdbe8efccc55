"""Span-based tracing for the AQP serving stack.
Counterpart: `repro/obs/trace.py`, copied (the port imports nothing of
`repro`).

One query admitted through `AqpSession.submit` crosses threads (caller ->
flusher -> the kernel launches) before its CI comes back.  Every
instrumented section opens a `Span` carrying a `trace_id` shared by the
whole query and a `parent_id` linking it into a tree (admission.submit ->
admission.flush -> engine.run_compiled -> engine.plan / engine.kernel /
engine.ci).

  * injectable clock (`Tracer(clock=fake)`) so tests assert exact durations;
  * bounded in-memory ring (deque): a long-running server never grows
    unbounded trace state;
  * `contextvars` hold the current span, so nesting works within a thread
    of execution; the admission queue carries an explicit `ctx` across the
    submit -> flusher thread hop and passes it as `parent=`;
  * spans are recorded on close (end time known); `tree()` rebuilds the
    tree, `export_jsonl` writes one JSON object per line.

Timing inside a span is device-true only if the caller fences
(`repro_torch.obs.fence`, which waits for the output's CUDA stream); the
engine fences kernel outputs before closing its kernel spans.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

_ids = itertools.count(1)
_CURRENT: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("repro_torch_obs_span", default=None)


class Span:
    """One timed section.  Use as a context manager; attrs are free-form
    (coerced to str at export so they stay JSON-safe)."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "t0", "t1", "attrs", "_token")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 parent_id: Optional[int], attrs: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.attrs = attrs
        self.t0 = 0.0
        self.t1 = 0.0
        self._token = None

    @property
    def ctx(self) -> Tuple[int, int]:
        """(trace_id, span_id): enough to parent a span in another thread."""
        return (self.trace_id, self.span_id)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.t0 = self.tracer.clock()
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = self.tracer.clock()
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        self.tracer._record(self)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "t0": self.t0, "t1": self.t1,
            "duration_us": (self.t1 - self.t0) * 1e6,
            "attrs": {str(k): str(v) for k, v in self.attrs.items()},
        }


class _NoopSpan:
    """Disabled-mode stand-in: every operation is a no-op, `ctx` is None so
    downstream instrumentation knows there is nothing to parent onto."""

    __slots__ = ()
    ctx = None
    duration_s = 0.0

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Bounded span recorder.

    `span(name, parent=..., **attrs)` opens a span whose parent is, in
    order of preference: the explicit `parent` ctx tuple, else the current
    span in this execution context, else none (a new root — which also
    mints a fresh trace id).
    """

    def __init__(self, clock=time.perf_counter, capacity: int = 4096):
        self.clock = clock
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def span(self, name: str, parent: Optional[Tuple[int, int]] = None,
             **attrs) -> Span:
        if parent is not None:
            trace_id, parent_id = parent
        else:
            cur = _CURRENT.get()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
            else:
                trace_id, parent_id = next(_ids), None
        return Span(self, name, trace_id, parent_id, attrs)

    def current(self) -> Optional[Span]:
        return _CURRENT.get()

    def _record(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)

    def spans(self, trace_id: Optional[int] = None) -> List[Span]:
        """Closed spans, oldest first (optionally one trace only)."""
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def tree(self, trace_id: int) -> List[Dict[str, Any]]:
        """Reconstruct the span tree for one trace as nested dicts
        (each node: span fields + "children" sorted by start time)."""
        spans = self.spans(trace_id)
        nodes = {s.span_id: {**s.as_dict(), "children": []} for s in spans}
        roots: List[Dict[str, Any]] = []
        for s in sorted(spans, key=lambda s: s.t0):
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id) if s.parent_id else None
            (parent["children"] if parent else roots).append(node)
        return roots

    def export_jsonl(self, path: str,
                     trace_id: Optional[int] = None) -> int:
        """Append closed spans as JSON lines; returns the number written."""
        spans = self.spans(trace_id)
        with open(path, "a", encoding="utf-8") as f:
            for s in spans:
                f.write(json.dumps(s.as_dict(), sort_keys=True) + "\n")
        return len(spans)
