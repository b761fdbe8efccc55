"""`repro_torch.obs`: observability for the port's AQP stack.
Counterpart: `repro/obs/__init__.py`, with `registry.py` and `trace.py`
copied beside it (the port imports nothing of `repro`).

Two kinds of instrumentation with different costs:

  * **Always on**: counters and gauges (`MetricsRegistry`).  They back the
    public `stats()` dicts and cost one lock and one add per event.  A
    store's registry keeps the counters of closed sessions, so
    `store.stats()["admission"]` aggregates every session ever opened.

  * **Gated on `enabled()`**: span tracing, per-path latency histograms
    with device fencing, and kernel profiling.  Fencing waits for the
    card, which changes how far the host runs ahead of it, so these are
    opt-in: call `enable()`, or pass `--metrics-out` / `--trace-out` to
    `python -m repro_torch.launch.serve --mode aqp`.  Unlike the reference,
    which also reads an environment knob, nothing here reads the
    environment.  When disabled, `span()` returns a shared no-op object,
    `fence()` returns at once and the kernel wrappers take the branch that
    calls the launcher directly: answers are bit-identical either way.

  * **While a `torch.profiler` records**: `span()` also opens a profiler
    range of the span's name, with obs enabled or not: an op-level range
    (`_RecordFunctionFast`, a seventh of `record_function`'s cost), a
    CPU event of that name, not a user annotation.  Disabled, that range
    is all it does: no ring span, no fence, so a profiled window keeps the
    unfenced timing and its host timeline names the program's spans beside
    the card's kernels, on the profiler's clock.

Span catalogue: the reference's spans (`docs/observability.md`) keep their
names and labels here; `synopsis.fit` also wraps every exact fit
(`KDESynopsis.fit`: `backend`, `selector`, `n`, `d`), and `engine.kernel`
/ `engine.ci` carry the port's full-H path `qmc:kernel` (`qmc:kernel:cuda`
on the card, where its CI is `ci="fused"`).  The port adds five spans:

    store.add_batch  rows, columns  TelemetryStore.add_batch, joint
                                    stacking included
    engine.compile   n              QueryEngine.execute's compile of its
                                    specs, before engine.run_compiled
    nm.eval          points         one Nelder-Mead round trip: a batch of
                                    points evaluated and their values copied
                                    to the host (the start, one a step, one
                                    a shrink; the points add up to nfev)
    qmc.plan         q, d, n_qmc    quasi-MC host planning (_qmc_plan),
                                    inside engine.kernel / engine.ci
    qmc.draws        m, K, d        the kernel-centred path's standard-
                                    normal draws built on the device
                                    (kernel_normals), once a (K, d) and
                                    sample size, inside engine.kernel

Scoping: each `TelemetryStore` owns a registry (`store.metrics`); kernel
profiling writes to the process-global registry (`get_registry()`), since
kernels have no store handle.  `export_json` merges registries into one
snapshot file in the reference's format (`scripts/validate_metrics.py`
checks it).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

from .registry import Counter, Gauge, Histogram, LATENCY_BUCKETS_US, MetricsRegistry
from .trace import NOOP_SPAN, Span, Tracer, _NoopSpan

__all__ = [
    "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS_US", "MetricsRegistry",
    "NOOP_SPAN", "Span", "Tracer", "disable", "enable", "enabled", "fence",
    "export_json", "get_registry", "get_tracer", "set_tracer", "span",
]

_enabled = False
_registry = MetricsRegistry()
_tracer = Tracer()


def enabled() -> bool:
    """True when the expensive instrumentation (tracing, fenced latency
    histograms, kernel profiling) is active."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def get_registry() -> MetricsRegistry:
    """The process-global registry (kernel profiling)."""
    return _registry


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the global tracer (tests inject a fake-clock tracer); returns
    the previous one so callers can restore it."""
    global _tracer
    prev, _tracer = _tracer, tracer
    return prev


class _ProfilerRange(_NoopSpan):
    """A span while a `torch.profiler` records and obs is disabled: a
    profiler range of the span's name, on the host timeline of the trace
    that holds the card's kernels.  Nothing goes to the ring; as on the
    no-op, `ctx` is None and `set` drops its attributes."""

    __slots__ = ("range",)

    def __init__(self, name: str):
        self.range = _RecordFunctionFast(name)

    def __enter__(self) -> "_ProfilerRange":
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.range.__exit__(*exc)


def span(name: str, parent: Optional[Tuple[int, int]] = None, **attrs):
    """Open a span.  With nothing on, the shared no-op (a disabled
    `with obs.span(...):` costs one call, a flag check and no allocation);
    while a `torch.profiler` records, a profiler range of the same name;
    when enabled, a span on the global tracer, which also opens that range
    while the profiler records.  None of them fences or changes an answer."""
    profiling = torch.autograd._profiler_enabled()
    if not _enabled:
        return _ProfilerRange(name) if profiling else NOOP_SPAN
    # repro: allow[instrument-drift] plumbing: callers pass literal span names
    sp = _tracer.span(name, parent=parent, **attrs)
    if profiling:
        sp.range = _RecordFunctionFast(name)
    return sp


def fence(*values) -> None:
    """Wait until the CUDA work that produces every tensor in `values` is
    done, so the enclosing span measures device time and not the launch.
    A tensor on the card synchronises its device's current stream on this
    thread (the stream the launchers and PyTorch enqueue on), not the whole
    device: admission flushes run on several threads at once.  CPU tensors
    and other values pass through, a tuple or list is looked into one level
    deep, and nothing happens when disabled."""
    if not _enabled:
        return
    done = set()
    for v in values:
        for t in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda" \
                    and t.device not in done:
                torch.cuda.current_stream(t.device).synchronize()
                done.add(t.device)


def export_json(path: str, *registries: MetricsRegistry,
                extra: Optional[dict] = None) -> dict:
    """Atomically write the merged snapshot of `registries` (default: the
    global one) as JSON; returns the written document.  Later registries
    win on a (name, labels) clash, which the store / global split does not
    produce (disjoint names)."""
    regs = registries or (_registry,)
    doc = {"ts": time.time(), "counters": {}, "gauges": {}, "histograms": {}}
    for reg in regs:
        snap = reg.snapshot()
        for kind in ("counters", "gauges", "histograms"):
            for name, entries in snap[kind].items():
                doc[kind].setdefault(name, []).extend(entries)
    if extra:
        doc.update(extra)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return doc
