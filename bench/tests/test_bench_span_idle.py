"""CPU tests of the idle-by-span sweep (`bench/span_idle.py`), of the trace
reduction's handling of the card's mirrors of host ranges, and of the
readers of the program's fit spans."""
from __future__ import annotations

import pytest

from bench import harness, span_idle
from bench import trace as btrace

MS = 1_000_000

# one refresh in a 100 ms window: ingest 0-20, execute 20-90, capture 90-100
HARNESS = [("bench.window", 0, 100 * MS), ("bench.ingest", 0, 20 * MS),
           ("bench.execute", 20 * MS, 90 * MS), ("bench.capture", 90 * MS, 100 * MS)]
PROGRAM = [("store.add_batch", 1 * MS, 19 * MS),
           ("engine.run_compiled", 22 * MS, 88 * MS), ("engine.plan", 22 * MS, 60 * MS),
           ("synopsis.fit", 25 * MS, 58 * MS), ("nm.eval", 30 * MS, 40 * MS),
           ("engine.kernel", 62 * MS, 80 * MS), ("qmc.plan", 62 * MS, 64 * MS)]
# the card: one kernel in ingest, one that outlives the nm.eval that launched
# it, one in the answer, one in the capture (outside the scopes)
DEVICE = [("k", 5 * MS, 10 * MS), ("gh_tiles", 35 * MS, 45 * MS),
          ("qmc_box_tiles", 70 * MS, 75 * MS), ("x", 92 * MS, 95 * MS)]


def test_sweep_puts_each_idle_nanosecond_under_the_innermost_span():
    idle = span_idle.idle_by_span(DEVICE, HARNESS + PROGRAM, 0, 100 * MS)
    want = {"store.add_batch": 13, "unattributed": 6, "engine.plan": 5,
            "synopsis.fit": 18, "nm.eval": 5, "engine.run_compiled": 10,
            "engine.kernel": 11, "qmc.plan": 2}
    assert idle == pytest.approx({k: v / 1e3 for k, v in want.items()})
    # the values add up to the idle inside bench.ingest and bench.execute:
    # 20 + 70 ms less the 5 + 10 + 5 ms of kernels there
    assert sum(idle.values()) == pytest.approx(0.070)
    layers = span_idle.by_layer(idle)
    assert layers == pytest.approx({"ingest": 0.013, "engine": 0.015, "fit": 0.018,
                                    "nm_eval": 0.005, "answer": 0.013,
                                    "unattributed": 0.006})
    assert sum(layers.values()) == pytest.approx(sum(idle.values()))


def test_sweep_nesting_ties_gaps_and_the_window():
    # a nested span that starts with its parent, and the window cut short
    notes = [("bench.execute", 0, 10 * MS), ("engine.plan", 0, 10 * MS),
             ("synopsis.fit", 0, 4 * MS), ("nm.eval", 4 * MS, 4 * MS)]
    idle = span_idle.idle_by_span([("k", 2 * MS, 3 * MS)], notes, 0, 8 * MS)
    assert idle == pytest.approx({"synopsis.fit": 0.003, "engine.plan": 0.004})
    # a span of another layer (no layer names it) keeps its own name
    assert span_idle.by_layer({"admission.flush": 1.0}) == {"admission.flush": 1.0}
    # no scope, no idle counted; no card work, all of a scope is idle
    assert span_idle.idle_by_span([], [("engine.plan", 0, MS)], 0, MS) == {}
    assert span_idle.idle_by_span([], [("bench.ingest", 0, MS)], 0, MS) == \
        pytest.approx({"unattributed": 0.001})


class _Event:
    def __init__(self, name, kind, start, end, note=False, tid=1):
        self._v = (name, kind, start, end, note, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


class _Prof:
    """What `from_profiler` reads of a stopped `torch.profiler.profile`."""

    def __init__(self, events):
        results = type("Results", (), {"events": lambda self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


def _stub():
    # the harness's ranges are user annotations; the program's are op-level
    # ranges, CPU events told from the host's operators by their names
    events = [_Event(n, "CPU", s, e, note=True) for n, s, e in HARNESS]
    events += [_Event(n, "CPU", s, e) for n, s, e in PROGRAM]
    events += [_Event(n, "CUDA", s, e) for n, s, e in DEVICE]
    # the card's mirrors of the host's ranges: no device work
    events += [_Event("engine.plan", "CUDA", 22 * MS, 60 * MS, note=True),
               _Event("bench.execute", "CUDA", 20 * MS, 90 * MS, note=True)]
    # a host operator, an annotation that is no program span, and another
    # thread's span
    events += [_Event("aten::mm", "CPU", 36 * MS, 37 * MS),
               _Event("user.note", "CPU", 41 * MS, 44 * MS, note=True),
               _Event("engine.kernel", "CPU", 0, 100 * MS, tid=2)]
    return _Prof(events)


def test_device_mirror_of_a_program_range_is_not_busy():
    win = btrace.from_profiler(_stub(), 0, 100 * MS)
    assert win.busy_s == pytest.approx(0.023)
    assert "engine.plan" not in win.family_s and "bench.execute" not in win.family_s
    assert set(win.family_launches) == {"gh_fused_sum", "qmc_box_reduce"}
    # the breakdown's idle gaps are labelled by the program's ranges
    assert "store.add_batch" in dict(win.idle_by_host)


def test_span_idle_from_profiler_reads_the_harness_thread_only():
    idle = span_idle.from_profiler(_stub(), 0, 100 * MS)
    assert idle == pytest.approx(span_idle.idle_by_span(DEVICE, HARNESS + PROGRAM,
                                                        0, 100 * MS))


def _run(spans=(), span_refreshes=0):
    cell = harness.load_cell("kde1d.lscv_h.all-cols")
    return harness.Run(cell=cell, setup_s=1.0, window_s=1.0, refreshes=[None] * 4,
                       spans=list(spans), span_refreshes=span_refreshes)


def _fit(selector, t0, t1):
    return {"name": "synopsis.fit", "t0": t0, "t1": t1,
            "attrs": {"backend": "cuda", "selector": selector, "n": "16384", "d": "3"}}


@pytest.mark.parametrize("name,selector", [("fit_ms.lscv_h", "lscv_h"),
                                           ("fit_ms.lscv_H", "lscv_H")])
def test_fit_span_readers(name, selector):
    read = harness.load_reader(name)
    # no spans part (an untraced run), or a part without the exact fits' span
    assert read(_run()) is None
    rff = {"name": "synopsis.fit", "t0": 0.0, "t1": 1.0,
           "attrs": {"backend": "rff", "n": "16384", "n_features": "2048"}}
    assert read(_run([rff, {"name": "engine.plan", "t0": 0.0, "t1": 2.0}], 2)) is None
    other = "lscv_H" if selector == "lscv_h" else "lscv_h"
    spans = [_fit(selector, 0.0, 0.030), _fit(selector, 1.0, 1.050), _fit(other, 2.0, 3.0), rff]
    assert read(_run(spans, 2)) == pytest.approx(40.0)


def test_main_refuses_a_run_it_could_not_watch(monkeypatch, tmp_path):
    """A harness that never reaches the watched profiler reduction or readers
    makes the tool fail, not print an empty split, and the harness's own
    functions are put back."""
    import sys
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, str(tmp_path))
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(harness, "load_cell", lambda name: name)
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **k: {"correct": True, "metrics": {}, "device": {}})
    before = (btrace.from_profiler, harness.Refresh, harness.load_reader)
    with pytest.raises(RuntimeError, match="never reached"):
        span_idle.main(["--workload", "joint3.lscv_H", "--seed", "2147483999",
                        "--seconds", "1"])
    assert (btrace.from_profiler, harness.Refresh, harness.load_reader) == before
