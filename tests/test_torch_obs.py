"""The port's observability (`repro_torch.obs`, `kernels/tuning.py`'s
`profiled_call`) against the JAX package's `repro.obs`, on the CPU: the same
sequence of observations gives the same snapshot and `state()` (counters,
gauges, histogram quantiles), span parents link across threads as the
reference's do, an admission flush yields the reference's span tree, the
exported JSON passes `scripts/validate_metrics.py`, the fence passes CPU
tensors through (its card case skips without a CUDA device), the kernel
wrappers take the profiled branch only with obs enabled, and the store's
and engine's instruments match the reference's names and values.
"""
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import aqp_query as jq
from repro.data import aqp_store as jstore
from repro.kernels import tuning as jtuning
from repro_torch import obs as tobs
from repro_torch.core import aqp_query as tq
from repro_torch.data import aqp_store as tstore
from repro_torch.kernels import aqp_batch as tab
from repro_torch.kernels import ops, tuning

ROOT = Path(__file__).resolve().parents[1]
OBS = {"ref": jobs, "port": tobs}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Test files run in parallel worker processes, and torch's intra-op
    threads on these small tensors would oversubscribe the cores (one test
    here went from 7 s to 9 min): each test runs on one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def enabled():
    """The port's obs on for one test with a fresh tracer; state restored."""
    prev = tobs.set_tracer(tobs.Tracer())
    was = tobs.enabled()
    tobs.enable()
    yield tobs.get_tracer()
    if not was:
        tobs.disable()
    tobs.set_tracer(prev)


def _observe(reg, rng_seed=0):
    """One sequence of observations on a registry of either package."""
    rng = np.random.default_rng(rng_seed)
    for i in range(50):
        reg.counter("aqp.admission.submitted", session="s1").inc()
        reg.counter("aqp.ingest.rows", column="a").inc(int(rng.integers(1, 100)))
        reg.gauge("aqp.admission.depth", session="s1").set(float(i % 7))
        reg.gauge("aqp.admission.max_depth", session="s1").max(float(i % 7))
        reg.histogram("aqp.query.latency_us", path="range1d", tier=None).observe(
            float(rng.lognormal(5.0, 1.5)))
        reg.histogram("aqp.admission.batch_size", buckets=(1, 2, 4, 8, 16),
                      session="s1").observe(float(rng.integers(1, 20)))
    reg.counter("aqp.cache.hits").inc(0.5)


def test_registry_snapshot_and_state_match_the_reference():
    regs = {}
    for pkg, mod in OBS.items():
        regs[pkg] = mod.MetricsRegistry()
        _observe(regs[pkg])
    assert regs["port"].snapshot() == regs["ref"].snapshot()
    assert regs["port"].state() == regs["ref"].state()
    h = regs["port"].histogram("aqp.query.latency_us", path="range1d", tier=None)
    for p in (0.1, 0.5, 0.9, 0.99):
        assert h.percentile(p) == regs["ref"].histogram(
            "aqp.query.latency_us", path="range1d", tier=None).percentile(p)
    # a state written by either package loads into the other
    for src, dst in (("ref", "port"), ("port", "ref")):
        fresh = OBS[dst].MetricsRegistry()
        fresh.load_state(regs[src].state())
        assert fresh.snapshot() == regs[src].snapshot()
    assert tobs.LATENCY_BUCKETS_US == jobs.LATENCY_BUCKETS_US


def test_collect_and_sum_views_match_the_reference():
    regs = {pkg: mod.MetricsRegistry() for pkg, mod in OBS.items()}
    for reg in regs.values():
        for sid in ("s1", "s2"):
            reg.counter("aqp.admission.flush_reason", session=sid, reason="manual").inc(2)
            reg.gauge("aqp.admission.depth", session=sid).set(3)
            reg.histogram("aqp.admission.flush_us", session=sid).observe(10.0)
    for name in ("collect_counters", "collect_gauges"):
        got = getattr(regs["port"], name)("aqp.admission.flush_reason" if "counter" in name
                                          else "aqp.admission.depth", session="s1")
        want = getattr(regs["ref"], name)("aqp.admission.flush_reason" if "counter" in name
                                          else "aqp.admission.depth", session="s1")
        assert got == want
    assert regs["port"].sum_counter("aqp.admission.flush_reason") == 4
    assert regs["port"].sum_gauge("aqp.admission.depth") == 6
    assert regs["port"].sum_histogram("aqp.admission.flush_us") == \
        regs["ref"].sum_histogram("aqp.admission.flush_us") == (20.0, 2)


def test_counters_concurrent_increments_no_loss():
    reg = tobs.MetricsRegistry()
    n_threads, per = 8, 5000
    barrier = threading.Barrier(n_threads)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def work():
        barrier.wait(timeout=30)
        for i in range(per):
            reg.counter("t.hits", thread="shared").inc()
            reg.histogram("t.lat", thread="shared").observe(float(i % 100))
            reg.gauge("t.peak", thread="shared").max(float(i))

    threads = [threading.Thread(target=work, daemon=True) for _ in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert reg.counter("t.hits", thread="shared").value == n_threads * per
    assert reg.histogram("t.lat", thread="shared").count == n_threads * per
    assert reg.gauge("t.peak", thread="shared").value == per - 1


def _trace(mod):
    """Nested spans on a fake clock and one parented from another thread."""
    clock = [0.0]
    tr = mod.Tracer(clock=lambda: clock[0])
    with tr.span("root", job="q1") as root:
        clock[0] = 1.0
        with tr.span("child_a"):
            clock[0] = 2.0
        with tr.span("child_b"):
            clock[0] = 5.0
        ctx = root.ctx
    out = {}

    def other_thread():
        with tr.span("flush", parent=ctx) as f:
            out["trace"], out["parent"] = f.trace_id, f.parent_id
            clock[0] = 6.0

    t = threading.Thread(target=other_thread, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert (out["trace"], out["parent"]) == (root.trace_id, root.span_id)

    def strip(nodes):
        return [{"name": n["name"], "duration_us": n["duration_us"], "attrs": n["attrs"],
                 "children": strip(n["children"])} for n in nodes]
    return strip(tr.tree(root.trace_id))


def test_span_tree_and_thread_parents_match_the_reference():
    got = _trace(tobs.trace)
    assert got == _trace(jobs.trace)
    assert [k["name"] for k in got[0]["children"]] == ["child_a", "child_b", "flush"]
    assert got[0]["duration_us"] == pytest.approx(5e6)


def test_disabled_span_and_fence_are_noops():
    assert not tobs.enabled()
    s = tobs.span("anything", attr=1)
    assert s is tobs.NOOP_SPAN and s.ctx is None
    with s as inner:
        assert inner is s
    tobs.fence(torch.zeros(3), None, (torch.ones(2),))


def test_fence_passes_cpu_tensors_through(enabled, monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("a CPU tensor must not synchronise a CUDA stream")
    monkeypatch.setattr(torch.cuda, "current_stream", no_sync)
    tobs.fence(torch.zeros(3), np.zeros(2), (torch.ones(2), 1.0), [torch.ones(1)], None)


def test_fence_waits_for_the_cuda_stream(enabled):
    """On the card: the fence returns only when the work behind the tensor
    is done (an event recorded after it has completed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fence waits on a CUDA stream)")
    x = torch.randn(4096, 4096, device="cuda")
    y = x @ x
    done = torch.cuda.Event()
    done.record()
    tobs.fence(y)
    assert done.query()


def _span_tree(pkg, q, smod, tracer, rng):
    kw = {"device": "cpu"} if pkg == "port" else {}
    store = smod.TelemetryStore(capacity=512, seed=0, **kw)
    store.add_batch({"a": rng.normal(0, 1, 20_000).astype(np.float32)})
    engine = store.engine()
    engine.execute([q.AqpQuery("count", (q.Range("a", -1.0, 1.0),))])
    tracer.clear()
    with store.session(watermark=None, max_delay=None, auto_flush=False) as sess:
        fut = sess.submit(q.AqpQuery("count", (q.Range("a", -0.5, 0.5),)))
        sess.flush()
        fut.result(timeout=30)
    submit = [s for s in tracer.spans() if s.name == "admission.submit"]
    assert len(submit) == 1

    def names(nodes):
        return [(n["name"], n["attrs"].get("path", n["attrs"].get("reason")),
                 names(n["children"])) for n in nodes]
    return names(tracer.tree(submit[0].trace_id))


def test_admission_span_tree_matches_the_reference(enabled):
    """admission.submit -> admission.flush (reason) -> engine.run_compiled ->
    engine.plan, engine.kernel (path), engine.ci, in both packages."""
    got = _span_tree("port", tq, tstore, enabled, np.random.default_rng(0))
    prev = jobs.set_tracer(jobs.Tracer())
    was = jobs.enabled()
    jobs.enable()
    try:
        want = _span_tree("ref", jq, jstore, jobs.get_tracer(), np.random.default_rng(0))
    finally:
        if not was:
            jobs.disable()
        jobs.set_tracer(prev)
    assert got == want
    assert got == [("admission.submit", None, [("admission.flush", "manual", [
        ("engine.run_compiled", None, [("engine.plan", None, []),
                                       ("engine.kernel", "range1d", []),
                                       ("engine.ci", "range1d", [])])])])]


def test_profiled_call_labels_match_the_reference():
    """The same call through either package's profiled_call records
    kernel.calls / dispatch_us / wall_us under the same labels."""
    snaps = {}
    for pkg, (mod, tun) in {"ref": (jobs, jtuning), "port": (tobs, tuning)}.items():
        reg = mod.get_registry()
        before = reg.state()
        out = tun.profiled_call("aqp_batch_sums", lambda a: (a + 1, a), 1, n=32_768, G=8,
                                tile=4096, q_tile=32)
        assert out == (2, 1)
        after = [(e["name"], e["labels"], e["count"] if "count" in e else e["value"])
                 for kind in ("counters", "histograms") for e in reg.state()[kind]
                 if e["labels"].get("kernel") == "aqp_batch_sums" and e["labels"].get("n")
                 == "32768"]
        snaps[pkg] = sorted(map(repr, after))
        reg.load_state(before)
    assert snaps["port"] == snaps["ref"]
    assert len(snaps["port"]) == 3


def test_wrappers_profile_only_with_obs_enabled(monkeypatch):
    """A wrapper's launch branch calls the launcher directly with obs off and
    through profiled_call with obs on (a meta tensor stands in for the card:
    the launcher is faked); the CPU plain versions are never profiled."""
    calls = []

    def fake_launch(x, h, a, b, tile):
        calls.append(tile)
        return torch.zeros(5, a.shape[0])

    monkeypatch.setattr(tab, "aqp_batch_moments", fake_launch)
    x = torch.zeros(64, device="meta")
    a = torch.zeros(8, device="meta")
    reg = tobs.get_registry()

    def recorded():
        return reg.sum_counter("kernel.calls", kernel="aqp_batch_sums", n=64, G=8)

    before = recorded()
    assert not tobs.enabled()
    ops.aqp_batch_moments(x, torch.zeros(1), a, a)
    assert calls == [tab.TILE] and recorded() == before
    prev = tobs.set_tracer(tobs.Tracer())
    tobs.enable()
    try:
        ops.aqp_batch_moments(x, torch.zeros(1), a, a)
        assert calls == [tab.TILE] * 2 and recorded() == before + 1
        hist = reg.collect_histograms("kernel.wall_us", kernel="aqp_batch_sums", n=64)
        assert hist and hist[0][1].count >= 1
        cpu_before = reg.sum_counter("kernel.calls", kernel="aqp_batch_sums")
        ops.aqp_batch_moments(torch.zeros(64), torch.tensor(0.5), torch.zeros(8),
                              torch.ones(8))
        assert reg.sum_counter("kernel.calls", kernel="aqp_batch_sums") == cpu_before
    finally:
        tobs.disable()
        tobs.set_tracer(prev)


def _store_metrics(pkg, q, smod, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    kw = {"device": "cpu"} if pkg == "port" else {}
    store = smod.TelemetryStore(capacity=256, seed=0, cache_entries=2, **kw)
    store.track_categorical("code", kind="cm")
    for _ in range(3):
        store.add_batch({"a": rng.normal(0, 1, 1000).astype(np.float32),
                         "b": rng.normal(0, 1, 1000).astype(np.float32),
                         "code": rng.integers(0, 4, 1000).astype(np.float32)})
    engine = store.engine()
    specs = [q.AqpQuery("count", (q.Range(c, -1.0, 1.0),)) for c in ("a", "b", "code")]
    engine.execute(specs)
    engine.execute(specs)
    snap = store.metrics.snapshot()
    snap["gauges"].pop("aqp.cache.bytes")      # synopsis bytes: device tensors differ
    return snap


def test_store_and_engine_instruments_match_the_reference():
    """Ingest counters, gauges (fill, count-min err_bound), the cache's and
    the plan cache's mirrors hold the reference's names, labels and values."""
    got = _store_metrics("port", tq, tstore)
    want = _store_metrics("ref", jq, jstore)
    assert got == want
    assert got["counters"]["aqp.ingest.batches"] == [{"labels": {}, "value": 3}]
    assert {e["labels"]["column"] for e in got["counters"]["aqp.ingest.rows"]} == \
        {"a", "b", "code"}
    assert got["counters"]["aqp.cache.evictions"][0]["value"] >= 1


def test_gated_histograms_stay_empty_when_disabled():
    assert not tobs.enabled()
    store = tstore.TelemetryStore(capacity=256, seed=0, device="cpu")
    store.add_batch({"a": np.random.default_rng(0).normal(0, 1, 2000).astype(np.float32)})
    with store.session(watermark=None, max_delay=None, auto_flush=False) as sess:
        sess.submit(tq.AqpQuery("count", (tq.Range("a", -1.0, 1.0),)))
        sess.flush()
        st = sess.stats()
    assert st["submitted"] == 1 and st["flushes"] == 1
    for name in ("aqp.query.latency_us", "aqp.admission.flush_us", "aqp.ingest.us"):
        assert store.metrics.sum_histogram(name)[1] == 0


def test_export_json_passes_validate_metrics(enabled, tmp_path):
    """A session's store registry and the kernel registry, exported, pass the
    repository's validator unmodified (run as a subprocess)."""
    rng = np.random.default_rng(0)
    store = tstore.TelemetryStore(capacity=256, seed=0, device="cpu")
    store.track_joint(("a", "b"))
    store.add_batch({"a": rng.normal(0, 1, 2000).astype(np.float32),
                     "b": rng.normal(0, 1, 2000).astype(np.float32)})
    with store.session(watermark=2, max_delay=None, auto_flush=False) as sess:
        futs = [sess.submit(tq.AqpQuery("count", (tq.Range("a", -1.0, i / 4),)))
                for i in range(4)]
        futs.append(sess.submit(tq.AqpQuery(
            "sum", (tq.Box(("a", "b"), (-1.0, -1.0), (1.0, 1.0)),), target="b")))
        sess.flush()
        [f.result(timeout=30) for f in futs]
    path = tmp_path / "m.json"
    doc = tobs.export_json(str(path), store.metrics, tobs.get_registry(),
                           extra={"mode": "aqp"})
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
    assert {e["labels"]["path"] for e in doc["histograms"]["aqp.query.latency_us"]} == \
        {"range1d", "box"}
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "validate_metrics.py"),
                          str(path)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_export_json_merges_registries_as_the_reference(tmp_path):
    docs = {}
    for pkg, mod in OBS.items():
        r1, r2 = mod.MetricsRegistry(), mod.MetricsRegistry()
        r1.counter("aqp.cache.hits").inc(3)
        r2.histogram("kernel.wall_us", kernel="kde_eval").observe(12.0)
        doc = mod.export_json(str(tmp_path / f"{pkg}.json"), r1, r2, extra={"mode": "t"})
        doc.pop("ts")
        docs[pkg] = doc
    assert docs["port"] == docs["ref"]
