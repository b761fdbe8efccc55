"""Admission sessions of the port (`repro_torch.core.aqp_admission`) against
the JAX package's, on the CPU: every behaviour of `tests/test_aqp_admission.py`
run on the same numpy data and the same specs in both packages, the
reference on its "jnp" path and the port on "torch".

Held: the port's session answers bit-identical to the port's own
`QueryEngine.execute` of the same specs (estimate, CI bounds, path,
synopsis version, rel_width, group), including the 8-thread closed-loop
case and the GROUP BY, Eq and lscv_H overrides; the port's answers against
the reference session's at `tests/test_torch_store.py`'s tolerances (rtol
1e-4 plus atol 1e-4 x scale, scale = n_source / sample size; exact answers
bit-equal); and the bookkeeping (flush reasons, priority tiers, version
re-keying, max_pending block and shed, fit offload, `store.stats()
["admission"]`) equal to the reference's values.  LSCV_H fits differ
between the packages within their optimiser's tolerance (the ground rules
of ROADMAP.md), so an lscv_H answer of the port is held to its own
`execute` bit for bit and to the reference's answer within the reference's
CI.

Every `result()`, `join()` and wait carries a timeout, so a hang fails
instead of running out the suite's clock; every thread is a daemon.
"""
import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from repro.core import AdmissionFull as JAdmissionFull
from repro.core import aqp_admission as jadm
from repro.core import aqp_query as jq
from repro.data import aqp_store as jstore
from repro_torch.core import AdmissionFull as TAdmissionFull
from repro_torch.core import aqp_admission as tadm
from repro_torch.core import aqp_query as tq
from repro_torch.data import aqp_store as tstore

PKGS = {"ref": (jq, jstore, jadm, JAdmissionFull), "port": (tq, tstore, tadm, TAdmissionFull)}
WAIT = 30.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Test files run in parallel worker processes, and torch's intra-op
    threads on these small tensors would oversubscribe the cores (one test
    here went from 7 s to 9 min): each test runs on one thread."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _data(rng, n=20_000):
    a = rng.normal(0, 1, n).astype(np.float32)
    b = (0.8 * a + 0.6 * rng.normal(0, 1, n)).astype(np.float32)
    code = rng.integers(0, 4, n).astype(np.float32)
    return {"a": a, "b": b, "code": code}


def _store(pkg, data, capacity=512, categorical=False):
    _, smod, _, _ = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    store = smod.TelemetryStore(capacity=capacity, seed=0, **kw)
    store.track_joint(("a", "b"))
    store.track_joint(("code", "b"))
    if categorical:
        store.track_categorical("code")
    store.add_batch(data)
    return store


def _tiered_store(pkg, data, capacity=512, n_tiers=4):
    _, smod, _, _ = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    store = smod.TelemetryStore(capacity=capacity, seed=0, **kw)
    store.track_tiered("a", n_tiers=n_tiers)
    store.add_batch({"a": data["a"]})
    return store


def _manual_session(engine, **kw):
    """A session with no automatic flushing: explicit flush()/poll() only."""
    kw.setdefault("watermark", None)
    kw.setdefault("max_delay", None)
    return engine.session(auto_flush=False, **kw)


def _key(r):
    return (r.estimate, r.ci_lo, r.ci_hi, r.path, r.synopsis_version, r.rel_width,
            r.group, r.n_effective)


def _flat(results):
    out = []
    for r in results:
        out.extend(r if isinstance(r, list) else [r])
    return out


def _assert_close(got, want, scale):
    """The port's results against the reference's: paths, versions and
    n_effective equal, exact answers bit-equal, KDE answers and CI bounds
    within rtol 1e-4 + atol 1e-4 x scale."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.path, g.synopsis_version, g.n_effective, g.group) == \
            (w.path, w.synopsis_version, w.n_effective, w.group)
        if w.path == "exact":
            assert (g.estimate, g.ci_lo, g.ci_hi) == (w.estimate, w.ci_lo, w.ci_hi)
            continue
        for field in ("estimate", "ci_lo", "ci_hi"):
            np.testing.assert_allclose(getattr(g, field), getattr(w, field),
                                       rtol=1e-4, atol=1e-4 * scale, err_msg=field)


def _join(threads):
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)


def _counters(stats):
    """The session counters both packages keep, without the plan cache."""
    return {k: v for k, v in stats.items() if k != "plan_cache"}


# --- acceptance: bit-identical to the synchronous path -----------------------

def _mixed_specs(q):
    return [
        q.AqpQuery("count", (q.Range("a", -1.0, 1.0),)),
        q.AqpQuery("sum", (q.Range("b", -0.5, 2.0),), target="b"),
        q.AqpQuery("avg", (q.Box(("a", "b"), (-1.0, -1.0), (1.0, 1.0)),), target="b"),
        q.AqpQuery("count", (q.Eq("code", 2.0),)),
        q.AqpQuery("count", (q.Range("a", -1.0, 1.0),), selector="lscv_H"),
        q.AqpQuery("count", (q.Range("b", -1.0, 1.0),),
                   group_by=q.GroupBy("code", values=(0.0, 1.0, 2.0, 3.0))),
    ]


def _session_answers(pkg, data, specs_fn):
    q = PKGS[pkg][0]
    store = _store(pkg, data, categorical=True)
    engine = store.engine()
    want = engine.execute(specs_fn(q))
    with _manual_session(engine) as sess:
        futs = [sess.submit(s) for s in specs_fn(q)]
        assert sess.pending > 0 and not futs[0].done()
        sess.flush()
        got = _flat(f.result(timeout=WAIT) for f in futs)
    return got, want


def test_admission_bit_identical_to_execute(rng):
    """Every path (range1d, box, exact Eq, GROUP BY expansion, the lscv_H
    override on qmc) answers bit-identically to the port's own execute, and
    within the parity tolerance of the reference's session."""
    data = _data(rng)
    got, want = _session_answers("port", data, _mixed_specs)
    assert [_key(r) for r in got] == [_key(r) for r in want]
    ref_got, _ = _session_answers("ref", data, _mixed_specs)
    assert [r.path for r in got] == [r.path for r in ref_got] == \
        ["range1d", "range1d", "box", "exact", "qmc"] + ["box:grouped"] * 4
    fullh = 4
    keep = [i for i in range(len(got)) if i != fullh]
    _assert_close([got[i] for i in keep], [ref_got[i] for i in keep], 20_000 / 512)
    g, w = got[fullh], ref_got[fullh]
    assert w.ci_lo <= g.estimate <= w.ci_hi
    assert g.synopsis_version == w.synopsis_version


def test_session_execute_convenience_matches_engine(rng):
    data = _data(rng)
    out = {}
    for pkg in PKGS:
        q = PKGS[pkg][0]
        store = _store(pkg, data)
        engine = store.engine()
        specs = [q.AqpQuery("count", (q.Range("a", -1, 1),)),
                 q.AqpQuery("avg", (q.Range("b", -1, 1),), target="b")]
        want = engine.execute(specs)
        with _manual_session(engine) as sess:
            got = sess.execute(specs)
        out[pkg] = got
        if pkg == "port":
            assert [_key(r) for r in got] == [_key(r) for r in want]
    _assert_close(out["port"], out["ref"], 20_000 / 512)


# --- flush triggers ----------------------------------------------------------

def _watermark(pkg, data):
    q, _, adm, _ = PKGS[pkg]
    store = _store(pkg, data)
    sess = store.session(watermark=3, max_delay=None, auto_flush=False)
    futs = [sess.submit(q.AqpQuery("count", (q.Range("a", -1, i),))) for i in range(2)]
    before = [f.done() for f in futs]
    f3 = sess.submit(q.AqpQuery("count", (q.Range("a", -1, 2),)))
    after = [f.done() for f in futs + [f3]]
    st = sess.stats()
    sess.close()
    assert st["flush_reasons"] == {adm.FLUSH_WATERMARK: 1}
    return before, after, _counters(st), [f.result(timeout=WAIT) for f in futs + [f3]]


def test_watermark_flush_is_inline_and_scoped_to_bucket(rng):
    data = _data(rng)
    ref, port = _watermark("ref", data), _watermark("port", data)
    assert port[:3] == ref[:3]
    assert port[0] == [False, False] and port[1] == [True] * 3
    assert port[2]["mean_batch"] == 3.0 and port[2]["coalesced"] == 3
    _assert_close(port[3], ref[3], 20_000 / 512)


def _deadline_poll(pkg, data):
    q = PKGS[pkg][0]
    store = _store(pkg, data)
    clock = FakeClock()
    sess = store.session(watermark=None, max_delay=1.0, auto_flush=False, time_fn=clock)
    fut = sess.submit(q.AqpQuery("count", (q.Range("a", -1, 1),)))
    seen = [(sess.poll(), fut.done())]
    clock.now = 0.5
    seen.append((sess.poll(), fut.done()))
    clock.now = 1.0
    seen.append((sess.poll(), fut.done()))
    st = sess.stats()
    sess.close()
    return seen, _counters(st)


def test_deadline_flush_via_poll_with_fake_clock(rng):
    data = _data(rng)
    ref, port = _deadline_poll("ref", data), _deadline_poll("port", data)
    assert port == ref
    assert port[0] == [(0, False), (0, False), (1, True)]
    assert port[1]["flush_reasons"] == {tadm.FLUSH_DEADLINE: 1}


def _deadline_unrelated(pkg, data):
    q = PKGS[pkg][0]
    store = _store(pkg, data)
    clock = FakeClock()
    sess = store.session(watermark=None, max_delay=1.0, auto_flush=False, time_fn=clock)
    stale = sess.submit(q.AqpQuery("count", (q.Range("a", -1, 1),)))
    clock.now = 0.5
    sess.submit(q.AqpQuery("count", (q.Range("b", -1, 1),)))
    seen = [stale.done()]
    clock.now = 1.2                              # "a" bucket now past its deadline
    fresh = sess.submit(q.AqpQuery("count", (q.Range("b", -2, 2),)))
    seen += [stale.done(), fresh.done()]
    st = sess.stats()
    sess.close()
    return seen, _counters(st)


def test_deadline_flush_runs_on_next_unrelated_submit(rng):
    data = _data(rng)
    ref, port = _deadline_unrelated("ref", data), _deadline_unrelated("port", data)
    assert port == ref
    assert port[0] == [False, True, False]
    assert port[1]["flush_reasons"] == {tadm.FLUSH_DEADLINE: 1}


def _close_flush(pkg, data):
    q = PKGS[pkg][0]
    store = _store(pkg, data)
    sess = store.session(watermark=None, max_delay=None, auto_flush=False)
    futs = [sess.submit(q.AqpQuery("count", (q.Range(c, -1, 1),))) for c in ("a", "b", "a")]
    before = [f.done() for f in futs]
    sess.close()
    after = [f.done() for f in futs]
    with pytest.raises(RuntimeError, match="closed"):
        sess.submit(q.AqpQuery("count", (q.Range("a", -1, 1),)))
    sess.close()                                  # idempotent
    return before, after, _counters(sess.stats()), [f.result(timeout=WAIT) for f in futs]


def test_flush_on_close_resolves_everything(rng):
    data = _data(rng)
    ref, port = _close_flush("ref", data), _close_flush("port", data)
    assert port[:3] == ref[:3]
    assert port[1] == [True] * 3 and port[2]["pending"] == 0
    assert port[2]["flush_reasons"] == {tadm.FLUSH_CLOSE: 2}   # one per bucket
    _assert_close(port[3], ref[3], 20_000 / 512)


def _out_of_order(pkg, data):
    q = PKGS[pkg][0]
    store = _store(pkg, data)
    sess = store.session(watermark=2, max_delay=None, auto_flush=False)
    first = sess.submit(q.AqpQuery("count", (q.Range("a", -1, 1),)))
    b1 = sess.submit(q.AqpQuery("count", (q.Range("b", -1, 1),)))
    b2 = sess.submit(q.AqpQuery("count", (q.Range("b", -2, 2),)))
    seen = [b1.done(), b2.done(), first.done()]
    sess.flush()
    seen.append(first.done())
    st = sess.stats()
    sess.close()
    return seen, _counters(st)


def test_out_of_order_future_resolution(rng):
    data = _data(rng)
    ref, port = _out_of_order("ref", data), _out_of_order("port", data)
    assert port == ref
    assert port[0] == [True, True, False, True]
    assert port[1]["flush_reasons"] == {tadm.FLUSH_WATERMARK: 1, tadm.FLUSH_MANUAL: 1}


# --- priority classes --------------------------------------------------------

def _priorities(pkg, data):
    q = PKGS[pkg][0]
    store = _tiered_store(pkg, data)
    engine = store.engine()
    spec = q.AqpQuery("count", (q.Range("a", -1.0, 1.0),))
    want = engine.execute(spec)[0]
    with _manual_session(engine) as sess:
        f_coarse = sess.submit(spec, priority="coarse")
        f_full = sess.submit(spec)               # default_priority == "full"
        pending = sess.pending
        sess.flush()
        coarse, full = f_coarse.result(timeout=WAIT), f_full.result(timeout=WAIT)
        st = sess.stats()
    return pending, coarse, full, want, _counters(st)


def test_priority_classes_map_to_tier_budgets(rng):
    """"coarse" answers from the smallest tier, "full" from the whole
    reservoir, bit-identical to the port's execute; the two never share a
    micro-batch."""
    data = _data(rng)
    ref, port = _priorities("ref", data), _priorities("port", data)
    pending, coarse, full, want, st = port
    assert pending == ref[0] == 2
    assert _key(full) == _key(want)
    assert coarse.n_effective == 512 >> 3 and full.n_effective == 512
    assert coarse.ci_width > full.ci_width
    assert st == ref[4]
    assert st["flush_reasons"] == {tadm.FLUSH_MANUAL: 2}
    assert st["priorities"] == {"coarse": 1, "full": 1}
    scale = 20_000 / 512
    _assert_close([full], [ref[2]], scale)
    _assert_close([coarse], [ref[1]], 20_000 / (512 >> 3))


def _custom_classes(pkg, data):
    q = PKGS[pkg][0]
    store = _tiered_store(pkg, {"a": data["a"][:2000]}, capacity=256)
    engine = store.engine()
    with _manual_session(engine) as sess:
        with pytest.raises(ValueError, match="unknown priority"):
            sess.submit(q.AqpQuery("count", (q.Range("a", -1, 1),)), priority="turbo")
        assert sess.pending == 0
    with pytest.raises(ValueError, match="default_priority"):
        engine.session(priority_tiers={"full": None}, default_priority="fast",
                       auto_flush=False)
    with _manual_session(engine, priority_tiers={"fast": 1, "exactish": None},
                         default_priority="fast") as sess:
        fut = sess.submit(q.AqpQuery("count", (q.Range("a", -1, 1),)))
        sess.flush()
        return fut.result(timeout=WAIT), sess.stats()["priorities"]


def test_priority_validation_and_custom_classes(rng):
    data = _data(rng)
    ref, port = _custom_classes("ref", data), _custom_classes("port", data)
    assert port[0].n_effective == ref[0].n_effective == 256 >> 2   # tier 1 of 4
    assert port[1] == ref[1] == {"fast": 1}
    _assert_close([port[0]], [ref[0]], 2000 / (256 >> 2))


# --- version invalidation ----------------------------------------------------

def _rekey(pkg, data, extra):
    q = PKGS[pkg][0]
    store = _store(pkg, data)
    engine = store.engine()
    spec = q.AqpQuery("count", (q.Range("a", -1.0, 1.0),))
    v0 = store.columns["a"].version
    with _manual_session(engine) as sess:
        fut = sess.submit(spec)
        store.add_batch({"a": extra})
        assert store.columns["a"].version > v0
        sess.flush()
        got = fut.result(timeout=WAIT)
    want = engine.execute(spec)[0]
    return got, want, store.columns["a"].version, sess.stats()["invalidations"]


def test_version_bump_rekeys_in_flight_batch(rng):
    """add_batch between submit and flush: the pending micro-batch is
    re-keyed to the new version and answers as a fresh execute does."""
    data = _data(rng)
    extra = rng.normal(3, 1, 4000).astype(np.float32)
    ref, port = _rekey("ref", data, extra), _rekey("port", data, extra)
    got, want, version, invalidations = port
    assert got.synopsis_version == version == ref[2]
    assert _key(got) == _key(want)
    assert invalidations == ref[3] == 1
    _assert_close([got], [ref[0]], 24_000 / 512)


def test_abandoned_session_is_collectable(rng):
    """A session dropped without close() is pinned neither by the store's
    listener list (a weakref subscription) nor by its own flusher thread."""
    q = tq
    store = _store("port", _data(rng, n=2000), capacity=256)
    sess = store.session(watermark=None, max_delay=0.01)   # starts no thread
    fut = sess.submit(q.AqpQuery("count", (q.Range("a", -1, 1),)))  # starts it
    fut.result(timeout=WAIT)
    ref = weakref.ref(sess)
    del sess, fut
    gc.collect()
    deadline = time.monotonic() + 10.0
    while ref() is not None and time.monotonic() < deadline:
        time.sleep(0.1)                    # the flusher's tick drops its ref
        gc.collect()
    assert ref() is None
    # the dead session's listener removes itself on the next notification
    store.add_batch({"a": np.zeros(4, np.float32)})
    assert store._listeners == []
    assert store.stats()["admission"]["pending"] == 0


def test_unsubscribed_after_close(rng):
    store = _store("port", _data(rng, n=2000), capacity=256)
    sess = store.session(watermark=None, max_delay=None, auto_flush=False)
    assert len(store._listeners) == 1
    sess.close()
    assert store._listeners == []


def test_subscribe_reports_bumped_versions_like_the_reference(rng):
    data = _data(rng, n=2000)
    seen = {}
    for pkg in PKGS:
        store = _store(pkg, data, capacity=256)
        got = []
        unsubscribe = store.subscribe(got.append)
        store.add_batch({"a": data["a"][:100], "b": data["b"][:100]})
        unsubscribe()
        unsubscribe()                      # idempotent
        store.add_batch({"a": data["a"][:10]})
        seen[pkg] = got
    assert seen["port"] == seen["ref"]
    assert len(seen["port"]) == 1 and set(seen["port"][0]) == {"a", "b", ("a", "b")}


# --- concurrency -------------------------------------------------------------

def test_concurrent_clients_all_resolve_and_match_sync(rng):
    """8 closed-loop client threads against one auto-flushing session: every
    future resolves, every answer is bit-identical to the port's execute of
    all the specs at once, and within tolerance of the reference's."""
    import sys
    data = _data(rng)
    store = _store("port", data, categorical=True)
    engine = store.engine()
    n_clients, per_client = 8, 6
    q = tq

    def spec(ci, i):
        kind = (ci + i) % 4
        if kind == 0:
            return q.AqpQuery("count", (q.Range("a", -2.0 + 0.1 * i, 0.5 * ci),))
        if kind == 1:
            return q.AqpQuery("avg", (q.Range("b", -1.5, 0.2 * i),), target="b")
        if kind == 2:
            return q.AqpQuery("sum", (q.Box(("a", "b"), (-1.0, -1.0), (0.1 * i, 0.1 * ci)),),
                              target="a")
        return q.AqpQuery("count", (q.Eq("code", float(i % 4)),))

    specs = {ci: [spec(ci, i) for i in range(per_client)] for ci in range(n_clients)}
    flat = [s for ci in range(n_clients) for s in specs[ci]]
    want = engine.execute(flat)
    got, errs = {}, []
    lock = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with engine.session(watermark=4, max_delay=0.002) as sess:
            def client(ci):
                try:
                    mine = [sess.submit(s).result(timeout=WAIT) for s in specs[ci]]
                    with lock:
                        got[ci] = mine
                except Exception as exc:       # surfaced after the join
                    errs.append(exc)
            threads = [threading.Thread(target=client, args=(ci,), daemon=True)
                       for ci in range(n_clients)]
            for t in threads:
                t.start()
            _join(threads)
            st = sess.stats()
    finally:
        sys.setswitchinterval(old)
    assert not errs
    flat_got = [r for ci in range(n_clients) for r in got[ci]]
    assert [_key(r) for r in flat_got] == [_key(r) for r in want]
    assert st["executed"] == n_clients * per_client and st["flushes"] >= 1
    ref = _store("ref", data, categorical=True)
    jflat = [jq.AqpQuery(s.aggregate, tuple(
        jq.Range(t.column, t.a, t.b) if isinstance(t, tq.Range)
        else jq.Box(t.columns, t.lo, t.hi) if isinstance(t, tq.Box)
        else jq.Eq(t.column, t.value) for t in s.predicates), target=s.target)
        for s in flat]
    _assert_close(flat_got, ref.engine().execute(jflat), 20_000 / 512)


# --- validation and bookkeeping ----------------------------------------------

def test_submit_raises_synchronously_on_bad_specs(rng):
    for pkg in PKGS:
        q = PKGS[pkg][0]
        store = _store(pkg, _data(rng, n=2000), capacity=256)
        with _manual_session(store.engine()) as sess:
            with pytest.raises(KeyError, match="unknown column"):
                sess.submit(q.AqpQuery("count", (q.Range("missing", 0, 1),)))
            with pytest.raises(KeyError, match="track_joint"):
                sess.submit(q.AqpQuery("count", (q.Range("a", 0, 1), q.Range("code", 0, 1))))
            assert sess.pending == 0


@pytest.mark.parametrize("kw,match", [({"watermark": 0}, "watermark"),
                                      ({"max_delay": -1.0}, "max_delay"),
                                      ({"max_pending": 0}, "max_pending"),
                                      ({"overflow": "drop"}, "overflow")])
def test_session_param_validation(rng, kw, match):
    for pkg in PKGS:
        store = _store(pkg, _data(rng, n=2000), capacity=256)
        with pytest.raises(ValueError, match=match):
            store.session(**kw)


def _aggregate(pkg, data):
    q = PKGS[pkg][0]
    store = _store(pkg, data)
    s1 = store.session(watermark=None, max_delay=None, auto_flush=False)
    s2 = store.session(watermark=None, max_delay=None, auto_flush=False)
    s1.submit(q.AqpQuery("count", (q.Range("a", -1, 1),)))
    s1.flush()
    s2.submit(q.AqpQuery("count", (q.Range("b", -1, 1),)))
    agg = store.stats()["admission"]
    s1.close()
    s2.close()
    return agg, store.stats()["admission"]


def test_store_stats_aggregate_admission_counters(rng):
    data = _data(rng)
    ref, port = _aggregate("ref", data), _aggregate("port", data)
    assert port == ref
    agg = port[0]
    assert agg["sessions"] == 2 and agg["submitted"] == 2 and agg["executed"] == 1
    assert agg["pending"] == 1 and agg["flush_reasons"] == {tadm.FLUSH_MANUAL: 1}
    assert port[1]["pending"] == 0


def test_store_stats_aggregate_two_sessions_flushing_concurrently(rng):
    """Two sessions flushing from their own threads aggregate without losing
    counts, and the totals survive close and garbage collection (the
    counters live in the store's registry)."""
    q = tq
    store = _store("port", _data(rng))
    store.engine().execute([q.AqpQuery("count", (q.Range("a", -1, 1),)),
                            q.AqpQuery("count", (q.Range("b", -1, 1),))])
    sessions = [store.session(watermark=None, max_delay=None, auto_flush=False)
                for _ in range(2)]
    n_each = 6
    errs = []

    def work(si):
        col = "ab"[si]
        try:
            for i in range(n_each):
                fut = sessions[si].submit(q.AqpQuery("count", (q.Range(col, -1.0, 0.1 * i),)))
                sessions[si].flush()
                fut.result(timeout=WAIT)
        except Exception as e:              # surfaced after the join
            errs.append(e)

    threads = [threading.Thread(target=work, args=(si,), daemon=True) for si in range(2)]
    for t in threads:
        t.start()
    _join(threads)
    assert not errs
    agg = store.stats()["admission"]
    assert agg["sessions"] == 2
    assert agg["submitted"] == agg["executed"] == 2 * n_each
    assert agg["flush_reasons"] == {tadm.FLUSH_MANUAL: 2 * n_each}
    while sessions:
        sessions.pop().close()
    gc.collect()
    agg = store.stats()["admission"]
    assert agg["sessions"] == 0
    assert agg["submitted"] == agg["executed"] == 2 * n_each
    assert agg["flush_reasons"] == {tadm.FLUSH_MANUAL: 2 * n_each}
    assert agg["pending"] == 0 and agg["mean_batch"] == 1.0


# --- backpressure: the max_pending bound -------------------------------------

def _shed(pkg, data):
    q, _, _, full = PKGS[pkg]
    store = _store(pkg, data, capacity=256)
    with _manual_session(store.engine(), max_pending=2, overflow="shed") as sess:
        futs = [sess.submit(q.AqpQuery("count", (q.Range("a", 0.0, float(i)),)))
                for i in range(2)]
        with pytest.raises(full, match="max_pending=2"):
            sess.submit(q.AqpQuery("count", (q.Range("a", 0.0, 9.0),)))
        st = _counters(sess.stats())
        sess.flush()
        res = [f.result(timeout=WAIT) for f in futs]
        sess.submit(q.AqpQuery("count", (q.Range("a", 0.0, 9.0),)))   # room again
        return st, sess.stats()["shed"], res, store.stats()["admission"]


def test_max_pending_shed_raises_and_counts(rng):
    data = _data(rng, n=2000)
    ref, port = _shed("ref", data), _shed("port", data)
    assert port[0] == ref[0] and port[1] == ref[1] == 1
    assert port[0]["shed"] == 1 and port[0]["max_pending"] == 2
    assert port[0]["submitted"] == 2                  # the shed spec was not admitted
    assert port[3] == ref[3]
    _assert_close(port[2], ref[2], 2000 / 256)


def _block(pkg, data):
    q = PKGS[pkg][0]
    store = _store(pkg, data, capacity=256)
    sess = _manual_session(store.engine(), max_pending=2, overflow="block")
    sess.submit(q.AqpQuery("count", (q.Range("a", -1.0, 1.0),)))
    sess.submit(q.AqpQuery("count", (q.Range("a", -2.0, 2.0),)))
    got = []

    def blocked_submit():
        got.append(sess.submit(q.AqpQuery("count", (q.Range("a", -3.0, 3.0),)))
                   .result(timeout=WAIT))

    t = threading.Thread(target=blocked_submit, daemon=True)
    t.start()
    t.join(timeout=0.2)
    parked = t.is_alive()
    blocked = sess.stats()["blocked"]
    sess.flush()                             # frees room: the submit proceeds
    for _ in range(200):
        if sess.pending:
            break
        t.join(timeout=0.05)
    sess.flush()                             # flush the unblocked submit
    t.join(timeout=WAIT)
    assert not t.is_alive() and len(got) == 1
    sess.close()
    want = store.engine().execute([q.AqpQuery("count", (q.Range("a", -3.0, 3.0),))])[0]
    return parked, blocked, got[0], want, _counters(sess.stats())


def test_max_pending_block_parks_until_flush_frees_room(rng):
    data = _data(rng, n=2000)
    ref, port = _block("ref", data), _block("port", data)
    parked, blocked, got, want, st = port
    assert parked and ref[0] and blocked == ref[1] == 1
    assert _key(got) == _key(want)
    assert st == ref[4]
    _assert_close([got], [ref[2]], 2000 / 256)


def _oversized(pkg, data):
    q = PKGS[pkg][0]
    store = _store(pkg, data, capacity=256, categorical=True)
    with _manual_session(store.engine(), max_pending=2, overflow="shed") as sess:
        fut = sess.submit(q.AqpQuery("count", (q.Range("b", -5.0, 5.0),),
                                     group_by=q.GroupBy("code", values=(0.0, 1.0, 2.0, 3.0))))
        pending, shed = sess.pending, sess.stats()["shed"]
        sess.flush()
        return pending, shed, fut.result(timeout=WAIT)


def test_max_pending_oversized_ticket_admitted_on_empty_queue(rng):
    """A GROUP BY spec whose parts alone exceed max_pending is admitted once
    the queue is empty, not shed or parked forever."""
    data = _data(rng, n=2000)
    ref, port = _oversized("ref", data), _oversized("port", data)
    assert port[:2] == ref[:2] == (4, 0)
    assert len(port[2]) == 4
    _assert_close(port[2], ref[2], 2000 / 256)


def test_max_pending_close_unblocks(rng):
    for pkg in PKGS:
        q = PKGS[pkg][0]
        store = _store(pkg, _data(rng, n=2000), capacity=256)
        sess = _manual_session(store.engine(), max_pending=1, overflow="block")
        sess.submit(q.AqpQuery("count", (q.Range("a", -1.0, 1.0),)))
        errs = []

        def blocked_submit():
            try:
                sess.submit(q.AqpQuery("count", (q.Range("a", -2.0, 2.0),)))
            except RuntimeError as exc:
                errs.append(exc)

        t = threading.Thread(target=blocked_submit, daemon=True)
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive()
        sess.close()                             # close() wakes parked submitters
        t.join(timeout=WAIT)
        assert not t.is_alive() and len(errs) == 1
        assert "closed" in str(errs[0])


def _backpressure_stats(pkg, data):
    q, _, _, full = PKGS[pkg]
    store = _store(pkg, data, capacity=256)
    sess = _manual_session(store.engine(), max_pending=1, overflow="shed")
    sess.submit(q.AqpQuery("count", (q.Range("a", -1.0, 1.0),)))
    with pytest.raises(full):
        sess.submit(q.AqpQuery("count", (q.Range("a", -2.0, 2.0),)))
    agg = store.stats()["admission"]
    sess.close()
    return agg, store.stats()["admission"]


def test_store_stats_aggregate_backpressure_counters(rng):
    data = _data(rng, n=2000)
    ref, port = _backpressure_stats("ref", data), _backpressure_stats("port", data)
    assert port == ref
    assert port[0]["shed"] == 1 and port[0]["blocked"] == 0


# --- fit offload: slow first fits must not stall the flusher ------------------

def _fit_offload(pkg, data):
    q, _, adm, _ = PKGS[pkg]
    store = _store(pkg, data, capacity=256)
    engine = store.engine()
    sess = _manual_session(engine, max_delay=0.0, fit_offload=True)
    spec = q.AqpQuery("count", (q.Box(("a", "b"), (-1.0, -1.0), (1.0, 1.0)),),
                      selector="lscv_H")
    fut = sess.submit(spec)
    polled = sess.poll()
    requeued = sess.fit_requeued
    r = fut.result(timeout=120)
    want = engine.execute([spec])[0]            # the synopsis is cached now
    st = _counters(sess.stats())
    fut2 = sess.submit(q.AqpQuery("count", (q.Box(("a", "b"), (-2.0, -2.0), (0.0, 0.0)),),
                                  selector="lscv_H"))
    sess.poll()
    done2 = fut2.done()
    sess.close()
    return (polled, requeued, st["flush_reasons"].get(adm.FLUSH_FIT), st["fit_requeued"],
            done2, sess.fit_requeued, store.stats()["admission"]["fit_requeued"]), r, want


def test_fit_offload_requeues_and_resolves(rng):
    """fit_offload=True: a due lscv_H bucket whose synopsis is not cached
    hands the fit to a worker thread (poll flushes nothing inline), the
    worker re-flushes it with reason "fit", and the answer is the port's
    execute's; a second ticket on the cached key flushes inline."""
    data = _data(rng, n=256)
    ref, port = _fit_offload("ref", data), _fit_offload("port", data)
    assert port[0] == ref[0] == (0, 1, 1, 1, True, 1, 1)
    got, want = port[1], port[2]
    assert _key(got) == _key(want) and got.path == ref[1].path == "qmc"
    assert ref[1].ci_lo <= got.estimate <= ref[1].ci_hi


def _offload_default(pkg, data):
    q = PKGS[pkg][0]
    store = _store(pkg, data, capacity=256)
    sess = _manual_session(store.engine(), max_delay=0.0)
    fut = sess.submit(q.AqpQuery("count", (q.Range("a", -1.0, 1.0),), selector="lscv_H"))
    sess.poll()
    seen = [fut.done(), sess.fit_requeued]
    sess.close()
    sess2 = _manual_session(store.engine(), max_delay=0.0, fit_offload=True)
    fut2 = sess2.submit(q.AqpQuery("count", (q.Range("a", -1.0, 1.0),)))
    sess2.poll()
    seen += [fut2.done(), sess2.fit_requeued]
    sess2.close()
    return seen


def test_fit_offload_disabled_by_default_and_fast_selectors_inline(rng):
    data = _data(rng, n=256)
    assert _offload_default("port", data) == _offload_default("ref", data) == \
        [True, 0, True, 0]


# --- observability on and off ------------------------------------------------

def test_answers_with_obs_on_equal_obs_off(rng):
    """The obs-disabled path is the same call as before: with spans, fences
    and kernel profiling on, a session's answers keep their bits."""
    from repro_torch import obs

    data = _data(rng)
    off, _ = _session_answers("port", data, _mixed_specs)
    was = obs.enabled()
    obs.enable()
    try:
        on, _ = _session_answers("port", data, _mixed_specs)
    finally:
        if not was:
            obs.disable()
    assert [_key(r) for r in on] == [_key(r) for r in off]
