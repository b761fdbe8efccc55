"""Count-min sketches, store merges, the store's small conveniences and the
legacy query surface, held against the JAX package on the CPU: the same
numpy inputs into `repro` and `repro_torch` (`device="cpu"`).

Tolerances: count-min tables, hash parameters, estimates, range terms and
errors, merged reservoirs and sketches, and "exact" / "exact:cm" answers
with their CI bounds are bit-equal (the same numpy code runs on both
sides).  KDE answers agree at the store tests' rtol 1e-4 plus atol 1e-4 x
scale (scale = n_source / sample size).
"""
import copy
import warnings

import numpy as np
import pytest

from repro.core import aqp as jaqp
from repro.core import aqp_multid as jmd
from repro.core import aqp_query as jq
from repro.data import aqp_store as jstore
from repro_torch import convert
from repro_torch.core import aqp as taqp
from repro_torch.core import aqp_multid as tmd
from repro_torch.core import aqp_query as tq
from repro_torch.data import aqp_store as tstore

CAPACITY = 256
JOINT = ("loss", "latency", "grad")


def _stream(seed: int, batches: int = 3, rows: int = 700, code_lo: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        latent = rng.normal(0, 1, rows)
        out.append({
            "loss": (2.0 + 0.5 * latent + rng.normal(0, 0.4, rows)).astype(np.float32),
            "latency": np.exp(3.0 + 0.3 * latent + rng.normal(0, 0.3, rows)).astype(np.float32),
            "grad": (1.0 + 0.3 * latent + rng.normal(0, 0.5, rows)).astype(np.float32),
            "code": rng.integers(code_lo, code_lo + 8, rows).astype(np.float32),
            "wide": rng.integers(-3000, 3000, rows).astype(np.float32),
        })
    return out


def _fill(store, stream, tiered: bool = False):
    store.track_joint(JOINT)
    store.track_categorical("code")
    store.track_categorical("wide", kind="cm", width=512)
    if tiered:
        store.track_tiered("tloss", n_tiers=3)
    for batch in stream:
        store.add_batch(dict(batch, **({"tloss": batch["loss"]} if tiered else {})))
    return store


def _both(stream, seed: int = 0, tiered: bool = False):
    return (_fill(jstore.TelemetryStore(capacity=CAPACITY, seed=seed), stream, tiered),
            _fill(tstore.TelemetryStore(capacity=CAPACITY, seed=seed, device="cpu"), stream,
                  tiered))


def _assert_res_equal(mine, ref):
    np.testing.assert_array_equal(mine.sample(), ref.sample())
    assert (mine.n_seen, mine.n_filled, mine.version) == (ref.n_seen, ref.n_filled, ref.version)
    for a, b in zip(getattr(mine, "tiers", [mine]), getattr(ref, "tiers", [ref])):
        np.testing.assert_array_equal(a.sample(), b.sample())
        assert a.rng.bit_generator.state == b.rng.bit_generator.state


def _assert_cm_equal(mine, ref):
    np.testing.assert_array_equal(mine.table, ref.table)
    assert mine.table.dtype == np.uint32
    np.testing.assert_array_equal(mine._mul, ref._mul)
    np.testing.assert_array_equal(mine._add, ref._add)
    assert (mine.n_rows, mine.saturated, mine.off_grid, mine.conservative) == \
        (ref.n_rows, ref.saturated, ref.off_grid, ref.conservative)
    assert mine.stats() == ref.stats()


def _assert_close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-4, atol=1e-4 * scale)


# --- count-min sketches -------------------------------------------------------

@pytest.mark.parametrize("conservative", [False, True])
def test_count_min_tables_and_estimates_are_bit_equal(conservative):
    rng = np.random.default_rng(1)
    mine = tstore.CountMinSketch(width=64, depth=4, seed=7, conservative=conservative)
    ref = jstore.CountMinSketch(width=64, depth=4, seed=7, conservative=conservative)
    for _ in range(4):
        # skewed codes over a range wider than the table: collisions happen
        batch = np.round(rng.zipf(1.3, 3000) % 500 - 40).astype(np.float32)
        mine.add(batch)
        ref.add(batch)
    _assert_cm_equal(mine, ref)
    for code in (-40.0, -3.0, 0.0, 1.0, 2.0, 17.0, 459.0, 1e6):
        assert mine.estimate(code) == ref.estimate(code)
    for lo, hi in ((-40.5, -20.5), (0.5, 1.5), (-1.0, 60.0), (2.2, 2.8), (0.0, 100.0)):
        assert mine.range_terms(lo, hi) == ref.range_terms(lo, hi)
        assert mine.range_err(lo, hi) == ref.range_err(lo, hi)
    assert mine.err_bound() == ref.err_bound() > 0
    assert mine.exact_for(12_000) and not mine.exact_for(11_999)


def test_conservative_update_never_under_counts_and_beats_the_standard_one():
    rng = np.random.default_rng(2)
    codes = np.round(rng.zipf(1.5, 20_000) % 2000).astype(np.float32)
    std = tstore.CountMinSketch(width=128, depth=3, seed=1)
    cons = tstore.CountMinSketch(width=128, depth=3, seed=1, conservative=True)
    ref = jstore.CountMinSketch(width=128, depth=3, seed=1, conservative=True)
    for chunk in np.array_split(codes, 5):
        std.add(chunk)
        cons.add(chunk)
        ref.add(chunk)
    _assert_cm_equal(cons, ref)
    truth = dict(zip(*np.unique(codes, return_counts=True)))
    err_std = err_cons = 0
    for c, k in truth.items():
        assert cons.estimate(c) >= k and std.estimate(c) >= k
        err_std += std.estimate(c) - k
        err_cons += cons.estimate(c) - k
    assert err_cons < err_std


@pytest.mark.parametrize("case", ["off_grid", "half_grid", "wide", "alias", "empty"])
def test_count_min_grid_cases_are_bit_equal(case):
    """The declared code lattice: off-grid values turn range answers off,
    a declared half grid enumerates half codes, windows past max_enumerate
    and empty windows, and grid points beyond float32 resolution counted
    once."""
    kw, batches, windows = {}, [], []
    if case == "off_grid":
        batches = [np.asarray([1, 2, 3], np.float32), np.asarray([2.5, 4], np.float32)]
        windows = [(0.5, 3.5), (2.0, 3.0)]
    elif case == "half_grid":
        kw = {"grid_step": 0.5}
        batches = [np.asarray([0.5, 1.0, 1.5, 1.5, -2.5], np.float32)]
        windows = [(0.25, 1.75), (-3.0, 0.0), (1.5, 1.5)]
    elif case == "wide":
        kw = {"max_enumerate": 8}
        batches = [np.arange(20, dtype=np.float32)]
        windows = [(0.0, 7.0), (0.0, 8.0), (-100.0, 100.0)]
    elif case == "alias":
        kw = {"grid_origin": 16_777_216.0}
        batches = [np.asarray([16_777_216.0, 16_777_218.0], np.float32)]
        windows = [(16_777_216.0, 16_777_219.0)]
    else:
        batches = [np.asarray([1, 2], np.float32)]
        windows = [(1.2, 1.8), (5.0, 4.0)]
    mine = tstore.CountMinSketch(width=32, depth=3, seed=3, **kw)
    ref = jstore.CountMinSketch(width=32, depth=3, seed=3, **kw)
    for b in batches:
        mine.add(b)
        ref.add(b)
    _assert_cm_equal(mine, ref)
    for lo, hi in windows:
        assert mine._grid_codes(lo, hi) == ref._grid_codes(lo, hi)
        assert mine.range_terms(lo, hi) == ref.range_terms(lo, hi)
        assert mine.range_err(lo, hi) == ref.range_err(lo, hi)
    if case == "off_grid":
        assert mine.off_grid and mine.range_terms(0.5, 3.5) is None
        assert mine.estimate(2.0) == 1
    with pytest.raises(ValueError, match="grid_step"):
        tstore.CountMinSketch(grid_step=0.0)
    with pytest.raises(ValueError, match="width"):
        tstore.CountMinSketch(width=0)


def test_count_min_saturates_instead_of_wrapping():
    out = []
    for mod in (tstore, jstore):
        sk = mod.CountMinSketch(width=8, depth=2, seed=0)
        sk.table[:] = np.uint32((1 << 32) - 3)
        sk.add(np.asarray([1, 1, 1, 1, 2], np.float32))
        out.append(sk)
        assert sk.saturated > 0 and not sk.exact_for(5)
        assert int(sk.table.max()) == (1 << 32) - 1
    _assert_cm_equal(*out)
    # a merge past the cap and an int64 table of an older snapshot clip too
    merged = [a.merge(a) for a in out]
    _assert_cm_equal(*merged)
    arrays, meta = out[1].state()
    arrays["table"] = arrays["table"].astype(np.int64) + 10
    mine = tstore.CountMinSketch.from_state(arrays, meta)
    _assert_cm_equal(mine, jstore.CountMinSketch.from_state(arrays, meta))
    assert mine.saturated > out[0].saturated


def test_count_min_merge_checks_the_hash_parameters():
    rng = np.random.default_rng(4)
    parts = {}
    for name, mod in (("port", tstore), ("ref", jstore)):
        a = mod.CountMinSketch(width=64, depth=3, seed=5, conservative=True)
        b = mod.CountMinSketch(width=64, depth=3, seed=5)
        parts[name] = (a, b)
    xs = [rng.integers(0, 200, 900).astype(np.float32) for _ in range(2)]
    for name in parts:
        parts[name][0].add(xs[0])
        parts[name][1].add(xs[1])
    got = parts["port"][0].merge(parts["port"][1])
    _assert_cm_equal(got, parts["ref"][0].merge(parts["ref"][1]))
    assert not got.conservative and got.n_rows == 1800
    a = parts["port"][0]
    for other, match in ((tstore.CountMinSketch(width=32, depth=3, seed=5), "geometry"),
                         (tstore.CountMinSketch(width=64, depth=3, seed=6), "hash"),
                         (tstore.CountMinSketch(width=64, depth=3, seed=5, grid_step=0.5),
                          "grids")):
        with pytest.raises(ValueError, match=match):
            a.merge(other)


def test_count_min_from_state_keeps_the_stored_hashes():
    ref = jstore.CountMinSketch(width=64, depth=4, seed=9, grid_step=0.5, grid_origin=0.25)
    ref.add(np.asarray([0.25, 0.75, 0.75, 3.25], np.float32))
    arrays, meta = ref.state()
    arrays = dict(arrays, mul=arrays["mul"] + np.uint64(2))   # not what seed 9 draws
    mine = tstore.CountMinSketch.from_state(arrays, meta)
    _assert_cm_equal(mine, jstore.CountMinSketch.from_state(arrays, meta))
    assert not np.array_equal(mine._mul, tstore.CountMinSketch(64, 4, 9)._mul)


def test_exact_cm_answers_and_intervals_match_reference():
    """Eq terms on a count-min column answer on "exact:cm" with the CI of the
    over-count bound: one-sided for COUNT, asymmetric for SUM over negative
    codes, ratio bounds for AVG; a window wider than the enumeration limit
    goes back to the KDE in both packages."""
    ref, port = _both(_stream(0))
    specs = []
    for m in (jq, tq):
        specs.append([
            m.AqpQuery("count", (m.Eq("wide", -17.0),)),
            m.AqpQuery("sum", (m.Eq("wide", -17.0),), target="wide"),
            m.AqpQuery("sum", (m.Eq("wide", 5.0, halfwidth=2.0),), target="wide"),
            m.AqpQuery("avg", (m.Eq("wide", 12.0, halfwidth=3.0),), target="wide"),
            m.AqpQuery("avg", (m.Eq("wide", 99_999.0),), target="wide"),
            m.AqpQuery("count", (m.Eq("wide", 0.0, halfwidth=100.0),)),
            m.AqpQuery("count", (m.Eq("code", 3.0),)),
        ])
    want = ref.query(specs[0])
    got = port.query(specs[1])
    assert [r.path for r in got] == [r.path for r in want] == \
        ["exact:cm"] * 5 + ["range1d", "exact"]
    for g, w in zip(got[:5] + got[6:], want[:5] + want[6:]):
        assert (g.estimate, g.ci_lo, g.ci_hi, g.n_effective, g.synopsis_version) == \
            (w.estimate, w.ci_lo, w.ci_hi, w.n_effective, w.synopsis_version)
    _assert_close(got[5].estimate, want[5].estimate, 3 * 700 / CAPACITY)
    cnt = got[0]
    assert cnt.ci_hi == cnt.estimate and cnt.ci_lo < cnt.estimate
    assert got[1].ci_hi > got[1].estimate        # negative code: truth may sit above
    # a code never seen takes the collision mass of its cells: AVG is the
    # code itself, inside ratio bounds that reach far below it
    assert got[4].ci_lo < got[4].estimate <= got[4].ci_hi


def test_track_categorical_validation_and_seeding():
    for mod, kw in ((jstore, {}), (tstore, {"device": "cpu"})):
        store = mod.TelemetryStore(capacity=64, seed=0, **kw)
        with pytest.raises(ValueError, match="unknown sketch kind"):
            store.track_categorical("a", kind="bloom")
        with pytest.raises(ValueError, match="conservative"):
            store.track_categorical("a", conservative=True)
        with pytest.raises(ValueError, match="grid_step"):
            store.track_categorical("a", grid_step=0.5)
        store.track_categorical("b", kind="cm", width=128, depth=3, conservative=True,
                                grid_step=0.5, grid_origin=0.25)
        sk = store.categoricals["b"]
        assert (sk.width, sk.depth, sk.conservative, sk.grid_step, sk.grid_origin) == \
            (128, 3, True, 0.5, 0.25)
        store.track_categorical("b")               # already tracked: kept
        assert store.categoricals["b"] is sk
    # seeded from the column name alone: stores of other seeds hash alike
    a = tstore.TelemetryStore(capacity=64, seed=1, device="cpu")
    b = tstore.TelemetryStore(capacity=64, seed=2, device="cpu")
    r = jstore.TelemetryStore(capacity=64, seed=3)
    for s in (a, b, r):
        s.track_categorical("model_id", kind="cm")
    _assert_cm_equal(a.categoricals["model_id"], r.categoricals["model_id"])
    _assert_cm_equal(b.categoricals["model_id"], r.categoricals["model_id"])


# --- store merges and the store's conveniences -------------------------------------

@pytest.fixture(scope="module")
def merged():
    ref1, port1 = _both(_stream(0), seed=0, tiered=True)
    ref2, port2 = _both(_stream(1, batches=2, rows=500, code_lo=4), seed=1, tiered=True)
    extra = np.random.default_rng(9).normal(0, 1, 300).astype(np.float32)
    for s in (ref2, port2):
        s.add_batch({"only_second": extra})
        s.track_categorical("only_cm", kind="cm")
        s.add_batch({"only_cm": np.arange(30, dtype=np.float32)})
    ref, port = ref1.merge(ref2), port1.merge(port2)
    return (ref1, ref2, ref), (port1, port2, port)


def test_merged_reservoirs_and_sketches_are_bit_equal(merged):
    (r1, r2, ref), (p1, p2, port) = merged
    assert port.device.type == "cpu"
    assert sorted(port.columns) == sorted(ref.columns)
    for name in ref.columns:
        _assert_res_equal(port.columns[name], ref.columns[name])
    _assert_res_equal(port.joints[JOINT], ref.joints[JOINT])
    assert isinstance(port.columns["tloss"], tstore.TieredReservoir)
    # the parents' RNGs moved alike (each merge draws the child's seed first)
    for mine, theirs in ((p1, r1), (p2, r2)):
        for name in theirs.columns:
            _assert_res_equal(mine.columns[name], theirs.columns[name])
    assert port.categoricals["code"].counts == ref.categoricals["code"].counts
    assert port.categoricals["code"].n_rows == ref.categoricals["code"].n_rows
    _assert_cm_equal(port.categoricals["wide"], ref.categoricals["wide"])
    _assert_cm_equal(port.categoricals["only_cm"], ref.categoricals["only_cm"])


def test_merged_store_answers_like_the_reference(merged):
    (_, _, ref), (_, _, port) = merged
    specs = [[m.AqpQuery("count", (m.Range("loss", 1.5, 2.5),)),
              m.AqpQuery("avg", (m.Box(JOINT, (1.0, 10.0, 0.0), (3.0, 30.0, 2.0)),),
                         target="grad"),
              m.AqpQuery("sum", (m.Range("tloss", 0.0, 2.0),)),
              m.AqpQuery("count", (m.Eq("code", 5),)),
              m.AqpQuery("count", (m.Eq("wide", 12.0),)),
              m.AqpQuery("count", (m.Range("only_second", -1.0, 1.0),))]
             for m in (jq, tq)]
    want = ref.query(specs[0])
    got = port.query(specs[1])
    assert [r.path for r in got] == [r.path for r in want]
    assert got[3].path == "exact" and got[4].path == "exact:cm"
    for g, w in zip(got, want):
        _assert_close([g.estimate, g.ci_lo, g.ci_hi], [w.estimate, w.ci_lo, w.ci_hi],
                      (3 * 700 + 2 * 500) / CAPACITY)
        assert g.n_effective == w.n_effective
    rounds = list(port.query(specs[1], mode="progressive"))
    for (t, g), (_, w) in zip(rounds, ref.query(specs[0], mode="progressive")):
        assert t in (0, 1, 2)
        _assert_close([r.estimate for r in g], [r.estimate for r in w],
                      (3 * 700 + 2 * 500) / 64)


def test_merge_does_not_alias_one_sided_entries(merged):
    (_, r2, ref), (_, p2, port) = merged
    before = port.columns["only_second"].sample()
    cm_before = port.categoricals["only_cm"].table.copy()
    assert port.columns["only_second"] is not p2.columns["only_second"]
    assert port.categoricals["only_cm"] is not p2.categoricals["only_cm"]
    p2.add_batch({"only_second": np.full(5000, 99.0, np.float32),
                  "only_cm": np.full(10, 3.0, np.float32)})
    np.testing.assert_array_equal(port.columns["only_second"].sample(), before)
    np.testing.assert_array_equal(port.categoricals["only_cm"].table, cm_before)
    # a one-sided sketch does not cover the merged stream of its column
    assert port.stats()["categoricals"]["only_cm"]["exact"] == \
        ref.stats()["categoricals"]["only_cm"]["exact"]


def test_store_stats_match_reference(merged):
    (_, _, ref), (_, _, port) = merged
    want = ref.stats()
    got = port.stats()
    assert "admission" not in got
    for key in ("columns", "joints", "backfilled", "categoricals"):
        assert got[key] == want[key], key
    assert set(got["cache"]) == set(want["cache"])


def test_count_avg_fraction_match_reference():
    ref, port = _both(_stream(0))
    scale = 3 * 700 / CAPACITY
    for a, b in ((1.5, 2.5), (0.0, 2.0), (3.5, 9.0)):
        _assert_close(port.count("loss", a, b), ref.count("loss", a, b), scale)
        _assert_close(port.avg("loss", a, b), ref.avg("loss", a, b), 1e-3)
        _assert_close(port.fraction("loss", a, b), ref.fraction("loss", a, b), 1e-4 / CAPACITY)
    assert isinstance(port.fraction("loss", 1.0, 2.0), float)
    assert port.count("loss", 1.0, 2.0, "silverman") == pytest.approx(
        ref.count("loss", 1.0, 2.0, "silverman"), rel=1e-4)


def test_synopsis_cache_peek_invalidate_entries_nbytes():
    _, port = _both(_stream(0))
    cache = port.cache
    syn = port.synopsis("loss")
    port.joint_synopsis(JOINT)
    port.synopsis("loss", backend="cuda")
    assert len(cache) == 3 and cache.nbytes == cache.stats()["bytes"] > 0
    stats = cache.stats()
    version = port.columns["loss"].version
    assert cache.peek("loss", "PLUGIN", version, backend="torch") is syn
    assert cache.peek("loss", "plugin", version + 1, backend="torch") is None
    assert cache.peek("grad", "plugin", version, backend="torch") is None
    assert cache.stats() == stats                       # no hit, no miss counted
    keys = [k for k, _, _ in cache.entries()]
    assert keys == [("loss", "plugin", "torch"), (JOINT, "plugin", "torch"),
                    ("loss", "plugin", "cuda")]
    cache.get("loss", "plugin", version, backend="torch")   # refreshes recency
    assert [k for k, _, _ in cache.entries()][-1] == ("loss", "plugin", "torch")
    assert all(v == port.columns["loss"].version for k, v, _ in cache.entries()
               if k[0] == "loss")
    cache.invalidate("loss")
    assert [k for k, _, _ in cache.entries()] == [(JOINT, "plugin", "torch")]
    assert cache.nbytes == sum(int(t.nbytes) for t in
                               (port.joint_synopsis(JOINT).x, port.joint_synopsis(JOINT).h))
    cache.invalidate()
    assert len(cache) == 0 and cache.nbytes == 0


def test_plan_cache_entries_and_stats():
    _, port = _both(_stream(0))
    eng = port.shared_engine()
    specs = [tq.AqpQuery("count", (tq.Range("loss", 1.0, 2.0),)),
             tq.AqpQuery("count", (tq.Box(JOINT, (1, 10, 0), (3, 30, 2)),))]
    eng.execute(specs)
    eng.execute(specs)
    assert eng.plans.stats() == {"hits": 2, "misses": 2, "entries": 2}
    version = port.columns["loss"].version
    assert (((("loss", "plugin", None), "torch"), version) in eng.plans.entries())


# --- the legacy surface -------------------------------------------------------

def _legacy_queries():
    return [("count", 1.5, 2.5, "loss"), ("sum", 0.0, 2.0, "loss"),
            ("avg", 15.0, 30.0, "latency"), ("count", 60.0, 90.0, "latency")]


def _legacy_boxes():
    return [("count", (1.0, 10.0, 0.0), (3.0, 30.0, 2.0), JOINT),
            ("sum", (1.0, 10.0, 0.0), (3.0, 30.0, 2.0), JOINT, "latency"),
            ("avg", (1.0, 10.0, 0.0), (3.0, 30.0, 2.0), JOINT, 2)]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_store_query_batch_and_query_box_batch_match_reference(backend):
    ref, port = _both(_stream(0))
    scale = 3 * 700 / CAPACITY
    _assert_close(port.query_batch(_legacy_queries(), backend=backend),
                  ref.query_batch(_legacy_queries()), scale)
    _assert_close(port.query_batch([taqp.Query(*q) for q in _legacy_queries()]),
                  ref.query_batch(_legacy_queries()), scale)
    _assert_close(port.query_box_batch(_legacy_boxes(), backend=backend),
                  ref.query_box_batch(_legacy_boxes()), scale)


def test_query_batch_run_warns_and_matches_the_synopsis_methods():
    ref, port = _both(_stream(0))
    mine = {"loss": port.synopsis("loss"), "latency": port.synopsis("latency")}
    theirs = {"loss": ref.synopsis("loss"), "latency": ref.synopsis("latency")}
    qs = [taqp.Query(*q) for q in _legacy_queries()]
    with pytest.warns(DeprecationWarning, match="QueryBatch.run"):
        got = taqp.QueryBatch(qs).run(mine)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jaqp.QueryBatch([jaqp.Query(*q) for q in _legacy_queries()]).run(theirs)
    _assert_close(got, want, 3 * 700 / CAPACITY)
    batch = taqp.QueryBatch(_legacy_queries())
    assert len(batch) == 4 and batch.columns == ["loss", "latency"]
    assert batch._groups == {"loss": [0, 1], "latency": [2, 3]}
    one = [("count", 1.5, 2.5), ("avg", 1.0, 3.0)]
    np.testing.assert_array_equal(mine["loss"].query_batch(one),
                                  taqp.run_legacy_queries([taqp.Query(*q) for q in one],
                                                          mine["loss"]))
    _assert_close(mine["loss"].query_batch(one), theirs["loss"].query_batch(one),
                  3 * 700 / CAPACITY)
    with pytest.raises(ValueError, match="unknown op"):
        taqp.Query("median", 0.0, 1.0)
    with pytest.raises(ValueError, match="single synopsis"):
        taqp.QueryBatch(qs[:1]).run(mine["loss"])


def test_box_query_batch_run_warns_and_matches_reference():
    ref, port = _both(_stream(0))
    mine, theirs = port.joint_synopsis(JOINT), ref.joint_synopsis(JOINT)
    boxes = [tmd.BoxQuery(*q) for q in _legacy_boxes()]
    assert boxes[1].target_index() == 1 and boxes[2].target_index() == 2
    with pytest.warns(DeprecationWarning, match="BoxQueryBatch.run"):
        got = tmd.BoxQueryBatch(boxes).run({JOINT: mine})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jmd.BoxQueryBatch([jmd.BoxQuery(*q) for q in _legacy_boxes()]).run(
            {JOINT: theirs})
    scale = 3 * 700 / CAPACITY
    _assert_close(got, want, scale)
    bare = [("count", (1.0, 10.0, 0.0), (3.0, 30.0, 2.0)),
            ("sum", (1.0, 10.0, 0.0), (3.0, 30.0, 2.0), None, 1)]
    _assert_close(mine.query_box_batch(bare), theirs.query_box_batch(bare), scale)
    lo, hi = (1.0, 10.0, 0.0), (3.0, 30.0, 2.0)
    _assert_close(float(mine.avg_box(lo, hi, 1)), float(theirs.avg_box(lo, hi, 1)), 1e-3)
    batch = tmd.BoxQueryBatch(_legacy_boxes())
    assert batch.column_groups == [JOINT] and len(batch) == 3
    with pytest.raises(ValueError, match="mix box"):
        tmd.BoxQueryBatch([("count", (0, 0), (1, 1)), ("count", (0,), (1,))])
    with pytest.raises(ValueError, match="not among"):
        tmd.BoxQuery("sum", (0, 0), (1, 1), ("a", "b"), "c")
    with pytest.raises(KeyError, match="no joint synopsis"):
        tmd.run_legacy_boxes(boxes[:1], {("x", "y", "z"): mine})


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_execute_specs_matches_reference(backend):
    ref, port = _both(_stream(0))
    mapping = [{"loss": s.synopsis("loss"), JOINT: s.joint_synopsis(JOINT)}
               for s in (ref, port)]
    specs = [[m.AqpQuery("count", (m.Range("loss", 1.5, 2.5),)),
              m.AqpQuery("sum", (m.Box(JOINT, (1, 10, 0), (3, 30, 2)),), target="grad"),
              m.AqpQuery("avg", (m.Range("loss", 1.0, 3.0),))]
             for m in (jq, tq)]
    want = jq.execute_specs(specs[0], mapping[0])
    got = tq.execute_specs(specs[1], mapping[1], backend=backend)
    _assert_close(got, want, 3 * 700 / CAPACITY)
    bare = [tq.AqpQuery("count", (tq.Range(None, 1.5, 2.5),))]
    _assert_close(tq.execute_specs(bare, mapping[1]["loss"]),
                  jq.execute_specs([jq.AqpQuery("count", (jq.Range(None, 1.5, 2.5),))],
                                   mapping[0]["loss"]), 3 * 700 / CAPACITY)
    with pytest.raises(ValueError, match="group_by"):
        tq.execute_specs([tq.AqpQuery("count", (), group_by="code")], mapping[1])
    with pytest.raises(ValueError, match="selector"):
        tq.execute_specs([tq.AqpQuery("count", (tq.Range("loss", 0, 1),),
                                      selector="lscv_h")], mapping[1])
    with pytest.raises(KeyError, match="no synopsis for column"):
        tq.execute_specs([tq.AqpQuery("count", (tq.Range("grad", 0, 1),))], mapping[1])
    assert tq.QueryEngine(port).answers(specs[1][:1]).dtype == np.float64


def test_synopsis_merge_refits_on_the_union():
    ref, port = _both(_stream(0))
    a, b = port.synopsis("loss"), port.synopsis("latency")
    m = a.merge(a, max_sample=4 * CAPACITY)
    want = ref.synopsis("loss").merge(ref.synopsis("loss"), max_sample=4 * CAPACITY)
    assert m.n_source == 2 * a.n_source and m.x.shape == (2 * CAPACITY,)
    np.testing.assert_array_equal(np.sort(m.x.numpy()), np.sort(np.asarray(want.x)))
    assert float(m.h) == pytest.approx(float(want.h), rel=1e-4)
    # above max_sample: a seeded subsample (not the reference's rows)
    small = a.merge(b, max_sample=CAPACITY, seed=3)
    again = a.merge(b, max_sample=CAPACITY, seed=3)
    assert small.x.shape == (CAPACITY,) and bool((small.x == again.x).all())
    assert small.n_source == a.n_source + b.n_source


# --- carried snapshots ----------------------------------------------------------

def test_store_from_state_reads_tiered_and_count_min_entries():
    stream = _stream(0)
    ref = jstore.TelemetryStore(capacity=CAPACITY, seed=0)
    ref.track_tiered("loss", n_tiers=3)
    ref.track_tiered(JOINT, n_tiers=3, strat_column="grad")
    ref.track_categorical("wide", kind="cm", conservative=True)
    for batch in stream:
        ref.add_batch(batch)
    specs = [[m.AqpQuery("count", (m.Range("loss", 1.5, 2.5),)),
              m.AqpQuery("sum", (m.Box(JOINT, (1, 10, 0), (3, 30, 2)),), target="loss"),
              m.AqpQuery("count", (m.Eq("wide", 12.0),))]
             for m in (jq, tq)]
    want = list(ref.query(specs[0], mode="progressive"))     # fits every tier
    carried = convert.store_from_state(*ref.to_state(), device="cpu")
    for key in ("loss",):
        _assert_res_equal(carried.columns[key], ref.columns[key])
    _assert_res_equal(carried.joints[JOINT], ref.joints[JOINT])
    assert carried.joints[JOINT].codes() == ref.joints[JOINT].codes()
    _assert_cm_equal(carried.categoricals["wide"], ref.categoricals["wide"])
    misses = carried.cache.stats()["misses"]
    got = list(carried.query(specs[1], mode="progressive"))
    assert carried.cache.stats()["misses"] == misses     # every tier's fit came along
    for (_, g), (_, w) in zip(got, want):
        assert [r.path for r in g] == [r.path for r in w]
        _assert_close([r.estimate for r in g], [r.estimate for r in w], 3 * 700 / 64)
        assert (g[2].estimate, g[2].ci_lo, g[2].ci_hi) == (w[2].estimate, w[2].ci_lo, w[2].ci_hi)
    extra = _stream(5, batches=1)[0]
    clone = jstore.TelemetryStore.from_state(*ref.to_state())
    clone.add_batch(extra)
    carried.add_batch(extra)
    _assert_res_equal(carried.joints[JOINT], clone.joints[JOINT])
    _assert_cm_equal(carried.categoricals["wide"], clone.categoricals["wide"])
    assert copy.deepcopy(carried.categoricals["wide"]).stats() == \
        clone.categoricals["wide"].stats()
