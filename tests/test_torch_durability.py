"""Durable stores (ROADMAP queue 1.12) in both packages and across them: the
store-level cases of `tests/test_aqp_durability.py` run on the JAX package's
`TelemetryStore` and on the port's (on the CPU), the port's
`CheckpointManager` (the cases of `tests/test_checkpoint.py` that a flat
dict of arrays has), the five `state()` methods bit-equal to the
reference's, and snapshots carried both ways: `repro` saves and
`repro_torch` loads, `repro_torch` saves and `repro` loads, and a port
snapshot with "torch" and "cuda" fits restores each backend's own.

Tolerances: reservoirs, RNG states, sketches and exact answers are
bit-equal (the same numpy code runs in both packages).  KDE estimates and
CI bounds of one package against the other agree at `tests/
test_torch_store.py`'s rtol 1e-4 plus atol 1e-4 x scale (scale =
n_source / sample size); a store against its own restored copy agrees bit
for bit.
"""
import os
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import aqp_query as jq
from repro.data import aqp_store as jstore
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import aqp_query as tq
from repro_torch.data import aqp_store as tstore

PKGS = {"ref": (jq, jstore, {}), "port": (tq, tstore, {"device": "cpu"})}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))
WAIT = 30.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors on many test workers: one intra-op thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _new(pkg, capacity, seed=0):
    _, smod, kw = PKGS[pkg]
    return smod.TelemetryStore(capacity=capacity, seed=seed, **kw)


def _load(pkg, path, **extra):
    _, smod, kw = PKGS[pkg]
    return smod.TelemetryStore.load(str(path), **kw, **extra)


def _from_state(pkg, tree, meta):
    _, smod, kw = PKGS[pkg]
    return smod.TelemetryStore.from_state(tree, meta, **kw)


def _full_store(pkg, rng, n=20_000, capacity=512):
    """Every durable part: per-column reservoirs, a streamed joint, a
    backfilled joint, an exact sketch, a count-min sketch."""
    store = _new(pkg, capacity)
    store.track_joint(("a", "b"))
    store.track_categorical("code")
    store.track_categorical("wide", kind="cm")
    a = rng.normal(0, 1, n).astype(np.float32)
    store.add_batch({
        "a": a,
        "b": (0.8 * a + 0.6 * rng.normal(0, 1, n)).astype(np.float32),
        "code": rng.integers(0, 4, n).astype(np.float32),
        "wide": rng.integers(0, 10_000, n).astype(np.float32),
    })
    store.track_joint(("code", "b"))     # backfilled from the per-column samples
    return store


def _batch(rng, n=5_000):
    a = rng.normal(0.5, 1, n).astype(np.float32)
    return {
        "a": a,
        "b": (0.8 * a + 0.6 * rng.normal(0, 1, n)).astype(np.float32),
        "code": rng.integers(0, 4, n).astype(np.float32),
        "wide": rng.integers(0, 10_000, n).astype(np.float32),
    }


def _specs(pkg):
    q = PKGS[pkg][0]
    return [
        q.AqpQuery("count", (q.Range("a", -1.0, 1.0),)),
        q.AqpQuery("sum", (q.Range("b", -0.5, 2.0),), target="b"),
        q.AqpQuery("avg", (q.Box(("a", "b"), (-1.0, -1.0), (1.0, 1.0)),), target="b"),
        q.AqpQuery("count", (q.Eq("code", 2.0),)),
        q.AqpQuery("count", (q.Eq("wide", 137.0),)),
    ]


def _assert_rows_identical(r1, r2):
    assert len(r1) == len(r2)
    for x, y in zip(r1, r2):
        assert (x.estimate, x.ci_lo, x.ci_hi) == (y.estimate, y.ci_lo, y.ci_hi), (x, y)
        assert x.path == y.path and x.synopsis_version == y.synopsis_version


def _assert_rows_close(got, want, scale):
    """One package's answers against the other's (the module docstring's
    tolerances); exact answers bit-equal."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.path == w.path and g.synopsis_version == w.synopsis_version
        if w.path.startswith("exact"):
            assert (g.estimate, g.ci_lo, g.ci_hi) == (w.estimate, w.ci_lo, w.ci_hi)
            continue
        for field in ("estimate", "ci_lo", "ci_hi"):
            np.testing.assert_allclose(getattr(g, field), getattr(w, field), rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=field)


def _assert_stores_identical(s1, s2):
    assert sorted(s1.columns) == sorted(s2.columns)
    for name, res in s1.columns.items():
        other = s2.columns[name]
        np.testing.assert_array_equal(res.sample(), other.sample())
        assert (res.n_seen, res.n_filled, res.version) == \
            (other.n_seen, other.n_filled, other.version)
        assert res.rng.bit_generator.state == other.rng.bit_generator.state
    assert sorted(s1.joints) == sorted(s2.joints)
    for key, res in s1.joints.items():
        other = s2.joints[key]
        np.testing.assert_array_equal(res.sample(), other.sample())
        assert res.backfilled == other.backfilled
        assert (res.n_seen, res.version) == (other.n_seen, other.version)
    assert sorted(s1.categoricals) == sorted(s2.categoricals)
    for name, sk in s1.categoricals.items():
        assert sk.state()[1] == s2.categoricals[name].state()[1]


# --- round trips, restarts and warm starts (both packages) ---------------------

@BOTH
def test_roundtrip_then_add_batch_is_bit_identical(pkg, rng, tmp_path):
    """save -> load -> add_batch(B) gives bit-identical samples, versions, RNG
    states and answers to the store that was never saved, fed B."""
    store = _full_store(pkg, rng)
    store.save(str(tmp_path))
    restored = _load(pkg, tmp_path)
    _assert_stores_identical(store, restored)
    batch = _batch(rng)
    store.add_batch(batch)
    restored.add_batch(batch)
    _assert_stores_identical(store, restored)
    _assert_rows_identical(store.query(_specs(pkg)), restored.query(_specs(pkg)))


@BOTH
def test_restart_serving_process_scenario(pkg, rng, tmp_path):
    """A serving process restarted from a snapshot answers a batch through an
    admission session bit-identically to an uninterrupted one, with the
    exact categorical paths still on."""
    uninterrupted = _full_store(pkg, rng)
    uninterrupted.save(str(tmp_path))
    restarted = _load(pkg, tmp_path)
    batch = _batch(rng)
    uninterrupted.add_batch(batch)
    restarted.add_batch(batch)
    kw = dict(auto_flush=False, watermark=None, max_delay=None)
    with uninterrupted.session(**kw) as s1, restarted.session(**kw) as s2:
        r1 = s1.execute(_specs(pkg))
        r2 = s2.execute(_specs(pkg))
    _assert_rows_identical(r1, r2)
    assert r2[3].path == "exact" and r2[4].path == "exact:cm"
    assert restarted.stats()["categoricals"]["code"]["exact"] is True


@BOTH
def test_restore_warm_starts_fitted_synopses(pkg, rng, tmp_path):
    """The fitted synopses ride along: the restored store answers the same
    specs with zero synopsis-cache misses, and (the shared engine's plans
    primed from them) zero plan misses."""
    store = _full_store(pkg, rng)
    want = store.query(_specs(pkg))
    store.save(str(tmp_path))
    restored = _load(pkg, tmp_path)
    misses = restored.cache.stats()["misses"]
    got = restored.query(_specs(pkg))
    assert restored.cache.stats()["misses"] == misses
    assert restored.shared_engine().plans.misses == 0
    _assert_rows_identical(want, got)


@BOTH
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chained_weighted_merge_then_restore(pkg, seed, tmp_path):
    """A store built by chained weighted merges round-trips like any other:
    later updates and answers are bit-identical to the merged store's."""
    rng = np.random.default_rng(seed)
    parts = []
    for i, (mu, n) in enumerate([(0.0, 8000), (3.0, 4000), (6.0, 2000)]):
        st = _new(pkg, 256, seed=i)
        st.track_categorical("code")
        st.add_batch({"x": rng.normal(mu, 1, n).astype(np.float32),
                      "code": rng.integers(0, 3, n).astype(np.float32)})
        parts.append(st)
    merged = parts[0].merge(parts[1]).merge(parts[2])
    merged.save(str(tmp_path))
    restored = _load(pkg, tmp_path)
    _assert_stores_identical(merged, restored)
    batch = {"x": rng.normal(1, 1, 3000).astype(np.float32),
             "code": rng.integers(0, 3, 3000).astype(np.float32)}
    merged.add_batch(batch)
    restored.add_batch(batch)
    _assert_stores_identical(merged, restored)
    q = PKGS[pkg][0]
    specs = [q.AqpQuery("count", (q.Range("x", -1.0, 4.0),)),
             q.AqpQuery("count", (q.Eq("code", 1.0),))]
    _assert_rows_identical(merged.query(specs), restored.query(specs))


@BOTH
def test_save_keep_k_retains_latest(pkg, rng, tmp_path):
    mgr_cls = CheckpointManager if pkg == "port" else JCheckpointManager
    store = _full_store(pkg, rng, n=2_000, capacity=128)
    for _ in range(4):
        store.add_batch(_batch(rng, n=500))
        store.save(str(tmp_path), keep=2)
    assert mgr_cls(str(tmp_path), async_save=False).all_steps() == [3, 4]
    _assert_stores_identical(store, _load(pkg, tmp_path))


@BOTH
def test_tiered_store_roundtrip(pkg, rng, tmp_path):
    """Tier ladders and their strata restore with every RNG state: the next
    batch lands bit-identically, and a tier-0 answer matches."""
    store = _new(pkg, 256)
    store.track_tiered("a", n_tiers=3)
    store.track_tiered(("code", "b"), n_tiers=3, strat_column="code")
    store.add_batch(_batch(rng, n=4_000))
    store.save(str(tmp_path))
    restored = _load(pkg, tmp_path)
    batch = _batch(rng, n=1_000)
    store.add_batch(batch)
    restored.add_batch(batch)
    for key in ("a",):
        for t1, t2 in zip(store.columns[key].tiers, restored.columns[key].tiers):
            np.testing.assert_array_equal(t1.sample(), t2.sample())
            assert t1.rng.bit_generator.state == t2.rng.bit_generator.state
    j1, j2 = store.joints[("code", "b")], restored.joints[("code", "b")]
    assert j1.codes() == j2.codes()
    for code in j1.codes():
        np.testing.assert_array_equal(j1.stratum(code), j2.stratum(code))
    q = PKGS[pkg][0]
    spec = [q.AqpQuery("count", (q.Range("a", -1.0, 1.0),))]
    eng1, eng2 = store.engine(), restored.engine()
    _assert_rows_identical(eng1.run_compiled(eng1.compile(spec), tier=0),
                           eng2.run_compiled(eng2.compile(spec), tier=0))


# --- snapshot against mutation, refused snapshots, subscribers ------------------

@BOTH
def test_snapshot_never_persists_uncovered_sketch_rows(pkg, rng):
    """A snapshot racing add_batch sees whole batches only: no stored sketch
    claims more rows than its reservoir's n_seen."""
    store = _new(pkg, 128)
    store.track_categorical("code")
    snapshots = []
    stop = threading.Event()

    def snapshotter():
        while not stop.is_set():
            snapshots.append(store.to_state())

    t = threading.Thread(target=snapshotter, daemon=True)
    t.start()
    try:
        for _ in range(40):
            store.add_batch({"code": rng.integers(0, 4, 2_000).astype(np.float32)})
    finally:
        stop.set()
        t.join(WAIT)
    assert not t.is_alive() and len(snapshots) >= 2
    for tree, meta in snapshots:
        cat, col = meta["categoricals"].get("code"), meta["columns"].get("code")
        if cat is None or col is None:
            continue
        assert cat["n_rows"] == col["n_seen"], (cat, col)
        _from_state(pkg, tree, meta)              # never raises


@BOTH
def test_from_state_rejects_inconsistent_sketch(pkg, rng):
    store = _new(pkg, 128)
    store.track_categorical("code")
    store.add_batch({"code": rng.integers(0, 4, 1_000).astype(np.float32)})
    tree, meta = store.to_state()
    meta["categoricals"]["code"]["n_rows"] += 5      # claims unseen rows
    with pytest.raises(ValueError, match="inconsistent snapshot"):
        _from_state(pkg, tree, meta)


@BOTH
def test_from_state_rejects_unknown_format(pkg):
    tree, meta = _new(pkg, 64).to_state()
    meta["format"] = 999
    with pytest.raises(ValueError, match="format"):
        _from_state(pkg, tree, meta)


@BOTH
def test_restore_state_notifies_subscribers_and_rekeys_sessions(pkg, rng):
    """restore_state on a live store pushes the restored versions through the
    subscribe listeners: a pending admission bucket re-keys and flushes
    against (and reports) the restored version."""
    q = PKGS[pkg][0]
    store = _new(pkg, 256)
    store.add_batch({"x": rng.normal(0, 1, 4_000).astype(np.float32)})
    snapshot = store.to_state()                      # x at version 1
    store.add_batch({"x": rng.normal(0, 1, 1_000).astype(np.float32)})
    assert store.columns["x"].version == 2
    seen = []
    store.subscribe(seen.append)
    session = store.session(auto_flush=False, watermark=None, max_delay=None)
    fut = session.submit(q.AqpQuery("count", (q.Range("x", -1.0, 1.0),)))
    store.restore_state(*snapshot)                   # back to version 1
    assert seen and seen[-1]["x"] == 1
    assert session.stats()["invalidations"] == 1
    session.flush()
    assert fut.result(timeout=WAIT).synopsis_version == 1
    session.close()


@BOTH
def test_state_roundtrip_with_nan_codes(pkg):
    """A NaN row in a tracked categorical column does not break a snapshot
    (counts go by items(): a NaN key can never be looked up again)."""
    store = _new(pkg, 64)
    store.track_categorical("code")
    store.add_batch({"code": np.asarray([1.0, 2.0, np.nan], np.float32)})
    restored = _from_state(pkg, *store.to_state())
    sk = restored.categoricals["code"]
    assert sk.n_rows == 3
    assert sk.range_terms(0.5, 2.5) == (2, pytest.approx(3.0))


@BOTH
def test_count_min_restore_keeps_hash_parameters(pkg, rng, tmp_path):
    """The hash parameters are stored, not derived again on load, and a
    restored sketch still merges with the original."""
    store = _new(pkg, 128)
    store.track_categorical("wide", kind="cm")
    store.add_batch({"wide": rng.integers(0, 2_000, 10_000).astype(np.float32)})
    store.save(str(tmp_path))
    back = _load(pkg, tmp_path).categoricals["wide"]
    orig = store.categoricals["wide"]
    np.testing.assert_array_equal(back._mul, orig._mul)
    np.testing.assert_array_equal(back._add, orig._add)
    assert back.estimate(17.0) == orig.estimate(17.0)
    assert orig.merge(back).n_rows == 20_000


@BOTH
def test_to_state_consistent_under_concurrent_queries(pkg, rng):
    """Snapshots race live queries (cache hits reorder the LRU list while
    to_state reads it) and never fail."""
    q = PKGS[pkg][0]
    store = _new(pkg, 128)
    store.add_batch({"x": rng.normal(0, 1, 4_000).astype(np.float32),
                     "y": rng.normal(0, 1, 4_000).astype(np.float32)})
    stop = threading.Event()
    errs = []

    def querier():
        try:
            i = 0
            while not stop.is_set():
                store.query([q.AqpQuery("count", (q.Range(("x", "y")[i % 2], -1.0, 1.0),))],
                            selector=("plugin", "silverman")[i % 2])
                i += 1
        except Exception as exc:              # reported by the assert below
            errs.append(exc)

    t = threading.Thread(target=querier, daemon=True)
    t.start()
    try:
        for _ in range(30):
            _from_state(pkg, *store.to_state())
    finally:
        stop.set()
        t.join(WAIT)
    assert not t.is_alive() and not errs


# --- the five state() methods against the reference ----------------------------

def _states_equal(a, b):
    (arr_a, meta_a), (arr_b, meta_b) = a, b
    assert meta_a == meta_b
    if isinstance(arr_a, dict):
        assert sorted(arr_a) == sorted(arr_b)
        for k in arr_a:
            np.testing.assert_array_equal(arr_a[k], arr_b[k])
            assert arr_a[k].dtype == arr_b[k].dtype
    else:
        np.testing.assert_array_equal(arr_a, arr_b)
        assert arr_a.dtype == arr_b.dtype


def test_reservoir_and_sketch_states_equal_the_reference(rng):
    """`state()` of Reservoir, MultiReservoir, TieredReservoir,
    CategoricalSketch and CountMinSketch: the port's arrays and metadata
    equal the reference's on the same stream, after a merge too."""
    data = rng.normal(0, 1, 3_000).astype(np.float32)
    rows = rng.normal(0, 1, (3_000, 2)).astype(np.float32)
    codes = rng.integers(0, 5, 3_000).astype(np.float32)
    made = {}
    for name, smod in (("ref", jstore), ("port", tstore)):
        res = smod.Reservoir(256, seed=3)
        res.add(data)
        multi = smod.MultiReservoir(("u", "v"), 256, seed=4)
        multi.add(rows)
        multi.backfilled = True
        tiered = smod.TieredReservoir(256, n_tiers=3, seed=5, columns=("c", "u"),
                                      strat_column="c", strata_capacity=16)
        tiered.add(np.stack([codes, data], axis=1))
        cat = smod.CategoricalSketch(max_codes=16)
        cat.add(codes)
        cm = smod.CountMinSketch(width=64, depth=3, seed=7, conservative=True)
        cm.add(codes)
        made[name] = [res, multi, tiered, cat, cm, res.merge(res), tiered.merge(tiered)]
    for mine, theirs in zip(made["port"], made["ref"]):
        _states_equal(mine.state(), theirs.state())


# --- CheckpointManager ---------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"w": torch.randn(8, 16, generator=g)},
            "b": torch.arange(10, dtype=torch.int32),
            "c": torch.randn(4, generator=g).to(torch.bfloat16),
            "d": np.linspace(0, 1, 5)}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = _tree()
    mgr.save(5, tree, {"step": 5, "pipeline": {"step": 5, "seed": 0}})
    assert mgr.latest_step() == 5
    flat, extra = mgr.restore_flat(5)
    assert extra == {"step": 5, "pipeline": {"step": 5, "seed": 0}}
    assert sorted(flat) == ["a/w", "b", "c", "d"]
    np.testing.assert_array_equal(flat["a/w"], tree["a"]["w"].numpy())
    assert flat["b"].dtype == np.int32 and flat["d"].dtype == np.float64
    assert flat["c"].dtype == torch.bfloat16 and torch.equal(flat["c"], tree["c"])


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(7, _tree())
    mgr.wait()
    assert mgr.latest_step() == 7


def test_checkpoint_atomicity_tmp_dirs_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    os.makedirs(os.path.join(str(tmp_path), "tmp.99"), exist_ok=True)   # a crashed write
    mgr.save(1, _tree())
    assert mgr.all_steps() == [1]


def test_checkpoint_format_is_the_reference(tmp_path):
    """One on-disk format: the reference's manager reads the port's steps
    (the bfloat16 leaf folded back from its `.bf16` bits) and the port's
    reads the reference's."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    tree = _tree(3)
    CheckpointManager(str(port_dir), async_save=False).save(2, tree, {"k": 1})
    flat, extra = JCheckpointManager(str(port_dir), async_save=False).restore_flat(2)
    assert extra == {"k": 1}
    np.testing.assert_array_equal(flat["a/w"], tree["a"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(flat["c"], np.float32),
                                  tree["c"].float().numpy())
    JCheckpointManager(str(ref_dir), async_save=False).save(
        4, {"x": np.arange(6, dtype=np.float32), "y": {"z": np.ones(3, np.int64)}}, {"k": 2})
    flat, extra = CheckpointManager(str(ref_dir), async_save=False).restore_flat(4)
    assert extra == {"k": 2} and sorted(flat) == ["x", "y/z"]
    np.testing.assert_array_equal(flat["x"], np.arange(6, dtype=np.float32))


# --- snapshots across the packages ---------------------------------------------

def test_reference_snapshot_answers_in_the_port(rng, tmp_path):
    """`repro` saves, `repro_torch` loads: bit-equal reservoirs and sketches,
    the reference's fits served on the port's plain backend with zero cache
    and plan misses, answers within the tolerances of the reference's."""
    ref = _full_store("ref", rng)
    want = ref.query(_specs("ref"))
    ref.save(str(tmp_path))
    port = tstore.TelemetryStore.load(str(tmp_path), device="cpu")
    _assert_stores_identical(ref, port)
    got = port.query(_specs("port"), backend="torch")
    assert port.cache.stats()["misses"] == 0
    assert port.shared_engine("plugin", "torch").plans.misses == 0
    _assert_rows_close(got, want, 20_000 / 512)
    assert port.metrics.sum_counter("aqp.ingest.batches") == \
        ref.metrics.sum_counter("aqp.ingest.batches")
    batch = _batch(rng)
    ref.add_batch(batch)
    port.add_batch(batch)
    _assert_stores_identical(ref, port)


def test_port_snapshot_answers_in_the_reference(rng, tmp_path):
    """`repro_torch` saves, `repro` loads: bit-equal reservoirs and sketches,
    and the reference answers from the port's plain fits (written last, so
    they win the reference's one key per column) with zero cache misses,
    within the tolerances of the port's answers."""
    port = _full_store("port", rng)
    want = port.query(_specs("port"), backend="torch")
    port.query(_specs("port"), backend="cuda")           # a "cuda" fit of every column too
    tree, meta = port.to_state()
    backends = [e["backend"] for e in meta["cache"]]
    assert backends == sorted(backends, key=lambda b: b == "torch") and "cuda" in backends
    port.save(str(tmp_path))
    ref = jstore.TelemetryStore.load(str(tmp_path))
    _assert_stores_identical(port, ref)
    got = ref.query(_specs("ref"))
    assert ref.cache.stats()["misses"] == 0
    _assert_rows_close(got, want, 20_000 / 512)


def test_port_snapshot_restores_each_backends_own_fit(rng, tmp_path):
    """A "cuda" fit that differs from the "torch" fit of the same column comes
    back under its own backend and is served as it is: the restored store's
    answers on each backend equal the saving store's, bit for bit, with no
    refit; a fitted RFF density synopsis round-trips too."""
    from repro_torch.core.aqp_query import _rff_cache_key
    from repro_torch.synopses import RFFSynopsis

    port = _full_store("port", rng)
    spec = [tq.AqpQuery("count", (tq.Range("a", -1.0, 1.0),))]
    port.query(spec, backend="torch")
    syn = port.synopsis("a", backend="cuda")
    syn.h = syn.h * 1.5                       # a fit only the "cuda" entry holds
    want = {b: port.query(spec, backend=b) for b in ("torch", "cuda")}
    assert want["torch"][0].estimate != want["cuda"][0].estimate
    x = port.joint_synopsis(("a", "b"), backend="torch").x
    rff = RFFSynopsis.fit(x, torch.eye(2) * 0.1, n_features=64, seed=3)
    rff.degraded, rff.probe_rel_err = True, 0.25
    port.cache.put(_rff_cache_key(("a", "b"), 64), "lscv_H", port.joints[("a", "b")].version,
                   rff, backend="cuda")
    port.save(str(tmp_path))
    back = tstore.TelemetryStore.load(str(tmp_path), device="cpu")
    for b in ("torch", "cuda"):
        _assert_rows_identical(back.query(spec, backend=b), want[b])
    assert back.cache.stats()["misses"] == 0
    got = back.cache.peek(_rff_cache_key(("a", "b"), 64), "lscv_H",
                          back.joints[("a", "b")].version, backend="cuda")
    assert got is not None and got.degraded and got.probe_rel_err == 0.25
    for k in ("w", "b", "z"):
        assert torch.equal(getattr(got, k), getattr(rff, k))


def test_load_needs_a_snapshot_and_lands_on_the_asked_device(rng, tmp_path):
    with pytest.raises(FileNotFoundError, match="no completed snapshots"):
        tstore.TelemetryStore.load(str(tmp_path / "empty"), device="cpu")
    store = _full_store("port", rng, n=2_000, capacity=64)
    store.synopsis("a")
    store.save(str(tmp_path / "snap"))
    back = tstore.TelemetryStore.load(str(tmp_path / "snap"), device="cpu")
    assert back.device.type == "cpu"
    assert all(syn.x.device.type == "cpu" for _k, _v, syn in back.cache.entries())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tstore.TelemetryStore.load(str(tmp_path / "snap"))
