"""Tiered reservoirs and progressive execution: one seeded numpy stream fed
to the JAX package's `TelemetryStore` and to the port's on the CPU, with
tiered columns, a tiered joint and stratified ladders, and the same specs
answered round by round with `mode="progressive"` in both.

Tolerances: tier buffers, strata, codes and RNG states are bit-equal (the
same numpy code runs on both sides).  Progressive estimates and CI bounds
agree at the store tests' rtol 1e-4 plus atol 1e-4 x scale, with scale =
n_source / the tier's sample size; path labels, versions and n_effective
are equal.  The port's last round is bit-identical to its own `execute`.
"""
import numpy as np
import pytest

from repro.core import aqp_query as jq
from repro.data import aqp_store as jstore
from repro_torch.core import aqp_query as tq
from repro_torch.data import aqp_store as tstore

CAPACITY = 512
N_TIERS = 4
JOINT = ("loss", "latency", "grad")
SJOINT = ("grad", "code")                # a joint stratified on its code axis
N_SEEN = 3 * 1500                        # rows of the stream of `stores`


def _stream(seed: int, batches: int = 3, rows: int = 1500, n_codes: int = 8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        latent = rng.normal(0, 1, rows)
        out.append({
            "loss": (2.0 + 0.5 * latent + rng.normal(0, 0.4, rows)).astype(np.float32),
            "latency": np.exp(3.0 + 0.3 * latent + rng.normal(0, 0.3, rows)).astype(np.float32),
            "grad": (1.0 + 0.3 * latent + rng.normal(0, 0.5, rows)).astype(np.float32),
            "code": rng.integers(0, n_codes, rows).astype(np.float32),
            "plain": rng.normal(5.0, 1.0, rows).astype(np.float32),
        })
    return out


def _fill(store, stream):
    store.track_tiered("loss", n_tiers=N_TIERS)
    store.track_tiered("latency", n_tiers=N_TIERS)
    store.track_tiered(JOINT, n_tiers=N_TIERS)
    store.track_tiered("code", n_tiers=N_TIERS, strat_column="code")
    store.track_tiered(SJOINT, n_tiers=3, strat_column="code")
    for batch in stream:
        store.add_batch(batch)
    return store


def _specs(m):
    return [
        m.AqpQuery("count", (m.Range("loss", 1.5, 2.5),)),
        m.AqpQuery("sum", (m.Range("loss", 0.0, 2.0),)),
        m.AqpQuery("avg", (m.Range("latency", 15.0, 30.0),)),
        m.AqpQuery("count", (m.Range("latency", 25.0, 40.0),)),
        m.AqpQuery("count", (m.Box(JOINT, (1.0, 10.0, 0.0), (3.0, 30.0, 2.0)),)),
        m.AqpQuery("sum", (m.Box(("latency", "loss", "grad"), (10, 1, 0), (30, 3, 2)),),
                   target="latency"),
        m.AqpQuery("avg", (m.Box(SJOINT, (0.0, 1.5), (2.0, 5.5)),), target="grad"),
        m.AqpQuery("count", (m.Range("plain", 4.0, 6.0),)),
        m.AqpQuery("avg", (m.Range("code", 1.5, 4.5),)),
    ]


@pytest.fixture(scope="module")
def stores():
    stream = _stream(0)
    ref = _fill(jstore.TelemetryStore(capacity=CAPACITY, seed=0), stream)
    port = _fill(tstore.TelemetryStore(capacity=CAPACITY, seed=0, device="cpu"), stream)
    return ref, port, list(ref.query(_specs(jq), mode="progressive"))


def _assert_members_equal(mine, ref):
    np.testing.assert_array_equal(mine.sample(), ref.sample())
    assert (mine.n_seen, mine.n_filled, mine.version, mine.capacity) == \
        (ref.n_seen, ref.n_filled, ref.version, ref.capacity)
    assert mine.rng.bit_generator.state == ref.rng.bit_generator.state


def _assert_ladders_equal(mine, ref):
    assert isinstance(mine, tstore.TieredReservoir)
    assert (mine.n_tiers, mine.columns, mine.strat_column, mine.seed) == \
        (ref.n_tiers, ref.columns, ref.strat_column, ref.seed)
    assert mine.tier_sizes() == ref.tier_sizes()
    for a, b in zip(mine.tiers, ref.tiers):
        _assert_members_equal(a, b)
    assert mine.codes() == ref.codes()
    assert mine.strata_overflow == ref.strata_overflow
    for code in ref.codes():
        _assert_members_equal(mine.strata[code], ref.strata[code])
        np.testing.assert_array_equal(mine.stratum(code), ref.stratum(code))
    assert (mine.version, mine.n_seen, mine.n_filled) == (ref.version, ref.n_seen, ref.n_filled)


def _assert_rounds_match(got, want, suffix="", n_seen=N_SEEN):
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g_rows), (_, w_rows) in zip(got, want):
        assert len(g_rows) == len(w_rows)
        for g, w in zip(g_rows, w_rows):
            assert g.n_effective == w.n_effective
            assert g.synopsis_version == w.synopsis_version
            if w.path.startswith("exact"):
                assert g.path == w.path
                assert (g.estimate, g.ci_lo, g.ci_hi) == (w.estimate, w.ci_lo, w.ci_hi)
                continue
            assert g.path == w.path + suffix
            scale = n_seen / w.n_effective
            for field in ("estimate", "ci_lo", "ci_hi"):
                np.testing.assert_allclose(getattr(g, field), getattr(w, field), rtol=1e-4,
                                           atol=1e-4 * scale, err_msg=field)


def _rows(results):
    return [(r.estimate, r.ci_lo, r.ci_hi, r.path, r.synopsis_version, r.n_effective,
             r.group) for r in results]


@pytest.mark.parametrize("key", ["loss", "code", JOINT, SJOINT])
def test_tiers_strata_and_codes_are_bit_equal(stores, key):
    ref, port, _ = stores
    reg = (lambda s: s.joints) if isinstance(key, tuple) else (lambda s: s.columns)
    _assert_ladders_equal(reg(port)[key], reg(ref)[key])
    _assert_members_equal(port.columns["plain"], ref.columns["plain"])


def test_tier_geometry_and_clamping():
    rng = np.random.default_rng(3)
    res = tstore.TieredReservoir(capacity=1024, n_tiers=4, seed=0)
    res.add(rng.normal(0, 1, 5_000).astype(np.float32))
    assert res.tier_sizes() == [128, 256, 512, 1024]
    assert res.n_seen == 5_000 and res.n_filled == 1024 and res.version == 1
    np.testing.assert_array_equal(res.sample(), res.sample(3))
    np.testing.assert_array_equal(res.sample(99), res.sample(3))
    np.testing.assert_array_equal(res.sample(-7), res.sample(0))
    for tier in res.tiers:
        assert tier.n_seen == 5_000
    with pytest.raises(ValueError, match="n_tiers"):
        tstore.TieredReservoir(capacity=64, n_tiers=0)
    with pytest.raises(ValueError, match="too small"):
        tstore.TieredReservoir(capacity=4, n_tiers=8)
    with pytest.raises(ValueError, match="strat_column"):
        tstore.TieredReservoir(capacity=64, columns=("a", "b"), strat_column="c")


@pytest.mark.parametrize("columns,strat", [(None, "x"), (("a", "b"), "b"), (("a", "b"), None)])
def test_chained_merges_are_bit_equal(columns, strat):
    """Three ladders per package from the same streams, merged in a chain:
    every tier and stratum bit-equal, and each parent's RNG moved alike (the
    child's seed is drawn from the parent's top tier before the child is
    built)."""
    rng = np.random.default_rng(11)
    parts = {"ref": [], "port": []}
    for i, (mu, n) in enumerate([(0.0, 6_000), (3.0, 3_000), (6.0, 1_500)]):
        codes = rng.integers(0, 3, n).astype(np.float32) + 10.0 * i
        vals = rng.normal(mu, 1, n).astype(np.float32)
        data = codes if columns is None else np.stack([vals, codes], axis=1)
        for name, mod in (("ref", jstore), ("port", tstore)):
            t = mod.TieredReservoir(capacity=128, n_tiers=3, seed=i, columns=columns,
                                    strat_column=strat)
            t.add(data)
            parts[name].append(t)
    got = parts["port"][0].merge(parts["port"][1]).merge(parts["port"][2])
    want = parts["ref"][0].merge(parts["ref"][1]).merge(parts["ref"][2])
    _assert_ladders_equal(got, want)
    assert got.n_seen == 10_500
    for mine, ref in zip(parts["port"], parts["ref"]):
        _assert_ladders_equal(mine, ref)
    with pytest.raises(ValueError, match="different shape"):
        got.merge(tstore.TieredReservoir(capacity=128, n_tiers=2))


def test_reservoir_merges_are_bit_equal():
    """Plain and joint reservoirs: chained weighted merges of unequal
    streams, each parent's RNG moved alike, the joint's backfill flag
    sticky."""
    rng = np.random.default_rng(5)
    chunks = [rng.normal(i, 1, n).astype(np.float32) for i, n in enumerate((5000, 900, 40))]
    for cls_args in ((), (("a", "b"),)):
        out = {}
        for name, mod in (("ref", jstore), ("port", tstore)):
            make = (lambda s: mod.Reservoir(256, seed=s)) if not cls_args else \
                (lambda s: mod.MultiReservoir(cls_args[0], 256, seed=s))
            rs = []
            for s, c in enumerate(chunks):
                r = make(s)
                r.add(c if not cls_args else np.stack([c, -c], axis=1))
                rs.append(r)
            if cls_args:
                rs[1].backfilled = True
            out[name] = (rs, rs[0].merge(rs[1]).merge(rs[2]), rs[2].merge(make(9)))
        for mine, ref in zip(out["port"][0], out["ref"][0]):
            _assert_members_equal(mine, ref)
        for k in (1, 2):
            _assert_members_equal(out["port"][k], out["ref"][k])
        if cls_args:
            assert out["port"][1].backfilled and out["port"][1].columns == ("a", "b")
    with pytest.raises(ValueError, match="different"):
        tstore.MultiReservoir(("a", "b"), 8).merge(tstore.MultiReservoir(("a", "c"), 8))


def test_track_tiered_validation():
    for mod, kw in ((jstore, {}), (tstore, {"device": "cpu"})):
        store = mod.TelemetryStore(capacity=256, seed=0, **kw)
        with pytest.raises(ValueError, match="strat_column"):
            store.track_tiered("x", strat_column="y")
        store.add_batch({"x": np.arange(100, dtype=np.float32)})
        with pytest.raises(ValueError, match="before add_batch"):
            store.track_tiered("x")
        store.track_tiered("y", n_tiers=3)
        first = store.columns["y"]
        store.track_tiered("y", n_tiers=3)          # idempotent
        assert store.columns["y"] is first
        store.track_tiered(("x", "y"), n_tiers=2, strat_column="y")
        assert store.joints[("x", "y")].strat_column == "y"
        assert store.joints[("x", "y")].seed == store._col_seed("x|y")
        with pytest.raises(ValueError, match="strat_column"):
            store.track_tiered(("a", "b"), strat_column="c")


@pytest.mark.parametrize("backend,suffix", [("torch", ""), ("cuda", ":cuda")])
def test_progressive_rounds_match_reference(stores, backend, suffix):
    ref, port, want = stores
    got = list(port.query(_specs(tq), backend=backend, mode="progressive"))
    assert [t for t, _ in got] == list(range(N_TIERS))
    _assert_rounds_match(got, want, suffix)
    paths = {r.path for _, rows in got for r in rows}
    assert paths == {"range1d" + suffix, "box" + suffix}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_final_round_is_bit_identical_to_execute(stores, backend):
    _, port, _ = stores
    eng = port.shared_engine(backend=backend)
    rounds = list(eng.execute(_specs(tq), mode="progressive"))
    misses = port.cache.stats()["misses"]
    plan_misses = eng.plans.stats()["misses"]
    want = eng.execute(_specs(tq))
    assert _rows(rounds[-1][1]) == _rows(want)
    # the top tier collapses to the untiered keys: no refit, no replan
    assert port.cache.stats()["misses"] == misses
    assert eng.plans.stats()["misses"] == plan_misses


def test_ci_widths_tighten_and_n_effective_follow_the_tiers(stores):
    _, port, _ = stores
    rounds = list(port.query(_specs(tq), mode="progressive"))
    sizes = port.columns["loss"].tier_sizes()
    assert sizes == [64, 128, 256, 512]
    assert [rows[0].n_effective for _, rows in rounds] == sizes
    assert [rows[4].n_effective for _, rows in rounds] == port.joints[JOINT].tier_sizes()
    # the 3-tier joint answers from its top tier in rounds 2 and 3
    assert [rows[6].n_effective for _, rows in rounds] == [128, 256, 512, 512]
    widths = np.asarray([[r.ci_width for r in rows] for _, rows in rounds])
    assert np.all(np.isfinite(widths))
    med = np.median(widths, axis=1)
    assert all(a >= b for a, b in zip(med, med[1:]))
    assert widths[0, 0] > widths[-1, 0]
    # the untiered column answers from its one sample in every round
    np.testing.assert_array_equal(widths[:, 7], np.full(N_TIERS, widths[0, 7]))


def test_tier_synopses_live_under_tier_keys(stores):
    ref, port, _ = stores
    loss = port.columns["loss"]
    syn0 = port.synopsis("loss", tier=0)
    assert syn0.x.shape[0] == loss.tier_sizes()[0] and syn0.n_source == loss.n_seen
    assert port.synopsis("loss", tier=N_TIERS - 1) is port.synopsis("loss")
    assert port.synopsis("plain", tier=0) is port.synopsis("plain")
    np.testing.assert_array_equal(syn0.x.numpy(), np.asarray(ref.synopsis("loss", tier=0).x))
    assert float(syn0.h) == pytest.approx(float(ref.synopsis("loss", tier=0).h), rel=1e-4)
    jsyn = port.joint_synopsis(JOINT, tier=1)
    assert jsyn.x.shape == (port.joints[JOINT].tier_sizes()[1], 3)
    keys = {k[0] for k, _, _ in port.cache.entries()}
    assert {"loss#tier0", JOINT + ("#tier1",)} <= keys
    for res, tier in ((loss, None), (loss, 7), (loss, -2), (loss, 1),
                      (port.columns["plain"], 0), (port.joints[SJOINT], 2)):
        assert tq._effective_tier(res, tier) == jq._effective_tier(res, tier)
    for col, tier in (("loss", None), ("loss", 0), (JOINT, 2)):
        assert tq._tier_key(col, tier) == jq._tier_key(col, tier)


def test_progressive_without_tiers_is_one_round():
    stream = _stream(2, batches=1, rows=400)
    out = {}
    for name, mod, m, kw in (("ref", jstore, jq, {}), ("port", tstore, tq, {"device": "cpu"})):
        store = mod.TelemetryStore(capacity=128, seed=0, **kw)
        for batch in stream:
            store.add_batch(batch)
        specs = [m.AqpQuery("count", (m.Range("loss", 1.0, 3.0),))]
        out[name] = list(store.query(specs, mode="progressive"))
        if name == "port":
            assert _rows(out[name][0][1]) == _rows(store.query(specs))
            with pytest.raises(ValueError, match="mode"):
                store.query(specs, mode="bogus")
    _assert_rounds_match(out["port"], out["ref"], n_seen=400)
    assert [t for t, _ in out["port"]] == [0]


def test_rare_code_found_through_the_strata_union():
    """A code seen 10 times in a 40 000-row stream is displaced from every
    uniform tier; the stratified ladder still reports it, so GROUP BY gives
    it a row in both packages."""
    rng = np.random.default_rng(4)
    flood = rng.integers(0, 3, 40_000).astype(np.float32)
    out = {}
    for name, mod, m, kw in (("ref", jstore, jq, {}), ("port", tstore, tq, {"device": "cpu"})):
        store = mod.TelemetryStore(capacity=128, seed=0, **kw)
        store.track_tiered("code", strat_column="code")
        store.add_batch({"code": np.full(10, 9.0, np.float32)})
        store.add_batch({"code": flood})
        res = store.columns["code"]
        assert 9.0 not in set(np.round(res.sample()).tolist())
        assert 9.0 in res.codes() and len(res.stratum(9.0)) == 10
        out[name] = store.query([m.AqpQuery("count", (), group_by=m.GroupBy("code"))])
    assert [r.group for r in out["port"]] == [r.group for r in out["ref"]] == [0.0, 1.0, 2.0, 9.0]
    for g, w in zip(out["port"], out["ref"]):
        np.testing.assert_allclose(g.estimate, w.estimate, rtol=1e-4, atol=1e-4 * 40_010 / 128)
    rare = out["port"][-1]
    assert np.isfinite(rare.estimate) and rare.estimate >= 0.0


def test_strata_overflow_is_sticky_and_bit_equal():
    got = tstore.TieredReservoir(capacity=64, n_tiers=2, strat_column="x", max_strata=4)
    want = jstore.TieredReservoir(capacity=64, n_tiers=2, strat_column="x", max_strata=4)
    for batch in (np.arange(4), np.arange(8), np.asarray([np.nan, 1.0])):
        got.add(np.asarray(batch, np.float32))
        want.add(np.asarray(batch, np.float32))
    _assert_ladders_equal(got, want)
    assert got.strata_overflow and got.codes() == [0.0, 1.0, 2.0, 3.0]
    assert got.strata[1.0].n_seen == 3


def test_tiered_from_state_loads_the_reference_ladder(stores):
    ref, _, _ = stores
    for key in (JOINT, SJOINT):
        arrays, meta = ref.joints[key].state()
        mine = tstore.TieredReservoir.from_state(arrays, meta)
        _assert_ladders_equal(mine, ref.joints[key])
    arrays, meta = ref.columns["code"].state()
    mine = tstore.TieredReservoir.from_state(arrays, meta)
    clone = jstore.TieredReservoir.from_state(arrays, meta)
    extra = np.random.default_rng(8).integers(0, 12, 700).astype(np.float32)
    mine.add(extra)
    clone.add(extra)
    _assert_ladders_equal(mine, clone)
