"""The slices end to end: one seeded numpy stream fed to the JAX package's
`TelemetryStore` and to the port's on the CPU, one mixed batch of Range / Box
/ Eq specs through `store.query` in both (PLUGIN fits, and LSCV_h fits with
`selector="lscv_h"`), LSCV_H joint fits, and the reference's snapshot
carried into the port with `store_from_state`.  Also the port's device
policy, its not-yet-ported paths, and its import hygiene.

Tolerances: reservoir buffers and exact (sketch) answers are bit-equal —
the same numpy code runs on both sides.  KDE estimates and CI bounds agree
at rtol 1e-4 plus atol 1e-4 x scale (scale = n_source / sample size): the
AQP kernels' raw-sum tolerance carried through the sample->relation scale,
with PLUGIN's h agreeing to its float32 pairwise sums and LSCV_h's h equal
to the reference's (the same grid point; `tests/test_torch_lscv.py` holds
the g values).  LSCV_H joint fits agree by their float64 objective to 1e-2
relative: in d = 3 the two float32 Nelder-Mead runs part after a few steps
and neither has converged at the default 150 iterations.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import aqp_query as jq
from repro.data import aqp_store as jstore
from repro_torch import convert
from repro_torch.core import aqp_query as tq
from repro_torch.data import aqp_store as tstore
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
CAPACITY = 256
JOINT = ("loss", "latency", "grad")


def _stream(seed: int, batches: int = 3, rows: int = 700):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        latent = rng.normal(0, 1, rows)
        out.append({
            "loss": (2.0 + 0.5 * latent + rng.normal(0, 0.4, rows)).astype(np.float32),
            "latency": np.exp(3.0 + 0.3 * latent + rng.normal(0, 0.3, rows)).astype(np.float32),
            "grad": (1.0 + 0.3 * latent + rng.normal(0, 0.5, rows)).astype(np.float32),
            "code": rng.integers(0, 8, rows).astype(np.float32),
        })
    return out


def _fill(store, stream):
    store.track_joint(JOINT)
    store.track_categorical("code")
    for batch in stream:
        store.add_batch(batch)
    return store


def _specs(m):
    """The same mixed batch built from either package's spec classes."""
    return [
        m.AqpQuery("count", (m.Range("loss", 1.5, 2.5),)),
        m.AqpQuery("sum", (m.Range("loss", 0.0, 2.0),)),
        m.AqpQuery("avg", (m.Range("latency", 15.0, 30.0),)),
        m.AqpQuery("count", (m.Range("latency", 60.0, 90.0),)),
        m.AqpQuery("count", (m.Box(JOINT, (1.0, 10.0, 0.0), (3.0, 30.0, 2.0)),)),
        m.AqpQuery("sum", (m.Box(("latency", "loss", "grad"), (10, 1, 0), (30, 3, 2)),),
                   target="latency"),
        m.AqpQuery("avg", (m.Range("loss", 1.0, 3.0), m.Range("grad", 0.5, 1.5),
                           m.Range("latency", 0.0, 40.0)), target="grad"),
        m.AqpQuery("count", (m.Eq("code", 3),)),
        m.AqpQuery("sum", (m.Eq("code", 5),), target="code"),
        m.AqpQuery("avg", (m.Eq("code", 2),), target="code"),
        m.AqpQuery("count", (m.Range("loss", 2.0, 2.0),)),
    ]


@pytest.fixture(scope="module")
def stores():
    stream = _stream(0)
    ref = _fill(jstore.TelemetryStore(capacity=CAPACITY, seed=0), stream)
    port = _fill(tstore.TelemetryStore(capacity=CAPACITY, seed=0, device="cpu"), stream)
    return ref, port, ref.query(_specs(jq))


def _assert_results_match(got, want, scale, suffix=""):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.path == "exact":
            assert g.path == "exact"
            assert (g.estimate, g.ci_lo, g.ci_hi) == (w.estimate, w.ci_lo, w.ci_hi)
        else:
            assert g.path == w.path + suffix
            for field in ("estimate", "ci_lo", "ci_hi"):
                np.testing.assert_allclose(getattr(g, field), getattr(w, field),
                                           rtol=1e-4, atol=1e-4 * scale, err_msg=field)
        assert g.synopsis_version == w.synopsis_version
        assert g.n_effective == w.n_effective
        assert g.rel_width == pytest.approx(w.rel_width, rel=1e-3)


def test_reservoirs_are_bit_equal(stores):
    ref, port, _ = stores
    assert sorted(port.columns) == sorted(ref.columns)
    for name, res in ref.columns.items():
        mine = port.columns[name]
        np.testing.assert_array_equal(mine.sample(), res.sample())
        assert (mine.n_seen, mine.n_filled, mine.version) == \
            (res.n_seen, res.n_filled, res.version)
        assert mine.rng.bit_generator.state == res.rng.bit_generator.state
    np.testing.assert_array_equal(port.joints[JOINT].sample(), ref.joints[JOINT].sample())
    assert port.categoricals["code"].counts == ref.categoricals["code"].counts


@pytest.mark.parametrize("backend,suffix", [("torch", ""), ("cuda", ":cuda")])
def test_mixed_batch_matches_reference(stores, backend, suffix):
    ref, port, want = stores
    got = port.query(_specs(tq), backend=backend)
    scale = (3 * 700) / CAPACITY
    _assert_results_match(got, want, scale, suffix)
    assert {r.path for r in got} == {"range1d" + suffix, "box" + suffix, "exact"}


def test_cpu_store_defaults_to_the_plain_path(stores):
    _, port, _ = stores
    ops.reset_launch_counts()
    paths = {r.path for r in port.query(_specs(tq))}
    assert paths == {"range1d", "box", "exact"}
    assert sum(ops.launch_counts().values()) == 0


def test_repeat_query_is_bit_identical_from_caches(stores):
    _, port, _ = stores
    first = port.query(_specs(tq))
    misses = port.cache.stats()["misses"]
    again = port.query(_specs(tq))
    assert [(r.estimate, r.ci_lo, r.ci_hi) for r in first] == \
        [(r.estimate, r.ci_lo, r.ci_hi) for r in again]
    assert port.cache.stats()["misses"] == misses


def test_each_backend_fits_and_caches_its_own_synopsis():
    """A fit made on one backend never serves the other, so a store's answers
    do not depend on which backend fitted a column first."""
    port = _fill(tstore.TelemetryStore(capacity=CAPACITY, seed=0, device="cpu"),
                 _stream(0))
    plain = port.synopsis("loss", backend="torch")
    misses = port.cache.stats()["misses"]
    kern = port.synopsis("loss", backend="cuda")
    assert kern is not plain
    assert port.cache.stats()["misses"] == misses + 1
    assert port.synopsis("loss", backend="torch") is plain
    assert port.synopsis("loss", backend="cuda") is kern
    assert port.synopsis("loss") is plain          # the CPU's default backend


def test_store_from_state_answers_the_same(stores):
    ref, port, want = stores
    tree, meta = ref.to_state()
    carried = convert.store_from_state(tree, meta, device="cpu")
    for name, res in ref.columns.items():
        np.testing.assert_array_equal(carried.columns[name].sample(), res.sample())
    assert carried.joints[JOINT].backfilled == ref.joints[JOINT].backfilled
    misses = carried.cache.stats()["misses"]
    got = carried.query(_specs(tq))
    assert carried.cache.stats()["misses"] == misses      # cached fits carried over
    _assert_results_match(got, want, (3 * 700) / CAPACITY)
    # the RNG state came along: both sample the next batch identically
    extra = _stream(1, batches=1)[0]
    clone = jstore.TelemetryStore.from_state(tree, meta)
    clone.add_batch(extra)
    carried.add_batch(extra)
    np.testing.assert_array_equal(carried.columns["loss"].sample(),
                                  clone.columns["loss"].sample())
    np.testing.assert_array_equal(carried.joints[JOINT].sample(),
                                  clone.joints[JOINT].sample())


def test_synopsis_from_numpy_carries_a_reference_fit(stores):
    ref, _, _ = stores
    syn = ref.joint_synopsis(JOINT)
    mine = convert.synopsis_from_numpy(np.asarray(syn.x), np.asarray(syn.h),
                                       syn.n_source, syn.selector, device="cpu")
    lo, hi = (1.0, 10.0, 0.0), (3.0, 30.0, 2.0)
    np.testing.assert_allclose(float(mine.count_box(lo, hi)),
                               float(syn.count_box(lo, hi)), rtol=1e-4)


def test_store_from_state_refuses_unported_entries():
    """The count-min snapshot this once refused now loads and answers on
    "exact:cm" as the reference does (`tests/test_torch_sketch_merge.py`
    covers tiered and count-min snapshots in full)."""
    ref = jstore.TelemetryStore(capacity=64, seed=0)
    ref.track_categorical("code", kind="cm")
    ref.add_batch({"code": np.arange(10, dtype=np.float32)})
    carried = convert.store_from_state(*ref.to_state(), device="cpu")
    np.testing.assert_array_equal(carried.categoricals["code"].table,
                                  ref.categoricals["code"].table)
    specs = [m.AqpQuery("count", (m.Eq("code", 3),)) for m in (tq, jq)]
    got, = carried.query(specs[:1])
    want, = ref.query(specs[1:])
    assert got.path == want.path == "exact:cm"
    assert (got.estimate, got.ci_lo, got.ci_hi) == (want.estimate, want.ci_lo, want.ci_hi)


def test_store_without_device_needs_cuda():
    if torch.cuda.is_available():
        assert tstore.TelemetryStore().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tstore.TelemetryStore()


@pytest.mark.parametrize("call", ["to_state", "save"])
def test_snapshot_paths_answer(call, tmp_path):
    """The store's snapshots answer (ROADMAP queue 1.12): `to_state` gives
    the reference's format with JSON-safe metadata, `save` writes step 1 of
    a keep-k checkpoint directory; `tests/test_torch_durability.py` holds
    both against the reference."""
    import json

    store = tstore.TelemetryStore(capacity=64, seed=0, device="cpu")
    store.track_categorical("code")
    rng = np.random.default_rng(0)
    store.add_batch({"a": rng.normal(0, 1, 500).astype(np.float32),
                     "code": rng.integers(0, 4, 500).astype(np.float32)})
    store.synopsis("a")
    if call == "to_state":
        tree, meta = store.to_state()
        assert meta["format"] == tstore.STATE_FORMAT == 1
        assert tree["columns/a/buf"].shape == (64,)
        assert [e["backend"] for e in meta["cache"]] == ["torch"]
        json.dumps(meta)
    else:
        assert store.save(str(tmp_path)) == 1
        assert sorted(p.name for p in (tmp_path / "step_00000001").iterdir()) == \
            ["arrays.npz", "manifest.json"]


def test_port_imports_neither_jax_nor_repro():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [p.name for p in examples] == ["torch_aqp_database.py",
                                          "torch_distributed_bandwidth.py",
                                          "torch_quickstart.py", "torch_serve_lm.py",
                                          "torch_train_lm.py"]
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + examples)
    assert len(files) > 10
    walked = {p.relative_to(ROOT / "src" / "repro_torch").as_posix() for p in files
              if "repro_torch" in p.parts}
    assert {"optim/adamw.py", "optim/grad_compress.py", "data/pipeline.py",
            "checkpoint/__init__.py", "checkpoint/checkpoint.py", "checkpoint/elastic.py",
            "train/train_step.py", "launch/train.py", "launch/mesh.py", "launch/pipeline.py",
            "launch/dryrun.py", "roofline.py", "sharding.py"} <= walked
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from repro_torch.kernels import _build\n"
            "assert _build._libs == {}, _build._libs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# --- the LSCV slice ------------------------------------------------------------------

@pytest.mark.parametrize("backend,suffix", [("torch", ""), ("cuda", ":cuda")])
def test_lscv_h_batch_matches_reference(stores, backend, suffix):
    """selector="lscv_h": the fits go through LSCV_h (on "cuda", its kernel
    wrappers, which take the plain versions on the CPU) and the queries
    through the range1d / box paths with the scalar h."""
    ref, port, _ = stores
    want = ref.query(_specs(jq), selector="lscv_h")
    got = port.query(_specs(tq), selector="lscv_h", backend=backend)
    for col in ("loss", "latency"):
        assert float(port.synopsis(col, "lscv_h", backend=backend).h) == \
            pytest.approx(float(ref.synopsis(col, "lscv_h").h), rel=1e-6)
    assert float(port.joint_synopsis(JOINT, "lscv_h", backend=backend).h) == \
        pytest.approx(float(ref.joint_synopsis(JOINT, "lscv_h").h), rel=1e-6)
    _assert_results_match(got, want, (3 * 700) / CAPACITY, suffix)
    for g, w in zip(got, want):                   # within the reference's CI widths
        assert w.ci_lo - 1e-3 <= g.estimate <= w.ci_hi + 1e-3
    again = port.query(_specs(tq), selector="lscv_h", backend=backend)
    assert [r.estimate for r in again] == [r.estimate for r in got]


def test_lscv_h_batch_from_a_carried_snapshot(stores):
    ref, _, _ = stores
    want = ref.query(_specs(jq), selector="lscv_h")
    carried = convert.store_from_state(*ref.to_state(), device="cpu")
    misses = carried.cache.stats()["misses"]
    got = carried.query(_specs(tq), selector="lscv_h")
    assert carried.cache.stats()["misses"] == misses   # the LSCV_h fits came along
    _assert_results_match(got, want, (3 * 700) / CAPACITY)


def test_lscv_H_joint_fit_matches_reference_by_objective(stores):
    from test_torch_lscv import _g64_of_H

    ref, port, _ = stores
    want = ref.joint_synopsis(JOINT, selector="lscv_H")
    got = port.joint_synopsis(JOINT, selector="lscv_H")
    x = np.asarray(want.x)
    np.testing.assert_array_equal(got.x.numpy(), x)
    assert got.h is None and got.H.shape == (3, 3)
    assert np.all(np.linalg.eigvalsh(got.H.numpy().astype(np.float64)) > 0)
    g_got, g_want = _g64_of_H(x, got.H.numpy()), _g64_of_H(x, np.asarray(want.H))
    assert g_got == pytest.approx(g_want, rel=1e-2)
    from repro_torch.core.lscv import h_start
    assert g_got <= _g64_of_H(x, h_start(got.x).numpy())
    assert port.cache.stats()["bytes"] >= got.x.nbytes + got.H.nbytes


def test_store_from_state_carries_an_lscv_H_fit_whose_queries_wait_for_1_10():
    ref = _fill(jstore.TelemetryStore(capacity=64, seed=3), _stream(3, batches=1, rows=100))
    want = ref.joint_synopsis(JOINT, selector="lscv_H")
    carried = convert.store_from_state(*ref.to_state(), device="cpu")
    syn = carried.joint_synopsis(JOINT, selector="lscv_H")
    assert syn.h is None and syn.selector == "lscv_H"
    np.testing.assert_array_equal(syn.H.numpy(), np.asarray(want.H))
    np.testing.assert_array_equal(syn.x.numpy(), np.asarray(want.x))
    # its queries answer on the full-H qmc path, as the reference's do
    box = [m.AqpQuery("count", (m.Box(JOINT, (1.0, 10.0, 0.0), (3.0, 30.0, 2.0)),))
           for m in (tq, jq)]
    got, = carried.query(box[:1], selector="lscv_H")
    want, = ref.query(box[1:], selector="lscv_H")
    assert got.path == want.path == "qmc"
    for field in ("estimate", "ci_lo", "ci_hi"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-4, err_msg=field)
    with pytest.raises(ValueError, match="exactly one"):
        convert.synopsis_from_numpy(np.zeros((4, 2)), None, 4, "lscv_H", device="cpu")
