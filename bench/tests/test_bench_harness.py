"""CPU tests of the benchmark's harness: cells, configurations, traffic and
metrics resolved by name from BENCHMARK.json; a metric added by files
alone; the generators' seeding; the roofline counts; the trace reduction;
the guards of `bench/run.py`."""
from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench import harness, roofline, streams
from bench import trace as btrace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = harness.load_cell(name)
    assert cell.chips == 1
    assert {"capacity", "columns", "stream_rows", "n_qmc", "ci_level"} <= set(cell.config)
    assert cell.traffic["dashboard"] and cell.traffic["selector"]
    assert cell.limits["reservoir_mismatch"] == 0
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_reader(m["name"]))


def test_benchmark_entries_keep_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["name"]: m["layer"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert "\n" not in layers[m["name"]]


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_metric_is_added_by_new_files_and_entries_only(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "bench")
    (tmp_path / "bench" / "metrics" / "refreshes_done.py").write_text(
        "def read(run):\n    return float(len(run.refreshes))\n")
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["per_layer"].append({"name": "refreshes_done", "unit": "count", "better": "higher",
                             "source": "host_clock", "layer": "harness",
                             "moves": "refresh_ms", "workloads": [CELLS[0]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    after = _digest(tmp_path / "bench")
    assert {k: v for k, v in after.items() if k in before} == before
    cell = harness.load_cell(CELLS[0], root=tmp_path)
    assert "refreshes_done" in [m["name"] for m in cell.per_layer]
    run = harness.Run(cell=cell, setup_s=1.0, window_s=1.0, refreshes=[None] * 3)
    assert harness.load_reader("refreshes_done", root=tmp_path)(run) == 3.0
    assert "refreshes_done" not in [m["name"] for m in harness.load_cell(CELLS[-1], root=tmp_path).per_layer]


def _small(cell):
    cell.config.update(capacity=256, stream_rows=6000)
    cell.traffic.update(ingest_rows=1000, pool_batches=3, probe_rows=3000)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_traffic_repeats_for_a_seed_and_differs_across_seeds(name):
    cell = _small(harness.load_cell(name))
    seed = 2 ** 31 + 77

    def draw(s):
        st = streams.make_stream(s, cell.config, cell.traffic)
        return st, streams.make_dashboard(s, cell.config, cell.traffic, st.probe)

    (a, da), (b, db), (c, dc) = draw(seed), draw(seed), draw(seed + 1)
    for x, y in zip(a.setup + a.pool, b.setup + b.pool):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert da == db
    assert not np.array_equal(a.pool[0][next(iter(a.pool[0]))], c.pool[0][next(iter(c.pool[0]))])
    assert da != dc
    # the same sizes and the same spec mix whatever the seed
    assert [len(next(iter(x.values()))) for x in a.pool] == \
        [len(next(iter(x.values()))) for x in c.pool]
    assert [(r.kind, r.aggregate, r.columns, r.target) for r in da] == \
        [(r.kind, r.aggregate, r.columns, r.target) for r in dc]


def test_dashboard_matches_the_cells_description():
    kde = harness.load_cell("kde1d.lscv_h.all-cols")
    st = streams.make_stream(3, _small(kde).config, kde.traffic)
    rows = streams.make_dashboard(3, kde.config, kde.traffic, st.probe)
    assert sum(r.kind == "range" for r in rows) == 512 and sum(r.kind == "eq" for r in rows) == 64
    assert {r.columns[0] for r in rows if r.kind == "range"} == \
        {"loss", "latency_ms", "grad_norm", "tokens"}
    joint = harness.load_cell("joint3.lscv_H")
    st = streams.make_stream(3, _small(joint).config, joint.traffic)
    rows = streams.make_dashboard(3, joint.config, joint.traffic, st.probe)
    assert len(rows) == 128 and all(r.kind == "box" and len(r.columns) == 3 for r in rows)
    assert tuple(rows[0].columns) == tuple(joint.config["joints"][0])
    # chip_smoke's box recipe: lower quantile in [0, 0.4], width in [0.4, 0.9]
    assert joint.traffic["dashboard"][0]["lo_q"] == [0.0, 0.4]
    assert joint.traffic["dashboard"][0]["width_q"] == [0.4, 0.9]


def test_a_configuration_outside_the_benchmark_runs_under_a_listed_cell():
    cell = harness.load_cell("joint8.lscv_H", config="joint8-n16384", like="joint3.lscv_H")
    assert cell.name == "joint8.lscv_H" and len(cell.config["joints"][0]) == 8
    assert cell.traffic == harness.load_cell("joint3.lscv_H").traffic
    assert cell.limits == harness.load_cell("joint3.lscv_H").limits
    assert {m["name"] for m in cell.per_layer} >= {"nm_evals", "gh_fused_sum_roofline"}
    assert "joint8.lscv_H" not in CELLS


def test_roofline_counts_match_hand_counts():
    # sv_matrix, n = 4, d = 2: 6 pairs of (4 + 6 - 1) = 9 FLOPs; writes 64 bytes of S
    assert roofline.sv_matrix_s(4, 2) == max((32 + 16 + 64) / roofline.PEAK_BYTES,
                                             54 / roofline.PEAK_FP32)
    # lscv_grid_sums, n = 4, 3 grid points: 6 FLOPs per (pair, h) over 6 pairs
    assert roofline.lscv_grid_sums_s(4, 3) == max((24 + 24 + 8) / roofline.PEAK_BYTES,
                                                  108 / roofline.PEAK_FP32)
    # gh_fused_sum, n = 3, d = 2: 3 pairs of (4 + 6 + 4) = 14 FLOPs
    assert roofline.gh_fused_sum_s(3, 2) == max((24 + 16 + 12) / roofline.PEAK_BYTES,
                                                42 / roofline.PEAK_FP32)
    # at the cells' sizes: sv_matrix bound by its 4 GiB of S, the others by FLOPs
    n = 32768
    assert roofline.sv_matrix_s(n, 1) == pytest.approx((4 * n + 4 + 4 * n * n) / 3.35e12)
    assert roofline.lscv_grid_sums_s(n, 150) == pytest.approx(6 * 150 * n * (n - 1) / 2 / 67e12)
    assert roofline.gh_fused_sum_s(n, 8) == pytest.approx(92 * n * (n - 1) / 2 / 67e12)
    assert roofline.share_pct(1e-3, 0, 0.0) is None
    assert roofline.share_pct(1e-3, 4, 8e-3) == pytest.approx(50.0)


def test_trace_reduction_attributes_finishers_and_labels_gaps():
    ms = 1_000_000
    dev = [("lscv_grid_tiles(float const*, int)", 0, 10 * ms),
           ("sum_tile_partials(float const*, long long, float*)", 10 * ms, 11 * ms),
           ("sv_tiles<1>(float const*, long long, int)", 20 * ms, 22 * ms),
           ("void at::native::elementwise_kernel<128, 4>", 30 * ms, 31 * ms)]
    host = [("bench.window", 0, 40 * ms), ("bench.execute", 0, 25 * ms),
            ("aten::argmin", 12 * ms, 19 * ms)]
    win = btrace.reduce_events(dev, host, 0, 40 * ms)
    assert win.family_s["lscv_grid_sums"] == pytest.approx(0.011)
    assert win.family_s["sv_matrix"] == pytest.approx(0.002)
    assert win.family_launches == {"lscv_grid_sums": 1, "sv_matrix": 1}
    assert win.busy_s == pytest.approx(0.014) and win.window_s == pytest.approx(0.040)
    labels = dict(win.idle_by_host)
    assert labels["aten::argmin"] == pytest.approx(0.009)
    assert labels["bench.window"] == pytest.approx(0.017)
    out = btrace.breakdown(win)
    assert out["device_ops"][0][0] == "lscv_grid_sums" and len(out["idle_gaps"]) <= 10


def test_readers_on_a_run():
    cell = harness.load_cell(CELLS[0])
    recs = [harness.Refresh(k, t, t + 0.01, t + 0.1, None, None, {}, {})
            for k, t in enumerate((0.0, 0.1, 0.2, 0.3))]
    run = harness.Run(cell=cell, setup_s=12.5, window_s=0.4, refreshes=recs,
                      spans=[{"name": "engine.plan", "t0": 0.0, "t1": 0.02}] * 4,
                      span_refreshes=2)
    read = harness.load_reader
    assert read("refresh_ms")(run) == pytest.approx(100.0)
    assert read("setup_s")(run) == 12.5
    assert read("ingest_ms")(run) == pytest.approx(10.0)
    assert read("execute_ms")(run) == pytest.approx(90.0)
    assert read("plan_ms")(run) == pytest.approx(40.0)   # over the spans' refreshes
    assert read("refresh_ms.p95")(run) == pytest.approx(100.0)
    for name in ("nm_evals", "device_idle_pct", "fit_gpu_ms.lscv_h", "sv_matrix_roofline"):
        assert read(name)(run) is None


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_under_bench_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "bench").rglob("*.py"))
    assert files
    for path in files:
        assert not _top_level_imports(path) & FORBIDDEN, path
    # what the reference and the harness load, in a fresh process
    code = ("import json, sys; sys.path[:0] = ['.', 'src']; "
            "import bench.reference, bench.check, bench.streams, bench.roofline, "
            "bench.trace, bench.harness; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert not set(json.loads(out.stdout)) & FORBIDDEN
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")


def _run_cli(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
                           "2147483999", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_run_refuses_without_enough_cuda_devices():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for a machine without one")
    out = _run_cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_refuses_in_a_directory_without_the_program(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch" in out.stderr
