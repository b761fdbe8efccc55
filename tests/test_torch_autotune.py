"""Tile tuning of the port (`repro_torch.kernels.autotune`, `tuning`, the
`ops.py` wrappers' resolution and `python -m repro_torch.launch.autotune`)
against the reference's (`repro.kernels.autotune`, `tests/test_autotune.py`):
call-time resolution, keyword over cache over module constant, the cache
file's schema both ways, and a fresh process that loads the cache with no
sweep.  The range, box and GROUP BY kernels' keys leave the batch `G` out
(`tests/test_torch_batch_invariance.py` holds their cut to n alone under a
tuned cache).  Sweeps time the card, so the one sweep test here needs it
(`cuda_device` skips without one); chip_smoke's phase T sweeps there.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.kernels import autotune as jtune
from repro.kernels.tuning import resolve_tile as jresolve_tile
from repro_torch import obs as tobs
from repro_torch.kernels import aqp_boxes as tabx
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import pairwise_reduce as tpr
from repro_torch.kernels.tuning import measured, resolve_tile
from repro_torch.launch import autotune as cli

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


@pytest.fixture(autouse=True)
def _fresh_tuners(monkeypatch):
    monkeypatch.delenv("REPRO_TUNING_CACHE", raising=False)
    autotune.reset()
    jtune.reset()
    yield
    autotune.reset()
    jtune.reset()


@pytest.fixture()
def cuda_device():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sweeps time the card)")
    return torch.device("cuda")


def _entry(kernel, shape, tiles, default_tiles, us=1.0, default_us=2.0):
    """A sweep entry in the schema both packages write."""
    return {"kernel": kernel, "shape": dict(shape), "key": autotune.shape_key(kernel, shape),
            "tiles": dict(tiles), "us": us, "default_tiles": dict(default_tiles),
            "default_us": default_us, "repeats": 1,
            "swept": [{"tiles": dict(default_tiles), "us": default_us},
                      {"tiles": dict(tiles), "us": us}]}


def test_resolve_tile_at_call_time_as_the_reference(monkeypatch):
    """The keyword wins, a non-positive keyword fails loudly, and without
    one the default stands: the reference's rule with its environment step
    left out (the port reads no environment variable)."""
    knob = "REPRO_PAIRWISE_TILE"
    monkeypatch.delenv(knob, raising=False)
    assert resolve_tile(128) == jresolve_tile(knob, 128) == 128
    assert resolve_tile(128, override=64) == jresolve_tile(knob, 128, override=64) == 64
    for pkg in (lambda: resolve_tile(128, override=0),
                lambda: jresolve_tile(knob, 128, override=0)):
        with pytest.raises(ValueError, match="positive integer"):
            pkg()


def test_ops_wrapper_resolves_the_cache_at_call_time(monkeypatch):
    """A winner recorded after `ops` was imported reaches the launcher (a
    meta tensor stands in for the card, the launcher is faked), an explicit
    keyword beats it, and no entry means the module constants."""
    calls = []

    def fake_launch(x, h, lo, hi, tgt, tile, ranges):
        calls.append((tile, ranges))
        return torch.zeros(5, lo.shape[0])

    monkeypatch.setattr(tabx, "aqp_box_moments", fake_launch)
    meta = {"device": "meta"}
    x, h = torch.zeros(300, 2, **meta), torch.ones(2, **meta)
    lo, tgt = torch.zeros(4, 2, **meta), torch.zeros(4, dtype=torch.int32, **meta)
    ops.aqp_box_moments(x, h, lo, lo, tgt)
    autotune.record("aqp_box_sums", {"n": 300, "d": 2, "G": 4}, {"tile": 512, "ranges": 96})
    ops.aqp_box_moments(x, h, lo, lo, tgt)
    ops.aqp_box_moments(x, h, lo, lo, tgt, ranges=8)
    ops.aqp_box_moments(x, h, lo, lo, tgt, tile=64, ranges=8)
    assert calls == [(tabx.TILE, tabx.RANGES), (512, 96), (512, 8), (64, 8)]


def test_profiled_launch_carries_the_resolved_tiles(monkeypatch):
    """With obs on, the kernel.wall_us labels carry the tiles the launch
    used, so `measured()` (and the CLI reading it) sees the tuned shape."""
    monkeypatch.setattr(tpr, "pairwise_scaled_ksum",
                        lambda x, g, kind, tile, blocks=None: x.sum())
    autotune.record("pairwise_scaled_ksum", {"n": 4096}, {"tile": 256})
    prev = tobs.set_tracer(tobs.Tracer())
    tobs.enable()
    try:
        ops.pairwise_scaled_ksum(torch.zeros(4000, device="meta"), torch.ones(1), "k6")
    finally:
        tobs.disable()
        tobs.set_tracer(prev)
    rows = [r for r in measured("pairwise_scaled_ksum") if r.get("n") == "4000"]
    assert rows and rows[0]["tile"] == "256" and rows[0]["count"] >= 1


KEYS_AS_THE_REFERENCE = [
    ("pairwise_scaled_ksum", {"n": 4000}),
    ("sv_matrix", {"n": 32_768, "d": 1}),
    ("gh_fused_sum", {"n": 500, "d": 3}),
    ("lscv_grid_sums", {"n": 1000, "G": 150}),
    ("kde_eval", {"n": 32_768, "G": 513}),
    ("qmc_box_reduce", {"n": 32_768, "d": 3, "G": 384, "m": 5000}),
    ("rff_density", {"n": 2048, "d": 1, "G": 32_768}),
]


@pytest.mark.parametrize("kernel,shape", KEYS_AS_THE_REFERENCE)
def test_shape_key_equals_the_reference(kernel, shape):
    assert autotune.shape_key(kernel, shape) == jtune.shape_key(kernel, shape)


@pytest.mark.parametrize("kernel,shape", [
    ("aqp_batch_sums", {"n": 4096, "G": 256}),
    ("aqp_box_sums", {"n": 32_768, "d": 3, "G": 384}),
    ("aqp_grouped_sums", {"n": 32_768, "d": 3, "G": 64})])
def test_range_kernels_key_leaves_the_batch_out(kernel, shape):
    """The reference's key without `G`; a lookup at q = 8 and at q = 1 024
    hits the one entry, and sizes still bucket (d exact)."""
    no_g = {k: v for k, v in shape.items() if k != "G"}
    assert autotune.shape_key(kernel, shape) == jtune.shape_key(kernel, no_g)
    autotune.record(kernel, shape, {"tile": 1024, "ranges": 32})
    reg = tobs.get_registry()
    hits = reg.sum_counter("autotune.cache.hits", kernel=kernel)
    for q in (8, 1024):
        assert autotune.lookup(kernel, {**shape, "G": q}) == {"tile": 1024, "ranges": 32}
    assert reg.sum_counter("autotune.cache.hits", kernel=kernel) == hits + 2
    bigger = {**shape, "n": shape["n"] * 2}
    assert autotune.lookup(kernel, bigger) is None
    if "d" in shape:
        assert autotune.lookup(kernel, {**shape, "d": shape["d"] + 1}) is None


def test_shape_key_buckets_sizes_not_d():
    k1 = autotune.shape_key("k", {"n": 500, "d": 3, "G": 17})
    k2 = autotune.shape_key("k", {"n": 512, "d": 3, "G": 32})
    k3 = autotune.shape_key("k", {"n": 512, "d": 4, "G": 32})
    assert k1 == k2 and k2 != k3


def test_cached_tiles_lose_to_explicit_keyword():
    shape = {"n": 128, "d": 2, "G": 8}
    autotune.record("qmc_box_reduce", shape, {"tile": 1024, "m_tile": 256})
    jtune.record("qmc_box_reduce", shape, {"tile": 1024, "m_tile": 256})
    got = autotune.resolve("qmc_box_reduce", shape, tile=(32, 512), m_tile=(None, 512))
    want = jtune.resolve("qmc_box_reduce", shape, tile=(32, "REPRO_QMC_TILE", 256),
                         m_tile=(None, "REPRO_QMC_M_TILE", 256))
    assert got == want == (32, 256)                 # keyword wins, the cache fills the rest
    assert autotune.resolve("qmc_box_reduce", {**shape, "n": 4096},
                            tile=(None, 512), m_tile=(None, 512)) == (512, 512)


def test_untuned_lookup_counts_nothing():
    """No entry: the wrappers' lookup is one check and records no counter."""
    reg = tobs.get_registry()
    before = reg.sum_counter("autotune.cache.misses")
    assert autotune.lookup("aqp_batch_sums", {"n": 64, "G": 8}) is None
    assert reg.sum_counter("autotune.cache.misses") == before


def test_load_cache_refuses_an_unknown_version(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"version": 99, "entries": []}))
    for tune in (autotune, jtune):
        with pytest.raises(ValueError, match="unsupported tile-cache version"):
            tune.load_cache(str(p))


def test_reference_cache_loads_in_the_port(tmp_path):
    """A file the reference's sweep, `record` and `save_cache` wrote loads in
    the port, under the port's keys (the range kernel's entry without G)."""
    path = tmp_path / "ref_tiles.json"
    ref = jtune.sweep("aqp_grouped_sums", {"n": 256, "d": 2, "G": 16}, repeats=1,
                      quick=True, persist=False)
    shape = {"n": 4000}
    jtune.record("pairwise_scaled_ksum", shape, {"tile": 256},
                 entry=_entry("pairwise_scaled_ksum", shape, {"tile": 256}, {"tile": 512}))
    jtune.save_cache(str(path))
    assert autotune.load_cache(str(path)) == 2
    assert autotune.lookup("pairwise_scaled_ksum", {"n": 4096}) == {"tile": 256}
    assert autotune.lookup("aqp_grouped_sums", {"n": 256, "d": 2, "G": 64}) == ref["tiles"]
    assert autotune.resolve("pairwise_scaled_ksum", {"n": 4096},
                            tile=(None, tpr.TILE)) == (256,)


def test_port_cache_loads_in_the_reference_and_passes_validate_metrics(tmp_path):
    """The port's file: the reference loads it, and the stdlib-only
    `scripts/validate_metrics.py --tuning` passes it unchanged."""
    path = tmp_path / "tiles.json"
    autotune.use_cache(str(path))
    shape = {"n": 32_768, "d": 3, "G": 8}
    autotune.record("aqp_box_sums", shape, {"tile": 4096, "ranges": 256},
                    entry=_entry("aqp_box_sums", shape, {"tile": 4096, "ranges": 256},
                                 {"tile": 4096, "ranges": 64}))
    pshape = {"n": 4096}
    autotune.record("pairwise_scaled_ksum", pshape, {"tile": 256},
                    entry=_entry("pairwise_scaled_ksum", pshape, {"tile": 256}, {"tile": 512}))
    doc = autotune.save_cache(str(path))
    assert doc["version"] == 1 and len(doc["entries"]) == 2
    assert jtune.load_cache(str(path)) == 2
    assert jtune.lookup("pairwise_scaled_ksum", {"n": 4000}) == {"tile": 256}
    assert jtune.lookup("aqp_box_sums", shape) == {"tile": 4096, "ranges": 256}
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "validate_metrics.py"),
                          "--tuning", str(path)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr


def test_fresh_process_loads_the_cache_with_no_sweep(tmp_path):
    """The acceptance path: a cache written here, then a new interpreter
    that calls `use_cache` resolves the tuned tiles on its first lookup,
    with zero sweeps and one cache hit."""
    path = tmp_path / "tiles.json"
    autotune.use_cache(str(path))
    shape = {"n": 4096, "G": 256}
    autotune.record("aqp_batch_sums", shape, {"tile": 4096, "ranges": 32},
                    entry=_entry("aqp_batch_sums", shape, {"tile": 4096, "ranges": 32},
                                 {"tile": 4096, "ranges": 160}))
    autotune.save_cache(str(path))
    code = (
        "import json, sys\n"
        "from repro_torch import obs\n"
        "from repro_torch.kernels import aqp_batch, autotune\n"
        f"autotune.use_cache({str(path)!r})\n"
        "got = autotune.resolve('aqp_batch_sums', {'n': 4000, 'G': 8},\n"
        "                       tile=(None, aqp_batch.TILE), ranges=(None, aqp_batch.RANGES))\n"
        "reg = obs.get_registry()\n"
        "print(json.dumps({'tiles': got, 'sweeps': reg.sum_counter('autotune.sweeps'),\n"
        "                  'hits': reg.sum_counter('autotune.cache.hits')}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == {"tiles": [4096, 32], "sweeps": 0,
                                                       "hits": 1}


def test_candidates_start_with_the_constants_and_drop_duplicate_cuts():
    """Candidate 0 is the module constants; candidates that launch the same
    cut (or tile side) as an earlier one are dropped; quick keeps each
    pool's extremes and the constant."""
    spec = autotune.SWEEPS["aqp_batch_sums"]
    shape = {"n": 4096, "G": 256}
    full = autotune._candidates(spec, shape, quick=False)
    assert full[0] == {"tile": 4096, "ranges": 160}
    cuts = [autotune._eff_cut(32)(shape, c) for c in full]
    assert len(set(cuts)) == len(cuts)
    assert {c["ranges"] for c in autotune._candidates(spec, shape, quick=True)} <= {16, 160, 320}
    pw = autotune._candidates(autotune.SWEEPS["pairwise_scaled_ksum"], {"n": 200}, False)
    assert pw == [{"tile": 512}, {"tile": 128}]     # 256 and up launch one 256-wide tile
    rff = autotune._candidates(autotune.SWEEPS["rff_density"], {"n": 2048, "d": 1, "G": 64},
                               False)
    assert rff[0] == {"tile": 256, "threads": 256} and len(rff) == 9


def test_sweep_refuses_an_unknown_kernel_and_needs_the_card():
    with pytest.raises(KeyError, match="no sweep registered"):
        autotune.sweep("nope", {"n": 8})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            autotune.sweep("pairwise_scaled_ksum", {"n": 256})


def test_cuda_sweep_on_the_card(cuda_device, tmp_path):
    """On the card: the winner is never slower than the constants on the
    swept timings, it is recorded and persisted, and the file passes
    `validate_metrics.py --tuning`."""
    path = tmp_path / "tiles.json"
    autotune.use_cache(str(path))
    entry = autotune.sweep("pairwise_scaled_ksum", {"n": 4096}, repeats=2, quick=True)
    assert entry["us"] <= entry["default_us"] and entry["swept"][0]["tiles"] == {"tile": 512}
    assert autotune.lookup("pairwise_scaled_ksum", {"n": 4096}) == entry["tiles"]
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "validate_metrics.py"),
                          "--tuning", str(path)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cli_shapes_from_specs_and_snapshots(tmp_path, capsys):
    """`--shape` parsing, and a metrics snapshot's kernel.wall_us rows turned
    into sweep shapes: the range kernel's rows at two batch sizes are one
    sweep, rows of kernels without a sweep are skipped; with nothing to
    sweep the CLI exits 2."""
    assert cli.parse_shape("aqp_box_sums:n=32768,d=3,G=8") == (
        "aqp_box_sums", {"n": 32_768, "d": 3, "G": 8})
    with pytest.raises(ValueError, match="unknown axis"):
        cli.parse_shape("aqp_box_sums:n=8,q=3")
    snap = {"histograms": {"kernel.wall_us": [
        {"labels": {"kernel": "aqp_batch_sums", "n": "32768", "G": "8", "tile": "4096"}},
        {"labels": {"kernel": "aqp_batch_sums", "n": "32768", "G": "256", "tile": "4096"}},
        {"labels": {"kernel": "pairwise_scaled_ksum", "n": "4096", "kind": "k6"}},
        {"labels": {"kernel": "kde_eval", "n": "32768", "G": "513"}}]}}
    path = tmp_path / "m.json"
    path.write_text(json.dumps(snap))
    assert cli.shapes_from_snapshot(str(path), autotune.SWEEPS) == [
        ("aqp_batch_sums", {"n": 32_768, "G": 8}), ("pairwise_scaled_ksum", {"n": 4096})]
    path.write_text(json.dumps({"histograms": {"kernel.wall_us": snap["histograms"][
        "kernel.wall_us"][3:]}}))
    assert cli.main(["--metrics", str(path)]) == 2
    assert "nothing to sweep" in capsys.readouterr().err


def test_sweep_instruments_are_the_reference_names():
    """The port's instruments carry the reference's names (the catalogue in
    docs/observability.md); `record` sets the entries gauge in both."""
    for tune, obs_mod in ((autotune, tobs), (jtune, jobs)):
        tune.record("kde_eval", {"n": 64, "G": 8}, {"tile": 256})
        gauges = obs_mod.get_registry().collect_gauges("autotune.cache.entries")
        assert gauges and gauges[0][1] == 1
    src = (ROOT / "src" / "repro_torch" / "kernels" / "autotune.py").read_text()
    for name in ("autotune.sweeps", "autotune.sweep_us", "autotune.cache.hits",
                 "autotune.cache.misses", "autotune.cache.entries"):
        assert f'"{name}"' in src


def test_port_sweep_inputs_are_seeded():
    rng1, _ = autotune._inputs()
    rng2, _ = autotune._inputs()
    assert np.array_equal(rng1.normal(size=4), rng2.normal(size=4))
