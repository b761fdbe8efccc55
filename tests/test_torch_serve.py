"""The port's serving entry point (`python -m repro_torch.launch.serve --mode
aqp`) on the CPU: its query mixes give the reference's specs field for
field for the same seed; a small run with `--device cpu` and a quiet
producer exits 0 and prints the same sample answers on two runs; without
`--device` on a machine with no card it exits non-zero; `--snapshot-dir`
then `--restore` warm-starts a second process from the first one's snapshot.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--mode", "aqp", "--rows", "20000", "--capacity", "1024", "--clients", "4",
         "--per-client", "16", "--stream-every-ms", "100000"]
RANGES = {"loss": (0.1, 9.0), "latency_ms": (5.0, 300.0), "seq_len": (16.0, 2047.0)}


def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if not f.name.startswith("_"))
    if isinstance(obj, (tuple, list)):
        return tuple(_fields(v) for v in obj)
    return obj


@pytest.mark.parametrize("seed", [0, 7])
def test_query_mixes_give_the_reference_specs(seed):
    assert _fields(tserve.make_query_mix(40, RANGES, seed=seed)) == \
        _fields(jserve.make_query_mix(40, RANGES, seed=seed))
    cols = ("loss", "latency_ms")
    assert _fields(tserve.make_box_query_mix(30, cols, RANGES, seed=seed)) == \
        _fields(jserve.make_box_query_mix(30, cols, RANGES, seed=seed))
    for frac in (0.0, 0.5):
        got = tserve.make_mixed_aqp_queries(64, dict(RANGES, model_id=(0.0, 3.0)), cols,
                                            "model_id", (0.0, 1.0, 2.0, 3.0), seed=seed,
                                            fullh_frac=frac)
        want = jserve.make_mixed_aqp_queries(64, dict(RANGES, model_id=(0.0, 3.0)), cols,
                                             "model_id", (0.0, 1.0, 2.0, 3.0), seed=seed,
                                             fullh_frac=frac)
        assert _fields(got) == _fields(want)
        assert {type(t).__name__ for q in got for t in q.predicates} == {"Range", "Box", "Eq"}


def test_telemetry_matches_the_reference():
    import numpy as np
    got = tserve._make_telemetry(np.random.default_rng(3), 500)
    want = jserve._make_telemetry(np.random.default_rng(3), 500)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def _serve(*extra, timeout=120):
    # one intra-op thread: test files run in parallel worker processes
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *SMALL, *extra],
                          cwd=str(ROOT), env=env, capture_output=True, text=True,
                          timeout=timeout)


def _answers(stdout):
    """The printed sample answers and the GROUP BY line."""
    return [ln for ln in stdout.splitlines()
            if ln.startswith("  ") or "GROUP BY" in ln]


def test_serve_on_the_cpu_exits_zero_and_repeats_its_answers():
    runs = [_serve("--device", "cpu") for _ in range(2)]
    for out in runs:
        assert out.returncode == 0, out.stdout + out.stderr
        assert "queries/s [torch]" in out.stdout
        assert "[serve:aqp] admission:" in out.stdout
        assert "version invalidations" in out.stdout
    first = _answers(runs[0].stdout)
    assert len(first) == 7 and first == _answers(runs[1].stdout)


def test_serve_without_a_card_and_without_device_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: serve runs on it by default")
    out = _serve()
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_serve_snapshot_flags_wait_for_queue_1_12(tmp_path):
    """Queue 1.12 is done, so the snapshot flags answer; what is left to
    refuse is their misuse: --restore without --snapshot-dir, or with no
    completed snapshot under it, exits non-zero naming the cause."""
    out = _serve("--device", "cpu", "--restore")
    assert out.returncode != 0 and "--restore needs --snapshot-dir" in out.stderr
    out = _serve("--device", "cpu", "--snapshot-dir", str(tmp_path / "none"), "--restore")
    assert out.returncode != 0 and "no completed snapshots" in out.stderr


def test_serve_snapshots_then_warm_restarts(tmp_path):
    """--snapshot-dir writes the start-up snapshot; a second process with
    --restore warm-starts from it with no refit (zero synopsis-cache misses)
    and, with the producer quiet, prints the same answers; it also loads a
    tile cache given by --tuning-cache."""
    from repro_torch.kernels import autotune

    snap = tmp_path / "snap"
    first = _serve("--device", "cpu", "--snapshot-dir", str(snap))
    assert first.returncode == 0, first.stdout + first.stderr
    assert f"1 snapshots written to {snap}" in first.stdout
    assert sorted(p.name for p in snap.iterdir()) == ["step_00000001"]
    tiles = tmp_path / "tiles.json"
    autotune.reset()
    try:
        autotune.save_cache(str(tiles))
    finally:
        autotune.reset()
    again = _serve("--device", "cpu", "--snapshot-dir", str(snap), "--restore",
                   "--tuning-cache", str(tiles))
    assert again.returncode == 0, again.stdout + again.stderr
    assert "durability: warm-started from snapshot step 1" in again.stdout
    cache_line = next(ln for ln in again.stdout.splitlines() if "synopsis cache:" in ln)
    assert " / 0 misses" in cache_line
    assert _answers(again.stdout) == _answers(first.stdout)


def test_serve_offers_no_lm_mode(monkeypatch):
    """The port's serve now offers `--mode lm` (ROADMAP queue 1.15a), but not
    as its default: with no `--mode` it runs the AQP loop, where the
    reference's serve defaults to LM mode.  An unknown mode exits."""
    called = []
    monkeypatch.setattr(tserve, "run_aqp", lambda args: called.append(("aqp", args.mode)))
    monkeypatch.setattr(tserve, "run_lm", lambda args: called.append(("lm", args.arch)))
    tserve.main(["--device", "cpu"])
    tserve.main(["--mode", "lm", "--device", "cpu", "--smoke"])
    assert called == [("aqp", "aqp"), ("lm", "llama3.2-1b")]
    with pytest.raises(SystemExit):
        tserve.main(["--mode", "train", "--device", "cpu"])
