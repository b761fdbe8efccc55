"""The check that decides `correct`, shown to fail: each cell driven on the
CPU at a small size through the program's plain path, once sound, once with
the control (the reference in TF32 in the program's place), and once with
each fault the cell can have planted in the timed path.  The run skips only
the look for a card (`bench/run.py`); everything after it is the
benchmark's own."""
from __future__ import annotations

import dataclasses

import pytest

from bench import harness

SEED = 2 ** 31 + 2024
CELLS = ("kde1d.lscv_h.all-cols", "joint3.lscv_H")


def small(name: str):
    cell = harness.load_cell(name)
    cell.config.update(capacity=256 if cell.traffic["selector"] == "lscv_h" else 128,
                       stream_rows=8000)
    cell.traffic.update(ingest_rows=1000, pool_batches=3, probe_rows=4000)
    for ent in cell.traffic["dashboard"]:
        if ent["kind"] == "range":
            ent["per_column"] = 12
        elif ent["kind"] == "box":
            ent["count"] = 12
    return cell


def run(cell, control=False):
    return harness.run_cell(cell, SEED, 0.05, trace=False, device="cpu", control=control)


def _after_setup(cell):
    """add_batch calls before the window: the set-up batches and the warm
    refresh's."""
    rows, size = int(cell.config["stream_rows"]), int(cell.traffic["ingest_rows"])
    return -(-rows // size) + 1


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(small(name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = run(small(name), control=True)
    assert not res["correct"]
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert over, res["checks"]


def _ingest_fault(monkeypatch, cell, fault):
    from repro_torch.data.aqp_store import TelemetryStore
    original = TelemetryStore.add_batch
    calls = {"n": 0}
    skip = _after_setup(cell)

    def add_batch(self, stats):
        calls["n"] += 1
        if calls["n"] <= skip:
            return original(self, stats)
        if fault == "unchanged":
            return None
        half = {c: v[: len(v) // 2] for c, v in stats.items()}
        return original(self, half)

    monkeypatch.setattr(TelemetryStore, "add_batch", add_batch)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_ingest_faults_are_not_correct(monkeypatch, name, fault):
    cell = small(name)
    _ingest_fault(monkeypatch, cell, fault)
    res = run(cell)
    assert not res["correct"]
    assert res["checks"]["reservoir_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_not_correct(monkeypatch, name):
    from repro_torch.core.aqp_query import QueryEngine
    original = QueryEngine.execute

    def execute(self, queries, **kw):
        out = original(self, queries, **kw)
        r = out[0]
        out[0] = dataclasses.replace(r, estimate=r.estimate + (r.ci_hi - r.ci_lo))
        return out

    monkeypatch.setattr(QueryEngine, "execute", execute)
    res = run(small(name))
    assert not res["correct"]
    assert res["checks"]["answer_err"]["value"] > res["checks"]["answer_err"]["limit"]


def test_half_the_sample_with_the_mean_over_the_rest_is_not_correct(monkeypatch):
    """A range pass that sums half the sample and doubles it."""
    from repro_torch.kernels import ref
    original = ref.aqp_batch_sums

    def half(x, h, a, b):
        cnt, tot = original(x[: x.shape[0] // 2], h, a, b)
        return 2.0 * cnt, 2.0 * tot

    monkeypatch.setattr(ref, "aqp_batch_sums", half)
    res = run(small("kde1d.lscv_h.all-cols"))
    assert not res["correct"]
    assert res["checks"]["answer_err"]["value"] > res["checks"]["answer_err"]["limit"]


def test_a_traced_run_reads_spans_apart_from_its_untraced_part(monkeypatch):
    """The traced window's parts: host times from refreshes with nothing
    switched on, `plan_ms` from the part with the program's spans on; the
    check covers every refresh of all parts."""
    from repro_torch import obs
    cell = small("kde1d.lscv_h.all-cols")
    seen = []
    original = harness.Refresh

    def refresh(*args):
        seen.append(obs.enabled())
        return original(*args)

    monkeypatch.setattr(harness, "Refresh", refresh)
    res = harness.run_cell(cell, SEED, 0.4, trace=True, device="cpu")
    assert res["correct"], res["checks"]
    assert {"plan_ms", "ingest_ms", "execute_ms"} <= set(res["metrics"])
    assert "device_idle_pct" not in res["metrics"]
    # untraced refreshes first, then the spans' part, then the last part
    assert seen[0] is False and True in seen and seen[-1] is False
    assert seen.index(True) > 0 and not obs.enabled()
    assert set(res["not_compared"]) == {"answer_err.own_bw", "ci_err.own_bw",
                                        "stream_err.median", "stream_err.max"}
