"""The cell `joint8.lscv_H.kernel` on the CPU: shrunk as the control's
tests shrink a cell, it comes out correct through the program's plain
path and not correct under the control; the configuration's draws a row
are the program's; and a configuration that names the kernel-centred
integrator is only ever run under traffic that asks the program for it."""
from __future__ import annotations

import json

from bench import harness
from bench.tests.test_bench_control import run, small

from .test_bench_harness import BENCH, CELLS, ROOT

CELL = "joint8.lscv_H.kernel"


def test_joint8_cell_is_correct_on_the_plain_path():
    cell = small(CELL)
    assert len(cell.config["joints"][0]) == 8
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {"reservoir_mismatch", "H_shortfall", "answer_err", "ci_err"}


def test_joint8_control_is_not_correct():
    res = run(small(CELL), control=True)
    assert not res["correct"]
    assert [k for k, c in res["checks"].items() if c["value"] > c["limit"]], res["checks"]


def test_configuration_draws_are_the_programs():
    from repro_torch.core.aqp_query import KERNEL_DRAWS
    cell = harness.load_cell(CELL)
    assert cell.config["box_estimator"] == "kernel_qmc"
    assert int(cell.config["box_draws"]) == KERNEL_DRAWS


def test_kernel_qmc_configurations_run_under_kernel_traffic():
    files = {c["name"]: c["file"] for c in BENCH["configs"]}
    named = 0
    for w in BENCH["workloads"]:
        cfg = json.loads((ROOT / files[w["config"]]).read_text())
        traffic = json.loads((ROOT / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
        if cfg.get("box_estimator", "hull_qmc") == "kernel_qmc":
            named += 1
            assert traffic.get("kde_backend") == "kernel", w["name"]
    assert named >= 1 and CELL in CELLS
