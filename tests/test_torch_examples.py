"""The port's five examples (`examples/torch_*.py`) run end to end on the
CPU at small sizes, each in a process of its own with a timeout: the
quickstart's three selectors, the database scenario's sections, the
distributed example over 2 gloo ranks, the LM serving scenario's three
models and the LM training scenario's tiny model.  Without a CUDA device
and without `--device`, an example exits non-zero.  On a card the first
three run at full size in chip_smoke.py's phase I; phases L and R drive the
LM serving and training paths themselves.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300

RUNS = {
    "torch_quickstart.py": (["--rows", "20000", "--sample", "384"],
                            ["selector = silverman", "selector = plugin", "selector = lscv_h"]),
    "torch_aqp_database.py": (["--rows", "20000", "--sample", "256", "--box-sample", "96",
                               "--queries", "100", "--capacity", "512"],
                              ["== 1-D aggregates", "== 2-D box count", "mixed queries in",
                               "region=2: COUNT", "flushes", "merged fraction(120..250)"]),
    "torch_distributed_bandwidth.py": (["--world", "2", "--n", "1500", "--n2", "300",
                                        "--d", "3", "--n-h", "20"],
                                       ["2 ranks over gloo on cpu", "pairwise K4 sum",
                                        "PLUGIN Psi6 / Psi4 sums", "distributed LSCV_h"]),
    "torch_serve_lm.py": (["--batch", "2", "--prompt-len", "6", "--max-new", "4"],
                          ["[llama3.2-1b       ] generated 2x10 tokens",
                           "[falcon-mamba-7b   ] generated 2x10 tokens",
                           "[whisper-base      ] generated 2x10 tokens"]),
    "torch_train_lm.py": (["--tiny", "--steps", "4", "--batch", "2", "--seq", "32"],
                          ["[example] demo-tiny: 0.8M params on cpu", "step    0  loss",
                           "step    3  loss", "over 4 recorded steps; checkpoints at [4]",
                           "[example] done"]),
}


def _run(name, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(ROOT / "examples" / name), *args], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name):
    args, expect = RUNS[name]
    out = _run(name, ["--device", "cpu", *args])
    assert out.returncode == 0, out.stderr[-3000:]
    for line in expect:
        assert line in out.stdout, (line, out.stdout[-3000:])


def test_distributed_example_sharded_sums_match_one_device():
    args, _ = RUNS["torch_distributed_bandwidth.py"]
    out = _run("torch_distributed_bandwidth.py", ["--device", "cpu", *args])
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    k4 = next(s for s in lines if s.startswith("pairwise K4 sum"))
    assert float(k4.rsplit("rel_err=", 1)[1]) < 1e-4
    lscv = next(s for s in lines if s.startswith("distributed LSCV_h"))
    h = lscv.split("h=", 1)[1].split(" ", 1)[0]
    assert lscv.endswith(f"(single-path h={h})")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_without_a_card_or_device_exits_nonzero(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(name, RUNS[name][0])
    assert out.returncode != 0 and "no CUDA device" in out.stderr
