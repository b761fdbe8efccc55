"""`CheckpointManager` saving from several ranks into one directory: 4 gloo
ranks (4 processes, a file store; `tests/torch_mesh_worker.py` mode
"ckpt") save a sharded state on a 2 x 2 mesh at steps 1 .. 24, with and
without `async_save` (keep 3).  Every rank finishes without an error, only
rank 0 writes (every step, once), exactly the last 3 steps remain, every
rank sees them, and the last step restored onto a 4 x 1 mesh gives the
saved whole tensors bit for bit on every rank.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD, STEPS = 4, 24


def test_ranks_save_into_one_directory(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"w": rng.normal(0, 1, (4, 6)).astype(np.float32),
              "b": rng.normal(0, 1, (6,)).astype(np.float32),
              "e": rng.normal(0, 1, (3, 8)).astype(np.float32)}
    inp = tmp_path / "in.npz"
    np.savez(inp, meta=np.asarray(json.dumps({"steps": STEPS})), **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
                               "ckpt", str(tmp_path / "store"), str(r), str(WORLD), str(inp),
                               str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs
    results = [json.loads((tmp_path / f"ckpt_{r}.json").read_text()) for r in range(WORLD)]
    for mode in ("async0", "async1"):
        assert results[0][mode]["writes"] == list(range(1, STEPS + 1))
        for rank, res in enumerate(results):
            got = res[mode]
            assert rank == 0 or got["writes"] == []
            assert got["steps"] == [STEPS - 2, STEPS - 1, STEPS]
            assert got["same"] and got["extra"] == {"step": STEPS}
        names = sorted(os.listdir(tmp_path / f"ckpt_{mode}"))
        assert names == [f"step_{s:08d}" for s in (STEPS - 2, STEPS - 1, STEPS)]
