"""The port's sharded train step and elastic restore on 4 gloo ranks (4
processes, a file store; `tests/torch_mesh_worker.py`): float32 copies of
llama3.2-1b's and granite-moe-1b-a400m's smoke configs on a 2 x 2 (data,
model) mesh, and of qwen3-moe-235b-a22b's (4 q heads, 2 kv heads on model
4: attention by q heads, the MoE's count exchange) and falcon-mamba-7b's
(the in_proj halves projected from each device's columns) on a 1 x 4
mesh, parameters as DTensors under the train specs, one train step with
and without `param_constraint` (the serve specs, the reference's
gather-once), held against the reference's jitted `make_train_step` on the
same parameters and batch on the CPU.

Tolerance: loss and grad norm rtol 1e-5; each parameter within 1e-5 x its
leaf's max |value| of the reference's (the default AdamWConfig, whose
first step moves a parameter by at most about 3e-6).  Checkpoints: the
state saved from the 2 x 2 mesh and restored with `shardings` onto a 4 x 1
mesh gives the same whole tensors bit for bit on every rank.  Only rank 0
writes a checkpoint, so each architecture restores rank 0's directory.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.train import make_train_step as ref_make_train_step
from repro_torch import convert

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama3.2-1b", "granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "falcon-mamba-7b")
MESHES = {"qwen3-moe-235b-a22b": (1, 4), "falcon-mamba-7b": (1, 4)}     # else 2 x 2
B, S, N_MICRO, WORLD = 8, 16, 2, 4


def run_ranks(mode: str, world: int, arrays: dict, meta: dict, tmp: Path) -> None:
    """`world` gloo ranks of tests/torch_mesh_worker.py, each a process."""
    inp = tmp / "in.npz"
    np.savez(inp, meta=np.asarray(json.dumps(meta)), **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
                               mode, str(tmp / "store"), str(r), str(world), str(inp), str(tmp)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs


def _reference(arch: str):
    cfg = dataclasses.replace(ref_get_config(arch, smoke=True), param_dtype="float32")
    model = ref_build_model(cfg)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    step = jax.jit(ref_make_train_step(model, ref_adamw.AdamWConfig(), N_MICRO))
    new, _, met = step(params, ref_adamw.init(params), batch)
    flat = convert.lm_state_from_numpy(jax.tree.map(np.asarray, params))
    after = convert.lm_state_from_numpy(jax.tree.map(np.asarray, new))
    return flat, batch, float(met["loss"]), float(met["grad_norm"]), after


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    arrays, refs = {}, {}
    for arch in ARCHS:
        flat, batch, loss, gnorm, after = _reference(arch)
        arrays.update({f"{arch}/{k}": np.asarray(v, np.float32) for k, v in flat.items()})
        arrays.update({f"{arch}/batch.{k}": v for k, v in batch.items()})
        refs[arch] = (loss, gnorm, after)
    run_ranks("train", WORLD, arrays, {"archs": list(ARCHS), "n_micro": N_MICRO,
                                       "meshes": MESHES}, tmp)
    results = [json.loads((tmp / f"result_{r}.json").read_text()) for r in range(WORLD)]
    return tmp, refs, results


@pytest.mark.parametrize("mode", ["plain", "constrained"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_reference(sharded, arch, mode):
    tmp, refs, results = sharded
    loss, gnorm, after = refs[arch]
    for res in results:                              # every rank reads the same metrics
        got = res[f"{arch}/{mode}"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], gnorm, rtol=1e-5)
    with np.load(tmp / f"{arch}__{mode}.npz") as z:
        assert sorted(z.files) == sorted(after)
        for k in z.files:
            want = np.asarray(after[k], np.float32)
            scale = float(np.abs(want).max()) or 1.0
            np.testing.assert_allclose(z[k], want, rtol=0, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_placements_kept(sharded, arch):
    """The updated parameters keep the train specs' placements, with and
    without the constraint (the gradients come back to them)."""
    _, _, results = sharded
    res = results[0]
    assert res[f"{arch}/plain"]["placements"] == res[f"{arch}/constrained"]["placements"]
    assert any("Shard" in p for p in res[f"{arch}/plain"]["placements"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_restore_onto_another_mesh(sharded, arch):
    _, _, results = sharded
    for res in results:
        got = res[f"{arch}/restore"]
        assert got["same"], got
        assert got["count"] == 1
