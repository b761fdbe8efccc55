"""The port's SPMD microbatch pipeline (`repro_torch.launch.pipeline`)
against sequential application and against the reference's
`spmd_pipeline`, on the reference's own case (tests/test_pipeline.py):
4 stages of tanh(x @ W + b), 8 microbatches of 2 rows, d 16.  The 4 stages
are 4 gloo ranks, each a process (`tests/torch_mesh_worker.py`); the
reference runs on 4 placeholder devices in a process of its own.
Tolerances: sequential rtol = atol = 1e-6; the reference's pipeline at its
own 1e-5.  A one-stage pipeline runs in this process on one gloo rank.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.distributed import init_group
from repro_torch.launch.pipeline import spmd_pipeline
from test_torch_train_sharded import run_ranks

ROOT = Path(__file__).resolve().parents[1]
N_STAGES, N_MICRO, MB, D = 4, 8, 2, 16

REF_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.launch.pipeline import spmd_pipeline
with np.load(sys.argv[1]) as z:
    W, b, xs = z["W"], z["b"], z["xs"]
mesh = jax.make_mesh((4,), ("pipe",))
with jax.set_mesh(mesh):     # this jax wants the mesh set around the shard_map
    out = spmd_pipeline(lambda p, x: jnp.tanh(x @ p[0] + p[1]),
                        (jnp.asarray(W), jnp.asarray(b)), jnp.asarray(xs), mesh, "pipe")
np.save(sys.argv[2], np.asarray(out))
"""


def _case():
    rng = np.random.default_rng(0)
    W = rng.normal(0, 0.5, (N_STAGES, D, D)).astype(np.float32)
    b = rng.normal(0, 0.1, (N_STAGES, D)).astype(np.float32)
    xs = rng.normal(0, 1, (N_MICRO, MB, D)).astype(np.float32)
    return W, b, xs


def _sequential(W, b, xs, stages):
    ref = torch.from_numpy(xs)
    for s in range(stages):
        ref = torch.tanh(ref @ torch.from_numpy(W[s]) + torch.from_numpy(b[s]))
    return ref.numpy()


@pytest.fixture(scope="module")
def pipelined(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    W, b, xs = _case()
    run_ranks("pipeline", N_STAGES, {"W": W, "b": b, "xs": xs}, {}, tmp)
    np.savez(tmp / "case.npz", W=W, b=b, xs=xs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_CODE, str(tmp / "case.npz"),
                        str(tmp / "ref.npy")], capture_output=True, text=True, timeout=240,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    outs = [np.load(tmp / f"pipeline_{r}.npy") for r in range(N_STAGES)]
    return (W, b, xs), outs, np.load(tmp / "ref.npy")


def test_pipeline_matches_sequential(pipelined):
    (W, b, xs), outs, _ = pipelined
    want = _sequential(W, b, xs, N_STAGES)
    for out in outs:                                   # replicated on every stage
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)


def test_pipeline_matches_reference(pipelined):
    _, outs, ref = pipelined
    for out in outs:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_one_stage_pipeline_in_process(tmp_path):
    W, b, xs = _case()
    init_group(str(tmp_path / "store"), 0, 1, device="cpu", timeout_s=60)
    try:
        out = spmd_pipeline(lambda p, x: torch.tanh(x @ p[0] + p[1]),
                            (torch.from_numpy(W[:1]), torch.from_numpy(b[:1])),
                            torch.from_numpy(xs))
    finally:
        dist.destroy_process_group()
    want = torch.stack([torch.tanh(x @ torch.from_numpy(W[0]) + torch.from_numpy(b[0]))
                        for x in torch.from_numpy(xs)])
    assert torch.equal(out, want)                      # the same ops in the same order
    np.testing.assert_allclose(out.numpy(), _sequential(W, b, xs, 1), rtol=1e-6, atol=1e-6)
