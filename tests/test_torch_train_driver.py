"""The port's training driver and what it stands on, against the JAX
package: the token pipeline (`repro_torch/data/pipeline.py`), the elastic
and straggler logic (`repro_torch/checkpoint/elastic.py`), pytree
checkpoints in the reference's layout (`repro_torch/checkpoint/
checkpoint.py`, `train.train_step.state_tree`) read by either package, and
`python -m repro_torch.launch.train` crashing and resuming on the CPU.

The pipeline's draws are the port's own (numpy Philox keyed by seed, step
and host), not `jax.random`'s; its token law is the reference's, checked on
the same uniforms.  Cross-package checkpoints are held at the train-step
tolerances of `tests/test_torch_train_step.py` (float32), and a restored
leaf carries the writer's bits.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import elastic as jelastic
from repro.configs.base import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.train import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, elastic
from repro_torch.configs.base import get_config
from repro_torch.data.aqp_store import TelemetryStore
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.optim import adamw
from repro_torch.train import make_train_step, train_params
from repro_torch.train.train_step import load_state_tree, state_tree

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
CLI = ["--smoke", "--steps", "12", "--batch", "4", "--seq", "32", "--ckpt-every", "4",
       "--log-every", "1"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size tensors run on one intra-op thread: under the parallel
    test run several workers' thread pools would otherwise oversubscribe
    the cores (a 2.5 s test took 47 s beside one other worker)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- the token pipeline -----------------------------------------------------------------

def _batches(pipe, n):
    return [pipe.next() for _ in range(n)]


def test_pipeline_is_deterministic_and_resumes():
    a = _batches(TokenPipeline(1000, 8, 16, seed=3, device="cpu"), 5)
    b = _batches(TokenPipeline(1000, 8, 16, seed=3, device="cpu"), 5)
    assert all(torch.equal(x["tokens"], y["tokens"]) for x, y in zip(a, b))
    other = TokenPipeline(1000, 8, 16, seed=4, device="cpu").next()
    assert not torch.equal(other["tokens"], a[0]["tokens"])
    pipe = TokenPipeline(1000, 8, 16, seed=3, device="cpu")
    _batches(pipe, 3)
    state = pipe.state()
    assert state == {"step": 3, "seed": 3}
    resumed = TokenPipeline(1000, 8, 16, seed=3, device="cpu")
    resumed.restore(state)
    for want in a[3:]:
        got = next(resumed)
        assert torch.equal(got["tokens"], want["tokens"])
        assert torch.equal(got["labels"], want["labels"])
    with pytest.raises(ValueError, match="seed"):
        TokenPipeline(1000, 8, 16, seed=5, device="cpu").restore(state)


def test_pipeline_host_slices_are_disjoint_draws():
    hosts = [TokenPipeline(5000, 8, 32, seed=0, host_id=h, n_hosts=4, device="cpu")
             for h in range(4)]
    got = [p.next()["tokens"] for p in hosts]
    assert all(t.shape == (2, 32) for t in got)
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(got[i], got[j])
    with pytest.raises(ValueError, match="hosts"):
        TokenPipeline(5000, 6, 32, n_hosts=4, device="cpu")


def test_pipeline_keeps_the_references_token_law():
    """Tokens are min(int(vocab u^2.5), vocab - 1) on float32 uniforms, the
    reference's expression evaluated by jnp on the same u; labels rolled by
    -1; int64 on the pipeline's device."""
    vocab, pipe = 128256, TokenPipeline(128256, 4, 64, seed=9, host_id=1, n_hosts=2,
                                        device="cpu")
    rng = np.random.Generator(np.random.Philox(np.random.SeedSequence([9, 0, 1])))
    u = jnp.asarray(rng.random((2, 64), dtype=np.float32))
    want = np.asarray(jnp.minimum((vocab * u ** 2.5).astype(jnp.int32), vocab - 1))
    batch = pipe.next()
    assert batch["tokens"].dtype == torch.long and batch["tokens"].device.type == "cpu"
    np.testing.assert_array_equal(batch["tokens"].numpy(), want)
    np.testing.assert_array_equal(batch["labels"].numpy(), np.roll(want, -1, axis=1))
    many = TokenPipeline(vocab, 64, 256, device="cpu").next()["tokens"].numpy()
    assert many.min() >= 0 and many.max() < vocab
    assert abs(many.mean() / vocab - 1 / 3.5) < 0.01          # E[u^2.5] = 1 / 3.5


def test_pipeline_telemetry_columns_are_numpys_on_the_same_tokens():
    store = TelemetryStore(device="cpu")
    pipe = TokenPipeline(3000, 8, 40, seed=2, telemetry=store, device="cpu")
    toks = np.concatenate([pipe.next()["tokens"].numpy() for _ in range(3)])
    np.testing.assert_array_equal(store.columns["mean_token"].sample(),
                                  np.mean(toks, axis=1).astype(np.float32))
    std = np.std(toks.astype(np.float32), axis=1).astype(np.float32)
    np.testing.assert_array_equal(store.columns["seq_entropy"].sample(), std)
    # the reference's jnp reductions on the same tokens
    np.testing.assert_allclose(std, np.asarray(jnp.std(jnp.asarray(toks, jnp.float32), axis=1)),
                               rtol=1e-6)
    np.testing.assert_allclose(store.columns["mean_token"].sample(),
                               np.asarray(jnp.mean(jnp.asarray(toks), axis=1)), rtol=1e-6)


# --- elastic and straggler logic -------------------------------------------------------

def test_plan_mesh_decides_as_the_reference(rng):
    cases = [(256, 16, (8192, 1280)), (128, 16, (8192, 1280)), (64, 16, (12, 20)),
             (7, 16, ()), (1, 16, (3,)), (3, 2, (4,))]
    for _ in range(200):
        cases.append((int(rng.integers(1, 600)), int(rng.choice([1, 2, 8, 16, 32])),
                      tuple(int(x) for x in rng.integers(1, 9000, int(rng.integers(0, 3))))))
    for n, tp_max, div in cases:
        assert elastic.plan_mesh(n, tp_max, div) == jelastic.plan_mesh(n, tp_max, div)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_decides_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    # one host of 8 stands at most (8 - 1) / sqrt(8) = 2.47 sigmas out: k_sigma < 2
    kw = dict(alpha=float(rng.uniform(0.1, 0.5)), k_sigma=float(rng.uniform(1, 2)),
              patience=int(rng.integers(1, 5)))
    mine, theirs = elastic.StragglerMonitor(**kw), jelastic.StragglerMonitor(**kw)
    slow = int(rng.integers(0, 8))
    for step in range(40):
        for h in range(8):
            t = float(rng.gamma(4, 0.25)) + (2.0 if h == slow and step > 10 else 0.0)
            mine.record(h, t)
            theirs.record(h, t)
        if step % 3 == 0:
            assert mine.stragglers() == theirs.stragglers()
    assert {h: dataclasses.astuple(s) for h, s in mine.hosts.items()} == \
        {h: dataclasses.astuple(s) for h, s in theirs.hosts.items()}
    assert slow in mine.stragglers()


def test_elastic_controller_decides_as_the_reference(rng):
    mine = elastic.ElasticController(64, 4, tp_divisor_of=(8192, 1280))
    theirs = jelastic.ElasticController(64, 4, tp_divisor_of=(8192, 1280))
    assert mine.current_mesh() == theirs.current_mesh() == (16, 16)
    for step in range(10):
        lost = sorted(int(h) for h in rng.choice(64, int(rng.integers(1, 5)), replace=False))
        assert mine.fail(step * 100, lost) == theirs.fail(step * 100, lost)
        assert mine.alive == theirs.alive
    assert [(e.step, e.lost_hosts) for e in mine.events] == \
        [(e.step, e.lost_hosts) for e in theirs.events]
    assert isinstance(mine.events[0], elastic.FailureEvent)


# --- pytree checkpoints -----------------------------------------------------------------

def test_pytree_restore_round_trips_bf16_and_the_structure(tmp_path):
    tree = ({"layers": {"w": torch.randn(3, 2, 5).to(torch.bfloat16)},
             "e": torch.randn(7)},
            adamw.AdamWState(m={"w": torch.zeros(2, 2)}, v=[torch.ones(3), torch.arange(4)],
                             count=torch.tensor(5, dtype=torch.int32)))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, tree, {"step": 3})
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as z:
        assert sorted(z.files) == ["0/e", "0/layers/w.bf16", "1/.count", "1/.m/w", "1/.v/0",
                                   "1/.v/1"]
    back, extra = mgr.restore(3, tree)
    assert extra == {"step": 3} and isinstance(back[1], adamw.AdamWState)
    assert isinstance(back[1].v, list)
    for got, want in ((back[0]["layers"]["w"], tree[0]["layers"]["w"]), (back[0]["e"], tree[0]["e"]),
                      (back[1].m["w"], tree[1].m["w"]), (back[1].count, tree[1].count),
                      (back[1].v[1], tree[1].v[1])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # another template's dtypes and a wrong shape
    as_f32, _ = mgr.restore(3, ({"layers": {"w": torch.zeros(3, 2, 5)}, "e": torch.zeros(7)},
                                tree[1]))
    assert as_f32[0]["layers"]["w"].dtype == torch.float32
    assert torch.equal(as_f32[0]["layers"]["w"], tree[0]["layers"]["w"].float())
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(3, ({"layers": {"w": torch.zeros(3, 5)}, "e": torch.zeros(7)}, tree[1]))


def _ref_run(cfg_ref, batches, steps):
    """The reference's model (key 0) after `steps` jitted train steps."""
    model = ref_build_model(cfg_ref)
    params = model.init(jax.random.key(0))
    state = ref_adamw.init(params)
    step = jax.jit(ref_make_train_step(model, ref_adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                                    total_steps=10)))
    out = []
    for b in batches[:steps]:
        params, state, m = step(params, state, b)
        out.append(float(m["loss"]))
    return model, params, state, step, out


def _batches_both(cfg, n=3):
    pipe = TokenPipeline(cfg.vocab_size, 4, 16, seed=1, device="cpu")
    tb = [pipe.next() for _ in range(n)]
    jb = [{k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in b.items()} for b in tb]
    return tb, jb


def _flat(tree):
    return convert.lm_state_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), tree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_resumes_the_references_checkpoint(tmp_path, dtype):
    """The reference saves (params, opt_state) after 2 steps; the port
    restores it with the writer's bits and takes step 3 as the reference
    does."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True), param_dtype=dtype)
    ref_cfg = dataclasses.replace(ref_get_config("llama3.2-1b", smoke=True), param_dtype=dtype)
    tb, jb = _batches_both(cfg)
    model_j, params_j, state_j, step_j, _ = _ref_run(ref_cfg, jb, 2)
    jm = JCheckpointManager(str(tmp_path), async_save=False)
    jm.save(2, (params_j, state_j), {"step": 2})
    params_j, state_j, m3 = step_j(params_j, state_j, jb[2])

    from repro_torch.models import build_model
    model = build_model(cfg, "cpu")
    params = train_params(model)
    state = adamw.init(params)
    tree, extra = CheckpointManager(str(tmp_path)).restore(2, state_tree(params, state))
    state = load_state_tree(tree, params, state)
    assert extra == {"step": 2} and int(state.count) == 2
    with np.load(tmp_path / "step_00000002" / "arrays.npz") as z:
        stored = {k: z[k] for k in z.files}
    for k, p in params.items():                 # the writer's bits
        key = "0/" + k.split(".")[0]
        assert p.dtype == getattr(torch, dtype)
    w = stored["0/embed/w.bf16"].view(np.int16) if dtype == "bfloat16" else stored["0/embed/w"]
    got = params["embed.w"].detach()
    got = got.view(torch.int16).numpy() if dtype == "bfloat16" else got.numpy()
    np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(state.m["layers.1.mlp.wd"].numpy(),
                                  stored["1/.m/layers/mlp/wd"][1])
    step = make_train_step(model, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    params, state, metrics = step(params, state, tb[2])
    rtol = 1e-5 if dtype == "float32" else 5e-3
    assert float(metrics["loss"]) == pytest.approx(float(m3["loss"]), rel=rtol)
    want = _flat(params_j)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().float().numpy(), want[k], rtol=0,
                                   atol=2e-3 if dtype == "float32" else 6e-2)
    assert int(state.count) == int(state_j.count) == 3


def test_reference_resumes_the_ports_checkpoint(tmp_path):
    """The port saves after 2 steps in the reference's keys; the reference's
    own `restore(step, template)` reads it with the port's bits, and both
    packages' third steps agree."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True), param_dtype="float32")
    ref_cfg = dataclasses.replace(ref_get_config("llama3.2-1b", smoke=True),
                                  param_dtype="float32")
    tb, jb = _batches_both(cfg)
    model_j = ref_build_model(ref_cfg)
    params_j = model_j.init(jax.random.key(0))
    model = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params_j), device="cpu")
    params = train_params(model)
    state = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    for b in tb[:2]:
        params, state, _ = step(params, state, b)
    CheckpointManager(str(tmp_path), async_save=False).save(2, state_tree(params, state),
                                                            {"step": 2})
    (params_j, state_j), extra = JCheckpointManager(str(tmp_path)).restore(
        2, (params_j, ref_adamw.init(params_j)))
    assert extra == {"step": 2} and int(state_j.count) == 2
    restored = _flat(params_j)
    for k, p in params.items():
        np.testing.assert_array_equal(restored[k], p.detach().numpy())
    for k, m in state.m.items():
        np.testing.assert_array_equal(_flat(state_j.m)[k], m.numpy())
    ref_step = jax.jit(ref_make_train_step(model_j, ref_adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10)))
    params_j, state_j, m3 = ref_step(params_j, state_j, jb[2])
    params, state, metrics = step(params, state, tb[2])
    assert float(metrics["loss"]) == pytest.approx(float(m3["loss"]), rel=1e-5)
    want = _flat(params_j)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0, atol=2e-3)


def test_state_tree_has_the_references_keys(tmp_path):
    """The port's training checkpoint of every family holds exactly the keys
    the reference's `_flatten((params, opt_state))` writes."""
    from repro.checkpoint.checkpoint import _flatten as ref_flatten
    from repro_torch.models import build_model

    for arch in ("zamba2-1.2b", "whisper-base", "granite-moe-1b-a400m"):
        model = build_model(get_config(arch, smoke=True), "cpu")
        params = train_params(model)
        CheckpointManager(str(tmp_path / arch), async_save=False).save(
            1, state_tree(params, adamw.init(params)))
        jparams = ref_build_model(ref_get_config(arch, smoke=True)).init(jax.random.key(0))
        want = ref_flatten((jparams, ref_adamw.init(jparams)))
        with np.load(tmp_path / arch / "step_00000001" / "arrays.npz") as z:
            assert sorted(z.files) == sorted(want)
            assert all(z[k].shape == want[k].shape for k in want)


# --- the CLI: crash and restart, cross-package resume ---------------------------------

def _cli(*argv, module="repro_torch.launch.train", device="cpu"):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", module, *argv] + (["--device", device] if device else [])
    return subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True,
                          timeout=TIMEOUT)


def test_cli_crash_and_restart_ends_bit_equal(tmp_path):
    crashed, whole = str(tmp_path / "crashed"), str(tmp_path / "whole")
    out = _cli(*CLI, "--ckpt-dir", crashed, "--simulate-failure-at", "6")
    assert out.returncode == 42, out.stderr[-2000:]
    assert "simulated failure at step 6" in out.stdout
    assert CheckpointManager(crashed).all_steps() == [4]
    out = _cli(*CLI, "--ckpt-dir", crashed)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] resumed from step 4" in out.stdout and "step=4 " in out.stdout
    assert "step=3 " not in out.stdout and "[aqp] fraction" in out.stdout
    ref = _cli(*CLI, "--ckpt-dir", whole)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert "resumed" not in ref.stdout

    def steps(text):            # the per-step lines without their times
        return [ln.split(" dt=")[0] for ln in text.splitlines() if "step=" in ln]

    assert steps(out.stdout) == steps(ref.stdout)[4:]
    final = "step_00000012/arrays.npz"
    with np.load(os.path.join(crashed, final)) as a, np.load(os.path.join(whole, final)) as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 34
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_cli_without_a_card_exits_with_the_ports_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli("--smoke", "--steps", "1", device=None)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr


def test_port_trainer_resumes_the_reference_trainers_run(tmp_path):
    """`python -m repro.launch.train` writes step 2; the port's trainer
    resumes there (the reference's trainer reading the port's checkpoint is
    `test_reference_resumes_the_ports_checkpoint`)."""
    d = str(tmp_path / "run")
    common = ["--smoke", "--batch", "4", "--seq", "32", "--ckpt-every", "2", "--log-every", "1",
              "--ckpt-dir", d]
    out = _cli(*common, "--steps", "2", module="repro.launch.train", device=None)
    assert out.returncode == 0, out.stderr[-2000:]
    out = _cli(*common, "--steps", "4")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] resumed from step 2" in out.stdout and "step=3 " in out.stdout
    assert "step=1 " not in out.stdout


def test_trainer_refuses_families_the_pipeline_cannot_feed():
    for arch in ("internvl2-2b", "whisper-base"):
        args = train_cli.parser().parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                                              "--steps", "1"])
        with pytest.raises(ValueError, match="frontend inputs"):
            train_cli.run_train(args)


def test_run_train_in_process_takes_microbatched_steps():
    args = train_cli.parser().parse_args(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                                          "--steps", "9", "--batch", "4", "--seq", "8",
                                          "--n-micro", "2", "--log-every", "100"])
    run = train_cli.run_train(args)
    assert len(run["losses"]) == 9 and all(np.isfinite(run["losses"] + run["grad_norms"]))
    assert int(run["opt_state"].count) == 9 and run["stragglers"] == []
