"""The port's train step (`repro_torch/train/train_step.py`: autograd
through the five families' `loss`, microbatches, remat, AdamW) against the
JAX package's jitted `make_train_step` and `jax.value_and_grad(model.loss)`
on carried weights (`convert.lm_params_from_numpy`) and the same numpy
batch, for every `SMOKE_CONFIG` in float32, with llama also in bf16.

Tolerances (float32; measured worst in parentheses, this sandbox's CPU):
- loss rtol 1e-5 (4e-7); the losses of three steps rtol 2e-5;
- every gradient leaf, m and v after one step: rtol 2e-4 with atol 1e-4 x
  the leaf's max |value| (the LM parity tests' float32 tolerance; 1.2e-5);
- grad_norm rtol 1e-5, lr equal;
- the parameters after one step (lr 1e-3): within 2 lr everywhere, and
  within 1e-2 lr + 2^-20 |p| where the reference's gradient is at least
  1e-3 of its leaf's max |gradient| (7e-2 lr and 3e-6 lr).  AdamW steps
  about lr whatever a gradient's size, so a gradient at float32 noise level
  may step either way; a gradient above it steps alike.
bf16 (llama): loss rtol 5e-3, gradients rtol 5e-2 with atol 6e-2 x the
leaf's max |gradient|, parameters after one step at the reference's own
rtol 5e-2 / atol 6e-2 (`tests/test_models.py`).

The remat policies ("nothing", "dots", "dots_full", and remat off) give
bit-equal gradients on the CPU, and save what they name: the backward
recomputes products only where the policy does not save them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.train import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.models import layers as L
from repro_torch.optim import adamw
from repro_torch.train import make_eval_step, make_train_step, split_microbatches, train_params
from repro_torch.train.train_step import make_grads_fn

B, S = 4, 16
LR = 1e-3
OPT = dict(lr=LR, warmup_steps=1, total_steps=10)
F32 = {"loss": 1e-5, "steps": 2e-5, "rtol": 2e-4, "atol": 1e-4, "norm": 1e-5}
P_LOOSE, P_TIGHT, ABOVE = 2.0, 1e-2, 1e-3
BF16_RTOL, BF16_ATOL = 5e-2, 6e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size tensors run on one intra-op thread: under the parallel
    test run several workers' thread pools would otherwise oversubscribe
    the cores (a 2.5 s test took 47 s beside one other worker)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Case:
    """One architecture in one dtype: the reference's weights (key 0) in both
    packages, one batch (numpy seed 0), and the reference's jitted outputs:
    the loss and gradients of the batch and three train steps."""

    def __init__(self, arch: str, dtype: str = "float32", n_micro: int = 1):
        self.arch, self.dtype, self.n_micro = arch, dtype, n_micro
        self.ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True), param_dtype=dtype)
        self.cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype=dtype)
        self.ref = ref_build_model(self.ref_cfg)
        self.params = self.ref.init(jax.random.key(0))
        self.np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), self.params)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, self.cfg.vocab_size, (B, S)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        self.jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        self.tbatch = {"tokens": torch.tensor(tokens, dtype=torch.long),
                       "labels": torch.tensor(labels, dtype=torch.long)}
        extra = {"vlm": ("patch_embeds", self.cfg.n_vision_tokens),
                 "encdec": ("enc_frames", self.cfg.enc_seq)}.get(self.cfg.family)
        if extra:
            name, n = extra
            a = np.asarray(jnp.asarray(rng.normal(0, 1, (B, n, self.cfg.d_model)), dtype),
                           np.float32)
            self.jbatch[name] = jnp.asarray(a, dtype)
            self.tbatch[name] = torch.tensor(a).to(getattr(torch, dtype))

    def port(self, **cfg_changes):
        model = convert.lm_params_from_numpy(dataclasses.replace(self.cfg, **cfg_changes),
                                             self.np_params, device="cpu")
        return model, train_params(model)

    @functools.cached_property
    def ref_out(self) -> dict:
        step = ref_make_train_step(self.ref, ref_adamw.AdamWConfig(**OPT), self.n_micro)

        def both(p, s, b):
            return jax.value_and_grad(self.ref.loss)(p, b), step(p, s, b)

        fn = jax.jit(both)
        (loss, grads), (p, s, m) = fn(self.params, ref_adamw.init(self.params), self.jbatch)
        out = {"loss": float(loss), "grads": _flat(grads), "params": _flat(p), "m": _flat(s.m),
               "v": _flat(s.v), "count": int(s.count), "grad_norm": float(m["grad_norm"]),
               "lr": float(m["lr"]), "losses": [float(m["loss"])]}
        for _ in range(2):
            _, (p, s, m) = fn(p, s, self.jbatch)
            out["losses"].append(float(m["loss"]))
        return out


def _flat(tree) -> dict:
    return convert.lm_state_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), tree))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def case():
    made = {}

    def get(arch, dtype="float32", n_micro=1):
        if (arch, dtype, n_micro) not in made:
            made[(arch, dtype, n_micro)] = Case(arch, dtype, n_micro)
        return made[(arch, dtype, n_micro)]
    return get


def assert_leaf_close(got, want, what, rtol=F32["rtol"], atol=F32["atol"]):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max(),
                               err_msg=what)


def assert_params_stepped_alike(got: dict, want: dict, grads: dict, what: str):
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert (d <= P_LOOSE * LR).all(), (what, k, d.max() / LR)
        above = np.abs(grads[k]) >= ABOVE * np.abs(grads[k]).max()
        tight = P_TIGHT * LR + 2.0 ** -20 * np.abs(w)
        assert (d[above] <= tight[above]).all(), (what, k, (d[above] / LR).max())


def one_step(model, params, batch, n_micro=1):
    state = adamw.init(params)
    params, state, metrics = make_train_step(model, adamw.AdamWConfig(**OPT), n_micro)(
        params, state, batch)
    return params, state, metrics


# --- every family in float32 against the reference ------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_match_reference(case, arch):
    c = case(arch)
    model, params = c.port()
    loss, grads = make_grads_fn(model)(list(params.values()), c.tbatch)
    want = c.ref_out
    assert float(loss) == pytest.approx(want["loss"], rel=F32["loss"])
    assert float(make_eval_step(model)(c.tbatch)) == float(loss)
    assert sorted(params) == sorted(want["grads"])
    for k, g in zip(params, grads):
        assert g.dtype == torch.float32 and g.shape == params[k].shape
        assert_leaf_close(_np(g), want["grads"][k], f"{arch} gradient of {k}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_step_matches_reference(case, arch):
    c = case(arch)
    model, params = c.port()
    params, state, metrics = one_step(model, params, c.tbatch)
    want = c.ref_out
    assert float(metrics["loss"]) == pytest.approx(want["loss"], rel=F32["loss"])
    assert float(metrics["grad_norm"]) == pytest.approx(want["grad_norm"], rel=F32["norm"])
    assert float(metrics["lr"]) == want["lr"] and int(state.count) == want["count"] == 1
    for k in params:
        assert_leaf_close(state.m[k].numpy(), want["m"][k], f"{arch} m of {k}")
        assert_leaf_close(state.v[k].numpy(), want["v"][k], f"{arch} v of {k}")
    assert_params_stepped_alike({k: _np(p) for k, p in params.items()}, want["params"],
                                want["grads"], arch)
    # the step trained the model's own parameters
    assert all(p is q for p, q in zip(params.values(), model.parameters()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_three_steps_losses_match_reference(case, arch):
    c = case(arch)
    model, params = c.port()
    state = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(**OPT))
    losses = []
    for _ in range(3):
        params, state, metrics = step(params, state, c.tbatch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, c.ref_out["losses"], rtol=F32["steps"])
    assert losses[2] < losses[0]


# --- microbatches -----------------------------------------------------------------------

def test_two_microbatches_match_reference_and_one_batch(case):
    arch = "llama3.2-1b"
    c = case(arch, n_micro=2)
    model, params = c.port()
    params, state, metrics = one_step(model, params, c.tbatch, n_micro=2)
    want = c.ref_out
    assert float(metrics["loss"]) == pytest.approx(want["loss"], rel=F32["loss"])
    assert float(metrics["grad_norm"]) == pytest.approx(want["grad_norm"], rel=F32["norm"])
    for k in params:
        assert_leaf_close(state.m[k].numpy(), want["m"][k], f"{arch} n_micro 2 m of {k}")
    assert_params_stepped_alike({k: _np(p) for k, p in params.items()}, want["params"],
                                want["grads"], f"{arch} n_micro 2")
    # the mean of two microbatches' losses and gradients is the whole batch's
    whole, wparams = c.port()
    loss1, g1 = make_grads_fn(whole, 1)(list(wparams.values()), c.tbatch)
    loss2, g2 = make_grads_fn(whole, 2)(list(wparams.values()), c.tbatch)
    assert float(loss2) == pytest.approx(float(loss1), rel=F32["loss"])
    for k, a, b in zip(wparams, g1, g2):
        assert_leaf_close(_np(b), _np(a), f"{arch} n_micro 2 against 1, gradient of {k}")


def test_microbatches_accumulate_in_float32(case):
    """bf16 parameters: each microbatch's bf16 gradient is widened and added
    into float32, as the reference's scan does; the sum is not rounded to
    bf16 in between."""
    c = case("llama3.2-1b", "bfloat16")
    model, params = c.port()
    leaves = list(params.values())
    loss, grads = make_grads_fn(model, 2)(leaves, c.tbatch)
    parts = [torch.autograd.grad(model.loss(mb), leaves)
             for mb in split_microbatches(c.tbatch, 2)]
    for g, a, b in zip(grads, *parts):
        assert a.dtype == torch.bfloat16 and g.dtype == torch.float32
        assert torch.equal(g, (a.float() + b.float()) * 0.5)


def test_split_microbatches_keeps_row_order_and_refuses_a_remainder():
    batch = {"tokens": torch.arange(24).reshape(6, 4), "labels": torch.arange(6)}
    mbs = split_microbatches(batch, 3)
    assert [mb["labels"].tolist() for mb in mbs] == [[0, 1], [2, 3], [4, 5]]
    assert torch.equal(torch.cat([mb["tokens"] for mb in mbs]), batch["tokens"])
    with pytest.raises(ValueError, match="microbatches"):
        split_microbatches(batch, 4)


# --- remat ----------------------------------------------------------------------------

REMAT = [{"remat": False}, {"remat": True, "remat_policy": "nothing"},
         {"remat": True, "remat_policy": "dots"}, {"remat": True, "remat_policy": "dots_full"}]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_policies_give_the_same_gradient_bits(case, arch):
    c = case(arch)
    out = []
    for changes in REMAT:
        model, params = c.port(**changes)
        out.append(make_grads_fn(model)(list(params.values()), c.tbatch))
    for (loss, grads), changes in zip(out[1:], REMAT[1:]):
        assert torch.equal(loss, out[0][0]), changes
        assert all(torch.equal(a, b) for a, b in zip(grads, out[0][1])), changes


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-235b-a22b"])
def test_remat_policies_recompute_what_they_do_not_save(case, arch):
    """Products the backward runs: "nothing" reruns the forward's, "dots"
    reruns the batched ones only (attention's einsums, the MoE experts),
    "dots_full" none, as with remat off."""
    c = case(arch)
    seen = {}
    for changes in REMAT:
        model, params = c.port(**changes)
        loss = model.loss(c.tbatch)
        with _Count() as count:
            torch.autograd.grad(loss, list(params.values()))
        seen[changes.get("remat_policy") if changes["remat"] else "off"] = count.ops
    mm = {k: v.get("mm", 0) + v.get("addmm", 0) for k, v in seen.items()}
    bmm = {k: v.get("bmm", 0) + v.get("baddbmm", 0) for k, v in seen.items()}
    assert mm["nothing"] > mm["dots"] == mm["dots_full"] == mm["off"]
    assert bmm["nothing"] == bmm["dots"] > bmm["dots_full"] == bmm["off"]


def test_remat_runs_the_block_as_it_is_without_gradients():
    calls = []
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True), remat_policy="dots")
    block = L.remat_block(lambda x: calls.append(torch.is_grad_enabled()) or x * 2, cfg)
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        assert torch.equal(block(x), torch.full((3,), 2.0))
    assert calls == [False]
    with pytest.raises(ValueError, match="remat policy"):
        L.remat_block(lambda x: x, dataclasses.replace(cfg, remat_policy="everything"))
    assert L.remat_block(abs, dataclasses.replace(cfg, remat=False)) is abs


# --- the deterministic gather, bf16, serving stays gradient-free ----------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_is_indexing_with_a_fixed_order_backward(rng, dtype):
    table = torch.tensor(rng.normal(0, 1, (50, 6)).astype(np.float32)).to(dtype)
    idx = torch.tensor(rng.integers(0, 10, (7, 9)))          # many repeats, rows 10+ unread
    w = torch.tensor(rng.normal(0, 1, (7, 9, 6)).astype(np.float32)).to(dtype)
    a = table.clone().requires_grad_()
    b = table.clone().requires_grad_()
    out = L.gather_rows(a, idx)
    assert torch.equal(out, table[idx])
    (out * w).sum().backward()
    (b[idx] * w).sum().backward()
    want = torch.zeros(50, 6, dtype=torch.float64)
    want.index_add_(0, idx.reshape(-1), w.reshape(-1, 6).double())
    assert a.grad.dtype == dtype
    torch.testing.assert_close(a.grad.double(), want, rtol=1e-2 if dtype == torch.bfloat16
                               else 1e-6, atol=1e-2 if dtype == torch.bfloat16 else 1e-6)
    if dtype == torch.float32:
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)
    assert not a.grad[10:].any()


def test_llama_bf16_step_matches_reference_at_its_tolerance(case):
    c = case("llama3.2-1b", "bfloat16")
    model, params = c.port()
    loss, grads = make_grads_fn(model)(list(params.values()), c.tbatch)
    want = c.ref_out
    assert float(loss) == pytest.approx(want["loss"], rel=BF16_RTOL / 10)
    for k, g in zip(params, grads):
        assert_leaf_close(_np(g), want["grads"][k], f"bf16 gradient of {k}", BF16_RTOL,
                          BF16_ATOL)
    params, state, _ = one_step(model, params, c.tbatch)
    for k, p in params.items():
        assert p.dtype == torch.bfloat16 and state.m[k].dtype == torch.float32
        np.testing.assert_allclose(_np(p), want["params"][k], rtol=BF16_RTOL, atol=BF16_ATOL,
                                   err_msg=f"bf16 parameter {k}")


def test_serving_stays_gradient_free(case):
    from repro_torch.models import build_model
    from repro_torch.train import greedy_generate

    c = case("llama3.2-1b")
    fresh = build_model(c.cfg, "cpu")
    assert not any(p.requires_grad for p in fresh.parameters())
    model, params = c.port()
    assert all(p.requires_grad for p in params.values())
    out, logits = greedy_generate(model, c.tbatch["tokens"], 2, with_logits=True)
    assert not logits.requires_grad and out.shape == (B, S + 2)
