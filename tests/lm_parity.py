"""Harness of the LM parity tests (`tests/test_torch_lm_*.py`): one smoke
config of the JAX package's LM stack and the port's counterpart, on the same
numpy inputs with the reference's weights carried across
(`repro_torch.convert.lm_params_from_numpy`), and the reference's jitted
outputs computed once per case.

Sizes are the reference's own prefill/decode test's (`tests/test_models.py`,
B = 2, S = 16), plus NEW greedy tokens.  Tolerances:

- float32 (`param_dtype="float32"`): rtol 2e-4 with atol 1e-4 x the largest
  |reference value| of the compared output, and equal greedy tokens;
- bfloat16: the reference's own rtol 5e-2 / atol 6e-2
  (`tests/test_models.py`), and equal greedy tokens up to the first step
  whose reference top-2 logit margin is under that tolerance.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.train.serve_step import PADDED

B, S, NEW = 2, 16, 5
F32_RTOL, F32_ATOL = 2e-4, 1e-4
BF16_RTOL, BF16_ATOL = 5e-2, 6e-2
DTYPES = ("float32", "bfloat16")
# a bf16 MoE token whose router margin (k-th minus (k+1)-th probability)
# is at least this wide must be routed alike by the two packages
ROUTE_FLIP_MARGIN = 0.1
# families whose bf16 outputs are held to the reference's float32 run on the
# same weights instead: the recurrences carry bf16 rounding through every
# step, and the reference's own bf16 logits stand 0.05-0.06 (falcon-mamba)
# and 0.11-0.15 (zamba2) from its float32 ones at B = 2, S = 16, at or past
# the tolerance; the port's stand as far
FLOAT32_ANCHORED = ("ssm", "hybrid")


def tolerance(dtype: str, want) -> tuple:
    """(rtol, atol) for comparing against the reference output `want`."""
    if dtype == "float32":
        return F32_RTOL, F32_ATOL * float(np.abs(want).max())
    return BF16_RTOL, BF16_ATOL


def assert_close(got, want, dtype: str, what: str = ""):
    rtol, atol = tolerance(dtype, want)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


def to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def pad_by_name(cache: dict, max_len: int) -> dict:
    """The reference's caches with only "k" / "v" padded along time."""
    return {k: jnp.pad(a, [(0, 0), (0, 0), (0, max_len - a.shape[2])]
                       + [(0, 0)] * (a.ndim - 3)) if k in PADDED else a
            for k, a in cache.items()}


def first_unsafe_step(step_logits: np.ndarray, dtype: str) -> np.ndarray:
    """Per row, the first greedy step whose reference top-2 logit margin is
    within the tolerance (where another implementation may pick the other
    token); NEW where there is none."""
    top2 = np.sort(step_logits, axis=-1)[..., -2:]
    rtol, atol = tolerance(dtype, step_logits)
    margin = top2[..., 1] - top2[..., 0]
    unsafe = margin <= 2 * (atol + rtol * np.abs(top2[..., 1]))          # (B, steps)
    return np.where(unsafe.any(axis=1), np.argmax(unsafe, axis=1), unsafe.shape[1])


@contextlib.contextmanager
def port_routes(case):
    """Record the port's routing in a bf16 MoE case: per MoE call, each
    token's sorted top-k expert ids and its router margin (k-th minus
    (k+1)-th probability).  Nothing for the other cases, which route alike
    in both packages."""
    seen = []
    if not case.moe16:
        yield seen
        return
    import repro_torch.models.transformer as T
    block = T.moe_block

    def spy(p, x, cfg):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p["router"]["w"], -1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1)
        ids = torch.sort(top.indices[:, :-1], dim=-1).values
        margin = top.values[:, -2] - top.values[:, -1]
        seen.append((ids.reshape(*x.shape[:2], -1).numpy(), margin.reshape(x.shape[:2]).numpy()))
        return block(p, x, cfg)

    T.moe_block = spy
    try:
        yield seen
    finally:
        T.moe_block = block


@contextlib.contextmanager
def ref_routes(case):
    """Record the reference's routing in a bf16 MoE case, from inside its
    jitted scan (a host callback per MoE call): each token's sorted top-k
    expert ids."""
    seen = []
    if not case.moe16:
        yield seen
        return
    import repro.models.transformer as RT
    block = RT.moe_block

    def spy(p, x, cfg):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"]["w"]
        _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
        jax.debug.callback(lambda a, shape=x.shape[:2]: seen.append(
            np.sort(np.asarray(a), axis=-1).reshape(*shape, -1)), ids, ordered=True)
        return block(p, x, cfg)

    RT.moe_block = spy
    try:
        yield seen
    finally:
        RT.moe_block = block


def kept(ids: np.ndarray, cfg) -> np.ndarray:
    """Which of each token's top-k assignments (sorted expert ids, (rows,
    cols, k)) survive the capacity C = ceil(cf T k / E): an expert keeps the
    first C tokens, in token order, that chose it (both packages' rule)."""
    flat = ids.reshape(-1, ids.shape[-1])
    C = max(1, int(np.ceil(cfg.capacity_factor * flat.shape[0] * cfg.top_k / cfg.n_experts)))
    onehot = np.zeros((flat.shape[0], cfg.n_experts), int)
    np.put_along_axis(onehot, flat, 1, axis=1)
    position = np.take_along_axis(np.cumsum(onehot, axis=0) - 1, flat, axis=1)
    return (position < C).reshape(ids.shape)


def routed_alike(case, mine, theirs, rows: int, cols: int, fed_alike=None) -> np.ndarray:
    """(rows, cols) mask of the positions no routing difference reaches.  A
    token routes alike in a layer when both packages chose the same top-k
    experts and kept the same ones past capacity; a token that differs in
    an earlier MoE layer reaches, through attention, every later position
    of its row; in the last layer only its own position.  `mine` holds the
    port's (ids, margin) per layer, `theirs` the reference's ids, for the
    same calls.  A top-k difference that no earlier one reaches, in a row
    fed the same tokens (`fed_alike`, default all), must be a near-tie of
    the port's router (margin under ROUTE_FLIP_MARGIN); a capacity drop may
    move with any other token's choice; rows fed other tokens differ."""
    if not mine:
        return np.ones((rows, cols), bool)
    assert len(mine) == len(theirs)
    reached = np.broadcast_to(~(np.ones(rows, bool) if fed_alike is None
                                else fed_alike)[:, None], (rows, cols))
    for (ids, margin), ref_ids in zip(mine, theirs):
        chose = (ids != ref_ids).any(axis=-1)
        assert (margin[chose & ~reached] < ROUTE_FLIP_MARGIN).all(), margin[chose & ~reached]
        d = chose | (kept(ids, case.cfg) != kept(ref_ids, case.cfg)).any(axis=-1)
        last = reached | d
        reached = reached | (np.cumsum(d, axis=1) > 0)
    return ~last


class Case:
    """One (architecture, dtype): both packages' models on the reference's
    weights (key 0) and one input batch (numpy seed `seed`)."""

    def __init__(self, arch: str, dtype: str, seed: int = 0, prompt: int = S):
        self.arch, self.dtype, self.prompt = arch, dtype, prompt
        self.ref_cfg = dataclasses.replace(ref_get_config(arch, smoke=True), param_dtype=dtype)
        self.cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype=dtype)
        self.ref = ref_build_model(self.ref_cfg)
        self.params = self.ref.init(jax.random.key(0))
        self.np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), self.params)
        self.port = convert.lm_params_from_numpy(self.cfg, self.np_params, device="cpu")
        self.moe16 = self.cfg.family == "moe" and dtype == "bfloat16"
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, self.cfg.vocab_size, (B, prompt)).astype(np.int32)
        self.jbatch = {"tokens": jnp.asarray(tokens)}
        self.tbatch = {"tokens": torch.tensor(tokens, dtype=torch.long)}
        extra = {"vlm": ("patch_embeds", self.cfg.n_vision_tokens),
                 "encdec": ("enc_frames", self.cfg.enc_seq)}.get(self.cfg.family)
        if extra:
            name, n = extra
            a = np.asarray(jnp.asarray(rng.normal(0, 1, (B, n, self.cfg.d_model)), jdt),
                           np.float32)
            self.jbatch[name] = jnp.asarray(a, jdt)
            self.tbatch[name] = torch.tensor(a).to(tdt)
        labels = np.roll(tokens, -1, axis=1)
        self.jlabels = {**self.jbatch, "labels": jnp.asarray(labels)}
        self.tlabels = {**self.tbatch, "labels": torch.tensor(labels, dtype=torch.long)}

    # ------------------------------------------------ reference outputs --
    @functools.cached_property
    def ref_apply(self) -> np.ndarray:
        with ref_routes(self) as routes:
            out = to_numpy(jax.jit(self.ref.apply)(self.params, self.jbatch))
        self.ref_apply_routes = routes
        return out

    @functools.cached_property
    def ref_f32(self) -> tuple:
        """The reference's float32 prefill (logits, caches) on this case's
        weights (bf16 values held exactly in float32)."""
        model = ref_build_model(dataclasses.replace(self.ref_cfg, param_dtype="float32"))
        params = jax.tree.map(lambda a: a.astype(jnp.float32), self.params)
        logits, cache = jax.jit(model.prefill)(params, self.jbatch)
        return to_numpy(logits), {k: to_numpy(v) for k, v in cache.items()}

    @functools.cached_property
    def ref_loss(self) -> float:
        return float(jax.jit(self.ref.loss)(self.params, self.jlabels))

    @functools.cached_property
    def ref_generate(self) -> dict:
        """The reference's prefill, its caches padded by name, and NEW - 1
        decode steps on its own greedy tokens: logits, caches and tokens."""
        with ref_routes(self) as routes:
            out = self._generate()
        out["routes"] = routes
        return out

    def _generate(self) -> dict:
        logits, cache = jax.jit(self.ref.prefill)(self.params, self.jbatch)
        out = {"prefill_logits": to_numpy(logits),
               "prefill_cache": {k: to_numpy(v) for k, v in cache.items()}}
        start = logits.shape[1]
        cache = pad_by_name(cache, start + NEW)
        out["padded_cache"] = {k: to_numpy(v) for k, v in cache.items()}
        step = jax.jit(self.ref.decode_step)
        tok = jnp.argmax(logits[:, -1:, :], axis=-1).astype(jnp.int32)
        toks, seen = [tok], [to_numpy(logits[:, -1])]
        for i in range(NEW - 1):
            logits, cache = step(self.params, cache, tok, jnp.int32(start + i))
            if i == 0:
                out["step_cache"] = {k: to_numpy(v) for k, v in cache.items()}
            tok = jnp.argmax(logits[:, -1:, :], axis=-1).astype(jnp.int32)
            toks.append(tok)
            seen.append(to_numpy(logits[:, -1]))
        out["tokens"] = np.concatenate([np.asarray(t) for t in toks], axis=1)
        out["step_logits"] = np.stack(seen, axis=1)
        out["start"] = start
        return out


# ------------------------------------------------------------- checks --
def anchored(case: Case) -> bool:
    return case.dtype == "bfloat16" and case.cfg.family in FLOAT32_ANCHORED


def assert_as_close_to_float32(got: np.ndarray, ref: np.ndarray, f32: np.ndarray,
                               what: str) -> None:
    """The port's bf16 output `got` stands no farther from the reference's
    float32 run `f32` than the reference's own bf16 output `ref` does: the
    mean error within 1.25x of the reference's, the largest within it plus
    the bf16 atol."""
    mine, theirs = np.abs(got - f32), np.abs(ref - f32)
    assert mine.mean() <= 1.25 * theirs.mean(), (what, mine.mean(), theirs.mean())
    assert mine.max() <= theirs.max() + BF16_ATOL, (what, mine.max(), theirs.max())


def check_apply(case: Case) -> None:
    with torch.no_grad(), port_routes(case) as mine:
        got = case.port.apply(case.tbatch)
    assert got.dtype == getattr(torch, case.dtype)
    if anchored(case):
        return assert_as_close_to_float32(to_numpy(got), case.ref_apply, case.ref_f32[0],
                                          f"{case.arch} apply")
    want = case.ref_apply
    keep = routed_alike(case, mine, case.ref_apply_routes, *got.shape[:2])
    assert keep.any()
    assert_close(to_numpy(got)[keep], want[keep], case.dtype, f"{case.arch} apply")


def check_loss(case: Case) -> None:
    """The loss against the reference's; where a bf16 MoE token was routed
    otherwise, the port's loss of its own logits against the reference's
    `cross_entropy` of them (the logits are held by check_apply)."""
    from repro.models import layers as ref_layers

    with torch.no_grad(), port_routes(case) as mine:
        got = float(case.port.loss(case.tlabels))
    rtol = 1e-5 if case.dtype == "float32" else BF16_RTOL / 10
    want = case.ref_loss
    if mine and not routed_alike(case, mine, case.ref_apply_routes, B, case.prompt).all():
        with torch.no_grad():
            logits = to_numpy(case.port.apply(case.tbatch))
        labels = np.asarray(case.jlabels["labels"])
        want = float(ref_layers.cross_entropy(jnp.asarray(logits[:, :-1]),
                                              jnp.asarray(labels[:, 1:])))
    np.testing.assert_allclose(got, want, rtol=rtol, err_msg=f"{case.arch} loss")


def check_prefill(case: Case) -> None:
    with torch.no_grad(), port_routes(case) as mine:
        logits, cache = case.port.prefill(case.tbatch)
    want = case.ref_generate
    keep = routed_alike(case, mine, want["routes"][:len(mine)], *logits.shape[:2])
    assert keep.any()
    assert sorted(cache) == sorted(want["prefill_cache"])
    outputs = [("logits", to_numpy(logits), want["prefill_logits"])] + [
        (f"cache {k}", to_numpy(v), want["prefill_cache"][k]) for k, v in cache.items()]
    for name, got, ref in outputs:
        assert got.shape == ref.shape, name
        if anchored(case):
            f32 = case.ref_f32[0] if name == "logits" else case.ref_f32[1][name[6:]]
            assert_as_close_to_float32(got, ref, f32, f"{case.arch} prefill {name}")
            continue
        if not keep.all():   # a MoE model: logits (B, S, V), caches "k" / "v" (L, B, S, ...)
            got, ref = (got[keep], ref[keep]) if name == "logits" else \
                (got[:, keep], ref[:, keep])
        assert_close(got, ref, case.dtype, f"{case.arch} prefill {name}")


def check_decode_step(case: Case) -> None:
    """One decode step from the reference's own (padded) prefill cache, on
    the reference's first greedy token."""
    want = case.ref_generate
    cache = convert.lm_cache_from_numpy(case.cfg, want["padded_cache"], device="cpu")
    tok = torch.tensor(want["tokens"][:, :1], dtype=torch.long)
    with torch.no_grad(), port_routes(case) as mine:
        logits, cache = case.port.decode_step(cache, tok, want["start"])
    L = len(mine)
    rows = routed_alike(case, mine, want["routes"][L:2 * L], B, 1)[:, 0]
    assert_close(to_numpy(logits[:, -1])[rows], want["step_logits"][rows, 1], case.dtype,
                 f"{case.arch} decode_step")
    for k, v in cache.items():
        assert_close(to_numpy(v)[:, rows], want["step_cache"][k][:, rows], case.dtype,
                     f"{case.arch} decode_step cache {k}")


def check_greedy(case: Case) -> None:
    """greedy_generate's tokens against the reference's prefill + decode
    loop (caches padded by name), and the logits they were chosen from: all
    of them in float32; in bf16 each row up to its first step with a
    reference top-2 logit margin under the tolerance, or (MoE) whose
    prompt or step routed a token otherwise."""
    from repro_torch.train import greedy_generate

    want = case.ref_generate
    extra = {k: v for k, v in case.tbatch.items() if k != "tokens"}
    with port_routes(case) as mine:
        tokens, logits = greedy_generate(case.port, case.tbatch["tokens"], NEW,
                                         extra_batch=extra, with_logits=True)
    assert tuple(tokens.shape) == (B, case.prompt + NEW)
    assert torch.equal(tokens[:, :case.prompt], case.tbatch["tokens"])
    new, got = tokens[:, case.prompt:].numpy(), to_numpy(logits)
    limit = np.full(B, NEW)
    if case.dtype != "float32":
        limit = first_unsafe_step(want["step_logits"], case.dtype)
    if mine:
        L, theirs = case.cfg.n_layers, want["routes"]
        ok = [routed_alike(case, mine[:L], theirs[:L], B, case.prompt)[:, -1]]
        for j in range(NEW - 1):              # decode step j chooses token j + 1
            fed = (new[:, :j + 1] == want["tokens"][:, :j + 1]).all(axis=1)
            ok.append(routed_alike(case, mine[L * (j + 1):L * (j + 2)], theirs[L * (j + 1):L * (j + 2)],
                                   B, 1, fed)[:, 0])
        ok = np.stack(ok, axis=1)
        limit = np.minimum(limit, np.where(ok.all(axis=1), NEW, np.argmin(ok, axis=1)))
    for b in range(B):
        n = int(limit[b])
        np.testing.assert_array_equal(new[b, :n], want["tokens"][b, :n])
        if n:
            assert_close(got[b, :n], want["step_logits"][b, :n], case.dtype,
                         f"{case.arch} greedy logits, row {b}")
