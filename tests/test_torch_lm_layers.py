"""The LM stack's building blocks (`repro_torch/models/layers.py`, `moe.py`,
`configs/`) against the JAX package's on the same numpy inputs: norms,
RoPE with partial rotary, attention (GQA, chunked, sliding windows, decode
offsets), MLPs, the loss, MoE dispatch with drops, the configs and their
parameter counts, the abstract shapes, and the conversion of parameter
trees.  float32 at rtol 2e-4 / atol 1e-5 unless a test says otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.models import api as ref_api
from repro.models import layers as RL
from repro.models import moe as ref_moe
from repro_torch import convert
from repro_torch.configs import base as configs
from repro_torch.models import api, layers as L, moe
from repro_torch.train.serve_step import pad_caches

RTOL, ATOL = 2e-4, 1e-5


def t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def qkv(rng, b=2, sq=40, sk=40, hq=8, hkv=2, d=16):
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32))


# --- norms, RoPE, MLPs, loss -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(rng, kind, dtype):
    x = rng.normal(2.0, 3.0, (3, 5, 48)).astype(np.float32)
    w, b = rng.normal(size=48).astype(np.float32), rng.normal(size=48).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    x = np.asarray(jnp.asarray(x, jdt), np.float32)
    jp = {"w": jnp.asarray(w, jdt), "b": jnp.asarray(b, jdt)}
    want = RL.apply_norm(jnp.asarray(x, jdt), jp if kind == "layernorm" else {"w": jp["w"]}, kind)
    tp = {"w": t(jp["w"], tdt), "b": t(jp["b"], tdt)}
    got = L.apply_norm(t(x, tdt), tp, kind)
    assert got.dtype == tdt
    if dtype == "float32":
        close(got, want)
    else:      # both round one float32 result to bf16: at most one bf16 ulp apart
        close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("partial", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("pos_rank", [1, 2])
def test_rope_partial_rotary_matches_reference(rng, partial, pos_rank):
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    rd = int(32 * partial)
    pos = np.arange(9) if pos_rank == 1 else rng.integers(0, 5000, (2, 9))
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), rd, 500000.0)
    got = L.apply_rope(t(x), torch.tensor(pos), rd, 500000.0)
    close(got, want, atol=1e-4)
    np.testing.assert_array_equal(got[..., rd:].numpy(), x[..., rd:])
    assert L.apply_rope(t(x), torch.tensor(pos), 0, 1e4) is not None


def test_rope_keeps_pair_norms(rng):
    """Interleaved pairs are rotated: each pair's norm is kept."""
    x = rng.normal(size=(1, 6, 2, 16)).astype(np.float32)
    got = L.apply_rope(t(x), torch.arange(6), 16, 10000.0).numpy()
    n = lambda a: np.hypot(a[..., ::2], a[..., 1::2])      # noqa: E731
    np.testing.assert_allclose(n(got), n(x), rtol=1e-5)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_mlps_match_reference(rng, mlp):
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    if mlp == "swiglu":
        p = {k: rng.normal(size=s).astype(np.float32) * 0.2
             for k, s in (("wg", (24, 40)), ("wu", (24, 40)), ("wd", (40, 24)))}
        want, got = RL.swiglu(p, jnp.asarray(x)), L.swiglu({k: t(v) for k, v in p.items()}, t(x))
    else:
        p = {k: rng.normal(size=s).astype(np.float32) * 0.2
             for k, s in (("w1", (24, 40)), ("b1", (40,)), ("w2", (40, 24)), ("b2", (24,)))}
        want = RL.gelu_mlp(p, jnp.asarray(x))
        got = L.gelu_mlp({k: t(v) for k, v in p.items()}, t(x))
    close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(rng, masked):
    logits = rng.normal(0, 3, (2, 11, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 11))
    mask = (rng.random((2, 11)) > 0.3).astype(np.float32) if masked else None
    want = RL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = L.cross_entropy(t(logits), torch.tensor(labels),
                          None if mask is None else t(mask))
    close(got, want, rtol=1e-6)


# --- attention ---------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 7), (True, 300)])
@pytest.mark.parametrize("q_chunk", [16, 1024])
def test_attention_matches_reference(rng, causal, window, q_chunk):
    q, k, v = qkv(rng)
    want = RL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             window=window, q_chunk=q_chunk)
    got = L.attention_core(t(q), t(k), t(v), causal=causal, window=window, q_chunk=q_chunk)
    close(got, want)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 150)])
def test_chunked_attention_equals_unchunked(rng, causal, window):
    """S = 300 > q_chunk: the chunks, each over its static key range
    (lane-aligned window start), give the unchunked scores' answer."""
    q, k, v = qkv(rng, sq=300, sk=300, hq=4, hkv=4, d=8)
    whole = L.attention_core(t(q), t(k), t(v), causal=causal, window=window, q_chunk=4096)
    chunked = L.attention_core(t(q), t(k), t(v), causal=causal, window=window, q_chunk=64)
    close(chunked, whole.numpy(), atol=1e-5)


def test_sliding_window_limits_context(rng):
    """With a window w, a query attends to the last w keys only: changing a
    key further back leaves its output unchanged, a key within changes it."""
    q, k, v = qkv(rng, sq=24, sk=24, hq=2, hkv=2, d=8)
    base = L.attention_core(t(q), t(k), t(v), causal=True, window=5)
    k2, v2 = k.copy(), v.copy()
    k2[:, 10], v2[:, 10] = 9.0, 9.0
    moved = L.attention_core(t(q), t(k2), t(v2), causal=True, window=5)
    diff = (moved - base).abs().amax(dim=(0, 2, 3))
    assert float(diff[:10].max()) == 0.0 and float(diff[15:].max()) == 0.0
    assert float(diff[10:15].min()) > 0.0
    full = L.attention_core(t(q), t(k), t(v), causal=True, window=0)
    close(L.attention_core(t(q), t(k), t(v), causal=True, window=24), full.numpy())


def test_gqa_equals_expanded_heads(rng):
    """Grouped heads (Hq = 8 over Hkv = 2) equal attention with each KV
    head repeated for its 4 query heads."""
    q, k, v = qkv(rng, hq=8, hkv=2)
    grouped = L.attention_core(t(q), t(k), t(v), causal=True)
    rep = lambda a: np.repeat(a, 4, axis=2)                # noqa: E731
    expanded = L.attention_core(t(q), t(rep(k)), t(rep(v)), causal=True)
    close(grouped, expanded.numpy(), atol=1e-6)


@pytest.mark.parametrize("window", [0, 4])
def test_decode_offset_attends_to_the_written_prefix(rng, window):
    """A decode query at q_offset = pos over a max_len cache matches the
    reference and ignores every slot after pos."""
    q, k, v = qkv(rng, sq=1, sk=12)
    want = RL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                             q_offset=6, window=window)
    got = L.attention_core(t(q), t(k), t(v), causal=True, q_offset=6, window=window)
    close(got, want)
    k2 = k.copy()
    k2[:, 7:] = 50.0
    close(L.attention_core(t(q), t(k2), t(v), causal=True, q_offset=6, window=window),
          got.numpy(), atol=0.0, rtol=0.0)


# --- MoE ---------------------------------------------------------------------------

def moe_pair(rng, cf: float, T=(2, 24)):
    cfg = dataclasses.replace(configs.get_config("granite-moe-1b-a400m", smoke=True),
                              capacity_factor=cf, param_dtype="float32")
    rcfg = dataclasses.replace(ref_configs.get_config("granite-moe-1b-a400m", smoke=True),
                               capacity_factor=cf, param_dtype="float32")
    p = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     ref_moe.moe_params(jax.random.key(3), rcfg, jnp.float32))
    x = rng.normal(size=(*T, cfg.d_model)).astype(np.float32)
    tp = {"router": {"w": t(p["router"]["w"])}, **{k: t(p[k]) for k in ("wg", "wu", "wd")}}
    return cfg, rcfg, p, tp, x


@pytest.mark.parametrize("cf", [1.25, 0.3, 4.0])
def test_moe_block_matches_reference(rng, cf):
    """Capacity factor 0.3 drops most assignments, 4.0 none."""
    cfg, rcfg, p, tp, x = moe_pair(rng, cf)
    want = ref_moe.moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), rcfg)
    got = moe.moe_block(tp, t(x), cfg)
    close(got, want, atol=1e-5)


def test_moe_drops_past_capacity(rng):
    """C = ceil(cf T k / E); an assignment past its expert's capacity adds
    nothing: at cf = 0.3 some tokens keep fewer than k experts' outputs,
    and an expert's kept tokens are its first C in token order."""
    cfg, _, p, tp, x = moe_pair(rng, 0.3)
    T_ = x.shape[0] * x.shape[1]
    C = moe.capacity(cfg, T_)
    assert C == int(np.ceil(0.3 * T_ * cfg.top_k / cfg.n_experts))
    probs = torch.softmax(t(x).reshape(T_, -1) @ tp["router"]["w"], -1)
    eids = torch.topk(probs, cfg.top_k, -1).indices
    counts = torch.bincount(eids.reshape(-1), minlength=cfg.n_experts)
    assert int(counts.max()) > C               # some expert overflows
    out = moe.moe_block(tp, t(x), cfg)
    full = moe.moe_block(tp, t(x), dataclasses.replace(cfg, capacity_factor=4.0))
    changed = (out - full).abs().reshape(T_, -1).amax(-1) > 0
    # a token changes only if one of its experts overflowed before reaching it
    first_seen = {}
    dropped = torch.zeros(T_, dtype=torch.bool)
    for tok in range(T_):
        for e in eids[tok].tolist():
            first_seen[e] = first_seen.get(e, 0) + 1
            if first_seen[e] > C:
                dropped[tok] = True
    assert torch.equal(changed, dropped) and bool(dropped.any())


def test_moe_combine_repeats_bits(rng):
    cfg, _, p, tp, x = moe_pair(rng, 1.25)
    assert torch.equal(moe.moe_block(tp, t(x), cfg), moe.moe_block(tp, t(x), cfg))


def test_load_balance_loss_matches_reference(rng):
    cfg, rcfg, p, tp, x = moe_pair(rng, 1.25)
    want = ref_moe.load_balance_loss(jax.tree.map(jnp.asarray, p), jnp.asarray(x), rcfg)
    close(moe.load_balance_loss(tp, t(x), cfg), want, rtol=1e-5)


# --- configs, shapes, parameter trees ------------------------------------------

@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_and_parameter_counts_match_reference(arch):
    for smoke in (False, True):
        want, got = ref_configs.get_config(arch, smoke), configs.get_config(arch, smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.head_dim_, got.padded_vocab, got.d_inner) == \
            (want.head_dim_, want.padded_vocab, want.d_inner)
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs.LONG_CONTEXT_ARCHS == ref_configs.LONG_CONTEXT_ARCHS
    for shape in ref_configs.SHAPES:
        assert configs.cell_runnable(arch, shape.name) == \
            ref_configs.cell_runnable(arch, shape.name)


def test_shapes_and_cells_match_reference():
    assert [dataclasses.asdict(s) for s in configs.SHAPES] == \
        [dataclasses.asdict(s) for s in ref_configs.SHAPES]
    assert sorted(configs.SHAPES_BY_NAME) == sorted(ref_configs.SHAPES_BY_NAME)
    assert list(configs.all_cells()) == list(ref_configs.all_cells())


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_batch_and_decode_structs_match_reference(arch):
    """Shapes and dtypes of a cell's batch and decode cache, against the
    reference's `jax.eval_shape` (full configs, no allocation)."""
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    shape = ref_configs.SHAPES_BY_NAME["decode_32k"]
    want = ref_api.batch_struct(rcfg, shape)
    got = api.batch_struct(cfg, configs.SHAPES_BY_NAME["decode_32k"])
    assert sorted(got) == sorted(want)
    for k, (shp, dt) in got.items():
        assert shp == want[k].shape and str(dt).split(".")[-1] == want[k].dtype.name
    (tok, tdt), cache, (pos, pdt) = api.decode_struct(cfg, configs.SHAPES_BY_NAME["decode_32k"])
    wtok, wcache, wpos = ref_api.decode_struct(rcfg, shape)
    assert tok == wtok.shape and pos == wpos.shape
    assert sorted(cache) == sorted(wcache)
    for k, (shp, dt) in cache.items():
        assert shp == wcache[k].shape and str(dt).split(".")[-1] == wcache[k].dtype.name


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_parameter_trees_carry_across(arch):
    """Every leaf of the reference's parameter tree lands on one parameter
    of the port's model (layer axes unstacked), with the reference's dtype
    (float32 where the reference keeps float32), and the port's own init
    has the same names and shapes."""
    rcfg = ref_configs.get_config(arch, smoke=True)
    params = ref_api.build_model(rcfg).init(jax.random.key(0))
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    model = convert.lm_params_from_numpy(configs.get_config(arch, smoke=True), np_params,
                                         device="cpu")
    state = model.state_dict()
    flat = convert.lm_state_from_numpy(np_params)
    assert sorted(state) == sorted(flat)
    assert sum(v.numel() for v in state.values()) == \
        sum(a.size for a in jax.tree.leaves(params))
    ref_dtypes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        ref_dtypes[tuple(getattr(k, "key", k) for k in path)] = leaf.dtype.name
    for name, v in state.items():
        np.testing.assert_array_equal(v.float().numpy(), flat[name], err_msg=name)
        key = tuple(p for p in name.split(".") if not p.isdigit())
        assert str(v.dtype).split(".")[-1] == ref_dtypes[key], name
    own = api.build_model(configs.get_config(arch, smoke=True), "cpu").state_dict()
    assert {k: v.shape for k, v in own.items()} == {k: v.shape for k, v in state.items()}


def test_initialisers_draw_from_the_generator():
    gen = lambda: torch.Generator().manual_seed(5)          # noqa: E731
    w = L.dense_init(gen(), (400, 300), torch.float32)
    assert torch.equal(w, L.dense_init(gen(), (400, 300), torch.float32))
    assert abs(float(w.std()) - 1 / 20) < 2e-3
    assert abs(float(L.embed_init(gen(), (500, 64), torch.float32).std()) - 0.02) < 1e-3
    assert L.dense_init(gen(), (4, 8), torch.bfloat16, scale=0.5).dtype == torch.bfloat16
    cfg = configs.get_config("llama3.2-1b", smoke=True)
    a = api.build_model(cfg, "cpu", torch.Generator().manual_seed(1)).state_dict()
    b = api.build_model(cfg, "cpu", torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_build_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: models are built on it by default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build_model(configs.get_config("llama3.2-1b", smoke=True))


def test_pad_caches_grows_only_k_and_v():
    cache = {"k": torch.ones(2, 3, 4, 1, 2), "v": torch.ones(2, 3, 4, 1, 2),
             "conv": torch.ones(2, 3, 4, 5), "ssm": torch.ones(2, 3, 4, 5),
             "ck": torch.ones(2, 3, 4, 1, 2)}
    out = pad_caches(cache, 9)
    assert out["k"].shape == (2, 3, 9, 1, 2) and out["v"].shape == (2, 3, 9, 1, 2)
    assert float(out["k"][:, :, 4:].abs().max()) == 0.0 and torch.equal(out["k"][:, :, :4],
                                                                        cache["k"])
    for k in ("conv", "ssm", "ck"):
        assert out[k] is cache[k]
