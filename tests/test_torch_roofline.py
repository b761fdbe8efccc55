"""The port's roofline (`repro_torch.roofline`) against the reference's:
the analytic MODEL_FLOPS / HBM / KV-cache arithmetic equal for all 40
(architecture x shape) pairs (rel 1e-12), the reference's dominance cases
with the H100's constants, and `TraceCostModel`: exact dot FLOPs of
chained and nested products, collective bytes by kind of an FSDP product
on a fake 8-rank mesh, the one-step scaling of the SSM scans equal to the
whole loop forward and backward, and llama3.2-1b's smoke prefill within 2 %
of the reference's `HloCostModel.dot_flops()` of its jitted prefill.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import roofline as ref_roofline
from repro.configs.base import ARCH_IDS, SHAPES
from repro.configs.base import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch import convert, roofline
from repro_torch.configs.base import SHAPES_BY_NAME, get_config
from repro_torch.models import layers as L

PAIRS = [(a, s.name) for a in ARCH_IDS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_analytic_terms_equal_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    sh = SHAPES_BY_NAME[shape]
    ref_sh = next(s for s in SHAPES if s.name == shape)
    assert roofline.model_flops(cfg, sh) == pytest.approx(
        ref_roofline.model_flops(ref_cfg, ref_sh), rel=1e-12)
    for n_micro in (1, 8):
        assert roofline.hbm_bytes(cfg, sh, n_micro) == pytest.approx(
            ref_roofline.hbm_bytes(ref_cfg, ref_sh, n_micro), rel=1e-12)
    assert roofline.kv_cache_bytes(cfg, sh.global_batch, sh.seq_len) == pytest.approx(
        ref_roofline.kv_cache_bytes(ref_cfg, ref_sh.global_batch, ref_sh.seq_len), rel=1e-12)


def test_terms_dominance_with_h100_constants():
    t = roofline.terms(flops=1e18, hbm=1e12, coll_bytes_per_chip=1e9, chips=256)
    assert t["dominant"] == "compute"
    t = roofline.terms(flops=1e15, hbm=1e15, coll_bytes_per_chip=1e9, chips=256)
    assert t["dominant"] == "memory"
    t = roofline.terms(flops=1e15, hbm=1e12, coll_bytes_per_chip=1e12, chips=256)
    assert t["dominant"] == "collective"
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    fp32 = roofline.terms(1e15, 0.0, 0.0, 1, peak=roofline.PEAK_FLOPS_FP32)
    assert fp32["compute_s"] == pytest.approx(1e15 / 67e12)


def test_chained_products_count_exactly():
    x, w = torch.randn(128, 128), torch.randn(128, 128)
    tc = roofline.TraceCostModel()
    with tc:
        for _ in range(10):
            x = torch.tanh(x @ w)
    assert tc.dot_flops == 10 * 2 * 128 ** 3


def test_nested_loops_multiply():
    x, w = torch.randn(64, 64), torch.randn(64, 64)
    tc = roofline.TraceCostModel()
    with tc:
        for _ in range(5):
            for _ in range(3):
                x = x @ w
    assert tc.dot_flops == 15 * 2 * 64 ** 3


def test_one_step_scan_counts_like_the_loop():
    """A scan traced one step under `scaled` counts what the whole loop
    counts, forward and backward (the tagged backward nodes)."""
    w = torch.randn(16, 16, requires_grad=True)
    h0 = torch.randn(4, 16, requires_grad=True)     # every step has both gradients

    def step(h, t):
        h = torch.tanh(h @ w)
        return h, h @ w

    def run(hook):
        tc = roofline.TraceCostModel(one_step_scans=hook)
        with tc:
            ys, h = L.time_scan(step, h0, 12)
            torch.autograd.grad((ys.sum() + h.sum()), [w, h0])
        return tc, ys
    whole, ys_whole = run(False)
    one, ys_one = run(True)
    assert ys_one.shape == ys_whole.shape == (4, 12, 16)
    assert whole.dot_flops == 12 * 6 * 2 * 4 * 16 * 16     # 2 products, 3 dots each
    assert one.dot_flops == whole.dot_flops


def test_fsdp_product_counts_all_gather_bytes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh_from_spec
    assert not dist.is_initialized()
    try:
        mesh = make_mesh_from_spec("8", device_type="cpu")
        fake = FakeTensorMode()
        with fake:
            x = distribute_tensor(torch.zeros(128, 128), mesh, [Shard(0)], src_data_rank=None)
            w = distribute_tensor(torch.zeros(128, 128), mesh, [Shard(0)], src_data_rank=None)
            tc = roofline.TraceCostModel()
            with tc:
                (x @ w).sum().redistribute(mesh, [Replicate()])
        total, by_kind = tc.collective_bytes()
        assert by_kind["all-gather"] == 128 * 128 * 4            # the gathered weight
        assert total == sum(by_kind.values()) and "all-reduce" in by_kind
        assert tc.dot_flops == 2 * 16 * 128 * 128                # one device's rows
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_smoke_prefill_dot_flops_match_reference_hlo():
    cfg = ref_get_config("llama3.2-1b", smoke=True)
    model = ref_build_model(cfg)
    params = model.init(jax.random.key(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    compiled = jax.jit(model.prefill).lower(params, {"tokens": tokens}).compile()
    want = ref_roofline.HloCostModel(compiled.as_text()).dot_flops()

    port = convert.lm_params_from_numpy(
        get_config("llama3.2-1b", smoke=True),
        jax.tree.map(lambda a: np.asarray(a, np.float32), params), device="cpu")
    tc = roofline.TraceCostModel()
    with torch.no_grad(), tc:
        port.prefill({"tokens": torch.from_numpy(tokens).long()})
    assert tc.dot_flops == pytest.approx(want, rel=0.02)


def test_trace_counts_memory_made_during_the_trace():
    a = torch.zeros(1000)
    tc = roofline.TraceCostModel()
    assert tc.register_args(a) == 4000
    with tc:
        b = a + 1                         # 4 000 bytes live
        c = b * 2                         # 8 000
        del b                             # 4 000
        d = torch.zeros(3000)             # 16 000 at the peak
        del c, d
    assert tc.peak_bytes == 16000 and tc.live == 0


def test_dataclass_config_flops_use_active_params():
    moe = get_config("qwen3-moe-235b-a22b")
    tm = roofline.model_flops(moe, SHAPES_BY_NAME["train_4k"])
    assert tm < 6 * moe.param_count() * 4096 * 256 / 5
    assert dataclasses.is_dataclass(moe)
