"""What the LM stack's sharded pieces move and hold on a fake mesh, traced
one device at a time (`roofline.TraceCostModel` on fake tensors over a
fake process group, as the dry run traces a cell), at small widths:

- `gather_rows` from a table sharded by rows over 'model' (the serve
  spec `P("model", None)`) moves no table bytes: one all_reduce of its
  (B_local, S, d_model) rows and nothing else;
- `_nll` on vocab-sharded logits moves three all_reduces of (B_local, S)
  floats, never B x S x V;
- the MoE block's collective bytes a device are the same at 2 and at 4
  data-parallel ranks with the same tokens a rank, apart from the count
  exchange's E integers a rank, and no token is gathered;
- attention with kv heads that do not divide 'model' makes no tensor the
  size of the whole q or of its scores on any device.

Fake process groups are one a process: each case starts and destroys its
own.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import roofline, sharding
from repro_torch.configs.base import get_config
from repro_torch.launch.dryrun import _real_redistribution_plans
from repro_torch.launch.mesh import make_mesh_from_spec
from repro_torch.models import layers as L
from repro_torch.models import moe

B, S, D, V = 8, 16, 64, 1024


class Shapes(roofline.TraceCostModel):
    """The trace, with the numel of every tensor a local op made."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def _track(self, out, op: str = "") -> None:
        self.numels += [t.numel() for t in torch.utils._pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
        super()._track(out, op)


@pytest.fixture()
def fake_mesh():
    """make(spec): a mesh over a fake group of its size; the group is
    destroyed after the test."""
    def make(spec):
        if dist.is_initialized():
            dist.destroy_process_group()
        return make_mesh_from_spec(spec, device_type="cpu")
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _trace(fn):
    tc = Shapes()
    with _real_redistribution_plans(), tc, implicit_replication():
        out = fn()
    coll, by_kind = tc.collective_bytes()
    return out, coll, by_kind, tc


def _place(t, mesh, spec):
    return sharding.distribute({"t": t}, {"t": spec}, mesh)["t"]


def test_vocab_sharded_lookup_moves_only_its_rows(fake_mesh):
    mesh = fake_mesh("2,4")
    with FakeTensorMode():
        table = _place(torch.zeros((V, D), dtype=torch.bfloat16), mesh, sharding.P("model", None))
        idx = _place(torch.randint(0, V, (B, S)), mesh, sharding.P("data", None))
        rows, coll, by_kind, _ = _trace(lambda: L.gather_rows(table, idx))
    assert rows.shape == (B, S, D) and rows.placements == (Shard(0), Replicate())
    assert by_kind == {"all-reduce": (B // 2) * S * D * 2}          # bf16 rows, one all_reduce
    assert coll < V * D * 2 // 4                                   # less than a table shard


def test_vocab_parallel_nll_moves_no_logits(fake_mesh):
    mesh = fake_mesh("2,4")
    with FakeTensorMode():
        logits = _place(torch.zeros((B, S, V)), mesh, sharding.P("data", None, "model"))
        labels = _place(torch.randint(0, V, (B, S)), mesh, sharding.P("data", None))
        nll, coll, by_kind, tc = _trace(lambda: L._nll(logits, labels))
    assert nll.shape == (B, S)
    assert by_kind == {"all-reduce": 3 * (B // 2) * S * 4}          # max, sum, gold
    assert max(tc.numels) <= (B // 2) * S * V // 4                  # a shard's logits at most


def _moe_bytes(fake_mesh, spec, dp: int):
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b", smoke=True),
                              param_dtype="float32")
    mesh = fake_mesh(spec)
    with FakeTensorMode():
        gen = torch.Generator()
        p = moe.moe_params(gen, cfg, torch.float32)
        specs = sharding.flat_specs(moe.moe_specs(cfg, "data"), {})
        flat = sharding.distribute({"router.w": p["router"]["w"], "wg": p["wg"], "wu": p["wu"],
                                    "wd": p["wd"]}, specs, mesh)
        params = {"router": {"w": flat["router.w"]}, "wg": flat["wg"], "wu": flat["wu"],
                  "wd": flat["wd"]}
        x = _place(torch.zeros((2 * dp, S, cfg.d_model)), mesh, sharding.P("data", None, None))
        out, coll, by_kind, tc = _trace(lambda: moe.moe_block(params, x, cfg))
    assert out.shape == x.shape
    return cfg, coll, by_kind, tc


def test_moe_collectives_do_not_grow_with_data_parallel_ranks(fake_mesh):
    cfg, c2, k2, t2 = _moe_bytes(fake_mesh, "2,4", 2)
    _, c4, k4, t4 = _moe_bytes(fake_mesh, "4,4", 4)
    counts = {2: 2 * cfg.n_experts * 8, 4: 4 * cfg.n_experts * 8}    # int64 counts a rank
    assert c2 - counts[2] == c4 - counts[4]
    assert k2["all-reduce"] == k4["all-reduce"] == 2 * S * cfg.d_model * 4   # the combine
    tokens = 2 * S * cfg.d_model
    assert max(t4.numels) < 4 * tokens * cfg.top_k                  # no rank holds all tokens


def test_gqa_attention_holds_no_whole_q(fake_mesh):
    mesh = fake_mesh("2,4")
    hq, hkv, dh = 8, 2, 16                                           # kv heads do not divide 4
    with FakeTensorMode():
        q = _place(torch.zeros((B, S, hq, dh)), mesh, sharding.P("data", None, "model", None))
        k = _place(torch.zeros((B, S, hkv, dh)), mesh, sharding.P("data", None, None, None))
        v = _place(torch.zeros((B, S, hkv, dh)), mesh, sharding.P("data", None, None, None))
        out, coll, _, tc = _trace(lambda: L.attention_core(q, k, v, causal=True))
    assert out.shape == (B, S, hq, dh) and out.placements == (Shard(0), Shard(2))
    whole_q = (B // 2) * S * hq * dh
    whole_scores = (B // 2) * hq * S * S
    assert max(tc.numels) < min(whole_q, whole_scores)
    assert coll == 0
