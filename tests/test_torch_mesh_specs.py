"""The port's meshes and sharding specs against the reference's: every
parameter spec of the ten architectures (published and smoke configs,
train and serve) equal to the reference's `param_specs(mode)` leaf with the
stacked layer axis removed; cache, batch, dp-widened and optimiser specs
equal; each parameter's DTensor shard on a fake 4 x 2 mesh of the shape
the reference's `NamedSharding(mesh, spec).shard_shape` gives on 8
placeholder devices; and the meshes' axis names, shapes, `dp_axes` and
`tp_size` equal.  Exact equality throughout.

The reference's placeholder devices need `XLA_FLAGS` before jax starts, so
its side runs in a process of its own; the port's fake process groups are
started and destroyed here, one at a time.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import api as ref_api
from repro.optim import adamw as ref_adamw
from repro_torch import sharding
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
STACKED = sharding.STACKED
CONFIGS = [(a, smoke) for a in ARCH_IDS for smoke in (False, True)]


def ref_flat(tree, prefix=""):
    """The reference's spec tree by the port's state_dict keys: a stacked
    subtree's leaf P(None, *s) gives P(*s) for each layer."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, JP):
            out[prefix + k] = tuple(v)
        elif k in STACKED and not prefix:
            for path, spec in ref_flat(v, "").items():
                assert spec[0] is None, (k, path, spec)
                out[f"{k}.*.{path}"] = spec[1:]
        else:
            out.update(ref_flat(v, f"{prefix}{k}."))
    return out


def port_by_layer_pattern(specs: dict) -> dict:
    """The port's flat specs with the layer index replaced by '*', checking
    that every layer holds the same spec."""
    out = {}
    for k, s in specs.items():
        parts = k.split(".")
        if parts[0] in STACKED and parts[1].isdigit():
            key = ".".join([parts[0], "*"] + parts[2:])
            assert out.setdefault(key, tuple(s)) == tuple(s), k
        else:
            out[k] = tuple(s)
    return out


@pytest.fixture(scope="module")
def port_models():
    """The port's models of every config, built on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return {(a, smoke): api.build_model(get_config(a, smoke), device="cpu")
                for a, smoke in CONFIGS}


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch,smoke", CONFIGS)
def test_param_specs_equal_reference(port_models, arch, smoke, mode):
    model = port_models[(arch, smoke)]
    mine = model.param_specs(mode)
    assert sorted(mine) == sorted(k for k, _ in model.named_parameters())
    assert all(isinstance(s, sharding.P) for s in mine.values())
    n = {"layers": 0, "mamba": 0, "enc_layers": 0, "dec_layers": 0}
    for k in mine:
        if k.split(".")[0] in n:
            n[k.split(".")[0]] = max(n[k.split(".")[0]], int(k.split(".")[1]) + 1)
    ref = ref_build_model(ref_get_config(arch, smoke))
    assert port_by_layer_pattern(mine) == ref_flat(ref.param_specs(mode))
    cfg = get_config(arch, smoke)
    for name, count in n.items():
        if count:
            assert count == {"enc_layers": cfg.n_enc_layers}.get(name, cfg.n_layers)


@pytest.mark.parametrize("dp", [("data",), ("pod", "data")])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dp_cache_batch_and_state_specs_equal_reference(port_models, arch, dp):
    model = port_models[(arch, True)]
    ref = ref_build_model(ref_get_config(arch, True))
    assert {k: tuple(s) for k, s in model.cache_specs().items()} == \
        {k: tuple(s) for k, s in ref.cache_specs().items()}
    for bs in (0, 1, 128):
        assert {k: tuple(s) for k, s in api.cache_specs_with_dp(model, dp, bs).items()} == \
            {k: tuple(s) for k, s in ref_api.cache_specs_with_dp(ref, dp, bs).items()}
    assert {k: tuple(s) for k, s in api.batch_specs(get_config(arch, True), dp).items()} == \
        {k: tuple(s) for k, s in ref_api.batch_specs(ref_get_config(arch, True), dp).items()}
    for mode in ("train", "serve"):
        mine = api.param_specs_with_dp(model, mode, dp)
        theirs = ref_api.param_specs_with_dp(ref, mode, dp)
        assert port_by_layer_pattern(mine) == ref_flat(theirs)
        st, ref_st = adamw.state_specs(mine), ref_adamw.state_specs(theirs)
        assert port_by_layer_pattern(st.m) == ref_flat(ref_st.m)
        assert port_by_layer_pattern(st.v) == ref_flat(ref_st.v)
        assert tuple(st.count) == tuple(ref_st.count) == ()


def test_placements_follow_the_spec():
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    R, S = sharding.Replicate(), sharding.Shard
    assert sharding.placements(sharding.P(("pod", "data"), None, "model"), Mesh, 3) == \
        (S(0), S(0), S(2))
    assert sharding.placements(sharding.P(None, "model"), Mesh, 3) == (R, R, S(1))
    with pytest.raises(ValueError):
        sharding.placements(sharding.P("model", "model"), Mesh, 2)
    with pytest.raises(ValueError):
        sharding.placements(sharding.P("expert"), Mesh, 1)


REF_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ARCH_IDS, get_config
from repro.launch import mesh as M
from repro.models import build_model, param_structs

out = {"meshes": {}, "shards": {}}
for name, mesh in (("16,16", M.make_production_mesh()),
                   ("2,16,16", M.make_production_mesh(multi_pod=True)),
                   ("4,2", M.make_mesh_from_spec("4,2")),
                   ("2,2,2", M.make_mesh_from_spec("2,2,2"))):
    out["meshes"][name] = {"axes": list(mesh.axis_names), "shape": dict(mesh.shape),
                           "dp": list(M.dp_axes(mesh)), "tp": M.tp_size(mesh)}
mesh = M.make_mesh_from_spec("4,2")
for arch in ARCH_IDS:
    for smoke in (False, True):
        cfg = get_config(arch, smoke)
        model = build_model(cfg)
        structs = param_structs(cfg)
        for mode in ("train", "serve"):
            specs = model.param_specs(mode)
            leaves = jax.tree_util.tree_leaves_with_path(structs)
            spec_of = dict(jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda s: isinstance(s, P)))
            rows = {}
            for path, leaf in leaves:
                key = "/".join(str(getattr(p, "key", p)) for p in path)
                rows[key] = [list(leaf.shape),
                             list(NamedSharding(mesh, spec_of[path]).shard_shape(leaf.shape))]
            out["shards"][f"{arch}|{smoke}|{mode}"] = rows
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_CODE], capture_output=True, text=True,
                       timeout=240, env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture
def fresh_group():
    """No default process group before or after the test."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("spec", ["16,16", "2,16,16", "4,2", "2,2,2"])
def test_meshes_equal_reference(reference, fresh_group, spec):
    if spec == "16,16":
        mesh = tmesh.make_production_mesh(device_type="cpu")
    elif spec == "2,16,16":
        mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    else:
        mesh = tmesh.make_mesh_from_spec(spec, device_type="cpu")
    want = reference["meshes"][spec]
    assert list(mesh.mesh_dim_names) == want["axes"]
    assert tmesh.mesh_shape(mesh) == want["shape"]
    assert list(tmesh.dp_axes(mesh)) == want["dp"]
    assert tmesh.tp_size(mesh) == want["tp"]
    assert dist.get_backend() == "fake" and dist.get_world_size() == mesh.size()


def test_fake_group_refuses_another_size(fresh_group):
    """`fake_pg` is torch-internal: pin what the dry run rests on.  Its
    collectives return at once and leave the tensors as they were; a
    second mesh of another size is refused."""
    tmesh.make_mesh_from_spec("2,2", device_type="cpu")
    t = torch.arange(4.0)
    dist.all_reduce(t)
    assert torch.equal(t, torch.arange(4.0))
    dist.broadcast(t, 0)
    assert torch.equal(t, torch.arange(4.0))
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        tmesh.make_mesh_from_spec("4,2", device_type="cpu")


def test_host_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_host_mesh(1, 1, device_type="cpu")


@pytest.mark.parametrize("mode", ["train", "serve"])
def test_shards_on_4x2_equal_reference(reference, port_models, fresh_group, mode):
    """Every parameter's DTensor shard (rank 0's, on fake tensors) has the
    shape of the reference's shard of the same leaf, layer axis removed."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import convert

    mesh = tmesh.make_mesh_from_spec("4,2", device_type="cpu")
    for arch, smoke in CONFIGS:
        rows = reference["shards"][f"{arch}|{smoke}|{mode}"]
        model = port_models[(arch, smoke)]
        specs = model.param_specs(mode)
        with FakeTensorMode(allow_non_fake_inputs=True):
            shards = {k: sharding.distribute({k: p.detach()}, specs, mesh)[k]
                      for k, p in model.named_parameters()}
        structs = api.param_structs(get_config(arch, smoke))
        assert {k: s for k, (s, _) in structs.items()} == \
            {k: tuple(p.shape) for k, p in model.named_parameters()}
        seen = set()
        for key, (shape, shard) in rows.items():
            parts = key.split("/")
            if parts[0] in STACKED:
                for i in range(shape[0]):
                    k = ".".join([parts[0], str(i)] + parts[1:])
                    assert list(shards[k].shape) == shape[1:], k
                    assert list(shards[k]._local_tensor.shape) == shard[1:], (arch, k)
                    seen.add(k)
            else:
                k = ".".join(parts)
                assert list(shards[k].shape) == shape, k
                assert list(shards[k]._local_tensor.shape) == shard, (arch, k)
                seen.add(k)
        assert seen == set(shards), (arch, sorted(set(shards) - seen)[:3])
        assert convert.STACKED == STACKED


def test_shard_hint_redistributes_dtensors_only(fresh_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.layers import shard_hint
    plain = torch.ones(4, 4)
    assert shard_hint(plain, sharding.P("data", None)) is plain
    mesh = tmesh.make_mesh_from_spec("2,2", device_type="cpu")
    with FakeTensorMode():
        x = distribute_tensor(torch.zeros(8, 4), mesh, sharding.placements(
            sharding.P(None, None), mesh, 2), src_data_rank=None)
        y = shard_hint(x, sharding.P("data", "model"))
    assert tuple(y.placements) == (sharding.Shard(0), sharding.Shard(1))
    assert tuple(y._local_tensor.shape) == (4, 2)
    assert shard_hint(x, None) is x
