"""Sharding specs of the LM stack and their DTensor placements (counterpart:
`jax.sharding.PartitionSpec` / `NamedSharding` as the reference's models and
dry run use them).

`P` is a spec: one entry per tensor dim, each a mesh axis name, a tuple of
axis names (the dim sharded over all of them, major axis first) or None
(not sharded).  A spec means on a `torch.distributed.device_mesh.DeviceMesh`
what it means on the reference's `Mesh`: `placements(spec, mesh, ndim)`
gives, for each mesh dim `a`, `Shard(d)` where tensor dim d names `a` and
`Replicate()` otherwise.  DTensor shards a dim named by several mesh dims
in mesh-dim order, which is the reference's major-to-minor order for the
meshes of `launch.mesh` (`("pod", "data", "model")`).

The port's parameters are per layer ("layers.3.attn.wq") where the
reference stacks a leading layer axis, so a model's `param_specs(mode)` is
a flat {state_dict key: P} whose specs are the reference's with that
leading `None` removed; `flat_specs` expands a per-layer tree over the
layers the way `convert.lm_state_from_numpy` names them.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

# the layer lists of the models (the reference's stacked subtrees; the same
# names as `convert.STACKED`)
STACKED = ("layers", "mamba", "enc_layers", "dec_layers")


class P(tuple):
    """A partition spec: `P("model", None)`, `P(("pod", "data"), None)`."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def axes_of(entry) -> tuple:
    """The mesh axes one spec entry names (none for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence, mesh, ndim: int) -> tuple:
    """DTensor placements of a tensor of `ndim` dims under `spec` on `mesh`
    (a spec shorter than ndim leaves the trailing dims unsharded)."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    names = mesh.mesh_dim_names
    out = []
    for a in names:
        dims = [d for d, entry in enumerate(spec) if a in axes_of(entry)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {a!r} shards dims {dims} of spec {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    unknown = {a for entry in spec for a in axes_of(entry)} - set(names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} not on the mesh {names}")
    return tuple(out)


def distribute(params: Mapping[str, torch.Tensor], specs: Mapping[str, P], mesh
               ) -> Dict[str, DTensor]:
    """Each tensor of `params` as a DTensor on `mesh` under its spec.  Every
    rank must hold the same full tensors (the same seed, or one checkpoint):
    each keeps its own shard and nothing is sent."""
    missing = sorted(set(params) - set(specs))
    if missing:
        raise KeyError(f"no spec for {missing[:5]}")
    return {k: distribute_tensor(t, mesh, placements(specs[k], mesh, t.dim()),
                                 src_data_rank=None)
            for k, t in params.items()}


def distribute_model(model, specs: Mapping[str, P], mesh) -> None:
    """Replace the model's parameters, in place, by DTensor parameters under
    `specs` (keeping each one's `requires_grad`)."""
    owners = dict(model.named_modules())
    for key, p in list(model.named_parameters()):
        owner, _, name = key.rpartition(".")
        dt = distribute_tensor(p.detach(), mesh, placements(specs[key], mesh, p.dim()),
                               src_data_rank=None)
        owners[owner].register_parameter(name, torch.nn.Parameter(dt, p.requires_grad))


def flat_specs(tree: Mapping, counts: Mapping[str, int], prefix: str = "") -> Dict[str, P]:
    """{state_dict key: spec} from a tree of specs in which each subtree
    under a name of STACKED is one layer's, repeated over counts[name]
    layers ("layers.0.attn.wq", ...)."""
    out: Dict[str, P] = {}
    for k, v in tree.items():
        if is_spec(v):
            out[prefix + k] = v
        elif k in STACKED and not prefix:
            for i in range(counts[k]):
                out.update(flat_specs(v, {}, f"{k}.{i}."))
        else:
            out.update(flat_specs(v, counts, f"{prefix}{k}."))
    return out


def swap_dp(spec: P, dp, replicate: bool = False) -> P:
    """`spec` with its "data" axis widened to the mesh's data-parallel axes
    `dp` (one name, or a tuple on a multi-pod mesh), or dropped when
    `replicate`."""
    return P(*[(None if replicate else dp) if s == "data" else s for s in spec])


def replicated(x, dims: Sequence[int] = ()):
    """A DTensor with the given tensor dims (all of them by default) made
    whole on every device (each mesh dim that shards one of them becomes
    Replicate); anything else comes back unchanged."""
    if not isinstance(x, DTensor):
        return x
    dims = set(range(x.dim())) if not dims else {d % x.dim() for d in dims}
    new = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
                for p in x.placements)
    return x if new == tuple(x.placements) else x.redistribute(x.device_mesh, new)


def as_dtensor(x, mesh):
    """x as a DTensor on `mesh`: a plain tensor (the same on every device)
    as replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
