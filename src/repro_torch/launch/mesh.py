"""Device meshes of the LM stack (counterpart: `repro/launch/mesh.py`), as
`torch.distributed.device_mesh.DeviceMesh`es with the reference's axis
names: ("data", "model"), and ("pod", "data", "model") across pods.

`make_host_mesh` spans the ranks of the process group that exists (on the
card, `core.distributed.init_group`'s NCCL group, one rank a card).
`make_production_mesh` and `make_mesh_from_spec` span a *fake* process
group of the mesh's size (`torch.testing._internal.distributed.fake_pg`):
its collectives return at once and move nothing, which is what the dry run
needs to trace a step of 256 or 512 ranks in one process.  It is the
counterpart of the reference's placeholder devices, and needs no
environment variable (the reference sets `XLA_FLAGS` before jax starts).
Only one default group can exist in a process: these two start one if none
exists, and refuse a group of another size.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist


def _fake_group(world: int) -> None:
    """The default process group as a fake group of `world` ranks (this
    process rank 0), started here unless one of that size exists."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks exists; "
                               f"the mesh needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _mesh(shape: Sequence[int], axes: Sequence[str], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks with a leading 'pod'
    axis; over a fake group of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _fake_group(math.prod(shape))
    return _mesh(shape, axes, device_type)


def make_mesh_from_spec(spec: str, device_type: str = "cuda"):
    """'16,16' -> (data, model); '2,16,16' -> (pod, data, model); over a
    fake group of the mesh's size."""
    shape = tuple(int(x) for x in spec.split(","))
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"a mesh of 1 to 3 axes, not {spec!r}")
    axes = ("pod", "data", "model")[-len(shape):]
    _fake_group(math.prod(shape))
    return _mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A (data, model) mesh over the ranks of the existing process group,
    which must hold exactly data * model ranks."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one first (core.distributed.init_group)")
    n = dist.get_world_size()
    if data * model != n:
        raise ValueError(f"a {data} x {model} mesh over {n} ranks")
    return _mesh((data, model), ("data", "model"), device_type)


def dp_axes(mesh) -> tuple:
    """Mesh axes that carry data parallelism."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_size(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("model"))


def mesh_shape(mesh) -> dict:
    """{axis name: size}, the reference's `dict(mesh.shape)`."""
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}
