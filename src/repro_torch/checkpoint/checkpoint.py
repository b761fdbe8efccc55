"""Atomic, keep-k, optionally asynchronous checkpoints of tensor trees.
Counterpart: `repro/checkpoint/checkpoint.py` (`CheckpointManager`), whose
on-disk format this keeps, so either package reads the other's snapshots:

    <dir>/step_00000042/arrays.npz      one array per key
    <dir>/step_00000042/manifest.json   {"step": 42, "extra": {...}}

A write goes to `<dir>/tmp.<step>` and is moved into place with
`os.replace`, so a crash mid-write never corrupts the latest completed step,
and `latest_step()` sees completed steps only.  bfloat16 arrays, which
numpy cannot hold, are stored as their uint16 bits under a `.bf16` key and
folded back on restore.

A tree is nested mappings, tuples, lists and NamedTuples of tensors (a
saved tree may also hold numpy arrays), keyed by path as the reference's
pytree paths are: a
mapping's key, a tuple's or a list's index, a NamedTuple's field as
".name" (jax's `GetAttrKey`), joined by "/".  So a training state
`(params, AdamWState(m, v, count))` is stored under `0/layers/attn/wq`,
`1/.m/layers/attn/wq`, `1/.count`, the reference's own keys.

`restore(step, template)` reads a step into the template's structure, each
leaf in the template leaf's dtype and on its device; `restore_flat(step)`
reads one without a template (what `TelemetryStore.save` / `load` use).

On a device mesh the leaves are DTensors.  `save` gathers each one whole
(a collective: every rank of the mesh calls it) and writes the whole
tensors, so a checkpoint does not depend on the mesh it was written on.
`restore(step, template, shardings)` places each leaf on a mesh:
`shardings` is a tree of `(mesh, placements)` in the template's structure,
which may be another mesh than the one that wrote the step (elastic
restore); without it a DTensor template leaf comes back on its own mesh
and placements.  Each rank keeps its own shard of the whole tensor it
read, so nothing is sent.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

BF16 = ".bf16"


def _whole(value):
    """A DTensor gathered whole (every rank must call this); anything else
    as it is."""
    return value.full_tensor() if isinstance(value, DTensor) else value


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _items(tree) -> Iterator[Tuple[str, Any]]:
    """(path component, child) of one tree node; nothing for a leaf."""
    if isinstance(tree, Mapping):
        return ((str(k), v) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ((f".{f}", getattr(tree, f)) for f in tree._fields)
    if isinstance(tree, (tuple, list)):
        return ((str(i), v) for i, v in enumerate(tree))
    return iter(())


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (Mapping, tuple, list))


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a/w": array, ...} from a tree of tensors or arrays, on the host; a
    bfloat16 tensor becomes its uint16 bits under a `.bf16` key."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in _items(tree):
        path = f"{prefix}{key}"
        value = _whole(value)
        if not _is_leaf(value):
            flat.update(_flatten(value, path + "/"))
        elif isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
            flat[path + BF16] = value.detach().cpu().view(torch.int16).numpy().view(np.uint16)
        else:
            flat[path] = _host(value)
    return flat


def _leaf_from(arrays: Mapping[str, np.ndarray], path: str, like: torch.Tensor,
               placed=None):
    """The stored leaf at `path` as a tensor of `like`'s dtype on its
    device; as a DTensor on `placed` = (mesh, placements), or on `like`'s
    own mesh and placements when it is a DTensor."""
    if path + BF16 in arrays:
        t = torch.from_numpy(np.array(arrays[path + BF16]).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arrays[path]))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {path!r} has shape {tuple(t.shape)}, the "
                         f"template {tuple(like.shape)}")
    t = t.to(device=like.device, dtype=like.dtype)
    if placed is None and isinstance(like, DTensor):
        placed = (like.device_mesh, like.placements)
    if placed is None:
        return t
    mesh, placements = placed
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _is_placed(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2 and not hasattr(x, "_fields")
            and hasattr(x[0], "mesh_dim_names"))


def _unflatten_into(template, arrays: Mapping[str, np.ndarray], prefix: str = "",
                    shardings=None):
    if _is_leaf(template):
        return _leaf_from(arrays, prefix[:-1], template, shardings)
    placed = dict(_items(shardings)) if shardings is not None else {}
    children = [(k, _unflatten_into(v, arrays, f"{prefix}{k}/", _sub(placed, k)))
                for k, v in _items(template)]
    if isinstance(template, Mapping):
        return type(template)((k, v) for k, v in zip(template, (c for _, c in children)))
    values = [c for _, c in children]
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*values)
    return type(template)(values)


def _sub(placed: dict, key: str):
    """The shardings subtree under `key` (None where there is none)."""
    sub = placed.get(key)
    return sub if sub is None or _is_placed(sub) or not _is_leaf(sub) else None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=1) if async_save else None)
        self._pending: Optional[Future] = None

    # -- write ---------------------------------------------------------------
    def _write(self, step: int, flat: Dict[str, np.ndarray], extra: Dict) -> None:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "extra": extra}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """Copy `tree` to the host now, write it now or, with `async_save`,
        on the manager's thread (at most one write outstanding)."""
        self.wait()
        flat = _flatten(tree)
        extra = extra or {}
        if self._pool is None:
            self._write(step, flat, extra)
        else:
            self._pending = self._pool.submit(self._write, step, flat, extra)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self):
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_flat(self, step: int) -> Tuple[Dict[str, object], Dict]:
        """(flat {key: array}, extra) of one step; a `.bf16` key comes back
        under its own name as a torch.bfloat16 tensor (numpy has no
        bfloat16), every other key as a numpy array."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat: Dict[str, object] = {k: z[k] for k in z.files}
        for key in [k for k in flat if k.endswith(BF16)]:
            bits = np.ascontiguousarray(flat.pop(key)).view(np.int16)
            flat[key[: -len(BF16)]] = torch.from_numpy(bits).view(torch.bfloat16)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return flat, manifest["extra"]

    def restore(self, step: int, template: Any, shardings: Any = None) -> Tuple[Any, Dict]:
        """(tree, extra) of one step, in the structure of `template` (a
        tree of tensors), each leaf in the template leaf's dtype and on its
        device.  `shardings`: a tree of (mesh, placements) in the
        template's structure; each leaf is distributed onto its mesh (any
        mesh: the elastic restore)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return _unflatten_into(template, arrays, shardings=shardings), manifest["extra"]
