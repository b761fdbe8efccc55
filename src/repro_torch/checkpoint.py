"""Atomic, keep-k, optionally asynchronous checkpoints of flat array dicts.
Counterpart: `repro/checkpoint/checkpoint.py` (`CheckpointManager`), whose
on-disk format this keeps, so either package reads the other's snapshots:

    <dir>/step_00000042/arrays.npz      one array per key
    <dir>/step_00000042/manifest.json   {"step": 42, "extra": {...}}

A write goes to `<dir>/tmp.<step>` and is moved into place with
`os.replace`, so a crash mid-write never corrupts the latest completed step,
and `latest_step()` sees completed steps only.  bfloat16 arrays, which
numpy cannot hold, are stored as their uint16 bits under a `.bf16` key and
folded back on restore.

The port keeps the flat-dict half (`restore_flat`, what
`TelemetryStore.save` / `load` use).  Nested dicts are flattened with "/"
keys, as the reference's pytree paths are; the pytree
`restore(template, shardings)` belongs with the model stack.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

BF16 = ".bf16"


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a/w": array, ...} from nested mappings of tensors or arrays, on the
    host; a bfloat16 tensor becomes its uint16 bits under a `.bf16` key."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        elif isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
            flat[path + BF16] = value.detach().cpu().view(torch.int16).numpy().view(np.uint16)
        else:
            flat[path] = _host(value)
    return flat


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

    def save(self, step: int, tree: Mapping, extra: Optional[Dict] = None) -> None:
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
