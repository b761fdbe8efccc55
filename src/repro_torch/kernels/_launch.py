"""Argument checks, error handling and launch counters shared by the
kernel launchers (counterpart: none; the Pallas calls needed no binding)."""
from __future__ import annotations

import ctypes
import numbers
import threading
from functools import lru_cache
from typing import Optional, Sequence

import torch

GRID_Y_MAX = 65535
SMEM_MAX = 48 * 1024      # static-limit dynamic shared memory per block


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: Sequence[Optional[int]],
                 device: Optional[torch.device] = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` whose shape
    matches `shape` (None matches any extent) on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != e for s, e in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple('*' if s is None else s for s in shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tile(value: int, name: str) -> int:
    """A block dimension: a multiple of 32 in [32, 1024]."""
    value = int(value)
    if value % 32 or not 32 <= value <= 1024:
        raise ValueError(f"{name}={value} must be a multiple of 32 in "
                         f"[32, 1024]")
    return value


def device_scalars(values, device: torch.device) -> torch.Tensor:
    """A contiguous (len(values),) float32 tensor on `device` from Python
    numbers or one-element tensors (tensors already there are not synced
    to the host), for a kernel that reads its constants from device
    memory."""
    return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=device).reshape(())
                        for v in values])


def scalar_arg(value, name: str, device: torch.device) -> torch.Tensor:
    """A kernel constant as a 0-d float32 tensor on `device`, whose pointer
    the kernel reads: a one-element tensor is moved there (no copy when it
    already is float32 there, and never synced to the host), a Python
    number is copied there.  Raises before any launch on anything else."""
    if isinstance(value, torch.Tensor):
        if value.numel() != 1:
            raise ValueError(f"{name} must have one element, got shape "
                             f"{tuple(value.shape)}")
        return value.to(device=device, dtype=torch.float32).reshape(())
    if isinstance(value, bool) or not isinstance(value, numbers.Real):
        raise TypeError(f"{name} must be a number or a one-element tensor, "
                        f"got {type(value).__name__}")
    return torch.tensor(float(value), dtype=torch.float32, device=device)


@lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def point_range(n: int, q_tiles: int, sms: int, blocks_per_sm: int, waves: int,
                tile: int) -> int:
    """Sample points per block of a kernel whose grid is `q_tiles` query tiles
    times point ranges of equal cost: a multiple of 32 in [32, tile], the
    fewest that keep the grid within `waves` waves of the `blocks_per_sm`
    blocks that each of the `sms` SMs keeps resident (a block more would
    open a wave that runs nearly empty)."""
    ranges = max(1, waves * sms * max(blocks_per_sm, 1) // max(q_tiles, 1))
    pts = -(-(-(-n // ranges)) // 32) * 32
    return max(32, min(pts, tile // 32 * 32))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, for the launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(err: int, kernel: str) -> None:
    """The launcher returns cudaGetLastError() after its launches."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t "
                           f"{err}")


class LaunchCounter:
    """A plain-integer count of a kernel's launches, bumped by its launcher
    right where the launch happens and nowhere else; a run reads it to show
    that its path went through the kernel."""

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.value = 0               # guarded-by: _lock (writes)
        self._lock = threading.Lock()

    def inc(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0
