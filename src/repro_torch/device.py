"""Device and precision policy of the port (counterpart: none — the JAX
package leaves placement to `jax.default_backend()`).

float32 throughout, as in the reference.  TF32 is switched off for matrix
products and for cuDNN at import: TF32 keeps about three decimal digits,
and the parity of the port's kernels with the reference rests on full
float32 arithmetic.  The LM stack's bf16 products accumulate in float32, as
the reference's do: cuBLAS's reduced-precision bf16 reduction is off too.
"""
from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

DTYPE = torch.float32

# "cuda" is the hand-written-kernel path (the JAX package's "pallas"),
# "torch" the plain tensor path (its "jnp").
BACKENDS = ("cuda", "torch")

DeviceLike = Union[None, str, torch.device]


def require_cuda() -> torch.device:
    """The CUDA device, or a RuntimeError when there is none.  Nothing in
    the port carries on on the CPU unless the caller asked for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")


def resolve_device(device: DeviceLike) -> torch.device:
    """`None` means the CUDA device (raising without one); anything else
    is taken as the caller's explicit choice."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    return dev


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """`None` picks the kernel path on a CUDA device and the plain path on
    the CPU."""
    if backend is None:
        return "cuda" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return backend


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
