"""Kernel density estimation (paper §4.2, eqs. 3-8).
Counterpart: `repro/core/kde.py`.

`kde_eval`   — scalar-h estimator f^(x, h) (eq. 3), any d, five kernels.
`kde_eval_H` — full-matrix estimator f^(x, H) (eq. 6).

Both are the O(m*n) direct evaluation of §2.2, chunked over evaluation
points so memory stays O(chunk * n).  On a CUDA tensor the Gaussian
`kde_eval` runs in the kde_eval kernel (`kernels/ops.kde_eval`); the
compact-support kernels and `kde_eval_H` are plain tensor code, as in the
reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.device import DTYPE, DeviceLike, resolve_backend, resolve_device

KDE_CHUNK = 256     # evaluation points per chunk (the reference's default)


def _rows(t, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(t, dtype=DTYPE, device=device)
    return t[:, None] if t.dim() == 1 else t


def _chunked_eval(points: torch.Tensor, x: torch.Tensor, kfun, chunk: int
                  ) -> torch.Tensor:
    """mean over data of kfun(p - x), over chunks of evaluation points."""
    parts = [torch.zeros((0,), dtype=x.dtype, device=x.device)]
    for start in range(0, points.shape[0], chunk):
        diff = points[start:start + chunk, None, :] - x[None, :, :]   # (c, n, d)
        parts.append(torch.mean(kfun(diff), dim=1))
    return torch.cat(parts)


# --- product-kernel profiles (paper §4.2: "Other commonly used kernel
# functions are Epanechnikov, uniform, triangular, biweight") -------------
# Each maps |u| <= ... per dimension; constants normalise to integrate to 1.

def _profiles(kind: str, d: int, h: torch.Tensor):
    if kind == "gaussian":
        ln = -d / 2.0 * math.log(2.0 * math.pi) - d * torch.log(h)
        return lambda diff: torch.exp(ln - 0.5 * torch.sum((diff / h) ** 2, dim=-1))
    per_dim = {
        "epanechnikov": (0.75, lambda u: torch.clamp_min(1.0 - u * u, 0.0)),
        "biweight": (15.0 / 16.0, lambda u: torch.clamp_min(1.0 - u * u, 0.0) ** 2),
        "triangular": (1.0, lambda u: torch.clamp_min(1.0 - torch.abs(u), 0.0)),
        "uniform": (0.5, lambda u: (torch.abs(u) <= 1.0).to(DTYPE)),
    }
    if kind not in per_dim:
        raise ValueError(f"unknown kernel kind {kind!r}; expected 'gaussian' "
                         f"or one of {sorted(per_dim)}")
    cst, prof = per_dim[kind]

    def kfun(diff):
        u = diff / h
        return torch.prod(cst * prof(u), dim=-1) / h ** d

    return kfun


def kde_eval(points, x, h, chunk: int = KDE_CHUNK, backend: Optional[str] = None,
             kind: str = "gaussian", device: DeviceLike = None) -> torch.Tensor:
    """f^(points; x, h) per eq. (3) on `device` (default: the CUDA device).
    kind selects the kernel function: Gaussian (eq. 5, default) or the
    compact-support kernels of §4.2 (Epanechnikov / biweight / triangular /
    uniform, product form).
    backend "cuda" (None's choice on a CUDA device for the Gaussian) runs
    the kde_eval kernel, which implements the Gaussian only; None keeps the
    compact kernels on the plain path.

    points: (m, d) or (m,); x: (n, d) or (n,); returns (m,)."""
    dev = resolve_device(device)
    x = _rows(x, dev)
    points = _rows(points, dev)
    h = torch.as_tensor(h, dtype=DTYPE, device=x.device).reshape(())
    if backend is None and kind != "gaussian":
        backend = "torch"
    if resolve_backend(backend, x.device) == "cuda":
        if kind != "gaussian":
            raise ValueError(f"the kde_eval kernel implements the Gaussian, "
                             f"not {kind!r}")
        from repro_torch.kernels import ops as kops
        return kops.kde_eval(points, x, h)
    return _chunked_eval(points, x, _profiles(kind, x.shape[1], h), chunk)


def kde_eval_H(points, x, H, chunk: Optional[int] = None,
               device: DeviceLike = None) -> torch.Tensor:
    """f^(points; x, H) per eq. (6): n^-1 |H|^-1/2 sum K(H^-1/2 (x - X_i)),
    on `device` (default: the CUDA device).  The quadratic form contracts
    v = diff H^-1 before the second dot."""
    dev = resolve_device(device)
    x = _rows(x, dev)
    points = _rows(points, dev)
    H = torch.as_tensor(H, dtype=DTYPE, device=dev)
    d = x.shape[1]
    H_inv = torch.linalg.inv(H)
    log_norm = -d / 2.0 * math.log(2.0 * math.pi) - 0.5 * torch.linalg.slogdet(H)[1]

    def kfun(diff):
        quad = 0.5 * torch.sum((diff @ H_inv) * diff, dim=-1)
        return torch.exp(log_norm - quad)

    return _chunked_eval(points, x, kfun, KDE_CHUNK if chunk is None else chunk)


def silverman_h(x: torch.Tensor) -> torch.Tensor:
    """Rule-of-thumb bandwidth (paper §2.3 'first class' selector), 1-D."""
    n = x.shape[0]
    std = torch.std(x, correction=1)
    iqr = torch.quantile(x, 0.75) - torch.quantile(x, 0.25)
    a = torch.minimum(std, iqr / 1.349)
    return 0.9 * a * n ** (-0.2)
