"""The `"exact"` density backend: eq. 6 through `kde_eval_H`.
Counterpart: `repro/synopses/exact.py`.

The ground truth the sublinear backends are gated against.  The engine's
exact query path does not route through this class: `batch_query_qmc`
evaluates the density itself (or fuses it into the qmc_reduce kernel).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.kde import kde_eval_H
from repro_torch.device import DTYPE, DeviceLike, resolve_device

from .base import DensitySynopsis, register


@register("exact")
class ExactSynopsis(DensitySynopsis):
    """The retained sample and the full bandwidth matrix; eval is eq. 6."""

    def __init__(self, x: torch.Tensor, H: torch.Tensor):
        self.x = x if x.dim() == 2 else x[:, None]
        self.H = H
        self.n_fitted = int(self.x.shape[0])

    @classmethod
    def fit(cls, sample, H, device: DeviceLike = None, **kwargs) -> "ExactSynopsis":
        dev = sample.device if isinstance(sample, torch.Tensor) else resolve_device(device)
        return cls(torch.as_tensor(sample, dtype=DTYPE, device=dev),
                   torch.as_tensor(H, dtype=DTYPE, device=dev))

    def eval_batch(self, points) -> torch.Tensor:
        return kde_eval_H(points, self.x, self.H, device=self.x.device)

    @property
    def nbytes(self) -> int:
        return int(self.x.nbytes) + int(self.H.nbytes)

    def to_state(self) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
        return ({"x": self.x.cpu().numpy(), "H": self.H.cpu().numpy()},
                {"backend": "exact", "n_fitted": int(self.n_fitted),
                 "degraded": bool(self.degraded)})

    @classmethod
    def from_state(cls, arrays: Dict[str, np.ndarray], meta: Dict[str, object],
                   device: DeviceLike = None) -> "ExactSynopsis":
        dev = resolve_device(device)
        out = cls(torch.tensor(np.asarray(arrays["x"]), dtype=DTYPE, device=dev),
                  torch.tensor(np.asarray(arrays["H"]), dtype=DTYPE, device=dev))
        out.n_fitted = int(meta.get("n_fitted", out.n_fitted))
        out.degraded = bool(meta.get("degraded", False))
        return out

    def error_metadata(self) -> Dict[str, object]:
        return {"backend": "exact", "degraded": False, "exact": True}
