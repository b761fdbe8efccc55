"""Random-Fourier-feature density synopsis — the sublinear full-H backend.
Counterpart: `repro/synopses/rff.py`.

Bochner's theorem writes the anisotropic Gaussian kernel
k(x, y) = exp(-1/2 (x-y)^T H^-1 (x-y)) as the expectation of cos features
under its spectral density N(0, H^-1).  Drawing D frequencies

    w_j = L^-T zeta_j,   H = L L^T (Cholesky, float64),  zeta_j ~ N(0, I_d)

gives Cov(w) = H^-1, and with phases b_j ~ U[0, 2 pi) the whole n-row
sample compresses into one D-vector

    z = (2/D) (1/n) sum_i cos(W X_i + b)          (fit: O(n D), once)

so a density is a dot product independent of n:

    f^(p) = norm * (cos(W p + b) . z),  norm = (2 pi)^(-d/2) |H|^(-1/2)

(eval: O(D) per point, the rff_eval kernel on the card).  Densities are not
clipped at zero: the feature noise is zero-mean and the quasi-MC box
integrals cancel it, where clipping would rectify it into a positive bias.

The frequencies and phases come from a `torch.Generator` on the CPU seeded
with the fit's seed, then move to the sample's device, so the same seed
draws the same (W, b) on the CPU and on the card.  They are not
`jax.random`'s draws: the port's fits match the reference's only
statistically, and a reference fit carried across (`to_state` /
`from_state`, `repro_torch.convert.rff_from_numpy`) evaluates the same.

Confidence intervals: splitting the D features into B blocks gives B
unbiased density estimates per point (`block_densities`, rescaled by
D / |block|); the batch-means SE over the blocks' query answers costs
O(m D), the order of the estimate itself (`aqp_multid.qmc_rff_se`).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DTYPE, DeviceLike, resolve_device

from .base import DensitySynopsis, register

# the feature-mean fit is chunked over sample rows so memory stays
# O(chunk * n_features)
FIT_CHUNK = 4096


def _mean_cos(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              chunk: int = FIT_CHUNK) -> torch.Tensor:
    """(1/n) sum_i cos(W x_i + b) over sample rows, in row chunks."""
    n = x.shape[0]
    acc = torch.zeros((w.shape[0],), dtype=w.dtype, device=w.device)
    for start in range(0, n, chunk):
        proj = x[start:start + chunk] @ w.T + b[None, :]          # (c, D)
        acc = acc + torch.sum(torch.cos(proj), dim=0)
    return acc / max(n, 1)


def _block_densities(points: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     z: torch.Tensor, norm: float, n_blocks: int) -> torch.Tensor:
    """Per-feature-block densities, (n_blocks, m): block k rescales its
    partial dot by D / |block| so each block is an unbiased estimate of the
    same density.  Each block's dot is `ops.rff_density` on that block's
    features: the rff_eval kernel on the card, its plain version on the
    CPU."""
    from repro_torch.kernels import ops as kops

    D = w.shape[0]
    db = D // n_blocks
    rescale = D / db
    return torch.stack([
        norm * rescale * kops.rff_density(points, w[k * db:(k + 1) * db],
                                          b[k * db:(k + 1) * db],
                                          z[k * db:(k + 1) * db])
        for k in range(n_blocks)])


@register("rff")
class RFFSynopsis(DensitySynopsis):
    """Fitted RFF state: frequencies W (D, d), phases b (D,) and the scaled
    sample feature mean z (D,), all float32 on one device, so eval is
    f^(p) = norm * (cos(W p + b) . z)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, z: torch.Tensor,
                 norm: float, n_fitted: int, seed: int):
        self.w = w
        self.b = b
        self.z = z
        self.norm = float(norm)
        self.n_fitted = int(n_fitted)
        self.seed = int(seed)
        self.probe_rel_err = float("nan")   # set by the engine's gate

    @property
    def n_features(self) -> int:
        return int(self.w.shape[0])

    @property
    def d(self) -> int:
        return int(self.w.shape[1])

    @classmethod
    def fit(cls, sample, H, n_features: int = 2048, seed: int = 0,
            device: DeviceLike = None) -> "RFFSynopsis":
        """One-shot fit against the retained rows on the sample's device (a
        tensor's own, else `device`, default the CUDA device).  O(n D); the
        result never touches the sample again."""
        dev = sample.device if isinstance(sample, torch.Tensor) else resolve_device(device)
        x = torch.as_tensor(sample, dtype=DTYPE, device=dev)
        if x.dim() == 1:
            x = x[:, None]
        n, d = x.shape
        if isinstance(H, torch.Tensor):
            H = H.detach().cpu().numpy()
        H64 = np.asarray(H, np.float64).reshape(d, d)
        L = np.linalg.cholesky(H64)
        sign, logdet = np.linalg.slogdet(H64)
        if sign <= 0:
            raise ValueError("bandwidth matrix H must be positive definite")
        norm = math.exp(-d / 2.0 * math.log(2.0 * math.pi) - 0.5 * logdet)
        gen = torch.Generator().manual_seed(int(seed))
        zeta = torch.randn((n_features, d), generator=gen, dtype=DTYPE)
        b = torch.rand((n_features,), generator=gen, dtype=DTYPE) * (2.0 * math.pi)
        # w_j = L^-T zeta_j  =>  Cov(w) = H^-1 (anisotropy honored)
        w = np.linalg.solve(L.T, zeta.numpy().astype(np.float64).T).T
        w = torch.as_tensor(np.ascontiguousarray(w, np.float32), device=dev)
        b = b.to(dev)
        z = (2.0 / n_features) * _mean_cos(x, w, b)
        out = cls(w=w, b=b, z=z, norm=norm, n_fitted=n, seed=seed)
        out.n_source = n
        return out

    def _points(self, points) -> torch.Tensor:
        p = torch.as_tensor(points, dtype=DTYPE, device=self.w.device)
        return (p[:, None] if p.dim() == 1 else p).contiguous()

    def eval_batch(self, points) -> torch.Tensor:
        """Batched densities f^(points), (m,): O(m D), through
        `ops.rff_density` (the rff_eval kernel on the card)."""
        from repro_torch.kernels import ops as kops

        return self.norm * kops.rff_density(self._points(points), self.w,
                                            self.b, self.z)

    def block_densities(self, points, n_blocks: int = 8) -> torch.Tensor:
        """(n_blocks, m) per-feature-block density replicates, the CI
        pass's input."""
        return _block_densities(self._points(points), self.w, self.b, self.z,
                                self.norm, n_blocks)

    @property
    def nbytes(self) -> int:
        return sum(int(t.nbytes) for t in (self.w, self.b, self.z))

    def error_metadata(self) -> Dict[str, object]:
        return {"backend": "rff", "degraded": bool(self.degraded),
                "n_features": self.n_features,
                "probe_rel_err": float(self.probe_rel_err)}

    # -- snapshots -------------------------------------------------------------

    def to_state(self) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
        arrays = {k: getattr(self, k).detach().cpu().numpy() for k in ("w", "b", "z")}
        meta = {"backend": "rff", "norm": float(self.norm),
                "n_fitted": int(self.n_fitted), "seed": int(self.seed),
                "degraded": bool(self.degraded),
                "probe_rel_err": float(self.probe_rel_err)}
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: Dict[str, np.ndarray], meta: Dict[str, object],
                   device: DeviceLike = None) -> "RFFSynopsis":
        """The synopsis from `to_state()`'s arrays and meta — the port's or
        the reference's (`repro.synopses.rff.RFFSynopsis.to_state`) — on
        `device` (default: the CUDA device)."""
        dev = resolve_device(device)

        def t(k):
            return torch.tensor(np.ascontiguousarray(arrays[k], np.float32), device=dev)

        out = cls(w=t("w"), b=t("b"), z=t("z"), norm=float(meta["norm"]),
                  n_fitted=int(meta["n_fitted"]), seed=int(meta["seed"]))
        out.degraded = bool(meta.get("degraded", False))
        out.probe_rel_err = float(meta.get("probe_rel_err", float("nan")))
        return out
