"""LSCV bandwidth selectors (paper §4.4) with the §4.5 reformulation.
Counterpart: `repro/core/lscv.py`.

LSCV_h  — scalar bandwidth h, any d: brute-force minimisation of g(h) (eq. 24)
          on a 150-point grid over Z(h0) = [h0/4, 4*h0] (eq. 29), by
          (a) the paper's §4.5 two-phase scheme: all S(v) = v^T Sigma^-1 v
              once, reused for every h                        [store_s=True]
          (b) a streaming fused scheme that folds each (chunk x n) slab of
              quadratic forms into the sums of the whole grid [store_s=False]
          (c) on backend "cuda", the same two phases in the sv_precompute
              and lscv_grid kernels (`kernels/ops.lscv_grid_sums`).
LSCV_H  — full SPD bandwidth matrix: Nelder-Mead over a log-Cholesky
          parametrisation of H (SPD by construction), objective g(H) (eq. 32)
          from the fused quadratic-form + T_H + reduce pass of §6.3 (the
          gh_fused kernel on backend "cuda").

The small linear algebra (det, inv, cholesky, eigh of (d, d) matrices) runs
in float32 with torch.linalg on the fit's device, as the reference runs it
in float32 with jnp.linalg.  `multi_start > 1` draws its jitter from a
seeded torch.Generator: the reference's jax.random draws cannot be
reproduced, but start 0 is H_start in both.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DTYPE, DeviceLike, resolve_backend, resolve_device
from repro_torch.kernels import ref as kref

from . import gaussian as G
from .nelder_mead import minimize as nm_minimize
from .reductions import (pairwise_quadform_chunks, pairwise_quadform_reduce,
                         pairwise_sv_matrix)

N_H_DEFAULT = 150  # paper §7.1: objective evaluated at a fixed 150 grid points


# ---------------------------------------------------------------------------
# Covariance (eqs. 20-23), in the two-sum form the paper uses for reductions.
# ---------------------------------------------------------------------------

def _recip32(v: int) -> float:
    """1/v as XLA folds a division by the constant v: float32(1) / float32(v)."""
    return float(np.float32(1.0) / np.float32(v))


def covariance(x: torch.Tensor) -> torch.Tensor:
    """x: (n, d) row per sample.  Returns the (d, d) Sigma of eqs. (22)/(23).

    Formed as XLA compiles it inside the reference's jitted `lscv_h` and
    `lscv_H`: each division is a multiplication by a float32 reciprocal, and
    the difference is one fused multiply-add, s2 c1 - fl(s1 s1^T c2) rounded
    once (here in float64, exact for the float32 product).  On a constant
    column the two terms then differ by 2^-23 instead of cancelling to 0, so
    the fit sees the covariance the reference's fit sees."""
    n = x.shape[0]
    s1 = torch.sum(x, dim=0)                      # (d,)
    s2 = x.T @ x                                  # (d, d) sum of outer products
    second = torch.outer(s1, s1) * _recip32(n * (n - 1))
    return (s2.double() * _recip32(n - 1) - second.double()).to(x.dtype)


def _inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a small float32 matrix that does not raise on a singular
    one: LU without the singularity check, so a zero pivot gives the inf /
    NaN entries XLA's float32 `inv` gives.  Contiguous (cuSOLVER returns it
    column-major, and the launchers take only contiguous matrices)."""
    return torch.linalg.inv_ex(a).inverse.contiguous()


def h0_start(n: int, d: int) -> float:
    """eq. (28).  Constants exactly as printed in the paper; for d=1 this
    reduces to Silverman's (4/3)^(1/5) n^(-1/5)."""
    rk_over_mu2 = 1.0 / (2.0 ** d * math.pi ** (d / 2.0) * d ** 2)
    r_f2 = d * (d + 2.0) / (2.0 ** (d + 2) * math.pi ** (d / 2.0))
    return float((rk_over_mu2 / (r_f2 * n)) ** (1.0 / (d + 4)))


def h_grid_for(n: int, d: int, n_h: int = N_H_DEFAULT,
               device: DeviceLike = None) -> torch.Tensor:
    """Z(h0) = [h0/4, 4 h0] (eq. 29), n_h uniform float32 points (paper
    §7.1), formed in float32 as the reference's jitted `lscv_h` forms its
    jnp.linspace (XLA folds the division by n_h - 1 into a multiply by its
    reciprocal c): start (1 - i c) + i (stop c), then the stop itself."""
    device = resolve_device(device)
    h0 = h0_start(n, d)
    start = torch.tensor(h0 / 4.0, dtype=DTYPE, device=device)
    stop = torch.tensor(4.0 * h0, dtype=DTYPE, device=device)
    if n_h == 1:
        return start.reshape(1)
    c = torch.tensor(1.0, dtype=DTYPE) / torch.tensor(float(n_h - 1), dtype=DTYPE)
    c = c.to(device)
    i = torch.arange(n_h - 1, dtype=DTYPE, device=device)
    return torch.cat([start * (1 - i * c) + i * (stop * c), stop.reshape(1)])


# ---------------------------------------------------------------------------
# LSCV_h
# ---------------------------------------------------------------------------

class LSCVhResult(NamedTuple):
    h: torch.Tensor
    h_grid: torch.Tensor
    g_values: torch.Tensor
    sigma: torch.Tensor       # covariance matrix used by the Mahalanobis kernel
    det_sigma: torch.Tensor
    h0: torch.Tensor


def _t_sums_streaming(x: torch.Tensor, sigma_inv: torch.Tensor,
                      h_grid: torch.Tensor, c_k, c_kk, chunk: int = 128,
                      h_chunk: int = 8) -> torch.Tensor:
    """Fused grid: one pass over quadratic-form slabs accumulates
    sum_{i<j} T~ for every h at once.  Memory O(chunk * n * h_chunk)."""
    scan_slabs = pairwise_quadform_chunks(x, sigma_inv, chunk)
    inv2 = 0.5 / (h_grid * h_grid)   # (n_h,)
    inv4 = 0.25 / (h_grid * h_grid)

    def consume(acc, s, mask):
        sm = torch.where(mask, s, 0.0)
        w = mask.to(s.dtype)
        parts = []
        for start in range(0, h_grid.shape[0], h_chunk):
            i2 = inv2[start:start + h_chunk]
            i4 = inv4[start:start + h_chunk]
            e2 = torch.exp(-sm[None, :, :] * i2[:, None, None])
            e4 = torch.exp(-sm[None, :, :] * i4[:, None, None])
            parts.append(torch.sum((c_kk * e4 - 2.0 * c_k * e2) * w[None, :, :],
                                   dim=(1, 2)))
        return acc + torch.cat(parts)

    return scan_slabs(consume, torch.zeros(h_grid.shape, dtype=x.dtype,
                                           device=x.device))


def _as_rows(x, device: DeviceLike) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=DTYPE, device=resolve_device(device))
    return x[:, None] if x.dim() == 1 else x


def lscv_h(x, n_h: int = N_H_DEFAULT, store_s: bool = False, chunk: int = 128,
           backend: Optional[str] = None, device: DeviceLike = None
           ) -> LSCVhResult:
    """Full LSCV_h algorithm (paper §6.2 steps 1-7) on `device` (default:
    the CUDA device).  x: (n, d) or (n,).  Backend "cuda" runs steps 6-7 in
    the sv_precompute and lscv_grid kernels; "torch" takes `store_s`."""
    x = _as_rows(x, device)
    backend = resolve_backend(backend, x.device)
    n, d = x.shape

    # Steps 1-3: covariance, det, inverse (sequential scalar work in the paper).
    sigma = covariance(x)
    det_sigma = torch.linalg.det(sigma)
    sigma_inv = _inv(sigma)

    # Steps 4-5: h0 and search range (eqs. 28-29).
    h0 = torch.tensor(h0_start(n, d), dtype=DTYPE, device=x.device)
    h_grid = h_grid_for(n, d, n_h, device=x.device)

    c_k, c_kk, r_k = G.lscv_h_consts(d, det_sigma)

    # Steps 6-7: S(v) precompute + grid search (paper), or fused streaming.
    if backend == "cuda":
        from repro_torch.kernels import ops as kops
        t_sums = kops.lscv_grid_sums(x, sigma_inv, h_grid, c_k, c_kk)
    elif store_s:
        # phase 2 over the stored S is the grid kernel's plain version
        t_sums = kref.lscv_grid_sums_from_s(pairwise_sv_matrix(x, sigma_inv, chunk),
                                            h_grid, c_k, c_kk)
    else:
        t_sums = _t_sums_streaming(x, sigma_inv, h_grid, c_k, c_kk, chunk)

    g_values = h_grid ** (-d) * (2.0 / (n * n) * t_sums + r_k / n)   # eq. (43)
    best = torch.argmin(g_values)
    return LSCVhResult(h=h_grid[best], h_grid=h_grid, g_values=g_values,
                       sigma=sigma, det_sigma=det_sigma, h0=h0)


def g_of_h_sequential(x, h) -> float:
    """Unmodified eq. (24) evaluated naively in float64 numpy — the oracle for
    validating the §4.5 reformulation (recomputes the exponent for every pair
    at every h, i.e. the O(n_h n^2 d^2) path)."""
    import numpy as np

    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n, d = x.shape
    sigma = np.cov(x, rowvar=False, ddof=1).reshape(d, d)
    det = np.linalg.det(sigma)
    inv = np.linalg.inv(sigma)
    c_k = (2 * math.pi) ** (-d / 2) * det ** -0.5
    c_kk = (4 * math.pi) ** (-d / 2) * det ** -0.5
    acc = 0.0
    for i in range(n):
        for j in range(i + 1, n):
            u = (x[i] - x[j]) / h
            s = float(u @ inv @ u)
            acc += c_kk * math.exp(-0.25 * s) - 2.0 * c_k * math.exp(-0.5 * s)
    return float(h ** (-d) * (2.0 / (n * n) * acc + c_kk / n))


# ---------------------------------------------------------------------------
# LSCV_H
# ---------------------------------------------------------------------------

class LSCVHResult(NamedTuple):
    H: torch.Tensor
    g: torch.Tensor
    H_start: torch.Tensor
    it: int
    nfev: int


def g_of_H(x, H: torch.Tensor, chunk: int = 128, backend: Optional[str] = None,
           device: DeviceLike = None) -> torch.Tensor:
    """Objective g(H) (eq. 32) on `device` (default: the CUDA device),
    evaluated with the fused pass of §6.3: the gh_fused kernel on backend
    "cuda", the chunked plain pass on "torch"."""
    x = _as_rows(x, device)
    backend = resolve_backend(backend, x.device)
    H = torch.as_tensor(H, dtype=DTYPE, device=x.device)
    n, d = x.shape
    det_H = torch.linalg.det(H)
    H_inv = _inv(H)
    c_k, c_kk, r_k = G.lscv_H_consts(d, det_H)

    if backend == "cuda":
        from repro_torch.kernels import ops as kops
        t_sum = kops.gh_fused_sum(x, H_inv, c_k, c_kk)
    else:
        def fun1(s):
            return c_kk * torch.exp(-0.25 * s) - 2.0 * c_k * torch.exp(-0.5 * s)
        t_sum = pairwise_quadform_reduce(fun1, x, H_inv, chunk)
    return 2.0 / (n * n) * t_sum + r_k / n


def matrix_sqrt(a: torch.Tensor) -> torch.Tensor:
    """SPD matrix square root via eigendecomposition (paper uses ALGLIB);
    invariant to the sign convention of the eigenvectors."""
    w, v = torch.linalg.eigh(a)
    return (v * torch.sqrt(torch.clamp(w, min=0.0))) @ v.T


def h_start(x: torch.Tensor) -> torch.Tensor:
    """eq. (37): H_start = (4/(d+2))^(1/(d+4)) n^(-1/(d+4)) Sigma^(1/2)."""
    n, d = x.shape
    sigma = covariance(x)
    return (4.0 / (d + 2.0)) ** (1.0 / (d + 4)) * n ** (-1.0 / (d + 4)) * matrix_sqrt(sigma)


def _theta_to_H(theta: torch.Tensor, d: int) -> torch.Tensor:
    """log-Cholesky: theta packs L's lower triangle, diagonal stored as log."""
    il, jl = torch.tril_indices(d, d, device=theta.device)
    L = torch.zeros((d, d), dtype=theta.dtype, device=theta.device)
    L[il, jl] = theta
    idx = torch.arange(d, device=theta.device)
    L[idx, idx] = torch.exp(torch.diagonal(L))
    return L @ L.T


def _H_to_theta(H: torch.Tensor) -> torch.Tensor:
    # a matrix that is not positive definite gives NaN, as jnp's cholesky
    # does, instead of raising
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where(info == 0, L, torch.nan)
    idx = torch.arange(H.shape[0], device=H.device)
    L[idx, idx] = torch.log(torch.diagonal(L))
    il, jl = torch.tril_indices(H.shape[0], H.shape[0], device=H.device)
    return L[il, jl]


def lscv_H(x, max_iter: int = 150, chunk: int = 128,
           backend: Optional[str] = None, multi_start: int = 1, seed: int = 0,
           device: DeviceLike = None) -> LSCVHResult:
    """Full LSCV_H on `device` (default: the CUDA device): Nelder-Mead over
    log-Cholesky(vech) of H (d(d+1)/2 dof).

    multi_start > 1 runs that many Nelder-Mead instances, from H_start and
    from H_start's parameters jittered by 0.25 N(0, 1) (a torch.Generator
    seeded with `seed`), one after another, and keeps the best — the
    parallelisation the paper proposes in §6.3; `nfev` sums all runs."""
    x = _as_rows(x, device)
    backend = resolve_backend(backend, x.device)
    n, d = x.shape
    H0 = h_start(x)
    theta0 = _H_to_theta(H0).cpu()

    def objective(theta):
        return g_of_H(x, _theta_to_H(theta.to(x.device), d), chunk=chunk,
                      backend=backend, device=x.device)

    starts = [theta0]
    if multi_start > 1:
        gen = torch.Generator().manual_seed(seed)
        jitter = 0.25 * torch.randn((multi_start - 1, theta0.shape[0]),
                                    generator=gen, dtype=DTYPE)
        starts += [theta0 + j for j in jitter]
    runs = [nm_minimize(objective, t, max_iter=max_iter) for t in starts]
    best = min(range(len(runs)), key=lambda r: float(runs[r].fun))
    H = _theta_to_H(runs[best].x.to(x.device), d)
    return LSCVHResult(H=H, g=runs[best].fun.to(x.device), H_start=H0,
                       it=runs[best].it, nfev=sum(r.nfev for r in runs))
