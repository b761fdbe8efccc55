"""PLUGIN bandwidth selector (paper §4.4, eqs. 12-19), 1-D as in the paper.
Counterpart: `repro/core/plugin.py`.

Pipeline:  Vhat -> sigma -> Psi8_NS -> g1 -> Psi6(g1) -> g2 -> Psi4(g2) -> h

The two O(n^2) stages (Psi6, Psi4) are pairwise derivative-kernel sums
(RR_fun, §5.4): on backend "cuda" the triangular tile kernel
(`kernels/csrc/pairwise_reduce.cu`), on backend "torch" the chunked plain
`pairwise_reduce`.  Everything stays a device tensor from start to end, and
the kernel reads g1 and g2 from device memory, so the fit makes no host sync.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DTYPE, DeviceLike, resolve_backend, resolve_device

from . import gaussian as G
from .reductions import pairwise_reduce, reduce_sum


class PluginResult(NamedTuple):
    h: torch.Tensor
    sigma: torch.Tensor
    g1: torch.Tensor
    g2: torch.Tensor
    psi8: torch.Tensor
    psi6: torch.Tensor
    psi4: torch.Tensor


def variance_estimator(x: torch.Tensor) -> torch.Tensor:
    """eq. (12): unbiased variance via the two-sum form the paper parallelises."""
    n = x.shape[0]
    s2 = reduce_sum(x * x)
    s1 = reduce_sum(x)
    return s2 / (n - 1) - (s1 * s1) / (n * (n - 1))


def _psi_r(pair_sum: torch.Tensor, k_at_0: float, n: int, g: torch.Tensor,
           r: int) -> torch.Tensor:
    """Psi_r(g) = (2 * sum_{i<j} K^(r)(dx/g) + n K^(r)(0)) / (n^2 g^(r+1))
    (eqs. 16/18 with the diagonal written out)."""
    return (2.0 * pair_sum + n * k_at_0) / (n * n * g ** (r + 1))


def plugin_bandwidth(x, chunk: int = 512, backend: Optional[str] = None,
                     device: DeviceLike = None) -> PluginResult:
    """The PLUGIN h of a 1-D float32 sample, on `device` (default: the CUDA
    device; `device="cpu"` runs the plain path on the CPU)."""
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    x = torch.as_tensor(x, dtype=DTYPE, device=dev)
    if x.dim() != 1:
        raise ValueError("PLUGIN is defined for univariate data only (paper §4.4)")
    n = x.shape[0]

    if backend == "cuda":
        from repro_torch.kernels import ops as kops

        def rr_k6(g):
            return kops.pairwise_scaled_ksum(x, g, kind="k6")

        def rr_k4(g):
            return kops.pairwise_scaled_ksum(x, g, kind="k4")
    else:
        def rr_k6(g):
            return pairwise_reduce(lambda dx: G.k6(dx / g), x, chunk=chunk)

        def rr_k4(g):
            return pairwise_reduce(lambda dx: G.k4(dx / g), x, chunk=chunk)

    # Steps 1-2 (eqs. 12-13)
    v = variance_estimator(x)
    sigma = torch.sqrt(v)
    # Step 3 (eq. 14): Psi8 normal-scale estimate
    psi8 = 105.0 / (32.0 * math.sqrt(math.pi) * sigma ** 9)
    # Step 4 (eq. 15): g1 = (-2 K6(0) / (mu2 Psi8 n))^(1/9)
    g1 = (-2.0 * G.K6_AT_0 / (G.MU2_K * psi8 * n)) ** (1.0 / 9.0)
    # Step 5 (eq. 16): Psi6(g1) — O(n^2) pairwise sum of K^(6)
    psi6 = _psi_r(rr_k6(g1), G.K6_AT_0, n, g1, 6)
    # Step 6 (eq. 17): g2 = (-2 K4(0) / (mu2 Psi6 n))^(1/7)
    g2 = (-2.0 * G.K4_AT_0 / (G.MU2_K * psi6 * n)) ** (1.0 / 7.0)
    # Step 7 (eq. 18): Psi4(g2) — O(n^2) pairwise sum of K^(4)
    psi4 = _psi_r(rr_k4(g2), G.K4_AT_0, n, g2, 4)
    # Step 8 (eq. 19): final h
    h = (G.R_K_1D / (G.MU2_K ** 2 * psi4 * n)) ** 0.2
    return PluginResult(h=h, sigma=sigma, g1=g1, g2=g2, psi8=psi8, psi6=psi6,
                        psi4=psi4)


def plugin_bandwidth_sequential(x) -> float:
    """The paper's sequential implementation: scalar float32 loops in numpy,
    an independent oracle.  O(n^2) Python-level work — keep n small."""
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    s1 = np.float32(0.0)
    s2 = np.float32(0.0)
    for i in range(n):
        s1 += x[i]
        s2 += x[i] * x[i]
    v = s2 / np.float32(n - 1) - s1 * s1 / np.float32(n * (n - 1))
    sigma = np.sqrt(v)
    psi8 = np.float32(105.0 / (32.0 * math.sqrt(math.pi))) / sigma ** 9
    g1 = (np.float32(-2.0 * G.K6_AT_0) / (psi8 * n)) ** (1.0 / 9.0)

    inv_sqrt_2pi = np.float32(G.INV_SQRT_2PI)

    def k6s(t):
        t2 = t * t
        return (((t2 - 15.0) * t2 + 45.0) * t2 - 15.0) * inv_sqrt_2pi * np.exp(-0.5 * t2)

    def k4s(t):
        t2 = t * t
        return ((t2 - 6.0) * t2 + 3.0) * inv_sqrt_2pi * np.exp(-0.5 * t2)

    acc = np.float32(0.0)
    for i in range(n):
        for j in range(i + 1, n):
            acc += k6s((x[i] - x[j]) / g1)
    psi6 = (2.0 * acc + n * np.float32(G.K6_AT_0)) / (n * n * g1 ** 7)
    g2 = (np.float32(-2.0 * G.K4_AT_0) / (psi6 * n)) ** (1.0 / 7.0)
    acc = np.float32(0.0)
    for i in range(n):
        for j in range(i + 1, n):
            acc += k4s((x[i] - x[j]) / g2)
    psi4 = (2.0 * acc + n * np.float32(G.K4_AT_0)) / (n * n * g2 ** 5)
    h = (np.float32(G.R_K_1D) / (psi4 * n)) ** 0.2
    return float(h)
