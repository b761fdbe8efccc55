"""Binned / FFT-accelerated KDE (paper §2.2 related work, beyond the paper's
exact computation).  Counterpart: `repro/core/binned.py`.

`linear_binning`          — assigns each point to its two neighbouring grid
                            points with linear weights.
`binned_kde_fft`          — the KDE on the grid by a zero-padded FFT
                            convolution (no circular aliasing).
`binned_psi_r`            — binned Psi_r functionals, O(g log g).
`binned_plugin_bandwidth` — PLUGIN with binned Psi6 / Psi4.

Plain PyTorch on every device, as the reference computes all of it outside
any kernel: `torch.fft.rfft` / `irfft` stand where `jnp.fft` does.  The
counts are a stable sort of the bin indices and a segment sum
(`torch.segment_reduce`), never float atomics, so a CUDA run gives the same
bits every time.  The sort puts each bin's left-neighbour weights in point
order, then its right-neighbour weights, the order of the reference's two
scatter-adds; the CPU's segment sum adds them in that order, which gives
the reference's counts bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import DTYPE, DeviceLike, resolve_device

from . import gaussian as G
from .plugin import variance_estimator


def _f32(v, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=DTYPE, device=device).reshape(())


def _recip(g: int) -> float:
    """1 / (g - 1) as XLA folds the reference's division by that constant:
    one float32 reciprocal."""
    return float(np.float32(1.0) / np.float32(g - 1))


def _grid(lo: torch.Tensor, hi: torch.Tensor, g: int) -> torch.Tensor:
    """The reference's `jnp.linspace(lo, hi, g)` as XLA compiles it inside
    `linear_binning`: lo (1 - i c) + i (hi c) with c = 1 / (g - 1) in
    float32, each operation rounded once, then hi itself.  The first two
    points and the last, and so the spacing the FFT paths read, are the
    reference's bits; XLA's CPU code may contract an interior point's last
    multiply-add into one rounding, so those points can differ from it in
    the last bits."""
    c = _recip(g)
    i = torch.arange(g - 1, dtype=DTYPE, device=lo.device)
    return torch.cat([lo * (1.0 - i * c) + i * (hi * c), hi.reshape(1)])


def linear_binning(x, lo, hi, g: int = 512, device: DeviceLike = None):
    """Returns (grid, counts) with sum(counts) == n (paper §2.2), on
    `device` (default: the CUDA device)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=DTYPE, device=dev)
    lo, hi = _f32(lo, dev), _f32(hi, dev)
    grid = _grid(lo, hi, g)
    delta = (hi - lo) * _recip(g)
    pos = torch.clamp((x - lo) / delta, 0.0, g - 1.0)
    left = torch.floor(pos)
    w_right = pos - left
    li = left.to(torch.int64)
    ri = torch.clamp(li + 1, max=g - 1)
    idx = torch.cat([li, ri])
    w = torch.cat([1.0 - w_right, w_right])
    order = torch.sort(idx, stable=True).indices
    lengths = torch.bincount(idx, minlength=g)
    counts = torch.segment_reduce(w[order], "sum", lengths=lengths)
    return grid, counts


def binned_kde_fft(grid, counts, h, device: DeviceLike = None) -> torch.Tensor:
    """KDE on the grid in O(g log g) by a zero-padded FFT convolution."""
    dev = resolve_device(device)
    grid = torch.as_tensor(grid, dtype=DTYPE, device=dev)
    counts = torch.as_tensor(counts, dtype=DTYPE, device=dev)
    h = _f32(h, dev)
    g = grid.shape[0]
    delta = grid[1] - grid[0]
    n = torch.sum(counts)
    # kernel taps out to the grid's edge, padded to 4g: the circular
    # convolution is then linear (no aliasing)
    taps = torch.arange(-(g - 1), g, dtype=DTYPE, device=dev) * delta
    kern = G.phi(taps / h) / h
    size = 4 * g
    fc = torch.fft.rfft(counts, n=size)
    fk = torch.fft.rfft(kern, n=size)
    conv = torch.fft.irfft(fc * fk, n=size)
    return conv[g - 1:2 * g - 1] / n


def binned_psi_r(grid, counts, gbw, r: int, device: DeviceLike = None) -> torch.Tensor:
    """Binned Psi_r ~= n^-2 gbw^-(r+1) sum_ab c_a c_b K^(r)((g_a - g_b)/gbw).

    K^(r) depends only on a - b, so the double sum is sum_t K_t (c (*) c)[t]
    with (*) the cross-correlation, taken by FFT."""
    dev = resolve_device(device)
    grid = torch.as_tensor(grid, dtype=DTYPE, device=dev)
    counts = torch.as_tensor(counts, dtype=DTYPE, device=dev)
    gbw = _f32(gbw, dev)
    g = grid.shape[0]
    delta = grid[1] - grid[0]
    n = torch.sum(counts)
    kfun = G.k6 if r == 6 else G.k4
    size = 4 * g
    fc = torch.fft.rfft(counts, n=size)
    autocorr = torch.fft.irfft(fc * torch.conj(fc), n=size)
    lags = torch.arange(g, dtype=DTYPE, device=dev) * delta
    k_at_lags = kfun(lags / gbw)
    # lag 0 once, lags +-t together (K^(r) is even for even r)
    total = autocorr[0] * k_at_lags[0] + 2.0 * torch.sum(autocorr[1:g] * k_at_lags[1:])
    return total / (n * n * gbw ** (r + 1))


def binned_plugin_bandwidth(x, g: int = 1024, device: DeviceLike = None) -> torch.Tensor:
    """PLUGIN (eqs. 12-19) with binned Psi6 / Psi4: the 0-d h."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=DTYPE, device=dev)
    n = x.shape[0]
    lo = torch.min(x) - 1e-3
    hi = torch.max(x) + 1e-3
    grid, counts = linear_binning(x, lo, hi, g, device=dev)
    sigma = torch.sqrt(variance_estimator(x))
    psi8 = 105.0 / (32.0 * math.sqrt(math.pi) * sigma ** 9)
    g1 = (-2.0 * G.K6_AT_0 / (G.MU2_K * psi8 * n)) ** (1.0 / 9.0)
    psi6 = binned_psi_r(grid, counts, g1, 6, device=dev)
    g2 = (-2.0 * G.K4_AT_0 / (G.MU2_K * psi6 * n)) ** (1.0 / 7.0)
    psi4 = binned_psi_r(grid, counts, g2, 4, device=dev)
    return (G.R_K_1D / (G.MU2_K ** 2 * psi4 * n)) ** 0.2
