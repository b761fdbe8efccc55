"""Gaussian kernel, the derivative kernels PLUGIN uses (paper §4, eqs.
14-19) and the normalisation constants of the LSCV kernels (eqs. 26-36).
Counterpart: `repro/core/gaussian.py`."""
from __future__ import annotations

import math

import torch

INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
SQRT1_2 = 1.0 / math.sqrt(2.0)

# Constants from the paper (eqs. 14-19).
K4_AT_0 = 3.0 * INV_SQRT_2PI           # K^(4)(0) = 3/sqrt(2*pi)
K6_AT_0 = -15.0 * INV_SQRT_2PI         # K^(6)(0) = -15/sqrt(2*pi)
R_K_1D = 1.0 / (2.0 * math.sqrt(math.pi))  # R(K) for 1-D Gaussian (eq. 19)
MU2_K = 1.0                            # second moment of the Gaussian kernel


def phi(x: torch.Tensor) -> torch.Tensor:
    """Standard normal density."""
    return INV_SQRT_2PI * torch.exp(-0.5 * x * x)


def k4(x: torch.Tensor) -> torch.Tensor:
    """K^(4)(x) = (x^4 - 6x^2 + 3) phi(x)  (eq. 18)."""
    x2 = x * x
    return ((x2 - 6.0) * x2 + 3.0) * phi(x)


def k6(x: torch.Tensor) -> torch.Tensor:
    """K^(6)(x) = (x^6 - 15x^4 + 45x^2 - 15) phi(x)  (eq. 16)."""
    x2 = x * x
    return (((x2 - 15.0) * x2 + 45.0) * x2 - 15.0) * phi(x)


def phi_diff(za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
    """Phi(zb) - Phi(za), the interval mass of eqs. 9-11, from the upper tail
    when the pair's midpoint is positive and from the lower tail otherwise:
    erfc keeps relative precision there, where 0.5*(erf(zb/sqrt2) -
    erf(za/sqrt2)) cancels.  The kernels form it the same way."""
    upper = (za + zb) > 0
    u = torch.where(upper, za, -zb)
    v = torch.where(upper, zb, -za)
    return 0.5 * (torch.special.erfc(u * SQRT1_2)
                  - torch.special.erfc(v * SQRT1_2))


def dens_diff(za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
    """phi(zb) - phi(za)."""
    return INV_SQRT_2PI * (torch.exp(-0.5 * zb * zb)
                           - torch.exp(-0.5 * za * za))


def lscv_h_consts(d: int, det_sigma):
    """Normalisation constants of the Sigma-shaped kernels (eqs. 26, 27).

    Returns (c_K, c_KK, r_K) with
      K(u)      = c_K  * exp(-1/2 u^T Sigma^-1 u)
      (K*K)(u)  = c_KK * exp(-1/4 u^T Sigma^-1 u)
      R(K)      = (K*K)(0) = c_KK
    """
    det_root = det_sigma ** -0.5
    c_k = (2.0 * math.pi) ** (-d / 2.0) * det_root
    c_kk = (4.0 * math.pi) ** (-d / 2.0) * det_root
    return c_k, c_kk, c_kk


def lscv_H_coefs(d: int):
    """The factors of det(H)^-1/2 in c_k, c_kk and r_k (eqs. 34-36)."""
    return ((2.0 * math.pi) ** (-d / 2.0), (4.0 * math.pi) ** (-d / 2.0),
            2.0 ** (-d) * math.pi ** (-d / 2.0))  # eq. 36 == c_kk


def lscv_H_consts(d: int, det_H):
    """Normalisation constants of the H-shaped kernels (eqs. 34-36)."""
    det_root = det_H ** -0.5
    a_k, a_kk, a_r = lscv_H_coefs(d)
    return a_k * det_root, a_kk * det_root, a_r * det_root
