"""Confidence intervals of the closed-form AQP paths.
Counterpart: `repro/core/aqp_ci.py`.

range1d / box: the estimate is scale * sum_i t_i over the m retained sample
points, t_i the per-point closed-form term; the sample is an iid draw from
the stream, so Var(est) = scale^2 * m * Var(t), and the sample variance of t
gives a normal-theory CI.  AVG = SUM/COUNT uses the delta method.  On the
"torch" backend the moment passes (`moments_1d`, `moments_box`: the plain
versions of the kernels' five sums) run separately from the estimate
passes, as in the reference; on the "cuda" backend a range or box group's
estimate and CI come from one launch of the aqp_batch / aqp_boxes kernel,
which sums the second moments beside the estimate's terms
(`range_answers_and_se`, `box_answers_and_se`).

qmc: no closed form under a full bandwidth matrix; the CI comes from
subsample (batch-means) variance over K equal chunks of the retained
sample, each answered on the node set planned for the full sample, with a
Student-t quantile (K - 1 dof).  On the "cuda" backend the chunks are row
splits of the estimate's own launch of the qmc_reduce kernel
(`qmc_answers_and_se`), so the path runs one kernel launch per group and
no plain version of a kernel on the card.

GROUP BY families on the "cuda" backend take their five moment sums from
the aqp_grouped kernel's launch (`aqp_multid.grouped_family_moments`) and
run no moment pass here.

Quantiles are closed-form approximations (Acklam's inverse normal CDF,
a Cornish-Fisher expansion for Student-t), accurate to ~1e-4 in the
central range.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DTYPE
from repro_torch.kernels import ref as kref

from .aqp import AVG_MIN_COUNT, OP_COUNT, OP_SUM
from .aqp_multid import (_estimates64, _host64, _qmc_kernel_split_terms,
                         _qmc_plan, _qmc_shared_terms, _QmcInputs, _select)

DEFAULT_CI_LEVEL = 0.95

# Subsample count for the quasi-MC batch-means CI.
QMC_SUBSAMPLES = 8


# --- quantiles --------------------------------------------------------------

_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
      1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
      6.680131188771972e+01, -1.328068155288572e+01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
      -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
      3.754408661907416e+00)


def norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation,
    |error| < 1.2e-9 over (0, 1))."""
    if not 0.0 < p < 1.0:
        if p == 0.0:
            return -math.inf
        if p == 1.0:
            return math.inf
        raise ValueError(f"p must be in [0, 1], got {p}")
    p_low = 0.02425
    if p < p_low:
        q = math.sqrt(-2.0 * math.log(p))
        return ((((((_C[0] * q + _C[1]) * q + _C[2]) * q + _C[3]) * q
                  + _C[4]) * q + _C[5])
                / ((((_D[0] * q + _D[1]) * q + _D[2]) * q + _D[3]) * q + 1.0))
    if p > 1.0 - p_low:
        return -norm_ppf(1.0 - p)
    q = p - 0.5
    r = q * q
    return (((((_A[0] * r + _A[1]) * r + _A[2]) * r + _A[3]) * r + _A[4]) * r
            + _A[5]) * q / \
           (((((_B[0] * r + _B[1]) * r + _B[2]) * r + _B[3]) * r + _B[4]) * r
            + 1.0)


def t_ppf(p: float, dof: int) -> float:
    """Student-t quantile by the Cornish-Fisher expansion around the normal
    quantile — exact enough (<1e-3 for dof >= 4 in the central range) for
    batch-means CIs, whose dominant error is the K-chunk variance estimate."""
    if dof < 1:
        return math.inf
    z = norm_ppf(p)
    if not math.isfinite(z):
        return z
    z2 = z * z
    g1 = z * (z2 + 1.0) / 4.0
    g2 = z * (5.0 * z2 * z2 + 16.0 * z2 + 3.0) / 96.0
    g3 = z * (3.0 * z2 ** 3 + 19.0 * z2 * z2 + 17.0 * z2 - 15.0) / 384.0
    g4 = z * (79.0 * z2 ** 4 + 776.0 * z2 ** 3 + 1482.0 * z2 * z2
              - 1920.0 * z2 - 945.0) / 92160.0
    d = float(dof)
    return z + g1 / d + g2 / d ** 2 + g3 / d ** 3 + g4 / d ** 4


# --- analytic moment passes (range1d / box paths) ---------------------------
#
# Per-query sums over the m sample points of the unscaled closed-form terms:
# (sum c, sum s, sum c^2, sum s^2, sum c*s) with c_i the COUNT term and s_i
# the SUM term — what the aqp_batch / aqp_boxes kernels sum beside their
# estimates, here by their plain versions in kernels/ref.py.

def moments_1d(x: torch.Tensor, h: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor):
    """x: (m,) sample; a/b: (q,).  Returns five (q,) tensors."""
    return tuple(kref.aqp_batch_moments(x, h, a, b))


def moments_box(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, tgt: torch.Tensor):
    """x: (m,d) rows; lo/hi: (q,d); tgt: (q,).  Returns five (q,) tensors."""
    return tuple(kref.aqp_box_moments(x, h_diag, lo, hi, tgt))


def _answers_and_se(five: torch.Tensor, ops: np.ndarray, scale: float,
                    m: int) -> Tuple[torch.Tensor, np.ndarray]:
    """(answers, per-query SE) from a (5, q) moment-sum tensor, read back
    in one device-to-host copy; the answers are a (q,) float32 host
    tensor."""
    five = five.cpu()
    return (_select(ops, scale * five[0], scale * five[1]),
            se_from_moments(ops, five, scale, m))


def range_answers_and_se(x: torch.Tensor, h: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, ops: np.ndarray, scale: float,
                         m: int) -> Tuple[torch.Tensor, np.ndarray]:
    """(answers, per-query SE) of a range group on the aqp_batch kernel: ONE
    launch gives the estimate's sums and the CI's (`batch_query_1d` and
    `moments_1d` of the "torch" backend in one pass), read back in one
    copy (the plain version for a sample on the CPU)."""
    from repro_torch.kernels import ops as kops
    return _answers_and_se(kops.aqp_batch_moments(x, h, a, b), ops, scale, m)


def box_answers_and_se(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, tgt: torch.Tensor, ops: np.ndarray,
                       scale: float, m: int) -> Tuple[torch.Tensor, np.ndarray]:
    """(answers, per-query SE) of a box group on the aqp_boxes kernel: ONE
    launch gives the estimate's sums and the CI's (`batch_query_box` and
    `moments_box` of the "torch" backend in one pass), read back in one
    copy (the plain version for a sample on the CPU)."""
    from repro_torch.kernels import ops as kops
    return _answers_and_se(kops.aqp_box_moments(x, h_diag, lo, hi, tgt), ops, scale,
                           m)


def se_from_moments(ops: np.ndarray, moments, scale: float,
                    m: int) -> np.ndarray:
    """Per-query standard error of the scaled estimate from the raw moment
    sums (tensors on any device, or arrays); `ops` selects the
    COUNT/SUM/AVG formula per query.

    est = scale * sum(t)  =>  SE = scale * sqrt(m/(m-1)) *
                                   sqrt(sum(t^2) - sum(t)^2 / m).
    AVG uses the delta method on r = S/C; at r = sum(s)/sum(c) the residuals
    u_i = s_i - r c_i sum to zero, so the variance term is
    sum(s^2) - 2 r sum(cs) + r^2 sum(c^2).  Empty selections (scaled count
    below AVG_MIN_COUNT, where AVG is pinned to 0) get an infinite SE.
    """
    m1c, m1s, m2c, m2s, m12 = (
        np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                   np.float64) for v in moments)
    ops = np.asarray(ops)
    if m < 2:
        return np.full(m1c.shape, np.inf)
    corr = m / (m - 1.0)
    se_count = scale * np.sqrt(corr * np.maximum(m2c - m1c * m1c / m, 0.0))
    se_sum = scale * np.sqrt(corr * np.maximum(m2s - m1s * m1s / m, 0.0))
    count = scale * m1c
    ok = count > AVG_MIN_COUNT
    r = np.where(ok, m1s / np.where(m1c != 0.0, m1c, 1.0), 0.0)
    quad = np.maximum(m2s - 2.0 * r * m12 + r * r * m2c, 0.0)
    se_avg = np.where(ok, scale * np.sqrt(corr * quad)
                      / np.maximum(count, AVG_MIN_COUNT), np.inf)
    return np.select([ops == OP_COUNT, ops == OP_SUM],
                     [se_count, se_sum], se_avg)


# --- subsample (batch-means) CI for the quasi-MC path -----------------------

def qmc_answers_and_se(x: torch.Tensor, H: torch.Tensor, lo: np.ndarray,
                       hi: np.ndarray, tgt: np.ndarray, ops: np.ndarray,
                       scale: float, n_source: int, n_qmc: int,
                       k_sub: int = QMC_SUBSAMPLES
                       ) -> Tuple[torch.Tensor, np.ndarray, int]:
    """(answers, per-query SE, t dof) of a full-H group on the qmc_reduce
    kernel: ONE plan and ONE launch give the estimate (the whole sample, as
    `batch_query_qmc`) and the K batch-means replicates of
    `qmc_subsample_se` (the sample's K equal row chunks over the same
    nodes), read back in one device-to-host copy.  The answers are a (q,)
    float32 tensor on the host."""
    q = np.asarray(lo).shape[0]
    m = x.shape[0]
    k = min(k_sub, m // 2)
    plan = _qmc_plan(_host64(x), _host64(H), lo, hi, n_qmc)
    if plan is None:                  # zero-measure boxes: estimate is 0
        se = np.full((q,), np.inf) if k < 2 else np.zeros((q,), np.float64)
        return torch.zeros((q,), dtype=DTYPE), se, max(k - 1, 1)
    inp = _QmcInputs(plan, tgt, x.shape[1], x.device)
    splits = k if k >= 2 else 0
    cnt_raw, sum_raw = _qmc_kernel_split_terms(x, H, inp, splits)
    cnt_raw, sum_raw = torch.stack([cnt_raw, sum_raw]).cpu()
    ans = _select(ops, scale * cnt_raw[0], scale * sum_raw[0])
    if splits == 0:
        return ans, np.full((q,), np.inf), 1
    ops = np.asarray(ops)
    scale_k = n_source / (m // k)
    e = np.stack([_estimates64(ops, scale_k, cnt_raw[1 + j], sum_raw[1 + j])
                  for j in range(k)])
    return ans, e.std(axis=0, ddof=1) / math.sqrt(k), k - 1


def qmc_subsample_se(x: torch.Tensor, H: torch.Tensor, lo: np.ndarray,
                     hi: np.ndarray, tgt: np.ndarray, ops: np.ndarray,
                     n_source: int, n_qmc: int, k_sub: int = QMC_SUBSAMPLES,
                     backend: str = "torch") -> Tuple[np.ndarray, int]:
    """(per-query SE, t dof) for a full-H group, by batch-means over K equal
    chunks of the retained sample (reservoir order is random, so chunks are
    independent uniform subsamples).  All chunks reduce over the node set
    planned for the full sample, so the quasi-MC integration error is
    common-mode and the spread isolates sampling variance.  backend="cuda"
    reads the chunks from one split launch of the qmc_reduce kernel
    (`qmc_answers_and_se`), "torch" answers each on the plain density
    pass."""
    q = np.asarray(lo).shape[0]
    m = x.shape[0]
    k = min(k_sub, m // 2)
    if k < 2:
        return np.full((q,), np.inf), 1
    if backend == "cuda":
        _, se, dof = qmc_answers_and_se(x, H, lo, hi, tgt, ops, 1.0, n_source,
                                        n_qmc, k_sub)
        return se, dof
    plan = _qmc_plan(_host64(x), _host64(H), lo, hi, n_qmc)
    if plan is None:                  # zero-measure boxes: estimate is 0
        return np.zeros((q,), np.float64), k - 1
    inp = _QmcInputs(plan, tgt, x.shape[1], x.device)
    ops = np.asarray(ops)
    chunk = m // k
    scale_k = n_source / chunk
    ests = []
    for j in range(k):
        cnt_raw, sum_raw = _qmc_shared_terms(x[j * chunk:(j + 1) * chunk].contiguous(),
                                             H, inp)
        ests.append(_estimates64(ops, scale_k, cnt_raw, sum_raw))
    e = np.stack(ests)
    return e.std(axis=0, ddof=1) / math.sqrt(k), k - 1
