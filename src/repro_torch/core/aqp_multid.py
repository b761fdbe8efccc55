"""Box predicates over joint KDE synopses (eq. 11), GROUP BY families, and
the batched quasi-MC path of full-H synopses.
Counterpart: `repro/core/aqp_multid.py`; the reference's plain per-query
terms (`_box_terms`, `_grouped_box_terms`) are `kernels/ref.py`'s
`aqp_box_sums` and `aqp_grouped_sums` here.

For diagonal bandwidths the box integral factorises into per-axis 1-D
closed forms:

  COUNT(box) ~= scale * sum_i  prod_j  [Phi]_ij
  SUM(t;box) ~= scale * sum_i  m_it * prod_{j!=t} [Phi]_ij,
                m_ij = X_ij [Phi]_ij - h_j [phi]_ij

A GROUP BY family (boxes that differ only in the group column's code
window) shares every other axis's factors, so the grouped pass forms them
once: O(n d + n G) instead of O(n d G).  Full-H synopses do not factorise:
a group of boxes is answered by quasi-MC on one shared Halton node set over
the group's support-clipped hull, with one density evaluation per group —
exact (`batch_query_qmc`, eq. 6) or from a fitted RFF synopsis
(`batch_query_qmc_rff`).  The host planning (`_qmc_plan`) is float64 numpy,
as in the reference.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DTYPE
from repro_torch.kernels import ref as kref

from .aqp import (AVG_MIN_COUNT, OP_CODES, OP_COUNT, OP_SUM, KDESynopsis,
                  _avg_or_zero, _halton, _select_op)
from .kde import kde_eval_H


def batch_query_box(x: torch.Tensor, h_diag: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, tgt: torch.Tensor, ops: torch.Tensor,
                    scale: float, backend: str = "torch") -> torch.Tensor:
    """Answer a mixed box batch against one diagonal-bandwidth joint
    synopsis.  x: (n,d); lo/hi: (q,d); tgt/ops: (q,).  backend="cuda" runs
    the (queries x samples x dims) reduction in the aqp_boxes kernel,
    backend="torch" its plain version (`kernels/ref.py`)."""
    if backend == "cuda":
        from repro_torch.kernels import ops as kops
        cnt_raw, sum_raw = kops.aqp_box_sums(x, h_diag, lo, hi, tgt)
    else:
        cnt_raw, sum_raw = kref.aqp_box_sums(x, h_diag, lo, hi, tgt)
    return _select_op(ops, scale * cnt_raw, scale * sum_raw)


# --- grouped GROUP BY evaluation (shared box terms factored out) ------------

def batch_query_box_grouped(x: torch.Tensor, h_diag: torch.Tensor, lo, hi,
                            glo, ghi, g_axis: int, tgt: int, op: int,
                            scale: float, backend: str = "torch") -> torch.Tensor:
    """Answer one GROUP BY family — a shared box crossed with G per-category
    windows on axis `g_axis` — in a single factored pass (one answer per
    category; the family shares one aggregate op).  backend="cuda" runs the
    factored reduction in the aqp_grouped kernel, backend="torch" its plain
    version."""
    def dev(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=x.device)

    args = (x, h_diag, dev(lo), dev(hi), dev(glo), dev(ghi), int(g_axis), int(tgt))
    if backend == "cuda":
        from repro_torch.kernels import ops as kops
        cnt_raw, sum_raw = kops.aqp_grouped_sums(*args)
    else:
        cnt_raw, sum_raw = kref.aqp_grouped_sums(*args)
    counts = scale * cnt_raw
    sums = scale * sum_raw
    if op == OP_COUNT:
        return counts
    if op == OP_SUM:
        return sums
    return _avg_or_zero(counts, sums)


# --- batched quasi-MC (full-H groups) ----------------------------------------

MAX_QMC_NODES = 32_768


@lru_cache(maxsize=16)
def _halton_unit(n_nodes: int, d: int) -> np.ndarray:
    """Shared unit-cube Halton nodes (float32; callers do not write to
    them); cached so repeated batches reuse them."""
    return _halton(n_nodes, d)


def _qmc_plan(x_host: np.ndarray, H: np.ndarray, lo: np.ndarray,
              hi: np.ndarray, n_qmc: int):
    """Host-side quasi-MC planning, shared by the estimate pass and the
    subsample-CI pass so both reduce over the same clipped boxes and node
    set.

    Axes wider than the synopsis support are clipped to support +- 6
    per-axis sigma (the "unconstrained" axes of SUM/AVG targets).  Small
    boxes inside a large bounding box see fewer effective nodes, so the node
    budget grows (up to MAX_QMC_NODES) when the narrowest box covers a small
    fraction of the group hull, quantized to a power of two.

    Returns (glo, ghi, clo, chi, n_nodes) float64 host arrays, or None when
    every box is zero-measure."""
    lo = np.asarray(lo, np.float64).reshape(lo.shape[0], -1)
    hi = np.asarray(hi, np.float64).reshape(hi.shape[0], -1)
    sig = np.sqrt(np.diag(np.asarray(H, np.float64)))
    slo = x_host.min(axis=0) - 6.0 * sig
    shi = x_host.max(axis=0) + 6.0 * sig
    clo = np.clip(lo, slo[None, :], shi[None, :])
    chi = np.clip(hi, slo[None, :], shi[None, :])
    glo = clo.min(axis=0)
    ghi = chi.max(axis=0)
    vol_g = float(np.prod(ghi - glo))
    if vol_g <= 0.0:                       # every box is zero-measure
        return None
    ratios = np.prod(chi - clo, axis=1) / vol_g
    ratios = ratios[ratios > 0]
    min_ratio = float(ratios.min()) if ratios.size else 1.0
    n_nodes = int(min(MAX_QMC_NODES, n_qmc / max(min_ratio, n_qmc / MAX_QMC_NODES)))
    n_nodes = 1 << max(int(np.ceil(np.log2(max(n_nodes, 1)))),
                       int(np.ceil(np.log2(n_qmc))))
    return glo, ghi, clo, chi, n_nodes


def _host64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


class _QmcInputs:
    """A plan's arrays on the device: the hull (glo, ghi), the clipped
    boxes (clo, chi), the targets and the shared nodes
    glo + unit (ghi - glo), formed in float32 as the reference forms them."""

    def __init__(self, plan, tgt, d: int, device: torch.device):
        glo, ghi, clo, chi, n_nodes = plan

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.glo, self.ghi = f32(glo), f32(ghi)
        self.clo, self.chi = f32(clo), f32(chi)
        self.tgt = torch.as_tensor(np.asarray(tgt, np.int32), device=device)
        unit = torch.as_tensor(_halton_unit(n_nodes, d), device=device)
        self.nodes = self.glo[None, :] + unit * (self.ghi - self.glo)[None, :]
        self.factor = float(np.prod(ghi - glo)) / n_nodes


def _qmc_indicator_terms(nodes: torch.Tensor, f: torch.Tensor,
                         glo: torch.Tensor, ghi: torch.Tensor,
                         lo: torch.Tensor, hi: torch.Tensor, tgt: torch.Tensor,
                         n: float):
    """Per-box unscaled (count_raw, sum_raw) from densities f at the shared
    nodes: count_q = n vol(G) mean(f 1_q), sum_q = n vol(G) mean(node_t f
    1_q).  Boxes in slabs, so the (boxes x nodes) indicator stays bounded."""
    vol_g = torch.prod(ghi - glo)
    empty = torch.zeros((0,), dtype=DTYPE, device=f.device)
    cnt, sm = [empty], [empty]
    for start in range(0, lo.shape[0], kref.QUERY_SLAB):
        w = kref.inside_boxes(nodes, lo[start:start + kref.QUERY_SLAB],
                         hi[start:start + kref.QUERY_SLAB]) * f[None, :]
        tvals = nodes.T[tgt[start:start + kref.QUERY_SLAB].long()]
        cnt.append(n * vol_g * torch.mean(w, dim=1))
        sm.append(n * vol_g * torch.mean(tvals * w, dim=1))
    return torch.cat(cnt), torch.cat(sm)


def _qmc_shared_terms(x: torch.Tensor, H: torch.Tensor, inp: _QmcInputs):
    """Per-box unscaled (count_raw, sum_raw) from ONE plain density
    evaluation (eq. 6 at the shared nodes)."""
    f = kde_eval_H(inp.nodes, x, H, device=x.device)
    return _qmc_indicator_terms(inp.nodes, f, inp.glo, inp.ghi, inp.clo,
                                inp.chi, inp.tgt, x.shape[0])


def _qmc_kernel_terms(x: torch.Tensor, H: torch.Tensor, inp: _QmcInputs):
    """The same terms from the qmc_reduce kernel: its raw double sums times
    vol(G) / m (the sample size cancels)."""
    from repro_torch.kernels import ops as kops
    d = x.shape[1]
    Hf = torch.as_tensor(H, dtype=DTYPE, device=x.device)
    h_inv = torch.linalg.inv(Hf).contiguous()   # cuSOLVER returns it column-major
    log_norm = -0.5 * d * math.log(2.0 * math.pi) - 0.5 * torch.linalg.slogdet(Hf)[1]
    cnt_sums, sum_sums = kops.qmc_box_reduce(inp.nodes, x, h_inv, log_norm,
                                             inp.clo, inp.chi, inp.tgt)
    return inp.factor * cnt_sums, inp.factor * sum_sums


def _select(ops, counts, sums):
    ops_t = torch.as_tensor(np.asarray(ops, np.int32), device=counts.device)
    return _select_op(ops_t, counts, sums)


def batch_query_qmc(x: torch.Tensor, H: torch.Tensor, lo: np.ndarray,
                    hi: np.ndarray, tgt: np.ndarray, ops: np.ndarray,
                    scale: float, n_qmc: int = 4096,
                    backend: str = "torch") -> torch.Tensor:
    """Answer a mixed box batch against one full-H synopsis in one density
    pass.  lo/hi: (q, d) host arrays, planned on the host by `_qmc_plan`.
    backend="cuda" fuses the (nodes x sample) density with the (boxes x
    nodes) indicator reduction in the qmc_reduce kernel; "torch" evaluates
    the density vector with `kde_eval_H` and reduces it."""
    plan = _qmc_plan(_host64(x), _host64(H), lo, hi, n_qmc)
    if plan is None:                       # every box is zero-measure
        return torch.zeros((np.asarray(lo).shape[0],), dtype=DTYPE, device=x.device)
    inp = _QmcInputs(plan, tgt, x.shape[1], x.device)
    terms = _qmc_kernel_terms if backend == "cuda" else _qmc_shared_terms
    cnt_raw, sum_raw = terms(x, H, inp)
    return _select(ops, scale * cnt_raw, scale * sum_raw)


def batch_query_qmc_rff(x_host, H, rff, lo: np.ndarray, hi: np.ndarray,
                        tgt: np.ndarray, ops: np.ndarray, scale: float,
                        n_qmc: int = 4096) -> torch.Tensor:
    """`batch_query_qmc` with the density pass through a fitted RFF synopsis
    (`rff.eval_batch`, the rff_eval kernel on the card).  Shares `_qmc_plan`
    with the exact path, so both reduce over identical clipped boxes and
    nodes.  x_host is the fitted sample, used for planning only."""
    x64 = _host64(x_host)
    dev = rff.w.device
    plan = _qmc_plan(x64, _host64(H), lo, hi, n_qmc)
    if plan is None:                       # every box is zero-measure
        return torch.zeros((np.asarray(lo).shape[0],), dtype=DTYPE, device=dev)
    inp = _QmcInputs(plan, tgt, x64.shape[1], dev)
    f = rff.eval_batch(inp.nodes)
    cnt_raw, sum_raw = _qmc_indicator_terms(inp.nodes, f, inp.glo, inp.ghi,
                                            inp.clo, inp.chi, inp.tgt,
                                            float(x64.shape[0]))
    return _select(ops, scale * cnt_raw, scale * sum_raw)


def _estimates64(ops: np.ndarray, scale: float, cnt_raw: torch.Tensor,
                 sum_raw: torch.Tensor) -> np.ndarray:
    """COUNT / SUM / AVG per box in float64 on the host, from the unscaled
    terms of one replicate."""
    counts = scale * np.asarray(cnt_raw.detach().cpu(), np.float64)
    sums = scale * np.asarray(sum_raw.detach().cpu(), np.float64)
    avgs = np.where(counts > AVG_MIN_COUNT, sums / np.maximum(counts, 1e-12), 0.0)
    return np.select([ops == OP_COUNT, ops == OP_SUM], [counts, sums], avgs)


def qmc_rff_se(rff, x_host, H, lo: np.ndarray, hi: np.ndarray,
               tgt: np.ndarray, ops: np.ndarray, n_source: int, n_qmc: int,
               n_blocks: int = 8) -> Tuple[np.ndarray, int]:
    """(per-query SE, t dof) for the RFF QMC path, by batch-means over
    feature blocks: each block of D/B features gives an unbiased density
    (`block_densities`), every block reduces over the same plan and nodes,
    so the spread isolates feature-sampling variance."""
    q = np.asarray(lo).shape[0]
    x64 = _host64(x_host)
    plan = _qmc_plan(x64, _host64(H), lo, hi, n_qmc)
    if plan is None:                  # zero-measure boxes: estimate is 0
        return np.zeros((q,), np.float64), n_blocks - 1
    inp = _QmcInputs(plan, tgt, x64.shape[1], rff.w.device)
    ops = np.asarray(ops)
    fb = rff.block_densities(inp.nodes, n_blocks)            # (B, m)
    scale = n_source / x64.shape[0]
    ests = []
    for j in range(n_blocks):
        cnt_raw, sum_raw = _qmc_indicator_terms(inp.nodes, fb[j], inp.glo, inp.ghi,
                                                inp.clo, inp.chi, inp.tgt,
                                                float(x64.shape[0]))
        ests.append(_estimates64(ops, scale, cnt_raw, sum_raw))
    e = np.stack(ests)
    return e.std(axis=0, ddof=1) / math.sqrt(n_blocks), n_blocks - 1


def _qmc_box_answers(syn: KDESynopsis, qs: Sequence, n_qmc: int = 4096
                     ) -> np.ndarray:
    """Full-H answers for a group of box queries (objects with `lo`, `hi`,
    `op` and `target_index()`, as the reference's BoxQuery), batched."""
    x = syn.x[:, None] if syn.x.dim() == 1 else syn.x
    lo = np.asarray([q.lo for q in qs], np.float64)
    hi = np.asarray([q.hi for q in qs], np.float64)
    tgt = np.asarray([q.target_index() for q in qs], np.int32)
    ops = np.asarray([OP_CODES[q.op] for q in qs], np.int32)
    ans = batch_query_qmc(x, syn.H, lo, hi, tgt, ops,
                          syn.n_source / x.shape[0], n_qmc=n_qmc)
    return np.asarray(ans.detach().cpu(), np.float64)
