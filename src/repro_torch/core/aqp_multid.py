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
(`batch_query_qmc_rff`; on the "cuda" backend `qmc_rff_answers_and_se`
takes the answers and their feature-block CI from one launch).  The host
planning (`_qmc_plan`) is float64 numpy, as in the reference.  The port
adds a full-H path with no density pass and no hull: kernel-centred
quasi-MC (`batch_query_kernel`, `kernel_box_terms`; the draw_box_reduce
kernel on the card), which counts draws around every sample row in each
box.  `BoxQuery` and `BoxQueryBatch` are the legacy box surface over the
engine.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
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


# --- the legacy box surface ---------------------------------------------------
#
# `BoxQuery` / `BoxQueryBatch` predate the declarative engine;
# `BoxQueryBatch.run` is a deprecated shim that compiles to AqpQuery specs.

ColumnsKey = Optional[Tuple[str, ...]]


@dataclass(frozen=True)
class BoxQuery:
    """One aggregate over an axis-aligned box: OP WHERE lo_j <= X_j <= hi_j.
    `columns` names the joint synopsis (None against a single synopsis);
    `target` picks the SUM / AVG axis, a column name (needs `columns`) or an
    axis index, default axis 0."""
    op: str                                   # "count" | "sum" | "avg"
    lo: Tuple[float, ...]
    hi: Tuple[float, ...]
    columns: Optional[Tuple[str, ...]] = None
    target: Optional[Union[int, str]] = None

    def __post_init__(self):
        if self.op not in OP_CODES:
            raise ValueError(f"unknown op {self.op!r}; expected one of {sorted(OP_CODES)}")
        object.__setattr__(self, "lo", tuple(float(v) for v in np.ravel(self.lo)))
        object.__setattr__(self, "hi", tuple(float(v) for v in np.ravel(self.hi)))
        if len(self.lo) != len(self.hi):
            raise ValueError(f"lo/hi dimensionality mismatch: "
                             f"{len(self.lo)} vs {len(self.hi)}")
        if self.columns is not None:
            object.__setattr__(self, "columns", tuple(self.columns))
            if len(self.columns) != len(self.lo):
                raise ValueError(f"box has {len(self.lo)} axes but names "
                                 f"{len(self.columns)} columns")
        self.target_index()      # validate eagerly: planning must not fail late

    @property
    def d(self) -> int:
        return len(self.lo)

    def target_index(self) -> int:
        """`target` as an axis index (0 when unset)."""
        if self.target is None:
            return 0
        if isinstance(self.target, str):
            if self.columns is None or self.target not in self.columns:
                raise ValueError(f"target column {self.target!r} not among "
                                 f"box columns {self.columns}")
            return self.columns.index(self.target)
        t = int(self.target)
        if not 0 <= t < self.d:
            raise ValueError(f"target axis {t} out of range for d={self.d}")
        return t


@dataclass
class BoxQueryBatch:
    """A heterogeneous batch of legacy box queries, grouped by column tuple
    (each group one box dimensionality).  The reference's `plan` has no
    counterpart: the engine plans."""
    queries: Sequence[BoxQuery]
    _groups: Dict[ColumnsKey, List[int]] = field(init=False, repr=False)

    def __post_init__(self):
        self.queries = [q if isinstance(q, BoxQuery) else BoxQuery(*q)
                        for q in self.queries]
        groups: Dict[ColumnsKey, List[int]] = {}
        for i, q in enumerate(self.queries):
            groups.setdefault(q.columns, []).append(i)
        for key, idx in groups.items():
            dims = {self.queries[i].d for i in idx}
            if len(dims) > 1:
                raise ValueError(f"queries for synopsis {key} mix box "
                                 f"dimensionalities {sorted(dims)}")
        self._groups = groups

    def __len__(self) -> int:
        return len(self.queries)

    @property
    def column_groups(self) -> List[ColumnsKey]:
        return list(self._groups)

    def run(self, synopses, backend: Optional[str] = None) -> np.ndarray:
        """Deprecated: compiles to AqpQuery specs and executes them through
        the engine; answers in submission order."""
        import warnings

        warnings.warn(
            "BoxQueryBatch.run is deprecated; build AqpQuery specs and "
            "execute them through repro_torch.core.aqp_query.QueryEngine (or "
            "TelemetryStore.query)", DeprecationWarning, stacklevel=2)
        return run_legacy_boxes(self.queries, synopses, backend=backend)


def run_legacy_boxes(queries: Sequence[BoxQuery], synopses,
                     backend: Optional[str] = None) -> np.ndarray:
    """Execute legacy `BoxQuery` objects through the engine against a
    synopsis or a {columns: synopsis} mapping (the body of
    `BoxQueryBatch.run` and `KDESynopsis.query_box_batch`)."""
    from .aqp_query import execute_specs, from_box_query
    return execute_specs([from_box_query(q) for q in queries], synopses, backend=backend)


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


def grouped_family_moments(x: torch.Tensor, h_diag: torch.Tensor, boxes,
                           windows, g_axis: Sequence[int],
                           tgt: Sequence[int]) -> torch.Tensor:
    """The five moment sums (sum c, sum s, sum c^2, sum s^2, sum c s) of F
    GROUP BY families of one diagonal-bandwidth synopsis, as a (F, 5, Gmax)
    float32 tensor on the host: family f answers its categories' COUNT / SUM
    from the first two and its CI from all five.  boxes: F (lo, hi) shared
    boxes of d floats; windows: F (glo, ghi) category windows on the group
    axis (Gmax the most categories; shorter tables are padded with
    zero-width windows).  The families' boxes and window tables (equal
    tables once) go to the device in one copy, all families run in one
    launch of the aqp_grouped kernel (its plain version for a sample on the
    CPU), and the sums come back in one copy."""
    from repro_torch.kernels import ops as kops
    n_fam, d = len(boxes), x.shape[1]
    gmax = max(len(glo) for glo, _ in windows)
    tables: Dict[bytes, int] = {}
    rows, win = [], []
    for glo, ghi in windows:
        row = np.zeros((2, gmax), np.float32)
        row[0, :len(glo)] = glo
        row[1, :len(ghi)] = ghi
        idx = tables.setdefault(row.tobytes(), len(tables))
        if idx == len(rows):
            rows.append(row)
        win.append(idx)
    tab = np.stack(rows)                                          # (W, 2, Gmax)
    lo = np.asarray([b[0] for b in boxes], np.float32).reshape(n_fam, d)
    hi = np.asarray([b[1] for b in boxes], np.float32).reshape(n_fam, d)
    buf = torch.as_tensor(np.concatenate([lo.ravel(), hi.ravel(),
                                          tab[:, 0].ravel(), tab[:, 1].ravel()]),
                          device=x.device)
    nb, nw = n_fam * d, len(rows) * gmax
    five = kops.aqp_grouped_moments(
        x, h_diag, buf[:nb].view(n_fam, d), buf[nb:2 * nb].view(n_fam, d),
        buf[2 * nb:2 * nb + nw].view(-1, gmax), buf[2 * nb + nw:].view(-1, gmax),
        win, g_axis, tgt)
    return five.cpu()


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
    # repro: allow[instrument-drift] port span, listed in repro_torch.obs's docstring
    with obs.span("qmc.plan", q=len(lo), d=H.shape[0], n_qmc=n_qmc):
        return _plan_boxes(x_host, H, lo, hi, n_qmc)


def _plan_boxes(x_host: np.ndarray, H: np.ndarray, lo: np.ndarray,
                hi: np.ndarray, n_qmc: int):
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
    1_q).  f is (m,), giving (q,) each, or S density rows (S, m), giving
    (S, q) each from one indicator per box.  Boxes in slabs, so the
    (boxes x nodes) indicator stays bounded."""
    vol_g = torch.prod(ghi - glo)
    empty = torch.zeros(f.shape[:-1] + (0,), dtype=DTYPE, device=f.device)
    cnt, sm = [empty], [empty]
    for start in range(0, lo.shape[0], kref.QUERY_SLAB):
        w = kref.inside_boxes(nodes, lo[start:start + kref.QUERY_SLAB],
                         hi[start:start + kref.QUERY_SLAB]) * f[..., None, :]
        tvals = nodes.T[tgt[start:start + kref.QUERY_SLAB].long()]
        cnt.append(n * vol_g * torch.mean(w, dim=-1))
        sm.append(n * vol_g * torch.mean(tvals * w, dim=-1))
    return torch.cat(cnt, dim=-1), torch.cat(sm, dim=-1)


def _qmc_shared_terms(x: torch.Tensor, H: torch.Tensor, inp: _QmcInputs):
    """Per-box unscaled (count_raw, sum_raw) from ONE plain density
    evaluation (eq. 6 at the shared nodes)."""
    f = kde_eval_H(inp.nodes, x, H, device=x.device)
    return _qmc_indicator_terms(inp.nodes, f, inp.glo, inp.ghi, inp.clo,
                                inp.chi, inp.tgt, x.shape[0])


def _qmc_kernel_split_terms(x: torch.Tensor, H, inp: _QmcInputs, splits: int):
    """`_qmc_kernel_terms` for the whole sample (row 0) and for `splits`
    equal row chunks x[j c:(j + 1) c], c = m // splits (rows 1..splits), in
    ONE launch of the qmc_reduce kernel: (count_raw, sum_raw), each
    (splits + 1, q) on x's device."""
    from repro_torch.kernels import ops as kops
    d = x.shape[1]
    Hf = torch.as_tensor(H, dtype=DTYPE, device=x.device)
    h_inv = torch.linalg.inv(Hf).contiguous()   # cuSOLVER returns it column-major
    log_norm = -0.5 * d * math.log(2.0 * math.pi) - 0.5 * torch.linalg.slogdet(Hf)[1]
    cnt_sums, sum_sums = kops.qmc_box_reduce_split(inp.nodes, x, h_inv, log_norm,
                                                   inp.clo, inp.chi, inp.tgt,
                                                   splits)
    return inp.factor * cnt_sums, inp.factor * sum_sums


def _qmc_kernel_terms(x: torch.Tensor, H: torch.Tensor, inp: _QmcInputs):
    """The same terms from the qmc_reduce kernel: its raw double sums times
    vol(G) / m (the sample size cancels)."""
    cnt_raw, sum_raw = _qmc_kernel_split_terms(x, H, inp, 0)
    return cnt_raw[0], sum_raw[0]


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


# --- kernel-centred quasi-MC (full-H groups) ---------------------------------
#
# The KDE's mass in a box is the mean over the sample rows of the mass of
# N(x_i, H) in it; each row's Gaussian is integrated with its own K draws
# y_ij = x_i + L z_ij (L L^T = H), z_ij = Phi^-1 of Halton point i K + j + 1
# in the first d primes (float32, `_halton`).  No hull, clipping or node
# budget: every draw lies where a row's kernel puts its mass, so a box far
# smaller than the sample's hull still sees its share of the draws (the hull
# path's nodes miss most 8-column boxes).  The draws z depend only on
# (m, K, d): built once on the device and kept.

_normals: Dict[Tuple[int, int, str], torch.Tensor] = {}


def kernel_normals(m: int, draws: int, d: int, device) -> torch.Tensor:
    """(m draws, d) float32 standard-normal draws: row t is Phi^-1 (float64)
    of the Halton point t + 1.  Draws of m rows are the first m draws rows
    of any larger m's, so one tensor a (draws, d, device) is kept, of the
    most rows asked for, and sliced."""
    key = (int(draws), int(d), str(torch.device(device)))
    z = _normals.get(key)
    if z is None or z.shape[0] < m * draws:
        # repro: allow[instrument-drift] port span, listed in repro_torch.obs's docstring
        with obs.span("qmc.draws", m=m, K=draws, d=d):
            u = torch.as_tensor(_halton(m * draws, d).astype(np.float64), device=device)
            z = _normals[key] = torch.special.ndtri(u).to(DTYPE)
            obs.fence(z)
    return z[: m * draws]


def _kernel_factor(H) -> np.ndarray:
    """H's lower Cholesky factor, in float64 on the host (as the fit forms
    H), rounded to float32."""
    return np.linalg.cholesky(_host64(H)).astype(np.float32)


def kernel_box_terms(x: torch.Tensor, H, lo: np.ndarray, hi: np.ndarray,
                     tgt: np.ndarray, draws: int, splits: int,
                     backend: str = "torch") -> Tuple[torch.Tensor, torch.Tensor]:
    """(cnt, sum), each (splits + 1, q) float64 on the host: the draws
    inside each closed box and the sum of their target coordinate, row 0
    over the whole sample, row 1 + j over rows [j c, (j + 1) c), c =
    m // splits.  L and the boxes go to the device in one copy, the sums
    come back in one.  backend="cuda" runs the draw_box_reduce kernel,
    "torch" its plain version over slabs of draws; both take 1 <= d <= 8
    and raise ValueError above."""
    from repro_torch.kernels import ops as kops
    m, d = x.shape
    q = np.asarray(lo).shape[0]
    buf = torch.as_tensor(np.concatenate([
        _kernel_factor(H).ravel(), np.asarray(lo, np.float32).ravel(),
        np.asarray(hi, np.float32).ravel()]), device=x.device)
    l_chol = buf[:d * d].view(d, d)
    lo_t, hi_t = buf[d * d:d * d + q * d].view(q, d), buf[d * d + q * d:].view(q, d)
    tgt_t = torch.as_tensor(np.asarray(tgt, np.int32), device=x.device)
    z = kernel_normals(m, draws, d, x.device)
    fn = kops.draw_box_reduce if backend == "cuda" else kref.draw_box_reduce
    cnt, sm = torch.stack(fn(x, z, l_chol, lo_t, hi_t, tgt_t, splits)).cpu()
    return cnt, sm


def batch_query_kernel(x: torch.Tensor, H, lo: np.ndarray, hi: np.ndarray,
                       tgt: np.ndarray, ops: np.ndarray, scale: float,
                       draws: int) -> torch.Tensor:
    """Answer a mixed box batch against one full-H synopsis by the
    kernel-centred estimator, on the plain path: COUNT = scale / K times
    the draws inside the box, SUM the same weighted by the target
    coordinate, AVG their ratio (scale = n_source / m); (q,) float64 on the
    host."""
    cnt, sm = kernel_box_terms(x, H, lo, hi, tgt, draws, 0, "torch")
    return _select(ops, (scale / draws) * cnt[0], (scale / draws) * sm[0])


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


def qmc_rff_answers_and_se(rff, x_host, H, lo: np.ndarray, hi: np.ndarray,
                           tgt: np.ndarray, ops: np.ndarray, scale: float,
                           n_source: int, n_qmc: int, n_blocks: int = 8
                           ) -> Tuple[torch.Tensor, np.ndarray, int]:
    """(answers, per-query SE, t dof) of an RFF group: ONE plan, ONE launch
    of the rff_eval kernel for the density and its n_blocks feature blocks
    (`densities_and_blocks`), the indicator terms of those n_blocks + 1
    density rows in one batched pass, and one device-to-host copy.  The
    answers are `batch_query_qmc_rff`'s, the SE `qmc_rff_se`'s, as a (q,)
    float32 tensor on the host."""
    q = np.asarray(lo).shape[0]
    x64 = _host64(x_host)
    plan = _qmc_plan(x64, _host64(H), lo, hi, n_qmc)
    if plan is None:                  # zero-measure boxes: estimate is 0
        return torch.zeros((q,), dtype=DTYPE), np.zeros((q,), np.float64), n_blocks - 1
    inp = _QmcInputs(plan, tgt, x64.shape[1], rff.w.device)
    f, fb = rff.densities_and_blocks(inp.nodes, n_blocks)
    cnt_raw, sum_raw = _qmc_indicator_terms(inp.nodes, torch.cat([f[None], fb]),
                                            inp.glo, inp.ghi, inp.clo, inp.chi,
                                            inp.tgt, float(x64.shape[0]))
    cnt_raw, sum_raw = torch.stack([cnt_raw, sum_raw]).cpu()
    ans = _select(ops, scale * cnt_raw[0], scale * sum_raw[0])
    ops = np.asarray(ops)
    scale_b = n_source / x64.shape[0]
    e = np.stack([_estimates64(ops, scale_b, cnt_raw[1 + j], sum_raw[1 + j])
                  for j in range(n_blocks)])
    return ans, e.std(axis=0, ddof=1) / math.sqrt(n_blocks), n_blocks - 1


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
