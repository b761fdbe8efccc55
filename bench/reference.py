"""The plain reference the benchmark holds the program to.

Plain NumPy and PyTorch, written from the paper's equations and the
configuration's stated semantics.  It imports nothing of the program (nor
`jax`, nor the JAX package) and takes nothing the program made: it replays
the stream itself, refits every bandwidth itself and answers every spec
itself.  The one exception is stated where it happens: the answers that
are compared are worked out at the bandwidth the program chose (an
optimiser's path cannot be followed otherwise), and that bandwidth is judged
on its own first; the answers at the reference's own bandwidth are worked
out beside them and reported.

Precision: `prec="float64"` is the reference.  `prec="tf32"` is the control
of the benchmark's `correct` (the configuration states float32 with TF32
off, so the control is the same reference in float32 with every matrix
product in TF32).  TF32 is emulated exactly: both operands rounded to TF32's
10 stored mantissa bits, the product of two such numbers exact in float32
and summed in float32, which is what a tensor core does with TF32 inputs.

  * reservoirs: algorithm R with a numpy generator per reservoir seeded
    `store_seed + crc32(name) % 1000` (a joint: the names joined by "|"),
    one slot draw per element past the fill;
  * LSCV_h (paper eqs. 24-29, 43): the Mahalanobis quadratic forms S of all
    pairs as a Gram product, g(h) on the 150-point grid over [h0/4, 4 h0];
  * LSCV_H (eqs. 32-37): Nelder-Mead over the log-Cholesky parameters of H
    from H_start, standard coefficients, the configuration's iteration
    limit, g(H) from the same Gram form;
  * range COUNT / SUM / AVG (eqs. 9-10) with the normal-theory CI of the
    sample variance of the per-point terms (delta method for AVG);
  * box COUNT / SUM / AVG under a full H by quasi-MC, with the batch-means CI
    over K row chunks and a Student-t quantile, by the integrator the
    configuration names: Halton nodes over the boxes' support-clipped hull
    (`qmc_box_answers`, the default), or Halton draws around each sample
    row's kernel (`kernel_box_answers`);
  * Eq on a dictionary column: exact counts of the stream;
  * the stream's exact COUNT / SUM / AVG of every spec over the rows
    ingested up to a refresh (`stream_answers`), which the synopses
    approximate: a reading beside the check.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

AVG_MIN_COUNT = 1e-3      # COUNT at or below this is an empty selection: AVG 0
MAX_QMC_NODES = 32_768
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _dtype(prec: str) -> torch.dtype:
    return torch.float64 if prec == "float64" else torch.float32


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """float32 `a` rounded to the nearest TF32 value (10 stored mantissa
    bits, ties to even)."""
    bits = a.contiguous().view(torch.int32)
    low = bits & 0x1FFF
    keep = bits & ~0x1FFF
    odd = (bits >> 13) & 1
    up = (low > 0x1000) | ((low == 0x1000) & (odd == 1))
    return (keep + up.to(torch.int32) * 0x2000).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "tf32":
        return tf32_round(a.float()) @ tf32_round(b.float())
    return a @ b


# --- ingest ------------------------------------------------------------------

def reservoir_seed(store_seed: int, key) -> int:
    name = key if isinstance(key, str) else "|".join(key)
    return store_seed + zlib.crc32(name.encode()) % 1000


class Reservoir:
    """Algorithm R over rows (a 1-D column, or (m, d) rows of a joint)."""

    def __init__(self, capacity: int, seed: int, width: int = 0):
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self.buf = np.empty((capacity, width) if width else (capacity,), np.float32)
        self.n_seen = 0
        self.n_filled = 0

    def add(self, rows: np.ndarray) -> None:
        m = rows.shape[0]
        if m == 0:
            return
        k = 0
        if self.n_filled < self.capacity and self.n_seen == self.n_filled:
            k = min(self.capacity - self.n_filled, m)
            self.buf[self.n_filled:self.n_filled + k] = rows[:k]
            self.n_filled += k
            self.n_seen += k
        if k < m:
            idx = self.n_seen + np.arange(m - k)
            slot = self.rng.integers(0, idx + 1)
            hit = slot < self.n_filled
            # in stream order: a slot drawn twice keeps the later row
            self.buf[slot[hit]] = rows[k:][hit]
            self.n_seen += m - k

    def sample(self) -> np.ndarray:
        return self.buf[: self.n_filled]


class Ingest:
    """The store's sampling state, replayed from the same batches: a
    reservoir per column, one per tracked joint, exact counts per code of
    the dictionary columns."""

    def __init__(self, capacity: int, store_seed: int, columns: Sequence[str],
                 joints: Sequence[Tuple[str, ...]], dictionary: Sequence[str]):
        self.columns = {c: Reservoir(capacity, reservoir_seed(store_seed, c))
                        for c in columns}
        self.joints = {tuple(j): Reservoir(capacity, reservoir_seed(store_seed, tuple(j)),
                                           width=len(j)) for j in joints}
        self.codes = {c: {} for c in dictionary}

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        for c, v in batch.items():
            self.columns[c].add(np.asarray(v, np.float32))
            if c in self.codes:
                vals, cnt = np.unique(np.asarray(v, np.float32), return_counts=True)
                table = self.codes[c]
                for code, k in zip(vals.tolist(), cnt.tolist()):
                    table[code] = table.get(code, 0) + k
        for j, res in self.joints.items():
            if all(c in batch for c in j):
                res.add(np.stack([np.asarray(batch[c], np.float32) for c in j], axis=1))

    def digests(self) -> Dict[str, int]:
        """crc32 of every reservoir's retained rows, keyed by name."""
        out = {c: zlib.crc32(r.sample().tobytes()) for c, r in self.columns.items()}
        out.update({"|".join(j): zlib.crc32(r.sample().tobytes())
                    for j, r in self.joints.items()})
        return out


# --- pairwise quadratic forms ------------------------------------------------

def _rows(x, device, dtype) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(x, np.float64), device=device)
    return (x[:, None] if x.dim() == 1 else x).to(dtype)


def _triangle_blocks(y: torch.Tensor, prec: str, block: int):
    """For y (n, d) with quadratic form |y_i - y_j|^2, yields S of each row
    block [r0, r1) against the columns [r0, n): the pairs i < j, and +inf on
    and below the diagonal (so exp(-S a) is 0 there)."""
    n = y.shape[0]
    q = torch.sum(y * y, dim=1)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        s = q[r0:r1, None] + q[None, r0:] - 2.0 * matmul(y[r0:r1], y[r0:].T, prec).to(y.dtype)
        diag = s[:, : r1 - r0]
        diag.masked_fill_(~torch.ones_like(diag, dtype=torch.bool).triu(1), math.inf)
        yield s


def _whiten(x: torch.Tensor, a_inv: torch.Tensor, prec: str) -> torch.Tensor:
    """y = x L with L L^T = a_inv, so (x_i - x_j)^T a_inv (x_i - x_j) =
    |y_i - y_j|^2."""
    return matmul(x, torch.linalg.cholesky(a_inv), prec).to(x.dtype)


def covariance(x: torch.Tensor) -> torch.Tensor:
    """The unbiased sample covariance (eqs. 22-23)."""
    c = x - x.mean(dim=0, keepdim=True)
    return (c.T @ c) / (x.shape[0] - 1)


# --- LSCV_h ------------------------------------------------------------------

def h0_start(n: int, d: int) -> float:
    """eq. 28."""
    rk_over_mu2 = 1.0 / (2.0 ** d * math.pi ** (d / 2.0) * d ** 2)
    r_f2 = d * (d + 2.0) / (2.0 ** (d + 2) * math.pi ** (d / 2.0))
    return (rk_over_mu2 / (r_f2 * n)) ** (1.0 / (d + 4))


def lscv_h_curve(x, n_h: int, extra_h: Sequence[float] = (), prec: str = "float64",
                 device="cpu", block: int = 1024, h_chunk: int = 4):
    """(h grid, g on the grid, g at each of `extra_h`) of LSCV_h (eq. 24 in
    the §4.5 form): g(h) = h^-d (2/n^2 sum_{i<j} [c_KK e^{-S/4h^2} -
    2 c_K e^{-S/2h^2}] + c_KK / n), S the pairs' Mahalanobis forms under
    the sample covariance, the grid n_h points over [h0/4, 4 h0]."""
    dt = _dtype(prec)
    xt = _rows(x, device, dt)
    n, d = xt.shape
    sigma = covariance(xt)
    det = torch.linalg.det(sigma)
    y = _whiten(xt, torch.linalg.inv(sigma), prec)
    h0 = h0_start(n, d)
    grid = np.linspace(h0 / 4.0, 4.0 * h0, n_h)
    hs = torch.as_tensor(np.concatenate([grid, np.asarray(extra_h, np.float64)]),
                         device=device, dtype=dt)
    inv4 = 0.25 / (hs * hs)
    s1 = torch.zeros_like(hs)      # sum of e^{-S/4h^2}
    s2 = torch.zeros_like(hs)      # sum of e^{-S/2h^2} = (e^{-S/4h^2})^2
    for s in _triangle_blocks(y, prec, block):
        s.neg_()
        for c0 in range(0, hs.shape[0], h_chunk):
            e = (s[None] * inv4[c0:c0 + h_chunk, None, None]).exp_()
            s1[c0:c0 + h_chunk] += e.sum(dim=(1, 2))
            s2[c0:c0 + h_chunk] += torch.linalg.vector_norm(e, dim=(1, 2)) ** 2
    det_root = det ** -0.5
    c_k = (2.0 * math.pi) ** (-d / 2.0) * det_root
    c_kk = (4.0 * math.pi) ** (-d / 2.0) * det_root
    t = c_kk * s1 - 2.0 * c_k * s2
    g = hs ** (-d) * (2.0 / (n * n) * t + c_kk / n)
    g = g.double().cpu().numpy()
    return grid, g[:n_h], g[n_h:]


# --- LSCV_H ------------------------------------------------------------------

def g_of_H(xt: torch.Tensor, H: np.ndarray, prec: str, block: int = 2048) -> float:
    """eq. 32: 2/n^2 sum_{i<j} [c_KK e^{-s/4} - 2 c_K e^{-s/2}] + R(K)/n with
    s = (x_i - x_j)^T H^-1 (x_i - x_j)."""
    n, d = xt.shape
    Ht = torch.as_tensor(H, device=xt.device, dtype=xt.dtype)
    det = float(torch.linalg.det(Ht.double()))
    if not det > 0.0:
        return math.inf
    y = _whiten(xt, torch.linalg.inv(Ht), prec)
    s1 = torch.zeros((), device=xt.device, dtype=xt.dtype)
    s2 = torch.zeros((), device=xt.device, dtype=xt.dtype)
    for s in _triangle_blocks(y, prec, block):
        e = s.mul_(-0.25).exp_()
        s1 += e.sum()
        s2 += torch.linalg.vector_norm(e) ** 2
    det_root = det ** -0.5
    c_k = (2.0 * math.pi) ** (-d / 2.0) * det_root
    c_kk = (4.0 * math.pi) ** (-d / 2.0) * det_root
    return float(2.0 / (n * n) * (c_kk * s1 - 2.0 * c_k * s2) + c_kk / n)


def g_of_H_rows(x, H: np.ndarray, prec: str = "float64", device="cpu") -> float:
    """`g_of_H` of sample rows given as an array."""
    return g_of_H(_rows(x, device, _dtype(prec)), H, prec)


def h_start(x64: np.ndarray) -> np.ndarray:
    """eq. 37: (4/(d+2))^(1/(d+4)) n^(-1/(d+4)) Sigma^(1/2)."""
    n, d = x64.shape
    sigma = np.cov(x64, rowvar=False, ddof=1).reshape(d, d)
    w, v = np.linalg.eigh(sigma)
    root = (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T
    return (4.0 / (d + 2.0)) ** (1.0 / (d + 4)) * n ** (-1.0 / (d + 4)) * root


def theta_to_H(theta: np.ndarray, d: int) -> np.ndarray:
    """log-Cholesky: theta packs L's lower triangle row by row, the
    diagonal as its log; H = L L^T."""
    L = np.zeros((d, d))
    L[np.tril_indices(d)] = theta
    L[np.diag_indices(d)] = np.exp(np.diag(L))
    return L @ L.T


def H_to_theta(H: np.ndarray) -> np.ndarray:
    L = np.linalg.cholesky(H)
    L[np.diag_indices(H.shape[0])] = np.log(np.diag(L))
    return L[np.tril_indices(H.shape[0])]


def nelder_mead(fun, x0: np.ndarray, max_iter: int, init_scale: float = 0.1,
                xtol: float = 1e-6, ftol: float = 1e-9):
    """Nelder-Mead with the standard coefficients (reflection 1, expansion
    2, contraction 1/2, shrink 1/2), the initial simplex x0 plus
    init_scale |x0_k| along each axis k; each step evaluates the
    reflection, expansion and contraction points and takes the first of
    expansion (fr < best and fe < fr), reflection (fr < second worst),
    contraction (fc < worst), else shrinks towards the best.  Returns
    (best point, its value, evaluations)."""
    k = x0.shape[0]
    steps = np.where(np.abs(x0) > 1e-8, init_scale * np.abs(x0), init_scale)
    simplex = np.vstack([x0, x0 + np.diag(steps)])
    values = np.array([fun(p) for p in simplex])
    nfev = k + 1
    order = np.argsort(values, kind="stable")
    simplex, values = simplex[order], values[order]
    for _ in range(max_iter):
        if not (values[-1] - values[0] > ftol
                or np.max(np.abs(simplex - simplex[0])) > xtol):
            break
        centroid = simplex[:-1].mean(axis=0)
        xr = centroid + (centroid - simplex[-1])
        xe = centroid + 2.0 * (centroid - simplex[-1])
        xc = centroid + 0.5 * (simplex[-1] - centroid)
        fr, fe, fc = fun(xr), fun(xe), fun(xc)
        nfev += 3
        if fr < values[0] and fe < fr:
            simplex[-1], values[-1] = xe, fe
        elif fr < values[-2]:
            simplex[-1], values[-1] = xr, fr
        elif fc < values[-1]:
            simplex[-1], values[-1] = xc, fc
        else:
            simplex = simplex[0] + 0.5 * (simplex - simplex[0])
            values = np.array([fun(p) for p in simplex])
            nfev += k + 1
        order = np.argsort(values, kind="stable")
        simplex, values = simplex[order], values[order]
    return simplex[0], float(values[0]), nfev


def lscv_H_fit(x, max_iter: int, prec: str = "float64", device="cpu"):
    """LSCV_H: (H, g(H), g(H_start), H_start, evaluations)."""
    x64 = np.asarray(x, np.float64)
    x64 = x64[:, None] if x64.ndim == 1 else x64
    d = x64.shape[1]
    xt = _rows(x64, device, _dtype(prec))
    H0 = h_start(x64)

    def objective(theta):
        return g_of_H(xt, theta_to_H(theta, d), prec)

    theta, g_best, nfev = nelder_mead(objective, H_to_theta(H0), max_iter)
    return theta_to_H(theta, d), g_best, objective(H_to_theta(H0)), H0, nfev


# --- quantiles ---------------------------------------------------------------

def norm_ppf(p: float) -> float:
    return float(torch.special.ndtri(torch.tensor(p, dtype=torch.float64)))


def t_ppf(p: float, dof: int) -> float:
    """Student-t quantile: bisection on the CDF, integrated from the density
    by Simpson's rule (4 096 panels; the CDF to ~1e-13)."""
    lg = math.lgamma((dof + 1) / 2.0) - math.lgamma(dof / 2.0)
    c = math.exp(lg) / math.sqrt(dof * math.pi)

    def cdf(t):
        u = np.linspace(0.0, t, 4097)
        f = c * (1.0 + u * u / dof) ** (-(dof + 1) / 2.0)
        h = t / 4096
        return 0.5 + h / 3.0 * (f[0] + f[-1] + 4 * f[1:-1:2].sum() + 2 * f[2:-1:2].sum())

    lo, hi = 0.0, 100.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if cdf(mid) < p else (lo, mid)
    return 0.5 * (lo + hi)


def _select(agg: str, count: np.ndarray, total: np.ndarray) -> np.ndarray:
    if agg == "count":
        return count
    if agg == "sum":
        return total
    return np.where(count > AVG_MIN_COUNT, total / np.maximum(count, 1e-300), 0.0)


# --- range answers (eqs. 9-10) -----------------------------------------------

def _phi_diff(za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
    """Phi(zb) - Phi(za) from whichever tail keeps its relative precision."""
    upper = (za + zb) > 0
    u = torch.where(upper, za, -zb)
    v = torch.where(upper, zb, -za)
    r2 = 1.0 / math.sqrt(2.0)
    return 0.5 * (torch.special.erfc(u * r2) - torch.special.erfc(v * r2))


def range_answers(x, h: float, specs, n_source: int, ci_level: float,
                  prec: str = "float64", device="cpu"):
    """(estimate, ci_lo, ci_hi) per Range spec (`.aggregate`, `.lo[0]`,
    `.hi[0]`): with t_c = [Phi((y - X_i)/h)]_a^b and t_s = X_i t_c -
    h [phi((y - X_i)/h)]_a^b over the m sample points, COUNT = s sum t_c,
    SUM = s sum t_s (s = n_source / m); SE = s sqrt(m/(m-1) (sum t^2 -
    (sum t)^2/m)), AVG's by the delta method; est +- z SE."""
    dt = _dtype(prec)
    xt = torch.as_tensor(np.asarray(x, np.float64), device=device).to(dt)
    m = xt.shape[0]
    a = torch.as_tensor([s.lo[0] for s in specs], device=device, dtype=torch.float64).to(dt)
    b = torch.as_tensor([s.hi[0] for s in specs], device=device, dtype=torch.float64).to(dt)
    za = (a[:, None] - xt[None]) / h
    zb = (b[:, None] - xt[None]) / h
    tc = _phi_diff(za, zb)
    dens = (torch.exp(-0.5 * zb * zb) - torch.exp(-0.5 * za * za)) / math.sqrt(2.0 * math.pi)
    ts = xt[None] * tc - h * dens
    ones = torch.ones((m, 1), device=device, dtype=dt)
    # the sums over the sample are products with a ones vector (a GEMV)
    sums = [matmul(t, ones, prec)[:, 0].double().cpu().numpy()
            for t in (tc, ts, tc * tc, ts * ts, tc * ts)]
    return _moment_answers(specs, sums, n_source / m, m, norm_ppf(0.5 + ci_level / 2.0))


def _moment_answers(specs, sums, scale: float, m: int, z: float):
    c1, s1, c2, s2, cs = sums
    corr = m / (m - 1.0)
    count, total = scale * c1, scale * s1
    se_c = scale * np.sqrt(corr * np.maximum(c2 - c1 * c1 / m, 0.0))
    se_s = scale * np.sqrt(corr * np.maximum(s2 - s1 * s1 / m, 0.0))
    ok = count > AVG_MIN_COUNT
    r = np.where(ok, s1 / np.where(c1 != 0.0, c1, 1.0), 0.0)
    quad = np.maximum(s2 - 2.0 * r * cs + r * r * c2, 0.0)
    se_a = np.where(ok, scale * np.sqrt(corr * quad) / np.maximum(count, AVG_MIN_COUNT),
                    np.inf)
    out = []
    for i, sp in enumerate(specs):
        est = float(_select(sp.aggregate, count[i:i + 1], total[i:i + 1])[0])
        se = {"count": se_c, "sum": se_s, "avg": se_a}[sp.aggregate][i]
        out.append((est, est - z * se, est + z * se))
    return out


# --- Eq answers (exact counts) -----------------------------------------------

def eq_answers(codes: Dict[float, int], specs) -> List[Tuple[float, float, float]]:
    """COUNT / SUM / AVG of the codes inside [lo, hi] of the whole stream:
    exact, with a zero-width interval."""
    out = []
    for sp in specs:
        cnt = sum(k for c, k in codes.items() if sp.lo[0] <= c <= sp.hi[0])
        tot = sum(c * k for c, k in codes.items() if sp.lo[0] <= c <= sp.hi[0])
        est = float(cnt) if sp.aggregate == "count" else (
            float(tot) if sp.aggregate == "sum" else (tot / cnt if cnt > 0 else 0.0))
        out.append((est, est, est))
    return out


# --- box answers under a full H (quasi-MC) -----------------------------------

def halton(n: int, d: int, start: int = 0) -> np.ndarray:
    """The n points of index start + 1 .. start + n of the Halton sequence
    in the first d primes, as float64 radical inverses rounded to float32."""
    out = np.zeros((n, d))
    for k, p in enumerate(PRIMES[:d]):
        i = np.arange(start + 1, start + n + 1)
        f, denom = np.zeros(n), float(p)
        while i.max() > 0:
            f += (i % p) / denom
            i = i // p
            denom *= p
        out[:, k] = f
    return out.astype(np.float32)


def qmc_box_answers(x, H: np.ndarray, specs, n_source: int, n_qmc: int, k_sub: int,
                    ci_level: float, prec: str = "float64", device="cpu",
                    node_block: int = 2048):
    """(estimate, ci_lo, ci_hi) per Box spec under the full bandwidth H.

    Plan: every box clipped to the sample's support +- 6 sqrt(H_jj), the
    hull G of the clipped boxes, N = 2^ceil(log2(n_qmc / r)) nodes (N in
    [n_qmc, MAX_QMC_NODES]) for r the smallest box's share of vol(G), the
    nodes glo + u (ghi - glo) in float32 for the Halton points u, and
    clo, chi, glo, ghi in float32 where nodes meet them.  Estimate: with
    F(y) = sum_i N(y - X_i; H), COUNT = s vol(G)/N sum_{y in box} F(y) and
    SUM = s vol(G)/N sum_{y in box} y_t F(y), s = n_source / m.  CI: the
    same over K equal row chunks of the sample (s_k = n_source / (m // K)),
    SE = std(ddof 1)/sqrt(K), est +- t_{K-1} SE."""
    x64 = np.asarray(x, np.float64)
    m, d = x64.shape
    lo = np.asarray([s.lo for s in specs], np.float64)
    hi = np.asarray([s.hi for s in specs], np.float64)
    sig = np.sqrt(np.diag(H))
    slo, shi = x64.min(axis=0) - 6.0 * sig, x64.max(axis=0) + 6.0 * sig
    clo, chi = np.clip(lo, slo, shi), np.clip(hi, slo, shi)
    glo, ghi = clo.min(axis=0), chi.max(axis=0)
    vol = float(np.prod(ghi - glo))
    ratios = np.prod(chi - clo, axis=1) / vol
    ratios = ratios[ratios > 0]
    r_min = float(ratios.min()) if ratios.size else 1.0
    n_nodes = int(min(MAX_QMC_NODES, n_qmc / max(r_min, n_qmc / MAX_QMC_NODES)))
    n_nodes = 1 << max(int(np.ceil(np.log2(max(n_nodes, 1)))), int(np.ceil(np.log2(n_qmc))))
    g32lo, g32hi = glo.astype(np.float32), ghi.astype(np.float32)
    nodes32 = g32lo[None] + halton(n_nodes, d) * (g32hi - g32lo)[None]
    inside = np.all((nodes32[None] >= clo.astype(np.float32)[:, None])
                    & (nodes32[None] <= chi.astype(np.float32)[:, None]), axis=2)
    tgt = np.asarray([s.target for s in specs])

    dt = _dtype(prec)
    k = min(k_sub, m // 2)
    chunk = m // k
    Ht = torch.as_tensor(H, device=device, dtype=torch.float64)
    log_norm = -0.5 * d * math.log(2.0 * math.pi) - 0.5 * float(torch.linalg.slogdet(Ht)[1])
    xt = torch.as_tensor(x64, device=device).to(dt)
    h_inv = torch.linalg.inv(Ht).to(dt)
    yt = _whiten(xt, h_inv, prec)
    qy = torch.sum(yt * yt, dim=1)
    nodes = torch.as_tensor(nodes32.astype(np.float64), device=device).to(dt)
    # F per node: the whole sample (column 0) and each row chunk (1..K)
    f = torch.zeros((n_nodes, k + 1), device=device, dtype=torch.float64)
    for b0 in range(0, n_nodes, node_block):
        yn = _whiten(nodes[b0:b0 + node_block], h_inv, prec)
        quad = (torch.sum(yn * yn, dim=1)[:, None] + qy[None]
                - 2.0 * matmul(yn, yt.T, prec).to(dt))
        kern = torch.exp(log_norm - 0.5 * torch.clamp_min(quad, 0.0))
        f[b0:b0 + node_block, 0] = kern.sum(dim=1).double()
        f[b0:b0 + node_block, 1:] = kern[:, : k * chunk].reshape(
            -1, k, chunk).sum(dim=2).double()
    ind = torch.as_tensor(inside, device=device, dtype=torch.float64)
    nt = torch.as_tensor(nodes32.astype(np.float64), device=device)[:, tgt].T  # (q, N)
    factor = vol / n_nodes
    cnt = (factor * (ind @ f)).cpu().numpy()                 # (q, K + 1)
    tot = (factor * ((ind * nt) @ f)).cpu().numpy()
    out = []
    t = t_ppf(0.5 + ci_level / 2.0, k - 1)
    for i, sp in enumerate(specs):
        est = float(_select(sp.aggregate, n_source / m * cnt[i, :1], n_source / m * tot[i, :1])[0])
        reps = _select(sp.aggregate, n_source / chunk * cnt[i, 1:], n_source / chunk * tot[i, 1:])
        se = float(np.std(reps, ddof=1) / math.sqrt(k))
        out.append((est, est - t * se, est + t * se))
    return out


def kernel_box_answers(x, H: np.ndarray, specs, n_source: int, draws: int, k_sub: int,
                       ci_level: float, prec: str = "float64", device="cpu",
                       row_block: int = 1024):
    """(estimate, ci_lo, ci_hi) per Box spec under the full bandwidth H, by
    kernel-centred quasi-MC: the KDE's mass in a box is the mean over the
    sample rows of the mass of N(X_i, H) in it, and each row's Gaussian is
    integrated with its own K = `draws` points.

    Draws: with L the lower Cholesky factor of H, draw j of row i is
    y_ij = X_i + L z_ij, z_ij = Phi^-1(u_t) (float64) for u_t the Halton
    point t = i K + j + 1 in the first d primes as `halton()` gives it
    (float32).  No hull, no clipping and no node budget: every draw lies
    where a row's kernel puts its mass.  COUNT = s / K sum_i sum_j
    1[lo <= y_ij <= hi] (closed box, every axis), SUM the same with each
    term weighted by y_ij[target], s = n_source / m; AVG by `_select`.
    CI: the same sums over k = min(k_sub, m // 2) equal row chunks of
    m // k rows (s_c = n_source / (m // k)), SE = std(ddof 1) / sqrt(k),
    est +- t_{k-1} SE.  With `prec="tf32"` (the control) L z goes through
    `matmul`'s TF32 emulation, and the draws, the box tests and each row
    block's sums are float32.  Rows are taken `row_block` at a time, so
    memory stays at row_block K draws whatever m."""
    x64 = np.asarray(x, np.float64)
    x64 = x64[:, None] if x64.ndim == 1 else x64
    m, d = x64.shape
    K = int(draws)
    dt = _dtype(prec)
    k = min(k_sub, m // 2)
    chunk = m // k
    L = torch.linalg.cholesky(torch.as_tensor(np.asarray(H, np.float64).reshape(d, d),
                                              device=device))
    lt = L.T.to(dt)
    lo = torch.as_tensor([s.lo for s in specs], device=device, dtype=torch.float64).to(dt)
    hi = torch.as_tensor([s.hi for s in specs], device=device, dtype=torch.float64).to(dt)
    tgt = torch.as_tensor([s.target for s in specs], device=device)
    xt = torch.as_tensor(x64, device=device).to(dt)
    # per row chunk (columns 0..k-1; rows past k * chunk in column k)
    cnt = torch.zeros((len(specs), k + 1), device=device, dtype=torch.float64)
    tot = torch.zeros_like(cnt)
    for r0 in range(0, m, row_block):
        r1 = min(m, r0 + row_block)
        u = torch.as_tensor(halton((r1 - r0) * K, d, start=r0 * K).astype(np.float64),
                            device=device)
        z = torch.special.ndtri(u).to(dt)
        y = torch.repeat_interleave(xt[r0:r1], K, dim=0) + matmul(z, lt, prec).to(dt)
        inside = torch.ones((len(specs), y.shape[0]), device=device, dtype=torch.bool)
        for a in range(d):
            inside &= (y[None, :, a] >= lo[:, a, None]) & (y[None, :, a] <= hi[:, a, None])
        w = inside.to(dt)
        wy = w * y[:, tgt].T
        cid = torch.clamp((torch.arange(r0, r1, device=device) // chunk), max=k)
        first, last = int(cid[0]), int(cid[-1])
        for c in range(first, last + 1):
            sel = torch.repeat_interleave(cid == c, K)
            cnt[:, c] += w[:, sel].sum(dim=1).double()
            tot[:, c] += wy[:, sel].sum(dim=1).double()
    cnt, tot = cnt.cpu().numpy(), tot.cpu().numpy()
    out = []
    t = t_ppf(0.5 + ci_level / 2.0, k - 1)
    for i, sp in enumerate(specs):
        est = float(_select(sp.aggregate, n_source / (m * K) * cnt[i].sum(keepdims=True),
                            n_source / (m * K) * tot[i].sum(keepdims=True))[0])
        reps = _select(sp.aggregate, n_source / (chunk * K) * cnt[i, :k],
                       n_source / (chunk * K) * tot[i, :k])
        se = float(np.std(reps, ddof=1) / math.sqrt(k))
        out.append((est, est - t * se, est + t * se))
    return out


# --- the stream's exact answers ------------------------------------------------

def box_sums(batch: Dict[str, np.ndarray], specs, device="cpu") -> np.ndarray:
    """(2, q): the exact COUNT and SUM of each spec over one batch's rows.
    Every spec is a closed box over its columns (a Range or an Eq a box of
    one column); SUM reads the column `columns[target]`.  float64."""
    out = np.zeros((2, len(specs)))
    groups: Dict[tuple, List[int]] = {}
    for i, sp in enumerate(specs):
        groups.setdefault(tuple(sp.columns), []).append(i)
    for cols, idx in groups.items():
        v = torch.as_tensor(np.stack([np.asarray(batch[c], np.float64) for c in cols]),
                            device=device)                                 # (d, n)
        lo = torch.as_tensor([specs[i].lo for i in idx], device=device, dtype=torch.float64)
        hi = torch.as_tensor([specs[i].hi for i in idx], device=device, dtype=torch.float64)
        inside = torch.ones((len(idx), v.shape[1]), device=device, dtype=torch.bool)
        for a in range(len(cols)):
            inside &= (v[None, a] >= lo[:, a, None]) & (v[None, a] <= hi[:, a, None])
        w = inside.double()
        tgt = torch.as_tensor([specs[i].target for i in idx], device=device)
        out[0, idx] = w.sum(dim=1).cpu().numpy()
        out[1, idx] = (w * v[tgt]).sum(dim=1).cpu().numpy()
    return out


def stream_answers(setup, pool, specs, ks: Sequence[int], device="cpu") -> np.ndarray:
    """(len(ks), q): each spec's exact COUNT / SUM / AVG over every row
    ingested up to refresh k: the set-up batches, then the pool's batches
    of refreshes 0 .. k (refresh j ingests pool[j % len(pool)]; refresh 0
    is the warm-up).  Counted once a batch, so a refresh costs a product."""
    base = sum(box_sums(b, specs, device) for b in setup)                  # (2, q)
    per = np.stack([box_sums(b, specs, device) for b in pool])             # (P, 2, q)
    p = len(pool)
    ks = np.asarray(ks, np.int64)
    times = (ks[:, None] - np.arange(p)[None]) // p + 1                    # (R, P)
    times = np.where(np.arange(p)[None] <= ks[:, None], times, 0).astype(np.float64)
    count = base[0][None] + times @ per[:, 0]
    total = base[1][None] + times @ per[:, 1]
    return np.stack([_select(sp.aggregate, count[:, i], total[:, i])
                     for i, sp in enumerate(specs)], axis=1)
