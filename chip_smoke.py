#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each failing loudly (a failed check raises; the script then exits
non-zero and prints no result line):

  1. the card (nvidia-smi) and the kernel build from `src/repro_torch/kernels/
     csrc`, one nvcc per source, all started together;
  2. the main path at full size: a `TelemetryStore` of 32 768 rows per sample
     fed 1 000 000 streamed rows, PLUGIN fits on the pairwise kernel, one
     `store.query` of 1 024 mixed Range / Box / Eq specs through the aqp_batch
     and aqp_boxes kernels; answers held against a float64 closed form of the
     same synopses and against exact counts of the stream, launch counts
     read, and the batch repeated for bit-identical answers from the caches;
  3. path A, the same store and specs with `selector="lscv_h"`: LSCV_h fits
     (two columns and the 3-column joint, 150 grid points each) on the
     sv_precompute and lscv_grid kernels, answers on aqp_batch / aqp_boxes,
     launch counts read for the first query and its bit-identical repeat;
  4. path B, `store.joint_synopsis(joint, selector="lscv_H")`: Nelder-Mead
     (150 iterations) with one gh_fused launch per objective evaluation; H
     SPD and g(H) <= g(H_start);
  5. path C, GROUP BY: 104 GROUP BY specs over the 64-code model_id column
     through a joint that holds it, one aqp_grouped launch per family; each
     family held against its boxes fanned out through a float64 oracle and
     against the stream's exact per-code counts within the CIs; a
     bit-identical repeat with no fit launches;
  6. path D, full-H serving: the 1 024-spec mix with `selector="lscv_H"`
     (the joint's fit cached from path B, the two 1-D columns fitted on
     gh_fused), every group on the RFF density synopsis ("auto" at 32 768
     rows: rff_eval launches), then the same specs with
     `kde_backend="exact"` (qmc_reduce launches); the exact answers held
     against a float64 oracle of eq. 6 on the same Halton nodes, the RFF
     answers against the exact ones within their CIs; bit-identical repeats;
  7. path E, `kde_eval` at 4 096 points on a 1-D sample and on the joint,
     and the trapezoid forms of eqs. 9-10 on 64 ranges against the closed
     forms (kde_eval launches);
  8. every kernel against its plain PyTorch version on the card, on the
     very inputs of its calls on those paths (recorded while they ran), at
     an extra shape and at edge shapes, and against a float64 oracle on a
     subsample; two launches of lscv_grid_sums, gh_fused_sum and
     aqp_grouped_sums on the same inputs giving the same bits; PLUGIN and
     LSCV_h against the paper's sequential oracles; the kernel's own
     eqs. 49/50 tile mapping exhaustively;
  9. kernel and plain-version times (CUDA events, median of warm runs) on
     the inputs of each kernel's first call on its path (the largest call
     for rff_density, whose first call is the probe gate's; for
     gh_fused_sum also path D's first 1-D call), beside the bound and the
     SFU floor at the SM clock read after the kernel's windows.

It prints a {"kernels": [...]} JSON line, the card's name and power limit,
and last {"ok": true, "device": {...}}.  Exits non-zero without a CUDA
device, and when run without the repository around it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

CAPACITY = 32_768          # per-column sample: bench_plugin.py's largest n
STREAM_ROWS = 1_000_000
BATCH_ROWS = 50_000
N_CODES = 64
NUMERIC = ("loss", "latency_ms", "grad_norm", "tokens")
JOINT = ("loss", "latency_ms", "grad_norm")
RANGE_COLS = ("loss", "latency_ms")
N_RANGE, N_BOX, N_EQ = 512, 384, 128
GJOINT = ("loss", "latency_ms", "model_id")     # path C's joint, with the group column
N_GROUP, N_GROUP_SELF = 96, 8                   # GROUP BY specs; AVG of model_id itself
N_E_POINTS, N_E_RANGES = 4096, 64               # path E

# tests/test_kernels.py tolerances
PAIR_RTOL = 3e-4
AQP_RTOL, CNT_ATOL, SUM_ATOL = 1e-4, 1e-5, 1e-4
SV_RTOL, SV_ATOL = 1e-3, 1e-3
GRID_RTOL, GRID_ATOL = 1e-3, 1e-3
GH_RTOL, GH_ATOL = 5e-4, 1e-4
QMC_RTOL, QMC_ATOL = 1e-5, 1e-6    # atol relative to the call's largest |sum| (see below)
RFF_RTOL, RFF_ATOL = 2e-5, 2e-5
KDE_RTOL, KDE_ATOL = 5e-4, 1e-7

# the device of paths C-E and their checks ("cpu" only to rehearse them at a
# small size with the plain versions)
DEV = "cuda"

# H100 SXM published peaks: FP32 outside the tensor cores (an FMA counts
# as two FLOPs), HBM3 bandwidth; SFU (MUFU) lanes: 16 per SM x 132 SMs
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SFU_LANES = 16 * 132

TPU_KERNELS = {
    "pairwise_scaled_ksum": ("src/repro_torch/kernels/csrc/pairwise_reduce.cu",
                             "src/repro/kernels/pairwise_reduce.py:73"),
    "aqp_batch_sums": ("src/repro_torch/kernels/csrc/aqp_batch.cu",
                       "src/repro/kernels/aqp_batch.py:78"),
    "aqp_box_sums": ("src/repro_torch/kernels/csrc/aqp_boxes.cu",
                     "src/repro/kernels/aqp_boxes.py:95"),
    "sv_matrix": ("src/repro_torch/kernels/csrc/sv_precompute.cu",
                  "src/repro/kernels/sv_precompute.py:88"),
    "lscv_grid_sums": ("src/repro_torch/kernels/csrc/lscv_grid.cu",
                       "src/repro/kernels/lscv_grid.py:91"),
    "gh_fused_sum": ("src/repro_torch/kernels/csrc/gh_fused.cu",
                     "src/repro/kernels/gh_fused.py:73"),
    "aqp_grouped_sums": ("src/repro_torch/kernels/csrc/aqp_grouped.cu",
                         "src/repro/kernels/aqp_grouped.py:115"),
    "qmc_box_reduce": ("src/repro_torch/kernels/csrc/qmc_reduce.cu",
                       "src/repro/kernels/qmc_reduce.py:112"),
    "rff_density": ("src/repro_torch/kernels/csrc/rff_eval.cu",
                    "src/repro/kernels/rff_eval.py:64"),
    "kde_eval": ("src/repro_torch/kernels/csrc/kde_eval.cu",
                 "src/repro/kernels/kde_eval.py:72"),
}
# the path whose launches each kernel's "launches" reports
KERNEL_PATH = {"pairwise_scaled_ksum": "plugin", "aqp_batch_sums": "plugin",
               "aqp_box_sums": "plugin", "sv_matrix": "A", "lscv_grid_sums": "A",
               "gh_fused_sum": "B", "aqp_grouped_sums": "C", "qmc_box_reduce": "D exact",
               "rff_density": "D", "kde_eval": "E"}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def close(a, b, rtol: float, atol: float) -> tuple:
    """(all within |a-b| <= atol + rtol |b|, max abs error)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = np.abs(a - b)
    return bool(np.all(err <= atol + rtol * np.abs(b))), float(err.max(initial=0.0))


@contextlib.contextmanager
def recording(ops):
    """Keep the arguments of every call made to an `ops` wrapper while the
    block runs, so each kernel is held and timed on exactly the inputs the
    main path gave it.  The launch counters live in the launchers and are
    not touched."""
    calls = {name: [] for name in TPU_KERNELS}
    originals = {name: getattr(ops, name) for name in TPU_KERNELS}

    def keep(name):
        def wrapper(*args, **kwargs):
            calls[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        return wrapper

    for name in TPU_KERNELS:
        setattr(ops, name, keep(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)


def call_shape(name: str, args, kwargs) -> str:
    if name == "pairwise_scaled_ksum":
        return f"n={args[0].shape[0]} {kwargs.get('kind', args[2] if len(args) > 2 else 'k4')}"
    if name == "aqp_batch_sums":
        return f"q={args[2].shape[0]} n={args[0].shape[0]}"
    if name == "aqp_box_sums":
        return f"q={args[2].shape[0]} n={args[0].shape[0]} d={args[0].shape[1]}"
    if name == "lscv_grid_sums":
        return f"n={args[0].shape[0]} d={args[0].shape[1]} n_h={args[2].shape[0]}"
    if name == "aqp_grouped_sums":
        return (f"G={args[4].shape[0]} n={args[0].shape[0]} d={args[0].shape[1]} "
                f"g_axis={args[6]} tgt={args[7]}")
    if name == "qmc_box_reduce":
        return (f"q={args[4].shape[0]} m={args[0].shape[0]} n={args[1].shape[0]} "
                f"d={args[1].shape[1]}")
    if name == "rff_density":
        return f"m={args[0].shape[0]} D={args[1].shape[0]} d={args[0].shape[1]}"
    if name == "kde_eval":
        return f"m={args[0].shape[0]} n={args[1].shape[0]} d={args[1].shape[-1]}"
    return f"n={args[0].shape[0]} d={args[0].shape[1]}"


# --- data and query mix ------------------------------------------------------

def make_stream(rng: np.random.Generator):
    """Telemetry rows: a latent factor shared by normal and lognormal
    columns (correlated joint axes), and a 64-code dictionary column."""
    latent = rng.normal(0.0, 1.0, STREAM_ROWS)
    cols = {
        "loss": 2.0 + 0.5 * latent + rng.normal(0.0, 0.4, STREAM_ROWS),
        "latency_ms": np.exp(3.0 + 0.3 * latent + rng.normal(0.0, 0.3, STREAM_ROWS)),
        "grad_norm": 1.0 + 0.3 * latent + rng.normal(0.0, 0.5, STREAM_ROWS),
        "tokens": np.exp(5.0 + rng.normal(0.0, 0.6, STREAM_ROWS)),
        "model_id": rng.integers(0, N_CODES, STREAM_ROWS).astype(np.float64),
    }
    return {k: v.astype(np.float32) for k, v in cols.items()}


def interval(rng, data: np.ndarray, lo_q=(0.02, 0.6), width_q=(0.05, 0.4)):
    u = rng.uniform(*lo_q)
    v = min(0.999, u + rng.uniform(*width_q))
    return float(np.quantile(data, u)), float(np.quantile(data, v))


def make_specs(rng, stream, q):
    """512 Range (two columns), 384 Box (the joint) and 128 Eq specs, each
    COUNT / SUM / AVG in turn."""
    aggs = ("count", "sum", "avg")
    probe = {c: stream[c][:200_000] for c in NUMERIC}
    specs = []
    for i in range(N_RANGE):
        col = RANGE_COLS[i % 2]
        a, b = interval(rng, probe[col])
        specs.append(q.AqpQuery(aggs[i % 3], (q.Range(col, a, b),)))
    for i in range(N_BOX):
        bounds = [interval(rng, probe[c], lo_q=(0.0, 0.4), width_q=(0.4, 0.9))
                  for c in JOINT]
        agg = aggs[i % 3]
        box = q.Box(JOINT, tuple(b[0] for b in bounds), tuple(b[1] for b in bounds))
        specs.append(q.AqpQuery(agg, (box,),
                                target=None if agg == "count" else JOINT[i % 3]))
    for i in range(N_EQ):
        agg = aggs[i % 3]
        specs.append(q.AqpQuery(agg, (q.Eq("model_id", float(i % N_CODES)),),
                                target=None if agg == "count" else "model_id"))
    return specs


def make_group_specs(rng, stream, q):
    """Path C: 96 GROUP BY specs over model_id, COUNT / SUM / AVG in turn
    (SUM and AVG of loss) under a Range on loss and one on latency_ms, then
    8 AVG of model_id itself (the group axis as the target)."""
    aggs = ("count", "sum", "avg")
    probe = {c: stream[c][:200_000] for c in RANGE_COLS}
    specs = []
    for i in range(N_GROUP + N_GROUP_SELF):
        preds = tuple(q.Range(c, *interval(rng, probe[c], lo_q=(0.0, 0.4), width_q=(0.4, 0.9)))
                      for c in RANGE_COLS)
        if i < N_GROUP:
            agg = aggs[i % 3]
            target = None if agg == "count" else "loss"
        else:
            agg, target = "avg", "model_id"
        specs.append(q.AqpQuery(agg, preds, target=target, group_by="model_id"))
    return specs


# --- float64 oracles ---------------------------------------------------------

def oracle_batch(x, h, a, b):
    from scipy.special import ndtr
    x = np.asarray(x, np.float64)
    za = (np.asarray(a, np.float64)[:, None] - x[None]) / h
    zb = (np.asarray(b, np.float64)[:, None] - x[None]) / h
    d_Phi = ndtr(zb) - ndtr(za)
    d_phi = (np.exp(-0.5 * zb * zb) - np.exp(-0.5 * za * za)) / math.sqrt(2 * math.pi)
    return d_Phi.sum(1), (x[None] * d_Phi - h * d_phi).sum(1)


def oracle_boxes(x, h, lo, hi, tgt):
    from scipy.special import ndtr
    x = np.asarray(x, np.float64)
    h = np.asarray(h, np.float64)
    za = (np.asarray(lo, np.float64)[:, None, :] - x[None]) / h
    zb = (np.asarray(hi, np.float64)[:, None, :] - x[None]) / h
    d_Phi = ndtr(zb) - ndtr(za)
    d_phi = (np.exp(-0.5 * zb * zb) - np.exp(-0.5 * za * za)) / math.sqrt(2 * math.pi)
    moment = x[None] * d_Phi - h * d_phi
    sel = np.arange(x.shape[1])[None, None, :] == np.asarray(tgt)[:, None, None]
    return (np.prod(d_Phi, 2).sum(1),
            np.prod(np.where(sel, moment, d_Phi), 2).sum(1))


def oracle_pairwise(x, g, kind):
    x = np.asarray(x, np.float64)
    total = 0.0
    for s in range(0, x.shape[0], 1024):
        t = (x[s:s + 1024, None] - x[None]) / g
        t2 = t * t
        ph = np.exp(-0.5 * t2) / math.sqrt(2 * math.pi)
        poly = (t2 - 6) * t2 + 3 if kind == "k4" else ((t2 - 15) * t2 + 45) * t2 - 15
        i = s + np.arange(t.shape[0])
        total += float(np.where(i[:, None] < np.arange(x.shape[0])[None], poly * ph, 0).sum())
    return total


# --- phases ------------------------------------------------------------------

def build_store(args, rt, q):
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    stream = make_stream(rng)
    store = rt["store"].TelemetryStore(capacity=CAPACITY, seed=args.seed)
    check(store.device.type == "cuda", f"store landed on {store.device}")
    store.track_joint(JOINT)
    store.track_joint(GJOINT)
    store.track_categorical("model_id")
    for s in range(0, STREAM_ROWS, BATCH_ROWS):
        store.add_batch({k: v[s:s + BATCH_ROWS] for k, v in stream.items()})
    specs = make_specs(rng, stream, q)
    gspecs = make_group_specs(rng, stream, q)
    print(f"store: {STREAM_ROWS} rows streamed in {BATCH_ROWS}-row batches, "
          f"{len(specs)} specs and {len(gspecs)} GROUP BY specs, "
          f"set-up {time.perf_counter() - t0:.2f} s")
    return store, specs, gspecs, stream


def driven(torch, ops, what: str, fn):
    """Run one path with every launch count set to 0 just before it and read
    just after, recording each kernel wrapper's calls; returns (result,
    seconds, counts, calls)."""
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording(ops) as calls:
        out = fn()
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"{what}: {sec * 1e3:.1f} ms; launches {counts}")
    for name, made in calls.items():
        check(len(made) == counts[name],
              f"{what}: {name}: {len(made)} wrapper calls but {counts[name]} launches")
        shapes = [call_shape(name, a, k) for a, k in made]
        if len(set(shapes)) == 1 and len(shapes) > 3:
            print(f"{what}: calls of {name}: {len(shapes)} x {shapes[0]}")
        elif shapes:
            print(f"{what}: calls of {name}: {', '.join(shapes)}")
    return out, sec, counts, calls


def check_answers(store, specs, stream, res, selector: str, suffix: str) -> np.ndarray:
    """Every answer finite and inside its CI, each spec on its path; the
    first 32 specs of each range column and 48 boxes held against a float64
    closed form of the same synopses; Eq answers equal to exact counts of
    the stream."""
    check(len(res) == len(specs), "one result per spec")
    est = np.asarray([r.estimate for r in res])
    lo = np.asarray([r.ci_lo for r in res])
    hi = np.asarray([r.ci_hi for r in res])
    check(bool(np.all(np.isfinite(est))), f"{selector}: non-finite estimate")
    check(bool(np.all((lo <= est) & (est <= hi))), f"{selector}: an estimate outside its CI")
    paths = [r.path for r in res]
    check(set(paths[:N_RANGE]) == {"range1d" + suffix}, f"range paths {set(paths[:N_RANGE])}")
    check(set(paths[N_RANGE:N_RANGE + N_BOX]) == {"box" + suffix}, "box paths")
    check(set(paths[N_RANGE + N_BOX:]) == {"exact"}, "Eq paths")

    for col in RANGE_COLS:
        syn = store.synopsis(col, selector)
        idx = [i for i in range(N_RANGE) if specs[i].predicates[0].column == col][:32]
        a = [specs[i].predicates[0].a for i in idx]
        b = [specs[i].predicates[0].b for i in idx]
        c64, s64 = oracle_batch(syn.x.cpu().numpy(), float(syn.h), a, b)
        scale = syn.n_source / syn.x.shape[0]
        want = []
        for j, i in enumerate(idx):
            cnt, sm = scale * c64[j], scale * s64[j]
            want.append({"count": cnt, "sum": sm}.get(specs[i].aggregate,
                                                      sm / cnt if cnt > 1e-3 else 0.0))
        ok, err = close(est[idx], want, 1e-4, 1e-3)
        check(ok, f"{selector}: range1d{suffix} answers on {col} vs float64 (max err {err})")
    syn = store.joint_synopsis(JOINT, selector)
    idx = list(range(N_RANGE, N_RANGE + 48))
    boxes = [specs[i].predicates[0] for i in idx]
    tgt = [0 if specs[i].target is None else JOINT.index(specs[i].target) for i in idx]
    c64, s64 = oracle_boxes(syn.x.cpu().numpy(), syn.h_diag().cpu().numpy(),
                            [bx.lo for bx in boxes], [bx.hi for bx in boxes], tgt)
    scale = syn.n_source / syn.x.shape[0]
    want = []
    for j, i in enumerate(idx):
        cnt, sm = scale * c64[j], scale * s64[j]
        want.append({"count": cnt, "sum": sm}.get(specs[i].aggregate,
                                                  sm / cnt if cnt > 1e-3 else 0.0))
    ok, err = close(est[idx], want, 1e-4, 1e-3)
    check(ok, f"{selector}: box{suffix} answers vs float64 (max err {err})")
    codes = stream["model_id"]
    for i in range(N_RANGE + N_BOX, len(specs)):
        v = specs[i].predicates[0].value
        cnt = int(np.sum(codes == np.float32(v)))
        want = {"count": float(cnt), "sum": float(v * cnt)}.get(
            specs[i].aggregate, v if cnt else 0.0)
        check(est[i] == want, f"exact answer {est[i]} != {want}")
    return est


def repeat_query(torch, ops, store, specs, res, selector: str, what: str) -> dict:
    """The same batch again: plans and fits from the caches, no fit
    launches, bit-identical answers."""
    misses = store.cache.stats()["misses"]
    res2, sec, counts, _ = driven(torch, ops, f"{what} repeat query (cached fits)",
                                  lambda: store.query(specs, selector=selector))
    same = all(r.estimate == r2.estimate and r.ci_lo == r2.ci_lo and r.ci_hi == r2.ci_hi
               and r.path == r2.path for r, r2 in zip(res, res2))
    check(same, f"{what}: repeat query not bit-identical")
    fit_kernels = ("pairwise_scaled_ksum", "sv_matrix", "lscv_grid_sums", "gh_fused_sum")
    check(store.cache.stats()["misses"] == misses
          and all(counts[k] == 0 for k in fit_kernels),
          f"{what}: repeat query refitted instead of using the cached fits")
    print(f"{what} repeat query: bit-identical answers")
    return counts


def main_path(torch, rt, store, specs, stream):
    """The PLUGIN path (PR 11's main path)."""
    ops = rt["ops"]
    res, _, counts, calls = driven(torch, ops, "main path (PLUGIN) first query, fits included",
                                   lambda: store.query(specs))
    check_answers(store, specs, stream, res, "plugin", ":cuda")
    n_axes = len(RANGE_COLS) + len(JOINT)
    check(counts["pairwise_scaled_ksum"] >= 2 * n_axes,
          f"pairwise launched {counts['pairwise_scaled_ksum']} < {2 * n_axes}")
    check(counts["aqp_batch_sums"] >= len(RANGE_COLS), "aqp_batch launches")
    check(counts["aqp_box_sums"] >= 1, "aqp_boxes launches")
    repeat_query(torch, ops, store, specs, res, "plugin", "main path")
    return counts, calls


def path_a(torch, rt, store, specs, stream):
    """Path A: the same store and specs served from LSCV_h fits."""
    ops = rt["ops"]
    res, _, counts, calls = driven(
        torch, ops, "path A (lscv_h) first query, fits included",
        lambda: store.query(specs, selector="lscv_h"))
    n_fits = len(RANGE_COLS) + 1
    want = {k: 0 for k in counts}
    want.update(aqp_batch_sums=len(RANGE_COLS), aqp_box_sums=1, sv_matrix=n_fits,
                lscv_grid_sums=n_fits)
    check(counts == want, f"path A launches {counts}, expected {want}")
    check_answers(store, specs, stream, res, "lscv_h", ":cuda")
    hs = {c: float(store.synopsis(c, "lscv_h").h) for c in RANGE_COLS}
    hs["joint"] = float(store.joint_synopsis(JOINT, "lscv_h").h)
    print(f"path A: LSCV_h h per fit (Sigma-whitened, served as a data-unit bandwidth): {hs}")
    counts2 = repeat_query(torch, ops, store, specs, res, "lscv_h", "path A")
    want2 = dict(want, sv_matrix=0, lscv_grid_sums=0)
    check(counts2 == want2, f"path A repeat launches {counts2}, expected {want2}")
    return counts, calls


def path_b(torch, rt, store):
    """Path B: the joint's LSCV_H fit, one gh_fused launch per evaluation."""
    ops, lscv = rt["ops"], rt["lscv"]
    syn, sec, counts, calls = driven(
        torch, ops, "path B (lscv_H joint fit)",
        lambda: store.joint_synopsis(JOINT, selector="lscv_H"))
    n_eval = counts["gh_fused_sum"]
    check(n_eval > 0 and sum(counts.values()) == n_eval,
          f"path B launches {counts}: only gh_fused_sum expected")
    H = syn.H.double().cpu().numpy()
    w = np.linalg.eigvalsh(H)
    check(bool(np.all(w > 0)), f"path B: H not SPD (eigenvalues {w})")
    g = float(lscv.g_of_H(syn.x, syn.H, device="cuda"))
    H0 = lscv.h_start(syn.x)
    g0 = float(lscv.g_of_H(syn.x, H0, device="cuda"))
    check(g <= g0, f"path B: g(H) {g} > g(H_start) {g0}")
    direct = lscv.lscv_H(syn.x, device="cuda")
    check(direct.nfev == n_eval,
          f"path B: a direct lscv_H made {direct.nfev} evaluations, the store path "
          f"{n_eval} launches")
    print(f"path B: it {direct.it}, nfev {direct.nfev}, gh_fused_sum launches {n_eval}, "
          f"wall {sec:.3f} s ({sec / n_eval * 1e3:.3f} ms per evaluation); "
          f"g(H) {g!r} <= g(H_start) {g0!r}; H eigenvalues {w}")
    return counts, calls


# --- paths C, D, E (GROUP BY, full-H serving, kde_eval) -------------------------

def select_op(agg: str, cnt, sm):
    return {"count": cnt, "sum": sm}.get(agg, sm / cnt if cnt > 1e-3 else 0.0)


def oracle_boxes_dev(torch, x, h, lo, hi, tgt):
    """oracle_boxes in float64 on the card (x (n,d), h (d,), lo/hi (q,d)
    float64 tensors, tgt (q,) ints): unscaled (count, sum) per box."""
    from torch.special import ndtr
    za = (lo[:, None, :] - x[None]) / h
    zb = (hi[:, None, :] - x[None]) / h
    d_Phi = ndtr(zb) - ndtr(za)
    d_phi = (torch.exp(-0.5 * zb * zb) - torch.exp(-0.5 * za * za)) / math.sqrt(2 * math.pi)
    moment = x[None] * d_Phi - h * d_phi
    t = torch.as_tensor(np.asarray(tgt), device=x.device)
    sel = torch.arange(x.shape[1], device=x.device)[None, None, :] == t[:, None, None]
    return (torch.prod(d_Phi, 2).sum(1).cpu().numpy(),
            torch.prod(torch.where(sel, moment, d_Phi), 2).sum(1).cpu().numpy())


def path_c(torch, rt, store, gspecs, stream):
    """Path C: GROUP BY families over the joint that holds model_id."""
    ops = rt["ops"]
    res, _, counts, calls = driven(torch, ops, "path C (GROUP BY) first query, fits included",
                                   lambda: store.query(gspecs))
    n_fam = len(gspecs)
    check(len(res) == n_fam * N_CODES, f"path C: {len(res)} results, expected "
          f"{n_fam} x {N_CODES} categories")
    want = {k: 0 for k in counts}
    want.update(pairwise_scaled_ksum=2 * len(GJOINT), aqp_grouped_sums=n_fam)
    check(counts == want, f"path C launches {counts}, expected {want}")
    check({r.path for r in res} == {"box:grouped:cuda"}, f"path C paths {({r.path for r in res})}")
    est = np.asarray([r.estimate for r in res])
    lo = np.asarray([r.ci_lo for r in res])
    hi = np.asarray([r.ci_hi for r in res])
    check(bool(np.all(np.isfinite(est)) and np.all((lo <= est) & (est <= hi))),
          "path C: non-finite estimate or an estimate outside its CI")

    syn = store.joint_synopsis(GJOINT)
    x64, h64 = syn.x.double(), syn.h_diag().double()
    scale = syn.n_source / syn.x.shape[0]
    worst = 0.0
    for fi in range(n_fam):
        q, rows = gspecs[fi], res[fi * N_CODES:(fi + 1) * N_CODES]
        (ra, rb) = q.predicates
        lo_b = [[ra.a, rb.a, r.group - 0.5] for r in rows]
        hi_b = [[ra.b, rb.b, r.group + 0.5] for r in rows]
        tgt = [0 if q.target in (None, "loss") else 2] * len(rows)
        c64, s64 = oracle_boxes_dev(torch, x64, h64,
                                    torch.tensor(lo_b, dtype=torch.float64, device=DEV),
                                    torch.tensor(hi_b, dtype=torch.float64, device=DEV), tgt)
        want64 = [select_op(q.aggregate, scale * c, scale * s) for c, s in zip(c64, s64)]
        ok, err = close([r.estimate for r in rows], want64, 1e-4, 1e-3)
        check(ok, f"path C: family {fi} ({q.aggregate}) vs its fanned-out boxes in float64 "
                  f"(max err {err})")
        worst = max(worst, err)

    # exact GROUP BY counts of the stream, for the COUNT families
    h_g = float(syn.h_diag()[2])
    codes = stream["model_id"].astype(np.int64)
    inner_in, inner_n, edge_ratio = 0, 0, []
    for fi in range(0, N_GROUP, 3):
        ra, rb = gspecs[fi].predicates
        mask = ((stream["loss"] >= np.float32(ra.a)) & (stream["loss"] <= np.float32(ra.b))
                & (stream["latency_ms"] >= np.float32(rb.a))
                & (stream["latency_ms"] <= np.float32(rb.b)))
        exact = np.bincount(codes[mask], minlength=N_CODES)
        for r in res[fi * N_CODES:(fi + 1) * N_CODES]:
            g = int(r.group)
            if min(g, N_CODES - 1 - g) >= 3.0 * h_g:
                inner_n += 1
                inner_in += int(r.ci_lo <= exact[g] <= r.ci_hi)
            elif g in (0, N_CODES - 1):
                edge_ratio.append(r.estimate / max(exact[g], 1))
    cover = inner_in / max(inner_n, 1)
    check(inner_n > 0 and cover >= 0.75,
          f"path C: exact per-code counts inside the 95% CIs for {cover:.3f} of {inner_n} "
          f"interior (family, code) pairs")
    print(f"path C: {n_fam} families x {N_CODES} codes on box:grouped:cuda; every family "
          f"matches its fanned-out boxes in float64 (max |err| {worst:.3g}); exact stream "
          f"counts inside the CI for {cover:.3f} of {inner_n} interior (COUNT family, code) "
          f"pairs (codes >= 3 h = {3 * h_g:.3g} from the ends); at codes 0 and 63 the "
          f"estimate / exact ratio is {np.mean(edge_ratio):.3f} on average (the KDE's mass "
          f"leaks past the ends of the code range)")

    misses = store.cache.stats()["misses"]
    res2, _, counts2, _ = driven(torch, ops, "path C repeat query (cached fits)",
                                 lambda: store.query(gspecs))
    check(all((r.estimate, r.ci_lo, r.ci_hi, r.path) == (r2.estimate, r2.ci_lo, r2.ci_hi, r2.path)
              for r, r2 in zip(res, res2)), "path C: repeat query not bit-identical")
    want2 = dict(want, pairwise_scaled_ksum=0)
    check(counts2 == want2 and store.cache.stats()["misses"] == misses,
          f"path C repeat launches {counts2}, expected {want2}, and no refit")
    print("path C repeat query: bit-identical answers, no fit launches")
    return counts, calls


def group_slices(specs):
    """{group: spec indices} of the 1 024-spec mix's KDE groups."""
    out = {col: [i for i in range(N_RANGE) if specs[i].predicates[0].column == col]
           for col in RANGE_COLS}
    out[JOINT] = list(range(N_RANGE, N_RANGE + N_BOX))
    return out


def group_boxes(specs, idx):
    """(lo, hi, tgt, aggs) of a group's specs, in the engine's axis order."""
    lo, hi, tgt, aggs = [], [], [], []
    for i in idx:
        p = specs[i].predicates[0]
        if hasattr(p, "a"):
            lo.append([p.a])
            hi.append([p.b])
            tgt.append(0)
        else:
            lo.append(list(p.lo))
            hi.append(list(p.hi))
            tgt.append(0 if specs[i].target is None else JOINT.index(specs[i].target))
        aggs.append(specs[i].aggregate)
    return np.asarray(lo, np.float64), np.asarray(hi, np.float64), np.asarray(tgt), aggs


def oracle_qmc(torch, rt, syn, lo, hi, tgt, aggs, k: int, n_qmc: int = 4096):
    """eq. 6 integrated over the first k boxes of a full-H group in float64
    on the card, with the engine's plan (the same clipped boxes and the same
    float32 Halton nodes): scaled COUNT / SUM / AVG per box."""
    md = rt["aqp_multid"]
    x = syn.x if syn.x.dim() == 2 else syn.x[:, None]
    n, d = x.shape
    plan = md._qmc_plan(x.double().cpu().numpy(), syn.H.double().cpu().numpy(), lo, hi, n_qmc)
    glo, ghi, clo, chi, n_nodes = plan

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=DEV)

    glo_t, ghi_t = f32(glo), f32(ghi)
    unit = torch.as_tensor(md._halton_unit(n_nodes, d), device=DEV)
    nodes = (glo_t[None] + unit * (ghi_t - glo_t)[None]).double()
    H64 = syn.H.double()
    h_inv = torch.linalg.inv(H64)
    log_norm = -0.5 * d * math.log(2 * math.pi) - 0.5 * torch.linalg.slogdet(H64)[1]
    x64 = x.double()
    f = torch.empty(n_nodes, dtype=torch.float64, device=DEV)
    for s in range(0, n_nodes, 256):
        diff = nodes[s:s + 256, None, :] - x64[None]
        quad = torch.sum((diff @ h_inv) * diff, dim=-1)
        f[s:s + 256] = torch.exp(log_norm - 0.5 * quad).mean(1)
    vol = torch.prod(ghi_t - glo_t).double()
    lo_t, hi_t = f32(clo[:k]).double(), f32(chi[:k]).double()
    w = torch.all((nodes[None] >= lo_t[:, None]) & (nodes[None] <= hi_t[:, None]), 2) * f[None]
    tv = nodes.T[torch.as_tensor(np.asarray(tgt[:k]), device=DEV)]
    scale = syn.n_source / n
    cnt = (scale * n * vol * w.mean(1)).cpu().numpy()
    sm = (scale * n * vol * (w * tv).mean(1)).cpu().numpy()
    return [select_op(a, c, s) for a, c, s in zip(aggs[:k], cnt, sm)], n_nodes


def path_d(torch, rt, store, specs):
    """Path D: the 1 024-spec mix served from LSCV_H fits on the full-H
    path, the RFF density backend ("auto") and then the exact one."""
    ops, RFF = rt["ops"], rt["synopses"].RFFSynopsis
    fit_s = []
    orig_fit = RFF.fit.__func__

    def timed_fit(cls, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_fit(cls, *a, **kw)
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
        return out

    RFF.fit = classmethod(timed_fit)
    try:
        res, sec, counts, calls = driven(
            torch, ops, "path D (lscv_H, kde_backend auto) first query, 1-D LSCV_H fits "
            "and RFF fits included", lambda: store.query(specs, selector="lscv_H"))
    finally:
        RFF.fit = classmethod(orig_fit)
    others = {k: v for k, v in counts.items()
              if k not in ("gh_fused_sum", "rff_density", "qmc_box_reduce")}
    check(counts["gh_fused_sum"] > 0 and counts["rff_density"] >= 3
          and not any(others.values()),
          f"path D launches {counts}: 1-D LSCV_H fits on gh_fused_sum, the RFF probe gates "
          f"on rff_density, nothing else")
    slices = group_slices(specs)
    est = np.asarray([r.estimate for r in res])
    check(bool(np.all(np.isfinite(est)))
          and all(r.ci_lo <= r.estimate <= r.ci_hi for r in res), "path D: CI or finiteness")
    check({res[i].path for i in range(N_RANGE + N_BOX, len(specs))} == {"exact"}, "Eq paths")
    rff_groups = []
    for j, (col, idx) in enumerate(slices.items()):
        syn = (store.joint_synopsis(col, "lscv_H") if isinstance(col, tuple)
               else store.synopsis(col, "lscv_H"))
        ver = (store.joints[col] if isinstance(col, tuple) else store.columns[col]).version
        ckey = col + ("#rff2048",) if isinstance(col, tuple) else f"{col}#rff2048"
        rff = store.cache.get(ckey, "lscv_H", ver, backend="cuda")
        paths = {res[i].path for i in idx}
        check(rff is not None and paths == ({"qmc:cuda"} if rff.degraded else {"qmc:rff"}),
              f"path D: group {col} paths {paths} with RFF {rff and rff.error_metadata()}")
        if not rff.degraded:
            rff_groups.append(col)
        print(f"path D group {col}: H diag {syn.H.diagonal().tolist()}; RFF fit "
              f"{fit_s[j] * 1e3:.1f} ms, probe_rel_err {rff.probe_rel_err:.4f}, "
              f"degraded {rff.degraded}; path {paths.pop()}")
    per_group = []
    for args, _ in calls["rff_density"]:           # each fit's probe call opens a group
        if args[0].shape[0] == rt["query"].RFF_GATE_PROBES:
            per_group.append(0)
        per_group[-1] += 1
    print(f"path D: rff_density launches {counts['rff_density']}, per group {per_group} (a "
          f"probe per fit, then an estimate and 8 feature blocks per RFF group), "
          f"qmc_box_reduce {counts['qmc_box_reduce']} (degraded groups); {sec:.3f} s")

    eng = store.shared_engine("lscv_H")
    res_x, sec_x, counts_x, calls_x = driven(
        torch, ops, "path D exact (kde_backend='exact', fits cached)",
        lambda: eng.execute(specs, kde_backend="exact"))
    want = {k: 0 for k in counts_x}
    want["qmc_box_reduce"] = 3 * (1 + 8)       # an estimate and 8 CI chunks per group
    check(counts_x == want, f"path D exact launches {counts_x}, expected {want}")
    nodes = [a[0].shape[0] for a, _ in calls_x["qmc_box_reduce"] if a[1].shape[0] == CAPACITY]
    print(f"path D exact: Halton nodes per group (_qmc_plan): {nodes}")
    worst, in_ci, n_rff = 0.0, 0, 0
    for col, idx in slices.items():
        syn = (store.joint_synopsis(col, "lscv_H") if isinstance(col, tuple)
               else store.synopsis(col, "lscv_H"))
        lo, hi, tgt, aggs = group_boxes(specs, idx)
        check({res_x[i].path for i in idx} == {"qmc:cuda"}, f"path D exact: {col} paths")
        want64, _ = oracle_qmc(torch, rt, syn, lo, hi, tgt, aggs, 24)
        ok, err = close([res_x[i].estimate for i in idx[:24]], want64, 1e-4, 1e-3)
        check(ok, f"path D exact: {col} vs the float64 eq. 6 oracle (max err {err})")
        worst = max(worst, err)
        if col in rff_groups:
            top = max(abs(res_x[i].estimate) for i in idx)
            for i, w64 in zip(idx, want64):
                r = res[i]
                half = max((r.ci_hi - r.ci_lo) / 2.0, 0.02 * top)
                check(abs(r.estimate - w64) <= 4.0 * half,
                      f"path D: {col} spec {i}: RFF {r.estimate} vs float64 {w64}")
            for i in idx:
                r, x_ = res[i], res_x[i]
                half = max((r.ci_hi - r.ci_lo) / 2.0, (x_.ci_hi - x_.ci_lo) / 2.0, 0.02 * top)
                check(abs(r.estimate - x_.estimate) <= 4.0 * half,
                      f"path D: {col} spec {i}: RFF {r.estimate} vs exact {x_.estimate} "
                      f"beyond 4 half-widths {half}")
                in_ci += int(r.ci_lo <= x_.estimate <= r.ci_hi
                             or x_.ci_lo <= r.estimate <= x_.ci_hi)
                n_rff += 1
    print(f"path D exact: 24 specs per group match the float64 eq. 6 oracle on the same "
          f"nodes (max |err| {worst:.3g}), the RFF answers of those within 4 CI "
          f"half-widths of it; RFF and exact answers inside each other's CIs for {in_ci} "
          f"of {n_rff} specs, all within 4 CI half-widths")

    for what, run, first in (("path D", lambda: store.query(specs, selector="lscv_H"), res),
                             ("path D exact",
                              lambda: eng.execute(specs, kde_backend="exact"), res_x)):
        again, _, c2, _ = driven(torch, ops, f"{what} repeat query", run)
        check(all((r.estimate, r.ci_lo, r.ci_hi, r.path) == (r2.estimate, r2.ci_lo, r2.ci_hi,
                                                               r2.path)
                  for r, r2 in zip(first, again)), f"{what}: repeat query not bit-identical")
        check(c2["gh_fused_sum"] == 0, f"{what}: repeat query refitted")
    print("path D repeat queries (RFF and exact): bit-identical answers, no fit launches")
    return counts, calls, counts_x, calls_x


def path_e(torch, rt, store, specs):
    """Path E: kde_eval on a 1-D sample and on the joint, and the
    trapezoid forms of eqs. 9-10 against the closed forms."""
    ops, kde, aqp = rt["ops"], rt["kde"], rt["aqp"]
    syn = store.synopsis("loss")                     # PLUGIN, cached by the main path
    jsyn = store.joint_synopsis(JOINT, "lscv_h")     # scalar h, cached by path A
    x1, h1 = syn.x, syn.h
    hv = float(h1)
    grid1 = torch.linspace(float(x1.min()) - 6 * hv, float(x1.max()) + 6 * hv, N_E_POINTS,
                           device=DEV)
    per_axis = round(N_E_POINTS ** (1 / 3))
    qs = torch.quantile(jsyn.x[:8192], torch.linspace(0.02, 0.98, per_axis, device=DEV), dim=0)
    gridj = torch.stack(torch.meshgrid(qs[:, 0], qs[:, 1], qs[:, 2], indexing="ij"),
                        -1).reshape(-1, 3).contiguous()
    ranges = [(specs[i].predicates[0].a, specs[i].predicates[0].b) for i in range(N_RANGE)
              if specs[i].predicates[0].column == "loss"][:N_E_RANGES]

    def run():
        f1 = kde.kde_eval(grid1, x1, h1, device=DEV)
        fj = kde.kde_eval(gridj, jsyn.x, jsyn.h, device=DEV)
        num = [(aqp.count_1d_numeric(x1, h1, a, b), aqp.sum_1d_numeric(x1, h1, a, b))
               for a, b in ranges]
        return f1, fj, num

    (f1, fj, num), sec, counts, calls = driven(torch, ops, "path E (kde_eval)", run)
    want = {k: 0 for k in counts}
    want["kde_eval"] = 2 + 2 * len(ranges)
    check(counts == want, f"path E launches {counts}, expected {want}")
    check(bool(torch.all(torch.isfinite(f1)) & torch.all(f1 >= 0) & torch.all(torch.isfinite(fj))
               & torch.all(fj >= 0)) and fj.shape == (N_E_POINTS,),
          "path E: densities finite, non-negative, of the expected shape")
    mass = float(torch.trapezoid(f1.double(), grid1.double()))
    check(abs(mass - 1.0) < 1e-3, f"path E: the 1-D density integrates to {mass}")
    got = np.asarray([[float(c), float(s)] for c, s in num])
    closed = np.asarray([[float(aqp.count_1d(x1, h1, a, b)), float(aqp.sum_1d(x1, h1, a, b))]
                         for a, b in ranges])
    ok, err = close(got, closed, 1e-3, 1e-2)
    check(ok, f"path E: trapezoid eqs. 9-10 vs the closed forms (max err {err})")
    print(f"path E: kde_eval at {N_E_POINTS} points (n={x1.shape[0]}, d=1, h={hv:.4g}; "
          f"joint d=3, h={float(jsyn.h):.4g}); the 1-D density integrates to {mass:.6f}; "
          f"{len(ranges)} count_1d_numeric / sum_1d_numeric match the closed forms "
          f"(max |err| {err:.3g}); {sec * 1e3:.1f} ms")
    return counts, calls


def all_range_bounds(torch, calls):
    """The bounds of all main-path range groups, concatenated: the extra
    aqp_batch shape (q = 512 here) of one launch per batch."""
    made = calls["aqp_batch_sums"]
    return (torch.cat([a[2] for a, _ in made]).contiguous(),
            torch.cat([a[3] for a, _ in made]).contiguous())


def held(a, b, rtol: float, atol: float, what: str) -> float:
    """Check kernel output `a` against plain output `b`; the max abs error."""
    ok, err = close(a, b, rtol, atol)
    check(ok, f"{what}: max abs error {err} beyond rtol {rtol} atol {atol}")
    return err


def kernels_vs_plain(torch, rt, calls):
    """Each kernel against its plain version on the inputs of every one of
    its main-path calls, at an extra shape and at edge shapes, and against
    float64 on a subsample."""
    ops, ref, plugin = rt["ops"], rt["ref"], rt["plugin"]
    dev = torch.device(DEV)
    rng = np.random.default_rng(7)
    out = {}

    # eqs. 49/50 as the kernel computes them, for every tile of n_tiles <= 512
    n_tri = 512 * 513 // 2
    q_t, l_t = rt["pairwise_reduce"].triangle_map(n_tri, dev)
    q_t, l_t = q_t.long(), l_t.long()
    bx = torch.arange(n_tri, device=dev)
    check(bool(torch.all(l_t * (l_t + 1) // 2 + q_t == bx) & torch.all(q_t <= l_t)
               & torch.all(q_t >= 0)), "device bx_to_ql mapping")
    print(f"triangle map: {n_tri} tiles (n_tiles <= 512) round-trip on the device")

    # pairwise on each main-path call: every fitted axis's Psi6(g1), Psi4(g2)
    errs, oracle_done = [], set()
    for args, kw in calls["pairwise_scaled_ksum"]:
        x, g = args[0], args[1]
        kind = kw["kind"]
        n = x.shape[0]
        errs.append(held(float(ops.pairwise_scaled_ksum(*args, **kw)),
                         float(ref.pairwise_scaled_ksum(*args, **kw)),
                         PAIR_RTOL, max(1e-5, 1e-6 * n), f"pairwise {kind} n={n}"))
        if kind not in oracle_done:
            oracle_done.add(kind)
            sub = x[:4096].contiguous()
            held(float(ops.pairwise_scaled_ksum(sub, g, kind)),
                 oracle_pairwise(sub.cpu().numpy(), float(g), kind),
                 PAIR_RTOL, max(1e-5, 1e-6 * 4096), f"pairwise {kind} vs float64")
    out["pairwise_scaled_ksum"] = max(errs)
    print(f"pairwise: {len(errs)} main-path calls (n={calls['pairwise_scaled_ksum'][0][0][0].shape[0]}) "
          f"match plain, max |err| {max(errs):.3g}; k4/k6 at n=4096 match float64")
    for n in (1, 2, 4097):
        xs = torch.as_tensor(rng.normal(0, 1, n).astype(np.float32), device=dev)
        g = torch.tensor(0.4, device=dev)
        for kind in ("k4", "k6", "gauss"):
            held(float(ops.pairwise_scaled_ksum(xs, g, kind)),
                 float(ref.pairwise_scaled_ksum(xs, g, kind)),
                 PAIR_RTOL, max(1e-5, 1e-6 * n), f"pairwise {kind} n={n}")
    xs = rng.normal(1.0, 2.0, 512).astype(np.float32)
    h_k = float(plugin.plugin_bandwidth(xs, backend="cuda").h)
    h_seq = plugin.plugin_bandwidth_sequential(xs)
    check(abs(h_k - h_seq) / h_seq < 1e-3, f"PLUGIN h {h_k} vs sequential {h_seq}")
    print(f"PLUGIN n=512: kernel path h {h_k!r}, sequential oracle {h_seq!r}")

    # aqp_batch on each main-path range group: a column's synopsis with the
    # group's padded bounds
    errs = []
    for args, kw in calls["aqp_batch_sums"]:
        k = ops.aqp_batch_sums(*args, **kw)
        p = ref.aqp_batch_sums(*args, **kw)
        what = f"aqp_batch {call_shape('aqp_batch_sums', args, kw)}"
        errs += [held(k[0].cpu(), p[0].cpu(), AQP_RTOL, CNT_ATOL, what + " count"),
                 held(k[1].cpu(), p[1].cpu(), AQP_RTOL, SUM_ATOL, what + " sum")]
    out["aqp_batch_sums"] = max(errs)
    x, h, a, b = calls["aqp_batch_sums"][0][0]
    k = ops.aqp_batch_sums(x[:4096].contiguous(), h, a[:64].contiguous(), b[:64].contiguous())
    c64, s64 = oracle_batch(x[:4096].cpu().numpy(), float(h), a[:64].cpu().numpy(),
                            b[:64].cpu().numpy())
    held(k[0].cpu(), c64, AQP_RTOL, CNT_ATOL, "aqp_batch count vs float64")
    held(k[1].cpu(), s64, AQP_RTOL, SUM_ATOL, "aqp_batch sum vs float64")
    print(f"aqp_batch: {len(calls['aqp_batch_sums'])} main-path calls "
          f"({call_shape('aqp_batch_sums', (x, h, a, b), {})}) "
          f"match plain, max |err| {max(errs):.3g}; n=4096 q=64 within tolerance of float64")
    # an extra shape: every range group's bounds against the first synopsis
    a_t, b_t = all_range_bounds(torch, calls)
    k = ops.aqp_batch_sums(x, h, a_t, b_t)
    p = ref.aqp_batch_sums(x, h, a_t, b_t)
    held(k[0].cpu(), p[0].cpu(), AQP_RTOL, CNT_ATOL, "aqp_batch q=512 count")
    held(k[1].cpu(), p[1].cpu(), AQP_RTOL, SUM_ATOL, "aqp_batch q=512 sum")
    for n, qn in ((1, 1), (4097, 3), (4097, 0), (0, 5)):
        xs = torch.as_tensor(rng.normal(0, 2, n).astype(np.float32), device=dev)
        aa = torch.as_tensor(rng.uniform(-8, 8, qn).astype(np.float32), device=dev)
        bb = aa + 2.0
        hh = torch.tensor(0.3, device=dev)
        k = ops.aqp_batch_sums(xs, hh, aa, bb)
        p = ref.aqp_batch_sums(xs, hh, aa, bb)
        check(k[0].shape == (qn,), f"aqp_batch n={n} q={qn} shape")
        held(k[0].cpu(), p[0].cpu(), AQP_RTOL, CNT_ATOL, f"aqp_batch n={n} q={qn} count")
        held(k[1].cpu(), p[1].cpu(), AQP_RTOL, SUM_ATOL, f"aqp_batch n={n} q={qn} sum")

    # aqp_boxes on the main path's box group: the joint synopsis, its boxes
    errs = []
    for args, kw in calls["aqp_box_sums"]:
        k = ops.aqp_box_sums(*args, **kw)
        p = ref.aqp_box_sums(*args, **kw)
        what = f"aqp_boxes {call_shape('aqp_box_sums', args, kw)}"
        errs += [held(k[0].cpu(), p[0].cpu(), AQP_RTOL, CNT_ATOL, what + " count"),
                 held(k[1].cpu(), p[1].cpu(), AQP_RTOL, SUM_ATOL, what + " sum")]
    out["aqp_box_sums"] = max(errs)
    xj, h_d, lo, hi, tg = calls["aqp_box_sums"][0][0]
    k = ops.aqp_box_sums(xj[:4096].contiguous(), h_d, lo[:64].contiguous(),
                         hi[:64].contiguous(), tg[:64].contiguous())
    c64, s64 = oracle_boxes(xj[:4096].cpu().numpy(), h_d.cpu().numpy(), lo[:64].cpu().numpy(),
                            hi[:64].cpu().numpy(), tg[:64].cpu().numpy())
    held(k[0].cpu(), c64, AQP_RTOL, CNT_ATOL, "aqp_boxes count vs float64")
    held(k[1].cpu(), s64, AQP_RTOL, SUM_ATOL, "aqp_boxes sum vs float64")
    print(f"aqp_boxes: {len(calls['aqp_box_sums'])} main-path call "
          f"({call_shape('aqp_box_sums', (xj, h_d, lo, hi, tg), {})}) match plain, "
          f"max |err| {max(errs):.3g}; n=4096 q=64 within tolerance of float64")
    for n, qn, d in ((1, 1, 1), (4097, 1, 1), (4097, 5, 2), (4097, 0, 3), (0, 4, 2)):
        xs = torch.as_tensor(rng.normal(0, 1.5, (n, d)).astype(np.float32), device=dev)
        hh = torch.as_tensor(rng.uniform(0.2, 0.8, d).astype(np.float32), device=dev)
        ll = torch.as_tensor(rng.uniform(-3, 1, (qn, d)).astype(np.float32), device=dev)
        uu = ll + 1.5
        tt = torch.as_tensor(rng.integers(0, d, qn).astype(np.int32), device=dev)
        k = ops.aqp_box_sums(xs, hh, ll, uu, tt)
        p = ref.aqp_box_sums(xs, hh, ll, uu, tt)
        check(k[0].shape == (qn,), f"aqp_boxes n={n} q={qn} d={d} shape")
        held(k[0].cpu(), p[0].cpu(), AQP_RTOL, CNT_ATOL, f"aqp_boxes n={n} q={qn} d={d} count")
        held(k[1].cpu(), p[1].cpu(), AQP_RTOL, SUM_ATOL, f"aqp_boxes n={n} q={qn} d={d} sum")
    print(f"extra shape aqp_batch q={a_t.shape[0]}; edge shapes n=0/1/2/4097, q=0/1, d=1/2/3: "
          "kernels match plain versions")
    torch.cuda.synchronize()
    return out


def held_dev(torch, a, b, rtol: float, atol: float, what: str, rows: int = 4096) -> float:
    """held() for large device tensors, compared on the card in row slabs."""
    check(tuple(a.shape) == tuple(b.shape), f"{what}: shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    ok, worst = True, 0.0
    for s in range(0, a2.shape[0], rows):
        x, y = a2[s:s + rows].double(), b2[s:s + rows].double()
        e = (x - y).abs()
        ok = ok and bool(torch.all(e <= atol + rtol * y.abs()))
        worst = max(worst, float(e.max()))
    check(ok, f"{what}: max abs error {worst} beyond rtol {rtol} atol {atol}")
    return worst


def oracle_quadform_sum(x, m, c_k, c_kk) -> float:
    """sum_{i<j} c_kk exp(-s/4) - 2 c_k exp(-s/2) in float64, s = v^T M v."""
    x = np.asarray(x, np.float64)
    m = np.asarray(m, np.float64)
    n = x.shape[0]
    total = 0.0
    for s in range(0, n, 512):
        v = x[s:s + 512, None, :] - x[None]
        q = np.einsum("ijd,de,ije->ij", v, m, v)
        i = s + np.arange(q.shape[0])
        t = c_kk * np.exp(-0.25 * q) - 2.0 * c_k * np.exp(-0.5 * q)
        total += float(np.where(i[:, None] < np.arange(n)[None], t, 0.0).sum())
    return total


def first_d1_gh(calls_d):
    """The inputs of path D's first 1-D gh_fused_sum call."""
    return next(c for c in calls_d["gh_fused_sum"] if c[0][0].shape[1] == 1)


def lscv_kernels_vs_plain(torch, rt, calls_a, calls_b, calls_d):
    """The LSCV kernels against their plain versions on the inputs of every
    call of path A (sv_matrix, lscv_grid_sums), the first and last calls of
    path B and the first 1-D call of path D (gh_fused_sum), at edge shapes
    (n not a multiple of a tile, d = 1..8 for gh_fused_sum), and against
    float64; two launches of lscv_grid_sums and gh_fused_sum on the same
    inputs give the same bits; path A's aqp_batch / aqp_boxes calls against
    theirs; LSCV_h at n = 512 on the card against the paper's sequential
    float64 oracle."""
    ops, ref, lscv = rt["ops"], rt["ref"], rt["lscv"]
    dev = torch.device(DEV)
    rng = np.random.default_rng(11)
    out = {}

    for name in ("aqp_batch_sums", "aqp_box_sums"):
        for args, kw in calls_a[name]:
            k = getattr(ops, name)(*args, **kw)
            p = getattr(ref, name)(*args, **kw)
            what = f"path A {name} {call_shape(name, args, kw)}"
            held(k[0].cpu(), p[0].cpu(), AQP_RTOL, CNT_ATOL, what + " count")
            held(k[1].cpu(), p[1].cpu(), AQP_RTOL, SUM_ATOL, what + " sum")
    print(f"path A: {len(calls_a['aqp_batch_sums'])} aqp_batch and "
          f"{len(calls_a['aqp_box_sums'])} aqp_boxes calls (LSCV_h bandwidths) match plain")

    errs = []
    for args, kw in calls_a["sv_matrix"]:
        k = ops.sv_matrix(*args, **kw)
        p = ref.sv_matrix(args[0], args[1])
        errs.append(held_dev(torch, k, p, SV_RTOL, SV_ATOL,
                             f"sv_matrix {call_shape('sv_matrix', args, kw)}"))
        del k, p
    out["sv_matrix"] = max(errs)
    x, m = calls_a["sv_matrix"][-1][0][:2]
    sub = x[:1024].contiguous()
    x64, m64 = sub.double().cpu().numpy(), m.double().cpu().numpy()
    v = x64[:, None] - x64[None]
    s64 = np.triu(np.einsum("ijd,de,ije->ij", v, m64, v), 1)
    held(ops.sv_matrix(sub, m).cpu(), s64, SV_RTOL, SV_ATOL, "sv_matrix vs float64")
    for n in (1, 2, 4097):
        for d in (1, 3, 16):
            xs = torch.as_tensor(rng.normal(0, 1, (n, d)).astype(np.float32), device=dev)
            m0 = rng.normal(0, 1, (d, d))
            ms = torch.as_tensor((0.2 * m0 @ m0.T + np.eye(d)).astype(np.float32), device=dev)
            p = ref.sv_matrix(xs, ms)
            for alg in ("paper", "mxu"):
                held_dev(torch, ops.sv_matrix(xs, ms, algorithm=alg), p, SV_RTOL, SV_ATOL,
                         f"sv_matrix n={n} d={d} {alg}")
    print(f"sv_matrix: {len(errs)} path-A calls match plain, max |err| {max(errs):.3g}; "
          f"n=1024 d={x.shape[1]} within tolerance of float64; edge shapes n=1/2/4097 x "
          f"d=1/3/16 x paper/mxu match plain")

    errs = []
    for args, kw in calls_a["lscv_grid_sums"]:
        k = ops.lscv_grid_sums(*args, **kw).cpu()
        p = ref.lscv_grid_sums(*args, **kw).cpu()
        errs.append(held(k, p, GRID_RTOL, GRID_ATOL,
                         f"lscv_grid_sums {call_shape('lscv_grid_sums', args, kw)}"))
    out["lscv_grid_sums"] = max(errs)
    x, m, hg, c_k, c_kk = calls_a["lscv_grid_sums"][0][0]
    s_mat = ops.sv_matrix(x, m)
    same = torch.equal(ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk),
                       ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk))
    check(same, "lscv_grid_sums: two launches on path A's first S differ")
    del s_mat
    for n in (1, 2, 65, 4097, 4100):
        xs = torch.as_tensor(rng.normal(0, 1, (n, 2)).astype(np.float32), device=dev)
        ms = torch.eye(2, device=dev)
        hg = torch.linspace(0.05, 2.0, 150, device=dev)
        held(ops.lscv_grid_sums(xs, ms, hg, 0.3, 0.2).cpu(),
             ref.lscv_grid_sums(xs, ms, hg, 0.3, 0.2).cpu(), GRID_RTOL, GRID_ATOL,
             f"lscv_grid_sums n={n}")
    xs = rng.normal(0.0, 1.0, (512, 3)).astype(np.float32)
    res = lscv.lscv_h(xs, backend="cuda", device=DEV)
    worst = 0.0
    for i in (0, 50, 100, 149):
        oracle = lscv.g_of_h_sequential(xs, float(res.h_grid[i]))
        rel = abs(float(res.g_values[i]) - oracle) / abs(oracle)
        check(rel < 2e-3, f"LSCV_h n=512 g[{i}] {float(res.g_values[i])} vs float64 {oracle}")
        worst = max(worst, rel)
    print(f"lscv_grid_sums: {len(errs)} path-A calls match plain, max |err| {max(errs):.3g}; "
          f"two launches give the same bits; edge shapes n=1/2/65/4097/4100 match; LSCV_h "
          f"n=512 d=3 on the kernels within {worst:.2g} relative of the sequential float64 "
          f"oracle at 4 grid points")

    made = calls_b["gh_fused_sum"]
    errs = []
    for tag, (args, kw) in (("first path-B", made[0]), ("last path-B", made[-1]),
                            ("first 1-D path-D", first_d1_gh(calls_d))):
        errs.append(held(float(ops.gh_fused_sum(*args, **kw)),
                         float(ref.gh_fused_sum(*args, **kw)), GH_RTOL, GH_ATOL,
                         f"gh_fused_sum {tag} call"))
    out["gh_fused_sum"] = max(errs)
    args, kw = made[0]
    check(torch.equal(ops.gh_fused_sum(*args, **kw), ops.gh_fused_sum(*args, **kw)),
          "gh_fused_sum: two launches on path B's first inputs differ")
    x, h_inv, c_k, c_kk = made[-1][0]
    sub = x[:4096].contiguous()
    held(float(ops.gh_fused_sum(sub, h_inv, c_k, c_kk)),
         oracle_quadform_sum(sub.cpu().numpy(), h_inv.cpu().numpy(), float(c_k), float(c_kk)),
         GH_RTOL, GH_ATOL, "gh_fused_sum vs float64")
    for n in (1, 2, 513, 4097):
        for d in range(1, 9):
            xs = torch.as_tensor(rng.normal(0, 1, (n, d)).astype(np.float32), device=dev)
            m0 = rng.normal(0, 1, (d, d))
            ms = torch.as_tensor((0.1 * m0 @ m0.T + np.eye(d)).astype(np.float32), device=dev)
            held(float(ops.gh_fused_sum(xs, ms, 0.31, 0.17)),
                 float(ref.gh_fused_sum(xs, ms, 0.31, 0.17)), GH_RTOL, GH_ATOL,
                 f"gh_fused_sum n={n} d={d}")
    print(f"gh_fused_sum: first and last of {len(made)} path-B calls and path D's first 1-D "
          f"call match plain, max |err| {max(errs):.3g}; two launches give the same bits; "
          f"n=4096 within tolerance of float64; edge shapes n=1/2/513/4097 x d=1..8 match plain")
    torch.cuda.synchronize()
    return out


def fullh_grouped_vs_plain(torch, rt, calls_c, calls_d, calls_dx, calls_e):
    """The GROUP BY and full-H kernels against their plain versions on the
    inputs of their calls on paths C, D and E, at edge shapes, and against
    float64 on a subsample.  qmc_box_reduce is held at the reference's rtol
    1e-5 with an atol of 1e-6 of the call's largest |sum|: each sum adds up
    to 1.07e9 positive kernel values in float32, in another order than the
    plain version, and a SUM over a box whose target axis changes sign can
    cancel far below the terms it adds."""
    ops, ref = rt["ops"], rt["ref"]
    dev = torch.device(DEV)
    rng = np.random.default_rng(13)
    out = {}

    def t32(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def grouped_pair(args, what):
        k, p = ops.aqp_grouped_sums(*args), ref.aqp_grouped_sums(*args)
        return max(held(k[0].cpu(), p[0].cpu(), AQP_RTOL, CNT_ATOL, what + " count"),
                   held(k[1].cpu(), p[1].cpu(), AQP_RTOL, SUM_ATOL, what + " sum"))

    made = calls_c["aqp_grouped_sums"]
    out["aqp_grouped_sums"] = max(grouped_pair(a, f"aqp_grouped {call_shape('aqp_grouped_sums', a, k)}")
                                  for a, k in made)
    args = made[0][0]
    k1, k2 = ops.aqp_grouped_sums(*args), ops.aqp_grouped_sums(*args)
    check(torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1]),
          "aqp_grouped: two launches on the same inputs differ")
    x, h, lo, hi, glo, ghi, g_axis, tgt = args
    sub = x[:4096].contiguous()
    blo = lo.double().repeat(glo.shape[0], 1)
    bhi = hi.double().repeat(glo.shape[0], 1)
    blo[:, g_axis], bhi[:, g_axis] = glo.double(), ghi.double()
    for t in (tgt, g_axis):
        k = ops.aqp_grouped_sums(sub, h, lo, hi, glo, ghi, g_axis, t)
        c64, s64 = oracle_boxes_dev(torch, sub.double(), h.double(), blo, bhi,
                                    [t] * glo.shape[0])
        held(k[0].cpu(), c64, AQP_RTOL, CNT_ATOL, f"aqp_grouped tgt={t} count vs float64")
        held(k[1].cpu(), s64, AQP_RTOL, SUM_ATOL, f"aqp_grouped tgt={t} sum vs float64")
    for n, d, G, ga, tg in ((1, 1, 1, 0, 0), (4097, 3, 1, 1, 0), (4097, 2, 130, 0, 1),
                            (4097, 3, 64, 2, 2), (0, 2, 4, 1, 0), (50, 3, 0, 1, 1)):
        xs = t32(rng.normal(0, 1.5, (n, d)).astype(np.float32))
        hs = t32(rng.uniform(0.2, 0.8, d).astype(np.float32))
        ls = t32(rng.uniform(-2, 0, d).astype(np.float32))
        codes = np.arange(G, dtype=np.float32) * 0.05 - 1.5
        k = ops.aqp_grouped_sums(xs, hs, ls, ls + 2.0, t32(codes), t32(codes + 0.05), ga, tg)
        check(k[0].shape == (G,), f"aqp_grouped n={n} G={G} shape")
        grouped_pair((xs, hs, ls, ls + 2.0, t32(codes), t32(codes + 0.05), ga, tg),
                     f"aqp_grouped n={n} d={d} G={G}")
    print(f"aqp_grouped: {len(made)} path-C calls ({call_shape('aqp_grouped_sums', args, {})}) "
          f"match plain, max |err| {out['aqp_grouped_sums']:.3g}; two launches give the same "
          f"bits; n=4096 within tolerance of float64 on both target branches; edge shapes "
          f"n=0/1/4097, G=0/1/130, d=1/2/3 match plain")

    def qmc_pair(args, what):
        k, p = ops.qmc_box_reduce(*args), ref.qmc_box_reduce(*args)
        errs = []
        for kk, pp, ch in ((k[0], p[0], "count"), (k[1], p[1], "sum")):
            atol = QMC_ATOL * max(float(pp.abs().max()) if pp.numel() else 0.0, 1.0)
            errs.append(held(kk.cpu(), pp.cpu(), QMC_RTOL, atol, f"{what} {ch}"))
        return max(errs)

    made = calls_dx["qmc_box_reduce"]
    full = [c for c in made if c[0][1].shape[0] == CAPACITY]
    chunks = [c for c in made if c[0][1].shape[0] != CAPACITY]
    out["qmc_box_reduce"] = max(qmc_pair(a, f"qmc_box_reduce {call_shape('qmc_box_reduce', a, k)}")
                                for a, k in made + calls_d["qmc_box_reduce"])
    nodes, x, h_inv, log_norm, lo, hi, tgt = full[-1][0]
    ns, xs, ls, hs, ts = (nodes[:4096].contiguous(), x[:2048].contiguous(), lo[:32].contiguous(),
                          hi[:32].contiguous(), tgt[:32].contiguous())
    k = ops.qmc_box_reduce(ns, xs, h_inv, log_norm, ls, hs, ts)
    n64, x64, hi64 = ns.double(), xs.double(), h_inv.double()
    f64 = torch.empty(ns.shape[0], dtype=torch.float64, device=dev)
    for s in range(0, ns.shape[0], 512):
        diff = n64[s:s + 512, None, :] - x64[None]
        f64[s:s + 512] = torch.exp(float(log_norm) - 0.5 * torch.sum((diff @ hi64) * diff, -1)).sum(1)
    w = torch.all((n64[None] >= ls.double()[:, None]) & (n64[None] <= hs.double()[:, None]), 2) * f64[None]
    c64 = w.sum(1)
    s64 = (w * n64.T[ts.long()]).sum(1)
    held(k[0].cpu(), c64.cpu(), QMC_RTOL, QMC_ATOL * float(c64.abs().max()), "qmc_box_reduce count vs float64")
    held(k[1].cpu(), s64.cpu(), QMC_RTOL, QMC_ATOL * float(s64.abs().max().clamp_min(1.0)),
         "qmc_box_reduce sum vs float64")
    for n, d, q, m in ((1, 1, 1, 1), (4097, 3, 70, 1000), (300, 8, 5, 33), (0, 2, 3, 4),
                       (10, 2, 0, 4), (10, 2, 3, 0)):
        xs = t32(rng.normal(0, 1, (n, d)).astype(np.float32))
        ns = t32(rng.uniform(-2, 2, (m, d)).astype(np.float32))
        a0 = rng.normal(0, 0.3, (d, d))
        Hm = a0 @ a0.T + 0.5 * np.eye(d)
        ls = t32(rng.uniform(-2, 0, (q, d)).astype(np.float32))
        args = (ns, xs, t32(np.linalg.inv(Hm).astype(np.float32)),
                float(-0.5 * d * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(Hm)[1]),
                ls, ls + 1.5, t32(rng.integers(0, d, q), torch.int32))
        check(ops.qmc_box_reduce(*args)[0].shape == (q,), f"qmc_box_reduce q={q} shape")
        qmc_pair(args, f"qmc_box_reduce n={n} d={d} q={q} m={m}")
    print(f"qmc_box_reduce: all {len(made) + len(calls_d['qmc_box_reduce'])} calls of paths D "
          f"exact and D ({len(full)} estimates, {call_shape('qmc_box_reduce', full[0][0], {})} "
          f"first, and {len(chunks)} CI chunks on exact) match plain, max |err| "
          f"{out['qmc_box_reduce']:.3g}; m=4096 n=2048 q=32 within tolerance of float64; edge "
          f"shapes n/m/q = 0 and 1, d=1/3/8 match plain")

    def rff_pair(args, what):
        return held(ops.rff_density(*args).cpu(), ref.rff_density(*args).cpu(),
                    RFF_RTOL, RFF_ATOL, what)

    made = calls_d["rff_density"]
    out["rff_density"] = max(rff_pair(a, f"rff_density {call_shape('rff_density', a, k)}")
                             for a, k in made)
    big = max(made, key=lambda c: c[0][0].shape[0] * c[0][1].shape[0])[0]
    p, w_, b_, z_ = big
    ps = p[:512].contiguous()
    k = ops.rff_density(ps, w_, b_, z_)
    want = torch.cos(ps.double() @ w_.double().T + b_.double()[None]) @ z_.double()
    held(k.cpu(), want.cpu(), RFF_RTOL, RFF_ATOL, "rff_density vs float64")
    for m, D, d in ((1, 16, 1), (4097, 515, 8), (0, 16, 2), (5, 0, 2)):
        args = (t32(rng.normal(0, 1, (m, d)).astype(np.float32)),
                t32(rng.normal(0, 3, (D, d)).astype(np.float32)),
                t32(rng.uniform(0, 2 * np.pi, D).astype(np.float32)),
                t32((rng.normal(0, 1, D) * 2.0 / max(D, 1)).astype(np.float32)))
        check(ops.rff_density(*args).shape == (m,), f"rff_density m={m} shape")
        rff_pair(args, f"rff_density m={m} D={D} d={d}")
    print(f"rff_density: {len(made)} path-D calls match plain, max |err| "
          f"{out['rff_density']:.3g}; m=512 D={w_.shape[0]} within tolerance of float64 "
          f"(the projection reaches {float((p @ w_.T + b_).abs().max()):.0f} rad); edge "
          f"shapes m/D = 0 and 1, d=1/8 match plain")

    def kde_pair(args, what):
        return held(ops.kde_eval(*args).cpu(), ref.kde_eval(*args).cpu(), KDE_RTOL, KDE_ATOL, what)

    made = calls_e["kde_eval"]
    out["kde_eval"] = max(kde_pair(a, f"kde_eval {call_shape('kde_eval', a, k)}")
                          for a, k in made)
    for pts, x, h in (made[0][0], made[1][0]):
        ps = pts[:256].contiguous()
        k = ops.kde_eval(ps, x, h)
        d = x.shape[1]
        h64 = float(h)
        diff = (ps.double()[:, None, :] - x.double()[None]) / h64
        want = ((2 * math.pi) ** (-d / 2) * h64 ** (-d)
                * torch.exp(-0.5 * torch.sum(diff * diff, -1)).mean(1))
        held(k.cpu(), want.cpu(), KDE_RTOL, KDE_ATOL, f"kde_eval d={d} vs float64")
    for m, n, d in ((1, 1, 1), (4097, 3000, 16), (0, 10, 2)):
        args = (t32(rng.normal(0, 1, (m, d)).astype(np.float32)),
                t32(rng.normal(0, 1, (n, d)).astype(np.float32)), 0.6)
        check(ops.kde_eval(*args).shape == (m,), f"kde_eval m={m} shape")
        kde_pair(args, f"kde_eval m={m} n={n} d={d}")
    print(f"kde_eval: all {len(made)} path-E calls (two grids, {len(made) - 2} trapezoid "
          f"grids) match plain, max |err| {out['kde_eval']:.3g}; 256 points against "
          f"the full sample within tolerance of float64 (d=1, 3); edge shapes m=0/1, n=1, "
          f"d=16 match plain")
    torch.cuda.synchronize()
    return out


def time_ms(torch, fn, reps: int = 15, warm: int = 3) -> float:
    """Median of `reps` warm runs, each between two CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


# FLOPs per pair of the pairwise kernel (an FMA counts two): sub, scale,
# square, -1/2 *, exp, 1/sqrt(2 pi) *, the add, and the polynomial with its
# product with the density (k4: a subtraction and one FMA; k6: a
# subtraction and two FMAs)
PAIR_OPS = {"k6": 13, "k4": 11, "gauss": 7}
# SFU (MUFU) instructions per erfcf on its fast path, one ex2 and one
# reciprocal: aqp_batch_tiles' SASS (scripts/bench_lscv_kernels.py --sass)
# holds 4 EX2 for the 2 erfcf and 2 expf of its loop, and the RCPs of the
# erfcf and their slow paths
MUFU_ERFC = 2


def bound_ms(name: str, args, kwargs, poly_share: float = 0.0) -> tuple:
    """(bound ms, "bytes" or "operations", SFU ops) for the work of one call
    on an H100.  The bound is the larger of bytes (each input read once,
    each output written once) over HBM bandwidth and FLOPs over the FP32
    peak, with an FMA as two FLOPs (the convention of the 67 TFLOP/s peak)
    and an exp / erfc / cos as one; a sum of k products is one multiply
    and k - 1 FMAs (its first term needs no add).  SFU ops are the MUFU
    instructions the kernel issues (an exp or exp2 one, an erfcf MUFU_ERFC,
    a reciprocal one; cosf none: its range reduction and polynomial are FMA
    work); the caller turns them into the SFU floor at the SM clock it
    reads.  Per unit of work, FLOPs / SFU ops:
      pairwise_scaled_ksum: PAIR_OPS / 1 per pair;
      aqp_batch_sums: 24 / (2 erfc + 2 exp) per (query, point): z_a, z_b
        (sub, mul each), the Phi difference (add, 2 mul, 2 erfc, sub, mul),
        the count add, the density difference (2 x square, mul, exp; sub,
        mul) and the moment (FMA, mul, add);
      aqp_box_sums: 13 / 2 erfc per (query, row, axis) (z_a, z_b, the Phi
        difference, two products) and 14 / 2 exp per (query, row) (count
        add; the target's density difference, FMA, mul, product, add);
      sv_matrix: d subs, the quadratic form (d rows of d - a products each
        and the sum of d products: d + 1 multiplies, d(d-1)/2 + d - 1 FMAs)
        per pair: d^2 + 3d - 1 / none;
      lscv_grid_sums: 6 / (1 - poly_share) per (pair, h) (the scale, the
        exp2, two FMAs; poly_share of the exp2 are the kernel's polynomial);
        the grid phase alone, the strict upper triangle of S read once;
      gh_fused_sum: d subs, the quadratic form as in sv_matrix, the exp2,
        two FMAs per pair: (d^2 + 3d + 4) / 1 (the kernel issues one FMA
        more: its sum of d products starts from 0);
      aqp_grouped_sums: 14 / (2 erfc + 1 rcp) per (row, axis), 15 / 2 erfc
        per (row, category) and 11 / 2 exp more when the target is the
        group axis;
      qmc_box_reduce: d subs, the quadratic form (d + 1 sums of d products:
        d + 1 multiplies, d^2 - 1 FMAs), the scaled exponent's FMA, exp, add
        per (node, row): (2d^2 + 2d + 3) / 1, and 2d compares, an add and an
        FMA per (box, node) / none;
      rff_density: the projection (a mul and d - 1 FMAs), the phase add,
        cos and an FMA per (point, feature): 2d + 3 / none;
      kde_eval: d subs, the sum of d squares (a multiply, d - 1 FMAs), the
        scale, exp2, add per (point, row): 3d + 2 / 1."""
    mufu = 0
    if name == "pairwise_scaled_ksum":
        x = args[0]
        n = x.shape[0]
        nbytes = 4 * n + 4 + 4
        pairs = n * (n - 1) // 2
        ops, mufu = PAIR_OPS[kwargs["kind"]] * pairs, pairs
    elif name == "aqp_batch_sums":
        x, _h, a, _b = args
        n, q = x.shape[0], a.shape[0]
        nbytes = 4 * n + 4 + 8 * q + 8 * q
        ops, mufu = 24 * n * q, (2 * MUFU_ERFC + 2) * n * q
    elif name == "aqp_box_sums":
        x, _h, lo, _hi, _t = args
        (n, d), q = x.shape, lo.shape[0]
        nbytes = 4 * n * d + 4 * d + 8 * q * d + 4 * q + 8 * q
        ops = (13 * d + 14) * n * q
        mufu = (2 * MUFU_ERFC * d + 2) * n * q
    elif name == "sv_matrix":
        n, d = args[0].shape
        nbytes = 4 * n * d + 4 * d * d + 4 * n * n
        ops = (d * d + 3 * d - 1) * n * (n - 1) // 2
    elif name == "lscv_grid_sums":
        n, n_h = args[0].shape[0], args[2].shape[0]
        nbytes = 4 * n * (n - 1) // 2 + 8 * n_h + 8
        terms = n_h * n * (n - 1) // 2
        ops, mufu = 6 * terms, round((1.0 - poly_share) * terms)
    elif name == "gh_fused_sum":
        n, d = args[0].shape
        nbytes = 4 * n * d + 4 * d * d + 8 + 4
        pairs = n * (n - 1) // 2
        ops, mufu = (d * d + 3 * d + 4) * pairs, pairs
    elif name == "aqp_grouped_sums":
        (n, d), G = args[0].shape, args[4].shape[0]
        nbytes = 4 * n * d + 12 * d + 8 * G + 8 * G
        group_tgt = args[7] == args[6]
        ops = 14 * n * d + (26 if group_tgt else 15) * n * G
        mufu = (2 * MUFU_ERFC + 1) * n * d + (2 * MUFU_ERFC + (2 if group_tgt else 0)) * n * G
    elif name == "qmc_box_reduce":
        (m, d), n, q = args[0].shape, args[1].shape[0], args[4].shape[0]
        nbytes = 4 * (m * d + n * d + d * d + 1 + 2 * q * d + q) + 8 * q
        ops = (2 * d * d + 2 * d + 3) * m * n + (2 * d + 3) * q * m
        mufu = m * n
    elif name == "rff_density":
        (m, d), nf = args[0].shape, args[1].shape[0]
        nbytes = 4 * (m * d + nf * d + 2 * nf) + 4 * m
        ops = (2 * d + 3) * m * nf
    else:                                    # kde_eval
        (m, d), n = args[0].shape, args[1].shape[0]
        nbytes = 4 * (m * d + n * d + 1) + 4 * m
        ops, mufu = (3 * d + 2) * m * n, m * n
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", mufu
    return t_bytes, "bytes", mufu


def sfu_floor_ms(mufu: int, clock_mhz: float) -> float:
    """MUFU instructions over 16 per clock per SM on 132 SMs at the SM
    clock read (MHz)."""
    return mufu / (SFU_LANES * clock_mhz * 1e6) * 1e3


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def timings(torch, rt, first, main_calls, calls_a, calls_d):
    """Kernel and plain version on the inputs of each kernel's first call
    on its path (`first`: name -> (args, kwargs)), in the order plain,
    kernel, kernel, plain, with the SM clock read just after the kernel's
    windows for its SFU floor.  lscv_grid_sums is timed as its grid phase
    alone, over the S that sv_matrix makes from those inputs.  A plain
    version whose first call takes over a second is timed over 2 runs, one
    over a tenth of a second over 5, the rest over 15; each line says
    which."""
    ops, ref = rt["ops"], rt["ref"]
    poly_share = rt["lscv_grid"].POLY_SHARE
    out = {}
    for name in TPU_KERNELS:
        args, kw = first[name]
        note = ""
        if name == "lscv_grid_sums":
            x, m, hg, c_k, c_kk = args
            s_mat = ops.sv_matrix(x, m)

            def kern():
                return ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk)

            def plain():
                return ref.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk)
            note = ", grid phase alone over its S"
        else:
            def kern():
                return getattr(ops, name)(*args, **kw)

            def plain():
                return getattr(ref, name)(*args, **({} if name == "sv_matrix" else kw))
        probe = time_ms(torch, plain, reps=1, warm=0)
        reps, warm = (2, 0) if probe > 1000 else ((5, 1) if probe > 100 else (15, 3))
        p1 = time_ms(torch, plain, reps=reps, warm=warm)
        k1 = time_ms(torch, kern)
        k2 = time_ms(torch, kern)
        mhz = sm_clock_mhz()
        p2 = time_ms(torch, plain, reps=reps, warm=warm)
        s_mat = None
        b, by, mufu = bound_ms(name, args, kw, poly_share)
        sfu = sfu_floor_ms(mufu, mhz)
        out[name] = (min(k1, k2), min(p1, p2), b, by, sfu, mhz)
        which = "largest" if name == "rff_density" else "first"
        print(f"time {name} ({call_shape(name, args, kw)}, the {which} call on path "
              f"{KERNEL_PATH[name]}{note}): kernel {k1:.4f} / {k2:.4f} ms (median of 15), "
              f"plain {p1:.4f} / {p2:.4f} ms (median of {reps}), bound {b:.4f} ms ({by}), "
              f"SFU floor {sfu:.4f} ms ({mufu} MUFU at {mhz:.0f} MHz); no single PyTorch "
              f"call computes it (library_ms null)")
    x, h = main_calls["aqp_batch_sums"][0][0][:2]
    a, b = all_range_bounds(torch, main_calls)
    k1 = time_ms(torch, lambda: ops.aqp_batch_sums(x, h, a, b))
    k2 = time_ms(torch, lambda: ops.aqp_batch_sums(x, h, a, b))
    print(f"time aqp_batch_sums extra shape ({call_shape('aqp_batch_sums', (x, h, a, b), {})}, "
          f"all range groups in one launch): kernel {k1:.4f} / {k2:.4f} ms, "
          f"bound {bound_ms('aqp_batch_sums', (x, h, a, b), {})[0]:.4f} ms")
    x, m = calls_a["sv_matrix"][-1][0][:2]
    k1 = time_ms(torch, lambda: ops.sv_matrix(x, m))
    k2 = time_ms(torch, lambda: ops.sv_matrix(x, m))
    print(f"time sv_matrix extra shape ({call_shape('sv_matrix', (x, m), {})}, the joint's "
          f"call on path A): kernel {k1:.4f} / {k2:.4f} ms, "
          f"bound {bound_ms('sv_matrix', (x, m), {})[0]:.4f} ms")
    args, kw = first_d1_gh(calls_d)
    p1 = time_ms(torch, lambda: ref.gh_fused_sum(*args, **kw))
    k1 = time_ms(torch, lambda: ops.gh_fused_sum(*args, **kw))
    k2 = time_ms(torch, lambda: ops.gh_fused_sum(*args, **kw))
    mhz = sm_clock_mhz()
    p2 = time_ms(torch, lambda: ref.gh_fused_sum(*args, **kw))
    b, by, mufu = bound_ms("gh_fused_sum", args, kw)
    print(f"time gh_fused_sum second shape ({call_shape('gh_fused_sum', args, kw)}, the first "
          f"1-D call on path D): kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
          f"bound {b:.4f} ms ({by}), SFU floor {sfu_floor_ms(mufu, mhz):.4f} ms at {mhz:.0f} MHz")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import synopses
    from repro_torch.core import aqp, aqp_multid, aqp_query, kde, lscv, plugin
    from repro_torch.data import aqp_store
    from repro_torch.kernels import _build, lscv_grid, ops, pairwise_reduce, ref
    rt = {"query": aqp_query, "plugin": plugin, "lscv": lscv, "store": aqp_store,
          "ops": ops, "ref": ref, "pairwise_reduce": pairwise_reduce, "aqp": aqp,
          "lscv_grid": lscv_grid,
          "aqp_multid": aqp_multid, "kde": kde, "synopses": synopses}
    t_start = time.perf_counter()

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s ({', '.join(_build.SOURCES.values())})")

    store, specs, gspecs, stream = build_store(args, rt, aqp_query)
    counts = {}
    counts["plugin"], calls_main = main_path(torch, rt, store, specs, stream)
    counts["A"], calls_a = path_a(torch, rt, store, specs, stream)
    counts["B"], calls_b = path_b(torch, rt, store)
    print(f"phases through path B: {time.perf_counter() - t_start:.1f} s")
    counts["C"], calls_c = path_c(torch, rt, store, gspecs, stream)
    counts["D"], calls_d, counts["D exact"], calls_dx = path_d(torch, rt, store, specs)
    counts["E"], calls_e = path_e(torch, rt, store, specs)
    print(f"phases through path E: {time.perf_counter() - t_start:.1f} s")
    errs = kernels_vs_plain(torch, rt, calls_main)
    errs.update(lscv_kernels_vs_plain(torch, rt, calls_a, calls_b, calls_d))
    errs.update(fullh_grouped_vs_plain(torch, rt, calls_c, calls_d, calls_dx, calls_e))
    print(f"phases through the plain-version checks: {time.perf_counter() - t_start:.1f} s")
    paths = {"plugin": calls_main, "A": calls_a, "B": calls_b, "C": calls_c, "D": calls_d,
             "D exact": calls_dx, "E": calls_e}
    first = {name: paths[KERNEL_PATH[name]][name][0] for name in TPU_KERNELS}
    first["rff_density"] = max(calls_d["rff_density"],
                               key=lambda c: c[0][0].shape[0] * c[0][1].shape[0])
    times = timings(torch, rt, first, calls_main, calls_a, calls_d)
    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        k_ms, p_ms, b_ms, by, sfu, mhz = times[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[KERNEL_PATH[name]][name],
                        "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                        "sfu_floor_ms": sfu, "sm_clock_mhz": mhz})
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
