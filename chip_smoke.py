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
  5. every kernel against its plain PyTorch version on the card, on the
     very inputs of its calls on those paths (recorded while they ran), at
     an extra shape and at edge shapes, and against a float64 oracle on a
     subsample; PLUGIN and LSCV_h against the paper's sequential oracles;
     the kernel's own eqs. 49/50 tile mapping exhaustively;
  6. kernel and plain-version times (CUDA events, median of warm runs) on
     the inputs of each kernel's first call on its path.

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

# tests/test_kernels.py tolerances
PAIR_RTOL = 3e-4
AQP_RTOL, CNT_ATOL, SUM_ATOL = 1e-4, 1e-5, 1e-4
SV_RTOL, SV_ATOL = 1e-3, 1e-3
GRID_RTOL, GRID_ATOL = 1e-3, 1e-3
GH_RTOL, GH_ATOL = 5e-4, 1e-4

# H100 SXM published peaks: FP32 outside the
# tensor cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

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
}
# the path whose launches each kernel's "launches" reports
KERNEL_PATH = {"pairwise_scaled_ksum": "plugin", "aqp_batch_sums": "plugin",
               "aqp_box_sums": "plugin", "sv_matrix": "A", "lscv_grid_sums": "A",
               "gh_fused_sum": "B"}


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
    store.track_categorical("model_id")
    for s in range(0, STREAM_ROWS, BATCH_ROWS):
        store.add_batch({k: v[s:s + BATCH_ROWS] for k, v in stream.items()})
    specs = make_specs(rng, stream, q)
    print(f"store: {STREAM_ROWS} rows streamed in {BATCH_ROWS}-row batches, "
          f"{len(specs)} specs, set-up {time.perf_counter() - t0:.2f} s")
    return store, specs, stream


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
    want = {"pairwise_scaled_ksum": 0, "aqp_batch_sums": len(RANGE_COLS), "aqp_box_sums": 1,
            "sv_matrix": n_fits, "lscv_grid_sums": n_fits, "gh_fused_sum": 0}
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
    dev = torch.device("cuda")
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


def lscv_kernels_vs_plain(torch, rt, calls_a, calls_b):
    """The LSCV kernels against their plain versions on the inputs of every
    call of path A (sv_matrix, lscv_grid_sums) and the first and last calls
    of path B (gh_fused_sum), at edge shapes, and against float64; path A's
    aqp_batch / aqp_boxes calls against theirs; LSCV_h at n = 512 on the
    card against the paper's sequential float64 oracle."""
    ops, ref, lscv = rt["ops"], rt["ref"], rt["lscv"]
    dev = torch.device("cuda")
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
    for n in (1, 2, 4097):
        xs = torch.as_tensor(rng.normal(0, 1, (n, 2)).astype(np.float32), device=dev)
        ms = torch.eye(2, device=dev)
        hg = torch.linspace(0.05, 2.0, 150, device=dev)
        held(ops.lscv_grid_sums(xs, ms, hg, 0.3, 0.2).cpu(),
             ref.lscv_grid_sums(xs, ms, hg, 0.3, 0.2).cpu(), GRID_RTOL, GRID_ATOL,
             f"lscv_grid_sums n={n}")
    xs = rng.normal(0.0, 1.0, (512, 3)).astype(np.float32)
    res = lscv.lscv_h(xs, backend="cuda", device="cuda")
    worst = 0.0
    for i in (0, 50, 100, 149):
        oracle = lscv.g_of_h_sequential(xs, float(res.h_grid[i]))
        rel = abs(float(res.g_values[i]) - oracle) / abs(oracle)
        check(rel < 2e-3, f"LSCV_h n=512 g[{i}] {float(res.g_values[i])} vs float64 {oracle}")
        worst = max(worst, rel)
    print(f"lscv_grid_sums: {len(errs)} path-A calls match plain, max |err| {max(errs):.3g}; "
          f"edge shapes n=1/2/4097 match; LSCV_h n=512 d=3 on the kernels within {worst:.2g} "
          f"relative of the sequential float64 oracle at 4 grid points")

    made = calls_b["gh_fused_sum"]
    errs = []
    for tag, (args, kw) in (("first", made[0]), ("last", made[-1])):
        errs.append(held(float(ops.gh_fused_sum(*args, **kw)),
                         float(ref.gh_fused_sum(*args, **kw)), GH_RTOL, GH_ATOL,
                         f"gh_fused_sum {tag} path-B call"))
    out["gh_fused_sum"] = max(errs)
    x, h_inv, c_k, c_kk = made[-1][0]
    sub = x[:4096].contiguous()
    held(float(ops.gh_fused_sum(sub, h_inv, c_k, c_kk)),
         oracle_quadform_sum(sub.cpu().numpy(), h_inv.cpu().numpy(), float(c_k), float(c_kk)),
         GH_RTOL, GH_ATOL, "gh_fused_sum vs float64")
    for n in (1, 2, 4097):
        for d in (1, 3, 8):
            xs = torch.as_tensor(rng.normal(0, 1, (n, d)).astype(np.float32), device=dev)
            m0 = rng.normal(0, 1, (d, d))
            ms = torch.as_tensor((0.1 * m0 @ m0.T + np.eye(d)).astype(np.float32), device=dev)
            held(float(ops.gh_fused_sum(xs, ms, 0.31, 0.17)),
                 float(ref.gh_fused_sum(xs, ms, 0.31, 0.17)), GH_RTOL, GH_ATOL,
                 f"gh_fused_sum n={n} d={d}")
    print(f"gh_fused_sum: first and last of {len(made)} path-B calls match plain, max |err| "
          f"{max(errs):.3g}; n=4096 within tolerance of float64; edge shapes n=1/2/4097 x "
          f"d=1/3/8 match plain")
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


# FP32 operations per pair of the pairwise kernel: sub, scale, square, the
# polynomial's FMAs, the density's multiplies, exp, add
PAIR_OPS = {"k6": 14, "k4": 13, "gauss": 10}


def bound_ms(name: str, args, kwargs) -> tuple:
    """Least time on an H100 for the work of one call: the larger of bytes
    (each input read once, each output written once) over HBM bandwidth and
    operations over the FP32 peak.  Operations count each exp / erfc as one
    and each FMA as one (a lower bound: on the card an exp is several
    instructions or an SFU op, and the peak counts an FMA as two).  For
    lscv_grid_sums the work is the grid phase alone: the strict upper
    triangle of S read once, 4 operations per (pair, h) (scale, exp2,
    two FMAs)."""
    if name == "pairwise_scaled_ksum":
        x = args[0]
        n = x.shape[0]
        nbytes = 4 * n + 4 + 4
        ops = PAIR_OPS[kwargs["kind"]] * n * (n - 1) // 2
    elif name == "aqp_batch_sums":
        x, _h, a, _b = args
        n, q = x.shape[0], a.shape[0]
        nbytes = 4 * n + 4 + 8 * q + 8 * q
        ops = 24 * n * q                     # 2 erfc, 2 exp, ~20 FP32 per pair
    elif name == "aqp_box_sums":
        x, _h, lo, _hi, _t = args
        (n, d), q = x.shape, lo.shape[0]
        nbytes = 4 * n * d + 4 * d + 8 * q * d + 4 * q + 8 * q
        ops = (13 * d + 13) * n * q          # per axis 2 erfc + 11; target 2 exp + 11
    elif name == "sv_matrix":
        n, d = args[0].shape
        nbytes = 4 * n * d + 4 * d * d + 4 * n * n
        ops = (2 * d + d * (d + 1) // 2) * n * (n - 1) // 2   # subs, quadratic-form FMAs
    elif name == "lscv_grid_sums":
        n, n_h = args[0].shape[0], args[2].shape[0]
        nbytes = 4 * n * (n - 1) // 2 + 8 * n_h + 8
        ops = 4 * n_h * n * (n - 1) // 2
    else:                                    # gh_fused_sum
        n, d = args[0].shape
        nbytes = 4 * n * d + 4 * d * d + 8 + 4
        ops = (2 * d + d * (d + 1) // 2 + 3) * n * (n - 1) // 2  # + exp2, two FMAs
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timings(torch, rt, first, main_calls, calls_a):
    """Kernel and plain version on the inputs of each kernel's first call
    on its path (`first`: name -> (args, kwargs)), in the order plain,
    kernel, kernel, plain.  lscv_grid_sums is timed as its grid phase alone,
    over the S that sv_matrix makes from those inputs.  A plain version
    whose first call takes over a second is timed over 2 runs, one over a
    tenth of a second over 5, the rest over 15; each line says which."""
    ops, ref = rt["ops"], rt["ref"]
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
        p2 = time_ms(torch, plain, reps=reps, warm=warm)
        s_mat = None
        b, by = bound_ms(name, args, kw)
        out[name] = (min(k1, k2), min(p1, p2), b, by)
        print(f"time {name} ({call_shape(name, args, kw)}, the first call on path "
              f"{KERNEL_PATH[name]}{note}): kernel {k1:.4f} / {k2:.4f} ms (median of 15), "
              f"plain {p1:.4f} / {p2:.4f} ms (median of {reps}), bound {b:.4f} ms ({by}); "
              f"no single PyTorch call computes it (library_ms null)")
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
    from repro_torch.core import aqp_query, lscv, plugin
    from repro_torch.data import aqp_store
    from repro_torch.kernels import _build, ops, pairwise_reduce, ref
    rt = {"query": aqp_query, "plugin": plugin, "lscv": lscv, "store": aqp_store,
          "ops": ops, "ref": ref, "pairwise_reduce": pairwise_reduce}
    t_start = time.perf_counter()

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s ({', '.join(_build.SOURCES.values())})")

    store, specs, stream = build_store(args, rt, aqp_query)
    counts = {}
    counts["plugin"], calls_main = main_path(torch, rt, store, specs, stream)
    counts["A"], calls_a = path_a(torch, rt, store, specs, stream)
    counts["B"], calls_b = path_b(torch, rt, store)
    print(f"phases through path B: {time.perf_counter() - t_start:.1f} s")
    errs = kernels_vs_plain(torch, rt, calls_main)
    errs.update(lscv_kernels_vs_plain(torch, rt, calls_a, calls_b))
    print(f"phases through the plain-version checks: {time.perf_counter() - t_start:.1f} s")
    paths = {"plugin": calls_main, "A": calls_a, "B": calls_b}
    first = {name: paths[KERNEL_PATH[name]][name][0] for name in TPU_KERNELS}
    times = timings(torch, rt, first, calls_main, calls_a)
    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        k_ms, p_ms, b_ms, by = times[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[KERNEL_PATH[name]][name],
                        "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": by, "library_ms": None})
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
