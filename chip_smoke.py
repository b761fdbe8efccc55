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
  3. every kernel against its plain PyTorch version on the card, on the
     very inputs of each of its main-path calls (recorded while the main
     path ran), at an extra shape and at edge shapes, and against a float64
     oracle on a subsample; PLUGIN against the paper's sequential oracle;
     the kernel's own eqs. 49/50 tile mapping exhaustively;
  4. kernel and plain-version times (CUDA events, median of warm runs) on
     the inputs of each kernel's first main-path call.

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
}


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
    return f"q={args[2].shape[0]} n={args[0].shape[0]} d={args[0].shape[1]}"


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

def main_path(args, torch, rt):
    q, ops = rt["query"], rt["ops"]
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
    print(f"main path: {STREAM_ROWS} rows streamed in {BATCH_ROWS}-row batches, "
          f"{len(specs)} specs, set-up {time.perf_counter() - t0:.2f} s")

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with recording(ops) as calls:
        res = store.query(specs)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    counts = ops.launch_counts()
    print(f"main path first query (fits included): {first_s * 1e3:.1f} ms; "
          f"launches {counts}")
    for name, made in calls.items():
        check(len(made) == counts[name],
              f"{name}: {len(made)} wrapper calls but {counts[name]} launches")
        print(f"main-path calls of {name}: "
              f"{', '.join(call_shape(name, a, k) for a, k in made)}")

    check(len(res) == len(specs), "one result per spec")
    est = np.asarray([r.estimate for r in res])
    lo = np.asarray([r.ci_lo for r in res])
    hi = np.asarray([r.ci_hi for r in res])
    check(bool(np.all(np.isfinite(est))), "non-finite estimate")
    check(bool(np.all((lo <= est) & (est <= hi))), "an estimate outside its CI")
    paths = [r.path for r in res]
    check(set(paths[:N_RANGE]) == {"range1d:cuda"}, f"range paths {set(paths[:N_RANGE])}")
    check(set(paths[N_RANGE:N_RANGE + N_BOX]) == {"box:cuda"}, "box paths")
    check(set(paths[N_RANGE + N_BOX:]) == {"exact"}, "Eq paths")
    n_axes = len(RANGE_COLS) + len(JOINT)
    check(counts["pairwise_scaled_ksum"] >= 2 * n_axes,
          f"pairwise launched {counts['pairwise_scaled_ksum']} < {2 * n_axes}")
    check(counts["aqp_batch_sums"] >= len(RANGE_COLS), "aqp_batch launches")
    check(counts["aqp_box_sums"] >= 1, "aqp_boxes launches")

    # answers vs a float64 closed form of the same synopses (scaled), on the
    # first 32 specs of each range column and of the boxes
    for col in RANGE_COLS:
        syn = store.synopsis(col)
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
        check(ok, f"range1d:cuda answers on {col} vs float64 (max err {err})")
    syn = store.joint_synopsis(JOINT)
    idx = list(range(N_RANGE, N_RANGE + 48))
    boxes = [specs[i].predicates[0] for i in idx]
    tgt = [0 if specs[i].target is None else JOINT.index(specs[i].target) for i in idx]
    c64, s64 = oracle_boxes(syn.x.cpu().numpy(), syn.h.cpu().numpy(),
                            [bx.lo for bx in boxes], [bx.hi for bx in boxes], tgt)
    scale = syn.n_source / syn.x.shape[0]
    want = []
    for j, i in enumerate(idx):
        cnt, sm = scale * c64[j], scale * s64[j]
        want.append({"count": cnt, "sum": sm}.get(specs[i].aggregate,
                                                  sm / cnt if cnt > 1e-3 else 0.0))
    ok, err = close(est[idx], want, 1e-4, 1e-3)
    check(ok, f"box:cuda answers vs float64 (max err {err})")
    # exact path vs the stream itself
    codes = stream["model_id"]
    for i in range(N_RANGE + N_BOX, len(specs)):
        v = specs[i].predicates[0].value
        cnt = int(np.sum(codes == np.float32(v)))
        want = {"count": float(cnt), "sum": float(v * cnt)}.get(
            specs[i].aggregate, v if cnt else 0.0)
        check(est[i] == want, f"exact answer {est[i]} != {want}")

    misses = store.cache.stats()["misses"]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res2 = store.query(specs)
    torch.cuda.synchronize()
    repeat_s = time.perf_counter() - t2
    counts2 = ops.launch_counts()
    same = all(r.estimate == r2.estimate and r.ci_lo == r2.ci_lo and r.ci_hi == r2.ci_hi
               and r.path == r2.path for r, r2 in zip(res, res2))
    check(same, "repeat query not bit-identical")
    check(store.cache.stats()["misses"] == misses and counts2["pairwise_scaled_ksum"] == 0,
          "repeat query refitted instead of using the cached fits")
    print(f"main path repeat query (cached fits): {repeat_s * 1e3:.1f} ms; "
          f"launches {counts2}; bit-identical answers")
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
    (a lower bound: on the card each is several instructions or an SFU op)."""
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
    else:
        x, _h, lo, _hi, _t = args
        (n, d), q = x.shape, lo.shape[0]
        nbytes = 4 * n * d + 4 * d + 8 * q * d + 4 * q + 8 * q
        ops = (13 * d + 13) * n * q          # per axis 2 erfc + 11; target 2 exp + 11
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timings(torch, rt, calls):
    """Kernel and plain version on the inputs of each kernel's first
    main-path call, in the order plain, kernel, kernel, plain."""
    ops, ref = rt["ops"], rt["ref"]
    out = {}
    for name in TPU_KERNELS:
        args, kw = calls[name][0]
        kern = getattr(ops, name)
        plain = getattr(ref, name)
        p1 = time_ms(torch, lambda: plain(*args, **kw))
        k1 = time_ms(torch, lambda: kern(*args, **kw))
        k2 = time_ms(torch, lambda: kern(*args, **kw))
        p2 = time_ms(torch, lambda: plain(*args, **kw))
        b, by = bound_ms(name, args, kw)
        out[name] = (min(k1, k2), min(p1, p2), b, by)
        print(f"time {name} ({call_shape(name, args, kw)}, the main path's first call): "
              f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
              f"bound {b:.4f} ms ({by}); no single PyTorch call computes it "
              f"(library_ms null)")
    x, h = calls["aqp_batch_sums"][0][0][:2]
    a, b = all_range_bounds(torch, calls)
    k1 = time_ms(torch, lambda: ops.aqp_batch_sums(x, h, a, b))
    k2 = time_ms(torch, lambda: ops.aqp_batch_sums(x, h, a, b))
    print(f"time aqp_batch_sums extra shape ({call_shape('aqp_batch_sums', (x, h, a, b), {})}, "
          f"all range groups in one launch): kernel {k1:.4f} / {k2:.4f} ms, "
          f"bound {bound_ms('aqp_batch_sums', (x, h, a, b), {})[0]:.4f} ms")
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
    from repro_torch.core import aqp_query, plugin
    from repro_torch.data import aqp_store
    from repro_torch.kernels import _build, ops, pairwise_reduce, ref
    rt = {"query": aqp_query, "plugin": plugin, "store": aqp_store, "ops": ops,
          "ref": ref, "pairwise_reduce": pairwise_reduce}

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s ({', '.join(_build.SOURCES.values())})")

    counts, calls = main_path(args, torch, rt)
    errs = kernels_vs_plain(torch, rt, calls)
    times = timings(torch, rt, calls)
    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        k_ms, p_ms, b_ms, by = times[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
