#!/usr/bin/env python3
"""Time the port's GROUP BY and full-H serving on one CUDA device, at
chip_smoke.py's store (32 768-row reservoirs fed 1 000 000 streamed rows
from `--seed`): the warm path C query (104 GROUP BY specs over model_id),
the warm path D exact query (the 1 024-spec mix with selector "lscv_H" and
kde_backend "exact"), and the aqp_grouped and qmc_reduce kernel calls that
each query makes, replayed alone.

    python3 scripts/bench_aqp_kernels.py [--root DIR] [--label TEXT]
                                         [--reps N] [--splits]

`--root` times the `repro_torch` of another checkout (its kernels build
into that checkout's own `build/`), so two commits compare in one run on
one card: run parent, change, change, parent.  The store, specs and fits
come from this checkout's chip_smoke.py helpers and the timed checkout's
public API (`TelemetryStore.query`, `shared_engine`), so both sides answer
the same queries; the fits are made once, before any timing.  `--splits`
adds one more run of each query with CUDA-synced host wall time per engine
function (those of `core/aqp_query.py`'s imports that the checkout has),
and device kernel time by name from `torch.profiler`.

Prints one JSON line: per query the warm walls (ms, every rep) and the
interpreter's full (generation 2) collections during them, the kernel
replay time (median of CUDA-event windows over the query's recorded calls
of the two kernels), and per full-H group the replay of its calls; the
card's name, power limit and SM clock sampled after each section.  Needs a
CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
KERNEL_WRAPPERS = ("aqp_grouped_sums", "aqp_grouped_moments", "qmc_box_reduce",
                   "qmc_box_reduce_split")
# engine functions timed by --splits, where the checkout's aqp_query has
# them: compiling the specs (GROUP BY expansion), _execute (resolving each
# entry, the groups' passes and the result rows), and inside it the
# per-entry resolution and each group's pass with its parts
ENGINE_FUNCS = ("QueryEngine.compile", "_execute", "_StoreResolver.__call__",
                "_StoreResolver.try_exact", "_run_group", "grouped_family_moments",
                "batch_query_box_grouped", "moments_box", "se_from_moments",
                "qmc_answers_and_se", "batch_query_qmc", "qmc_subsample_se")
# called once per entry and host-only: timed without a device sync
PER_ENTRY = ("_StoreResolver.__call__", "_StoreResolver.try_exact")


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warm: int = 2) -> list:
    for _ in range(warm):
        fn()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def walls(torch, fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def recorded(ops, fn):
    """Run fn with the kernel wrappers of `ops` recording their calls;
    returns [(wrapper, args, kwargs)] in call order."""
    calls = []
    originals = {w: getattr(ops, w) for w in KERNEL_WRAPPERS if hasattr(ops, w)}

    def keep(w):
        def wrapper(*a, **k):
            calls.append((w, a, k))
            return originals[w](*a, **k)
        return wrapper

    for w in originals:
        setattr(ops, w, keep(w))
    try:
        fn()
    finally:
        for w, f in originals.items():
            setattr(ops, w, f)
    return calls


def replay_ms(torch, ops, calls, reps: int) -> float:
    return float(np.median(time_ms(
        torch, lambda: [getattr(ops, w)(*a, **k) for w, a, k in calls], reps)))


def split_walls(torch, query_mod, fn) -> dict:
    """{engine function: host ms inside it} over one run of fn, nested
    calls counted in each enclosing function too; CUDA-synced on entry and
    exit except the per-entry host functions.  gc_gen2 counts the
    interpreter's full collections during the run."""
    spent = collections.Counter()
    owners = {}
    for f in ENGINE_FUNCS:
        owner_name, _, attr = f.rpartition(".")
        owner = getattr(query_mod, owner_name) if owner_name else query_mod
        if hasattr(owner, attr):
            owners[f] = (owner, attr, getattr(owner, attr))

    def timed(name, orig):
        sync = torch.cuda.synchronize if name not in PER_ENTRY else (lambda: None)

        def wrapper(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            sync()
            spent[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    for f, (owner, attr, orig) in owners.items():
        setattr(owner, attr, timed(f, orig))
    gen2 = gc.get_stats()[2]["collections"]
    try:
        total = walls(torch, fn, 1)[0]
    finally:
        for owner, attr, orig in owners.values():
            setattr(owner, attr, orig)
    return {"total_ms": total, "gc_gen2": gc.get_stats()[2]["collections"] - gen2,
            **{k: round(v, 4) for k, v in spent.items()}}


def device_kernels(torch, fn, top: int = 8) -> dict:
    """Device time by kernel name (torch.profiler) over one run of fn."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us and "CUDA" in str(getattr(ev, "device_type", "")):
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return {"device_ms_total": round(sum(r[1] for r in rows), 4),
            "top": [[k[:60], round(ms, 4), c] for k, ms, c in rows[:top]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--splits", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_aqp_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    sys.path.insert(0, str(args.root / "src"))
    from repro_torch.core import aqp_query
    from repro_torch.data import aqp_store
    from repro_torch.kernels import _build, ops

    res = {"label": args.label, "root": str(args.root), "card": smi("name,power.limit"),
           "clocks_sm": []}
    t0 = time.perf_counter()
    res["build_s"] = _build.build_all()
    rng = np.random.default_rng(args.seed)
    stream = cs.make_stream(rng)
    store = aqp_store.TelemetryStore(capacity=cs.CAPACITY, seed=args.seed)
    store.track_joint(cs.JOINT)
    store.track_joint(cs.GJOINT)
    store.track_categorical("model_id")
    for s in range(0, cs.STREAM_ROWS, cs.BATCH_ROWS):
        store.add_batch({k: v[s:s + cs.BATCH_ROWS] for k, v in stream.items()})
    specs = cs.make_specs(rng, stream, aqp_query)
    gspecs = cs.make_group_specs(rng, stream, aqp_query)
    eng = store.shared_engine("lscv_H")
    queries = {"path_c": lambda: store.query(gspecs),
               "path_d_exact": lambda: eng.execute(specs, kde_backend="exact")}
    for fn in queries.values():          # fits (PLUGIN, LSCV_H) and first use
        fn()
    torch.cuda.synchronize()
    res["setup_s"] = time.perf_counter() - t0

    for name, fn in queries.items():
        fn()
        gen2 = gc.get_stats()[2]["collections"]
        res[f"{name}_warm_ms"] = walls(torch, fn, args.reps)
        res[f"{name}_gc_gen2"] = gc.get_stats()[2]["collections"] - gen2
        res["clocks_sm"].append(smi("clocks.sm"))
        calls = recorded(ops, fn)
        res[f"{name}_kernel_calls"] = collections.Counter(w for w, _, _ in calls)
        res[f"{name}_kernel_replay_ms"] = replay_ms(torch, ops, calls, args.reps)
        if name == "path_d_exact":
            per = len(calls) // 3        # three full-H groups: loss, latency_ms, the joint
            res["path_d_exact_group_replay_ms"] = [
                replay_ms(torch, ops, calls[g * per:(g + 1) * per], args.reps)
                for g in range(3)]
            res["path_d_exact_first_call_ms"] = replay_ms(torch, ops, calls[:1], args.reps)
        res["clocks_sm"].append(smi("clocks.sm"))
        if args.splits:
            res[f"{name}_splits"] = split_walls(torch, aqp_query, fn)
            res[f"{name}_device"] = device_kernels(torch, fn)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
