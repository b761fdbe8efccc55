#!/usr/bin/env python3
"""Time the port's serving paths on one CUDA device, at chip_smoke.py's
store (32 768-row reservoirs fed 1 000 000 streamed rows from `--seed`):
the warm main-path query (the 1 024-spec mix with selector "plugin"), the
same with "lscv_h" (path A), the warm path C query (104 GROUP BY specs over
model_id), the warm path D exact query (the 1 024-spec mix with selector
"lscv_H" and kde_backend "exact"), the warm path D query with kde_backend
"auto" (RFF groups where the probe gate passes), a PLUGIN refit of the
main path's five axes, and path E (chip_smoke's 130 kde_eval calls); and the
kernel calls that each makes (aqp_batch, aqp_boxes, aqp_grouped, qmc_reduce,
rff_eval, pairwise, kde_eval), replayed alone.

    python3 scripts/bench_aqp_kernels.py [--root DIR] [--label TEXT]
                                         [--reps N] [--splits]
                                         [--paths plugin_warm,a_warm,c,...]
                                         [--set FILE:NAME=VALUE] [--sass]

`--root` times the `repro_torch` of another checkout (its kernels build
into that checkout's own `build/`), so two commits compare in one run on
one card: run parent, change, change, parent.  The store, specs and fits
come from this checkout's chip_smoke.py helpers and the timed checkout's
public API (`TelemetryStore.query`, `shared_engine`), so both sides answer
the same queries; the fits are made once, before any timing.  `--splits`
adds one more run of each query with CUDA-synced host wall time per engine
function (those of `core/aqp_query.py`'s imports that the checkout has),
and device kernel time by name and the count of device kernels and copies
per query from `torch.profiler`.

Prints one JSON line: per query the warm walls (ms, every rep) and the
interpreter's full (generation 2) collections during them, the kernel
replay time (median of CUDA-event windows over the query's recorded calls
of the kernels), and per full-H group the replay of its calls; the
card's name, power limit and SM clock sampled after each section.
`--paths` picks the sections (default: all).  The plugin_warm and a_warm
sections replay their range and box groups' aqp_batch / aqp_boxes calls and
give their device time by kernel and the wrappers' host time (the calls
issued without a device sync).  The PLUGIN section times the
refit (CUDA-synced wall of `plugin_bandwidth` on the five axes' samples)
and replays its ten pairwise calls; the D auto section replays each RFF
group's rff_eval calls.  The E section (`--paths e`) replays path E's calls
by shape (the 4 096-point grids at d = 1 and d = 3, the 513-point
trapezoid grids) with, per call, the wall, the host work issued unsynced,
device ms and device kernels from torch.profiler, the bound and the SFU
floor at the SM clock read after the shape; and the walls of the whole
run.  `--set` times a variant: it copies the timed
checkout's `src/repro_torch` into a temporary directory and sets
`constexpr NAME` in `kernels/csrc/FILE` (a .cu) or the module constant
`NAME` in `kernels/FILE` (a .py) to VALUE there (repeatable).  `--sass`
prints, for the pairwise, rff_eval, aqp_batch, aqp_boxes and kde_eval kernels
of the timed checkout, the
instructions of each loop by opcode, all of them and those of its hot
path, from `cuobjdump -sass`; every run prints their registers per thread
from the ptxas logs.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from bench_lscv_kernels import cuobjdump_sass, smi, time_ms, variant_root

REPO = Path(__file__).resolve().parents[1]
KERNEL_WRAPPERS = ("aqp_batch_sums", "aqp_batch_moments", "aqp_box_sums",
                   "aqp_box_moments", "aqp_grouped_sums", "aqp_grouped_moments",
                   "qmc_box_reduce", "qmc_box_reduce_split", "rff_density",
                   "rff_density_blocks", "pairwise_scaled_ksum", "kde_eval")
PATHS = ("plugin_warm", "a_warm", "c", "d_exact", "d_auto", "plugin", "e")
# engine functions timed by --splits, where the checkout's aqp_query has
# them: compiling the specs (GROUP BY expansion), _execute (resolving each
# entry, the groups' passes and the result rows), and inside it the
# per-entry resolution and each group's pass with its parts (a range or box
# group's estimate and CI moment passes, or its one-launch helper)
ENGINE_FUNCS = ("QueryEngine.compile", "_execute", "_StoreResolver.__call__",
                "_StoreResolver.try_exact", "_run_group", "batch_query_1d",
                "batch_query_box", "moments_1d", "range_answers_and_se",
                "box_answers_and_se", "grouped_family_moments",
                "batch_query_box_grouped", "moments_box", "se_from_moments",
                "qmc_answers_and_se", "batch_query_qmc", "qmc_subsample_se",
                "qmc_rff_answers_and_se", "batch_query_qmc_rff", "qmc_rff_se")
# called once per entry and host-only: timed without a device sync
PER_ENTRY = ("_StoreResolver.__call__", "_StoreResolver.try_exact")


def sass_functions(build_dir: Path, libs) -> list:
    """[(function, [(addr, opcode, predicated, branch target)])] from
    cuobjdump -sass of the named libraries."""
    out = []
    for _, text in cuobjdump_sass(build_dir, libs):
        labels, pending, raw = {}, [], []
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                out.append((m.group(1), raw := []))
                labels, pending = {}, []
                continue
            lab = re.match(r"\s*\.(L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not m or not out:
                continue
            addr, body = int(m.group(1), 16), m.group(2).strip()
            for lb in pending:
                labels[lb] = addr
            pending = []
            pred = bool(re.match(r"@!?U?P\w+\s", body))
            body = re.sub(r"^@!?U?P\w+\s+", "", body)
            br = re.search(r"BRA\s+(?:`\(\.(L_x_\d+)\)|0x([0-9a-f]+))", body)
            tgt = (br.group(1) if br.group(1) else int(br.group(2), 16)) if br else None
            raw.append([addr, body.split()[0] if body else "?", pred, tgt, labels])
    return [(name, [(a, op, pr, lb.get(t) if isinstance(t, str) else t)
                    for a, op, pr, t, lb in ins]) for name, ins in out]


def sass_loops(build_dir: Path,
               libs=("pairwise_reduce", "rff_eval", "aqp_batch", "aqp_boxes", "kde_eval"),
               funcs=("pairwise_tiles", "rff_tiles", "aqp_batch_tiles", "aqp_box_tiles",
                      "kde_tiles")
               ) -> dict:
    """{kernel function: [loop]} from cuobjdump -sass: every loop (the
    instructions from a backward branch's target to the branch) with its
    opcode counts ("all") and those of its hot path ("hot": the basic
    blocks reached from the loop's head inside the loop without entering a
    cold block, one that touches local memory (STL / LDL, as cosf's
    Payne-Hanek reduction does) or lies in a nested loop)."""
    out = {}
    for name, ins in sass_functions(build_dir, libs):
        if not any(f in name for f in funcs):
            continue
        addrs = [a for a, _, _, _ in ins]
        loops = sorted({(t, a) for a, _, _, t in ins if t is not None and t <= a})
        leaders = {addrs[0]} | {t for _, _, _, t in ins if t is not None}
        leaders |= {addrs[k + 1] for k, (_, op, _, t) in enumerate(ins[:-1])
                    if t is not None or op in ("EXIT", "RET")}
        blocks, cur = {}, None
        for a, op, pr, t in ins:
            if a in leaders:
                cur = a
                blocks[cur] = []
            blocks[cur].append((a, op, pr, t))
        starts = sorted(blocks)
        found = []
        for lo, hi in loops:
            nested = [(l2, h2) for l2, h2 in loops if (l2, h2) != (lo, hi) and lo <= l2 and h2 <= hi]

            def succ(b):
                a, op, pr, t = blocks[b][-1]
                nxt = starts.index(b) + 1
                out_ = [t] if t is not None else []
                if (t is None or pr) and op not in ("EXIT", "RET") and nxt < len(starts):
                    out_.append(starts[nxt])
                return [c for c in out_ if lo <= c <= hi]

            inside = [b for b in starts if lo <= b <= hi]
            cold = {b for b in inside
                    if any(op in ("STL", "LDL") for _, op, _, _ in blocks[b])
                    or any(l2 <= b <= h2 for l2, h2 in nested)}
            grew = True
            while grew:                   # blocks that lead only into cold ones
                grew = False
                for b in inside:
                    if b != lo and b not in cold and succ(b) and all(c in cold for c in succ(b)):
                        cold.add(b)
                        grew = True
            seen, todo = set(), [lo]
            while todo:
                b = todo.pop()
                if b in seen or b in cold:
                    continue
                seen.add(b)
                todo.extend(succ(b))
            found.append({"range": [lo, hi],
                          "all": dict(collections.Counter(op for a, op, _, _ in ins
                                                          if lo <= a <= hi)),
                          "hot": dict(collections.Counter(op for b in sorted(seen)
                                                          for _, op, _, _ in blocks[b]))})
        out[name] = found
    return out


def ptxas_registers(build_mod, names=("pairwise_reduce", "rff_eval", "aqp_batch",
                                      "aqp_boxes", "kde_eval")) -> dict:
    """{kernel function: registers per thread} from the build's ptxas logs."""
    out = {}
    for name in names:
        log = build_mod.target(name).with_suffix(".log")
        func = None
        for line in log.read_text().splitlines() if log.exists() else []:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                func = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and func:
                out[func] = int(m.group(1))
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


def host_ms(torch, ops, calls, reps: int) -> float:
    """Median host time (ms) of issuing the recorded calls once, without a
    device sync inside the window (the wrappers' own work: checks,
    allocation, the launch), each run after the device has drained."""
    out = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w, a, k in calls:
            getattr(ops, w)(*a, **k)
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(out[2:]))


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
    """Device time by kernel name (torch.profiler) over one run of fn, and
    the count of device kernels and of copies / fills it ran."""
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
    copies = sum(c for k, _, c in rows if k.startswith(("Memcpy", "Memset")))
    return {"device_ms_total": round(sum(r[1] for r in rows), 4),
            "kernels": sum(c for _, _, c in rows) - copies, "copies": copies,
            "top": [[k[:60], round(ms, 4), c] for k, ms, c in rows[:top]]}


def rff_groups(calls) -> list:
    """The recorded rff_eval calls of a warm query, split into its RFF
    groups: a group opens with the call over all D features (the estimate's:
    `rff_density_blocks`, or the PR 13 design's `rff_density` before its
    eight block calls)."""
    rff = [c for c in calls if c[0] in ("rff_density", "rff_density_blocks")]
    full = max((a[1].shape[0] for _, a, _ in rff), default=0)
    groups = []
    for c in rff:
        if c[1][1].shape[0] == full:
            groups.append([])
        groups[-1].append(c)
    return groups


def path_e_section(torch, cs, ops, e_run, reps: int) -> dict:
    """Path E (chip_smoke's 130 kde_eval calls) by shape: the 4 096-point
    grids at d = 1 and d = 3 and the 128 trapezoid grids of 513 points.  Per
    call: the replay's wall (median of CUDA-event windows over the shape's
    calls), the host work issued unsynced, device ms and device kernels and
    copies from torch.profiler, and the SFU floor (one MUFU a pair, the SM
    clock read after the shape's windows); and the walls of the whole run."""
    calls = recorded(ops, e_run)
    out = {"e_calls": len(calls), "e_run_ms": walls(torch, e_run, reps)}
    shapes = collections.defaultdict(list)
    for c in calls:
        shapes[f"m{c[1][0].shape[0]}_d{c[1][1].shape[-1]}"].append(c)
    for key, group in shapes.items():
        k = len(group)
        replay = lambda g=group: [getattr(ops, w)(*a, **kw) for w, a, kw in g]  # noqa: E731
        dev = device_kernels(torch, replay)
        mhz = float(smi("clocks.sm").split()[0])
        _, a, kw = group[0]
        b, by, mufu = cs.bound_ms("kde_eval", a, kw)
        out[f"e_{key}"] = {
            "calls": k, "n": a[1].shape[0],
            "wall_ms": replay_ms(torch, ops, group, reps) / k,
            "host_ms": host_ms(torch, ops, group, reps) / k,
            "device_ms": dev["device_ms_total"] / k,
            "device_kernels": dev["kernels"] / k, "copies": dev["copies"] / k,
            "top": dev["top"], "bound_ms": b, "bound_by": by,
            "sfu_floor_ms": cs.sfu_floor_ms(mufu, mhz), "sm_clock_mhz": mhz}
    return out


def run(args, root: Path, paths) -> dict:
    import torch
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import aqp, aqp_query, kde, plugin
    from repro_torch.data import aqp_store
    from repro_torch.kernels import _build, ops

    res = {"label": args.label, "root": str(args.root), "set": args.set,
           "card": smi("name,power.limit"), "clocks_sm": []}
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
    queries = {"path_plugin_warm": lambda: store.query(specs),
               "path_a_warm": lambda: store.query(specs, selector="lscv_h"),
               "path_c": lambda: store.query(gspecs),
               "path_d_exact": lambda: eng.execute(specs, kde_backend="exact"),
               "path_d_auto": lambda: store.query(specs, selector="lscv_H")}
    queries = {k: v for k, v in queries.items() if k[len("path_"):] in paths}
    if "e" in paths:                      # path E's synopses: PLUGIN (loss), LSCV_h (joint)
        e_run = cs.path_e_inputs(torch, {"kde": kde, "aqp": aqp}, store, specs)[0]
        e_run()
    if "plugin" in paths:                 # the main path's first query: its PLUGIN fits
        fit_calls = [c for c in recorded(ops, lambda: store.query(specs))
                     if c[0] == "pairwise_scaled_ksum"]
    for fn in queries.values():          # fits (PLUGIN, LSCV_H, RFF) and first use
        fn()
    torch.cuda.synchronize()
    res["setup_s"] = time.perf_counter() - t0

    if "plugin" in paths:
        xs = [a[0] for _, a, k in fit_calls if k.get("kind") == "k6"]
        res["plugin_kernel_calls"] = len(fit_calls)
        res["plugin_refit_ms"] = walls(torch, lambda: [plugin.plugin_bandwidth(x, backend="cuda")
                                                       for x in xs], args.reps)
        res["plugin_kernel_replay_ms"] = replay_ms(torch, ops, fit_calls, args.reps)
        res["plugin_first_call_ms"] = replay_ms(torch, ops, fit_calls[:1], args.reps)
        res["plugin_device"] = device_kernels(
            torch, lambda: [getattr(ops, w)(*a, **k) for w, a, k in fit_calls])
        res["clocks_sm"].append(smi("clocks.sm"))
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
        if name in ("path_plugin_warm", "path_a_warm"):
            aqp = [c for c in calls if c[0].startswith(("aqp_batch", "aqp_box"))]
            res[f"{name}_aqp_calls"] = [f"{w} {tuple(a[2].shape)}" for w, a, _ in aqp]
            res[f"{name}_aqp_replay_ms"] = replay_ms(torch, ops, aqp, args.reps)
            res[f"{name}_aqp_host_ms"] = host_ms(torch, ops, aqp, args.reps)
            res[f"{name}_aqp_device"] = device_kernels(
                torch, lambda: [getattr(ops, w)(*a, **k) for w, a, k in aqp])
            res[f"{name}_query_device"] = device_kernels(torch, fn)
        if name == "path_d_auto":
            groups = rff_groups(calls)
            res["path_d_auto_rff_group_calls"] = [len(g) for g in groups]
            res["path_d_auto_rff_group_replay_ms"] = [replay_ms(torch, ops, g, args.reps)
                                                      for g in groups]
            res["path_d_auto_rff_first_call_ms"] = replay_ms(torch, ops, groups[0][:1],
                                                             args.reps)
            res["path_d_auto_rff_device"] = device_kernels(
                torch, lambda: [getattr(ops, w)(*a, **k) for g in groups for w, a, k in g])
        res["clocks_sm"].append(smi("clocks.sm"))
        if args.splits:
            res[f"{name}_splits"] = split_walls(torch, aqp_query, fn)
            res[f"{name}_device"] = device_kernels(torch, fn)
    if "e" in paths:
        res.update(path_e_section(torch, cs, ops, e_run, args.reps))
        res["clocks_sm"].append(smi("clocks.sm"))
    res["ptxas_registers"] = ptxas_registers(_build)
    if args.sass:
        res["sass_loops"] = sass_loops(_build.BUILD_DIR)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        raise SystemExit(f"--paths takes {','.join(PATHS)}")

    import torch
    if not torch.cuda.is_available():
        print("bench_aqp_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        root = variant_root(args.root, args.set, Path(tmp)) if args.set else args.root
        print(json.dumps(run(args, root, paths)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
