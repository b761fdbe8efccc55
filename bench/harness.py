"""One run of one benchmark cell, driven by the entries of `BENCHMARK.json`.

A cell names a configuration (`bench/configs/<config>.json`: the store's
data and sizes), a traffic mix (`bench/traffic/<mix>.json`: the refresh
loop) and, through the metric entries, readers (`bench/metrics/<metric>.py`,
each a `read(run)` returning a number or None).  Its limits are
`bench/limits/<cell>.json`.  Adding a cell, a mix or a metric adds files;
nothing here names one.

The timed path is one *refresh*, back to back for the window:
`TelemetryStore.add_batch(batch)` (the reservoirs move) then
`QueryEngine.execute(dashboard)` on the engine of the mix's selector, which
refits every moved synopsis lazily and answers.  After the window the
program is freed and its outputs are held to `bench/reference.py`
(`bench/check.py`), with box answers from the integrator that the
configuration's `box_estimator` names (`box_integrator`), and read beside
the check against the stream's exact answers (`stream_errors`).
"""
from __future__ import annotations

import contextlib
import functools
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from bench import check, reference, streams
from bench import trace as btrace

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def load_cell(workload: str, root: Path = ROOT, config: Optional[str] = None,
              traffic: Optional[str] = None, like: Optional[str] = None) -> Cell:
    """The cell `workload` of BENCHMARK.json.  With `like`, a cell that the
    file does not list: `config` (`bench/configs/<config>.json`) under the
    mix `traffic`, with the chips, limits and metrics of the listed cell
    `like` (for readings of a configuration kept out of the benchmark)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    listed = like or workload
    cell = next((w for w in bench["workloads"] if w["name"] == listed), None)
    if cell is None:
        raise KeyError(f"no workload {listed!r} in BENCHMARK.json")
    if like is not None:
        cell = dict(cell, name=workload, config=config or cell["config"],
                    traffic=traffic or cell["traffic"])
    entry = next((c for c in bench["configs"] if c["name"] == cell["config"]), None)
    path = root / entry["file"] if entry else root / "bench" / "configs" / f"{cell['config']}.json"
    config = json.loads(path.read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "bench" / "limits" / f"{listed}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if listed in m.get("workloads", [listed])]

    return Cell(name=workload, chips=int(cell["chips"]), config=config, traffic=traffic,
                limits=limits, end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]), root=root)


def load_reader(name: str, root: Path = ROOT) -> Callable:
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + "".join(c if c.isalnum() else "_" for c in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package `repro`, compared whole (`repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Refresh:
    k: int                         # index into the stream's refresh batches
    t0: float                      # add_batch called
    t1: float                      # add_batch returned, execute called
    t2: float                      # execute returned
    answers: Optional[np.ndarray]  # (q, 3): estimate, ci_lo, ci_hi
    error: Optional[str]
    bandwidths: Dict[str, object]
    digests: Dict[str, int]


@dataclass
class Run:
    """What a metric reader sees.  An untraced run's window is one part; a
    traced run's is cut in three (`TRACED_PARTS`): refreshes with nothing
    switched on (`refreshes`, `launches`), then the program's spans on
    (`spans`), then the profiler on (`device`), so that neither the spans'
    fences nor the profiler's host activity reach the other parts."""
    cell: Cell
    setup_s: float
    window_s: float
    refreshes: List[Refresh]      # the untraced part's (an untraced run: all)
    launches: Dict[str, int] = field(default_factory=dict)   # over `refreshes`
    spans: List[dict] = field(default_factory=list)          # program spans
    span_refreshes: int = 0
    device: Optional[btrace.DeviceWindow] = None
    device_refreshes: int = 0


# A traced run's window: (part, share of --seconds), in order.
TRACED_PARTS = (("plain", 0.25), ("spans", 0.25), ("device", 0.5))


def _key_name(key) -> str:
    return key if isinstance(key, str) else "|".join(key)


def fit_keys(rows) -> list:
    """The synopses the dashboard fits: a column per Range spec, a column
    tuple per Box spec (Eq specs answer from the sketch)."""
    keys = []
    for r in rows:
        key = r.columns[0] if r.kind == "range" else (tuple(r.columns) if r.kind == "box"
                                                      else None)
        if key is not None and key not in keys:
            keys.append(key)
    return keys


def _capture(store, keys, selector, backend) -> tuple:
    """(bandwidths, reservoir digests) of the store after a refresh."""
    bw = {}
    for key in keys:
        res = store.joints[key] if isinstance(key, tuple) else store.columns[key]
        syn = store.cache.peek(key, selector, res.version, backend=backend)
        if syn is None:
            bw[_key_name(key)] = None
        elif syn.H is not None:
            bw[_key_name(key)] = syn.H.detach().cpu().double().numpy()
        else:
            bw[_key_name(key)] = float(syn.h)
    dig = {c: zlib.crc32(r.buf[: r.n_filled]) for c, r in store.columns.items()}
    dig.update({_key_name(j): zlib.crc32(r.buf[: r.n_filled]) for j, r in store.joints.items()})
    return bw, dig


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, t_start: Optional[float] = None,
             log: Callable[[str], None] = lambda s: None) -> dict:
    """Set up, measure for `seconds`, check; the result's fields as the
    contract names them.  `device="cpu"` runs the program's plain path (for
    tests); `control=True` puts the reference in TF32 in the program's place
    for the checked refreshes."""
    import torch

    from repro_torch import obs
    from repro_torch.core import aqp_query as q
    from repro_torch.data.aqp_store import TelemetryStore
    from repro_torch.kernels import ops

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, tr = cell.config, cell.traffic
    box_integrator(cfg)            # an unknown estimator fails before set-up
    backend = "cuda" if device == "cuda" else "torch"
    selector = tr["selector"]
    stream = streams.make_stream(seed, cfg, tr)
    rows = streams.make_dashboard(seed, cfg, tr, stream.probe)
    specs = streams.to_aqp(rows, q)
    keys = fit_keys(rows)
    joints = [tuple(j) for j in cfg.get("joints", [])]
    dictionary = streams.dictionary_columns(cfg)

    store = TelemetryStore(capacity=int(cfg["capacity"]), seed=seed, device=device)
    for col in dictionary:
        store.track_categorical(col)
    for j in joints:
        store.track_joint(j)
    for batch in stream.setup:
        store.add_batch(batch)
    engine = store.engine(selector=selector, backend=backend, n_qmc=int(cfg["n_qmc"]),
                          ci_level=float(cfg["ci_level"]),
                          kde_backend=tr.get("kde_backend", "auto"))
    # warm-up: one refresh of the cell's own shapes (builds and loads the
    # kernels on a first run)
    store.add_batch(stream.refresh_batch(0))
    engine.execute(specs)
    if device == "cuda":
        torch.cuda.synchronize()

    records: List[Refresh] = []
    nxt = [1]                      # the next refresh batch

    def drive(part_s: float, label=contextlib.nullcontext) -> List[Refresh]:
        """Refreshes back to back until `part_s` has passed (at least one)."""
        first, start = len(records), time.perf_counter()
        while True:
            batch = stream.refresh_batch(nxt[0])
            t0 = time.perf_counter()
            with label("bench.ingest"):
                store.add_batch(batch)
            t1 = time.perf_counter()
            answers, error = None, None
            with label("bench.execute"):
                try:
                    res = engine.execute(specs)
                    answers = np.asarray([(r.estimate, r.ci_lo, r.ci_hi) for r in res],
                                         np.float64)
                except Exception as exc:   # an answer that raises counts as failed
                    error = f"{type(exc).__name__}: {exc}"
            t2 = time.perf_counter()
            with label("bench.capture"):
                bw, dig = _capture(store, keys, selector, backend)
            records.append(Refresh(nxt[0], t0, t1, t2, answers, error, bw, dig))
            nxt[0] += 1
            if t2 - start >= part_s:
                return records[first:]

    spans: List[dict] = []
    span_recs: List[Refresh] = []
    dev_recs: List[Refresh] = []
    win = None
    gc.collect()
    ops.reset_launch_counts()
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    shares = dict(TRACED_PARTS) if trace else {"plain": 1.0}
    plain = drive(shares["plain"] * seconds)
    launches = ops.launch_counts()
    if trace:
        obs.set_tracer(obs.Tracer(capacity=1 << 20))
        obs.enable()
        s0 = time.perf_counter()
        span_recs = drive(shares["spans"] * seconds)
        obs.disable()
        spans = [s.as_dict() for s in obs.get_tracer().spans() if s.t0 >= s0]
        if device == "cuda":
            from torch.profiler import ProfilerActivity, profile, record_function
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            with record_function("bench.window"):
                dev_recs = drive(shares["device"] * seconds, label=record_function)
            prof.stop()
            win = _device_window(prof)
            del prof
        else:
            dev_recs = drive(shares["device"] * seconds)
    window_s = records[-1].t2 - w0
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    log(f"window {window_s:.3f} s, {len(records)} refreshes")

    n_q = len(specs)
    attempted = n_q * len(records)
    failed = sum(n_q if r.answers is None else int(np.sum(~np.isfinite(r.answers).all(axis=1)))
                 for r in records)
    del engine, store
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    run = Run(cell=cell, setup_s=setup_s, window_s=window_s, refreshes=plain,
              launches=launches, spans=spans, span_refreshes=len(span_recs), device=win,
              device_refreshes=len(dev_recs))
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = load_reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_ref = time.perf_counter()
    readings, own = hold_to_reference(seed, cell, stream, rows, records, device=device,
                                      control=control, log=log)
    log(f"reference {time.perf_counter() - t_ref:.1f} s")
    t_ref = time.perf_counter()
    own.update(stream_errors(stream, rows, records, device))
    log(f"stream's exact answers {time.perf_counter() - t_ref:.1f} s")
    correct, checks = check.verdict(readings, cell.limits)
    result = {"correct": bool(correct and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics}
    if device == "cuda":
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": 1, "memory_peak_bytes": int(memory_peak)}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if win is not None:
        result["device"]["busy_s"] = win.busy_s
        result["device"]["window_s"] = win.window_s
        result["breakdown"] = btrace.breakdown(win)
    result["not_compared"] = own
    result["checks"] = checks
    return result


def _device_window(prof) -> btrace.DeviceWindow:
    """The traced window: the host's `bench.window` annotation."""
    ev = next(ev for ev in prof.profiler.kineto_results.events()
              if ev.name() == "bench.window" and "CPU" in str(ev.device_type()))
    return btrace.from_profiler(prof, ev.start_ns(), ev.start_ns() + ev.duration_ns())


def power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


# --- the check ----------------------------------------------------------------

def stream_errors(stream, rows, records: List[Refresh], device: str = "cpu") -> dict:
    """The program's answers of every refresh of the window against the
    stream's exact answers over the rows ingested up to it (a reading
    beside the check, not compared): `stream_err.median` and
    `stream_err.max` of |estimate - exact| / |exact| over the answers
    whose exact value is not 0."""
    done = [r for r in records if r.answers is not None]
    if not done:
        return {}
    exact = reference.stream_answers(stream.setup, stream.pool, rows, [r.k for r in done],
                                     device=device)
    return check.stream_errors(np.stack([r.answers[:, 0] for r in done]), exact)


def checked_refreshes(seed: int, n_done: int, n_check: int) -> List[int]:
    """Positions in the window's refreshes whose fits and answers the
    reference checks, drawn from the seed among those completed."""
    rng = np.random.default_rng([seed, 2])
    return sorted(rng.choice(n_done, size=min(n_check, n_done), replace=False).tolist())


def hold_to_reference(seed: int, cell: Cell, stream, rows, records: List[Refresh],
                      device: str = "cpu", control: bool = False,
                      log: Callable[[str], None] = lambda s: None) -> tuple:
    """(compared, not compared) numbers of a run (`bench/check.py`): every
    refresh's reservoirs against the reference's replay of the stream, then
    the fits and answers of the checked refreshes.  The answers are compared
    at the program's bandwidth where its fit's check accepts it; the same
    errors against the reference's answers at its own bandwidth
    (`answer_err.own_bw`, `ci_err.own_bw`) are reported, not compared.  With
    `control`, the reference in TF32 stands in for the program's fits and
    answers."""
    cfg, tr = cell.config, cell.traffic
    joints = [tuple(j) for j in cfg.get("joints", [])]
    ing = reference.Ingest(int(cfg["capacity"]), seed, streams.ingest_columns(cfg, tr),
                           joints, streams.dictionary_columns(cfg))
    for batch in stream.setup:
        ing.add(batch)
    ing.add(stream.refresh_batch(0))
    picks = set(checked_refreshes(seed, len(records), int(tr["check_refreshes"])))
    mismatch = 0
    states = {}
    for pos, rec in enumerate(records):
        ing.add(stream.refresh_batch(rec.k))
        ref_dig = ing.digests()
        mismatch += sum(ref_dig[key] != rec.digests.get(key) for key in ref_dig)
        if pos in picks:
            states[pos] = ({c: r.sample().copy() for c, r in ing.columns.items()},
                           {"|".join(j): r.sample().copy() for j, r in ing.joints.items()},
                           {c: r.n_seen for c, r in ing.columns.items()},
                           {"|".join(j): r.n_seen for j, r in ing.joints.items()},
                           {c: dict(t) for c, t in ing.codes.items()})
    readings = {"reservoir_mismatch": float(mismatch)}
    h_gaps, H_short, ans_err, ci_err, own_ans, own_ci = [], [], [], [], [], []
    for pos in sorted(states):
        cols, jnts, seen, jseen, codes = states[pos]
        rec = records[pos]
        judged = None if rec.answers is None else rec.answers.copy()
        ref_rows = [None] * len(rows)
        own_rows = [None] * len(rows)
        for key in fit_keys(rows):
            name = _key_name(key)
            idx = [i for i, r in enumerate(rows) if r.kind != "eq"
                   and (r.columns[0] if r.kind == "range" else tuple(r.columns)) == key]
            sel = [rows[i] for i in idx]
            bw = rec.bandwidths.get(name)
            if isinstance(key, str):
                reading, want, got, own = _check_lscv_h(cell, cols[key], seen[key], sel, bw,
                                                        control, device)
                h_gaps.append(reading)
            else:
                reading, want, got, own = _check_lscv_H(cell, jnts[name], jseen[name], sel,
                                                        bw, control, device, log)
                H_short.append(reading)
            for j, i in enumerate(idx):
                ref_rows[i] = None if want is None else want[j]
                own_rows[i] = None if own is None else own[j]
                if control and judged is not None and got is not None:
                    judged[i] = got[j]
        for i, r in enumerate(rows):
            if r.kind == "eq":
                ref_rows[i] = own_rows[i] = reference.eq_answers(codes[r.columns[0]], [r])[0]
        if judged is None or any(r is None for r in ref_rows):
            ans_err.append(math.inf)
            continue
        errs = check.answer_errors(judged, ref_rows)
        ans_err.append(errs["answer_err"])
        ci_err.append(errs["ci_err"])
        if all(r is not None for r in own_rows):
            errs = check.answer_errors(judged, own_rows)
            own_ans.append(errs["answer_err"])
            own_ci.append(errs["ci_err"])
    if h_gaps:
        readings["h_gap"] = check.worst(h_gaps)
    if H_short:
        readings["H_shortfall"] = check.worst(H_short)
    readings["answer_err"] = check.worst(ans_err)
    readings["ci_err"] = check.worst(ci_err)
    own = {"answer_err.own_bw": check.worst(own_ans), "ci_err.own_bw": check.worst(own_ci)}
    return readings, own


# Each check of a fit returns (reading, the reference's answers of its specs,
# the control's answers or None, the reference's answers at its own
# bandwidth).  The answers are judged at the program's bandwidth where the
# fit's check accepts it, else at the reference's own.

def _check_lscv_h(cell: Cell, x, n_seen: int, specs, bw, control: bool, device: str):
    cfg = cell.config
    if control:
        grid, g_tf, _ = reference.lscv_h_curve(x, int(cfg["n_h"]), prec="tf32", device=device)
        bw = float(np.float32(grid[int(np.argmin(g_tf))]))
    if bw is None:
        return math.inf, None, None, None
    grid, g, g_at = reference.lscv_h_curve(x, int(cfg["n_h"]), extra_h=[bw], device=device)
    g_min = float(np.min(g))
    gap = (float(g_at[0]) - g_min) / abs(g_min)
    h_ref = float(grid[int(np.argmin(g))])
    accepted = bw if gap <= float(cell.limits["h_gap"]) else h_ref
    args = (specs, n_seen, float(cfg["ci_level"]))
    want = reference.range_answers(x, accepted, *args, device=device)
    own = want if accepted == h_ref else reference.range_answers(x, h_ref, *args, device=device)
    got = reference.range_answers(x, bw, *args, prec="tf32", device=device) if control else None
    return gap, want, got, own


def box_integrator(config: dict) -> Callable:
    """The reference's integrator of full-H boxes that the configuration
    names by `box_estimator`, called `answer(x, H, specs, n_source,
    prec=..., device=...)`: "hull_qmc" (the default where the key is
    absent) is `reference.qmc_box_answers` with `n_qmc` nodes over the
    boxes' hull, "kernel_qmc" `reference.kernel_box_answers` with
    `box_draws` draws a sample row.  Both take `qmc_subsamples` row chunks
    for the CI.  Any other name raises."""
    name = config.get("box_estimator", "hull_qmc")
    ci = {"k_sub": int(config["qmc_subsamples"]), "ci_level": float(config["ci_level"])}
    if name == "hull_qmc":
        return functools.partial(reference.qmc_box_answers, n_qmc=int(config["n_qmc"]), **ci)
    if name == "kernel_qmc":
        return functools.partial(reference.kernel_box_answers,
                                 draws=int(config["box_draws"]), **ci)
    raise ValueError(f"unknown box_estimator {name!r}: hull_qmc or kernel_qmc")


def _check_lscv_H(cell: Cell, x, n_seen: int, specs, bw, control: bool, device: str,
                  log: Callable[[str], None]):
    cfg = cell.config
    answer = box_integrator(cfg)
    if control:
        bw = reference.lscv_H_fit(x, int(cfg["nm_max_iter"]), prec="tf32", device=device)[0]
    if bw is None:
        return math.inf, None, None, None
    bw = np.asarray(bw, np.float64)
    H_ref, g_ref, g_start, _h0, _nfev = reference.lscv_H_fit(x, int(cfg["nm_max_iter"]),
                                                            device=device)
    g_prog = reference.g_of_H_rows(x, bw, device=device)
    shortfall = (g_prog - g_ref) / (g_start - g_ref)
    log(f"LSCV_H: g(H) {g_prog!r}, g(H_ref) {g_ref!r}, g(H_start) {g_start!r}, "
        f"|H - H_ref| / |H_ref| {np.linalg.norm(bw - H_ref) / np.linalg.norm(H_ref)!r}")
    ok = shortfall <= float(cell.limits["H_shortfall"])
    want = answer(x, bw if ok else H_ref, specs, n_seen, device=device)
    own = answer(x, H_ref, specs, n_seen, device=device) if ok else want
    got = answer(x, bw, specs, n_seen, prec="tf32", device=device) if control else None
    return shortfall, want, got, own
