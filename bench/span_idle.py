"""The card's idle time put down to the program's spans, in a traced run's
profiled part.

While a `torch.profiler` records, every `repro_torch.obs.span` opens a
profiler range of its name (an op-level CPU event, not a user annotation),
on the same clock as the card's kernels.  `idle_by_span` sweeps the profiled window once: every
nanosecond in which no operation runs on the card, inside the harness's
`bench.ingest` / `bench.execute` ranges, goes to the innermost program span
open at that moment (the latest-starting one of those open), or to
`UNATTRIBUTED` where none is.  `LAYERS` sums those spans into the program's
layers, and its names are how the program's ranges are told from the
host's operators.

The benchmark's reduction (`bench/trace.py`) does not call this yet; run
as a module, this file runs one traced cell through the harness (watching
its profiler window, refreshes and readers from outside) and prints
the split (ms of idle card a refresh of the profiled part, by layer and by
span), beside the counts of the part with the spans on:

    python3 -m bench.span_idle --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a machine with the card.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Iterable, Tuple  # noqa: E402

from bench.trace import _merge  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

SCOPES = ("bench.ingest", "bench.execute")
UNATTRIBUTED = "unattributed"

# layer -> the program spans whose idle it holds (the innermost span decides)
LAYERS = {
    "ingest": ("store.add_batch",),
    "engine": ("engine.compile", "engine.run_compiled", "engine.plan"),
    "fit": ("synopsis.fit",),
    "nm_eval": ("nm.eval",),
    "answer": ("engine.kernel", "engine.ci", "qmc.plan", "synopsis.eval"),
    "unattributed": (UNATTRIBUTED,),
}

SPANS = frozenset(n for names in LAYERS.values() for n in names) - {UNATTRIBUTED}

Event = Tuple[str, int, int]     # (name, start_ns, end_ns)


def idle_by_span(device_events: Iterable[Event], annotations: Iterable[Event],
                 t0_ns: int, t1_ns: int) -> Dict[str, float]:
    """Idle seconds of the card in [t0_ns, t1_ns] inside the `SCOPES`
    ranges, by the innermost program span open at each moment.
    device_events: every operation on the card; annotations: the host
    thread's ranges, the harness's `bench.*` ones and the program's spans
    (any name not starting `bench.` counts as a span).  The values add up
    to the idle time inside the scopes."""
    busy = _merge((max(s, t0_ns), min(e, t1_ns)) for _, s, e in device_events
                  if e > t0_ns and s < t1_ns)
    scope = _merge((max(s, t0_ns), min(e, t1_ns)) for n, s, e in annotations
                   if n in SCOPES and e > t0_ns and s < t1_ns)
    # in start order, an enclosing span before a nested one that starts with it
    spans = sorted(((s, e, n) for n, s, e in annotations if not n.startswith("bench.")),
                   key=lambda t: (t[0], -t[1]))
    # boundaries: span opens and closes, scope and busy edges
    marks = sorted({t for s, e, _ in spans for t in (s, e)}
                   | {t for iv in scope + busy for t in iv})
    opens = sorted((s, i) for i, (s, _, _) in enumerate(spans))
    closes = sorted((e, i) for i, (_, e, _) in enumerate(spans))
    out: Dict[str, float] = {}
    live: Dict[int, None] = {}       # open spans by index, in start order
    io = ic = isc = ib = 0
    for a, b in zip(marks, marks[1:]):
        while ic < len(closes) and closes[ic][0] <= a:
            live.pop(closes[ic][1], None)
            ic += 1
        while io < len(opens) and opens[io][0] <= a:
            if spans[opens[io][1]][1] > a:
                live[opens[io][1]] = None
            io += 1
        while isc < len(scope) and scope[isc][1] <= a:
            isc += 1
        while ib < len(busy) and busy[ib][1] <= a:
            ib += 1
        in_scope = isc < len(scope) and scope[isc][0] <= a
        idle = not (ib < len(busy) and busy[ib][0] <= a)
        if in_scope and idle:
            name = spans[max(live)][2] if live else UNATTRIBUTED
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def by_layer(idle: Dict[str, float]) -> Dict[str, float]:
    """`idle_by_span`'s seconds summed into `LAYERS` (a span no layer
    names keeps its own name)."""
    owner = {span: layer for layer, names in LAYERS.items() for span in names}
    out: Dict[str, float] = {}
    for name, s in idle.items():
        key = owner.get(name, name)
        out[key] = out.get(key, 0.0) + s
    return out


def from_profiler(prof, t0_ns: int, t1_ns: int) -> Dict[str, float]:
    """`idle_by_span` of a stopped `torch.profiler.profile`, read from its
    kineto result: the card's operations (its mirrors of the host's ranges
    are no device work), and the harness's `SCOPES` ranges and the
    program's ranges (CPU events named in `LAYERS`) of the thread that
    opened the scopes."""
    device, notes = [], []
    for ev in prof.profiler.kineto_results.events():
        kind, name = str(ev.device_type()), ev.name()
        item = (name, ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if "CUDA" in kind:
            if not (name.startswith("bench.") or name in SPANS or ev.is_user_annotation()):
                device.append(item)
        elif "CPU" in kind and (name in SPANS or name in SCOPES):
            notes.append((item, ev.start_thread_id()))
    threads = {tid for (name, _, _), tid in notes if name in SCOPES}
    return idle_by_span(device, [item for item, tid in notes if tid in threads], t0_ns, t1_ns)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[:0] = [str(ROOT / "src")]
    from bench import harness
    from bench import trace as btrace

    # the harness's own traced run, watched from outside: its refreshes, the
    # Run its readers see, and the split of its profiled window
    seen: dict = {"refreshes": [], "idle": None, "run": None}
    reduce_window, make_refresh, load_reader = (btrace.from_profiler, harness.Refresh,
                                                harness.load_reader)

    def window(prof, t0_ns, t1_ns):
        seen["idle"] = from_profiler(prof, t0_ns, t1_ns)
        return reduce_window(prof, t0_ns, t1_ns)

    def refresh(*a, **k):
        seen["refreshes"].append(make_refresh(*a, **k))
        return seen["refreshes"][-1]

    def reader(name, root=harness.ROOT):
        read = load_reader(name, root)

        def keep(run):
            seen["run"] = run
            return read(run)
        return keep

    btrace.from_profiler, harness.Refresh, harness.load_reader = window, refresh, reader
    try:
        cell = harness.load_cell(args.workload)
        result = harness.run_cell(cell, args.seed, args.seconds, True, t_start=T_START,
                                  log=lambda m: print(f"[span_idle] {m}", file=sys.stderr))
    finally:
        btrace.from_profiler, harness.Refresh, harness.load_reader = (
            reduce_window, make_refresh, load_reader)
    # a harness that no longer calls what is watched above would leave the
    # split empty and read as no idle time: refuse to print it
    for what in ("idle", "run"):
        if seen[what] is None:
            raise RuntimeError(f"the traced run never reached the watched {what!r} step; "
                               "bench/harness.py or bench/trace.py changed under this tool")
    run, recs = seen["run"], seen["refreshes"]
    plain, n_span, n_dev = len(run.refreshes), run.span_refreshes, run.device_refreshes
    parts = {"plain": recs[:plain], "spans": recs[plain:plain + n_span],
             "device": recs[plain + n_span:plain + n_span + n_dev]}
    idle = seen["idle"]
    per = 1e3 / max(n_dev, 1)
    out = {
        "workload": args.workload, "seed": args.seed, "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "refresh_ms_by_part": {k: (sum(r.t2 - r.t0 for r in v) / len(v) * 1e3 if v else None)
                               for k, v in parts.items()},
        "refreshes_by_part": {k: len(v) for k, v in parts.items()},
        "idle_ms_by_layer": {k: v * per for k, v in sorted(by_layer(idle).items())},
        "idle_ms_by_span": {k: v * per for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "idle_ms_in_scopes": sum(idle.values()) * per,
        "span_counts_a_refresh": {n: sum(s["name"] == n for s in run.spans) / max(n_span, 1)
                                  for n in sorted({s["name"] for s in run.spans})},
        "breakdown": result.get("breakdown"),
        "device": result["device"],
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
