"""Serving entry points of the port (counterpart: `repro/launch/serve.py`).

AQP mode (the default here; the reference defaults to LM mode):
a long-lived admission loop over a `TelemetryStore`: concurrent query
clients submit heterogeneous AqpQuery specs (1-D ranges, multi-column box
predicates of eq. 11, categorical equality on a dictionary column) into one
`AqpSession` while a producer keeps streaming telemetry batches into the
store, bumping synopsis versions mid-flight.  The session coalesces specs
across clients into micro-batches keyed by (column tuple, selector, tier,
synopsis version) and flushes them on a batch-size watermark or a max-delay
deadline; the summary reports queries per second, queue depth, flush
reasons, per-flush batch sizes and version invalidations.

    python -m repro_torch.launch.serve --mode aqp \\
        --rows 200000 --clients 8 --per-client 150 --max-delay-ms 5

It runs on the CUDA device, on the hand-written kernels (`--backend cuda`),
and raises without one unless `--device cpu` asks for the plain PyTorch
path on the CPU.  `--stream-every-ms 100000` keeps the producer quiet, so
the printed answers repeat bit for bit run to run.

Observability: `--metrics-out FILE` enables `repro_torch.obs` (span
tracing, fenced per-path latency histograms, kernel profiling), exports a
merged JSON snapshot of the store and kernel registries every
`--metrics-every` seconds (atomic replace; `scripts/validate_metrics.py`
checks it) and prints an end-of-run summary table; `--trace-out FILE`
appends the span ring as JSON lines on exit.

The loop is restartable: `--snapshot-dir DIR` writes an atomic keep-3
store snapshot (reservoirs and their RNG states, sketches, fitted
synopses, plans, metrics) at start-up and every `--snapshot-every`
streamed batches, and `--restore` warm-starts from the latest one instead
of seeding a new store: no refit, and the exact categorical path stays on.

    python -m repro_torch.launch.serve --mode aqp --snapshot-dir /tmp/aqp-snap
    python -m repro_torch.launch.serve --mode aqp --snapshot-dir /tmp/aqp-snap --restore

`--tuning-cache FILE` loads (and persists sweeps to) a tile cache of
`repro_torch.kernels.autotune`, e.g. one written by
`python -m repro_torch.launch.autotune --cache FILE`.

LM mode: random weights (seed 0) for one architecture's published config
(or its smoke config, `--smoke`), `--batch` random prompts of
`--prompt-len` tokens (seed 1), prefill and `--max-new` greedy decode steps,
twice; it prints the warm run's tokens/s and the card's name and power
limit.  Like AQP mode it runs on the CUDA device and raises without one
unless `--device cpu` asks for the CPU.

    python -m repro_torch.launch.serve --mode lm --arch llama3.2-1b \
        --batch 4 --prompt-len 128 --max-new 32
    python -m repro_torch.launch.serve --mode lm --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time

RESULT_TIMEOUT = 600.0     # seconds a client waits for one answer before the run fails


def make_query_mix(n_queries: int, ranges, seed: int = 0):
    """Deterministic mixed COUNT/SUM/AVG batch of legacy `Query`s.  `ranges`
    maps column name (or None for a single-synopsis batch) -> (lo, hi)
    sampling range."""
    import numpy as np

    from repro_torch.core.aqp import Query

    rng = np.random.default_rng(seed)
    columns = list(ranges)
    ops = ["count", "sum", "avg"]
    queries = []
    for i in range(n_queries):
        col = columns[i % len(columns)]
        lo, hi = ranges[col]
        a = float(rng.uniform(lo, hi))
        b = float(rng.uniform(a, hi))
        # an independent draw, not i % 3: cycling op and column together
        # would make every column's queries one op when len(ranges) % 3 == 0
        queries.append(Query(ops[int(rng.integers(3))], a, b, column=col))
    return queries


def make_box_query_mix(n_queries: int, columns, ranges, seed: int = 0):
    """Deterministic mixed COUNT/SUM/AVG batch of legacy `BoxQuery`s over
    one column tuple.  `ranges` maps each column -> (lo, hi) sampling range;
    SUM/AVG target a random axis."""
    import numpy as np

    from repro_torch.core.aqp_multid import BoxQuery

    rng = np.random.default_rng(seed)
    columns = tuple(columns)
    ops = ["count", "sum", "avg"]
    queries = []
    for _ in range(n_queries):
        lo, hi = [], []
        for col in columns:
            c_lo, c_hi = ranges[col]
            a = float(rng.uniform(c_lo, c_hi))
            lo.append(a)
            hi.append(float(rng.uniform(a, c_hi)))
        op = ops[int(rng.integers(3))]
        target = columns[int(rng.integers(len(columns)))] if op != "count" else None
        queries.append(BoxQuery(op, tuple(lo), tuple(hi), columns=columns,
                                target=target))
    return queries


def make_mixed_aqp_queries(n_queries: int, ranges, joint_cols, cat_col,
                           cat_values, n_boxes: int = None, seed: int = 0,
                           fullh_frac: float = 0.0):
    """Deterministic heterogeneous AqpQuery batch: 1-D ranges over every
    numeric column, eq. 11 boxes over `joint_cols`, and categorical Eq terms
    on `cat_col`.  `fullh_frac` of the boxes carry a per-query
    selector="lscv_H" override, routing them through the full-H QMC path
    and the engine's density backend."""
    import numpy as np

    from repro_torch.core.aqp_query import AqpQuery, Box, Eq, Range

    rng = np.random.default_rng(seed)
    columns = [c for c in ranges if c not in (cat_col,)]
    ops = ["count", "sum", "avg"]
    if n_boxes is None:
        n_boxes = n_queries // 4
    n_eq = n_queries // 8 if cat_col is not None else 0
    queries = []
    for i in range(n_queries):
        op = ops[int(rng.integers(3))]
        if i % 4 == 1 and n_boxes > 0:
            n_boxes -= 1
            lo, hi = [], []
            for col in joint_cols:
                c_lo, c_hi = ranges[col]
                a = float(rng.uniform(c_lo, c_hi))
                lo.append(a)
                hi.append(float(rng.uniform(a, c_hi)))
            tgt = joint_cols[int(rng.integers(len(joint_cols)))]
            queries.append(AqpQuery(
                op, (Box(tuple(joint_cols), tuple(lo), tuple(hi)),),
                target=None if op == "count" else tgt,
                selector="lscv_H" if rng.random() < fullh_frac else None))
        elif i % 8 == 3 and n_eq > 0:
            n_eq -= 1
            queries.append(AqpQuery(
                "count", (Eq(cat_col, float(rng.choice(cat_values))),)))
        else:
            col = columns[i % len(columns)]
            lo, hi = ranges[col]
            a = float(rng.uniform(lo, hi))
            queries.append(AqpQuery(
                op, (Range(col, a, float(rng.uniform(a, hi))),),
                target=None if op == "count" else col))
    return queries


def _make_telemetry(rng, n):
    import numpy as np

    return {
        "loss": rng.gamma(3.0, 0.7, n).astype(np.float32),
        "latency_ms": np.where(rng.random(n) < 0.8, rng.normal(40, 8, n),
                               rng.normal(160, 30, n)).astype(np.float32),
        "seq_len": rng.integers(16, 2048, n).astype(np.float32),
        # dictionary-coded categorical column (which model variant served
        # the request): unit-spaced codes, served by Eq terms
        "model_id": rng.integers(0, 4, n).astype(np.float32),
    }


def _print_metrics_summary(store) -> None:
    """End-of-run metrics table: latency histograms, caches, ingest."""
    from repro_torch import obs

    rows = []
    for labels, h in store.metrics.collect_histograms("aqp.query.latency_us"):
        tag = labels.get("path", "?")
        if labels.get("tier") not in (None, "None"):
            tag += f"@t{labels['tier']}"
        rows.append((tag, h.summary()))
    for labels, h in obs.get_registry().collect_histograms("kernel.wall_us"):
        rows.append((f"kernel:{labels.get('kernel', '?')}", h.summary()))
    if rows:
        print(f"[serve:aqp] {'metric':<28s} {'count':>7s} {'p50us':>9s} "
              f"{'p95us':>9s} {'p99us':>9s} {'maxus':>9s}")
        for tag, s in sorted(rows, key=lambda r: -r[1]["count"]):
            print(f"[serve:aqp] {tag:<28s} {s['count']:>7d} {s['p50']:>9.1f} "
                  f"{s['p95']:>9.1f} {s['p99']:>9.1f} {s['max']:>9.1f}")
    hits = store.metrics.sum_counter("aqp.cache.hits")
    misses = store.metrics.sum_counter("aqp.cache.misses")
    phits = store.metrics.sum_counter("aqp.plan.hits")
    pmisses = store.metrics.sum_counter("aqp.plan.misses")
    print(f"[serve:aqp] metrics: synopsis cache hit rate "
          f"{hits / max(1, hits + misses):.1%}, plan cache hit rate "
          f"{phits / max(1, phits + pmisses):.1%}, ingested "
          f"{store.metrics.sum_counter('aqp.ingest.batches')} batches")


def run_aqp(args) -> dict:
    """The admission loop; prints the reference's `[serve:aqp]` lines and
    returns the run's summary (queries/s, flushes, invalidations)."""
    import threading
    from collections import Counter

    import numpy as np

    from repro_torch import obs
    from repro_torch.core.aqp_query import AqpQuery, Range
    from repro_torch.data.aqp_store import TelemetryStore
    from repro_torch.device import resolve_backend, resolve_device
    from repro_torch.kernels import autotune

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"[serve:aqp] {err} (--device cpu)") from err
    backend = resolve_backend(args.backend, device)
    if args.metrics_out or args.trace_out:
        # spans, fenced latency histograms and kernel profiling for this run
        obs.enable()
    if args.tuning_cache:
        autotune.use_cache(args.tuning_cache)

    rng = np.random.default_rng(0)
    n = args.rows
    joint_cols = ("loss", "latency_ms")
    restored_step = None
    if args.restore:
        if not args.snapshot_dir:
            raise SystemExit("--restore needs --snapshot-dir")
        from repro_torch.checkpoint import CheckpointManager
        restored_step = CheckpointManager(args.snapshot_dir,
                                          async_save=False).latest_step()
        if restored_step is None:
            raise SystemExit(f"--restore: no completed snapshots under "
                             f"{args.snapshot_dir!r}")
        # warm start: reservoirs, sketches (exact coverage intact), joint
        # registrations and fitted synopses all come back from the snapshot
        store = TelemetryStore.load(args.snapshot_dir, device=device)
        n = max(res.n_seen for res in store.columns.values())
    else:
        telemetry = _make_telemetry(rng, n)
        store = TelemetryStore(capacity=args.capacity, seed=0, device=device)
        # tiered ladders (before add_batch, like joints): tier 0 serves the
        # "coarse" priority class, the top tier is the full sample
        store.track_tiered("loss", n_tiers=4)
        store.track_tiered("latency_ms", n_tiers=4)
        store.track_tiered(joint_cols, n_tiers=4)   # joints sample whole rows
        store.track_categorical("model_id")  # exact per-code counts for Eq terms
        store.add_batch(telemetry)
        # registering after add_batch backfills from the per-column reservoirs
        store.track_joint(("model_id", "latency_ms"))
    # query-mix sampling ranges come from the reservoir samples (not the raw
    # stream) on both paths, so a restarted process regenerates the same
    # client query stream as the run that wrote the snapshot
    ranges = {c: (float(s.min()), float(s.max()))
              for c, s in ((c, store.columns[c].sample())
                           for c in store.columns if c != "model_id")}
    engine = store.engine(selector=args.selector, backend=backend)
    # the engine's density backend of full-H queries: "exact", the
    # sublinear "rff" synopsis, or "auto" by fitted-sample size
    engine.kde_backend = args.kde_backend

    # Closed-loop clients hold one outstanding query each, so a bucket can
    # never exceed the client count: a deeper watermark would leave every
    # flush to the deadline and cap throughput at clients / max_delay.
    watermark = args.watermark if args.watermark is not None \
        else max(2, args.clients)

    # Warm-up fits the synopses (cache misses) and runs the batched passes,
    # so the timed loop measures steady state.
    warm = make_mixed_aqp_queries(
        max(watermark, 64), ranges, joint_cols, "model_id",
        (0.0, 1.0, 2.0, 3.0), seed=99, fullh_frac=args.fullh_frac)
    engine.execute(warm)
    if args.coarse_frac > 0:
        # coarse traffic answers from tier 0: fit those synopses too
        engine.run_compiled(engine.compile(warm), tier=0)

    session = engine.session(watermark=watermark,
                             max_delay=args.max_delay_ms / 1e3,
                             max_pending=args.max_pending,
                             overflow=args.overflow)
    per_client: dict = {}
    errors: list = []
    results_lock = threading.Lock()
    stop_producer = threading.Event()
    stop_metrics = threading.Event()
    exports = [0]
    snapshots = [0]

    def export_metrics() -> None:
        obs.export_json(args.metrics_out, store.metrics, obs.get_registry(),
                        extra={"mode": "aqp", "rows": int(n)})
        exports[0] += 1

    def metrics_writer() -> None:
        while not stop_metrics.wait(args.metrics_every):
            export_metrics()

    mthread = None
    if args.metrics_out:
        mthread = threading.Thread(target=metrics_writer, daemon=True)
        mthread.start()

    if args.snapshot_dir and not args.restore:
        # a restartable loop snapshots at start-up too: --restore works even
        # if the process dies before the producer's first cadence tick
        store.save(args.snapshot_dir)
        snapshots[0] += 1

    def client(ci: int) -> None:
        specs = make_mixed_aqp_queries(
            args.per_client, ranges, joint_cols, "model_id",
            (0.0, 1.0, 2.0, 3.0), seed=10 + ci,
            fullh_frac=args.fullh_frac)
        crng = np.random.default_rng(500 + ci)
        got = []
        try:
            for q in specs:                       # closed loop: 1 outstanding
                priority = "coarse" if crng.random() < args.coarse_frac \
                    else None                     # None -> the session default
                got.append(session.submit(q, priority=priority).result(
                    timeout=RESULT_TIMEOUT))
        except Exception as exc:                  # reported after the join
            with results_lock:
                errors.append((ci, exc))
        with results_lock:
            per_client[ci] = got

    def producer() -> None:
        # keep streaming telemetry while queries are in flight: every batch
        # bumps reservoir versions, re-keying pending micro-batches
        prng = np.random.default_rng(1234)
        batches = 0
        while not stop_producer.wait(args.stream_every_ms / 1e3):
            store.add_batch(_make_telemetry(prng, args.stream_rows))
            batches += 1
            if args.snapshot_dir and batches % args.snapshot_every == 0:
                store.save(args.snapshot_dir)   # atomic keep-k, under the
                snapshots[0] += 1               # store's write lock

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(args.clients)]
    prod = threading.Thread(target=producer, daemon=True)
    depth_samples = []
    t0 = time.perf_counter()
    prod.start()
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        depth_samples.append(session.pending)
        time.sleep(0.002)
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    stop_producer.set()
    prod.join(timeout=10.0)
    session.close()
    if args.metrics_out:
        stop_metrics.set()
        if mthread is not None:
            mthread.join(timeout=10.0)
        export_metrics()    # the final snapshot includes the closing flush
    if args.trace_out:
        obs.get_tracer().export_jsonl(args.trace_out)
    if errors:
        ci, exc = errors[0]
        raise RuntimeError(f"[serve:aqp] {len(errors)} client(s) failed; client {ci}: "
                           f"{exc!r}") from exc

    # client order (not thread finish order): the sample rows below repeat
    # run to run when the producer is quiescent
    results = [r for ci in sorted(per_client) for r in per_client[ci]]
    st = session.stats()
    cs = store.cache.stats()
    paths = Counter(r.path for r in results)
    qps = len(results) / dt
    print(f"[serve:aqp] {len(results)} mixed queries from {args.clients} "
          f"concurrent clients over {len(store.columns)} columns "
          f"({n:,} seed rows) "
          f"in {dt * 1e3:.1f} ms -> {qps:,.0f} queries/s [{backend}]")
    if restored_step is not None:
        print(f"[serve:aqp] durability: warm-started from snapshot step "
              f"{restored_step} ({args.snapshot_dir}) — no refit, sketch "
              f"coverage intact")
    if args.snapshot_dir:
        print(f"[serve:aqp] durability: {snapshots[0]} snapshots written to "
              f"{args.snapshot_dir} (every {args.snapshot_every} streamed "
              f"batches, keep-3)")
    print(f"[serve:aqp] admission: {st['flushes']} flushes "
          f"(reasons: " + ", ".join(f"{k}={v}" for k, v
                                    in sorted(st['flush_reasons'].items()))
          + f"), mean batch {st['mean_batch']:.1f}, "
          f"{st['coalesced']} coalesced, "
          f"{st['invalidations']} version invalidations"
          + (f", backpressure: {st['blocked']} blocked, {st['shed']} shed "
             f"(max_pending={st['max_pending']})"
             if st["max_pending"] is not None else "")
          + (", priorities: " + ", ".join(
              f"{k}={v}" for k, v in sorted(st["priorities"].items()))
             if st["priorities"] else ""))
    if depth_samples:
        print(f"[serve:aqp] queue depth: max {max(depth_samples)}, "
              f"mean {sum(depth_samples) / len(depth_samples):.1f} "
              f"({len(depth_samples)} samples); "
              f"plan cache {st['plan_cache']['hits']} hits / "
              f"{st['plan_cache']['misses']} misses")
    print("[serve:aqp] execution paths: "
          + ", ".join(f"{p}={c}" for p, c in sorted(paths.items())))
    print(f"[serve:aqp] synopsis cache: {cs['hits']} hits / {cs['misses']} misses "
          f"({cs['entries']} entries, {cs['bytes']:,} bytes, "
          f"{cs['evictions']} evictions)")
    store_stats = store.stats()
    print("[serve:aqp] joints: " + ", ".join(
        f"{k} ({'backfilled' if v else 'streamed'})"
        for k, v in store_stats["backfilled"].items()))
    cat = store_stats["categoricals"].get("model_id", {})
    print(f"[serve:aqp] model_id sketch: {cat.get('codes', 0)} codes, "
          f"{cat.get('rows', 0):,} rows, "
          f"exact={'yes' if cat.get('exact') else 'no (KDE fallback)'}")
    if args.metrics_out:
        print(f"[serve:aqp] metrics: {exports[0]} snapshots -> "
              f"{args.metrics_out} (every {args.metrics_every:g}s)")
        _print_metrics_summary(store)
    if args.trace_out:
        print(f"[serve:aqp] traces: span ring appended to {args.trace_out}")
    for r in results[:6]:
        q = r.query
        terms = " & ".join(
            f"{t.column}={t.value:.0f}" if hasattr(t, "value")
            else (f"[{t.a:.1f},{t.b:.1f}] {t.column}" if hasattr(t, "a")
                  else " & ".join(f"{a:.1f}<={c}<={b:.1f}"
                                  for c, a, b in zip(t.columns, t.lo, t.hi)))
            for t in q.predicates)
        ci = "exact" if r.ci_lo == r.ci_hi \
            else f"±{(r.ci_hi - r.ci_lo) / 2:,.1f} @{r.ci_level:.0%}"
        print(f"  {q.aggregate.upper():5s} WHERE {terms} ~= {r.estimate:,.2f} "
              f"[{r.path}, {ci}, n_eff {r.n_effective:,}]")

    # GROUP BY over the dictionary column: one spec, one result per category,
    # answered by the factored grouped pass
    gb = engine.execute(AqpQuery("avg", (Range("latency_ms", 0.0, 500.0),),
                                 target="latency_ms", group_by="model_id"))
    print(f"[serve:aqp] AVG(latency_ms) GROUP BY model_id "
          f"[{gb[0].path}]: "
          + ", ".join(f"{r.group:.0f}: {r.estimate:.1f}" for r in gb))
    return {"queries": len(results), "seconds": dt, "qps": qps, "backend": backend,
            "device": str(device), "flushes": st["flushes"],
            "flush_reasons": st["flush_reasons"], "mean_batch": st["mean_batch"],
            "invalidations": st["invalidations"], "paths": dict(paths),
            "restored_step": restored_step, "snapshots": snapshots[0],
            "cache": cs}


def run_lm(args) -> dict:
    """LM mode: prefill + greedy decode of random prompts, run twice (the
    first run also loads the card's libraries).  Returns the model, its
    inputs, and each run's tokens, chosen-from logits and seconds."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.device import card_line, resolve_device, synchronize
    from repro_torch.models import build_model, random_inputs
    from repro_torch.train import greedy_generate

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device, torch.Generator(device=device).manual_seed(0))
    inputs = random_inputs(cfg, args.batch, args.prompt_len,
                           torch.Generator(device=device).manual_seed(1))
    prompt = inputs.pop("tokens")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve:lm] {cfg.name} ({cfg.family}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params:,} parameters, {cfg.param_dtype}) on {device}")
    runs = []
    for _ in range(2):
        synchronize(device)
        t0 = time.perf_counter()
        tokens, logits = greedy_generate(model, prompt, args.max_new, extra_batch=inputs,
                                         with_logits=True)
        synchronize(device)
        runs.append({"tokens": tokens, "logits": logits, "seconds": time.perf_counter() - t0})
    new = args.batch * args.max_new
    tps = new / runs[1]["seconds"]
    print(f"[serve:lm] generated {tuple(runs[1]['tokens'].shape)} tokens: "
          f"{runs[0]['seconds']:.3f} s first run, {runs[1]['seconds']:.3f} s warm, "
          f"{tps:,.1f} new tokens/s warm (prefill of {args.batch} x {args.prompt_len} "
          f"included)")
    card = card_line() if device.type == "cuda" else None
    if card:
        print(f"[serve:lm] card: {card}")
    print(f"[serve:lm] sample: {runs[1]['tokens'][0, args.prompt_len:].tolist()}")
    return {"cfg": cfg, "model": model, "prompt": prompt, "extra": inputs, "runs": runs,
            "tokens_per_s": tps, "device": str(device), "card": card}


def main(argv=None) -> None:
    from repro_torch.configs.base import ARCH_IDS

    ap = argparse.ArgumentParser(description="Serving on the port: AQP admission loop "
                                             "or LM prefill + decode")
    ap.add_argument("--mode", default="aqp", choices=["aqp", "lm"],
                    help="serving mode (default aqp; the reference defaults to lm)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, raising without "
                         "one; 'cpu' runs the plain PyTorch path)")
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(ARCH_IDS),
                    help="lm mode: the architecture")
    ap.add_argument("--smoke", action="store_true",
                    help="lm mode: the architecture's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4, help="lm mode: prompts")
    ap.add_argument("--prompt-len", type=int, default=16, help="lm mode: prompt tokens")
    ap.add_argument("--max-new", type=int, default=16, help="lm mode: tokens generated")
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--clients", type=int, default=8,
                    help="concurrent query clients feeding the AqpSession")
    ap.add_argument("--per-client", type=int, default=150,
                    help="queries each client submits (closed loop)")
    ap.add_argument("--watermark", type=int, default=None,
                    help="flush a micro-batch at this many pending queries "
                         "(default: the client count; closed-loop clients "
                         "can never fill a deeper bucket)")
    ap.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="max time a pending query waits before its bucket "
                         "flushes on deadline")
    ap.add_argument("--stream-every-ms", type=float, default=50.0,
                    help="producer cadence for streaming telemetry batches "
                         "(bumps synopsis versions mid-flight)")
    ap.add_argument("--stream-rows", type=int, default=20_000,
                    help="rows per streamed telemetry batch")
    ap.add_argument("--capacity", type=int, default=2048)
    ap.add_argument("--snapshot-dir", default=None,
                    help="write atomic keep-k store snapshots here (enables "
                         "--restore on the next run)")
    ap.add_argument("--snapshot-every", type=int, default=5,
                    help="streamed producer batches between snapshots")
    ap.add_argument("--restore", action="store_true",
                    help="warm-start from the latest snapshot in "
                         "--snapshot-dir instead of seeding a new store "
                         "(reservoirs, RNG states, sketches, fitted synopses)")
    ap.add_argument("--tuning-cache", default=None,
                    help="tile cache of repro_torch.kernels.autotune to load "
                         "(and to persist sweeps to)")
    ap.add_argument("--coarse-frac", type=float, default=0.0,
                    help="fraction of client queries submitted with "
                         "priority='coarse' (answered from the smallest "
                         "reservoir tier: faster, wider intervals)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="bound the admission queue depth (default: unbounded)")
    ap.add_argument("--overflow", default="block", choices=["block", "shed"],
                    help="policy at --max-pending: park the submitter or "
                         "raise AdmissionFull")
    ap.add_argument("--selector", default="plugin",
                    choices=["plugin", "silverman", "lscv_h"])
    ap.add_argument("--backend", default=None, choices=["cuda", "torch"],
                    help="'cuda' runs the hand-written kernels, 'torch' the plain "
                         "PyTorch path (default: cuda on the card, torch on the CPU)")
    ap.add_argument("--fullh-frac", type=float, default=0.0,
                    help="fraction of box queries carrying a per-query "
                         "selector='lscv_H' override: routed through the "
                         "full-H QMC path and the --kde-backend density "
                         "backend")
    ap.add_argument("--kde-backend", default="auto",
                    choices=["auto", "exact", "rff"],
                    help="density backend for full-H queries: exact KDE, "
                         "the sublinear RFF synopsis, or size-based auto "
                         "crossover (default)")
    ap.add_argument("--metrics-out", default=None,
                    help="enable repro_torch.obs and write a merged JSON metrics "
                         "snapshot here every --metrics-every seconds "
                         "(atomic replace)")
    ap.add_argument("--metrics-every", type=float, default=1.0,
                    help="seconds between --metrics-out snapshots")
    ap.add_argument("--trace-out", default=None,
                    help="append the span ring as JSON lines on exit "
                         "(enables repro_torch.obs)")
    args = ap.parse_args(argv)
    if args.metrics_every <= 0:
        ap.error(f"--metrics-every must be > 0, got {args.metrics_every}")
    if not 0.0 <= args.coarse_frac <= 1.0:
        ap.error(f"--coarse-frac must be in [0, 1], got {args.coarse_frac}")
    if not 0.0 <= args.fullh_frac <= 1.0:
        ap.error(f"--fullh-frac must be in [0, 1], got {args.fullh_frac}")
    if args.snapshot_every < 1:
        ap.error(f"--snapshot-every must be >= 1, got {args.snapshot_every}")
    if args.mode == "lm":
        if min(args.batch, args.prompt_len, args.max_new) < 1:
            ap.error("--batch, --prompt-len and --max-new must be >= 1")
        run_lm(args)
    else:
        run_aqp(args)


if __name__ == "__main__":
    main()
