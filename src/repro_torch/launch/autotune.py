"""Tile sweeps from the command line (counterpart: `scripts/autotune.py`,
the reference's front end of its `kernels/autotune.py`).

    python -m repro_torch.launch.autotune --shape pairwise_scaled_ksum:n=4096
    python -m repro_torch.launch.autotune --metrics m.json --cache tiles.json
    python -m repro_torch.launch.autotune --shape aqp_box_sums:n=32768,d=3,G=8 \\
        --cache tiles.json --assert-no-regress

Sweeps the candidate tiles of the shapes a workload ran, from a `serve
--metrics-out` snapshot's `kernel.wall_us` labels (--metrics), from this
process's registry (`tuning.measured()`, the default) or from explicit
--shape specs, on the CUDA device, and records the winners.  With --cache
they persist to the tile-cache JSON that `scripts/validate_metrics.py
--tuning` checks and that `serve --tuning-cache` (or
`autotune.use_cache`) loads with no sweep.

--assert-no-regress exits non-zero if a winner timed slower than the module
constants it was measured against (candidate 0 of every sweep, so this
trips only on a fault of the measurement).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.kernels import autotune
from repro_torch.kernels.tuning import measured

SHAPE_LABELS = ("n", "d", "G", "m")


def parse_shape(spec: str):
    """'kernel:n=16384,d=6,G=64' -> (kernel, {'n': 16384, 'd': 6, 'G': 64})"""
    kernel, _, rest = spec.partition(":")
    if not kernel or not rest:
        raise ValueError(f"malformed --shape {spec!r}; expected "
                         f"kernel:n=...,d=...[,G=...,m=...]")
    shape = {}
    for part in rest.split(","):
        k, _, v = part.partition("=")
        if k not in SHAPE_LABELS:
            raise ValueError(f"--shape {spec!r}: unknown axis {k!r} "
                             f"(have {SHAPE_LABELS})")
        shape[k] = int(v)
    return kernel, shape


def shapes_from_rows(rows, known):
    """(kernel, shape) specs from measured kernel.wall_us label rows,
    deduplicated by cache key (the range kernels' rows at several batch
    sizes are one key)."""
    out, seen = [], set()
    for row in rows:
        kernel = row.get("kernel")
        if kernel not in known:
            continue
        shape = {k: int(row[k]) for k in SHAPE_LABELS if k in row}
        if not shape:
            continue
        key = autotune.shape_key(kernel, shape)
        if key not in seen:
            seen.add(key)
            out.append((kernel, shape))
    return out


def shapes_from_snapshot(path: str, known):
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    rows = [e.get("labels", {})
            for e in doc.get("histograms", {}).get("kernel.wall_us", [])]
    return shapes_from_rows(rows, known)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tile sweeps of the port's CUDA kernels")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="KERNEL:n=..,d=..",
                    help="explicit sweep spec (repeatable); e.g. "
                         "aqp_box_sums:n=32768,d=3,G=8")
    ap.add_argument("--metrics", metavar="PATH",
                    help="obs.export_json snapshot: sweep every shape its "
                         "kernel.wall_us entries measured")
    ap.add_argument("--cache", metavar="PATH",
                    help="persist the winners here (autotune.use_cache)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="each parameter's extremes and its constant only")
    ap.add_argument("--assert-no-regress", action="store_true",
                    help="exit non-zero if any winner timed slower than the "
                         "module constants")
    args = ap.parse_args(argv)
    if args.cache:
        autotune.use_cache(args.cache)
    targets = [parse_shape(s) for s in args.shape]
    if args.metrics:
        targets += shapes_from_snapshot(args.metrics, autotune.SWEEPS)
    if not args.shape and not args.metrics:
        targets += shapes_from_rows(measured(), autotune.SWEEPS)
    if not targets:
        print("nothing to sweep: no --shape given and no measured "
              "kernel.wall_us shapes found", file=sys.stderr)
        return 2

    regressed = []
    for kernel, shape in targets:
        entry = autotune.sweep(kernel, shape, repeats=args.repeats, quick=args.quick)
        gain = entry["default_us"] / entry["us"] if entry["us"] else 1.0
        print(f"{kernel} {shape}: {entry['tiles']} "
              f"{entry['us']:.2f}us ({gain:.2f}x over the constants "
              f"{entry['default_tiles']} {entry['default_us']:.2f}us, "
              f"{len(entry['swept'])} candidates, device time a launch)")
        if entry["us"] > entry["default_us"]:
            regressed.append((kernel, shape))
    if args.cache:
        print(f"persisted {len(targets)} entr"
              f"{'y' if len(targets) == 1 else 'ies'} -> {args.cache}")
    if args.assert_no_regress and regressed:
        for kernel, shape in regressed:
            print(f"FAIL: {kernel} {shape} tuned tiles slower than the constants",
                  file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
