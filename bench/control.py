#!/usr/bin/env python3
"""The readings that set a cell's limits: one process runs the cell on
several seeds, each with a short window at the cell's own load, and prints
each run's compared numbers as a JSON line.  With `--control` the reference
in TF32 stands in for the program's fits and answers (the control, which has
to come out not correct).  With `--config` (and `--traffic`) it runs that
configuration in place of the cell's, under the cell's limits: readings of
a configuration that the benchmark does not list.  Not part of a benchmark
run.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 [--control]
        [--config <name> [--traffic <mix>]]
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--config", help="a configuration under bench/configs in the cell's place")
    ap.add_argument("--traffic", help="a traffic mix under bench/traffic in the cell's place")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    if args.config or args.traffic:
        name = f"{args.config or args.workload}.{args.traffic or 'mix'}"
        cell = harness.load_cell(name, config=args.config, traffic=args.traffic,
                                 like=args.workload)
    else:
        cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, trace=False, control=args.control,
                               log=lambda m: print(f"[bench] {m}", file=sys.stderr, flush=True))
        print(json.dumps({"workload": cell.name, "seed": seed, "control": args.control,
                          "correct": res["correct"], "seconds": time.perf_counter() - t0,
                          "metrics": res["metrics"], "not_compared": res["not_compared"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
