#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line of
standard output:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  `--trace 0` reports the cell's end-to-end
metrics, `--trace 1` its per-layer metrics from a traced window.  Exits
non-zero, printing no result, without enough CUDA devices, when the program
is missing, or when jax, flax or the JAX package `repro` is loaded once the
window has closed.  The numbers compared for `correct` are the last lines of
standard error and the last key of the result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    # every cache at a fixed path inside the checkout; the program's kernels
    # build into build/repro_torch_kernels there on their own
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from bench import harness

    def log(msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    cell = harness.load_cell(args.workload)
    import repro_torch  # noqa: F401  (the program: a checkout without it runs nothing)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3
    if args.trace:
        log(f"card: {harness.power_limit()} (name, power limit)")
    for name, v in result["not_compared"].items():
        log(f"reading {name}: {v!r} (not compared)")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
