"""Tile resolution and kernel profiling for the port's wrappers.
Counterpart: `repro/kernels/tuning.py`.

Every `ops.py` wrapper resolves its tiles at call time, in the order
explicit keyword > tuned cache (`kernels/autotune.py`) > module constant;
`resolve_tile` is the last step.  The port has no environment knobs: where
the reference reads `REPRO_*` variables, the module constants stand.

`profiled_call` is the measurement side: with `repro_torch.obs` enabled,
every launch records its fenced wall time, its dispatch time and a call
count in the process-global registry, labelled with the kernel and its shape
and tile labels, and `measured()` reads them back, for the autotune CLI and
for reports.
"""
from __future__ import annotations

import time
from typing import Dict, List

from repro_torch import obs


def resolve_tile(default: int, override=None) -> int:
    """One tile parameter, resolved at call time: the explicit keyword when
    given (a positive integer, else ValueError), otherwise `default`."""
    if override is not None:
        value = int(override)
        if value <= 0:
            raise ValueError(f"tile override must be a positive integer, "
                             f"got {override!r}")
        return value
    return int(default)


def profiled_call(kernel: str, fn, /, *args, **labels):
    """Run `fn(*args)` recording its timings into the global registry,
    labelled with `kernel` and the shape and tile labels the wrapper passes
    (n, d, G, tile, ...):

      kernel.calls        counter   launches
      kernel.dispatch_us  histogram time until `fn` returns (the launch)
      kernel.wall_us      histogram time until the output is ready on the card

    The launchers return before the card has run the kernel, so the wall
    time fences the output's CUDA stream (`obs.fence`).  The wrappers call
    this only on the `obs.enabled()` branch; the disabled branch calls the
    launcher directly.
    """
    reg = obs.get_registry()
    t0 = time.perf_counter()
    out = fn(*args)
    t1 = time.perf_counter()
    obs.fence(*(out if isinstance(out, tuple) else (out,)))
    t2 = time.perf_counter()
    reg.counter("kernel.calls", kernel=kernel, **labels).inc()
    reg.histogram("kernel.dispatch_us", kernel=kernel, **labels).observe(
        (t1 - t0) * 1e6)
    reg.histogram("kernel.wall_us", kernel=kernel, **labels).observe(
        (t2 - t0) * 1e6)
    return out


def measured(kernel: str = None) -> List[Dict[str, object]]:
    """Measured kernel timings from the global registry: one row per
    (kernel, shape, tile) combination with its call count and wall-time
    summary, the most-called first."""
    reg = obs.get_registry()
    match = {"kernel": kernel} if kernel is not None else {}
    rows = []
    for labels, hist in reg.collect_histograms("kernel.wall_us", **match):
        rows.append({**labels, **hist.summary()})
    rows.sort(key=lambda r: (r.get("kernel", ""), -r["count"]))
    return rows
