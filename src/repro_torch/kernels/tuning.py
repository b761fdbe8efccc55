"""Kernel profiling for the port's wrappers.
Counterpart: `repro/kernels/tuning.py`, its `profiled_call` only (tile
tuning, the rest of that module, is not ported yet).
"""
from __future__ import annotations

import time

from repro_torch import obs


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
