"""Reduction of the traced run's `torch.profiler` window: device busy time,
device time per kernel family, and the idle gaps with what the host was
doing during them.

Kernel families are named as `repro_torch.kernels.ops` names its wrappers:
a hand kernel's device functions map to the wrapper that launches them, and
the small finishing kernels a launcher queues after its main kernel
(`sum_tile_partials`, `sum_partial_columns`, `qmc_split_densities`) count
to the family launched just before them on the card.  Any other device
operation keeps its own name.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# device function name (as it starts, before any template or argument list)
# -> the ops wrapper that launches it
FAMILIES = {
    "sv_tiles": "sv_matrix",
    "lscv_grid_tiles": "lscv_grid_sums",
    "gh_tiles": "gh_fused_sum",
    "pairwise_tiles": "pairwise_scaled_ksum",
    "triangle_map": "pairwise_scaled_ksum",
    "aqp_batch_tiles": "aqp_batch_sums",
    "aqp_box_tiles": "aqp_box_sums",
    "grouped_tiles": "aqp_grouped_sums",
    "qmc_density_tiles": "qmc_box_reduce",
    "qmc_box_tiles": "qmc_box_reduce",
    "rff_tiles": "rff_density",
    "rff_combine": "rff_density",
    "kde_tiles": "kde_eval",
    "kde_finish": "kde_eval",
}
FINISHERS = ("sum_tile_partials", "sum_partial_columns", "qmc_split_densities")


def _base_name(name: str) -> str:
    """"void ns::(anonymous namespace)::kernel<8>(float const*, ...)" ->
    "kernel"."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<( ]", name, maxsplit=1)[0].split("::")[-1] or name


@dataclass
class DeviceWindow:
    """What one traced window holds."""
    window_s: float
    busy_s: float
    family_s: Dict[str, float]          # device seconds per family / op name
    family_launches: Dict[str, int]     # main-kernel launches per family
    idle_by_host: List[Tuple[str, float]] = field(default_factory=list)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_events(device_events, host_events, t0_ns: int, t1_ns: int) -> DeviceWindow:
    """device_events: (name, start_ns, end_ns) of every operation on the card;
    host_events: (name, start_ns, end_ns) of the host's profiled operations
    and annotations (one thread); [t0_ns, t1_ns] the window."""
    dev = sorted((s, e, n) for n, s, e in device_events if e > t0_ns and s < t1_ns)
    family_s: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    owner = None
    for s, e, name in dev:
        base = _base_name(name)
        fam = FAMILIES.get(base)
        if fam is not None:
            owner = fam
            launches[fam] = launches.get(fam, 0) + 1
        elif base in FINISHERS and owner is not None:
            fam = owner
        else:
            fam = base if base in FINISHERS else name[:80]
            owner = None
        family_s[fam] = family_s.get(fam, 0.0) + (e - s) / 1e9
    busy = _merge([(max(s, t0_ns), min(e, t1_ns)) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = []
    prev = t0_ns
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1_ns > prev:
        gaps.append((prev, t1_ns))
    return DeviceWindow(window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy_s, family_s=family_s,
                        family_launches=launches, idle_by_host=_label_gaps(gaps, host_events))


def _label_gaps(gaps, host_events) -> List[Tuple[str, float]]:
    """Idle seconds summed by the innermost host operation running at each
    gap's midpoint (nested host events: the latest-starting one that still
    covers the point; past 256 events back, the benchmark's own `bench.*`
    annotations), longest first."""
    host = sorted((s, e, n) for n, s, e in host_events)
    starts = [h[0] for h in host]
    marks = [h for h in host if h[2].startswith("bench.")]
    total: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = None
        for j in range(i, max(i - 256, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        if label is None:
            inner = [m for m in marks if m[0] <= mid <= m[1]]
            label = max(inner)[2] if inner else "host outside any profiled operation"
        total[label] = total.get(label, 0.0) + (g1 - g0) / 1e9
    return sorted(total.items(), key=lambda kv: -kv[1])


def from_profiler(prof, t0_ns: int, t1_ns: int) -> DeviceWindow:
    """Read a stopped `torch.profiler.profile` straight from its kineto
    result (no per-event Python tree is built)."""
    device_events, host_events = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = str(ev.device_type())
        item = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if "CUDA" in kind:
            # the host's annotations mirrored on the device's timeline are
            # no device work
            if ev.name().startswith("bench.") or ev.is_user_annotation():
                continue
            device_events.append(item)
        elif "CPU" in kind:
            host_events.append(item)
    return reduce_events(device_events, host_events, t0_ns, t1_ns)


def breakdown(win: DeviceWindow, top: int = 10) -> dict:
    ops = sorted(win.family_s.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in win.idle_by_host[:top]]}
