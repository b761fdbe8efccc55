"""Shape-keyed tile tuning for the port's CUDA kernels.
Counterpart: `repro/kernels/autotune.py`.

`sweep()` times a kernel over candidate tile configurations for one shape
on the card and caches the winner; `resolve()` is what the `ops.py`
wrappers call, in the order

    explicit keyword  >  tuned cache (this module)  >  module constant

Candidate 0 of every sweep is the module constants, so a winner is never
slower than them on the swept timings (`entry["us"] <= entry["default_us"]`;
`scripts/validate_metrics.py --tuning` checks it).

Timing.  A candidate's time is the card's own: one warm-up launch, then
`repeats` windows of back-to-back launches on fixed inputs between two CUDA
events, each window queued behind a short sleep kernel so that the host's
launch work (0.04-0.15 ms a call, above most of these kernels' device time)
is done before the window opens.  `us` is the median window's microseconds
a launch.  The sweeps call the launchers directly, so they neither read the
cache nor go through `profiled_call`.

Shape keys bucket sizes to the next power of two and keep `d` exact, as the
reference's do, with one difference: the keys of the range, box and GROUP
BY kernels (`BATCH_INVARIANT`) leave out the batch `G`.  Their tunable is
the cut of the sample into ranges, and a cut that followed the batch would
give a query other bits in a micro-batch of 8 than in a batch of 1 024, so
admission sessions would no longer equal `execute`.  Their entries still
record the `G` they were timed at.

Persistence: the file format is the reference's (`_SCHEMA_VERSION` 1, the
same entry fields, an atomic write), so either package loads the other's
file; tile names are each package's own launcher keywords.  Where the
reference reads `REPRO_TUNING_CACHE`, the port has `use_cache(path)`: after
it, sweeps persist to the file, and the first lookup loads it (once).

Instruments (process-global registry): `autotune.sweeps` counter and
`autotune.sweep_us` histogram per kernel, `autotune.cache.hits` /
`autotune.cache.misses` counters per kernel (only once a cache holds an
entry: the untuned path stays counter-free), `autotune.cache.entries`
gauge.
"""
from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs

from . import aqp_batch as _ab
from . import aqp_boxes as _abx
from . import aqp_grouped as _agr
from . import pairwise_reduce as _pr
from . import qmc_reduce as _qmc
from . import rff_eval as _rff
from ._launch import SMEM_MAX, fixed_range
from .tuning import resolve_tile

_SCHEMA_VERSION = 1

# kernels whose tunable cuts the sample: their keys leave the batch out
BATCH_INVARIANT = frozenset({"aqp_batch_sums", "aqp_box_sums", "aqp_grouped_sums"})

LAUNCHES = 20               # launches in one timed window
SLEEP_CYCLES = 20_000_000   # the sleep kernel a window is queued behind (~10 ms)

_lock = threading.Lock()
_tiles: Dict[str, Dict[str, int]] = {}     # guarded-by: _lock; shape key -> tiles
_entries: Dict[str, dict] = {}             # guarded-by: _lock; shape key -> sweep record
_cache_path: Optional[str] = None          # guarded-by: _lock; set by use_cache
_loaded_from: Optional[str] = None         # guarded-by: _lock; path already loaded


def _bucket(v: int) -> int:
    v = int(v)
    return v if v <= 1 else 1 << (v - 1).bit_length()


def shape_key(kernel: str, shape: Dict[str, int]) -> str:
    """Cache key: the kernel and its sorted shape labels, sizes bucketed to
    the next power of two (`d` exact); `G` left out for BATCH_INVARIANT
    kernels."""
    parts = [kernel]
    for k in sorted(shape):
        if k == "G" and kernel in BATCH_INVARIANT:
            continue
        v = int(shape[k])
        parts.append(f"{k}={v if k == 'd' else _bucket(v)}")
    return "|".join(parts)


def reset() -> None:
    """Drop all in-process tuner state, the cache path included (tests
    stand in a fresh process with it)."""
    global _cache_path, _loaded_from
    with _lock:
        _tiles.clear()
        _entries.clear()
        _cache_path = None
        _loaded_from = None


def use_cache(path: Optional[str]) -> None:
    """Persist sweeps to `path` and load it on the next lookup (once); None
    stops persisting (entries already loaded stay)."""
    global _cache_path, _loaded_from
    with _lock:
        _cache_path = None if path is None else str(path)
        _loaded_from = None


def _ensure_loaded() -> None:
    global _loaded_from
    if _cache_path is None:
        return
    with _lock:
        path = _cache_path
        if path is None or _loaded_from == path:
            return
        _loaded_from = path
    if os.path.exists(path):
        load_cache(path)


def lookup(kernel: str, shape: Dict[str, int]) -> Optional[Dict[str, int]]:
    """The cached tiles for a shape, or None.  Without any entry this is
    one check, with no counter."""
    _ensure_loaded()
    if not _tiles:
        return None
    with _lock:
        hit = _tiles.get(shape_key(kernel, shape))
    reg = obs.get_registry()
    if hit is None:
        reg.counter("autotune.cache.misses", kernel=kernel).inc()
        return None
    reg.counter("autotune.cache.hits", kernel=kernel).inc()
    return hit


def resolve(kernel: str, shape: Dict[str, int], **params) -> Tuple[int, ...]:
    """Tile parameters of one launch: `params` maps each name to
    (override, module constant); returns the values in that order, each
    the override if given, else the cached winner's, else the constant."""
    cached = None
    if any(ov is None for ov, _default in params.values()):
        cached = lookup(kernel, shape)
    out = []
    for name, (override, default) in params.items():
        if override is None and cached is not None and name in cached:
            override = cached[name]
        out.append(resolve_tile(default, override))
    return tuple(out)


def record(kernel: str, shape: Dict[str, int], tiles: Dict[str, int],
           entry: Optional[dict] = None) -> str:
    """Install a tile choice in the in-process cache; returns its key."""
    key = shape_key(kernel, shape)
    with _lock:
        _tiles[key] = {k: int(v) for k, v in tiles.items()}
        if entry is not None:
            _entries[key] = entry
        n = len(_tiles)
    obs.get_registry().gauge("autotune.cache.entries").set(n)
    return key


def save_cache(path: str) -> dict:
    """Atomically write every recorded sweep entry as the tile-cache JSON
    (the schema `scripts/validate_metrics.py --tuning` checks)."""
    with _lock:
        entries = [dict(e) for e in _entries.values()]
    doc = {"version": _SCHEMA_VERSION, "ts": time.time(), "entries": entries}
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return doc


def load_cache(path: str) -> int:
    """Merge a persisted tile cache (either package's) into the in-process
    state; returns the entries loaded.  A file of another schema version
    raises."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("version") != _SCHEMA_VERSION:
        raise ValueError(f"{path}: unsupported tile-cache version "
                         f"{doc.get('version')!r}")
    n = 0
    for e in doc.get("entries", ()):
        record(str(e["kernel"]), {k: int(v) for k, v in e["shape"].items()},
               {k: int(v) for k, v in e["tiles"].items()}, entry=e)
        n += 1
    return n


# --- sweeping ---------------------------------------------------------------

class _Sweep(NamedTuple):
    defaults: Callable[[], Dict[str, int]]             # the module constants
    pools: Dict[str, Sequence[int]]                    # candidates per parameter
    effective: Callable[[Dict[str, int], Dict[str, int]], Optional[tuple]]
    make: Callable[[Dict[str, int]], Callable[[Dict[str, int]], object]]


def _candidates(spec: _Sweep, shape: Dict[str, int], quick: bool) -> List[Dict[str, int]]:
    """The module constants first, then the cross product of the pools
    (quick: each pool's extremes and the constant), without those that the
    launcher refuses (`effective` None) or that launch as an earlier one."""
    defaults = spec.defaults()
    names = list(defaults)
    pools = []
    for name in names:
        pool = sorted(set(spec.pools.get(name, ())) | {defaults[name]})
        if quick:
            pool = sorted({pool[0], pool[-1], defaults[name]})
        pools.append(pool)
    out, seen = [], set()
    for values in itertools.chain([tuple(defaults[n] for n in names)],
                                  itertools.product(*pools)):
        tiles = dict(zip(names, values))
        eff = spec.effective(shape, tiles)
        if eff is None or eff in seen:
            continue
        seen.add(eff)
        out.append(tiles)
    return out


def _inputs():
    """A seeded generator and a maker of float32 (or `dtype`) CUDA tensors,
    for the sweeps' fixed inputs."""
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device="cuda")
    return rng, t


def _make_pairwise(shape):
    rng, t = _inputs()
    x, g = t(rng.normal(0, 1, shape["n"]).astype(np.float32)), t([0.4])
    return lambda tl: _pr.pairwise_scaled_ksum(x, g, "k6", tile=tl["tile"])


def _make_aqp_batch(shape):
    rng, t = _inputs()
    n, q = shape["n"], shape["G"]
    x, h = t(rng.normal(0, 2, n).astype(np.float32)), t([0.5])
    a = rng.uniform(-4, 2, q).astype(np.float32)
    b = t(a + rng.uniform(0.2, 3, q).astype(np.float32))
    a = t(a)
    return lambda tl: _ab.aqp_batch_moments(x, h, a, b, tile=tl["tile"], ranges=tl["ranges"])


def _make_aqp_boxes(shape):
    rng, t = _inputs()
    n, d, q = shape["n"], shape["d"], shape["G"]
    x = t(rng.normal(0, 1.5, (n, d)).astype(np.float32))
    h = t(rng.uniform(0.2, 0.8, d).astype(np.float32))
    lo = rng.uniform(-3, 1, (q, d)).astype(np.float32)
    hi = t(lo + rng.uniform(0.2, 3, (q, d)).astype(np.float32))
    lo = t(lo)
    tgt = t(rng.integers(0, d, q), torch.int32)
    return lambda tl: _abx.aqp_box_moments(x, h, lo, hi, tgt, tile=tl["tile"],
                                           ranges=tl["ranges"])


def _make_aqp_grouped(shape):
    rng, t = _inputs()
    n, d, g = shape["n"], shape["d"], shape["G"]
    x = t(rng.normal(0, 1.5, (n, d)).astype(np.float32))
    h = t(rng.uniform(0.2, 0.8, d).astype(np.float32))
    lo = rng.uniform(-3, -1, d).astype(np.float32)
    hi, lo = t(lo + 4.0), t(lo)
    glo = np.arange(g, dtype=np.float32) - 0.5
    ghi, glo = t(glo + 1.0), t(glo)
    return lambda tl: _agr.aqp_grouped_sums(x, h, lo, hi, glo, ghi, 0, min(1, d - 1),
                                            tile=tl["tile"], ranges=tl["ranges"])


def _make_qmc(shape):
    rng, t = _inputs()
    n, d, q, nm = shape["n"], shape["d"], shape["G"], shape.get("m", 1024)
    x = t(rng.normal(0, 1.0, (n, d)).astype(np.float32))
    nodes = t(rng.uniform(-3, 3, (nm, d)).astype(np.float32))
    h_inv = t(np.eye(d, dtype=np.float32) * 4.0)
    lo = rng.uniform(-3, 0, (q, d)).astype(np.float32)
    hi, lo = t(lo + 2.0), t(lo)
    tgt = t(rng.integers(0, d, q), torch.int32)
    log_norm = t([-0.5 * d])
    # 8 row splits: the full-H CI's launch on the "cuda" backend
    return lambda tl: _qmc.qmc_box_reduce_split(nodes, x, h_inv, log_norm, lo, hi, tgt, 8,
                                                tile=tl["tile"], m_tile=tl["m_tile"])


def _make_rff(shape):
    rng, t = _inputs()
    nf, d, npts = shape["n"], shape["d"], shape["G"]    # n: features, G: points
    pts = t(rng.normal(0, 1, (npts, d)).astype(np.float32))
    w = t(rng.normal(0, 1, (nf, d)).astype(np.float32))
    b = t(rng.uniform(0, 6.28, nf).astype(np.float32))
    z = t(rng.normal(0, 1, nf).astype(np.float32))
    return lambda tl: _rff.rff_density_blocks(pts, w, b, z, 8, tile=tl["tile"],
                                              threads=tl["threads"])


def _eff_pairwise(shape, tl):
    if tl["tile"] % 32 or not 32 <= tl["tile"] <= 1024:
        return None
    return (_pr.tile_for(shape["n"], tl["tile"]),)


def _eff_cut(step: int):
    def eff(shape, tl):
        if tl["tile"] < step or tl["tile"] % step or tl["ranges"] < 1:
            return None
        return (fixed_range(shape["n"], tl["ranges"], step, tl["tile"]),)
    return eff


def _eff_qmc(shape, tl):
    k, mk = tl["tile"], tl["m_tile"]
    if k % 4 or k * shape["d"] * 4 > SMEM_MAX or mk % 128 or not 128 <= mk <= 4096:
        return None
    return (min(k, -(-shape["n"] // 4) * 4), mk)


def _eff_rff(shape, tl):
    fk, th = tl["tile"], tl["threads"]
    if fk * _rff.record_floats(shape["d"]) * 4 > SMEM_MAX or th % 32 or not 32 <= th <= 1024:
        return None
    return (min(fk, shape["n"]), th)


SWEEPS: Dict[str, _Sweep] = {
    "pairwise_scaled_ksum": _Sweep(lambda: {"tile": _pr.TILE},
                                   {"tile": (128, 256, 512, 1024)}, _eff_pairwise,
                                   _make_pairwise),
    "aqp_batch_sums": _Sweep(lambda: {"tile": _ab.TILE, "ranges": _ab.RANGES},
                             {"ranges": (16, 32, 64, 96, 128, 192, 256, 320)},
                             _eff_cut(32), _make_aqp_batch),
    "aqp_box_sums": _Sweep(lambda: {"tile": _abx.TILE, "ranges": _abx.RANGES},
                           {"ranges": (16, 32, 64, 96, 128, 192, 256)},
                           _eff_cut(32), _make_aqp_boxes),
    "aqp_grouped_sums": _Sweep(lambda: {"tile": _agr.TILE, "ranges": _agr.RANGES},
                               {"ranges": (32, 64, 96, 128, 192, 256)},
                               _eff_cut(_agr.SUB), _make_aqp_grouped),
    "qmc_box_reduce": _Sweep(lambda: {"tile": _qmc.TILE, "m_tile": _qmc.M_TILE},
                             {"tile": (256, 512, 1024), "m_tile": (256, 512, 1024)},
                             _eff_qmc, _make_qmc),
    "rff_density": _Sweep(lambda: {"tile": _rff.TILE, "threads": _rff.THREADS},
                          {"tile": (128, 256, 512), "threads": (128, 256, 512)},
                          _eff_rff, _make_rff),
}


def time_launches(run: Callable[[], object], repeats: int,
                  launches: int = LAUNCHES) -> Tuple[float, List[float]]:
    """(median, windows): the card's microseconds a launch of `run()` over
    `repeats` CUDA-event windows of `launches` back-to-back launches, after
    one warm-up launch; each window waits behind a sleep kernel, so the
    host has queued all its launches before the first one starts."""
    run()
    torch.cuda.synchronize()
    sleep = getattr(torch.cuda, "_sleep", None)
    windows = []
    for _ in range(max(1, int(repeats))):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if sleep is not None:
            sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(launches):
            run()
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) * 1e3 / launches)
    return float(np.median(windows)), windows


def sweep(kernel: str, shape: Dict[str, int], repeats: int = 3,
          quick: bool = False, persist: bool = True) -> dict:
    """Time every candidate tile configuration of `kernel` at `shape` on
    the CUDA device, record the winner in the in-process cache, and, after
    `use_cache(path)` with `persist`, write the cache file.  Returns the
    entry (the schema of `scripts/validate_metrics.py --tuning`)."""
    spec = SWEEPS.get(kernel)
    if spec is None:
        raise KeyError(f"no sweep registered for kernel {kernel!r}; "
                       f"have {sorted(SWEEPS)}")
    from repro_torch.device import require_cuda
    require_cuda()
    shape = {k: int(v) for k, v in shape.items()}
    run = spec.make(shape)
    t_sweep = time.perf_counter()
    swept = []
    for tiles in _candidates(spec, shape, quick):
        us, windows = time_launches(lambda: run(tiles), repeats)
        swept.append({"tiles": dict(tiles), "us": us, "windows_us": windows})
    best = min(swept, key=lambda s: s["us"])
    entry = {
        "kernel": kernel, "shape": shape, "key": shape_key(kernel, shape),
        "tiles": dict(best["tiles"]), "us": best["us"],
        "default_tiles": dict(swept[0]["tiles"]), "default_us": swept[0]["us"],
        "repeats": int(max(1, repeats)), "launches": LAUNCHES,
        "timing": "CUDA events, median window, us a launch",
        "device": torch.cuda.get_device_name(), "swept": swept,
    }
    record(kernel, shape, best["tiles"], entry=entry)
    reg = obs.get_registry()
    reg.counter("autotune.sweeps", kernel=kernel).inc()
    reg.histogram("autotune.sweep_us", kernel=kernel).observe(
        (time.perf_counter() - t_sweep) * 1e6)
    with _lock:
        path = _cache_path
    if persist and path:
        save_cache(path)
    return entry
