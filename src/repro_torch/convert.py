"""State carried across from the JAX package: its fitted synopses, its RFF
density synopses and its store snapshots, rebuilt as the port's objects from
numpy arrays (the system's counterpart of carrying weights across).
Counterpart: the reference's `TelemetryStore.to_state()` / `from_state()`
and `RFFSynopsis.to_state()`."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.aqp import KDESynopsis
from repro_torch.data.aqp_store import (_SKETCH_KINDS, MultiReservoir, Reservoir,
                                        TelemetryStore, TieredReservoir)
from repro_torch.device import DTYPE, DeviceLike, resolve_device
from repro_torch.synopses import RFFSynopsis, get_backend

STATE_FORMAT = 1     # the reference's `repro.data.aqp_store.STATE_FORMAT`


def synopsis_from_numpy(x, h, n_source: int, selector: str,
                        device: DeviceLike = None, H=None) -> KDESynopsis:
    """The port's synopsis from a reference synopsis's fields as numpy
    arrays: sample `x` and either bandwidth `h` (scalar or per axis) or
    full bandwidth matrix `H` (LSCV_H)."""
    dev = resolve_device(device)
    if (h is None) == (H is None):
        raise ValueError("a synopsis carries exactly one of h and H")

    def tensor(a):
        return None if a is None else torch.tensor(
            np.asarray(a, np.float32), dtype=DTYPE, device=dev)

    return KDESynopsis(x=tensor(x), h=tensor(h), H=tensor(H),
                       n_source=int(n_source), selector=selector)


def rff_from_numpy(w, b, z, norm: float, n_fitted: int, seed: int,
                   degraded: bool = False, probe_rel_err: float = float("nan"),
                   device: DeviceLike = None) -> RFFSynopsis:
    """The port's RFF synopsis from a reference fit's state as numpy arrays
    (`repro.synopses.rff.RFFSynopsis.to_state()`): the very (W, b, z) the
    reference drew, so both packages evaluate the same synopsis."""
    return RFFSynopsis.from_state(
        {"w": w, "b": b, "z": z},
        {"norm": norm, "n_fitted": n_fitted, "seed": seed, "degraded": degraded,
         "probe_rel_err": probe_rel_err}, device=device)


def store_from_state(arrays: Dict[str, np.ndarray], meta: Dict[str, object],
                     device: DeviceLike = None) -> TelemetryStore:
    """The port's store from `repro.data.aqp_store.TelemetryStore.to_state()`.

    Carries reservoir buffers with `n_seen`, `n_filled`, version and RNG
    state (so later `add_batch` calls sample as the reference would), joints
    with their backfill flags, tiered columns and joints (every tier and
    stratum with its RNG state), exact and count-min sketches (the stored
    hash parameters and table), cached synopses with a bandwidth (plugin,
    silverman, lscv_h) or a full bandwidth matrix (lscv_H), and cached
    density synopses (RFF: w, b, z, norm, seed, degraded, probe_rel_err).  The reference fits on its plain path, so its
    cached entries serve the port's plain backend ("torch"); a "cuda" query
    refits on the kernels.  `meta["metrics"]` and `meta["plans"]` are
    skipped: the port has no metrics registry yet, and plans rebuild from the
    synopses on first use.  A tier's cached synopsis keeps its tier-suffixed
    column key, which is where the port's tiered resolution looks
    (`_tier_key`).
    """
    if int(meta.get("format", -1)) != STATE_FORMAT:
        raise ValueError(f"unsupported store-state format "
                         f"{meta.get('format')!r} (want {STATE_FORMAT})")
    store = TelemetryStore(capacity=int(meta["capacity"]),
                           seed=int(meta["seed"]), device=device)
    cap = store.capacity

    def subtree(prefix: str) -> Dict[str, np.ndarray]:
        return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}

    with store._write_lock:
        for name, m in meta["columns"].items():
            if m.get("kind") == "tiered":
                store.columns[name] = TieredReservoir.from_state(
                    subtree(f"columns/{name}/"), m)
                continue
            res = Reservoir(cap, seed=store._col_seed(name))
            res.load_state(arrays[f"columns/{name}/buf"], m)
            store.columns[name] = res
        for i, m in enumerate(meta["joints"]):
            cols = tuple(m["columns"])
            if m.get("kind") == "tiered":
                store.joints[cols] = TieredReservoir.from_state(subtree(f"joints/{i}/"), m)
                continue
            res = MultiReservoir(cols, cap, seed=store._col_seed("|".join(cols)))
            res.load_state(arrays[f"joints/{i}/buf"], m)
            store.joints[cols] = res
        for name, m in meta["categoricals"].items():
            sketch = _SKETCH_KINDS[str(m["kind"])].from_state(
                subtree(f"categoricals/{name}/"), m)
            res = store.columns.get(name)
            if res is not None and sketch.n_rows > res.n_seen:
                raise ValueError(
                    f"inconsistent snapshot: sketch for {name!r} has seen "
                    f"{sketch.n_rows} rows but its reservoir only {res.n_seen}")
            store.categoricals[name] = sketch
    for i, ent in enumerate(meta["cache"]):
        col = tuple(ent["column"]) if ent["is_tuple"] else ent["column"]
        syn_meta = ent.get("synopsis")
        if syn_meta is not None:
            syn = get_backend(str(syn_meta["backend"])).from_state(
                subtree(f"cache/{i}/"), syn_meta, device=store.device)
            syn.n_source = int(ent["n_source"])
            syn.selector = str(ent["syn_selector"])
        else:
            syn = synopsis_from_numpy(arrays[f"cache/{i}/x"],
                                      arrays.get(f"cache/{i}/h"),
                                      ent["n_source"], str(ent["syn_selector"]),
                                      device=store.device,
                                      H=arrays.get(f"cache/{i}/H"))
        store.cache.put(col, str(ent["selector"]), int(ent["version"]), syn,
                        backend="torch")
    return store
