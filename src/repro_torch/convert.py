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
from repro_torch.data.aqp_store import TelemetryStore
from repro_torch.device import DTYPE, DeviceLike, resolve_device
from repro_torch.synopses import RFFSynopsis


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
    """The port's store from `repro.data.aqp_store.TelemetryStore.to_state()`:
    `TelemetryStore.from_state` on `device`.

    Carries reservoir buffers with `n_seen`, `n_filled`, version and RNG
    state (so later `add_batch` calls sample as the reference would), joints
    with their backfill flags, tiered columns and joints (every tier and
    stratum with its RNG state), exact and count-min sketches (the stored
    hash parameters and table), cached synopses with a bandwidth (plugin,
    silverman, lscv_h) or a full bandwidth matrix (lscv_H), cached density
    synopses (RFF: w, b, z, norm, seed, degraded, probe_rel_err), the
    metrics registry, and the shared engines' plans.  The reference fits on
    its plain path, so its cached entries, which name no backend, serve the
    port's plain backend ("torch"), and so do its "jnp" engines' plans; a
    "cuda" query refits on the kernels.  A tier's cached synopsis keeps its
    tier-suffixed column key, which is where the port's tiered resolution
    looks (`_tier_key`).
    """
    return TelemetryStore.from_state(arrays, meta, device=device)
