"""State carried across from the JAX package: its fitted synopses, its RFF
density synopses and its store snapshots, rebuilt as the port's objects from
numpy arrays (the system's counterpart of carrying weights across), and the
LM stack's parameter trees and decode caches.
Counterpart: the reference's `TelemetryStore.to_state()` / `from_state()`,
`RFFSynopsis.to_state()` and the models' `init()` / `init_cache()` trees."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.aqp import KDESynopsis
from repro_torch.data.aqp_store import TelemetryStore
from repro_torch.device import DTYPE, DeviceLike, resolve_device
from repro_torch.synopses import RFFSynopsis

# the reference's parameter trees stack these subtrees on a leading layer
# axis; the port keeps one entry per layer
STACKED = ("layers", "mamba", "enc_layers", "dec_layers")


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


def lm_state_from_numpy(params: Mapping) -> Dict[str, np.ndarray]:
    """The reference's LM parameter tree (nested dicts of numpy arrays or
    tensors, the layer axis stacked) as the port's `state_dict()` keys:
    "layers.3.attn.wq" for `params["layers"]["attn"]["wq"][3]`.  The
    inverse of `lm_tree_from_state`."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree, path, layer):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                if k in STACKED:
                    n = len(next(iter(_leaves(v))))
                    for i in range(n):
                        walk(v, path + (k, str(i)), i)
                else:
                    walk(v, path + (k,), layer)
            else:
                a = v if isinstance(v, torch.Tensor) else np.asarray(v)
                out[".".join(path + (k,))] = a if layer is None else a[layer]

    walk(params, (), None)
    return out


def lm_tree_from_state(state: Mapping[str, torch.Tensor]) -> dict:
    """The port's per-layer tensors by `state_dict()` key (or any mapping
    with those keys, such as AdamW's moments) as the reference's tree:
    nested dicts with each layer list stacked on a leading axis, on the
    host.  The inverse of `lm_state_from_numpy`; the layout both packages'
    training checkpoints share."""
    tree: dict = {}
    stacked: Dict[tuple, Dict[int, torch.Tensor]] = {}

    def put(path, value):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value

    for key, t in state.items():
        parts = key.split(".")
        t = t.detach().cpu()
        if parts[0] in STACKED and len(parts) > 2 and parts[1].isdigit():
            stacked.setdefault((parts[0],) + tuple(parts[2:]), {})[int(parts[1])] = t
        else:
            put(parts, t)
    for path, by_layer in stacked.items():
        put(path, torch.stack([by_layer[i] for i in range(len(by_layer))]))
    return tree


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from _leaves(v)
        else:
            yield v


def lm_params_from_numpy(cfg, params: Mapping, device: DeviceLike = None):
    """The port's model of `cfg` holding the reference's parameters
    (`model.init(key)` as nested dicts of numpy arrays).  bf16 leaves come as
    float32, which holds them exactly; each is cast to the dtype the port's
    module keeps for it (the config's, or float32 where the reference keeps
    float32: the router, A_log, D, a_log, Mamba-2's dt_bias)."""
    from repro_torch.models import build_model

    model = build_model(cfg, device=device)
    state = {k: torch.tensor(a) for k, a in lm_state_from_numpy(params).items()}
    model.load_state_dict(state, strict=True)
    return model


def lm_cache_from_numpy(cfg, cache: Mapping[str, np.ndarray],
                        device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A reference decode cache (`prefill`'s or `init_cache`'s, as numpy
    arrays) on `device`, each leaf in the dtype the port's cache keeps: the
    SSM states float32, the rest the config's dtype."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    return {k: torch.tensor(np.asarray(a, np.float32), device=dev,
                            dtype=torch.float32 if k == "ssm" else dt)
            for k, a in cache.items()}
