"""Pluggable density-synopsis backends for the engine's full-H path.
Counterpart: `repro/synopses/base.py`.

A backend is fitted once per synopsis version and then evaluates batched
densities, exactly (`"exact"`, eq. 6 through `kde_eval_H`) or sublinearly
(`"rff"`, a fixed-size random-Fourier-feature state whose eval cost does not
depend on the sample size).  The contract:

  fit(sample, H, ...) -> synopsis   one-time fit against the retained rows
                                    and the full bandwidth matrix
  eval_batch(points) -> densities   batched f^(points), shape (m,)
  to_state() / from_state(...)      numpy arrays and JSON-safe meta, the
                                    reference's snapshot format
  n_fitted                          rows the fit consumed
  error_metadata()                  accuracy facts (probe error, feature
                                    count, degraded flag)

Backends register by name; the name rides in snapshot metadata.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_REGISTRY: Dict[str, type] = {}


def register(name: str):
    """Class decorator: publish a backend under `name` (used by cache keys
    and snapshot metadata, so a registered name never changes)."""

    def deco(cls: type) -> type:
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(f"density backend {name!r} already registered "
                             f"to {existing.__name__}")
        _REGISTRY[name] = cls
        cls.backend = name
        return cls

    return deco


def get_backend(name: str) -> type:
    cls = _REGISTRY.get(name)
    if cls is None:
        raise KeyError(f"unknown density backend {name!r}; "
                       f"have {available()}")
    return cls


def available() -> List[str]:
    return sorted(_REGISTRY)


class DensitySynopsis:
    """Base class of the density-synopsis backends (see the module
    docstring).  `n_source` / `selector` mirror `KDESynopsis`, so fitted
    backends ride the store's `SynopsisCache` unchanged."""

    backend: str = "?"
    n_fitted: int = 0
    n_source: int = 0
    selector: str = "plugin"
    degraded: bool = False      # accuracy gate failed -> engine uses exact

    @classmethod
    def fit(cls, sample, H, **kwargs) -> "DensitySynopsis":
        raise NotImplementedError

    def eval_batch(self, points):
        raise NotImplementedError

    def to_state(self) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
        raise NotImplementedError

    @classmethod
    def from_state(cls, arrays: Dict[str, np.ndarray], meta: Dict[str, object],
                   device=None) -> "DensitySynopsis":
        raise NotImplementedError

    @property
    def nbytes(self) -> int:
        """Device bytes, for the SynopsisCache's byte bound."""
        return 0

    def error_metadata(self) -> Dict[str, object]:
        return {"backend": self.backend, "degraded": bool(self.degraded)}
