"""Density-synopsis backends of the full-H path (see `base` for the
contract).  Counterpart: `repro/synopses/`.

Importing this package registers the built-in backends, so `available()`
lists everything usable after `import repro_torch.synopses`.
"""
from .base import DensitySynopsis, available, get_backend, register
from .exact import ExactSynopsis
from .rff import RFFSynopsis

__all__ = [
    "DensitySynopsis",
    "ExactSynopsis",
    "RFFSynopsis",
    "available",
    "get_backend",
    "register",
]
