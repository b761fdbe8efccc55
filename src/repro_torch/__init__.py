"""PyTorch + CUDA port of `repro` (KDE synopses for approximate query
processing), for NVIDIA Hopper.

The JAX package `repro` is the reference this package is held against.
This package imports neither it nor `jax`: where it needs code from there it
keeps its own copy.  Entry points run on the CUDA device unless the caller
passes `device="cpu"`; with no CUDA device and no explicit CPU request they
raise (`repro_torch.device.require_cuda`).
"""
