"""Entry points of the port (counterpart: `repro/launch/`): `serve` runs the
AQP admission loop (`python -m repro_torch.launch.serve --mode aqp`)."""
