"""Checkpoints and the elastic / straggler logic of training (counterpart:
`repro/checkpoint/`)."""
from .checkpoint import CheckpointManager
from .elastic import ElasticController, FailureEvent, HostStat, StragglerMonitor, plan_mesh
