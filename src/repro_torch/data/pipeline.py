"""Deterministic, resumable, shard-aware synthetic token pipeline
(counterpart: `repro/data/pipeline.py`).

Batches come from a counter-keyed generator: numpy's Philox keyed by
`SeedSequence([seed, step, host_id])`, so (a) every host draws exactly its
own slice of the global batch from (host_id, n_hosts), with no data
exchange, and (b) restoring `state()` after a restart reproduces the stream
bit for bit.  The draws are the port's own, not `jax.random`'s: the token
law is the reference's, `min(int(vocab * u^2.5), vocab - 1)` with u uniform
on [0, 1) in float32 (Zipf-like, so the KDE telemetry has structure), with
labels rolled by -1 along the sequence.  Parity tests feed both packages
the same batch.

Tokens are drawn on the host and moved to `device`, so a CPU run and a card
run of the same pipeline see the same tokens.  Each batch's telemetry
columns (`mean_token`, and `seq_entropy`, the population std of a row's
token ids) stream into a `TelemetryStore` when one is given.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class PipelineState:
    step: int = 0


class TokenPipeline:
    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1,
                 telemetry=None, device: DeviceLike = None):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{n_hosts} hosts")
        self.vocab = vocab_size
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seq = seq_len
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self._state = PipelineState()

    # -- persistence --------------------------------------------------------
    def state(self) -> Dict:
        return {"step": self._state.step, "seed": self.seed}

    def restore(self, state: Dict) -> None:
        if state["seed"] != self.seed:
            raise ValueError(f"restoring the stream of seed {state['seed']} into a "
                             f"pipeline of seed {self.seed}")
        self._state.step = int(state["step"])

    # -- iteration ----------------------------------------------------------
    def host_tokens(self, step: int) -> np.ndarray:
        """This host's (local_batch, seq) int32 tokens of `step`."""
        rng = np.random.Generator(np.random.Philox(
            np.random.SeedSequence([self.seed, step, self.host_id])))
        u = rng.random((self.local_batch, self.seq), dtype=np.float32)
        drawn = (np.float32(self.vocab) * u ** np.float32(2.5)).astype(np.int32)
        return np.minimum(drawn, self.vocab - 1)

    def next(self) -> Dict[str, torch.Tensor]:
        step = self._state.step
        tokens = self.host_tokens(step)
        labels = np.roll(tokens, -1, axis=1)
        self._state.step = step + 1
        if self.telemetry is not None:
            self.telemetry.add_batch({
                "mean_token": np.mean(tokens, axis=1).astype(np.float32),
                "seq_entropy": np.std(tokens.astype(np.float32), axis=1).astype(np.float32),
            })
        return {"tokens": torch.from_numpy(tokens).to(self.device, torch.long),
                "labels": torch.from_numpy(labels).to(self.device, torch.long)}

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()
