"""Elastic scaling and straggler mitigation (counterpart:
`repro/checkpoint/elastic.py`, copied whole: it is pure Python, and the port
imports nothing of `repro`).

On real fleets this sits next to the cluster manager; everything here is the
deterministic decision logic:

* `plan_mesh(n_devices, ...)` — given the surviving device count, choose the
  largest (data, model) grid (model axis must divide the TP-shardable dims)
  and report how many devices idle.  After a failure the driver: (1) stops,
  (2) re-plans the mesh, (3) restores the latest checkpoint, (4) resumes the
  data pipeline from its persisted cursor.
* `StragglerMonitor` — per-host EWMA of step times; hosts slower than
  mean + k*sigma for `patience` consecutive steps are flagged for eviction
  (the driver treats eviction like a failure: re-plan without that host).
  The port's trainer records a step's time after reading its loss, which
  waits for the device; the reference's timed the dispatch only.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def plan_mesh(n_devices: int, tp_max: int = 16,
              tp_divisor_of: Tuple[int, ...] = ()) -> Tuple[int, int]:
    """Largest (data, model) grid with data*model <= n_devices.

    Prefers the biggest power-of-two model axis <= tp_max that divides every
    dim in `tp_divisor_of` (e.g. n_kv_heads*head_dim, d_ff), then fills data.
    """
    tp = 1
    cand = 1
    while cand <= min(tp_max, n_devices):
        if all(d % cand == 0 for d in tp_divisor_of):
            tp = cand
        cand *= 2
    data = n_devices // tp
    return data, tp


@dataclasses.dataclass
class HostStat:
    ewma: float = 0.0
    var: float = 0.0
    n: int = 0
    strikes: int = 0


class StragglerMonitor:
    def __init__(self, alpha: float = 0.2, k_sigma: float = 3.0, patience: int = 5):
        self.alpha = alpha
        self.k_sigma = k_sigma
        self.patience = patience
        self.hosts: Dict[int, HostStat] = defaultdict(HostStat)

    def record(self, host: int, step_time: float) -> None:
        st = self.hosts[host]
        if st.n == 0:
            st.ewma = step_time
        else:
            delta = step_time - st.ewma
            st.ewma += self.alpha * delta
            st.var = (1 - self.alpha) * (st.var + self.alpha * delta * delta)
        st.n += 1

    def _fleet_stats(self) -> Tuple[float, float]:
        ew = [s.ewma for s in self.hosts.values() if s.n > 0]
        mu = sum(ew) / len(ew)
        var = sum((e - mu) ** 2 for e in ew) / max(len(ew) - 1, 1)
        return mu, math.sqrt(var)

    def update_strikes(self) -> None:
        mu, sigma = self._fleet_stats()
        thresh = mu + self.k_sigma * max(sigma, 1e-9) + 1e-9
        for st in self.hosts.values():
            if st.n > 0 and st.ewma > thresh:
                st.strikes += 1
            else:
                st.strikes = 0

    def stragglers(self) -> List[int]:
        self.update_strikes()
        return [h for h, st in self.hosts.items() if st.strikes >= self.patience]


@dataclasses.dataclass
class FailureEvent:
    step: int
    lost_hosts: Tuple[int, ...]


class ElasticController:
    """Glue: tracks alive hosts, plans meshes, logs decisions."""

    def __init__(self, n_hosts: int, devices_per_host: int, tp_divisor_of=()):
        self.alive = set(range(n_hosts))
        self.devices_per_host = devices_per_host
        self.tp_divisor_of = tuple(tp_divisor_of)
        self.events: List[FailureEvent] = []

    def fail(self, step: int, hosts) -> Tuple[int, int]:
        self.alive -= set(hosts)
        self.events.append(FailureEvent(step, tuple(hosts)))
        return self.current_mesh()

    def current_mesh(self) -> Tuple[int, int]:
        return plan_mesh(len(self.alive) * self.devices_per_host,
                         tp_divisor_of=self.tp_divisor_of)
