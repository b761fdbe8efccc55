"""The one traffic generator: a configuration's telemetry stream and a
traffic mix's dashboard, both drawn from the run's seed.

A configuration file describes the data (columns, latent factors, stream
size); a traffic file (`bench/traffic/<mix>.json`) describes the refresh
loop (ingest batch, the dashboard's specs).  Everything here is data-driven:
a new mix is a new JSON file, not new code.

The column model and the spec recipes are frozen copies of `chip_smoke.py`'s
`make_stream`, `interval` and `make_specs`: with that module's parameters
(one latent factor, the same columns in the same order) this draws the same
numbers from the same generator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

AGGREGATES = ("count", "sum", "avg")


def make_rows(rng: np.random.Generator, config: dict, n: int) -> Dict[str, np.ndarray]:
    """n telemetry rows of every column of `config["columns"]`, float32.

    A numeric column is `transform(base + loadings . latent + noise * z)`
    (transform "identity" or "exp"), a dictionary column (`codes`) uniform
    integer codes.  Draw order: the latent factors, each numeric column's
    noise in file order, then each dictionary column's codes."""
    latent = [rng.normal(0.0, 1.0, n) for _ in range(int(config["latent_factors"]))]
    cols: Dict[str, np.ndarray] = {}
    for col in config["columns"]:
        if "codes" in col:
            continue
        v = np.full(n, float(col["base"]))
        for w, f in zip(col.get("loadings", ()), latent):
            v = v + float(w) * f
        v = v + rng.normal(0.0, float(col["noise"]), n)
        if col.get("transform", "identity") == "exp":
            v = np.exp(v)
        cols[col["name"]] = v
    for col in config["columns"]:
        if "codes" in col:
            cols[col["name"]] = rng.integers(0, int(col["codes"]), n).astype(np.float64)
    order = [c["name"] for c in config["columns"]]
    return {k: cols[k].astype(np.float32) for k in order}


def numeric_columns(config: dict) -> List[str]:
    return [c["name"] for c in config["columns"] if "codes" not in c]


def dictionary_columns(config: dict) -> List[str]:
    return [c["name"] for c in config["columns"] if "codes" in c]


@dataclass
class Stream:
    """Set-up rows in ingest-sized batches, then the pool of window batches
    (refresh k ingests `pool[k % len(pool)]`)."""
    setup: List[Dict[str, np.ndarray]]
    pool: List[Dict[str, np.ndarray]]
    probe: Dict[str, np.ndarray]

    def refresh_batch(self, k: int) -> Dict[str, np.ndarray]:
        return self.pool[k % len(self.pool)]


def _split(rows: Dict[str, np.ndarray], size: int) -> List[Dict[str, np.ndarray]]:
    n = len(next(iter(rows.values())))
    return [{c: v[s:s + size] for c, v in rows.items()} for s in range(0, n, size)]


def make_stream(seed: int, config: dict, traffic: dict) -> Stream:
    """The run's rows: `config["stream_rows"]` at set-up and
    `traffic["pool_batches"]` batches of `traffic["ingest_rows"]` rows for
    the refreshes, from one generator seeded with `seed`.  The dashboard's
    intervals are drawn from the quantiles of the first
    `traffic["probe_rows"]` set-up rows."""
    rng = np.random.default_rng(seed)
    size = int(traffic["ingest_rows"])
    setup_rows = make_rows(rng, config, int(config["stream_rows"]))
    pool_rows = make_rows(rng, config, size * int(traffic["pool_batches"]))
    keep = ingest_columns(config, traffic)
    pool = [{c: b[c] for c in keep} for b in _split(pool_rows, size)]
    probe = {c: v[: int(traffic["probe_rows"])] for c, v in setup_rows.items()}
    return Stream(setup=_split(setup_rows, size), pool=pool, probe=probe)


def ingest_columns(config: dict, traffic: dict) -> List[str]:
    cols = traffic.get("ingest_columns", "all")
    return [c["name"] for c in config["columns"]] if cols == "all" else list(cols)


def _draw(rng, lo_q, width_q):
    """One interval's quantile levels (u, v), as chip_smoke's `interval`
    draws them."""
    u = rng.uniform(*lo_q)
    return u, min(0.999, u + rng.uniform(*width_q))


def _quantiles(probe: Dict[str, np.ndarray], wanted) -> list:
    """[(np.quantile(probe[c], u), np.quantile(probe[c], v))] for each
    (c, u, v) of `wanted`, one quantile call a column."""
    out = [None] * len(wanted)
    for col in {c for c, _, _ in wanted}:
        idx = [i for i, (c, _, _) in enumerate(wanted) if c == col]
        levels = np.quantile(probe[col], [q for i in idx for q in wanted[i][1:]])
        for k, i in enumerate(idx):
            out[i] = (float(levels[2 * k]), float(levels[2 * k + 1]))
    return out


def _columns(config: dict, sel) -> List[str]:
    if sel == "numeric":
        return numeric_columns(config)
    return [sel] if isinstance(sel, str) else list(sel)


@dataclass(frozen=True)
class SpecRow:
    """One dashboard spec as plain data: what the reference answers and what
    `to_aqp` turns into the program's AqpQuery."""
    kind: str                     # "range" | "eq" | "box"
    aggregate: str
    columns: tuple                # the predicate's column(s)
    lo: tuple
    hi: tuple
    target: int                   # axis of `columns` that SUM / AVG read


def make_dashboard(seed: int, config: dict, traffic: dict,
                   probe: Dict[str, np.ndarray]) -> List[SpecRow]:
    """The dashboard's specs, in `traffic["dashboard"]` order, drawn from
    their own generator (the seed's second stream).  Aggregates run COUNT /
    SUM / AVG in turn within each entry; a box's SUM / AVG target runs over
    its axes in turn."""
    rng = np.random.default_rng([seed, 1])
    rows: List[SpecRow] = []
    for ent in traffic["dashboard"]:
        kind = ent["kind"]
        if kind == "range":
            cols = _columns(config, ent["columns"])
            n = int(ent["per_column"]) * len(cols)
            want = [(cols[i % len(cols)],) + _draw(rng, ent["lo_q"], ent["width_q"])
                    for i in range(n)]
            for i, (w, (a, b)) in enumerate(zip(want, _quantiles(probe, want))):
                rows.append(SpecRow("range", AGGREGATES[i % 3], (w[0],), (a,), (b,), 0))
        elif kind == "eq":
            col, codes = ent["column"], int(ent["codes"])
            for i in range(int(ent["count"])):
                v = float(i % codes)
                rows.append(SpecRow("eq", AGGREGATES[i % 3], (col,), (v - 0.5,),
                                    (v + 0.5,), 0))
        elif kind == "box":
            cols = tuple(_columns(config, ent["columns"]))
            want = [(c,) + _draw(rng, ent["lo_q"], ent["width_q"])
                    for _ in range(int(ent["count"])) for c in cols]
            bounds = _quantiles(probe, want)
            for i in range(int(ent["count"])):
                box = bounds[i * len(cols):(i + 1) * len(cols)]
                rows.append(SpecRow("box", AGGREGATES[i % 3], cols,
                                    tuple(b[0] for b in box), tuple(b[1] for b in box),
                                    i % len(cols)))
        else:
            raise ValueError(f"unknown dashboard entry kind {kind!r}")
    return rows


def to_aqp(rows: Sequence[SpecRow], q) -> list:
    """The program's AqpQuery specs for `rows`; `q` is
    `repro_torch.core.aqp_query`."""
    out = []
    for r in rows:
        if r.kind == "range":
            pred = q.Range(r.columns[0], r.lo[0], r.hi[0])
            target = None
        elif r.kind == "eq":
            pred = q.Eq(r.columns[0], r.lo[0] + 0.5)
            target = None if r.aggregate == "count" else r.columns[0]
        else:
            pred = q.Box(r.columns, r.lo, r.hi)
            target = None if r.aggregate == "count" else r.columns[r.target]
        out.append(q.AqpQuery(r.aggregate, (pred,), target=target))
    return out
