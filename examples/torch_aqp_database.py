"""Database scenario of the PyTorch/CUDA port (paper §4.3; the port's copy
of `examples/aqp_database.py`): a multi-column fact table served by KDE
synopses through the declarative API, with one `AqpQuery` spec for 1-D
ranges, multi-column boxes (eq. 11's product kernel), categorical equality
on a dictionary column and GROUP BY, all answered by one
`QueryEngine.execute` call; a 2-D box COUNT under a full LSCV_H bandwidth
matrix; streaming admission; and synopses merged across hosts.

    PYTHONPATH=src python examples/torch_aqp_database.py [--device cuda]
        [--rows 500000] [--sample 2048] [--box-sample 512] [--queries 1000]
        [--capacity 2048]

On the CUDA device (the default; it raises without one) the fits and the
answers run in the hand kernels; `--device cpu` runs the plain path.
"""
import argparse
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import AqpQuery, Box, Eq, Range  # noqa: E402
from repro_torch.core.aqp import KDESynopsis  # noqa: E402
from repro_torch.data.aqp_store import TelemetryStore  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import make_mixed_aqp_queries  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--sample", type=int, default=2048)
    ap.add_argument("--box-sample", type=int, default=512)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--capacity", type=int, default=2048)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(7)
    n = args.rows
    # fact table: amount (skewed), latency_ms (bimodal)
    amount = rng.lognormal(4.0, 0.8, n).astype(np.float32)
    latency = np.where(rng.random(n) < 0.7, rng.normal(40, 8, n),
                       rng.normal(160, 30, n)).astype(np.float32)

    print(f"== 1-D aggregates (eqs. 9-10, closed-form Gaussian integrals) on {dev} ==")
    syn_amt = KDESynopsis.fit(amount, selector="plugin", max_sample=args.sample, device=dev)
    sel = (amount >= 50) & (amount <= 150)
    print(f"COUNT(50<=amount<=150): ~{float(syn_amt.count(50, 150)):,.0f} "
          f"exact {sel.sum():,}")
    print(f"SUM  (50<=amount<=150): ~{float(syn_amt.sum(50, 150)):,.0f} "
          f"exact {amount[sel].sum():,.0f}")

    print("\n== tail query on a bimodal column (selector quality matters) ==")
    for selector in ["silverman", "plugin", "lscv_h"]:
        syn = KDESynopsis.fit(latency, selector=selector, max_sample=args.sample, device=dev)
        approx = float(syn.count(120, 250))
        exact = float(((latency >= 120) & (latency <= 250)).sum())
        print(f"  {selector:10s} COUNT(120..250) ~ {approx:9.0f} "
              f"(exact {exact:9.0f}, err {abs(approx - exact) / exact:6.2%})")

    print("\n== 2-D box count with full bandwidth matrix (LSCV_H) ==")
    joint = np.stack([np.log(amount), latency / 100.0], axis=1).astype(np.float32)
    syn2 = KDESynopsis.fit(joint, selector="lscv_H", max_sample=args.box_sample, device=dev)
    lo, hi = [3.5, 0.2], [5.0, 0.8]
    inbox = ((joint >= lo) & (joint <= hi)).all(axis=1).sum()
    print(f"COUNT(box) ~ {float(syn2.count_box(lo, hi)):,.0f} exact {inbox:,}")

    print("\n== unified engine: one mixed batch, one execute call ==")
    store = TelemetryStore(capacity=args.capacity, seed=0, device=dev)
    store.track_joint(("amount", "latency"))   # rows sampled from registration on
    # region is dictionary-coded (0=na, 1=emea, 2=apac): Eq / GROUP BY territory
    region = rng.integers(0, 3, n).astype(np.float32)
    # registered before data: Eq terms on region answer exactly from the
    # per-code frequency sketch instead of the KDE code window
    store.track_categorical("region")
    store.add_batch({"amount": amount, "latency": latency, "region": region})
    # registered after add_batch: the joint reservoir is backfilled from the
    # per-column reservoirs (marginals right away; correlations stream in)
    store.track_joint(("region", "amount"))
    queries = make_mixed_aqp_queries(
        args.queries, {"amount": (50.0, 1000.0), "latency": (20.0, 250.0)},
        ("amount", "latency"), "region", (0.0, 1.0, 2.0), seed=11)
    engine = store.engine()
    engine.execute(queries)                   # warm-up: fit synopses + compile
    t0 = time.perf_counter()
    results = engine.execute(queries)
    dt = time.perf_counter() - t0
    paths = Counter(r.path for r in results)
    print(f"answered {len(results)} mixed queries in {dt * 1e3:.1f} ms "
          f"({len(results) / dt:,.0f} queries/s) -- paths: {dict(paths)}")

    print("\n== declarative specs: box, Eq, GROUP BY in the same batch ==")
    # SQL:  SELECT COUNT(*), SUM(amount), AVG(latency) FROM facts
    #       WHERE 50 <= amount <= 300 AND 20 <= latency <= 60;
    #       SELECT COUNT(*) FROM facts WHERE region = 2;
    #       SELECT region, COUNT(*) FROM facts
    #         WHERE 50 <= amount <= 300 GROUP BY region;
    box = Box(("amount", "latency"), lo=(50.0, 20.0), hi=(300.0, 60.0))
    specs = [
        AqpQuery("count", (box,)),
        AqpQuery("sum", (box,), target="amount"),
        AqpQuery("avg", (box,), target="latency"),
        AqpQuery("count", (Eq("region", 2),)),
        AqpQuery("count", (Range("amount", 50.0, 300.0),), group_by="region"),
    ]
    res = engine.execute(specs)
    sel2 = (amount >= 50) & (amount <= 300) & (latency >= 20) & (latency <= 60)
    print(f"COUNT(*)        ~ {res[0].estimate:12,.0f}  exact {sel2.sum():12,}")
    print(f"SUM(amount)     ~ {res[1].estimate:12,.0f}  "
          f"exact {amount[sel2].sum():12,.0f}")
    print(f"AVG(latency)    ~ {res[2].estimate:12,.2f}  "
          f"exact {latency[sel2].mean():12,.2f}")
    print(f"COUNT(region=2) ~ {res[3].estimate:12,.0f}  "
          f"exact {(region == 2).sum():12,}")
    for r in res[4:]:
        ex = ((amount >= 50) & (amount <= 300) & (region == r.group)).sum()
        print(f"  region={r.group:.0f}: COUNT ~ {r.estimate:10,.0f}  "
              f"exact {ex:10,}  [{r.path}]")

    print("\n== streaming admission: futures + cross-caller micro-batches ==")
    # many logical clients submit independently; the session coalesces their
    # specs into micro-batches and flushes on a watermark or a deadline, with
    # answers bit-identical to engine.execute of the same specs
    with store.session(watermark=8, max_delay=0.005) as session:
        futures = [session.submit(q) for q in specs[:4]]
        answers = [f.result() for f in futures]
    st = session.stats()
    for r, label in zip(answers, ("COUNT(box)", "SUM(amount)",
                                  "AVG(latency)", "COUNT(region=2)")):
        print(f"  {label:16s} ~ {r.estimate:12,.2f}  [{r.path}]")
    print(f"  {st['flushes']} flushes ({st['mean_batch']:.1f} mean batch), "
          f"reasons {st['flush_reasons']}")

    print("\n== mergeable synopses across 4 'hosts' ==")
    stores = []
    for h in range(4):
        host = TelemetryStore(capacity=args.capacity // 2, seed=h, device=dev)
        host.add_batch({"latency": latency[h::4]})
        stores.append(host)
    merged = stores[0]
    for host in stores[1:]:
        merged = merged.merge(host)
    frac = merged.fraction("latency", 120, 250, selector="silverman")
    print(f"merged fraction(120..250) ~ {frac:.4f} "
          f"exact {((latency >= 120) & (latency <= 250)).mean():.4f}")


if __name__ == "__main__":
    main()
