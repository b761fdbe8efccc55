"""Quickstart of the PyTorch/CUDA port: KDE-based approximate query
processing in a few lines (the port's copy of `examples/quickstart.py`).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda]
        [--rows 1000000] [--sample 2048]

Builds a KDE synopsis over a synthetic 'sales' column with each of the
paper's three bandwidth-selector classes, then answers COUNT / SUM / AVG
range queries approximately and compares them with the exact answers.  On
the CUDA device (the default; it raises without one) PLUGIN fits on the
pairwise kernel and LSCV_h on the sv_precompute and lscv_grid kernels;
`--device cpu` runs the plain PyTorch path.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.aqp import KDESynopsis  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--sample", type=int, default=2048)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    # a relation of order values, lognormal-ish (retail-like skew)
    sales = rng.lognormal(mean=3.0, sigma=0.7, size=args.rows).astype(np.float32)

    queries = [(10.0, 40.0), (20.0, 60.0), (5.0, 15.0)]
    for selector in ["silverman", "plugin", "lscv_h"]:
        syn = KDESynopsis.fit(sales, selector=selector, max_sample=args.sample, device=dev)
        print(f"\nselector = {selector}  (synopsis: {syn.x.shape[0]} points "
              f"~ {syn.x.shape[0] / sales.size:.4%} of the relation, on {dev})")
        for a, b in queries:
            c_apx = float(syn.count(a, b))
            s_apx = float(syn.sum(a, b))
            sel = (sales >= a) & (sales <= b)
            c_ex, s_ex = float(sel.sum()), float(sales[sel].sum())
            print(f"  WHERE {a:5.1f} <= sales <= {b:5.1f}  "
                  f"COUNT ~ {c_apx:12.0f} (exact {c_ex:12.0f}, "
                  f"err {abs(c_apx - c_ex) / c_ex:6.2%})   "
                  f"AVG ~ {s_apx / c_apx:7.2f} (exact {s_ex / c_ex:7.2f})")


if __name__ == "__main__":
    main()
