#!/usr/bin/env python3
"""Where the LSCV_h grid's minimum lands on one CUDA device, at chip_smoke's
`loss` column (`make_stream(default_rng(0))`, the first n rows, 150 grid
points), for the "cuda" distributed grid (slabs of S on one NCCL rank),
the single-device kernels over the whole S (where S fits), the "torch"
backend's two forms of S ("mxu", "einsum") and a float64 oracle of the same
sums on the same float32 inputs:

    python3 scripts/lscv_argmin_check.py [--n 65536,163840] [--torch-up-to 65536]

Prints, for each n and path, its grid point, its largest g difference from
the oracle (relative) and its g at the oracle's best point and the two on
each side (g evaluated in float64 from each path's float32 sums).  The
"torch" backend and the whole-S kernels run only up to `--torch-up-to`.
Needs a CUDA device; exits non-zero without one.
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def oracle_t(torch, x, m, hg, c_k, c_kk, rows: int = 256, h_block: int = 10):
    """float64 sums over i < j of c_kk exp(-S/4h^2) - 2 c_k exp(-S/2h^2),
    S = (x_i - x_j)^2 m, for every h of hg (d = 1)."""
    xd, md = x.double()[:, 0], float(m.double()[0, 0])
    inv4 = (0.25 / hg.double() ** 2)[:, None, None]
    inv2 = (0.5 / hg.double() ** 2)[:, None, None]
    n = xd.shape[0]
    acc = torch.zeros(hg.shape[0], dtype=torch.float64, device=x.device)
    j = torch.arange(n, device=x.device)
    for a in range(0, n, rows):
        s = (xd[a:a + rows, None] - xd[None, :]) ** 2 * md
        i = torch.arange(a, min(n, a + rows), device=x.device)
        s = torch.where(i[:, None] < j[None, :], s, torch.inf)[None]
        for b in range(0, hg.shape[0], h_block):
            e4 = torch.exp(-s * inv4[b:b + h_block])
            e2 = torch.exp(-s * inv2[b:b + h_block])
            acc[b:b + h_block] += (float(c_kk) * e4 - 2.0 * float(c_k) * e2).sum(dim=(1, 2))
    return acc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", default="65536,163840")
    ap.add_argument("--torch-up-to", type=int, default=65_536)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lscv_argmin_check: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import distributed as D
    from repro_torch.core import gaussian as G
    from repro_torch.core import lscv
    from repro_torch.kernels import _build, ops
    _build.build_all()
    print(cs.card_line())
    stream = cs.make_stream(np.random.default_rng(0))
    with tempfile.TemporaryDirectory() as tmp:
        D.init_group(os.path.join(tmp, "store"), 0, 1, device="cuda")
        try:
            for n in (int(v) for v in args.n.split(",")):
                x = torch.as_tensor(stream["loss"][:n], device="cuda")[:, None]
                sigma = lscv.covariance(x)
                m = lscv._inv(sigma)
                c_k, c_kk, r_k = G.lscv_h_consts(1, torch.linalg.det(sigma))
                hg = lscv.h_grid_for(n, 1, 150, device="cuda")
                paths = {"cuda_slabs": lambda: D.sharded_lscv_h_grid(x, m, hg, c_k, c_kk,
                                                                     backend="cuda")}
                if n <= args.torch_up_to:
                    paths["cuda_whole"] = lambda: ops.lscv_grid_sums(x, m, hg, c_k, c_kk)
                    for alg in ("mxu", "einsum"):
                        paths["torch_" + alg] = (lambda alg=alg: D.sharded_lscv_h_grid(
                            x, m, hg, c_k, c_kk, backend="torch", algorithm=alg))
                paths["float64"] = lambda: oracle_t(torch, x, m, hg, c_k, c_kk)
                sums = {}
                for name, fn in paths.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sums[name] = fn()
                    torch.cuda.synchronize()
                    print(f"n={n} {name}: {time.perf_counter() - t0:.2f} s")

                def g_of(t):
                    return hg.double() ** -1 * (2.0 / (n * n) * t.double() + float(r_k) / n)

                g64 = g_of(sums["float64"])
                k64 = int(torch.argmin(g64))
                for name, t in sums.items():
                    g = g_of(t)
                    k = int(torch.argmin(g))
                    rel = float(((g - g64).abs() / g64.abs()).max())
                    near = [f"{float(v):.9g}" for v in g[max(0, k64 - 2):k64 + 3]]
                    print(f"n={n} {name}: grid point {k} (h={float(hg[k]):.6f}), max rel "
                          f"to float64 {rel:.3g}, g around float64's point {k64}: {near}")
        finally:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
