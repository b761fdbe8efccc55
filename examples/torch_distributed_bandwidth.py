"""Distributed bandwidth selection with the PyTorch/CUDA port: the paper's
O(n^2) selectors split over the ranks of a torch.distributed group (the
port's copy of `examples/distributed_bandwidth.py`, whose 8-device
placeholder mesh the ranks take the place of).

    PYTHONPATH=src python examples/torch_distributed_bandwidth.py [--device cuda]
        [--world 4] [--n 20000] [--n2 3000] [--d 4] [--n-h 50]

Spawns `--world` ranks that meet through a file store: gloo with
`--device cpu`, NCCL with one rank per GPU on `cuda` (the default; it
raises without enough cards).  Every rank holds the same sample, reduces its
part of the pair triangle, and one all_reduce adds the parts.  On the card,
PLUGIN's Psi sums and the LSCV_h grid run in the pairwise and lscv_grid
kernels over each rank's share of their triangle tiles.
"""
import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import gaussian as G  # noqa: E402
from repro_torch.core.lscv import lscv_h  # noqa: E402
from repro_torch.core.reductions import pairwise_reduce  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def synced(dev, fn):
    """(fn(), seconds), with the device drained before and after."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def rank_main(rank, args, store):
    dev = D.init_group(store, rank, args.world, device=args.device)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"{args.world} ranks over {dist.get_backend()} on {dev.type}")
    rng = np.random.default_rng(0)          # every rank draws the same sample
    x = torch.as_tensor(rng.normal(0, 1, args.n).astype(np.float32), device=dev)

    def fun(d):
        return G.k4(d / 0.2)

    sharded, t_dist = synced(dev, lambda: float(D.sharded_pairwise_reduce(fun, x, device=dev)))
    single, t_single = synced(dev, lambda: float(pairwise_reduce(fun, x)))
    say(f"pairwise K4 sum  n={args.n}: sharded={sharded:.4f} ({t_dist:.2f}s) "
        f"single={single:.4f} ({t_single:.2f}s) rel_err="
        f"{abs(sharded - single) / abs(single):.1e}")

    (s6, s4), t_psi = synced(dev, lambda: D.sharded_plugin_psi_sums(x, 0.3, 0.2, device=dev))
    w6 = float(ops.pairwise_scaled_ksum(x, torch.tensor(0.3, device=dev), kind="k6"))
    say(f"PLUGIN Psi6 / Psi4 sums n={args.n}: sharded={float(s6):.4f} / {float(s4):.4f} "
        f"({t_psi:.3f}s), Psi6 on one device {w6:.4f}, rel_err "
        f"{abs(float(s6) - w6) / abs(w6):.1e}")

    x2 = rng.normal(0, 1, (args.n2, args.d)).astype(np.float32)
    (h, _grid, _g), t_lscv = synced(dev, lambda: D.distributed_lscv_h(x2, n_h=args.n_h,
                                                                       device=dev))
    ref = lscv_h(x2, n_h=args.n_h, device=dev)
    say(f"distributed LSCV_h n={args.n2} d={args.d}: h={float(h):.4f} ({t_lscv:.2f}s) "
        f"(single-path h={float(ref.h):.4f})")
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--n2", type=int, default=3000)
    ap.add_argument("--d", type=int, default=4)
    ap.add_argument("--n-h", type=int, default=50)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    args.device = dev.type
    if dev.type == "cuda" and torch.cuda.device_count() < args.world:
        raise RuntimeError(f"--world {args.world} needs one GPU a rank; "
                           f"{torch.cuda.device_count()} present")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(args, os.path.join(tmp, "store")), nprocs=args.world)


if __name__ == "__main__":
    main()
