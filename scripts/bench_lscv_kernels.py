#!/usr/bin/env python3
"""Time the port's two LSCV kernels on one CUDA device, at the shapes of
chip_smoke.py's paths: gh_fused_sum at n = 32 768 with d = 3 (the joint's
LSCV_H objective, path B) and d = 1 (a column's, path D), both at H_start;
lscv_grid_sums as its grid phase alone over the S of the joint at 150 grid
points (path A).  The data is chip_smoke.py's stream from `--seed`,
subsampled to the reservoir size.

    python3 scripts/bench_lscv_kernels.py [--root DIR] [--set FILE:NAME=VALUE]
                                          [--gh-tile K] [--fits] [--label TEXT]
                                          [--sass]

`--root` times the `repro_torch` of another checkout (its kernels build
into that checkout's own `build/`), so two commits compare in one run on
one card: run parent, change, change, parent.  `--set` times a variant: it
copies the checkout's `src/repro_torch` into a temporary directory and sets
`constexpr NAME` in `csrc/FILE` to VALUE there (repeatable); `--gh-tile`
passes gh_fused_sum another tile side.  `--fits` also times, once each
after a warm-up, an LSCV_h fit and an LSCV_H fit of the joint (the fits of
paths A and B, CUDA-synced host clock).  `--sass`
prints, for every kernel function of every library built, its SFU (MUFU)
instructions by kind from `cuobjdump -sass`.

Prints one JSON line: kernel times (median of CUDA-event windows), the
sums, the share of lscv_grid's (tile, h) pairs whose every term flushes to
0, the card's name, power limit and SM clock sampled after each window.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
N = 32_768
N_H = 150


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def variant_root(root: Path, sets, tmp: Path) -> Path:
    """A copy of root's src/repro_torch with constants replaced."""
    shutil.copytree(root / "src" / "repro_torch", tmp / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for spec in sets:
        fname, assign = spec.split(":", 1)
        name, value = assign.split("=", 1)
        path = tmp / "src" / "repro_torch" / "kernels" / "csrc" / fname
        text, hits = re.subn(rf"(constexpr \w+ {re.escape(name)} = )[^;]+;",
                             rf"\g<1>{value};", path.read_text())
        if hits != 1:
            raise SystemExit(f"--set {spec}: {hits} matches in {fname}")
        path.write_text(text)
    return tmp


def joint_sample(seed: int) -> np.ndarray:
    """(N, 3) float32: loss, latency_ms, grad_norm rows of chip_smoke's
    stream, drawn without replacement."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    rng = np.random.default_rng(seed)
    stream = chip_smoke.make_stream(rng)
    rows = rng.choice(chip_smoke.STREAM_ROWS, N, replace=False)
    return np.stack([stream[c][rows] for c in chip_smoke.JOINT], 1)


def time_ms(torch, fn, reps: int, warm: int = 2) -> list:
    for _ in range(warm):
        fn()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def sass_mufu(build_dir: Path) -> dict:
    """{library: {kernel function: {MUFU kind: count}}} from cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for lib in sorted(build_dir.glob("*.so")):
        text = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                              text=True, timeout=300).stdout
        funcs = {}
        name = None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                funcs[name] = collections.Counter()
            elif name and "MUFU" in line:
                kind = re.search(r"MUFU\.(\w+)", line)
                funcs[name][kind.group(1) if kind else "?"] += 1
        out[lib.name.split("-")[0]] = {f: dict(c) for f, c in funcs.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--gh-tile", type=int, default=None,
                    help="gh_fused_sum's tile (default: the checkout's own)")
    ap.add_argument("--fits", action="store_true",
                    help="also time an LSCV_h and an LSCV_H fit of the joint")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_lscv_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        root = variant_root(args.root, args.set, Path(tmp)) if args.set else args.root
        sys.path.insert(0, str(root / "src"))
        from repro_torch.core import gaussian, lscv
        from repro_torch.kernels import _build, ops

        dev = torch.device("cuda")
        x3 = torch.as_tensor(joint_sample(args.seed), device=dev)
        res = {"label": args.label, "root": str(args.root), "set": args.set,
               "card": smi("name,power.limit"), "clocks_sm": []}
        for d in (3, 1):
            x = x3[:, :d].contiguous()
            H = lscv.h_start(x)
            h_inv = torch.linalg.inv(H).contiguous()
            c_k, c_kk, _ = gaussian.lscv_H_consts(d, torch.linalg.det(H))
            t = time_ms(torch, lambda: ops.gh_fused_sum(x, h_inv, c_k, c_kk, tile=args.gh_tile),
                        args.reps)
            res[f"gh_fused_d{d}_ms"] = float(np.median(t))
            res[f"gh_fused_d{d}_sum"] = float(ops.gh_fused_sum(x, h_inv, c_k, c_kk,
                                                                tile=args.gh_tile))
            res["clocks_sm"].append(smi("clocks.sm"))

        sigma = lscv.covariance(x3)
        s_mat = ops.sv_matrix(x3, torch.linalg.inv(sigma).contiguous())
        hg = lscv.h_grid_for(N, 3, N_H, device=dev)
        c_k, c_kk, _ = gaussian.lscv_h_consts(3, torch.linalg.det(sigma))
        t = time_ms(torch, lambda: ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk),
                    max(3, args.reps // 3))
        res["lscv_grid_ms"] = float(np.median(t))
        res["clocks_sm"].append(smi("clocks.sm"))
        sums = ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk)
        res["lscv_grid_sums_first_last"] = [float(sums[0]), float(sums[-1])]
        # (tile, h) pairs whose every term flushes: min over the tile's strict
        # upper triangle of S times -log2(e) / (4 h^2) below -126
        tile = 64
        nt = N // tile
        tmin = s_mat.view(nt, tile, nt, tile).amin(dim=(1, 3))
        iu = torch.triu_indices(nt, nt, 1, device=dev)
        off = tmin[iu[0], iu[1]]
        a_h = -0.25 * np.log2(np.e) / (hg * hg)
        res["lscv_grid_skippable_share"] = float(
            ((off[:, None] * a_h[None]) < -126).float().mean())
        if args.fits:
            # the fits around the kernels, each once after a warm-up call:
            # LSCV_h on the joint (path A's joint fit) and LSCV_H on the joint
            # (path B's fit), with the CUDA-synced wall and the evaluations
            lscv.lscv_h(x3, backend="cuda", device=dev)
            lscv.g_of_H(x3, lscv.h_start(x3), device=dev)
            for key, fit in (("lscv_h_fit", lambda: lscv.lscv_h(x3, backend="cuda", device=dev)),
                             ("lscv_H_fit", lambda: lscv.lscv_H(x3, device=dev))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fit()
                torch.cuda.synchronize()
                res[f"{key}_ms"] = (time.perf_counter() - t0) * 1e3
            res["lscv_H_nfev"] = out.nfev
            res["lscv_H_ms_per_eval"] = res["lscv_H_fit_ms"] / out.nfev
            res["clocks_sm"].append(smi("clocks.sm"))
        if args.sass:
            res["sass_mufu"] = sass_mufu(_build.BUILD_DIR)
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
