#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--only kernel-boxes]

(`--child tuned|restore` runs it as phase T's or path H's second process.)

Phases, each failing loudly (a failed check raises; the script then exits
non-zero and prints no result line):

  1. the card (nvidia-smi) and the kernel build from `src/repro_torch/kernels/
     csrc`, one nvcc per source, all started together;
  2. the main path at full size: a `TelemetryStore` of 32 768 rows per sample
     fed 1 000 000 streamed rows, PLUGIN fits on the pairwise kernel, one
     `store.query` of 1 024 mixed Range / Box / Eq specs through the aqp_batch
     and aqp_boxes kernels (one launch per range or box group for its
     estimate and CI sums, no separate moment pass); answers held against a
     float64 closed form of the same synopses and against exact counts of the
     stream, launch counts read, and the batch repeated for bit-identical
     answers from the caches;
  3. path A, the same store and specs with `selector="lscv_h"`: LSCV_h fits
     (two columns and the 3-column joint, 150 grid points each) on the
     sv_precompute and lscv_grid kernels, answers on aqp_batch / aqp_boxes,
     launch counts read for the first query and its bit-identical repeat;
  4. path B, `store.joint_synopsis(joint, selector="lscv_H")`: Nelder-Mead
     (150 iterations) with one gh_fused launch per objective evaluation; H
     SPD and g(H) <= g(H_start);
  5. path C, GROUP BY: 104 GROUP BY specs over the 64-code model_id column
     through a joint that holds it, one aqp_grouped launch for all the
     families (estimates and CI moment sums); each family held against its
     boxes fanned out through a float64 oracle and against the stream's
     exact per-code counts within the CIs; a bit-identical repeat with no
     fit launches;
  6. path D, full-H serving: the 1 024-spec mix with `selector="lscv_H"`
     (the joint's fit cached from path B, the two 1-D columns fitted on
     gh_fused), every group on the RFF density synopsis ("auto" at 32 768
     rows: rff_eval launches), then the same specs with
     `kde_backend="exact"` (qmc_reduce launches); the exact answers held
     against a float64 oracle of eq. 6 on the same Halton nodes, the RFF
     answers against the exact ones within their CIs; one rff_eval launch
     per RFF group (the estimate and its 8 feature blocks) beside one probe
     per fit, and one qmc_reduce launch per exact group (the estimate and its
     8 CI chunks); bit-identical repeats;
  7. path E, `kde_eval` at 4 096 points on a 1-D sample and on the joint,
     and the trapezoid forms of eqs. 9-10 on 64 ranges against the closed
     forms (kde_eval launches); a point's density has the same bits alone
     and inside its grid;
  8. path F, progressive serving: a second store fed the same stream in the
     same batches, laid out as launch/serve.py's (four-tier reservoirs of
     4 096 to 32 768 rows on loss, latency_ms and the joint, a count-min
     sketch on model_id); the 1 024 specs through `store.query(specs,
     mode="progressive")`, four PLUGIN rounds, each fitting its tier on the
     pairwise kernel and answering on one aqp_batch launch per range group
     and one aqp_boxes launch; every round held against float64 closed
     forms of its tier's synopses, n_effective equal to the tier size, the
     median CI width never widening, the Eq specs on "exact:cm" with the
     stream's exact answers inside their intervals, the final round
     bit-identical to `store.query(specs)`; launches per round, the rounds'
     CUDA-synced walls (first run and warm repeats) and device ms
     (torch.profiler); every path-F launch of the three kernels held
     against its plain version, and their times, bounds and grids at the
     tier shapes;
  9. path G, admission serving: a third store of launch/serve.py's layout
     (four-tier ladders on loss, latency_ms and their joint, the exact
     model_id sketch) fed the same stream; (a) serve's closed loop, 8
     client threads x 128 specs of the port's `make_mixed_aqp_queries`
     into one `engine.session(watermark=8, max_delay=0.005)` on "cuda"
     with no producer, then a GROUP BY spec: every answer bit-identical to
     one `engine.execute` of the same specs, one aqp_batch / aqp_boxes /
     aqp_grouped launch per range / box / GROUP BY flush, no plain-version
     call, Eq counts exact; (b) the same with fullh_frac = 0.1, whose
     full-H answers (Halton nodes over each micro-batch's hull) replay
     bit for bit per flush and agree with the execute's within half a CI;
     (c) (a) with `obs.enable()`: the same bits, kernel.wall_us for every
     launched kernel, the exported metrics through
     `scripts/validate_metrics.py`; device ms per flush from
     torch.profiler; (d) `python -m repro_torch.launch.serve --mode aqp`
     at this size with its streaming producer, exit 0; and the range,
     box, GROUP BY and RFF kernels giving a query's bits alone at q = 8 as
     inside the main path's launches (qmc_reduce where both cut the same
     node slices), with their device ms at q = 8;
 10. phase T, tile tuning: `repro_torch.kernels.autotune.sweep` on the card
     at path F's tier-0 shapes, path G's micro-batch shapes, the main
     path's pairwise and 3-D box shapes and path D's full-H shapes (CUDA
     events, device time a launch, the module constants as candidate 0),
     each winner printed beside the constants with both times, the range
     kernels' winners also timed at another batch (their cache key has no
     batch); the cache saved and passed by `scripts/validate_metrics.py
     --tuning`; path G (a) again under the cache, its sessions bit-identical
     to one execute; the main path's specs on a fresh store under the
     cache, within the parity tolerances of the untuned answers and
     bit-identical to a second process (`--child tuned`) that loads the
     cache with no sweep; then the cache is dropped;
 11. path H, a warm restart: path G's store, with its "cuda" fits and plain
     ("torch") fits added, answers (a)'s and (b)'s specs through its shared
     engines and is saved (`store.save`); a second process (`--child
     restore`) loads it on the card and answers the same specs with the
     same bits, no synopsis or plan cache miss, no fit launch, no plain
     version, one launch a group; both add the same batch and their
     reservoirs and sketches stay bit-identical; then the serve CLI at full
     size with `--snapshot-dir` and again with `--restore`, which prints
     its durability line, misses no synopsis and launches no fit kernel;
 12. phase I, beyond the paper: the binned PLUGIN (`core/binned.py`) on the
     1 000 000 streamed rows of loss, g = 1024, twice with the same bits,
     against its plain version on the CPU and within 2 % of the exact
     PLUGIN h of the pairwise kernel on the same rows; the four shares of a
     world of 4 (`triangle.share`) launched in one process and summed
     against one whole pairwise (K6, K4) and lscv_grid launch, with one
     share's time beside the whole's; the distributed selectors
     (`core/distributed.py`) on "cuda" over NCCL with one rank and a file
     store, each call's launches counted (2 pairwise; one sv_matrix slab
     and one lscv_grid launch a run of the slab walk), no plain version,
     against the single-device kernels; the slabbed LSCV_h at n = 163 840
     (a whole S of 107 GB) within the slab budget plus 1 GB of peak memory,
     its g at n = 65 536 against the "torch" backend's, a slab against the
     whole S's bits, its two launches timed beside their bounds; and the
     three torch examples, each a process of its own;
 13. phase L, LM serving (the LM stack reaches no hand kernel: every launch
     count stays 0): (a) `launch/serve.run_lm` on llama3.2-1b at its full
     published config in bf16, batch 4, prompt 128, 32 new tokens, twice,
     with the same tokens and logits bits; the logits each token was chosen
     from against the teacher-forced `apply` at the reference's bf16
     tolerance; prefill and decode step timed (CUDA events, device ms and
     kernels from torch.profiler) beside their bounds; (b) a float32 copy of
     its first 2 layers at full width on the card and on the CPU, prefill
     and 8 decode steps held at the CPU parity tests' tolerance; (c) every
     other architecture at full width with its depth cut (`L_DEPTH`):
     prefill and 8 greedy decode steps, finite logits, decode against
     `apply` (MoE also with capacity_factor = E / k, where nothing is
     dropped); the serve CLI in LM mode at (a)'s size as a process of its own;
 14. phase R, LM training (no hand kernel either; launch counts read and
     printed): (a) `launch/train.run_train` on llama3.2-1b at its full
     published config in bf16 with remat "nothing", batch 8 x 512 in 2
     microbatches, 10 steps, twice from seed 0, with the same loss,
     grad-norm and parameter bits; the forward-backward, the AdamW update
     and a whole step timed apart (CUDA events) beside their bounds, a
     step's device ms by kernel kind (torch.profiler), tokens/s, peak
     memory against 16 bytes a parameter; (b) a float32 copy of its first 2
     layers at full width, one step (2 microbatches) on the card and on the
     CPU on the same pipeline batch: loss, grad norm, m, v and the
     parameters at the CPU parity tests' tolerances; (c) every other
     architecture at full width with `R_DEPTH`'s cuts: one batch's
     gradients with remat on and off (the same bits), then 2 train steps
     with finite losses and grad norms; (d) `python -m
     repro_torch.launch.train` on the smoke config crashing at step 6 (exit
     42), resuming from its step-4 checkpoint and ending with the same
     checkpoint bits as an uninterrupted run; (e) `compressed_psum` on one
     NCCL rank, each leaf the quantise-dequantise of g + e, the residual
     carried into a second call;
 15. phase M, the LM stack on a device mesh (no hand kernel; launch counts
     read, none expected): (a) llama3.2-1b at full size, phase R (a)'s
     batch, its parameters DTensors on a 1 x 1 NCCL mesh (one rank, a file
     store) under the train specs with `param_constraint` the serve specs,
     2 steps from seed 0 with the same loss, grad-norm and parameter bits
     as `run_train`'s unsharded steps on the same batches (else the op and
     the largest difference are printed and phase R (b)'s tolerances
     hold), and the steps' peak memory; (b) `spmd_pipeline` on that rank,
     one stage of its 16 blocks at full width, 4 microbatches, the same
     bits as the blocks applied in order; (c) `python -m
     repro_torch.launch.dryrun` for llama3.2-1b x train_4k and x
     decode_32k on the 16 x 16 mesh, granite-moe-1b-a400m x decode_32k on
     2 x 16 x 16 and `--kde 1048576,4,150`, each a process of its own
     started before (a), every record ok, llama3.2-1b decode_32k under
     10 MB of collectives a device (the vocab-parallel embedding lookup);
     (d) `dryrun.lower_cell` on a fake 1 x 1 mesh at (a)'s shape, its
     argument + temp bytes within 15 % of (a)'s measured peak, the H100
     roofline terms of that step beside its measured time;
 16. phase K, the kernel-centred box kernel (`--only kernel-boxes` runs the
     card line, the build and this phase alone): `draw_box_reduce` against
     its plain version at the cell `joint8.lscv_H.kernel`'s shape (m = 16
     384 rows, 64 draws a row, 128 boxes, d = 8, 8 CI chunks) and at edge
     shapes (d = 1..8; m = 1, 2, 513; 0, 8 and 16 chunks), two launches
     with the same bits, a draw on a face counted, one launch a call, and
     the kernel and plain-version times at the cell's shape beside the
     bound;
 17. every kernel against its plain PyTorch version on the card, on the
     very inputs of its calls on those paths (recorded while they ran), at
     an extra shape and at edge shapes, and against a float64 oracle on a
     subsample (aqp_batch / aqp_boxes: all five sums of every call of the
     main path and path A, and ranges far out in both tails, with their
     answers and CI bounds against the "torch" backend's separate passes);
     two launches of every kernel but sv_matrix on the same inputs giving
     the same bits; kde_eval also on data far from 0 against float64;
     PLUGIN and LSCV_h against the paper's sequential oracles; the kernel's
     own eqs. 49/50 tile mapping exhaustively; gh_fused_sums through an
     LSCV_H fit's launch plan on path B's first and last batches, and the
     median `lscv_H.round_trip_host_us` of a d = 3 and a d = 8 fit;
 18. kernel and plain-version times (CUDA events, median of warm runs) on
     the inputs of each kernel's first call on its path (the largest call
     for rff_density, whose first call is the probe gate's; for
     gh_fused_sum path B's first batch of bandwidths and path D's first
     1-D batch, each through `gh_fused_sums` as the fit launches it, for qmc_box_reduce also the
     joint's d = 3 call of path D exact, for kde_eval also the joint's grid
     and a 513-point trapezoid grid), beside the bound and the SFU floor at
     the SM clock read after the kernel's windows.

It prints a {"path_f": {...}} line (the rounds' walls, device ms and CI
widths), a {"path_g": {...}} line (queries/s, flushes by reason, mean
batch, p50 / p99 of aqp.query.latency_us, device ms per flush, the serve
CLI's line, the card), a {"phase_t": {...}} line (each sweep's winner and
constants with their device times, the card), a {"path_h": {...}} line
(save ms, load ms, the snapshot's bytes, the restored launches, the serve
runs, the card), a {"phase_i": {...}} line (the binned and exact PLUGIN
times, the shares and their times, the distributed calls, the slabbed
LSCV_h's peak, runs and times, the examples' seconds, the card), a {"phase_l": {...}} line (run_lm's times, tokens/s and
bounds, the float32 copy's card-CPU difference, each other architecture's
depth, times and error, the CLI's line, the card), a {"phase_r": {...}}
line (the steps' losses, grad norms and times, the step's parts against
their bounds, peak memory, the float32 copy's differences, each other
architecture's depth and steps, the restart's times, the card), a
{"phase_m": {...}} line (the sharded steps' losses, times and peak, the
pipeline's time, each dry-run cell's dominant term, GB a device and trace
seconds, the traced bytes against the peak, the card), a {"phase_k":
{...}} line (phase K's cases, largest count error, launches, kernel and
plain times, bound and roofline share, the card), a
{"path_f_kernels":
[...]} line (the path-F kernels at n = 4 096),
a {"kernels": [...]} JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA
device, and when run without the repository around it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

CAPACITY = 32_768          # per-column sample: bench_plugin.py's largest n
STREAM_ROWS = 1_000_000
BATCH_ROWS = 50_000
N_CODES = 64
NUMERIC = ("loss", "latency_ms", "grad_norm", "tokens")
JOINT = ("loss", "latency_ms", "grad_norm")
RANGE_COLS = ("loss", "latency_ms")
N_RANGE, N_BOX, N_EQ = 512, 384, 128
GJOINT = ("loss", "latency_ms", "model_id")     # path C's joint, with the group column
N_GROUP, N_GROUP_SELF = 96, 8                   # GROUP BY specs; AVG of model_id itself
N_E_POINTS, N_E_RANGES = 4096, 64               # path E

# tests/test_kernels.py tolerances
PAIR_RTOL = 3e-4
AQP_RTOL, CNT_ATOL, SUM_ATOL = 1e-4, 1e-5, 1e-4
SV_RTOL, SV_ATOL = 1e-3, 1e-3
GRID_RTOL, GRID_ATOL = 1e-3, 1e-3
GH_RTOL, GH_ATOL = 5e-4, 1e-4
QMC_RTOL, QMC_ATOL = 1e-5, 1e-6    # atol relative to the call's largest |sum| (see below)
RFF_RTOL, RFF_ATOL = 2e-5, 2e-5
KDE_RTOL, KDE_ATOL = 5e-4, 1e-7

# the device of paths C-E and their checks ("cpu" only to rehearse them at a
# small size with the plain versions)
DEV = "cuda"

# H100 SXM published peaks: FP32 outside the tensor cores (an FMA counts
# as two FLOPs), HBM3 bandwidth; SFU (MUFU) lanes: 16 per SM x 132 SMs
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SFU_LANES = 16 * 132

TPU_KERNELS = {
    "pairwise_scaled_ksum": ("src/repro_torch/kernels/csrc/pairwise_reduce.cu",
                             "src/repro/kernels/pairwise_reduce.py:73"),
    "aqp_batch_sums": ("src/repro_torch/kernels/csrc/aqp_batch.cu",
                       "src/repro/kernels/aqp_batch.py:78"),
    "aqp_box_sums": ("src/repro_torch/kernels/csrc/aqp_boxes.cu",
                     "src/repro/kernels/aqp_boxes.py:95"),
    "sv_matrix": ("src/repro_torch/kernels/csrc/sv_precompute.cu",
                  "src/repro/kernels/sv_precompute.py:88"),
    "lscv_grid_sums": ("src/repro_torch/kernels/csrc/lscv_grid.cu",
                       "src/repro/kernels/lscv_grid.py:91"),
    "gh_fused_sum": ("src/repro_torch/kernels/csrc/gh_fused.cu",
                     "src/repro/kernels/gh_fused.py:73"),
    "aqp_grouped_sums": ("src/repro_torch/kernels/csrc/aqp_grouped.cu",
                         "src/repro/kernels/aqp_grouped.py:115"),
    "qmc_box_reduce": ("src/repro_torch/kernels/csrc/qmc_reduce.cu",
                       "src/repro/kernels/qmc_reduce.py:112"),
    "rff_density": ("src/repro_torch/kernels/csrc/rff_eval.cu",
                    "src/repro/kernels/rff_eval.py:64"),
    "kde_eval": ("src/repro_torch/kernels/csrc/kde_eval.cu",
                 "src/repro/kernels/kde_eval.py:72"),
}
# the path whose launches each kernel's "launches" reports
KERNEL_PATH = {"pairwise_scaled_ksum": "plugin", "aqp_batch_sums": "plugin",
               "aqp_box_sums": "plugin", "sv_matrix": "A", "lscv_grid_sums": "A",
               "gh_fused_sum": "B", "aqp_grouped_sums": "C", "qmc_box_reduce": "D exact",
               "rff_density": "D", "kde_eval": "E"}
# the ops wrappers that launch each kernel: the engine runs a range or box
# group's estimate with its CI sums, a GROUP BY group's families, a full-H
# group's estimate with its CI chunks, and an RFF group's estimate with its
# feature blocks through the batched wrappers
WRAPPERS = {name: (name,) for name in TPU_KERNELS}
WRAPPERS["aqp_batch_sums"] = ("aqp_batch_sums", "aqp_batch_moments")
WRAPPERS["aqp_box_sums"] = ("aqp_box_sums", "aqp_box_moments")
WRAPPERS["aqp_grouped_sums"] = ("aqp_grouped_sums", "aqp_grouped_moments")
WRAPPERS["qmc_box_reduce"] = ("qmc_box_reduce", "qmc_box_reduce_split")
WRAPPERS["rff_density"] = ("rff_density", "rff_density_blocks")
WRAPPERS["gh_fused_sum"] = ("gh_fused_sum", "gh_fused_sums")


def wrapper_launches(name: str, args) -> int:
    """Launches one recorded wrapper call makes: `gh_fused_sums` one per row
    of its params, any other wrapper one."""
    return args[1].shape[0] if name == "gh_fused_sums" else 1


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def close(a, b, rtol: float, atol: float) -> tuple:
    """(all within |a-b| <= atol + rtol |b|, max abs error)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = np.abs(a - b)
    return bool(np.all(err <= atol + rtol * np.abs(b))), float(err.max(initial=0.0))


@contextlib.contextmanager
def recording(ops):
    """Keep the arguments of every call made to an `ops` wrapper while the
    block runs, so each kernel is held and timed on exactly the inputs the
    main path gave it.  The launch counters live in the launchers and are
    not touched."""
    names = [w for ws in WRAPPERS.values() for w in ws]
    calls = {name: [] for name in names}
    originals = {name: getattr(ops, name) for name in names}

    def keep(name):
        def wrapper(*args, **kwargs):
            kept_args, kept_kw = args, kwargs
            if kwargs.get("plan") is not None:
                # an LSCV_H fit's plan: its rows are rewritten every round
                # trip, so keep a copy of this batch's, replayed without it
                kept_args = (args[0], args[1].clone()) + args[2:]
                kept_kw = {k: v for k, v in kwargs.items() if k != "plan"}
            calls[name].append((kept_args, kept_kw))
            return originals[name](*args, **kwargs)
        return wrapper

    for name in names:
        setattr(ops, name, keep(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)


def call_shape(name: str, args, kwargs) -> str:
    if name == "pairwise_scaled_ksum":
        return f"n={args[0].shape[0]} {kwargs.get('kind', args[2] if len(args) > 2 else 'k4')}"
    if name in ("aqp_batch_sums", "aqp_batch_moments"):
        return f"q={args[2].shape[0]} n={args[0].shape[0]}"
    if name in ("aqp_box_sums", "aqp_box_moments"):
        return f"q={args[2].shape[0]} n={args[0].shape[0]} d={args[0].shape[1]}"
    if name == "lscv_grid_sums":
        return f"n={args[0].shape[0]} d={args[0].shape[1]} n_h={args[2].shape[0]}"
    if name == "aqp_grouped_sums":
        return (f"G={args[4].shape[0]} n={args[0].shape[0]} d={args[0].shape[1]} "
                f"g_axis={args[6]} tgt={args[7]}")
    if name == "aqp_grouped_moments":
        n_self = sum(int(g) == int(t) for g, t in zip(args[7], args[8]))
        return (f"F={args[2].shape[0]} ({n_self} with the group axis as target) "
                f"W={args[4].shape[0]} Gmax={args[4].shape[1]} n={args[0].shape[0]} "
                f"d={args[0].shape[1]}")
    if name in ("qmc_box_reduce", "qmc_box_reduce_split"):
        splits = f" splits={args[7]}" if len(args) > 7 else ""
        return (f"q={args[4].shape[0]} m={args[0].shape[0]} n={args[1].shape[0]} "
                f"d={args[1].shape[1]}{splits}")
    if name in ("rff_density", "rff_density_blocks"):
        blocks = f" blocks={args[4]}" if len(args) > 4 else ""
        return f"m={args[0].shape[0]} D={args[1].shape[0]} d={args[0].shape[1]}{blocks}"
    if name == "kde_eval":
        return f"m={args[0].shape[0]} n={args[1].shape[0]} d={args[1].shape[-1]}"
    if name == "gh_fused_sums":
        return f"B={args[1].shape[0]} n={args[0].shape[0]} d={args[0].shape[1]}"
    return f"n={args[0].shape[0]} d={args[0].shape[1]}"


# --- data and query mix ------------------------------------------------------

def make_stream(rng: np.random.Generator):
    """Telemetry rows: a latent factor shared by normal and lognormal
    columns (correlated joint axes), and a 64-code dictionary column."""
    latent = rng.normal(0.0, 1.0, STREAM_ROWS)
    cols = {
        "loss": 2.0 + 0.5 * latent + rng.normal(0.0, 0.4, STREAM_ROWS),
        "latency_ms": np.exp(3.0 + 0.3 * latent + rng.normal(0.0, 0.3, STREAM_ROWS)),
        "grad_norm": 1.0 + 0.3 * latent + rng.normal(0.0, 0.5, STREAM_ROWS),
        "tokens": np.exp(5.0 + rng.normal(0.0, 0.6, STREAM_ROWS)),
        "model_id": rng.integers(0, N_CODES, STREAM_ROWS).astype(np.float64),
    }
    return {k: v.astype(np.float32) for k, v in cols.items()}


def interval(rng, data: np.ndarray, lo_q=(0.02, 0.6), width_q=(0.05, 0.4)):
    u = rng.uniform(*lo_q)
    v = min(0.999, u + rng.uniform(*width_q))
    return float(np.quantile(data, u)), float(np.quantile(data, v))


def make_specs(rng, stream, q):
    """512 Range (two columns), 384 Box (the joint) and 128 Eq specs, each
    COUNT / SUM / AVG in turn."""
    aggs = ("count", "sum", "avg")
    probe = {c: stream[c][:200_000] for c in NUMERIC}
    specs = []
    for i in range(N_RANGE):
        col = RANGE_COLS[i % 2]
        a, b = interval(rng, probe[col])
        specs.append(q.AqpQuery(aggs[i % 3], (q.Range(col, a, b),)))
    for i in range(N_BOX):
        bounds = [interval(rng, probe[c], lo_q=(0.0, 0.4), width_q=(0.4, 0.9))
                  for c in JOINT]
        agg = aggs[i % 3]
        box = q.Box(JOINT, tuple(b[0] for b in bounds), tuple(b[1] for b in bounds))
        specs.append(q.AqpQuery(agg, (box,),
                                target=None if agg == "count" else JOINT[i % 3]))
    for i in range(N_EQ):
        agg = aggs[i % 3]
        specs.append(q.AqpQuery(agg, (q.Eq("model_id", float(i % N_CODES)),),
                                target=None if agg == "count" else "model_id"))
    return specs


def make_group_specs(rng, stream, q):
    """Path C: 96 GROUP BY specs over model_id, COUNT / SUM / AVG in turn
    (SUM and AVG of loss) under a Range on loss and one on latency_ms, then
    8 AVG of model_id itself (the group axis as the target)."""
    aggs = ("count", "sum", "avg")
    probe = {c: stream[c][:200_000] for c in RANGE_COLS}
    specs = []
    for i in range(N_GROUP + N_GROUP_SELF):
        preds = tuple(q.Range(c, *interval(rng, probe[c], lo_q=(0.0, 0.4), width_q=(0.4, 0.9)))
                      for c in RANGE_COLS)
        if i < N_GROUP:
            agg = aggs[i % 3]
            target = None if agg == "count" else "loss"
        else:
            agg, target = "avg", "model_id"
        specs.append(q.AqpQuery(agg, preds, target=target, group_by="model_id"))
    return specs


# --- float64 oracles ---------------------------------------------------------

def oracle_batch(x, h, a, b):
    from scipy.special import ndtr
    x = np.asarray(x, np.float64)
    za = (np.asarray(a, np.float64)[:, None] - x[None]) / h
    zb = (np.asarray(b, np.float64)[:, None] - x[None]) / h
    d_Phi = ndtr(zb) - ndtr(za)
    d_phi = (np.exp(-0.5 * zb * zb) - np.exp(-0.5 * za * za)) / math.sqrt(2 * math.pi)
    return d_Phi.sum(1), (x[None] * d_Phi - h * d_phi).sum(1)


def oracle_boxes(x, h, lo, hi, tgt):
    from scipy.special import ndtr
    x = np.asarray(x, np.float64)
    h = np.asarray(h, np.float64)
    za = (np.asarray(lo, np.float64)[:, None, :] - x[None]) / h
    zb = (np.asarray(hi, np.float64)[:, None, :] - x[None]) / h
    d_Phi = ndtr(zb) - ndtr(za)
    d_phi = (np.exp(-0.5 * zb * zb) - np.exp(-0.5 * za * za)) / math.sqrt(2 * math.pi)
    moment = x[None] * d_Phi - h * d_phi
    sel = np.arange(x.shape[1])[None, None, :] == np.asarray(tgt)[:, None, None]
    return (np.prod(d_Phi, 2).sum(1),
            np.prod(np.where(sel, moment, d_Phi), 2).sum(1))


def oracle_pairwise(x, g, kind):
    x = np.asarray(x, np.float64)
    total = 0.0
    for s in range(0, x.shape[0], 1024):
        t = (x[s:s + 1024, None] - x[None]) / g
        t2 = t * t
        ph = np.exp(-0.5 * t2) / math.sqrt(2 * math.pi)
        poly = (t2 - 6) * t2 + 3 if kind == "k4" else ((t2 - 15) * t2 + 45) * t2 - 15
        i = s + np.arange(t.shape[0])
        total += float(np.where(i[:, None] < np.arange(x.shape[0])[None], poly * ph, 0).sum())
    return total


# --- phases ------------------------------------------------------------------

def build_store(args, rt, q):
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    stream = make_stream(rng)
    store = rt["store"].TelemetryStore(capacity=CAPACITY, seed=args.seed)
    check(store.device.type == DEV, f"store landed on {store.device}")
    store.track_joint(JOINT)
    store.track_joint(GJOINT)
    store.track_categorical("model_id")
    for s in range(0, STREAM_ROWS, BATCH_ROWS):
        store.add_batch({k: v[s:s + BATCH_ROWS] for k, v in stream.items()})
    specs = make_specs(rng, stream, q)
    gspecs = make_group_specs(rng, stream, q)
    print(f"store: {STREAM_ROWS} rows streamed in {BATCH_ROWS}-row batches, "
          f"{len(specs)} specs and {len(gspecs)} GROUP BY specs, "
          f"set-up {time.perf_counter() - t0:.2f} s")
    return store, specs, gspecs, stream


def driven(torch, ops, what: str, fn):
    """Run one path with every launch count set to 0 just before it and read
    just after, recording each kernel wrapper's calls; returns (result,
    seconds, counts, calls)."""
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording(ops) as calls:
        out = fn()
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"{what}: {sec * 1e3:.1f} ms; launches {counts}")
    for kernel, wrappers in WRAPPERS.items():
        made = sum(wrapper_launches(w, a) for w in wrappers for a, _ in calls[w])
        check(made == counts[kernel],
              f"{what}: {kernel}: {made} wrapper calls but {counts[kernel]} launches")
    for name, made in calls.items():
        shapes = [call_shape(name, a, k) for a, k in made]
        if len(set(shapes)) == 1 and len(shapes) > 3:
            print(f"{what}: calls of {name}: {len(shapes)} x {shapes[0]}")
        elif shapes:
            print(f"{what}: calls of {name}: {', '.join(shapes)}")
    return out, sec, counts, calls


def check_answers(store, specs, stream, res, selector: str, suffix: str,
                  tier=None, eq_path: str = "exact") -> np.ndarray:
    """Every answer finite and inside its CI, each spec on its path; the
    first 32 specs of each range column and 48 boxes held against a float64
    closed form of the same synopses (of `tier`, for a tiered store's
    round); Eq answers equal to exact counts of the stream, or on a
    count-min path (`eq_path` "exact:cm") the exact answer inside the
    interval of the sketch's over-count bound."""
    check(len(res) == len(specs), "one result per spec")
    est = np.asarray([r.estimate for r in res])
    lo = np.asarray([r.ci_lo for r in res])
    hi = np.asarray([r.ci_hi for r in res])
    check(bool(np.all(np.isfinite(est))), f"{selector}: non-finite estimate")
    check(bool(np.all((lo <= est) & (est <= hi))), f"{selector}: an estimate outside its CI")
    paths = [r.path for r in res]
    check(set(paths[:N_RANGE]) == {"range1d" + suffix}, f"range paths {set(paths[:N_RANGE])}")
    check(set(paths[N_RANGE:N_RANGE + N_BOX]) == {"box" + suffix}, "box paths")
    check(set(paths[N_RANGE + N_BOX:]) == {eq_path}, f"Eq paths {set(paths[N_RANGE + N_BOX:])}")

    for col in RANGE_COLS:
        syn = store.synopsis(col, selector, tier=tier)
        idx = [i for i in range(N_RANGE) if specs[i].predicates[0].column == col][:32]
        a = [specs[i].predicates[0].a for i in idx]
        b = [specs[i].predicates[0].b for i in idx]
        c64, s64 = oracle_batch(syn.x.cpu().numpy(), float(syn.h), a, b)
        scale = syn.n_source / syn.x.shape[0]
        want = []
        for j, i in enumerate(idx):
            cnt, sm = scale * c64[j], scale * s64[j]
            want.append({"count": cnt, "sum": sm}.get(specs[i].aggregate,
                                                      sm / cnt if cnt > 1e-3 else 0.0))
        ok, err = close(est[idx], want, 1e-4, 1e-3)
        check(ok, f"{selector}: range1d{suffix} answers on {col} vs float64 (max err {err})")
    syn = store.joint_synopsis(JOINT, selector, tier=tier)
    idx = list(range(N_RANGE, N_RANGE + 48))
    boxes = [specs[i].predicates[0] for i in idx]
    tgt = [0 if specs[i].target is None else JOINT.index(specs[i].target) for i in idx]
    c64, s64 = oracle_boxes(syn.x.cpu().numpy(), syn.h_diag().cpu().numpy(),
                            [bx.lo for bx in boxes], [bx.hi for bx in boxes], tgt)
    scale = syn.n_source / syn.x.shape[0]
    want = []
    for j, i in enumerate(idx):
        cnt, sm = scale * c64[j], scale * s64[j]
        want.append({"count": cnt, "sum": sm}.get(specs[i].aggregate,
                                                  sm / cnt if cnt > 1e-3 else 0.0))
    ok, err = close(est[idx], want, 1e-4, 1e-3)
    check(ok, f"{selector}: box{suffix} answers vs float64 (max err {err})")
    codes = stream["model_id"]
    for i in range(N_RANGE + N_BOX, len(specs)):
        v = specs[i].predicates[0].value
        cnt = int(np.sum(codes == np.float32(v)))
        want = {"count": float(cnt), "sum": float(v * cnt)}.get(
            specs[i].aggregate, v if cnt else 0.0)
        if eq_path == "exact":
            check(est[i] == want, f"exact answer {est[i]} != {want}")
        else:
            check(lo[i] <= want <= hi[i],
                  f"{eq_path} spec {i}: exact answer {want} outside [{lo[i]}, {hi[i]}]")
    return est


def repeat_query(torch, ops, store, specs, res, selector: str, what: str) -> dict:
    """The same batch again: plans and fits from the caches, no fit
    launches, bit-identical answers."""
    misses = store.cache.stats()["misses"]
    res2, sec, counts, _ = driven(torch, ops, f"{what} repeat query (cached fits)",
                                  lambda: store.query(specs, selector=selector))
    same = all(r.estimate == r2.estimate and r.ci_lo == r2.ci_lo and r.ci_hi == r2.ci_hi
               and r.path == r2.path for r, r2 in zip(res, res2))
    check(same, f"{what}: repeat query not bit-identical")
    fit_kernels = ("pairwise_scaled_ksum", "sv_matrix", "lscv_grid_sums", "gh_fused_sum")
    check(store.cache.stats()["misses"] == misses
          and all(counts[k] == 0 for k in fit_kernels),
          f"{what}: repeat query refitted instead of using the cached fits")
    print(f"{what} repeat query: bit-identical answers")
    return counts


@contextlib.contextmanager
def moment_passes(query_mod):
    """Count the engine's calls of the separate CI moment passes
    (`moments_1d`, `moments_box`) while the block runs."""
    names = ("moments_1d", "moments_box")
    made = dict.fromkeys(names, 0)
    originals = {name: getattr(query_mod, name) for name in names}

    def counted(name):
        def wrapper(*args, **kwargs):
            made[name] += 1
            return originals[name](*args, **kwargs)
        return wrapper

    for name in names:
        setattr(query_mod, name, counted(name))
    try:
        yield made
    finally:
        for name, fn in originals.items():
            setattr(query_mod, name, fn)


def check_one_launch_per_group(counts, calls, passes, what: str) -> None:
    """Each range group (one per range column) and the box group answered
    its estimate and CI from one moments launch (the recorded `calls`, where
    given, all of the moments wrappers), with no moment pass."""
    check(counts["aqp_batch_sums"] == len(RANGE_COLS) and counts["aqp_box_sums"] == 1
          and (calls is None or (len(calls["aqp_batch_moments"]) == len(RANGE_COLS)
                                 and len(calls["aqp_box_moments"]) == 1)),
          f"{what}: aqp_batch / aqp_boxes launches {counts['aqp_batch_sums']} + "
          f"{counts['aqp_box_sums']}, expected {len(RANGE_COLS)} + 1 moments launches")
    check(passes == {"moments_1d": 0, "moments_box": 0},
          f"{what}: the engine ran the separate CI moment passes {passes}")


def main_path(torch, rt, store, specs, stream):
    """The PLUGIN path (PR 11's main path)."""
    ops = rt["ops"]
    with moment_passes(rt["query"]) as passes:
        res, _, counts, calls = driven(torch, ops,
                                       "main path (PLUGIN) first query, fits included",
                                       lambda: store.query(specs))
    check_answers(store, specs, stream, res, "plugin", ":cuda")
    n_axes = len(RANGE_COLS) + len(JOINT)
    check(counts["pairwise_scaled_ksum"] == 2 * n_axes,
          f"pairwise launched {counts['pairwise_scaled_ksum']} times, not Psi6 and Psi4 for "
          f"each of {n_axes} axes")
    check_one_launch_per_group(counts, calls, passes, "main path")
    with moment_passes(rt["query"]) as passes:
        counts2 = repeat_query(torch, ops, store, specs, res, "plugin", "main path")
    check_one_launch_per_group(counts2, None, passes, "main path repeat")
    print(f"main path: {counts['aqp_batch_sums']} aqp_batch + {counts['aqp_box_sums']} "
          f"aqp_boxes launches per query (estimate and CI sums), no CI moment pass")
    return counts, calls


def path_a(torch, rt, store, specs, stream):
    """Path A: the same store and specs served from LSCV_h fits."""
    ops = rt["ops"]
    with moment_passes(rt["query"]) as passes:
        res, _, counts, calls = driven(
            torch, ops, "path A (lscv_h) first query, fits included",
            lambda: store.query(specs, selector="lscv_h"))
    check_one_launch_per_group(counts, calls, passes, "path A")
    n_fits = len(RANGE_COLS) + 1
    want = {k: 0 for k in counts}
    want.update(aqp_batch_sums=len(RANGE_COLS), aqp_box_sums=1, sv_matrix=n_fits,
                lscv_grid_sums=n_fits)
    check(counts == want, f"path A launches {counts}, expected {want}")
    check_answers(store, specs, stream, res, "lscv_h", ":cuda")
    hs = {c: float(store.synopsis(c, "lscv_h").h) for c in RANGE_COLS}
    hs["joint"] = float(store.joint_synopsis(JOINT, "lscv_h").h)
    print(f"path A: LSCV_h h per fit (Sigma-whitened, served as a data-unit bandwidth): {hs}")
    with moment_passes(rt["query"]) as passes:
        counts2 = repeat_query(torch, ops, store, specs, res, "lscv_h", "path A")
    check_one_launch_per_group(counts2, None, passes, "path A repeat")
    want2 = dict(want, sv_matrix=0, lscv_grid_sums=0)
    check(counts2 == want2, f"path A repeat launches {counts2}, expected {want2}")
    return counts, calls


def path_b(torch, rt, store):
    """Path B: the joint's LSCV_H fit, one gh_fused launch per evaluation."""
    ops, lscv = rt["ops"], rt["lscv"]
    syn, sec, counts, calls = driven(
        torch, ops, "path B (lscv_H joint fit)",
        lambda: store.joint_synopsis(JOINT, selector="lscv_H"))
    n_eval = counts["gh_fused_sum"]
    check(n_eval > 0 and sum(counts.values()) == n_eval,
          f"path B launches {counts}: only gh_fused_sum expected")
    H = syn.H.double().cpu().numpy()
    w = np.linalg.eigvalsh(H)
    check(bool(np.all(w > 0)), f"path B: H not SPD (eigenvalues {w})")
    g = float(lscv.g_of_H(syn.x, syn.H, device="cuda"))
    H0 = lscv.h_start(syn.x)
    g0 = float(lscv.g_of_H(syn.x, H0, device="cuda"))
    check(g <= g0, f"path B: g(H) {g} > g(H_start) {g0}")
    direct = lscv.lscv_H(syn.x, device="cuda")
    check(direct.nfev == n_eval,
          f"path B: a direct lscv_H made {direct.nfev} evaluations, the store path "
          f"{n_eval} launches")
    print(f"path B: it {direct.it}, nfev {direct.nfev}, gh_fused_sum launches {n_eval}, "
          f"wall {sec:.3f} s ({sec / n_eval * 1e3:.3f} ms per evaluation); "
          f"g(H) {g!r} <= g(H_start) {g0!r}; H eigenvalues {w}")
    return counts, calls


# --- paths C, D, E (GROUP BY, full-H serving, kde_eval) -------------------------

def select_op(agg: str, cnt, sm):
    return {"count": cnt, "sum": sm}.get(agg, sm / cnt if cnt > 1e-3 else 0.0)


def _phi_diff64(torch, za, zb):
    """Phi(zb) - Phi(za) in float64 from the tail the pair sits in, by erfc
    (a difference of ndtr values cancels in the far tails even in float64,
    and torch's ndtr takes 1 + erf)."""
    upper = za + zb > 0
    u = torch.where(upper, za, -zb) * math.sqrt(0.5)
    v = torch.where(upper, zb, -za) * math.sqrt(0.5)
    return 0.5 * (torch.special.erfc(u) - torch.special.erfc(v))


def _five_or_two(terms, q: int, moments: bool, slab: int = 64):
    """Sums over the sample of the (c, s) that `terms(s0, s1)` gives for each
    slab of queries: (sum c, sum s), or with `moments` the five CI sums
    (sum c, sum s, sum c^2, sum s^2, sum c s), as float64 host arrays."""
    parts = []
    for s0 in range(0, q, slab):
        c, s = terms(s0, s0 + slab)
        parts.append([v.sum(1).cpu().numpy()
                      for v in ((c, s, c * c, s * s, c * s) if moments else (c, s))])
    return tuple(np.concatenate(col) for col in zip(*parts))


def oracle_batch_dev(torch, x, h, a, b, moments: bool = False):
    """oracle_batch in float64 on the card, tail-stable (x (n,), a/b (q,)
    float64 tensors, h a float): unscaled (count, sum) per range, or with
    `moments` the five CI sums."""
    def terms(s0, s1):
        za = (a[s0:s1, None] - x[None]) / h
        zb = (b[s0:s1, None] - x[None]) / h
        c = _phi_diff64(torch, za, zb)
        d_phi = (torch.exp(-0.5 * zb * zb) - torch.exp(-0.5 * za * za)) / math.sqrt(2 * math.pi)
        return c, x[None] * c - h * d_phi
    return _five_or_two(terms, a.shape[0], moments)


def oracle_boxes_dev(torch, x, h, lo, hi, tgt, moments: bool = False):
    """oracle_boxes in float64 on the card, tail-stable (x (n,d), h (d,),
    lo/hi (q,d) float64 tensors, tgt (q,) ints): unscaled (count, sum) per
    box, or with `moments` the five CI sums (sum c, sum s, sum c^2, sum s^2,
    sum c s)."""
    t_all = torch.as_tensor(np.asarray(tgt), device=x.device)
    axis = torch.arange(x.shape[1], device=x.device)

    def terms(s0, s1):
        za = (lo[s0:s1, None, :] - x[None]) / h
        zb = (hi[s0:s1, None, :] - x[None]) / h
        d_Phi = _phi_diff64(torch, za, zb)
        d_phi = (torch.exp(-0.5 * zb * zb) - torch.exp(-0.5 * za * za)) / math.sqrt(2 * math.pi)
        moment = x[None] * d_Phi - h * d_phi
        sel = axis[None, None, :] == t_all[s0:s1, None, None]
        return torch.prod(d_Phi, 2), torch.prod(torch.where(sel, moment, d_Phi), 2)
    return _five_or_two(terms, lo.shape[0], moments)


def path_c(torch, rt, store, gspecs, stream):
    """Path C: GROUP BY families over the joint that holds model_id."""
    ops = rt["ops"]
    res, _, counts, calls = driven(torch, ops, "path C (GROUP BY) first query, fits included",
                                   lambda: store.query(gspecs))
    n_fam = len(gspecs)
    check(len(res) == n_fam * N_CODES, f"path C: {len(res)} results, expected "
          f"{n_fam} x {N_CODES} categories")
    want = {k: 0 for k in counts}
    want.update(pairwise_scaled_ksum=2 * len(GJOINT), aqp_grouped_sums=1)
    check(counts == want, f"path C launches {counts}, expected {want}")
    check(len(calls["aqp_grouped_moments"]) == 1
          and calls["aqp_grouped_moments"][0][0][2].shape[0] == n_fam,
          f"path C: the {n_fam} families are not one aqp_grouped_moments call")
    check({r.path for r in res} == {"box:grouped:cuda"}, f"path C paths {({r.path for r in res})}")
    est = np.asarray([r.estimate for r in res])
    lo = np.asarray([r.ci_lo for r in res])
    hi = np.asarray([r.ci_hi for r in res])
    check(bool(np.all(np.isfinite(est)) and np.all((lo <= est) & (est <= hi))),
          "path C: non-finite estimate or an estimate outside its CI")

    syn = store.joint_synopsis(GJOINT)
    x64, h64 = syn.x.double(), syn.h_diag().double()
    scale = syn.n_source / syn.x.shape[0]
    worst = 0.0
    for fi in range(n_fam):
        q, rows = gspecs[fi], res[fi * N_CODES:(fi + 1) * N_CODES]
        (ra, rb) = q.predicates
        lo_b = [[ra.a, rb.a, r.group - 0.5] for r in rows]
        hi_b = [[ra.b, rb.b, r.group + 0.5] for r in rows]
        tgt = [0 if q.target in (None, "loss") else 2] * len(rows)
        c64, s64 = oracle_boxes_dev(torch, x64, h64,
                                    torch.tensor(lo_b, dtype=torch.float64, device=DEV),
                                    torch.tensor(hi_b, dtype=torch.float64, device=DEV), tgt)
        want64 = [select_op(q.aggregate, scale * c, scale * s) for c, s in zip(c64, s64)]
        ok, err = close([r.estimate for r in rows], want64, 1e-4, 1e-3)
        check(ok, f"path C: family {fi} ({q.aggregate}) vs its fanned-out boxes in float64 "
                  f"(max err {err})")
        worst = max(worst, err)

    # exact GROUP BY counts of the stream, for the COUNT families
    h_g = float(syn.h_diag()[2])
    codes = stream["model_id"].astype(np.int64)
    inner_in, inner_n, edge_ratio = 0, 0, []
    for fi in range(0, N_GROUP, 3):
        ra, rb = gspecs[fi].predicates
        mask = ((stream["loss"] >= np.float32(ra.a)) & (stream["loss"] <= np.float32(ra.b))
                & (stream["latency_ms"] >= np.float32(rb.a))
                & (stream["latency_ms"] <= np.float32(rb.b)))
        exact = np.bincount(codes[mask], minlength=N_CODES)
        for r in res[fi * N_CODES:(fi + 1) * N_CODES]:
            g = int(r.group)
            if min(g, N_CODES - 1 - g) >= 3.0 * h_g:
                inner_n += 1
                inner_in += int(r.ci_lo <= exact[g] <= r.ci_hi)
            elif g in (0, N_CODES - 1):
                edge_ratio.append(r.estimate / max(exact[g], 1))
    cover = inner_in / max(inner_n, 1)
    check(inner_n > 0 and cover >= 0.75,
          f"path C: exact per-code counts inside the 95% CIs for {cover:.3f} of {inner_n} "
          f"interior (family, code) pairs")
    print(f"path C: {n_fam} families x {N_CODES} codes on box:grouped:cuda; every family "
          f"matches its fanned-out boxes in float64 (max |err| {worst:.3g}); exact stream "
          f"counts inside the CI for {cover:.3f} of {inner_n} interior (COUNT family, code) "
          f"pairs (codes >= 3 h = {3 * h_g:.3g} from the ends); at codes 0 and 63 the "
          f"estimate / exact ratio is {np.mean(edge_ratio):.3f} on average (the KDE's mass "
          f"leaks past the ends of the code range)")

    misses = store.cache.stats()["misses"]
    res2, _, counts2, _ = driven(torch, ops, "path C repeat query (cached fits)",
                                 lambda: store.query(gspecs))
    check(all((r.estimate, r.ci_lo, r.ci_hi, r.path) == (r2.estimate, r2.ci_lo, r2.ci_hi, r2.path)
              for r, r2 in zip(res, res2)), "path C: repeat query not bit-identical")
    want2 = dict(want, pairwise_scaled_ksum=0)
    check(counts2 == want2 and store.cache.stats()["misses"] == misses,
          f"path C repeat launches {counts2}, expected {want2}, and no refit")
    print("path C repeat query: bit-identical answers, no fit launches")
    return counts, calls


def group_slices(specs):
    """{group: spec indices} of the 1 024-spec mix's KDE groups."""
    out = {col: [i for i in range(N_RANGE) if specs[i].predicates[0].column == col]
           for col in RANGE_COLS}
    out[JOINT] = list(range(N_RANGE, N_RANGE + N_BOX))
    return out


def group_boxes(specs, idx):
    """(lo, hi, tgt, aggs) of a group's specs, in the engine's axis order."""
    lo, hi, tgt, aggs = [], [], [], []
    for i in idx:
        p = specs[i].predicates[0]
        if hasattr(p, "a"):
            lo.append([p.a])
            hi.append([p.b])
            tgt.append(0)
        else:
            lo.append(list(p.lo))
            hi.append(list(p.hi))
            tgt.append(0 if specs[i].target is None else JOINT.index(specs[i].target))
        aggs.append(specs[i].aggregate)
    return np.asarray(lo, np.float64), np.asarray(hi, np.float64), np.asarray(tgt), aggs


def oracle_qmc(torch, rt, syn, lo, hi, tgt, aggs, k: int, n_qmc: int = 4096):
    """eq. 6 integrated over the first k boxes of a full-H group in float64
    on the card, with the engine's plan (the same clipped boxes and the same
    float32 Halton nodes): scaled COUNT / SUM / AVG per box."""
    md = rt["aqp_multid"]
    x = syn.x if syn.x.dim() == 2 else syn.x[:, None]
    n, d = x.shape
    plan = md._qmc_plan(x.double().cpu().numpy(), syn.H.double().cpu().numpy(), lo, hi, n_qmc)
    glo, ghi, clo, chi, n_nodes = plan

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=DEV)

    glo_t, ghi_t = f32(glo), f32(ghi)
    unit = torch.as_tensor(md._halton_unit(n_nodes, d), device=DEV)
    nodes = (glo_t[None] + unit * (ghi_t - glo_t)[None]).double()
    H64 = syn.H.double()
    h_inv = torch.linalg.inv(H64)
    log_norm = -0.5 * d * math.log(2 * math.pi) - 0.5 * torch.linalg.slogdet(H64)[1]
    x64 = x.double()
    f = torch.empty(n_nodes, dtype=torch.float64, device=DEV)
    for s in range(0, n_nodes, 256):
        diff = nodes[s:s + 256, None, :] - x64[None]
        quad = torch.sum((diff @ h_inv) * diff, dim=-1)
        f[s:s + 256] = torch.exp(log_norm - 0.5 * quad).mean(1)
    vol = torch.prod(ghi_t - glo_t).double()
    lo_t, hi_t = f32(clo[:k]).double(), f32(chi[:k]).double()
    w = torch.all((nodes[None] >= lo_t[:, None]) & (nodes[None] <= hi_t[:, None]), 2) * f[None]
    tv = nodes.T[torch.as_tensor(np.asarray(tgt[:k]), device=DEV)]
    scale = syn.n_source / n
    cnt = (scale * n * vol * w.mean(1)).cpu().numpy()
    sm = (scale * n * vol * (w * tv).mean(1)).cpu().numpy()
    return [select_op(a, c, s) for a, c, s in zip(aggs[:k], cnt, sm)], n_nodes


def path_d(torch, rt, store, specs):
    """Path D: the 1 024-spec mix served from LSCV_H fits on the full-H
    path, the RFF density backend ("auto") and then the exact one."""
    ops, RFF = rt["ops"], rt["synopses"].RFFSynopsis
    fit_s = []
    orig_fit = RFF.fit.__func__

    def timed_fit(cls, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_fit(cls, *a, **kw)
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)
        return out

    RFF.fit = classmethod(timed_fit)
    try:
        res, sec, counts, calls = driven(
            torch, ops, "path D (lscv_H, kde_backend auto) first query, 1-D LSCV_H fits "
            "and RFF fits included", lambda: store.query(specs, selector="lscv_H"))
    finally:
        RFF.fit = classmethod(orig_fit)
    others = {k: v for k, v in counts.items()
              if k not in ("gh_fused_sum", "rff_density", "qmc_box_reduce")}
    check(counts["gh_fused_sum"] > 0 and counts["rff_density"] >= 3
          and not any(others.values()),
          f"path D launches {counts}: 1-D LSCV_H fits on gh_fused_sum, the RFF probe gates "
          f"on rff_density, nothing else")
    slices = group_slices(specs)
    est = np.asarray([r.estimate for r in res])
    check(bool(np.all(np.isfinite(est)))
          and all(r.ci_lo <= r.estimate <= r.ci_hi for r in res), "path D: CI or finiteness")
    check({res[i].path for i in range(N_RANGE + N_BOX, len(specs))} == {"exact"}, "Eq paths")
    rff_groups = []
    for j, (col, idx) in enumerate(slices.items()):
        syn = (store.joint_synopsis(col, "lscv_H") if isinstance(col, tuple)
               else store.synopsis(col, "lscv_H"))
        ver = (store.joints[col] if isinstance(col, tuple) else store.columns[col]).version
        ckey = col + ("#rff2048",) if isinstance(col, tuple) else f"{col}#rff2048"
        rff = store.cache.get(ckey, "lscv_H", ver, backend="cuda")
        paths = {res[i].path for i in idx}
        check(rff is not None and paths == ({"qmc:cuda"} if rff.degraded else {"qmc:rff"}),
              f"path D: group {col} paths {paths} with RFF {rff and rff.error_metadata()}")
        if not rff.degraded:
            rff_groups.append(col)
        print(f"path D group {col}: H diag {syn.H.diagonal().tolist()}; RFF fit "
              f"{fit_s[j] * 1e3:.1f} ms, probe_rel_err {rff.probe_rel_err:.4f}, "
              f"degraded {rff.degraded}; path {paths.pop()}")
    n_degraded = len(slices) - len(rff_groups)
    check(counts["qmc_box_reduce"] == n_degraded
          and len(calls["qmc_box_reduce_split"]) == n_degraded,
          f"path D: {counts['qmc_box_reduce']} qmc_box_reduce launches for {n_degraded} "
          f"degraded groups (one each: the estimate and its CI chunks)")
    # the labels of PR 13-15 on this store: the two 1-D columns on qmc:rff,
    # the joint degraded to the exact pass
    check(rff_groups == list(RANGE_COLS),
          f"path D: RFF groups {rff_groups}, expected the 1-D columns {list(RANGE_COLS)}")
    probes, blocks = calls["rff_density"], calls["rff_density_blocks"]
    check(len(probes) == len(slices)
          and all(a[0].shape[0] == rt["query"].RFF_GATE_PROBES for a, _ in probes),
          f"path D: {len(probes)} rff_density calls, expected one probe per fit")
    check(len(blocks) == len(rff_groups) and all(a[4] == 8 for a, _ in blocks)
          and counts["rff_density"] == len(slices) + len(rff_groups),
          f"path D: {counts['rff_density']} rff_density launches, expected a probe per fit and "
          f"one launch per RFF group for its estimate and 8 feature blocks")
    print(f"path D: rff_density launches {counts['rff_density']} ({len(probes)} probes, one per "
          f"fit, and {len(blocks)} launches of the estimate with its 8 feature blocks, one per "
          f"RFF group), qmc_box_reduce {counts['qmc_box_reduce']} (one per degraded group); "
          f"{sec:.3f} s")

    eng = store.shared_engine("lscv_H")
    res_x, sec_x, counts_x, calls_x = driven(
        torch, ops, "path D exact (kde_backend='exact', fits cached)",
        lambda: eng.execute(specs, kde_backend="exact"))
    want = {k: 0 for k in counts_x}
    want["qmc_box_reduce"] = 3                 # one per group: the estimate and 8 CI chunks
    check(counts_x == want, f"path D exact launches {counts_x}, expected {want}")
    check([a[7] for a, _ in calls_x["qmc_box_reduce_split"]] == [8, 8, 8],
          "path D exact: each group's launch carries its 8 CI chunks")
    nodes = [a[0].shape[0] for a, _ in calls_x["qmc_box_reduce_split"]]
    print(f"path D exact: Halton nodes per group (_qmc_plan): {nodes}")
    worst, in_ci, n_rff = 0.0, 0, 0
    for col, idx in slices.items():
        syn = (store.joint_synopsis(col, "lscv_H") if isinstance(col, tuple)
               else store.synopsis(col, "lscv_H"))
        lo, hi, tgt, aggs = group_boxes(specs, idx)
        check({res_x[i].path for i in idx} == {"qmc:cuda"}, f"path D exact: {col} paths")
        want64, _ = oracle_qmc(torch, rt, syn, lo, hi, tgt, aggs, 24)
        ok, err = close([res_x[i].estimate for i in idx[:24]], want64, 1e-4, 1e-3)
        check(ok, f"path D exact: {col} vs the float64 eq. 6 oracle (max err {err})")
        worst = max(worst, err)
        if col in rff_groups:
            top = max(abs(res_x[i].estimate) for i in idx)
            for i, w64 in zip(idx, want64):
                r = res[i]
                half = max((r.ci_hi - r.ci_lo) / 2.0, 0.02 * top)
                check(abs(r.estimate - w64) <= 4.0 * half,
                      f"path D: {col} spec {i}: RFF {r.estimate} vs float64 {w64}")
            for i in idx:
                r, x_ = res[i], res_x[i]
                half = max((r.ci_hi - r.ci_lo) / 2.0, (x_.ci_hi - x_.ci_lo) / 2.0, 0.02 * top)
                check(abs(r.estimate - x_.estimate) <= 4.0 * half,
                      f"path D: {col} spec {i}: RFF {r.estimate} vs exact {x_.estimate} "
                      f"beyond 4 half-widths {half}")
                in_ci += int(r.ci_lo <= x_.estimate <= r.ci_hi
                             or x_.ci_lo <= r.estimate <= x_.ci_hi)
                n_rff += 1
    print(f"path D exact: 24 specs per group match the float64 eq. 6 oracle on the same "
          f"nodes (max |err| {worst:.3g}), the RFF answers of those within 4 CI "
          f"half-widths of it; RFF and exact answers inside each other's CIs for {in_ci} "
          f"of {n_rff} specs, all within 4 CI half-widths")

    for what, run, first in (("path D", lambda: store.query(specs, selector="lscv_H"), res),
                             ("path D exact",
                              lambda: eng.execute(specs, kde_backend="exact"), res_x)):
        again, _, c2, _ = driven(torch, ops, f"{what} repeat query", run)
        check(all((r.estimate, r.ci_lo, r.ci_hi, r.path) == (r2.estimate, r2.ci_lo, r2.ci_hi,
                                                               r2.path)
                  for r, r2 in zip(first, again)), f"{what}: repeat query not bit-identical")
        check(c2["gh_fused_sum"] == 0, f"{what}: repeat query refitted")
    print("path D repeat queries (RFF and exact): bit-identical answers, no fit launches")
    return counts, calls, counts_x, calls_x


def path_e_inputs(torch, rt, store, specs):
    """Path E's inputs and its run: kde_eval at N_E_POINTS grid points on a
    1-D sample (d = 1) and on the joint (d = 3), and count_1d_numeric /
    sum_1d_numeric (513-point trapezoid grids) on N_E_RANGES ranges;
    returns (run, x1, h1, grid1, jsyn, ranges), run() giving (f1, fj, num)."""
    kde, aqp = rt["kde"], rt["aqp"]
    syn = store.synopsis("loss")                     # PLUGIN, cached by the main path
    jsyn = store.joint_synopsis(JOINT, "lscv_h")     # scalar h, cached by path A
    x1, h1 = syn.x, syn.h
    hv = float(h1)
    grid1 = torch.linspace(float(x1.min()) - 6 * hv, float(x1.max()) + 6 * hv, N_E_POINTS,
                           device=DEV)
    per_axis = round(N_E_POINTS ** (1 / 3))
    qs = torch.quantile(jsyn.x[:8192], torch.linspace(0.02, 0.98, per_axis, device=DEV), dim=0)
    gridj = torch.stack(torch.meshgrid(qs[:, 0], qs[:, 1], qs[:, 2], indexing="ij"),
                        -1).reshape(-1, 3).contiguous()
    ranges = [(specs[i].predicates[0].a, specs[i].predicates[0].b) for i in range(N_RANGE)
              if specs[i].predicates[0].column == "loss"][:N_E_RANGES]

    def run():
        f1 = kde.kde_eval(grid1, x1, h1, device=DEV)
        fj = kde.kde_eval(gridj, jsyn.x, jsyn.h, device=DEV)
        num = [(aqp.count_1d_numeric(x1, h1, a, b), aqp.sum_1d_numeric(x1, h1, a, b))
               for a, b in ranges]
        return f1, fj, num

    return run, x1, h1, grid1, jsyn, ranges


def path_e(torch, rt, store, specs):
    """Path E: kde_eval on a 1-D sample and on the joint, and the
    trapezoid forms of eqs. 9-10 against the closed forms."""
    ops, aqp = rt["ops"], rt["aqp"]
    run, x1, h1, grid1, jsyn, ranges = path_e_inputs(torch, rt, store, specs)
    hv = float(h1)
    (f1, fj, num), sec, counts, calls = driven(torch, ops, "path E (kde_eval)", run)
    want = {k: 0 for k in counts}
    want["kde_eval"] = 2 + 2 * len(ranges)
    check(counts == want, f"path E launches {counts}, expected {want}")
    check(bool(torch.all(torch.isfinite(f1)) & torch.all(f1 >= 0) & torch.all(torch.isfinite(fj))
               & torch.all(fj >= 0)) and fj.shape == (N_E_POINTS,),
          "path E: densities finite, non-negative, of the expected shape")
    mass = float(torch.trapezoid(f1.double(), grid1.double()))
    check(abs(mass - 1.0) < 1e-3, f"path E: the 1-D density integrates to {mass}")
    got = np.asarray([[float(c), float(s)] for c, s in num])
    closed = np.asarray([[float(aqp.count_1d(x1, h1, a, b)), float(aqp.sum_1d(x1, h1, a, b))]
                         for a, b in ranges])
    ok, err = close(got, closed, 1e-3, 1e-2)
    check(ok, f"path E: trapezoid eqs. 9-10 vs the closed forms (max err {err})")
    print(f"path E: kde_eval at {N_E_POINTS} points (n={x1.shape[0]}, d=1, h={hv:.4g}; "
          f"joint d=3, h={float(jsyn.h):.4g}); the 1-D density integrates to {mass:.6f}; "
          f"{len(ranges)} count_1d_numeric / sum_1d_numeric match the closed forms "
          f"(max |err| {err:.3g}); {sec * 1e3:.1f} ms")
    return counts, calls


# --- path F (progressive serving over tiered reservoirs) ------------------------

N_TIERS = 4
TIER_SIZES = [CAPACITY >> (N_TIERS - 1 - t) for t in range(N_TIERS)]
F_KERNELS = {"pairwise_scaled_ksum": "pairwise_scaled_ksum",
             "aqp_batch_sums": "aqp_batch_moments", "aqp_box_sums": "aqp_box_moments"}
F_REPEATS = 5          # warm progressive runs timed per round


def build_tiered_store(args, rt, stream):
    """Path F's store, launch/serve.py's layout: four-tier ladders on loss,
    latency_ms and the joint, a count-min sketch on model_id; fed the same
    stream in the same batches as the first store."""
    t0 = time.perf_counter()
    store = rt["store"].TelemetryStore(capacity=CAPACITY, seed=args.seed)
    check(store.device.type == DEV, f"tiered store landed on {store.device}")
    for key in RANGE_COLS + (JOINT,):
        store.track_tiered(key, n_tiers=N_TIERS)
    store.track_categorical("model_id", kind="cm")
    for s in range(0, STREAM_ROWS, BATCH_ROWS):
        store.add_batch({k: v[s:s + BATCH_ROWS] for k, v in stream.items()})
    ladders = [store.columns[c] for c in RANGE_COLS] + [store.joints[JOINT]]
    check(all(r.tier_sizes() == TIER_SIZES and r.n_seen == STREAM_ROWS for r in ladders),
          f"path F: tier sizes {[r.tier_sizes() for r in ladders]}, expected {TIER_SIZES}")
    sketch = store.categoricals["model_id"]
    check(sketch.exact_for(store.columns["model_id"].n_seen) and not sketch.off_grid,
          f"path F: the count-min sketch does not cover the stream {sketch.stats()}")
    sec = time.perf_counter() - t0
    print(f"path F store: {STREAM_ROWS} rows in {BATCH_ROWS}-row batches, tiers {TIER_SIZES} "
          f"on {list(RANGE_COLS)} and the joint, count-min model_id "
          f"({sketch.depth} x {sketch.width}, err_bound {sketch.err_bound()}), set-up "
          f"{sec:.2f} s")
    return store, sec


def progressive_run(torch, ops, store, specs, calls=None):
    """One `store.query(specs, mode="progressive")` pass, a CUDA-synced wall
    per round: [(tier, results, wall s, launches, {wrapper: (first, end)}
    index span of the recorded `calls`)]."""
    out = []
    gen = store.query(specs, mode="progressive")
    while True:
        before = ops.launch_counts()
        marks = {w: len(v) for w, v in calls.items()} if calls is not None else {}
        t0 = time.perf_counter()
        item = next(gen, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if item is None:
            return out
        now = ops.launch_counts()
        spans = {w: (m, len(calls[w])) for w, m in marks.items()}
        out.append((item[0], item[1], wall, {k: now[k] - before[k] for k in now}, spans))


def device_ms(torch, fn) -> tuple:
    """(device ms, device kernels) of one run of fn from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, kernels = 0.0, 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us and "CUDA" in str(getattr(ev, "device_type", "")):
            total += us / 1e3
            kernels += ev.count
    return total, kernels


def grid_note(rt, wrapper: str, args) -> str:
    """The grid the launcher opens for a call, beside the card's SM count."""
    mods = {"pairwise_scaled_ksum": rt["pairwise_reduce"], "aqp_batch_moments": rt["aqp_batch"],
            "aqp_box_moments": rt["aqp_boxes"]}
    mod = mods[wrapper]
    x = args[0]
    index = x.device.index or 0
    sms = rt["launch"].sm_count(index)
    n = x.shape[0]
    if wrapper == "pairwise_scaled_ksum":
        k = mod.tile_for(n, mod.TILE)
        return f"{mod.n_tri_tiles(-(-n // k))} blocks of tile {k} on {sms} SMs"
    q_tiles = -(-args[2].shape[0] // mod.Q_TILE)
    pts = rt["launch"].fixed_range(n, mod.RANGES, 32, mod.TILE)
    blocks = q_tiles * -(-n // pts)
    return f"{blocks} blocks ({q_tiles} query tiles x ranges of {pts} points) on {sms} SMs"


def path_f(torch, rt, args, stream, specs):
    """Path F: the 1 024 specs answered progressively over a second store of
    four-tier reservoirs, four PLUGIN rounds (tiers of 4 096 to 32 768 rows)
    on the pairwise, aqp_batch and aqp_boxes kernels, Eq specs on the
    count-min sketch."""
    ops, ref = rt["ops"], rt["ref"]
    store, setup_s = build_tiered_store(args, rt, stream)
    n_axes = len(RANGE_COLS) + len(JOINT)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with moment_passes(rt["query"]) as passes, recording(ops) as calls:
        rounds = progressive_run(torch, ops, store, specs, calls)
    sec = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"path F (progressive, {N_TIERS} tiers) first run, fits included: {sec * 1e3:.1f} ms; "
          f"launches {counts}")
    for kernel, wrappers in WRAPPERS.items():
        made = sum(wrapper_launches(w, a) for w in wrappers for a, _ in calls[w])
        check(made == counts[kernel],
              f"path F: {kernel}: {made} wrapper calls but {counts[kernel]} launches")
    check(passes == {"moments_1d": 0, "moments_box": 0},
          f"path F: the engine ran the separate CI moment passes {passes}")
    check([t for t, *_ in rounds] == list(range(N_TIERS)),
          f"path F: rounds {[t for t, *_ in rounds]}, expected {list(range(N_TIERS))}")
    want = {k: 0 for k in counts}
    want.update(pairwise_scaled_ksum=2 * n_axes, aqp_batch_sums=len(RANGE_COLS), aqp_box_sums=1)
    medians = []
    for t, res, wall, c, spans in rounds:
        check(c == want, f"path F round {t}: launches {c}, expected {want} (each tier fitted "
                         f"once, one launch per range or box group)")
        n_t = TIER_SIZES[t]
        for wrapper in F_KERNELS.values():
            first, end = spans[wrapper]
            check(all(a[0].shape[0] == n_t for a, _ in calls[wrapper][first:end]),
                  f"path F round {t}: {wrapper} not at the tier's n = {n_t}")
        check_answers(store, specs, stream, res, "plugin", ":cuda",
                      tier=t if t < N_TIERS - 1 else None, eq_path="exact:cm")
        kde = res[:N_RANGE + N_BOX]
        check({r.n_effective for r in kde} == {n_t}
              and {r.n_effective for r in res[N_RANGE + N_BOX:]} == {STREAM_ROWS},
              f"path F round {t}: n_effective {sorted({r.n_effective for r in res})}, "
              f"expected {n_t} on the tiered groups")
        widths = np.asarray([r.ci_width for r in kde])
        medians.append(float(np.median(widths)))
        per_group = {str(col): float(np.median(widths[idx]))
                     for col, idx in group_slices(specs).items()}
        print(f"path F round {t} (n = {n_t}): {wall * 1e3:.1f} ms with its fits, launches "
              f"{ {k: v for k, v in c.items() if v} }; median CI width {medians[-1]:.6g} "
              f"(per group {per_group})")
    check(all(a >= b for a, b in zip(medians, medians[1:])),
          f"path F: the median CI width widened between rounds: {medians}")
    eq = rounds[-1][1][N_RANGE + N_BOX:]
    over = max(r.estimate - float(np.sum(stream["model_id"] == np.float32(r.query.predicates[0].value)))
               for r in eq if r.query.aggregate == "count")
    print(f"path F: {len(eq)} Eq specs on exact:cm in every round, the stream's exact answers "
          f"inside their intervals; COUNT estimates over the truth by {over:.0f} rows at most "
          f"(err_bound {store.categoricals['model_id'].err_bound()})")

    final = rounds[-1][1]
    res_x, _, counts_x, _ = driven(torch, ops, "path F execute (cached fits)",
                                   lambda: store.query(specs))

    def key(r):
        return (r.estimate, r.ci_lo, r.ci_hi, r.path, r.synopsis_version, r.n_effective)
    check([key(r) for r in final] == [key(r) for r in res_x],
          "path F: the final round is not bit-identical to store.query(specs)")
    want_x = dict(want, pairwise_scaled_ksum=0)
    check(counts_x == want_x, f"path F execute launches {counts_x}, expected {want_x}")
    print("path F: the final round is bit-identical to store.query(specs) (estimates, CI "
          "bounds, paths, versions)")

    walls = [[] for _ in range(N_TIERS)]
    for _ in range(F_REPEATS):
        again = progressive_run(torch, ops, store, specs)
        for (t, res, wall, c, _), (_, first_res, *_) in zip(again, rounds):
            check([key(r) for r in res] == [key(r) for r in first_res]
                  and c["pairwise_scaled_ksum"] == 0,
                  f"path F repeat round {t}: not bit-identical, or refitted")
            walls[t].append(wall)
    gen = store.query(specs, mode="progressive")
    dev = [device_ms(torch, lambda: next(gen)) for _ in range(N_TIERS)]
    summary = {"setup_s": setup_s, "first_run_ms": sec * 1e3,
               "first_ms": [r[2] * 1e3 for r in rounds],
               "repeat_ms": [float(np.median(w)) * 1e3 for w in walls],
               "device_ms": [d[0] for d in dev], "device_kernels": [d[1] for d in dev],
               "median_ci_width": medians}
    for t in range(N_TIERS):
        print(f"path F round {t} (n = {TIER_SIZES[t]}): first {summary['first_ms'][t]:.1f} ms, "
              f"repeat {summary['repeat_ms'][t]:.1f} ms (median of {F_REPEATS} CUDA-synced "
              f"walls, {' / '.join(f'{w * 1e3:.1f}' for w in walls[t])}); device "
              f"{dev[t][0]:.4f} ms in {dev[t][1]} kernels and copies (torch.profiler)")

    # every path-F launch of the three kernels against its plain version
    errs = []
    for a, kw in calls["pairwise_scaled_ksum"]:
        n = a[0].shape[0]
        errs.append(held(float(ops.pairwise_scaled_ksum(*a, **kw)),
                         float(ref.pairwise_scaled_ksum(*a, **kw)),
                         PAIR_RTOL, max(1e-5, 1e-6 * n), f"path F pairwise {kw['kind']} n={n}"))
    a, kw = calls["pairwise_scaled_ksum"][0]
    check(torch.equal(ops.pairwise_scaled_ksum(*a, **kw), ops.pairwise_scaled_ksum(*a, **kw)),
          "path F pairwise: two launches on the same inputs differ")
    f_errs = {"pairwise_scaled_ksum": max(errs)}
    print(f"path F pairwise: {len(errs)} calls (n = {sorted({a[0].shape[0] for a, _ in calls['pairwise_scaled_ksum']})}) "
          f"match plain, max |err| {max(errs):.3g}")
    f_errs.update(range_box_vs_plain(torch, rt, calls, "path F"))
    torch.cuda.synchronize()
    return counts, calls, rounds, summary, f_errs


def path_f_timings(torch, rt, rounds, calls, f_errs, counts) -> list:
    """The path-F kernels on the inputs of their first call in each tier
    round below the top (PLUGIN's K6 sum for the pairwise kernel): kernel
    and plain version by CUDA events, device ms a launch from torch.profiler,
    bound, SFU floor and the launcher's grid; the n = 4 096 rows for the
    JSON line."""
    ops, ref = rt["ops"], rt["ref"]
    out = []
    for name, wrapper in F_KERNELS.items():
        for t, _, _, _, spans in rounds[:-1]:
            first, end = spans[wrapper]
            made = calls[wrapper][first:end]
            args, kw = next(((a, k) for a, k in made if k.get("kind", "k6") == "k6"), made[0])

            def kern():
                return getattr(ops, wrapper)(*args, **kw)

            def plain():
                return getattr(ref, wrapper)(*args, **kw)
            p1 = time_ms(torch, plain)
            k1 = time_ms(torch, kern)
            k2 = time_ms(torch, kern)
            mhz = sm_clock_mhz()
            p2 = time_ms(torch, plain)
            reps = 20
            dev, _ = device_ms(torch, lambda: [kern() for _ in range(reps)])
            b, by, mufu = bound_ms(wrapper, args, kw)
            sfu = sfu_floor_ms(mufu, mhz)
            grid = grid_note(rt, wrapper, args)
            print(f"time path F {name} ({call_shape(wrapper, args, kw)}, tier {t}): kernel "
                  f"{k1:.4f} / {k2:.4f} ms (median of 15), device {dev / reps:.5f} ms a launch "
                  f"(torch.profiler, {reps} launches), plain {p1:.4f} / {p2:.4f} ms, bound "
                  f"{b:.5f} ms ({by}), SFU floor {sfu:.5f} ms at {mhz:.0f} MHz; {grid}")
            if t == 0:
                out.append({"name": name, "shape": call_shape(wrapper, args, kw),
                            "launches": counts[name], "launches_at_n": rounds[0][3][name],
                            "max_abs_err": f_errs[name],
                            "ms": min(k1, k2), "device_ms": dev / reps,
                            "plain_ms": min(p1, p2), "bound_ms": b, "bound_by": by,
                            "sfu_floor_ms": sfu, "sm_clock_mhz": mhz, "grid": grid})
    return out


# --- path G (admission serving) --------------------------------------------------

G_CLIENTS, G_PER_CLIENT = 8, 128       # launch/serve.py's closed-loop clients: 1 024 specs
G_WATERMARK, G_MAX_DELAY = 8, 0.005    # serve's default watermark (the client count), 5 ms
G_JOINT = ("loss", "latency_ms")       # launch/serve.py's joint
G_WAIT = 120.0                         # seconds any one answer or join may take
G_MICRO = 8                            # serve's micro-batch, for the kernels' invariance
G_REPEATS = 3                          # warm closed-loop runs timed for queries/s
FULLH_KERNELS = ("qmc_box_reduce", "rff_density")


def build_serve_store(args, rt, stream):
    """Path G's store, launch/serve.py's layout at this script's size:
    four-tier ladders on loss, latency_ms and their joint, the exact
    categorical sketch on model_id, the same stream in the same batches, and
    the (model_id, latency_ms) joint backfilled after it; the query mix's
    sampling ranges come from the reservoirs, as serve's do."""
    t0 = time.perf_counter()
    store = rt["store"].TelemetryStore(capacity=CAPACITY, seed=args.seed)
    check(store.device.type == DEV, f"path G store landed on {store.device}")
    for key in G_JOINT + (G_JOINT,):
        store.track_tiered(key, n_tiers=N_TIERS)
    store.track_categorical("model_id")
    for s in range(0, STREAM_ROWS, BATCH_ROWS):
        store.add_batch({k: v[s:s + BATCH_ROWS] for k, v in stream.items()})
    store.track_joint(("model_id", "latency_ms"))
    ranges = {c: (float(s.min()), float(s.max()))
              for c, s in ((c, store.columns[c].sample()) for c in store.columns
                           if c != "model_id")}
    sec = time.perf_counter() - t0
    print(f"path G store: {STREAM_ROWS} rows in {BATCH_ROWS}-row batches, tiers "
          f"{TIER_SIZES} on {list(G_JOINT)} and their joint, exact model_id sketch, "
          f"set-up {sec:.2f} s")
    return store, ranges, sec


def g_specs(rt, ranges, fullh_frac: float):
    """Each client's 128 specs from the port's `make_mixed_aqp_queries`,
    seeded as serve seeds its clients."""
    codes = tuple(float(c) for c in range(N_CODES))
    return [rt["serve"].make_mixed_aqp_queries(G_PER_CLIENT, ranges, G_JOINT, "model_id", codes,
                                               seed=10 + ci, fullh_frac=fullh_frac)
            for ci in range(G_CLIENTS)]


@contextlib.contextmanager
def plain_calls(ref):
    """Count calls of the kernels' plain versions (`kernels/ref.py`) while
    the block runs."""
    names = sorted({w for ws in WRAPPERS.values() for w in ws} | {"lscv_grid_sums_from_s"})
    made = dict.fromkeys(names, 0)
    originals = {name: getattr(ref, name) for name in names}

    def counted(name):
        def wrapper(*args, **kwargs):
            made[name] += 1
            return originals[name](*args, **kwargs)
        return wrapper

    for name in names:
        setattr(ref, name, counted(name))
    try:
        yield made
    finally:
        for name, fn in originals.items():
            setattr(ref, name, fn)


def closed_loop(torch, engine, per_client, extra):
    """serve's closed loop: G_CLIENTS threads, one outstanding spec each,
    into one `engine.session(watermark=8, max_delay=0.005)`; then the
    `extra` specs submitted and flushed.  Returns (results in client order,
    then extra's, flattened; CUDA-synced wall of the clients; session stats;
    flushes [(bucket key, compiled units, their results)])."""
    session = engine.session(watermark=G_WATERMARK, max_delay=G_MAX_DELAY)
    flushes, lock = [], threading.Lock()
    run_flush = session._run_flush

    def recorded(key, pendings, reason):
        run_flush(key, pendings, reason)
        with lock:
            flushes.append((key, [p.compiled for p in pendings],
                            [p.ticket.parts[p.part] for p in pendings]))

    session._run_flush = recorded
    got, errors = {}, []

    def client(ci):
        try:
            got[ci] = [session.submit(s).result(timeout=G_WAIT) for s in per_client[ci]]
        except Exception as exc:            # reported after the join
            errors.append((ci, repr(exc)))

    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(G_CLIENTS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=G_WAIT * 4)
    check(not any(t.is_alive() for t in threads), "path G: a client thread hung")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not errors, f"path G: clients failed: {errors[:3]}")
    results = [r for ci in range(G_CLIENTS) for r in got[ci]]
    futs = [session.submit(s) for s in extra]
    session.flush()
    for fut in futs:
        res = fut.result(timeout=G_WAIT)
        results.extend(res if isinstance(res, list) else [res])
    session.close()
    return results, wall, session.stats(), flushes


def g_key(r):
    return (r.estimate, r.ci_lo, r.ci_hi, r.path, r.synopsis_version, r.n_effective, r.group)


def expected_launches(flushes, counts) -> tuple:
    """The launches a run's flushes make: one aqp_batch launch per range
    bucket, one aqp_boxes launch per box bucket, one aqp_grouped launch per
    GROUP BY bucket, none for the exact Eq buckets and no fits (cached by
    the execute before); and the full-H buckets, one qmc_reduce or rff_eval
    launch each.  Returns ({kernel: launches} without the two full-H
    kernels, full-H buckets)."""
    want = {k: 0 for k in counts if k not in FULLH_KERNELS}
    fullh = 0
    for key, _, _ in flushes:
        col, sel = key[0], key[1]
        if col == "model_id":
            continue
        if not isinstance(col, tuple):
            want["aqp_batch_sums"] += 1
        elif sel == "lscv_H":
            fullh += 1
        elif col == G_JOINT:
            want["aqp_box_sums"] += 1
        else:
            want["aqp_grouped_sums"] += 1
    return want, fullh


def g_check_run(torch, rt, what, engine, per_client, gb, stream):
    """One quiescent closed-loop run against one `engine.execute` of the same
    specs: launch counts from the flushes, no plain-version call, every
    answer finite and inside its CI, Eq COUNT answers the stream's exact
    counts, and every answer bit-identical to the execute's, but for full-H
    answers, whose Halton nodes span their group's hull (below)."""
    ops, ref = rt["ops"], rt["ref"]
    flat = [s for ci in range(G_CLIENTS) for s in per_client[ci]] + [gb]
    t0 = time.perf_counter()
    want = engine.execute(flat)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    with plain_calls(ref) as plain:
        got, wall, st, flushes = closed_loop(torch, engine, per_client, [gb])
        counts = ops.launch_counts()
    check(len(got) == len(want), f"{what}: {len(got)} answers for {len(want)}")
    check(not any(plain.values()), f"{what}: plain versions called {plain}")
    want_rest, fullh = expected_launches(flushes, counts)
    rest = {k: v for k, v in counts.items() if k not in FULLH_KERNELS}
    check(rest == want_rest and sum(counts[k] for k in FULLH_KERNELS) == fullh,
          f"{what}: launches {counts}, expected {want_rest} and {fullh} full-H launches for "
          f"{len(flushes)} flushes")
    est = np.asarray([r.estimate for r in got])
    check(bool(np.all(np.isfinite(est))), f"{what}: a non-finite estimate")
    check(all(r.ci_lo <= r.estimate <= r.ci_hi for r in got), f"{what}: an estimate outside its CI")
    codes = stream["model_id"]
    for s, r in zip(flat, got):
        if r.path == "exact" and s.aggregate == "count":
            check(r.estimate == float(np.sum(codes == np.float32(s.predicates[0].value))),
                  f"{what}: Eq COUNT {r.estimate} is not the stream's count")
    is_fullh = [w.path.startswith("qmc") for w in want]
    same = [g_key(g) == g_key(w) for g, w, f in zip(got, want, is_fullh) if not f]
    check(all(same), f"{what}: {same.count(False)} of {len(same)} answers differ from one "
                     f"execute of the same specs")
    # full-H answers: each flush replayed alone gives the same bits, and the
    # answer agrees with the execute's within the larger half CI width
    dev = 0.0
    if any(is_fullh):
        replayed = 0
        for key, compiled, results in flushes:
            if key[1] != "lscv_H":
                continue
            again = engine.run_compiled(compiled, selector=key[1], tier=key[2])
            check([g_key(r) for r in again] == [g_key(r) for r in results],
                  f"{what}: a full-H flush replayed through run_compiled differs")
            replayed += 1
        for g, w, f in zip(got, want, is_fullh):
            if f:
                half = max(w.ci_hi - w.ci_lo, g.ci_hi - g.ci_lo) / 2
                check(g.path == w.path and abs(g.estimate - w.estimate) <= half,
                      f"{what}: full-H answer {g.estimate} vs {w.estimate} (half CI {half})")
                dev = max(dev, abs(g.estimate - w.estimate) / max(half, 1e-300))
        print(f"{what}: {sum(is_fullh)} full-H answers on {sorted({w.path for w, f in zip(want, is_fullh) if f})}: "
              f"{replayed} flushes replayed alone give the same bits; vs one execute within "
              f"{dev:.3g} of a half CI width (their Halton nodes span each micro-batch's hull)")
    n_specs = sum(map(len, per_client))
    print(f"{what}: {len(got)} answers, the clients' {n_specs} in {wall * 1e3:.1f} ms "
          f"({n_specs / wall:.1f} queries/s; "
          f"the execute of the same specs first, fits included, {first_s * 1e3:.1f} ms); "
          f"{st['flushes']} flushes {st['flush_reasons']}, mean batch {st['mean_batch']:.2f}; "
          f"launches { {k: v for k, v in counts.items() if v} }; "
          f"{len(same)} answers bit-identical to one execute, no plain-version call")
    return got, wall, st, counts, flushes, dev


def g_kernel_invariance(torch, rt, calls_main, calls_c, calls_d, calls_dx):
    """A query's sums at serve's micro-batch (its first 8 queries launched
    alone) against the same queries inside the recorded main-path / path C /
    path D launch: bit-equal for the range, box and GROUP BY kernels (the cut
    depends on n alone) and for rff_eval (per node); for qmc_reduce, whose
    node slices per box depend on the box count (`box_slices`), bit-equal
    where both launches cut the same slices.  At q = 8: device ms a launch,
    the kernel's and the plain version's CUDA-event windows, the bound and
    the SFU floor."""
    ops, ref, qmc = rt["ops"], rt["ref"], rt["qmc_reduce"]
    k = G_MICRO
    out = {}

    def device_per_launch(wrapper, args, reps=20):
        fn = getattr(ops, wrapper)
        dev = device_ms(torch, lambda: [fn(*args) for _ in range(reps)])[0] / reps
        b, by, mufu = bound_ms(wrapper, args, {})
        return {"device_ms": dev, "ms": time_ms(torch, lambda: fn(*args)),
                "plain_ms": time_ms(torch, lambda: getattr(ref, wrapper)(*args)),
                "bound_ms": b, "bound_by": by,
                "sfu_floor_ms": sfu_floor_ms(mufu, sm_clock_mhz())}

    a, kw = calls_main["aqp_batch_moments"][0]
    x, h, qa, qb = a
    full = ops.aqp_batch_moments(*a, **kw)
    small = ops.aqp_batch_moments(x, h, qa[:k].contiguous(), qb[:k].contiguous())
    check(torch.equal(full[:, :k], small), "aqp_batch: a query's sums differ at q = 8")
    out["aqp_batch_sums"] = device_per_launch(
        "aqp_batch_moments", (x, h, qa[:k].contiguous(), qb[:k].contiguous()))
    a, kw = calls_main["aqp_box_moments"][0]
    x, h, lo, hi, tgt = a
    full = ops.aqp_box_moments(*a, **kw)
    sl = (lo[:k].contiguous(), hi[:k].contiguous(), tgt[:k].contiguous())
    check(torch.equal(full[:, :k], ops.aqp_box_moments(x, h, *sl)),
          "aqp_boxes: a box's sums differ at q = 8")
    out["aqp_box_sums"] = device_per_launch("aqp_box_moments", (x, h) + sl)
    a, kw = calls_c["aqp_grouped_moments"][0]
    x, h, lo, hi, wlo, whi, win, g_axis, tgt = a
    full = ops.aqp_grouped_moments(*a, **kw)
    sl = (lo[:k].contiguous(), hi[:k].contiguous(), wlo, whi, list(win)[:k],
          list(g_axis)[:k], list(tgt)[:k])
    check(torch.equal(full[:k], ops.aqp_grouped_moments(x, h, *sl)),
          "aqp_grouped: a family's sums differ with 8 families")
    out["aqp_grouped_sums"] = device_per_launch("aqp_grouped_moments", (x, h) + sl)
    a, kw = calls_dx["qmc_box_reduce_split"][0]
    nodes, xq, h_inv, log_norm, lo, hi, tgt, splits = a
    q = lo.shape[0]
    sms = rt["launch"].sm_count(xq.device.index or 0)
    slices = (qmc.box_slices(k, nodes.shape[0], sms), qmc.box_slices(q, nodes.shape[0], sms))
    full = ops.qmc_box_reduce_split(*a, **kw)
    small = ops.qmc_box_reduce_split(nodes, xq, h_inv, log_norm, lo[:k].contiguous(),
                                     hi[:k].contiguous(), tgt[:k].contiguous(), splits)
    qmc_same = all(torch.equal(f[:, :k], s) for f, s in zip(full, small))
    check(qmc_same or slices[0] != slices[1],
          f"qmc_reduce: boxes differ at q = {k} with the same {slices[0]} node slices")
    a, kw = max(calls_d["rff_density_blocks"], key=lambda c: c[0][0].shape[0])
    pts, w, b, z, n_blocks = a
    blocks, est = ops.rff_density_blocks(*a, **kw)
    blocks_k, est_k = ops.rff_density_blocks(pts[:k].contiguous(), w, b, z, n_blocks)
    check(torch.equal(est[:k], est_k) and torch.equal(blocks[:, :k], blocks_k),
          "rff_eval: a node's density differs at 8 nodes")
    print(f"path G kernels at q = {k}: aqp_batch, aqp_boxes, aqp_grouped and rff_eval give "
          f"a query's (node's) bits alone as in the recorded launch (q = "
          f"{calls_main['aqp_batch_moments'][0][0][2].shape[0]}, "
          f"{calls_main['aqp_box_moments'][0][0][2].shape[0]}, "
          f"{calls_c['aqp_grouped_moments'][0][0][2].shape[0]} families, m = {pts.shape[0]}); "
          f"qmc_reduce at q = {k} vs {q}: {'the same bits' if qmc_same else 'other bits'} "
          f"with {slices[0]} vs {slices[1]} node slices a box; at q = {k}: "
          + "; ".join(f"{n} device {v['device_ms']:.5f} ms a launch (torch.profiler, 20 "
                      f"launches), kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms "
                      f"(median of 15), bound {v['bound_ms']:.5f} ms ({v['bound_by']}), SFU "
                      f"floor {v['sfu_floor_ms']:.5f} ms" for n, v in out.items()))
    return {"kernels_q8": out, "qmc_same_bits_q8": qmc_same, "qmc_slices": list(slices)}


def path_g(torch, rt, args, stream, calls_main, calls_c, calls_d, calls_dx):
    """Path G: admission serving.  (a) serve's closed loop (8 clients x 128
    specs of `make_mixed_aqp_queries`, watermark 8, max_delay 5 ms) on the
    "cuda" backend with no producer, bit-identical to one execute; (b) the
    same with fullh_frac = 0.1; (c) (a) again with obs enabled: the same
    bits, kernel.wall_us for every kernel launched, the exported metrics
    through scripts/validate_metrics.py; (d) `python -m
    repro_torch.launch.serve --mode aqp` at this size with its streaming
    producer; and the kernels' invariance at q = 8."""
    obs = rt["obs"]
    store, ranges, setup_s = build_serve_store(args, rt, stream)
    engine = store.engine()
    check(engine.backend == "cuda", f"path G engine on {engine.backend}")
    q = rt["query"]
    gb = q.AqpQuery("avg", (q.Range("latency_ms", 0.0, 500.0),), target="latency_ms",
                    group_by="model_id")
    per_a = g_specs(rt, ranges, 0.0)
    n_specs = sum(map(len, per_a))          # the clients' (the GROUP BY spec comes after)
    got_a, wall_a, st_a, counts_a, flushes_a, _ = g_check_run(
        torch, rt, "path G (a)", engine, per_a, gb, stream)
    per_b = g_specs(rt, ranges, 0.1)
    got_b, wall_b, st_b, counts_b, flushes_b, dev_b = g_check_run(
        torch, rt, "path G (b) fullh_frac=0.1", engine, per_b, gb, stream)
    check(any(r.path.startswith("qmc") for r in got_b), "path G (b): no full-H answer")
    # (a) warm: the same closed loop repeated, the same bits each time
    walls_a = []
    for _ in range(G_REPEATS):
        again, wall, _, _ = closed_loop(torch, engine, per_a, [gb])
        check([g_key(r) for r in again] == [g_key(r) for r in got_a],
              "path G (a) repeat: answers differ from the first run")
        walls_a.append(wall)
    print(f"path G (a) warm: {G_REPEATS} repeats bit-identical, clients' walls "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls_a)} ms")

    # (c) obs on: the same bits, every launched kernel profiled, the export valid
    prev = obs.set_tracer(obs.Tracer())
    obs.enable()
    try:
        rt["ops"].reset_launch_counts()
        got_c, wall_c, st_c, _ = closed_loop(torch, engine, per_a, [gb])
        counts_c = rt["ops"].launch_counts()
    finally:
        obs.disable()
        obs.set_tracer(prev)
    check([g_key(r) for r in got_c] == [g_key(r) for r in got_a],
          "path G (c): answers with obs on differ from (a)")
    walls = {lb["kernel"] for lb, h in obs.get_registry().collect_histograms("kernel.wall_us")
             if h.count}
    launched = {k for k, v in counts_c.items() if v}
    check(launched <= walls, f"path G (c): kernel.wall_us missing for {launched - walls}")
    lat = {}
    for lb, h in store.metrics.collect_histograms("aqp.query.latency_us"):
        s = h.summary()
        lat[lb["path"] + ("" if lb.get("tier") in (None, "None") else f"@t{lb['tier']}")] = {
            "count": s["count"], "p50_us": s["p50"], "p99_us": s["p99"]}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    mpath = out_dir / "path_g_metrics.json"
    obs.export_json(str(mpath), store.metrics, obs.get_registry(), extra={"mode": "aqp"})
    val = subprocess.run([sys.executable, str(ROOT / "scripts" / "validate_metrics.py"), str(mpath)],
                 capture_output=True, text=True, timeout=120)
    check(val.returncode == 0, f"path G (c): validate_metrics failed: {val.stdout}{val.stderr}")
    print(f"path G (c) obs on: {len(got_c)} answers bit-identical to (a), the clients' in "
          f"{wall_c * 1e3:.1f} ms ({n_specs / wall_c:.1f} queries/s); "
          f"kernel.wall_us for {sorted(launched)}; {mpath.name}: {val.stdout.strip()}; "
          f"aqp.query.latency_us {lat}")

    # device ms per flush of (a)'s run
    dev_ms, dev_kernels = device_ms(torch, lambda: closed_loop(torch, engine, per_a, [gb]))
    n_flush = st_a["flushes"]

    # (d) the entry point, with its streaming producer
    dpath = out_dir / "path_g_serve_metrics.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "aqp", "--rows",
           str(STREAM_ROWS), "--capacity", str(CAPACITY), "--clients", str(G_CLIENTS),
           "--per-client", str(G_PER_CLIENT), "--metrics-out", str(dpath)]
    if DEV != "cuda":
        cmd += ["--device", DEV]
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                             else "")
    serve = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    serve_s = time.perf_counter() - t0
    check(serve.returncode == 0,
          f"path G (d): serve exited {serve.returncode}:\n{serve.stdout[-3000:]}\n"
          f"{serve.stderr[-3000:]}")
    lines = serve.stdout.splitlines()
    head = next(ln for ln in lines if "queries/s" in ln)
    adm = next(ln for ln in lines if ln.startswith("[serve:aqp] admission:"))
    for ln in lines:
        if ln.startswith("[serve:aqp]"):
            print(f"path G (d) | {ln}")
    d_qps = float(head.split("->")[1].split("queries/s")[0].replace(",", ""))
    check("[cuda]" in head or DEV != "cuda", f"path G (d): serve not on cuda: {head}")
    val = subprocess.run([sys.executable, str(ROOT / "scripts" / "validate_metrics.py"), str(dpath)],
                 capture_output=True, text=True, timeout=120)
    check(val.returncode == 0, f"path G (d): validate_metrics failed: {val.stdout}{val.stderr}")
    print(f"path G (d): serve exited 0 in {serve_s:.1f} s (its own process); its metrics "
          f"{val.stdout.strip()}")

    inv = g_kernel_invariance(torch, rt, calls_main, calls_c, calls_d, calls_dx)
    summary = {
        "setup_s": setup_s,
        "qps": n_specs / float(np.median(walls_a)), "first_qps": n_specs / wall_a,
        "walls_ms": [w * 1e3 for w in [wall_a] + walls_a], "answers": len(got_a),
        "flushes": st_a["flushes"], "flush_reasons": st_a["flush_reasons"],
        "mean_batch": st_a["mean_batch"],
        "launches": {k: v for k, v in counts_a.items() if v},
        "fullh": {"qps": n_specs / wall_b, "flushes": st_b["flushes"],
                  "flush_reasons": st_b["flush_reasons"], "mean_batch": st_b["mean_batch"],
                  "launches": {k: v for k, v in counts_b.items() if v},
                  "max_dev_half_ci": dev_b},
        "obs_on_qps": n_specs / wall_c, "latency_us": lat,
        "device_ms_per_flush": dev_ms / max(n_flush, 1), "device_kernels": dev_kernels,
        "serve": {"qps": d_qps, "line": head, "admission": adm, "seconds": serve_s},
        **inv, "card": card_line()}
    print(f"path G: (a) {summary['qps']:.1f} queries/s warm (median of {G_REPEATS}; first run "
          f"{summary['first_qps']:.1f}), {n_flush} flushes, mean batch "
          f"{st_a['mean_batch']:.2f}; device {dev_ms:.3f} ms in {dev_kernels} kernels and "
          f"copies over one run ({summary['device_ms_per_flush']:.4f} ms a flush, "
          f"torch.profiler); serve {d_qps:.1f} queries/s")
    ctx = {"store": store, "engine": engine, "per_a": per_a, "per_b": per_b, "gb": gb,
           "ranges": ranges}
    return summary, ctx


# --- phase T: tile tuning ----------------------------------------------------

# the sweeps: path F's tier-0 pairwise and range shapes, the main path's
# pairwise shape, the range, box and GROUP BY shapes of path G's micro-batch
# (its joints are 2-D; the main path's range group shares the n = 32 768
# aqp_batch key, as the key leaves the batch out), the main path's 3-D
# joint at q = 8, and path D's full-H shapes (the joint's exact pass, a 1-D
# RFF group)
T_SWEEPS = (("pairwise_scaled_ksum", {"n": 4096}),
            ("pairwise_scaled_ksum", {"n": CAPACITY}),
            ("aqp_batch_sums", {"n": 4096, "G": 256}),
            ("aqp_batch_sums", {"n": CAPACITY, "G": G_MICRO}),
            ("aqp_box_sums", {"n": CAPACITY, "d": 3, "G": G_MICRO}),
            ("aqp_box_sums", {"n": CAPACITY, "d": 2, "G": G_MICRO}),
            ("aqp_grouped_sums", {"n": CAPACITY, "d": 2, "G": N_CODES}),
            ("qmc_box_reduce", {"n": CAPACITY, "d": 3, "G": 384, "m": 4096}),
            ("rff_density", {"n": 2048, "d": 1, "G": CAPACITY}))
# the range kernels' winners also timed at another batch: their key has no G
T_CROSS = (("aqp_batch_sums", {"n": 4096, "G": 256}, G_MICRO),
           ("aqp_batch_sums", {"n": CAPACITY, "G": G_MICRO}, 256),
           ("aqp_box_sums", {"n": CAPACITY, "d": 3, "G": G_MICRO}, 384))
T_REPEATS = 5


def g_flat(ctx, per_key="per_a"):
    return [s for ci in range(G_CLIENTS) for s in ctx[per_key][ci]] + [ctx["gb"]]


def answer_rows(res) -> dict:
    """Answers as arrays, to compare bit for bit across processes."""
    return {"estimate": np.asarray([r.estimate for r in res], np.float64),
            "ci_lo": np.asarray([r.ci_lo for r in res], np.float64),
            "ci_hi": np.asarray([r.ci_hi for r in res], np.float64),
            "version": np.asarray([r.synopsis_version for r in res], np.int64),
            "n_effective": np.asarray([r.n_effective for r in res], np.int64),
            "path": np.asarray([r.path for r in res])}


def same_rows(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


def child(args, mode: str, **paths) -> dict:
    """Run this script in a fresh process in `mode` (`--child`); returns the
    JSON object its last line prints."""
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--child", mode, "--seed",
           str(args.seed)]
    for k, v in paths.items():
        cmd += [f"--{k}", str(v)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"child {mode} exited {out.returncode}:\n{out.stdout[-3000:]}\n"
                               f"{out.stderr[-3000:]}")
    for ln in out.stdout.splitlines()[:-1]:
        print(f"  child {mode} | {ln}")
    got = json.loads(out.stdout.splitlines()[-1])
    got["seconds"] = time.perf_counter() - t0
    return got


def phase_t(torch, rt, args, store, specs, stream, g_ctx):
    """Phase T: tile tuning.  Sweeps T_SWEEPS on the card (CUDA-event device
    time a launch, the module constants as candidate 0), each winner printed
    beside the constants with both times; the range kernels' winners also
    timed at another batch; the cache saved and checked by
    `scripts/validate_metrics.py --tuning`; path G (a) again under the cache,
    the sessions bit-identical to one execute; the main path's specs on a
    fresh store under the cache, within the parity tolerances of the untuned
    answers and bit-identical to a second process that loads the cache."""
    tune, q = rt["autotune"], rt["query"]
    want_untuned = answer_rows(store.query(specs))
    cache = ROOT / "build" / "tiles.json"
    cache.parent.mkdir(exist_ok=True)
    cache.unlink(missing_ok=True)
    card = card_line()
    sweeps, cross = [], []
    tune.reset()
    tune.use_cache(str(cache))
    try:
        for kernel, shape in T_SWEEPS:
            e = tune.sweep(kernel, shape, repeats=T_REPEATS)
            sweeps.append({k: e[k] for k in ("kernel", "shape", "tiles", "us", "default_tiles",
                                             "default_us", "repeats")}
                          | {"candidates": len(e["swept"])})
            print(f"phase T sweep {kernel} {shape}: winner {e['tiles']} {e['us']:.3f} us "
                  f"against the constants {e['default_tiles']} {e['default_us']:.3f} us "
                  f"({len(e['swept'])} candidates, median of {e['repeats']} CUDA-event windows "
                  f"of {e['launches']} launches, device time a launch; {card})")
        for kernel, shape, g in T_CROSS:
            e = next(x for x in sweeps if x["kernel"] == kernel and x["shape"] == shape)
            run = tune.SWEEPS[kernel].make({**shape, "G": g})
            times = {name: tune.time_launches(lambda t=tiles: run(t), T_REPEATS)[0]
                     for name, tiles in (("constants", e["default_tiles"]),
                                         ("winner", e["tiles"]))}
            cross.append({"kernel": kernel, "shape": {**shape, "G": g},
                          "tiles": e["tiles"], "us": times["winner"],
                          "default_tiles": e["default_tiles"], "default_us": times["constants"]})
            print(f"phase T {kernel} at G = {g} (swept at G = {shape['G']}): winner "
                  f"{e['tiles']} {times['winner']:.3f} us, constants {e['default_tiles']} "
                  f"{times['constants']:.3f} us (device time a launch; {card})")
        val = subprocess.run([sys.executable, str(ROOT / "scripts" / "validate_metrics.py"),
                              "--tuning", str(cache)], capture_output=True, text=True,
                             timeout=120)
        check(val.returncode == 0, f"phase T: validate_metrics --tuning failed: "
                                   f"{val.stdout}{val.stderr}")
        print(f"phase T: {cache.name}: {val.stdout.strip()}")
        hits0 = rt["obs"].get_registry().sum_counter("autotune.cache.hits")
        g_check_run(torch, rt, "phase T: path G (a) under the tuned cache", g_ctx["engine"],
                    g_ctx["per_a"], g_ctx["gb"], stream)
        check(rt["obs"].get_registry().sum_counter("autotune.cache.hits") > hits0
              or DEV != "cuda", "phase T: path G (a) never read the tuned cache")
        loop = {}
        for label in ("untuned", "tuned", "tuned", "untuned") * 2 + ("untuned", "tuned"):
            tune.reset()
            if label == "tuned":
                tune.use_cache(str(cache))
            run = lambda: closed_loop(torch, g_ctx["engine"], g_ctx["per_a"], [g_ctx["gb"]])
            if label in loop and "device_ms" not in loop[label]:
                loop[label]["device_ms"] = device_ms(torch, run)[0]
                continue
            _, wall, st, _ = run()
            rec = loop.setdefault(label, {"walls_ms": [], "deadline_flushes": []})
            rec["walls_ms"].append(wall * 1e3)
            rec["deadline_flushes"].append(st["flush_reasons"].get("deadline", 0))
        print("phase T: path G (a)'s closed loop, untuned and tuned in turn: " + "; ".join(
            f"{k} walls {', '.join(f'{w:.1f}' for w in v['walls_ms'])} ms (median "
            f"{np.median(v['walls_ms']):.1f}; deadline flushes {v['deadline_flushes']}), "
            f"device {v['device_ms']:.3f} ms a run (torch.profiler)" for k, v in loop.items()))
        fresh, fspecs, _, _ = build_store(args, rt, q)
        tuned = answer_rows(fresh.query(fspecs))
        del fresh
        other = child(args, "tuned", cache=cache, out=ROOT / "build" / "phase_t_child.npz")
        got = dict(np.load(ROOT / "build" / "phase_t_child.npz"))
        check(same_rows(got, tuned), "phase T: a second process under the same cache gave "
                                     "other bits")
        check(other["sweeps"] == 0 and (other["hits"] > 0 or DEV != "cuda"),
              f"phase T: the second process swept or missed the cache: {other}")
        scale = STREAM_ROWS / CAPACITY
        exact = want_untuned["path"] == "exact"
        check(np.array_equal(tuned["estimate"][exact], want_untuned["estimate"][exact]),
              "phase T: exact answers moved under the tuned cache")
        dev = 0.0
        for k in ("estimate", "ci_lo", "ci_hi"):
            ok, err = close(tuned[k][~exact], want_untuned[k][~exact], 1e-4, 1e-4 * scale)
            check(ok, f"phase T: tuned {k} off the untuned answers (max err {err})")
            dev = max(dev, err)
        print(f"phase T: the main path's {len(fspecs)} specs under the tuned cache: within rtol "
              f"1e-4 / atol {1e-4 * scale:.4g} of the untuned answers (max abs diff {dev:.4g}), "
              f"bit-identical in a second process that loaded the cache with no sweep "
              f"({other['hits']} cache hits, {other['seconds']:.1f} s)")
    finally:
        tune.reset()
    return {"sweeps": sweeps, "cross": cross, "closed_loop": loop,
            "max_abs_diff_untuned": dev, "card": card}


# --- path H: a warm restart ----------------------------------------------------

H_FIT_KERNELS = ("pairwise_scaled_ksum", "sv_matrix", "lscv_grid_sums", "gh_fused_sum")


def h_next_batch(seed: int) -> dict:
    """The batch both processes add after the restart."""
    rng = np.random.default_rng(seed + 1000)
    latent = rng.normal(0.0, 1.0, BATCH_ROWS)
    cols = {"loss": 2.0 + 0.5 * latent + rng.normal(0.0, 0.4, BATCH_ROWS),
            "latency_ms": np.exp(3.0 + 0.3 * latent + rng.normal(0.0, 0.3, BATCH_ROWS)),
            "grad_norm": 1.0 + 0.3 * latent + rng.normal(0.0, 0.5, BATCH_ROWS),
            "tokens": np.exp(5.0 + rng.normal(0.0, 0.6, BATCH_ROWS)),
            "model_id": rng.integers(0, N_CODES, BATCH_ROWS).astype(np.float64)}
    return {k: v.astype(np.float32) for k, v in cols.items()}


def sample_state(store) -> dict:
    """The reservoirs' and sketches' part of a snapshot, flattened for a
    bit comparison across processes."""
    tree, meta = store.to_state()
    out = {k: v for k, v in tree.items() if not k.startswith("cache/")}
    for part in ("columns", "joints", "categoricals"):
        out[f"meta/{part}"] = np.asarray(json.dumps(meta[part], sort_keys=True))
    return out


def restored_answers(torch, rt, store, g_ctx) -> tuple:
    """The saved store's, or the restored store's, answers to path G (a)'s
    specs and GROUP BY spec, then to (b)'s, on "cuda", with the launches,
    plain-version calls and cache misses of each."""
    ops = rt["ops"]
    out, stats = {}, {}
    for name, per in (("a", "per_a"), ("b", "per_b")):
        misses = store.cache.stats()["misses"]
        ops.reset_launch_counts()
        with plain_calls(rt["ref"]) as plain:
            res = store.query(g_flat(g_ctx, per))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        out.update({f"{name}/{k}": v for k, v in answer_rows(res).items()})
        stats[name] = {"launches": {k: v for k, v in counts.items() if v},
                       "groups": group_launches(g_flat(g_ctx, per)),
                       "plain": sum(plain.values()),
                       "misses": store.cache.stats()["misses"] - misses,
                       "plan_misses": store.shared_engine().plans.misses}
    return out, stats


def group_launches(specs) -> dict:
    """The launches one query of `specs` makes with every fit cached: one
    aqp_batch launch per column of the single-Range specs, one aqp_boxes
    launch per joint of the plain boxes, one aqp_grouped launch for the
    GROUP BY spec, and one qmc_reduce or rff_eval launch per full-H joint."""
    kinds = [(type(s.predicates[0]).__name__, s) for s in specs]
    cols = {s.predicates[0].column for k, s in kinds
            if k == "Range" and len(s.predicates) == 1 and s.group_by is None}
    boxes = {(s.predicates[0].columns, s.selector) for k, s in kinds if k == "Box"}
    return {"aqp_batch_sums": len(cols),
            "aqp_box_sums": sum(sel is None for _c, sel in boxes),
            "aqp_grouped_sums": int(any(s.group_by is not None for s in specs)),
            "fullh": sum(sel == "lscv_H" for _c, sel in boxes)}


def check_restored_launches(stats, what: str) -> None:
    """No fit kernel, no plain version, no synopsis or plan cache miss, and
    one launch per group (`group_launches`)."""
    for name, st in stats.items():
        c, want = st["launches"], st["groups"]
        check(not any(c.get(k) for k in H_FIT_KERNELS), f"{what} ({name}): fit launches {c}")
        check(st["plain"] == 0 and st["misses"] == 0 and st["plan_misses"] == 0,
              f"{what} ({name}): {st['plain']} plain calls, {st['misses']} cache misses, "
              f"{st['plan_misses']} plan misses")
        got = {k: c.get(k, 0) for k in ("aqp_batch_sums", "aqp_box_sums", "aqp_grouped_sums")}
        got["fullh"] = sum(c.get(k, 0) for k in FULLH_KERNELS)
        check(got == want, f"{what} ({name}): launches {c}, expected one a group: {want}")


def serve_cli(*extra) -> tuple:
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "aqp", "--rows",
           str(STREAM_ROWS), "--capacity", str(CAPACITY), "--clients", str(G_CLIENTS),
           "--per-client", str(G_PER_CLIENT), "--stream-every-ms", "100000", *extra]
    if DEV != "cuda":
        cmd += ["--device", DEV]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                             else "")
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True,
                         timeout=600)
    sec = time.perf_counter() - t0
    check(out.returncode == 0, f"serve {' '.join(extra)} exited {out.returncode}:\n"
                               f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout.splitlines(), sec


def path_h(torch, rt, args, g_ctx):
    """Path H: a warm restart.  Path G's store, with "cuda" fits from path G
    and plain ("torch") fits of (a)'s specs added here, answers (a)'s specs
    with the GROUP BY spec and (b)'s through its shared engines, is saved,
    and a fresh process loads it on the card and answers the same specs: the
    same bits, no cache miss, no fit launch, no plain-version call, one
    launch a group; both add the same batch and their reservoirs stay
    bit-identical.  Then serve's CLI at full size once with --snapshot-dir
    and once with --restore: the restored run prints its durability line,
    misses no synopsis and launches no fit kernel."""
    store = g_ctx["store"]
    want, stats = restored_answers(torch, rt, store, g_ctx)
    store.query(g_flat(g_ctx), backend="torch")
    backends = {key[2] for key, _v, _s in store.cache.entries()}
    check(backends == {"cuda", "torch"}, f"path H: cache backends {backends}")
    snap = ROOT / "build" / "path_h_snapshot"
    shutil.rmtree(snap, ignore_errors=True)
    t0 = time.perf_counter()
    step = store.save(str(snap))
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(p.stat().st_size for p in (snap / f"step_{step:08d}").iterdir())
    got = child(args, "restore", snapshot=snap, out=ROOT / "build" / "path_h_child.npz")
    theirs = dict(np.load(ROOT / "build" / "path_h_child.npz"))
    for key in want:
        check(np.array_equal(theirs[key], want[key]),
              f"path H: the restored process's {key} differs from the saving process's")
    check_restored_launches(got["stats"], "path H restored")
    store.add_batch(h_next_batch(args.seed))
    mine = sample_state(store)
    for key, v in mine.items():
        check(np.array_equal(theirs[f"state/{key}"], v),
              f"path H: {key} differs after the same add_batch in both processes")
    print(f"path H: saved {nbytes} bytes ({len(store.cache.entries())} cached synopses of "
          f"both backends) in {save_ms:.1f} ms; the restored process loaded them on "
          f"{got['device']} in {got['load_ms']:.1f} ms and answered "
          f"{len(want['a/estimate']) + len(want['b/estimate'])} specs with the same bits, "
          f"0 cache misses, 0 fit launches, no plain-version call (launches "
          f"{got['stats']}); after the same add_batch the reservoirs and sketches are "
          f"bit-identical ({len(mine)} arrays)")
    serve_snap = ROOT / "build" / "path_h_serve_snapshot"
    shutil.rmtree(serve_snap, ignore_errors=True)
    lines1, sec1 = serve_cli("--snapshot-dir", str(serve_snap))
    check(any(f"1 snapshots written to {serve_snap}" in ln for ln in lines1),
          "path H: serve --snapshot-dir wrote no start-up snapshot")
    mpath = ROOT / "build" / "path_h_serve_metrics.json"
    lines2, sec2 = serve_cli("--snapshot-dir", str(serve_snap), "--restore",
                             "--metrics-out", str(mpath))
    durable = next((ln for ln in lines2 if "durability: warm-started" in ln), None)
    check(durable is not None, "path H: serve --restore printed no durability line")
    cache_line = next(ln for ln in lines2 if "synopsis cache:" in ln)
    check(" / 0 misses" in cache_line, f"path H: serve --restore refitted: {cache_line}")
    metrics = json.loads(mpath.read_text())
    fits = [e["labels"] for e in metrics.get("counters", {}).get("kernel.calls", [])
            if e["labels"].get("kernel") in H_FIT_KERNELS]
    launched = sorted({e["labels"]["kernel"]
                       for e in metrics.get("counters", {}).get("kernel.calls", [])})
    check(not fits and ("aqp_batch_sums" in launched or DEV != "cuda"),
          f"path H: serve --restore launched fit kernels {fits} (kernels {launched})")
    head = next(ln for ln in lines2 if "queries/s" in ln)
    for ln in lines1 + lines2:
        if ln.startswith("[serve:aqp]") and ("durability" in ln or "queries/s" in ln
                                             or "synopsis cache" in ln):
            print(f"path H serve | {ln}")
    summary = {"save_ms": save_ms, "load_ms": got["load_ms"], "snapshot_bytes": nbytes,
               "cached_synopses": len(store.cache.entries()), "restored": got["stats"],
               "saving": stats, "child_s": got["seconds"],
               "serve": {"snapshot_s": sec1, "restore_s": sec2, "restored_line": head,
                         "durability": durable, "cache": cache_line, "kernels": launched},
               "card": card_line()}
    print(f"path H: serve --snapshot-dir {sec1:.1f} s, --restore {sec2:.1f} s with no fit "
          f"launch and 0 synopsis-cache misses (kernels {launched})")
    return summary


# --- phase I: binned PLUGIN, the distributed selectors, the examples -----------

I_GRID = 1024                           # bins of the binned PLUGIN (the reference's default)
I_WORLD = 4                             # the shares launched in one process
I_D4 = (3000, 50)                       # the distributed example's LSCV_h: n, n_h (d = 4)
I_SLAB_N = 163_840                      # the slabbed LSCV_h: a whole S of 107 GB
I_CMP_N = 65_536                        # its g against the "torch" backend's at this n
G_F32_RES = 4 * 2.0 ** -24              # 4 float32 ulps of g, relative
I_EXAMPLES = (("torch_quickstart.py",), ("torch_aqp_database.py",),
              ("torch_distributed_bandwidth.py", "--world", "1"))


def synced_s(torch, fn) -> tuple:
    """(fn(), CUDA-synced wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def i_counted(torch, ops, what: str, fn) -> tuple:
    """(fn(), seconds, the kernels it launched): every launch count set to
    0 just before and read just after."""
    ops.reset_launch_counts()
    out, sec = synced_s(torch, fn)
    made = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"{what}: {sec * 1e3:.1f} ms; launches {made}")
    return out, sec, made


def i_binned(torch, rt, stream) -> dict:
    """The binned PLUGIN on the 1 000 000 streamed rows of `loss`, on the
    card twice (the same bits), against its plain version on the CPU, and
    its h against the exact PLUGIN h of the pairwise kernel on the same
    rows."""
    binned, plugin = rt["binned"], rt["plugin"]
    rows = stream["loss"]
    x = torch.as_tensor(rows, device=DEV)

    def run(xx, device):
        h = binned.binned_plugin_bandwidth(xx, I_GRID, device=device)
        lo, hi = torch.min(xx) - 1e-3, torch.max(xx) + 1e-3
        grid, counts = binned.linear_binning(xx, lo, hi, I_GRID, device=device)
        kde = binned.binned_kde_fft(grid, counts, h, device=device)
        return h, grid, counts, kde

    first, t_first = synced_s(torch, lambda: run(x, DEV))
    again, t_binned = synced_s(torch, lambda: run(x, DEV))
    for name, a, b in zip(("h", "grid", "counts", "KDE"), first, again):
        check(torch.equal(a, b), f"phase I: two binned runs gave different {name} bits")
    exact, t_exact = synced_s(torch, lambda: plugin.plugin_bandwidth(x, device=DEV))
    h, grid, counts, kde = first
    hp, gridp, countsp, kdep = run(torch.as_tensor(rows), "cpu")
    check(torch.equal(grid.cpu(), gridp), "phase I: the binned grid differs from the CPU's")
    err_c = held(counts.cpu(), countsp, 1e-4, 1e-4 * float(countsp.max()),
                 "phase I binned counts against the CPU")
    err_k = held(kde.cpu(), kdep, 1e-4, 1e-4 * float(kdep.max()),
                 "phase I binned KDE against the CPU")
    psi = {}
    for r, gbw in ((6, exact.g1), (4, exact.g2)):
        a = float(binned.binned_psi_r(grid, counts, gbw, r, device=DEV))
        b = float(binned.binned_psi_r(gridp, countsp, gbw.cpu(), r, device="cpu"))
        held(a, b, 1e-3, 0.0, f"phase I binned Psi{r} against the CPU")
        psi[f"psi{r}"] = (a, b)
    held(float(h), float(hp), 1e-3, 0.0, "phase I binned h against the CPU")
    rel = abs(float(h) - float(exact.h)) / float(exact.h)
    check(rel < 0.02, f"phase I: binned h {float(h)} is {rel:.2%} from the exact {float(exact.h)}")
    print(f"phase I binned PLUGIN on {rows.shape[0]} rows of loss, g = {I_GRID}: h = "
          f"{float(h):.6f} in {t_binned * 1e3:.2f} ms warm ({t_first * 1e3:.2f} ms first, with "
          f"the bins and the grid's KDE), exact PLUGIN h = {float(exact.h):.6f} on the pairwise "
          f"kernel in {t_exact * 1e3:.2f} ms ({rel:.3%} apart); two runs bit-identical; against "
          f"the CPU: counts {err_c:.3g}, KDE {err_k:.3g} max abs, Psi6 / Psi4 {psi}, h "
          f"{float(hp):.6f}")
    return {"rows": int(rows.shape[0]), "grid": I_GRID, "h": float(h), "h_exact": float(exact.h),
            "rel": rel, "binned_ms": t_binned * 1e3, "binned_first_ms": t_first * 1e3,
            "exact_ms": t_exact * 1e3}


def share_fraction(torch, tri, n: int, k: int, blocks) -> float:
    """The pairs of a (begin, count) share of tiles of side k over all
    n(n-1)/2: the share's part of a whole launch's work and bytes, so its
    bound is the whole's times this."""
    begin, count = blocks
    q, l = tri.bx_to_ql(torch.arange(begin, begin + count))
    rows, cols = torch.clamp(n - q * k, max=k), torch.clamp(n - l * k, max=k)
    pairs = torch.where(q == l, rows * (rows - 1) // 2, rows * cols).sum()
    return int(pairs) / (n * (n - 1) // 2)


def i_shares(torch, rt, x, g1, g2, lscv_in) -> dict:
    """The four shares of a world of 4 launched in one process: their sums
    against one whole launch (pairwise K6 and K4; the LSCV_h grid per grid
    point), and one share's time beside the whole's."""
    ops, tri, kpr, klg = rt["ops"], rt["triangle"], rt["pairwise_reduce"], rt["lscv_grid"]
    n = x.shape[0]
    n_tri = tri.n_tri_tiles(-(-n // kpr.tile_for(n, kpr.TILE)))
    shares = [tri.share(n_tri, r, I_WORLD) for r in range(I_WORLD)]
    out = {"pairwise_tiles": n_tri, "pairwise_shares": shares}
    for kind, g in (("k6", g1), ("k4", g2)):
        whole = ops.pairwise_scaled_ksum(x, g, kind, tile=kpr.TILE)
        check(torch.equal(whole, ops.pairwise_scaled_ksum(x, g, kind, tile=kpr.TILE,
                                                          blocks=(0, n_tri))),
              f"phase I: pairwise {kind} over all its tiles as blocks changed its bits")
        parts = [float(ops.pairwise_scaled_ksum(x, g, kind, tile=kpr.TILE, blocks=s))
                 for s in shares]
        held(sum(parts), float(whole), PAIR_RTOL, 0.0,
             f"phase I: the {I_WORLD} pairwise {kind} shares against the whole")
    w_ms = time_ms(torch, lambda: ops.pairwise_scaled_ksum(x, g1, "k6", tile=kpr.TILE))
    s_ms = time_ms(torch, lambda: ops.pairwise_scaled_ksum(x, g1, "k6", tile=kpr.TILE,
                                                            blocks=shares[0]))
    s_bound = (bound_ms("pairwise_scaled_ksum", (x, g1), {"kind": "k6"})[0]
               * share_fraction(torch, tri, n, kpr.TILE, shares[0]))
    out.update(pairwise_whole_ms=w_ms, pairwise_share_ms=s_ms, pairwise_share_bound_ms=s_bound)
    x2, m, hg, c_k, c_kk = lscv_in
    s_mat = ops.sv_matrix(x2, m)
    g_tri = tri.n_tri_tiles(-(-n // klg.TILE))
    g_shares = [tri.share(g_tri, r, I_WORLD) for r in range(I_WORLD)]
    whole = ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk)
    parts = sum(ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk, blocks=s).double()
                for s in g_shares)
    held(parts.cpu(), whole.cpu(), 1e-4, 1e-6 * float(whole.abs().max()),
         f"phase I: the {I_WORLD} lscv_grid shares against the whole")
    gw_ms = time_ms(torch, lambda: ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk), reps=5, warm=1)
    gs_ms = time_ms(torch, lambda: ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk,
                                                              blocks=g_shares[0]), reps=5, warm=1)
    del s_mat
    gs_bound = (bound_ms("lscv_grid_sums", (x2, m, hg), {}, klg.POLY_SHARE)[0]
                * share_fraction(torch, tri, n, klg.TILE, g_shares[0]))
    out.update(grid_tiles=g_tri, grid_shares=g_shares, grid_whole_ms=gw_ms, grid_share_ms=gs_ms,
               grid_share_bound_ms=gs_bound)
    print(f"phase I shares of a world of {I_WORLD}, n = {n}: pairwise {n_tri} tiles as "
          f"{shares}, K6 / K4 sums within {PAIR_RTOL} of one launch; one share "
          f"{s_ms:.4f} ms (bound {s_bound:.4f}) against the whole's {w_ms:.4f} (median of 15); "
          f"lscv_grid {g_tri} tiles as {g_shares}, every grid point within 1e-4; one share "
          f"{gs_ms:.3f} ms (bound {gs_bound:.3f}) against the whole's {gw_ms:.3f} (median of 5)")
    return out


def i_distributed(torch, rt, stream) -> dict:
    """The distributed selectors on "cuda" over NCCL with a world of one
    rank (a file store): each call's launches counted, no plain version,
    each against the single-device kernels."""
    D, plugin, lscv, red, G = (rt["distributed"], rt["plugin"], rt["lscv"], rt["reductions"],
                               rt["gaussian"])
    ops, ref = rt["ops"], rt["ref"]
    x = torch.as_tensor(stream["loss"][:CAPACITY], device=DEV)
    fit = plugin.plugin_bandwidth(x, device=DEV)
    g1, g2 = fit.g1.reshape(1), fit.g2.reshape(1)
    x2 = x[:, None]
    sigma_inv = lscv._inv(lscv.covariance(x2))
    hg = lscv.h_grid_for(CAPACITY, 1, 150, device=DEV)
    c_k, c_kk, _ = rt["gaussian"].lscv_h_consts(1, torch.linalg.det(lscv.covariance(x2)))
    out = i_shares(torch, rt, x, g1, g2, (x2, sigma_inv, hg, c_k, c_kk))
    x4 = torch.as_tensor(np.stack([stream[c][:I_D4[0]] for c in NUMERIC], axis=1), device=DEV)
    with tempfile.TemporaryDirectory() as tmp:
        D.init_group(os.path.join(tmp, "store"), 0, 1, device=DEV, timeout_s=120)
        try:
            with plain_calls(ref) as plain:
                (s6, s4), t_psi0, c_psi = i_counted(
                    torch, ops, "phase I sharded_plugin_psi_sums",
                    lambda: D.sharded_plugin_psi_sums(x, g1, g2))
                (h1, _g, gv1), t_l1, c_l1 = i_counted(
                    torch, ops, "phase I distributed_lscv_h d=1",
                    lambda: D.distributed_lscv_h(x, n_h=150))
                (h4, _g, gv4), t_l4, c_l4 = i_counted(
                    torch, ops, "phase I distributed_lscv_h d=4",
                    lambda: D.distributed_lscv_h(x4, n_h=I_D4[1]))
            check(sum(plain.values()) == 0, f"phase I: the distributed calls ran plain versions "
                                            f"{ {k: v for k, v in plain.items() if v} }")
            # the first call's wall holds NCCL's set-up of its communicator
            _r, t_psi = synced_s(torch, lambda: D.sharded_plugin_psi_sums(x, g1, g2))

            def k4(d):
                return G.k4(d / g2)

            sk4, t_sk4 = synced_s(torch, lambda: D.sharded_pairwise_reduce(k4, x))
            backend = rt["dist"].get_backend()
        finally:
            rt["dist"].destroy_process_group()
    runs = {n: len(list(rt["lscv_grid"].slab_walk(n, None, D.SLAB_BYTES)))
            for n in (CAPACITY, I_D4[0])}
    for what, made, want in (("sharded_plugin_psi_sums", c_psi, {"pairwise_scaled_ksum": 2}),
                             ("distributed_lscv_h d=1", c_l1,
                              {"sv_matrix": runs[CAPACITY], "lscv_grid_sums": runs[CAPACITY]}),
                             ("distributed_lscv_h d=4", c_l4,
                              {"sv_matrix": runs[I_D4[0]], "lscv_grid_sums": runs[I_D4[0]]})):
        check(made == want, f"phase I: {what} launched {made}, expected {want}")
    held(float(s6), float(ops.pairwise_scaled_ksum(x, g1, "k6")), PAIR_RTOL, 0.0,
         "phase I: sharded Psi6 sum against one pairwise launch")
    held(float(s4), float(ops.pairwise_scaled_ksum(x, g2, "k4")), PAIR_RTOL, 0.0,
         "phase I: sharded Psi4 sum against one pairwise launch")
    for what, (h, gv), xx, n_h in (("d=1", (h1, gv1), x, 150), ("d=4", (h4, gv4), x4, I_D4[1])):
        one = lscv.lscv_h(xx, n_h=n_h, device=DEV)
        check(torch.equal(h, one.h), f"phase I: distributed LSCV_h {what} h {float(h)} against "
                                     f"the single device's {float(one.h)}")
        held(gv.cpu(), one.g_values.cpu(), 1e-3, 0.0, f"phase I: distributed LSCV_h {what} g")
    plain_k4 = float(red.pairwise_reduce(k4, x))
    held(float(sk4), plain_k4, 1e-4, 0.0, "phase I: sharded_pairwise_reduce(k4)")
    print(f"phase I distributed on {backend}, 1 rank: Psi sums {float(s6):.4f} / "
          f"{float(s4):.4f} (2 pairwise launches, {t_psi0 * 1e3:.1f} ms first, "
          f"{t_psi * 1e3:.2f} ms warm); LSCV_h d=1 n={CAPACITY} h={float(h1):.6f} in "
          f"{t_l1 * 1e3:.1f} ms ({runs[CAPACITY]} slabs of S: as many sv_matrix and lscv_grid "
          f"launches), d=4 n={I_D4[0]} h={float(h4):.6f} in {t_l4 * 1e3:.1f} ms "
          f"({runs[I_D4[0]]} slab), the single device's h; sharded K4 sum "
          f"{float(sk4):.4f} against {plain_k4:.4f} in {t_sk4 * 1e3:.1f} ms")
    out.update(backend=backend, psi_first_ms=t_psi0 * 1e3, psi_ms=t_psi * 1e3,
               lscv_d1_ms=t_l1 * 1e3, lscv_d4_ms=t_l4 * 1e3, sharded_k4_ms=t_sk4 * 1e3,
               h_d1=float(h1), h_d4=float(h4))
    return out


def oracle_lscv_g(torch, x, m, hg, idx, c_k, c_kk, r_k, rows: int = 256):
    """float64 g(h) of LSCV_h (eq. 43's sums over i < j) at the grid points
    `idx` of hg, on the same float32 x, M, grid and constants."""
    xd, md = x.double(), m.double()
    n, d = xd.shape
    h = hg.double()[idx]
    acc = torch.zeros(len(idx), dtype=torch.float64, device=x.device)
    j = torch.arange(n, device=x.device)
    for a in range(0, n, rows):
        v = xd[a:a + rows, None, :] - xd[None, :, :]
        s = torch.einsum("rnd,de,rne->rn", v, md, v)
        i = torch.arange(a, min(n, a + rows), device=x.device)
        s = torch.where(i[:, None] < j[None, :], s, torch.inf)[None]
        acc += (float(c_kk) * torch.exp(-s * (0.25 / h ** 2)[:, None, None])
                - 2.0 * float(c_k) * torch.exp(-s * (0.5 / h ** 2)[:, None, None])).sum(dim=(1, 2))
    return h ** (-d) * (2.0 / (n * n) * acc + float(r_k) / n)


def i_slabs(torch, rt, stream) -> dict:
    """The "cuda" distributed LSCV_h at I_SLAB_N rows of `loss`, whose whole
    S would not fit the card, on one NCCL rank: its peak memory within the
    slab budget plus 1 GB, one sv_matrix and one lscv_grid launch a run of
    the walk, no plain version; at I_CMP_N its g values against the
    "torch" backend (rtol 1e-3); at both n its h a float64 oracle's best
    grid point, or one whose float64 g lies within float32 resolution of it
    (the oracle taken over the grid points around both backends' picks; the
    two backends' h may differ: the g of neighbouring grid points differ by
    about 1e-7 there, and the "torch" backend's float32 slab sums are 2e-6
    from float64 where the kernels' are 4e-7: PERF.md §6,
    `scripts/lscv_argmin_check.py`); the largest run's slab against the
    whole S's bits and its sums against the same tiles over the whole S at
    CAPACITY; the largest run's two launches at I_SLAB_N timed beside their
    bounds."""
    D, lscv, G, tri = rt["distributed"], rt["lscv"], rt["gaussian"], rt["triangle"]
    ops, ref, klg = rt["ops"], rt["ref"], rt["lscv_grid"]
    xb = torch.as_tensor(stream["loss"][:I_SLAB_N], device=DEV)
    runs = list(klg.slab_walk(I_SLAB_N, None, D.SLAB_BYTES))
    with tempfile.TemporaryDirectory() as tmp:
        D.init_group(os.path.join(tmp, "store"), 0, 1, device=DEV, timeout_s=120)
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with plain_calls(ref) as plain:
                (h, _g, gv), t_big, made = i_counted(
                    torch, ops, f"phase I slabbed distributed_lscv_h n={I_SLAB_N}",
                    lambda: D.distributed_lscv_h(xb, n_h=150))
                peak = torch.cuda.max_memory_allocated() - base
                x_c = torch.as_tensor(stream["loss"][:I_CMP_N], device=DEV)
                (h_c, _g, gv_c), t_c, made_c = i_counted(
                    torch, ops, f"phase I slabbed distributed_lscv_h n={I_CMP_N}",
                    lambda: D.distributed_lscv_h(x_c, n_h=150))
            check(sum(plain.values()) == 0, f"phase I: the slabbed calls ran plain versions "
                                            f"{ {k: v for k, v in plain.items() if v} }")
            (h_t, _g, gv_t), t_t = synced_s(
                torch, lambda: D.distributed_lscv_h(x_c, n_h=150, backend="torch"))
        finally:
            rt["dist"].destroy_process_group()
    whole_gb = 4 * I_SLAB_N ** 2 / 1e9
    check(peak <= D.SLAB_BYTES + (1 << 30),
          f"phase I: the slabbed LSCV_h at n={I_SLAB_N} peaked at {peak / 1e9:.3f} GB above "
          f"its inputs, beyond the {D.SLAB_BYTES / 1e9:.3f} GB slab budget plus 1 GB")
    want = {"sv_matrix": len(runs), "lscv_grid_sums": len(runs)}
    check(made == want, f"phase I: the slabbed LSCV_h launched {made}, expected {want}")
    check(bool(torch.isfinite(gv).all()), "phase I: the slabbed LSCV_h's g values not finite")
    held(gv_c.cpu(), gv_t.cpu(), 1e-3, 0.0,
         f"phase I: slabbed LSCV_h g at n={I_CMP_N} against the torch backend")
    argmins = {}
    for n_, xs, g_cuda, g_torch in ((I_CMP_N, x_c, gv_c, gv_t), (I_SLAB_N, xb, gv, None)):
        xs = xs[:, None]
        sigma = lscv.covariance(xs)
        c_k, c_kk, r_k = G.lscv_h_consts(1, torch.linalg.det(sigma))
        hg_ = lscv.h_grid_for(n_, 1, 150, device=DEV)
        ks = [int(torch.argmin(g)) for g in (g_cuda, g_torch) if g is not None]
        idx = list(range(max(0, min(ks) - 2), min(150, max(ks) + 3)))
        g64 = oracle_lscv_g(torch, xs, lscv._inv(sigma), hg_, idx, c_k, c_kk, r_k)
        best = float(g64.min())
        gaps = [(float(g64[idx.index(k)]) - best) / abs(best) for k in ks]
        k64 = idx[int(torch.argmin(g64))]
        # the kernels' pick is the float64 minimum, or a grid point whose
        # float64 g lies within float32 resolution (4 ulps) of it
        check(gaps[0] <= G_F32_RES, f"phase I: slabbed LSCV_h at n={n_} picks grid point "
                                    f"{ks[0]}, the float64 oracle {k64}: its g {gaps[0]:.3g} "
                                    f"above the minimum, relative")
        argmins[n_] = {"cuda": ks[0], "torch": ks[1] if len(ks) > 1 else None,
                       "float64": k64, "gaps": gaps}
    # the largest run of the walk at CAPACITY: bits against the whole S
    x = torch.as_tensor(stream["loss"][:CAPACITY], device=DEV)[:, None]
    m = lscv._inv(lscv.covariance(x))
    hg = lscv.h_grid_for(CAPACITY, 1, 150, device=DEV)
    c_k, c_kk, _ = G.lscv_h_consts(1, torch.linalg.det(lscv.covariance(x)))
    b, c, c0, c1 = max(klg.slab_walk(CAPACITY, None, D.SLAB_BYTES),
                       key=lambda r: (r[3] - r[2]) * r[3])
    whole = ops.sv_matrix(x, m)
    slab = ops.sv_matrix(x, m, cols=(c0, c1))
    check(torch.equal(slab, whole[:c1, c0:c1]),
          f"phase I: sv_matrix's slab of columns {c0}..{c1} differs from the whole S's bits")
    check(torch.equal(ops.lscv_grid_sums_from_s(slab, hg, c_k, c_kk, blocks=(b, c),
                                                slab=(c0, CAPACITY)),
                      ops.lscv_grid_sums_from_s(whole, hg, c_k, c_kk, blocks=(b, c))),
          f"phase I: lscv_grid over the slab of tiles {b}..{b + c} differs from the whole S's")
    held_dev(torch, slab, ref.sv_matrix(x, m, cols=(c0, c1)), SV_RTOL, SV_ATOL,
             f"phase I: sv_matrix slab of columns {c0}..{c1} against its plain version")
    del whole, slab
    # the largest run at I_SLAB_N, each launch timed beside its bound
    xb2 = xb[:, None]
    mb = lscv._inv(lscv.covariance(xb2))
    hgb = lscv.h_grid_for(I_SLAB_N, 1, 150, device=DEV)
    b, c, c0, c1 = max(runs, key=lambda r: (r[3] - r[2]) * r[3])
    sv_ms = time_ms(torch, lambda: ops.sv_matrix(xb2, mb, cols=(c0, c1)), reps=5, warm=1)
    slab = ops.sv_matrix(xb2, mb, cols=(c0, c1))
    gr_ms = time_ms(torch, lambda: ops.lscv_grid_sums_from_s(
        slab, hgb, c_k, c_kk, blocks=(b, c), slab=(c0, I_SLAB_N)), reps=5, warm=1)
    del slab
    pairs = (c0 + c1 - 1) * (c1 - c0) // 2                 # i < j, j in [c0, c1)
    sv_bytes = 4 * ((c1 - c0) * c1 + I_SLAB_N + 1)
    sv_bound = max(sv_bytes / PEAK_BYTES, 3 * pairs / PEAK_FP32) * 1e3
    run_pairs = share_fraction(torch, tri, I_SLAB_N, klg.TILE, (b, c)) * (
        I_SLAB_N * (I_SLAB_N - 1) // 2)
    gr_bound = max(4 * run_pairs / PEAK_BYTES, 6 * 150 * run_pairs / PEAK_FP32) * 1e3
    out = {"n": I_SLAB_N, "whole_s_gb": whole_gb, "slab_budget_bytes": D.SLAB_BYTES,
           "peak_bytes": peak, "runs": len(runs), "seconds": t_big, "h": float(h),
           "cmp_n": I_CMP_N, "cmp_cuda_s": t_c, "cmp_torch_s": t_t, "argmins": argmins,
           "cmp_launches": made_c, "largest_run": [b, c, c0, c1],
           "sv_slab_ms": sv_ms, "sv_slab_bound_ms": sv_bound,
           "grid_slab_ms": gr_ms, "grid_slab_bound_ms": gr_bound}
    print(f"phase I slabbed LSCV_h on 1 rank, n={I_SLAB_N} (whole S {whole_gb:.1f} GB): "
          f"{len(runs)} runs of the walk, as many sv_matrix and lscv_grid launches, "
          f"{t_big:.2f} s, peak {peak / 1e9:.3f} GB above its inputs (budget "
          f"{D.SLAB_BYTES / 1e9:.3f} GB + 1 GB), h={float(h):.6f}; at n={I_CMP_N} g within "
          f"1e-3 of the torch backend ({t_c:.2f} s against {t_t:.2f} s); grid points picked "
          f"(cuda / torch / float64 oracle) {argmins}; the "
          f"largest run's slab at n={CAPACITY} the whole S's bits, its sums the same tiles' "
          f"over the whole S; at n={I_SLAB_N} the largest run ({c} tiles, slab of columns "
          f"{c0}..{c1}) sv_matrix {sv_ms:.3f} ms (bound {sv_bound:.3f}, bytes) and "
          f"lscv_grid {gr_ms:.3f} ms (bound {gr_bound:.3f}, operations), median of 5")
    return out


def i_examples() -> dict:
    """The three torch examples on the card, each a process of its own."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                             else "")
    secs = {}
    for name, *extra in I_EXAMPLES:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, str(ROOT / "examples" / name), *extra],
                             cwd=str(ROOT), env=env, capture_output=True, text=True,
                             timeout=300)
        secs[name] = time.perf_counter() - t0
        check(out.returncode == 0, f"phase I: {name} exited {out.returncode}:\n"
                                   f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        for ln in out.stdout.strip().splitlines()[-3:]:
            print(f"phase I {name} | {ln}")
    print("phase I examples: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    return secs


def phase_i(torch, rt, stream) -> dict:
    """Phase I: the binned PLUGIN at 1 000 000 rows, the distributed
    selectors' kernel shares and NCCL calls, and the three torch examples."""
    summary = {"binned": i_binned(torch, rt, stream),
               "distributed": i_distributed(torch, rt, stream),
               "slabs": i_slabs(torch, rt, stream),
               "examples_s": i_examples(), "card": card_line()}
    return summary


# --- phase L: the LM stack (ROADMAP queue 1.15a) ------------------------------------

L_ARCH = "llama3.2-1b"
L_BATCH, L_PROMPT, L_NEW = 4, 128, 32       # run_lm's path at full size
L_STEPS = 8                                 # decode steps of every other architecture
L_BF16_RTOL, L_BF16_ATOL = 5e-2, 6e-2       # tests/test_models.py:86-91
L_F32_RTOL, L_F32_ATOL = 2e-4, 1e-4         # the CPU parity tests'; atol x max |logit|
L_F32_LAYERS = 2
# layers kept of every other architecture at full width (None: all of them);
# MoE decode is held to apply with no capacity drops (see l_other)
L_DEPTH = {"stablelm-12b": 4, "glm4-9b": 4, "qwen2.5-14b": 4, "falcon-mamba-7b": 4,
           "internvl2-2b": None, "zamba2-1.2b": 7, "qwen3-moe-235b-a22b": 2,
           "granite-moe-1b-a400m": None, "whisper-base": None}
L_SMOKE = False                             # True only to rehearse on the CPU
PEAK_BF16 = 989e12                          # H100 SXM, dense bf16 tensor cores


def l_config(arch: str, layers=None):
    """The published config of `arch` (its smoke config when rehearsing),
    cut to `layers` layers."""
    import dataclasses

    from repro_torch.configs.base import get_config
    cfg = get_config(arch, smoke=L_SMOKE)
    return cfg if layers is None or L_SMOKE else dataclasses.replace(cfg, n_layers=layers)


def l_bounds(cfg, tokens: int, kv_bytes: int) -> tuple:
    """(prefill bound ms, decode-step bound ms): the larger of 2 x params x
    tokens FLOPs at the bf16 peak and the weights' (and the KV cache's)
    bytes at the HBM rate."""
    p = cfg.param_count()
    prefill = max(2 * p * tokens / PEAK_BF16, 2 * p / PEAK_BYTES) * 1e3
    decode = max(2 * p * L_BATCH / PEAK_BF16, (2 * p + kv_bytes) / PEAK_BYTES) * 1e3
    return prefill, decode


def l_decode_vs_apply(torch, model, tokens, logits, extra, what: str) -> float:
    """The logits each new token was chosen from (prefill's last position,
    then one decode step each) against the teacher-forced apply on the same
    tokens, at the reference's bf16 tolerance."""
    n = logits.shape[1]
    with torch.no_grad():
        full = model.apply({"tokens": tokens[:, :-1], **extra})
    return held_dev(torch, logits.float(), full[:, -n:].float(), L_BF16_RTOL, L_BF16_ATOL,
                    f"{what}: decode against apply")


def l_serve(torch, serve) -> tuple:
    """(a) run_lm on llama3.2-1b at full size: two runs with the same bits,
    decode against apply, prefill and decode steps timed."""
    from repro_torch.train.serve_step import pad_caches

    args = argparse.Namespace(device=DEV, arch=L_ARCH, smoke=L_SMOKE, batch=L_BATCH,
                              prompt_len=L_PROMPT, max_new=L_NEW)
    res = serve.run_lm(args)
    model, cfg, (r0, r1) = res["model"], res["cfg"], res["runs"]
    check(torch.equal(r0["tokens"], r1["tokens"]), "phase L (a): two runs, other tokens")
    check(torch.equal(r0["logits"], r1["logits"]), "phase L (a): two runs, other logits bits")
    check(bool(torch.isfinite(r1["logits"]).all()), "phase L (a): non-finite logits")
    err = l_decode_vs_apply(torch, model, r1["tokens"], r1["logits"], res["extra"],
                            "phase L (a)")
    batch = {"tokens": res["prompt"], **res["extra"]}
    with torch.no_grad():
        prefill_ms = time_ms(torch, lambda: model.prefill(batch), reps=10, warm=2)
        prefill_dev, prefill_k = device_ms(torch, lambda: model.prefill(batch))
        _, cache = model.prefill(batch)
        cache = pad_caches(cache, L_PROMPT + L_NEW)
        tok = r1["tokens"][:, L_PROMPT:L_PROMPT + 1]
        step = lambda: model.decode_step(cache, tok, L_PROMPT)      # noqa: E731
        decode_ms = time_ms(torch, step, reps=20, warm=3)
        decode_dev, decode_k = device_ms(torch, step)
    kv_bytes = sum(a.numel() * a.element_size() for a in cache.values())
    b_prefill, b_decode = l_bounds(cfg, L_BATCH * L_PROMPT, kv_bytes)
    out = {"arch": cfg.name, "params": cfg.param_count(), "batch": L_BATCH,
           "prompt": L_PROMPT, "new": L_NEW, "first_run_s": r0["seconds"],
           "warm_run_s": r1["seconds"], "tokens_per_s": res["tokens_per_s"],
           "prefill_ms": prefill_ms, "prefill_device_ms": prefill_dev,
           "prefill_kernels": prefill_k, "prefill_bound_ms": b_prefill,
           "decode_ms": decode_ms, "decode_device_ms": decode_dev,
           "decode_kernels": decode_k, "decode_bound_ms": b_decode,
           "decode_vs_apply_err": err, "same_bits": True}
    print(f"phase L (a) {cfg.name}: prefill {L_BATCH} x {L_PROMPT} {prefill_ms:.3f} ms "
          f"(device {prefill_dev:.3f} ms in {prefill_k} kernels; bound {b_prefill:.3f}), "
          f"decode step {decode_ms:.3f} ms (device {decode_dev:.3f} ms in {decode_k} "
          f"kernels; bound {b_decode:.3f}), {res['tokens_per_s']:.1f} tokens/s warm; "
          f"decode against apply {err:.4g}; two runs bit-identical")
    return out, model, cfg, res


def l_float32(torch, model, cfg, res) -> dict:
    """(b) a float32 copy of the first L_F32_LAYERS layers at full width, on
    the card and then on the CPU: prefill and L_STEPS decode steps on (a)'s
    tokens, logits held at the CPU parity tests' tolerance."""
    import dataclasses

    from repro_torch.models import build_model
    from repro_torch.train.serve_step import pad_caches

    cfg32 = dataclasses.replace(cfg, n_layers=L_F32_LAYERS, param_dtype="float32")
    keep = {k: v.float() for k, v in model.state_dict().items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < L_F32_LAYERS}
    m32 = build_model(cfg32, DEV, torch.Generator(device=DEV).manual_seed(0))
    m32.load_state_dict(keep, strict=True)
    tokens = res["runs"][1]["tokens"]

    def run(m, dev):
        with torch.no_grad():
            logits, cache = m.prefill({"tokens": res["prompt"].to(dev)})
            cache = pad_caches(cache, L_PROMPT + L_STEPS)
            outs = [logits]
            for i in range(L_STEPS):
                tok = tokens[:, L_PROMPT + i:L_PROMPT + i + 1].to(dev)
                outs.append(m.decode_step(cache, tok, L_PROMPT + i)[0])
        return [o.cpu() for o in outs]

    t0 = time.perf_counter()
    card = run(m32, DEV)
    t_card = time.perf_counter() - t0
    m32.to("cpu")
    t0 = time.perf_counter()
    host = run(m32, "cpu")
    t_cpu = time.perf_counter() - t0
    worst, scale = 0.0, 0.0
    for i, (a, b) in enumerate(zip(card, host)):
        scale = float(b.abs().max())
        worst = max(worst, held_dev(torch, a, b, L_F32_RTOL, L_F32_ATOL * scale,
                                    f"phase L (b): float32 card against CPU, output {i}"))
    del m32
    print(f"phase L (b) {cfg.name} float32, {L_F32_LAYERS} layers: prefill + {L_STEPS} "
          f"decode steps on the card ({t_card:.2f} s) and the CPU ({t_cpu:.2f} s), max abs "
          f"difference {worst:.3g} (max |logit| {scale:.3g})")
    return {"layers": L_F32_LAYERS, "max_abs_err": worst, "max_logit": scale,
            "card_s": t_card, "cpu_s": t_cpu}


def l_other(torch, arch: str) -> dict:
    """(c) one other architecture at full width, its depth cut to
    L_DEPTH[arch]: prefill and L_STEPS greedy decode steps in bf16, finite
    logits, their distance from the bf16 teacher-forced apply (printed: at
    full width bf16 rounding moves a decode step past the reference's
    smoke-size tolerance, 0.117 on internvl2-2b's 24 layers); then the same
    weights in float32, prefill and L_STEPS decode steps on those tokens
    held to apply at the CPU parity tests' tolerance.  A MoE model runs the
    float32 check with capacity_factor = E / k, where no assignment is
    dropped: a 4-token decode step drops assignments that a 512-token
    prefill keeps, so with drops decode and apply compute different
    functions."""
    import dataclasses

    from repro_torch.models import build_model, random_inputs
    from repro_torch.train.serve_step import greedy_generate, pad_caches

    cfg = l_config(arch, L_DEPTH[arch])
    t0 = time.perf_counter()
    model = build_model(cfg, DEV, torch.Generator(device=DEV).manual_seed(0))
    inputs = random_inputs(cfg, L_BATCH, L_PROMPT, torch.Generator(device=DEV).manual_seed(1))
    prompt = inputs.pop("tokens")
    n = L_STEPS + 1
    (tokens, logits), sec = synced_s(torch, lambda: greedy_generate(
        model, prompt, n, extra_batch=inputs, with_logits=True))
    check(bool(torch.isfinite(logits).all()), f"phase L (c) {arch}: non-finite logits")
    batch = {"tokens": prompt, **inputs}
    with torch.no_grad():
        full = model.apply({"tokens": tokens[:, :-1], **inputs})[:, -n:]
        bf16_err = float((logits.float() - full.float()).abs().max())
        prefill_ms = time_ms(torch, lambda: model.prefill(batch), reps=3, warm=1)
    n_params = sum(p.numel() for p in model.parameters())
    del full
    model.float()
    extra = {"capacity_factor": cfg.n_experts / cfg.top_k} if cfg.family == "moe" else {}
    model.cfg = dataclasses.replace(cfg, param_dtype="float32", **extra)
    with torch.no_grad():
        first, cache = model.prefill(batch)
        start = first.shape[1]
        cache = pad_caches(cache, start + L_STEPS)
        steps = [first[:, -1]]
        for i in range(L_STEPS):
            tok = tokens[:, L_PROMPT + i:L_PROMPT + i + 1]
            steps.append(model.decode_step(cache, tok, start + i)[0][:, -1])
        full = model.apply({"tokens": tokens[:, :-1], **inputs})[:, -n:]
    scale = float(full.abs().max())
    err = held_dev(torch, torch.stack(steps, dim=1), full, L_F32_RTOL, L_F32_ATOL * scale,
                   f"phase L (c) {arch}: float32 decode against apply")
    out = {"layers": cfg.n_layers, "of": l_config(arch).n_layers, "params": n_params,
           "generate_s": sec, "prefill_ms": prefill_ms, "bf16_decode_vs_apply": bf16_err,
           "f32_decode_vs_apply": err, "max_logit": scale,
           "seconds": time.perf_counter() - t0}
    del model, cache
    if DEV == "cuda":
        torch.cuda.empty_cache()
    print(f"phase L (c) {arch}: {cfg.n_layers} of {out['of']} layers, {n_params:,} "
          f"parameters; prefill {L_BATCH} x {L_PROMPT} {prefill_ms:.2f} ms, prefill + "
          f"{L_STEPS} decode steps {sec:.2f} s; decode against apply: bf16 {bf16_err:.4g}"
          f"{' (capacity drops differ)' if extra else ''}, float32 {err:.3g} (max |logit| "
          f"{scale:.3g})")
    return out


def l_cli() -> dict:
    """The serve CLI in LM mode at run_lm's full size, a process of its own."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm", "--arch",
           L_ARCH, "--batch", str(L_BATCH), "--prompt-len", str(L_PROMPT), "--max-new",
           str(L_NEW)]
    if DEV != "cuda":
        cmd += ["--device", DEV, "--smoke"]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                             else "")
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True,
                         timeout=600)
    sec = time.perf_counter() - t0
    check(out.returncode == 0, f"serve --mode lm exited {out.returncode}:\n"
                               f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    line = next(ln for ln in out.stdout.splitlines() if "tokens/s" in ln)
    print(f"phase L serve CLI ({sec:.1f} s): {line}")
    return {"seconds": sec, "line": line}


def phase_l(torch, rt) -> dict:
    """Phase L: the LM stack, with every launch count set to 0 just before
    it and read just after (it reaches no hand kernel)."""
    from repro_torch.configs.base import ARCH_IDS
    ops = rt["ops"]
    ops.reset_launch_counts()
    summary = {"card": card_line()}
    summary["serve"], model, cfg, res = l_serve(torch, rt["serve"])
    summary["float32"] = l_float32(torch, model, cfg, res)
    del model, res
    summary["others"] = {arch: l_other(torch, arch) for arch in ARCH_IDS if arch != L_ARCH}
    summary["cli"] = l_cli()
    made = {k: v for k, v in ops.launch_counts().items() if v}
    check(not made, f"phase L launched hand kernels: {made}")
    return summary


# --- phase R: LM training (ROADMAP queue 1.15b) -------------------------------------

R_BATCH, R_SEQ, R_MICRO, R_STEPS = 8, 512, 2, 10    # launch.train's path at full size
R_LR = 3e-4                                         # the trainer's default
R_F32_BATCH, R_F32_SEQ = 2, 64                      # (b): the CPU takes the same step
R_OTHER_BATCH, R_OTHER_SEQ = 2, 128                 # (c)
# (c)'s SSM families scan time in a Python loop: shorter sequences
R_OTHER_SEQS = {"falcon-mamba-7b": 32, "zamba2-1.2b": 64}
# (c)'s depth: phase L's cuts, but qwen3-moe-235b-a22b keeps 1 of its 94 layers
# (3.73 B parameters: 59.7 GB of bf16 weights, float32 moments and gradients)
R_DEPTH = dict(L_DEPTH, **{"qwen3-moe-235b-a22b": 1})
# (d): the crash-restart through the CLI, on llama3.2-1b's smoke config
R_CLI = ("--smoke", "--steps", "12", "--batch", "4", "--seq", "32", "--ckpt-every", "4")
R_FAIL_AT = 6
# (b)'s tolerances, the CPU parity tests' (tests/test_torch_train_step.py): loss
# and grad norm rtol 1e-5; m and v rtol L_F32_RTOL with atol R_STATE_ATOL x the
# leaf's max |value|; a parameter within R_P_LOOSE x lr everywhere (AdamW steps
# about lr whatever the gradient's size, so a gradient at float32 noise may step
# either way) and within R_P_TIGHT x lr + 2^-20 |p| where the gradient is at
# least R_ABOVE of its leaf's max |gradient| (read from m = (1 - b1) g)
R_RTOL = 1e-5
R_STATE_ATOL = 1e-4
R_P_LOOSE, R_P_TIGHT, R_ABOVE = 2.0, 1e-2, 1e-3


def r_args(**kw) -> argparse.Namespace:
    base = dict(arch=L_ARCH, smoke=L_SMOKE, device=DEV, steps=R_STEPS, batch=R_BATCH,
                seq=R_SEQ, n_micro=R_MICRO, lr=R_LR, ckpt_dir="", ckpt_every=20,
                simulate_failure_at=-1, log_every=1)
    base.update(kw)
    return argparse.Namespace(**base)


def r_bounds(n_params: int, tokens: int) -> dict:
    """A step's bounds (ms): 6 N T FLOPs at the bf16 peak (8 N T with remat's
    recomputed forward), 28 bytes a parameter (the weights read twice and
    AdamW's 24) at the HBM rate; AdamW alone, 24 bytes a parameter; tokens/s
    at the 6 N T bound."""
    flops = 6 * n_params * tokens / PEAK_BF16 * 1e3
    return {"step_ms": flops, "step_remat_ms": flops * 8 / 6,
            "step_bytes_ms": 28 * n_params / PEAK_BYTES * 1e3,
            "adamw_ms": 24 * n_params / PEAK_BYTES * 1e3, "tokens_per_s": tokens / flops * 1e3}


def r_train(torch, train_mod) -> tuple:
    """(a) launch.train's path on llama3.2-1b at full size, twice from seed
    0: finite losses and grad norms, the same loss and grad-norm bits at
    every step and the same final parameter bits; the second run's peak
    device memory."""
    first = train_mod.run_train(r_args())
    check(all(math.isfinite(v) for v in first["losses"] + first["grad_norms"]),
          f"phase R (a): non-finite loss or grad norm {first['losses']} {first['grad_norms']}")
    kept = {k: p.detach().cpu() for k, p in first["params"].items()}
    losses, norms, secs = first["losses"], first["grad_norms"], first["seconds"]
    del first
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    run = train_mod.run_train(r_args())
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    check(run["losses"] == losses, f"phase R (a): two runs, other losses {losses} / "
                                   f"{run['losses']}")
    check(run["grad_norms"] == norms, "phase R (a): two runs, other grad norms")
    other = [k for k, p in run["params"].items() if not torch.equal(p.detach().cpu(), kept[k])]
    check(not other, f"phase R (a): two runs, other parameter bits in {other[:5]}")
    return run, {"losses": losses, "grad_norms": norms, "first_seconds": secs}, peak


def r_timing(torch, run) -> dict:
    """CUDA-event times of the forward-backward (n_micro 2) and the AdamW
    update apart and of a whole step, on a pipeline batch, and the device ms
    and kernels of one step (torch.profiler)."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_grads_fn, make_train_step

    model, params, state, cfg = run["model"], run["params"], run["opt_state"], run["cfg"]
    opt_cfg = adamw.AdamWConfig(lr=R_LR, warmup_steps=1, total_steps=R_STEPS)
    batch = TokenPipeline(cfg.vocab_size, R_BATCH, R_SEQ, seed=1, device=DEV).next()
    grads_of = make_grads_fn(model, R_MICRO)
    leaves = list(params.values())
    fb_ms = time_ms(torch, lambda: grads_of(leaves, batch), reps=5, warm=1)
    grads = adamw.like(params, grads_of(leaves, batch)[1])
    upd_ms = time_ms(torch, lambda: adamw.update(opt_cfg, grads, state, params), reps=5,
                     warm=1)
    del grads
    step = make_train_step(model, opt_cfg, R_MICRO)
    step_ms = time_ms(torch, lambda: step(params, state, batch), reps=5, warm=1)
    dev_ms, kernels, kinds, top = r_device_breakdown(torch, lambda: step(params, state, batch))
    return {"fwd_bwd_ms": fb_ms, "adamw_ms": upd_ms, "step_ms": step_ms,
            "step_device_ms": dev_ms, "step_kernels": kernels, "step_device_by_kind": kinds,
            "step_top_kernels": top, "tokens_per_s": R_BATCH * R_SEQ / step_ms * 1e3}


# kinds of a train step's device kernels, by a substring of the kernel's name
R_KINDS = (("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
           ("foreach", ("multi_tensor_apply",)), ("softmax", ("softmax",)),
           ("reduce", ("reduce",)),
           ("index", ("index", "gather", "scatter", "segment", "sort", "unique", "radix")),
           ("copy", ("copy", "memcpy", "memset", "fill", "cat")),
           ("elementwise", ("elementwise", "vectorized")))


def r_device_breakdown(torch, fn, top: int = 8) -> tuple:
    """(device ms, kernels, device ms by kind, the `top` kernels by device
    time as [name, ms, launches]) of one run of fn, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us and "CUDA" in str(getattr(ev, "device_type", "")):
            rows.append((ev.key, us / 1e3, ev.count))
    kinds = {}
    for name, ms, _n in rows:
        low = name.lower()
        kind = next((k for k, subs in R_KINDS if any(x in low for x in subs)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    rows.sort(key=lambda r: -r[1])
    return (sum(r[1] for r in rows), sum(r[2] for r in rows), kinds,
            [[name[:120], ms, n] for name, ms, n in rows[:top]])


def r_state_held(torch, card: dict, host: dict, lr: float, what: str) -> dict:
    """(b)'s check of one step's m, v and parameters, card against CPU."""
    worst = {"m": 0.0, "v": 0.0, "params": 0.0}
    for k, m_ref in host["m"].items():
        m_max = float(m_ref.abs().max())
        worst["m"] = max(worst["m"], held(card["m"][k], m_ref, L_F32_RTOL,
                                          R_STATE_ATOL * m_max, f"{what}: m of {k}"))
        v_ref = host["v"][k]
        worst["v"] = max(worst["v"], held(card["v"][k], v_ref, L_F32_RTOL,
                                          R_STATE_ATOL * float(v_ref.abs().max()),
                                          f"{what}: v of {k}"))
        p_ref = host["params"][k]
        dp = (card["params"][k] - p_ref).abs()
        above = m_ref.abs() >= R_ABOVE * m_max
        bound = torch.where(above, R_P_TIGHT * lr + 2.0 ** -20 * p_ref.abs(),
                            torch.full_like(p_ref, R_P_LOOSE * lr))
        check(bool((dp <= bound).all()), f"{what}: parameter {k} moved {float(dp.max())} "
                                         f"from the CPU's (lr {lr})")
        worst["params"] = max(worst["params"], float(dp.max()))
    return worst


def r_float32(torch, run) -> dict:
    """(b) a float32 copy of the first L_F32_LAYERS layers at full width:
    one train step (n_micro 2) on the card and on the CPU on the same
    pipeline batch; loss, grad norm, m, v and the parameters held."""
    import dataclasses

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step, train_params

    cfg32 = dataclasses.replace(run["cfg"], n_layers=L_F32_LAYERS, param_dtype="float32")
    keep = {k: p.detach().float().cpu() for k, p in run["params"].items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < L_F32_LAYERS}
    batch = TokenPipeline(cfg32.vocab_size, R_F32_BATCH, R_F32_SEQ, seed=2, device="cpu").next()
    opt_cfg = adamw.AdamWConfig(lr=R_LR, warmup_steps=1, total_steps=R_STEPS)

    def one_step(dev):
        model = build_model(cfg32, dev, torch.Generator(device=dev).manual_seed(0))
        model.load_state_dict(keep, strict=True)
        params = train_params(model)
        state = adamw.init(params)
        step = make_train_step(model, opt_cfg, R_MICRO)
        (_p, state, met), sec = (synced_s(torch, lambda: step(params, state, {
            k: v.to(dev) for k, v in batch.items()})) if dev == "cuda" else
            (step(params, state, batch), None))
        out = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
               "params": {k: p.detach().cpu() for k, p in params.items()},
               "m": {k: t.cpu() for k, t in state.m.items()},
               "v": {k: t.cpu() for k, t in state.v.items()}, "seconds": sec}
        del model, params, state
        return out

    t0 = time.perf_counter()
    card = one_step(DEV)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = one_step("cpu")
    t_cpu = time.perf_counter() - t0
    what = "phase R (b): float32 card against CPU"
    held(card["loss"], host["loss"], R_RTOL, 0.0, f"{what}, loss")
    held(card["grad_norm"], host["grad_norm"], R_RTOL, 0.0, f"{what}, grad norm")
    worst = r_state_held(torch, card, host, R_LR, what)
    print(f"phase R (b) {cfg32.name} float32, {L_F32_LAYERS} layers, batch {R_F32_BATCH} x "
          f"{R_F32_SEQ}, {R_MICRO} microbatches: one step on the card ({t_card:.2f} s with the "
          f"build) and the CPU ({t_cpu:.2f} s); loss {card['loss']:.6f} / {host['loss']:.6f}, "
          f"grad norm {card['grad_norm']:.6f} / {host['grad_norm']:.6f}; max abs difference "
          f"m {worst['m']:.3g}, v {worst['v']:.3g}, parameters {worst['params']:.3g} "
          f"(lr {R_LR})")
    return {"layers": L_F32_LAYERS, "loss": [card["loss"], host["loss"]],
            "grad_norm": [card["grad_norm"], host["grad_norm"]], "max_abs_err": worst,
            "card_s": t_card, "cpu_s": t_cpu}


def r_other(torch, arch: str) -> dict:
    """(c) one other architecture at full width, its depth cut to
    R_DEPTH[arch]: the gradients of one batch with remat on and off (the
    same bits), then 2 train steps with finite losses and grad norms."""
    import dataclasses

    from repro_torch.models import build_model, random_inputs
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step, train_params
    from repro_torch.train.train_step import make_grads_fn

    cfg = l_config(arch, R_DEPTH[arch])
    t0 = time.perf_counter()
    model = build_model(cfg, DEV, torch.Generator(device=DEV).manual_seed(0))
    params = train_params(model)
    leaves = list(params.values())
    seq = R_OTHER_SEQS.get(arch, R_OTHER_SEQ)
    batch = random_inputs(cfg, R_OTHER_BATCH, seq, torch.Generator(device=DEV).manual_seed(1))
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    grads_of = make_grads_fn(model, 1)
    (loss_on, g_on), fb_s = synced_s(torch, lambda: grads_of(leaves, batch))
    model.cfg = dataclasses.replace(cfg, remat=False)
    loss_off, g_off = grads_of(leaves, batch)
    model.cfg = cfg
    check(torch.equal(loss_on, loss_off), f"phase R (c) {arch}: remat on / off, other loss")
    other = [k for k, a, b in zip(params, g_on, g_off) if not torch.equal(a, b)]
    check(not other, f"phase R (c) {arch}: remat on / off, other gradient bits in {other[:5]}")
    del g_on, g_off
    state = adamw.init(params)
    step = make_train_step(model, adamw.AdamWConfig(lr=R_LR, warmup_steps=1, total_steps=2))
    losses, norms, secs = [], [], []
    for _ in range(2):
        (params, state, met), sec = synced_s(torch, lambda: step(params, state, batch))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        secs.append(sec)
    check(all(math.isfinite(v) for v in losses + norms),
          f"phase R (c) {arch}: non-finite loss or grad norm {losses} {norms}")
    n_params = sum(p.numel() for p in leaves)
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    del model, params, leaves, state, step, batch
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out = {"layers": cfg.n_layers, "of": l_config(arch).n_layers, "params": n_params,
           "batch": R_OTHER_BATCH, "seq": seq, "losses": losses, "grad_norms": norms,
           "fwd_bwd_s": fb_s, "step_s": secs, "peak_gb": peak / 1e9,
           "seconds": time.perf_counter() - t0}
    print(f"phase R (c) {arch}: {cfg.n_layers} of {out['of']} layers, {n_params:,} parameters, "
          f"batch {R_OTHER_BATCH} x {seq}; remat on / off the same gradient bits; 2 steps, "
          f"losses {losses[0]:.4f} {losses[1]:.4f}, grad norms {norms[0]:.3f} {norms[1]:.3f}, "
          f"{secs[0]:.2f} / {secs[1]:.2f} s a step, peak {peak / 1e9:.1f} GB")
    return out


def r_cli(*argv) -> subprocess.Popen:
    """`python -m repro_torch.launch.train` with argv, started."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *argv]
    if DEV != "cuda":
        cmd += ["--device", DEV]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                             else "")
    return subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def r_done(proc: subprocess.Popen) -> tuple:
    """(exit code, stdout and the end of stderr) of a started CLI run."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    return proc.returncode, out + err[-3000:]


def r_restart(torch, train_mod, tmp: str, crash: subprocess.Popen) -> dict:
    """(d) crash and restart through the CLI: the run with
    --simulate-failure-at (started before (c), `crash`, writing under
    `tmp`) exits 42, the rerun resumes from its last checkpoint and ends
    with the same checkpoint bits as an uninterrupted run of the same steps
    (in this process)."""
    import re

    crashed, whole = os.path.join(tmp, "crashed"), os.path.join(tmp, "whole")
    rc, out = r_done(crash)
    check(rc == 42, f"phase R (d): the failing run exited {rc}, not 42:\n{out[-3000:]}")
    t0 = time.perf_counter()
    rc, out = r_done(r_cli(*R_CLI, "--ckpt-dir", crashed))
    t_resume = time.perf_counter() - t0
    check(rc == 0, f"phase R (d): the resumed run exited {rc}:\n{out[-3000:]}")
    resumed = re.search(r"resumed from step (\d+) \(([\d.]+) ms to restore\)", out)
    saved = re.search(r"checkpoint of step \d+ written in ([\d.]+) ms", out)
    check(resumed is not None and saved is not None,
          f"phase R (d): no resume or checkpoint line:\n{out[-3000:]}")
    argv = list(R_CLI) + ["--ckpt-dir", whole, "--device", DEV]
    train_mod.run_train(train_mod.parser().parse_args(argv))
    final = "step_{:08d}/arrays.npz".format(int(R_CLI[R_CLI.index("--steps") + 1]))
    with np.load(os.path.join(crashed, final)) as a, np.load(os.path.join(whole, final)) as b:
        check(sorted(a.files) == sorted(b.files), "phase R (d): other checkpoint keys")
        other = [k for k in a.files if a[k].tobytes() != b[k].tobytes()]
        n_keys = len(a.files)
    check(not other, f"phase R (d): restarted and uninterrupted runs differ in {other[:5]}")
    step0, load_ms, save_ms = int(resumed.group(1)), float(resumed.group(2)), float(saved.group(1))
    print(f"phase R (d) crash at step {R_FAIL_AT} exits 42 (run beside (c)), the rerun "
          f"resumes from step {step0} ({load_ms:.1f} ms to restore, {t_resume:.1f} s) and its "
          f"final checkpoint ({n_keys} arrays, written in {save_ms:.1f} ms) equals an "
          f"uninterrupted run's bit for bit")
    return {"resumed_from": step0, "load_ms": load_ms, "save_ms": save_ms,
            "resume_run_s": t_resume, "arrays": n_keys}


def r_compress(torch, rt) -> dict:
    """(e) compressed_psum on one NCCL rank (a file store): each leaf equal
    to the quantise-dequantise of g + e, the new residual quantize's, and a
    second call carrying that residual."""
    from repro_torch.optim import grad_compress as gc

    D = rt["distributed"]
    gen = torch.Generator(device=DEV).manual_seed(7)
    grads = {"w": torch.randn((1024, 512), generator=gen, device=DEV),
             "b": torch.randn((4096,), generator=gen, device=DEV) * 1e-3,
             "h": torch.randn((64, 64), generator=gen, device=DEV).to(torch.bfloat16)}
    errors = {k: torch.randn(g.shape, generator=gen, device=DEV) * 1e-4 for k, g in grads.items()}
    with tempfile.TemporaryDirectory() as tmp:
        D.init_group(os.path.join(tmp, "store"), 0, 1, device=DEV, timeout_s=120)
        try:
            (out, carried), sec = synced_s(torch, lambda: gc.compressed_psum(grads, errors))
            out2, carried2 = gc.compressed_psum(grads, carried)
            backend = rt["dist"].get_backend()
        finally:
            rt["dist"].destroy_process_group()
    for k, g in grads.items():
        for e_in, o, e_out in ((errors[k], out[k], carried[k]), (carried[k], out2[k], carried2[k])):
            q, scale, resid = gc.quantize(g, e_in)
            check(torch.equal(o, q.float() * scale), f"phase R (e): {k} is not the quantise-"
                                                     f"dequantise of its input")
            check(torch.equal(e_out, resid), f"phase R (e): {k}'s residual")
        check(not torch.equal(out2[k], out[k]) or not torch.equal(carried2[k], carried[k]),
              f"phase R (e): {k}'s residual was not carried")
    wire = (gc.wire_bytes(grads, True), gc.wire_bytes(grads, False))
    print(f"phase R (e) compressed_psum on {backend}, 1 rank: 3 leaves equal their "
          f"quantise-dequantise, residuals carried into a second call; {sec * 1e3:.1f} ms "
          f"first call; {wire[0]:,} / {wire[1]:,} bytes on the wire (int8 / float32)")
    return {"backend": backend, "first_ms": sec * 1e3, "wire_bytes": wire}


def phase_r(torch, rt) -> dict:
    """Phase R: LM training, with every launch count set to 0 just before
    it and read just after."""
    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.launch import train as train_mod

    ops = rt["ops"]
    ops.reset_launch_counts()
    summary = {"card": card_line(),
               "threads": sorted(t.name for t in threading.enumerate())}
    print(f"phase R starts beside {len(summary['threads'])} threads: {summary['threads']}")
    run, first, peak = r_train(torch, train_mod)
    cfg = run["cfg"]
    n = sum(p.numel() for p in run["params"].values())
    tokens = R_BATCH * R_SEQ
    bounds = r_bounds(n, tokens)
    timing = r_timing(torch, run)
    secs = run["seconds"]
    warm = float(np.median(secs[1:])) if len(secs) > 1 else secs[0]
    summary["train"] = dict(
        arch=cfg.name, params=n, batch=R_BATCH, seq=R_SEQ, n_micro=R_MICRO, steps=R_STEPS,
        remat=cfg.remat_policy if cfg.remat else "off", losses=run["losses"],
        grad_norms=run["grad_norms"], step_s=secs, first_run_step_s=first["first_seconds"],
        tokens_per_s_loop=tokens / warm, peak_gb=peak / 1e9, reckoning_gb=16 * n / 1e9,
        bounds=bounds, same_bits=True, **timing)
    print(f"phase R (a) {cfg.name}: {n:,} parameters, batch {R_BATCH} x {R_SEQ}, {R_MICRO} "
          f"microbatches, {R_STEPS} steps twice with the same loss, grad-norm and parameter "
          f"bits; losses {run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}; a step "
          f"{timing['step_ms']:.2f} ms (events; device {timing['step_device_ms']:.2f} ms in "
          f"{timing['step_kernels']} kernels; bound {bounds['step_ms']:.2f}, with remat "
          f"{bounds['step_remat_ms']:.2f}): forward-backward {timing['fwd_bwd_ms']:.2f} ms, "
          f"AdamW {timing['adamw_ms']:.2f} ms (bound {bounds['adamw_ms']:.2f}); "
          f"{timing['tokens_per_s']:,.0f} tokens/s (bound {bounds['tokens_per_s']:,.0f}), "
          f"{tokens / warm:,.0f} in the trainer's loop; peak {peak / 1e9:.2f} GB against "
          f"16 bytes a parameter {16 * n / 1e9:.2f} GB")
    print("phase R (a) a step's device ms by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(timing["step_device_by_kind"].items(),
                                          key=lambda kv: -kv[1])))
    for name, ms, count in timing["step_top_kernels"]:
        print(f"phase R (a)   {ms:8.3f} ms in {count:5d} launches: {name}")
    summary["float32"] = r_float32(torch, run)
    del run
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        # (d)'s failing run is a process of its own: it runs beside (c)
        crash = r_cli(*R_CLI, "--ckpt-dir", os.path.join(tmp, "crashed"),
                      "--simulate-failure-at", str(R_FAIL_AT))
        try:
            summary["others"] = {arch: r_other(torch, arch) for arch in ARCH_IDS
                                 if arch != L_ARCH}
        except BaseException:
            crash.kill()
            raise
        summary["restart"] = r_restart(torch, train_mod, tmp, crash)
    summary["compress"] = r_compress(torch, rt)
    summary["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"phase R launches of hand kernels: {summary['launches'] or 'none'}")
    return summary


M_STEPS = 2                                 # (a): sharded steps against run_train's
M_PIPE_MICRO = 4                            # (b): microbatches of R_BATCH rows
M_MEM_GAP = 0.15                            # (d): the dry run's bytes against the peak
M_DECODE_COLL = 10e6                        # (c): llama3.2-1b decode_32k's collective bytes
# (c): the dry run's cells, each `python -m repro_torch.launch.dryrun` of its own
M_DRYRUN = (("--arch", "llama3.2-1b", "--shape", "train_4k"),
            ("--arch", "llama3.2-1b", "--shape", "decode_32k"),
            ("--arch", "granite-moe-1b-a400m", "--shape", "decode_32k", "--multi-pod"),
            ("--kde", "1048576,4,150"))


def m_sharded(torch, rt, mesh) -> dict:
    """(a) llama3.2-1b at full width, phase R (a)'s batch (R_BATCH x R_SEQ in
    R_MICRO microbatches, remat "nothing"), its parameters DTensors on the
    1 x 1 mesh under the train specs and `param_constraint` the serve specs:
    M_STEPS steps from seed 0 against run_train's unsharded steps on the
    same batches (the same loss, grad-norm and parameter bits; otherwise
    the op and the largest difference are printed and phase R (b)'s
    tolerances hold); the sharded steps' peak device memory."""
    from repro_torch import sharding
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.models import batch_specs, build_model, param_specs_with_dp
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step, train_params

    plain = train_mod.run_train(r_args(steps=M_STEPS))
    want = {"losses": plain["losses"], "grad_norms": plain["grad_norms"],
            "params": {k: p.detach().cpu() for k, p in plain["params"].items()},
            "m": {k: t.cpu() for k, t in plain["opt_state"].m.items()},
            "v": {k: t.cpu() for k, t in plain["opt_state"].v.items()}}
    cfg = plain["cfg"]
    del plain
    if DEV == "cuda":
        torch.cuda.empty_cache()
    dp = dp_axes(mesh)
    model = build_model(cfg, DEV, torch.Generator(device=DEV).manual_seed(0))
    model.requires_grad_(True)
    sharding.distribute_model(model, param_specs_with_dp(model, "train", dp), mesh)
    params = train_params(model)
    state = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(lr=R_LR, warmup_steps=max(M_STEPS // 10, 1),
                                total_steps=M_STEPS)
    step = make_train_step(model, opt_cfg, R_MICRO,
                           param_constraint=param_specs_with_dp(model, "serve", dp))
    pipe = TokenPipeline(cfg.vocab_size, R_BATCH, R_SEQ, device=DEV)
    batches = [sharding.distribute(pipe.next(), batch_specs(cfg, dp), mesh)
               for _ in range(M_STEPS)]
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, norms, secs = [], [], []
    for b in batches:
        (params, state, met), sec = synced_s(torch, lambda: step(params, state, b))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        secs.append(sec)
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    got = {"losses": losses, "grad_norms": norms,
           "params": {k: p.detach().full_tensor().cpu() for k, p in params.items()},
           "m": {k: t.full_tensor().cpu() for k, t in state.m.items()},
           "v": {k: t.full_tensor().cpu() for k, t in state.v.items()}}
    placements = sorted({str(p.placements) for p in params.values()})
    del model, params, state, step, batches
    if DEV == "cuda":
        torch.cuda.empty_cache()
    check(all(math.isfinite(v) for v in losses + norms),
          f"phase M (a): non-finite loss or grad norm {losses} {norms}")
    other = [k for k in want["params"] if not torch.equal(got["params"][k], want["params"][k])]
    same = (not other and got["losses"] == want["losses"]
            and got["grad_norms"] == want["grad_norms"])
    finding = None
    if not same:
        worst = max(want["params"], key=lambda k: float(
            (got["params"][k].float() - want["params"][k].float()).abs().max()))
        diff = float((got["params"][worst].float() - want["params"][worst].float()).abs().max())
        finding = (f"DTensor's dispatch changed the bits: {len(other)} parameters differ, "
                   f"the largest in {worst} by {diff:.3g}; losses {got['losses']} / "
                   f"{want['losses']}, grad norms {got['grad_norms']} / {want['grad_norms']}")
        print(f"phase M (a) {finding}; held to phase R (b)'s tolerances")
        for a, b in zip(got["losses"] + got["grad_norms"], want["losses"] + want["grad_norms"]):
            held(a, b, R_RTOL, 0.0, "phase M (a): sharded loss / grad norm")
        r_state_held(torch, got, want, R_LR, "phase M (a): sharded against unsharded")
    print(f"phase M (a) {cfg.name} on the 1 x 1 mesh ({len(placements)} placements: "
          f"{placements}), param_constraint the serve specs, batch {R_BATCH} x {R_SEQ}, "
          f"{R_MICRO} microbatches: {M_STEPS} steps, losses {losses}, grad norms {norms}, "
          f"{'the same bits as' if same else 'held to'} run_train's unsharded steps; "
          f"{', '.join(f'{s * 1e3:.1f}' for s in secs)} ms a step; peak {peak / 1e9:.2f} GB")
    return {"losses": losses, "grad_norms": norms, "step_s": secs, "peak_bytes": peak,
            "same_bits": same, "finding": finding, "placements": placements}


def m_pipeline(torch, rt) -> dict:
    """(b) `spmd_pipeline` on the one-rank group, one stage: llama3.2-1b's
    blocks at full width as stage_fn on its embedded batch in M_PIPE_MICRO
    microbatches, the same bits as the blocks applied in order."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.pipeline import spmd_pipeline
    from repro_torch.models import build_model

    cfg = l_config(L_ARCH)
    model = build_model(cfg, DEV, torch.Generator(device=DEV).manual_seed(0))
    tokens = TokenPipeline(cfg.vocab_size, R_BATCH, R_SEQ, device=DEV).next()["tokens"]
    positions = torch.arange(R_SEQ, device=DEV)

    def tree(pt):
        return {k: tree(pt[k]) if hasattr(pt[k], "_keys") else pt[k] for k in pt._keys}

    stage = [tree(lp) for lp in model.layers]
    stacked = [{k: _unsqueezed(v) for k, v in lp.items()} for lp in stage]

    def stage_fn(layers, x):
        for lp in layers:
            x = model._block(x, lp, positions)[0]
        return x

    with torch.no_grad():
        xs = model.embed["w"][tokens].reshape(M_PIPE_MICRO, R_BATCH // M_PIPE_MICRO, R_SEQ, -1)
        out, sec = synced_s(torch, lambda: spmd_pipeline(stage_fn, stacked, xs))
        want = torch.stack([stage_fn(stage, x) for x in xs])
    check(torch.equal(out, want), "phase M (b): the pipeline's outputs are not the blocks' "
                                  "applied in order, bit for bit")
    check(bool(torch.isfinite(out.float()).all()), "phase M (b): non-finite outputs")
    print(f"phase M (b) spmd_pipeline, 1 stage of {cfg.n_layers} {cfg.name} blocks at width "
          f"{cfg.d_model}, {M_PIPE_MICRO} microbatches of {R_BATCH // M_PIPE_MICRO} x {R_SEQ}: "
          f"the same bits as the blocks in order; {sec * 1e3:.1f} ms")
    del model
    return {"stages": 1, "layers": cfg.n_layers, "n_micro": M_PIPE_MICRO, "seconds": sec,
            "same_bits": True}


def _unsqueezed(v):
    """A layer's tree with every tensor given a leading stage axis of 1."""
    if isinstance(v, dict):
        return {k: _unsqueezed(x) for k, x in v.items()}
    return v.unsqueeze(0)


def m_dryruns_started(tmp: str) -> list:
    """(c) each cell of M_DRYRUN as a process of its own, all started
    together (they trace on the host while (a) and (b) run on the card)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH")
                                             else "")
    procs = []
    for i, argv in enumerate(M_DRYRUN):
        out = os.path.join(tmp, f"dry_{i}.jsonl")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out", out]
        if DEV != "cuda":
            cmd += ["--device", DEV]
        procs.append((argv, out, time.perf_counter(), subprocess.Popen(
            cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    return procs


def m_dryruns_done(procs: list) -> dict:
    """(c) every record ok; its dominant term, per-device GB and trace
    seconds."""
    cells = []
    for argv, out, t0, proc in procs:
        rc, text = r_done(proc)
        wall = time.perf_counter() - t0
        check(rc == 0, f"phase M (c): dryrun {' '.join(argv)} exited {rc}:\n{text[-3000:]}")
        with open(out) as f:
            rec = json.loads(f.read().splitlines()[-1])
        check(rec["ok"], f"phase M (c): dryrun {' '.join(argv)} record not ok: {rec}")
        mem = rec["memory"]
        gb = mem["argument_gb_per_dev"] + mem["temp_gb_per_dev"]
        cell = {"cell": f"{rec['arch']} x {rec['shape']}", "mesh": rec["mesh"],
                "dominant": rec["roofline"]["dominant"], "gb_per_dev": gb,
                "argument_gb": mem["argument_gb_per_dev"], "temp_gb": mem["temp_gb_per_dev"],
                "trace_s": rec["compile_s"], "wall_s": wall, "terms": rec["roofline"],
                "dot_flops_per_dev": rec["hlo_dot_flops_per_dev"],
                "collective_bytes_per_dev": rec["collective_bytes_per_dev"],
                "collective_by_kind": rec["collective_by_kind"]}
        if cell["cell"] == "llama3.2-1b x decode_32k":
            # the vocab-parallel lookup: no table bytes move, one all_reduce of rows
            check(rec["collective_bytes_per_dev"] < M_DECODE_COLL,
                  f"phase M (c): llama3.2-1b decode_32k moves "
                  f"{rec['collective_bytes_per_dev'] / 1e6:.3f} MB of collectives a device, "
                  f"not under {M_DECODE_COLL / 1e6:.0f} MB: {rec['collective_by_kind']}")
        cells.append(cell)
        print(f"phase M (c) dryrun {cell['cell']} on {rec['mesh']}: dominant "
              f"{cell['dominant']}, {gb:.2f} GB a device (argument "
              f"{mem['argument_gb_per_dev']:.2f} + temp {mem['temp_gb_per_dev']:.2f}), "
              f"collectives {rec['collective_bytes_per_dev'] / 1e6:.3f} MB a device, trace "
              f"{rec['compile_s']} s ({wall:.1f} s from its start)")
    return {"cells": cells}


def m_memory(torch, a: dict) -> dict:
    """(d) `lower_cell` on a fake "1,1" mesh at (a)'s shape: its argument +
    temp bytes within M_MEM_GAP of (a)'s measured peak; the roofline terms
    of that step beside its measured time (a printed ratio)."""
    from repro_torch import roofline
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_from_spec

    cfg = l_config(L_ARCH)
    shape = ShapeConfig("train_r", R_SEQ, R_BATCH, "train")
    mesh = make_mesh_from_spec("1,1", device_type="cuda" if DEV == "cuda" else "cpu")
    try:
        meta = dryrun.lower_cell(cfg, shape, mesh, n_micro=R_MICRO)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    mem, tc = meta["memory"], meta["cost"]
    traced = mem["argument"] + mem["temp"]
    peak = a["peak_bytes"]
    gap = abs(traced - peak) / peak if peak else float("nan")
    if DEV == "cuda":
        check(gap <= M_MEM_GAP, f"phase M (d): the dry run's {traced / 1e9:.3f} GB (argument "
                                f"{mem['argument'] / 1e9:.3f} + temp {mem['temp'] / 1e9:.3f}) "
                                f"against the measured peak {peak / 1e9:.3f} GB: {gap:.1%}")
    coll, _ = tc.collective_bytes()
    terms = roofline.terms(tc.dot_flops, roofline.hbm_bytes(cfg, shape, R_MICRO), coll, 1)
    step_s = a["step_s"][-1]                      # the warm step
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    print(f"phase M (d) lower_cell on 1,1 at batch {R_BATCH} x {R_SEQ}, {R_MICRO} "
          f"microbatches: argument {mem['argument'] / 1e9:.3f} + temp {mem['temp'] / 1e9:.3f} = "
          f"{traced / 1e9:.3f} GB against (a)'s peak {peak / 1e9:.3f} GB ({gap:.1%}); trace "
          f"{meta['seconds']:.1f} s; H100 roofline of the step: compute "
          f"{terms['compute_s'] * 1e3:.2f} ms ({tc.dot_flops:.4g} dot FLOPs), memory "
          f"{terms['memory_s'] * 1e3:.2f} ms, collective {terms['collective_s'] * 1e3:.3f} ms "
          f"(dominant {terms['dominant']}) beside the warm step's {step_s * 1e3:.1f} ms "
          f"measured ({step_s / bound:.2f} x the bound)")
    return {"argument_bytes": mem["argument"], "temp_bytes": mem["temp"], "traced_bytes": traced,
            "peak_bytes": peak, "gap": gap, "trace_s": meta["seconds"], "terms": terms,
            "dot_flops": tc.dot_flops, "step_s": step_s, "step_over_bound": step_s / bound}


def phase_m(torch, rt) -> dict:
    """Phase M: the LM stack on a device mesh, with every launch count set
    to 0 just before it and read just after."""
    from repro_torch.launch.mesh import make_host_mesh

    ops = rt["ops"]
    ops.reset_launch_counts()
    summary = {"card": card_line()}
    with tempfile.TemporaryDirectory() as tmp:
        # (c)'s processes trace on the host while (a) and (b) run on the card
        t_c = time.perf_counter()
        dry = m_dryruns_started(tmp)
        rt["distributed"].init_group(os.path.join(tmp, "store"), 0, 1, device=DEV,
                                     timeout_s=120)
        try:
            mesh = make_host_mesh(1, 1, device_type="cuda" if DEV == "cuda" else "cpu")
            summary["sharded"] = m_sharded(torch, rt, mesh)
            summary["pipeline"] = m_pipeline(torch, rt)
            summary["backend"] = rt["dist"].get_backend()
        except BaseException:
            for *_, proc in dry:
                proc.kill()
            raise
        finally:
            rt["dist"].destroy_process_group()
        summary["memory"] = m_memory(torch, summary["sharded"])
        summary["dryrun"] = m_dryruns_done(dry)
        summary["dryrun"]["wall_s"] = time.perf_counter() - t_c
    summary["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    check(not summary["launches"], f"phase M: hand kernels launched {summary['launches']}")
    print("phase M launches of hand kernels: none")
    return summary


def child_main(args) -> int:
    """The second processes of phase T (`--child tuned`: the main path's
    store under a tuned cache) and path H (`--child restore`: the saved
    store loaded and queried); each writes its answers to `--out` and prints
    one JSON line."""
    import torch
    torch_rt = runtime(torch)
    ops, tune = torch_rt["ops"], torch_rt["autotune"]
    if args.child == "tuned":
        tune.use_cache(args.cache)
        store, specs, _, _ = build_store(args, torch_rt, torch_rt["query"])
        rows = answer_rows(store.query(specs))
        np.savez(args.out, **rows)
        reg = torch_rt["obs"].get_registry()
        print(json.dumps({"sweeps": reg.sum_counter("autotune.sweeps"),
                          "hits": reg.sum_counter("autotune.cache.hits")}))
        return 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = torch_rt["store"].TelemetryStore.load(args.snapshot)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    check(store.device.type == DEV
          and all(getattr(s, "x", getattr(s, "w", None)).device.type == DEV
                  for _k, _v, s in store.cache.entries()),
          "path H child: the snapshot did not land on the card")
    ranges = {c: (float(s.min()), float(s.max()))
              for c, s in ((c, store.columns[c].sample()) for c in store.columns
                           if c != "model_id")}
    q = torch_rt["query"]
    g_ctx = {"per_a": g_specs(torch_rt, ranges, 0.0), "per_b": g_specs(torch_rt, ranges, 0.1),
             "gb": q.AqpQuery("avg", (q.Range("latency_ms", 0.0, 500.0),),
                              target="latency_ms", group_by="model_id")}
    rows, stats = restored_answers(torch, torch_rt, store, g_ctx)
    store.add_batch(h_next_batch(args.seed))
    rows.update({f"state/{k}": v for k, v in sample_state(store).items()})
    np.savez(args.out, **rows)
    print(json.dumps({"load_ms": load_ms, "stats": stats, "device": torch.cuda.get_device_name(0),
                      "launches_total": ops.launch_counts()}))
    return 0


def all_range_bounds(torch, calls):
    """The bounds of all main-path range groups, concatenated: the extra
    aqp_batch shape (q = 512 here) of one launch per batch."""
    made = calls["aqp_batch_moments"]
    return (torch.cat([a[2] for a, _ in made]).contiguous(),
            torch.cat([a[3] for a, _ in made]).contiguous())


def held(a, b, rtol: float, atol: float, what: str) -> float:
    """Check kernel output `a` against plain output `b`; the max abs error."""
    ok, err = close(a, b, rtol, atol)
    check(ok, f"{what}: max abs error {err} beyond rtol {rtol} atol {atol}")
    return err


def _host(v):
    return v.cpu() if hasattr(v, "cpu") else v


def held_five(k, p, what: str, atol: float = None) -> float:
    """The five moment sums of a kernel call (5, q) against the same from a
    plain version or an oracle, each at AQP_RTOL with CNT_ATOL on the sums
    of c and c^2 and SUM_ATOL on those that hold s (or `atol` for all)."""
    return max(held(_host(k[t]), _host(p[t]), AQP_RTOL,
                    atol if atol is not None else (CNT_ATOL if t in (0, 2) else SUM_ATOL),
                    f"{what} sum {t}")
               for t in range(5))


def range_box_vs_plain(torch, rt, calls, what: str) -> dict:
    """All five sums of every recorded aqp_batch / aqp_boxes call of a path
    (the engine calls the moments wrappers only) against the plain version
    and the float64 oracle; the first call of each launched twice for the
    same bits.  Returns {kernel: max abs error against the plain version}."""
    ops, ref = rt["ops"], rt["ref"]
    out = {}
    for name, wrapper in (("aqp_batch_sums", "aqp_batch_moments"),
                          ("aqp_box_sums", "aqp_box_moments")):
        made = calls[wrapper]
        check(len(made) > 0 and not calls[name],
              f"{what}: {name} launched other than through {wrapper}")
        errs = []
        for args, kw in made:
            k = getattr(ops, wrapper)(*args, **kw)
            shape = call_shape(wrapper, args, kw)
            errs.append(held_five(k, getattr(ref, wrapper)(*args, **kw),
                                  f"{what} {wrapper} {shape}"))
            if wrapper == "aqp_batch_moments":
                x, h, a, b = args
                five64 = oracle_batch_dev(torch, x.double(), float(h), a.double(), b.double(),
                                          moments=True)
            else:
                x, h, lo, hi, tg = args
                five64 = oracle_boxes_dev(torch, x.double(), h.double(), lo.double(),
                                          hi.double(), tg.cpu().numpy(), moments=True)
            held_five(k, five64, f"{what} {wrapper} {shape} vs float64")
        args, kw = made[0]
        check(torch.equal(getattr(ops, wrapper)(*args, **kw), getattr(ops, wrapper)(*args, **kw)),
              f"{what} {wrapper}: two launches on the same inputs differ")
        out[name] = max(errs)
        print(f"{what}: {len(made)} {wrapper} calls ({call_shape(wrapper, *made[0])} first) "
              f"match plain on all five sums, max |err| {out[name]:.3g}, and float64; two "
              f"launches give the same bits")
    return out


def range_box_tails(torch, rt, calls) -> None:
    """Ranges far out in both tails of the first main-path range group's
    sample (the nearest point 1 to 12 bandwidths away), and the same ranges
    on the first axis of boxes over the joint whose other axes cover every
    row: all five sums against float64 at AQP_RTOL with an atol of 1e-30
    (a far-tail term of 1e-36 squared underflows float32)."""
    ops = rt["ops"]
    x, h = calls["aqp_batch_moments"][0][0][:2]
    hv, lo_x, hi_x = float(h), float(x.min()), float(x.max())
    k_near = np.asarray([1.0, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0])
    width = np.asarray([0.5, 1.0, 2.0, 3.0, 1.0, 2.0, 0.5])
    a = np.concatenate([hi_x + hv * k_near, lo_x - hv * (k_near + width)])
    b = np.concatenate([hi_x + hv * (k_near + width), lo_x - hv * k_near])
    a_t = torch.as_tensor(a.astype(np.float32), device=x.device)
    b_t = torch.as_tensor(b.astype(np.float32), device=x.device)
    k = ops.aqp_batch_moments(x, h, a_t, b_t)
    five64 = oracle_batch_dev(torch, x.double(), hv, a_t.double(), b_t.double(), moments=True)
    held_five(k, five64, "aqp_batch far tails vs float64", atol=1e-30)
    xj, h_d = calls["aqp_box_moments"][0][0][:2]
    axis0 = xj[:, 0]
    h0, lo0, hi0 = float(h_d[0]), float(axis0.min()), float(axis0.max())
    a0 = np.concatenate([hi0 + h0 * k_near, lo0 - h0 * (k_near + width)])
    b0 = np.concatenate([hi0 + h0 * (k_near + width), lo0 - h0 * k_near])
    q = a0.shape[0]
    span_lo = (xj.min(0).values - 20.0 * h_d).cpu().numpy()
    span_hi = (xj.max(0).values + 20.0 * h_d).cpu().numpy()
    lo = np.tile(span_lo, (q, 1))
    hi = np.tile(span_hi, (q, 1))
    lo[:, 0], hi[:, 0] = a0, b0
    tgt = np.arange(q) % xj.shape[1]
    lo_t = torch.as_tensor(lo.astype(np.float32), device=xj.device)
    hi_t = torch.as_tensor(hi.astype(np.float32), device=xj.device)
    k = ops.aqp_box_moments(xj, h_d, lo_t, hi_t,
                            torch.as_tensor(tgt.astype(np.int32), device=xj.device))
    five64 = oracle_boxes_dev(torch, xj.double(), h_d.double(), lo_t.double(), hi_t.double(),
                              tgt, moments=True)
    held_five(k, five64, "aqp_boxes far tails vs float64", atol=1e-30)
    print(f"aqp_batch / aqp_boxes: {len(a)} ranges 1-12 bandwidths past both ends of the "
          f"sample (boxes: on the joint's first axis, targets on every axis) match float64 "
          f"at rtol {AQP_RTOL} on all five sums (counts down to "
          f"{float(k[0].abs().min()):.3g})")


def ci_vs_torch_backend(torch, rt, calls) -> None:
    """Each main-path range and box call's answers and 95 % CI bounds from
    its one moments launch (`range_answers_and_se`, `box_answers_and_se`)
    against the "torch" backend's separate estimate and moment passes on
    the same inputs, COUNT / SUM / AVG in turn, at the parity tests' rtol
    1e-4 with an atol of 1e-4 x scale."""
    aqp, md, ci = rt["aqp"], rt["aqp_multid"], rt["aqp_ci"]
    scale = STREAM_ROWS / CAPACITY
    z = ci.norm_ppf(0.975)
    worst = 0.0
    for wrapper in ("aqp_batch_moments", "aqp_box_moments"):
        for args, _ in calls[wrapper]:
            q, m = args[2].shape[0], args[0].shape[0]
            ops_np = (np.arange(q) % 3).astype(np.int32)
            ops_t = torch.as_tensor(ops_np, device=args[0].device)
            if wrapper == "aqp_batch_moments":
                ans, se = ci.range_answers_and_se(*args, ops_np, scale, m)
                ans_p = aqp.batch_query_1d(*args, ops_t, scale, backend="torch")
                se_p = ci.se_from_moments(ops_np, ci.moments_1d(*args), scale, m)
            else:
                ans, se = ci.box_answers_and_se(*args, ops_np, scale, m)
                ans_p = md.batch_query_box(*args, ops_t, scale, backend="torch")
                se_p = ci.se_from_moments(ops_np, ci.moments_box(*args), scale, m)
            ans, ans_p = ans.double().numpy(), ans_p.double().cpu().numpy()
            for got, want, what in ((ans, ans_p, "answers"),
                                    (ans - z * se, ans_p - z * se_p, "CI lo"),
                                    (ans + z * se, ans_p + z * se_p, "CI hi")):
                worst = max(worst, held(got, want, 1e-4, 1e-4 * scale,
                                        f"{wrapper} {call_shape(wrapper, args, {})} {what} vs "
                                        f"the torch backend"))
    print(f"range / box answers and CI bounds from one moments launch match the torch "
          f"backend's separate passes (max |err| {worst:.3g})")


def kernels_vs_plain(torch, rt, calls, calls_c):
    """Each kernel against its plain version on the inputs of every one of
    its main-path calls (and, for the pair sums, of path C's PLUGIN fits on
    GROUP BY's joint, whose model_id axis is mostly ties), at an extra
    shape and at edge shapes, and against float64 on a subsample."""
    ops, ref, plugin = rt["ops"], rt["ref"], rt["plugin"]
    dev = torch.device(DEV)
    rng = np.random.default_rng(7)
    out = {}

    # eqs. 49/50 as the kernel computes them, for every tile of n_tiles <= 512
    n_tri = 512 * 513 // 2
    q_t, l_t = rt["pairwise_reduce"].triangle_map(n_tri, dev)
    q_t, l_t = q_t.long(), l_t.long()
    bx = torch.arange(n_tri, device=dev)
    check(bool(torch.all(l_t * (l_t + 1) // 2 + q_t == bx) & torch.all(q_t <= l_t)
               & torch.all(q_t >= 0)), "device bx_to_ql mapping")
    print(f"triangle map: {n_tri} tiles (n_tiles <= 512) round-trip on the device")

    # pairwise on each recorded call: every fitted axis's Psi6(g1), Psi4(g2),
    # of the main path and of path C; each path's kinds against float64 on
    # 4 096 of the axis's points, its first two calls launched twice
    errs = []
    for path, made in (("main path", calls["pairwise_scaled_ksum"]),
                       ("path C", calls_c["pairwise_scaled_ksum"])):
        oracle_done = set()
        for args, kw in made:
            x, g = args[0], args[1]
            kind = kw["kind"]
            n = x.shape[0]
            errs.append(held(float(ops.pairwise_scaled_ksum(*args, **kw)),
                             float(ref.pairwise_scaled_ksum(*args, **kw)),
                             PAIR_RTOL, max(1e-5, 1e-6 * n), f"{path} pairwise {kind} n={n}"))
            if kind not in oracle_done:
                oracle_done.add(kind)
                sub = x[:4096].contiguous()
                held(float(ops.pairwise_scaled_ksum(sub, g, kind)),
                     oracle_pairwise(sub.cpu().numpy(), float(g), kind),
                     PAIR_RTOL, max(1e-5, 1e-6 * 4096), f"{path} pairwise {kind} vs float64")
        for args, kw in made[:2]:
            check(torch.equal(ops.pairwise_scaled_ksum(*args, **kw),
                              ops.pairwise_scaled_ksum(*args, **kw)),
                  f"{path} pairwise {kw['kind']}: two launches on the same inputs differ")
        print(f"pairwise: {len(made)} {path} calls (n={made[0][0][0].shape[0]}) match plain, "
              f"two launches give the same bits; {'/'.join(sorted(oracle_done))} at n=4096 "
              f"match float64")
    out["pairwise_scaled_ksum"] = max(errs)
    print(f"pairwise: max |err| {max(errs):.3g} over {len(errs)} recorded calls")
    # edge shapes around the tile (n = 2, below it, not a multiple of it),
    # data offset far above g, every kind
    tile = rt["pairwise_reduce"].TILE
    for n in (1, 2, 3, 127, 128, 129, tile - 1, tile, tile + 1, 3 * tile + 5, 4097):
        xs = torch.as_tensor((rng.normal(0, 1, n) + 30.0).astype(np.float32), device=dev)
        g = torch.tensor(0.4, device=dev)
        for kind in ("k4", "k6", "gauss"):
            held(float(ops.pairwise_scaled_ksum(xs, g, kind)),
                 float(ref.pairwise_scaled_ksum(xs, g, kind)),
                 PAIR_RTOL, max(1e-5, 1e-6 * n), f"pairwise {kind} n={n}")
    xs = rng.normal(1.0, 2.0, 512).astype(np.float32)
    h_k = float(plugin.plugin_bandwidth(xs, backend="cuda").h)
    h_seq = plugin.plugin_bandwidth_sequential(xs)
    check(abs(h_k - h_seq) / h_seq < 1e-3, f"PLUGIN h {h_k} vs sequential {h_seq}")
    print(f"PLUGIN n=512: kernel path h {h_k!r}, sequential oracle {h_seq!r}")

    # aqp_batch / aqp_boxes: all five sums of each main-path call against the
    # plain version and float64, far tails, the CI against the "torch" pass
    out.update(range_box_vs_plain(torch, rt, calls, "main path"))
    range_box_tails(torch, rt, calls)
    ci_vs_torch_backend(torch, rt, calls)
    # an extra shape: every range group's bounds against the first synopsis
    x, h = calls["aqp_batch_moments"][0][0][:2]
    a_t, b_t = all_range_bounds(torch, calls)
    held_five(ops.aqp_batch_moments(x, h, a_t, b_t), ref.aqp_batch_moments(x, h, a_t, b_t),
              f"aqp_batch q={a_t.shape[0]}")
    # edge shapes: n, q = 0 and 1, a range or a query tile and one more, d = 1..8
    for n, qn in ((1, 1), (4097, 3), (4097, 0), (0, 5), (33, 31), (32_768 + 5, 33)):
        xs = torch.as_tensor(rng.normal(0, 2, n).astype(np.float32), device=dev)
        aa = torch.as_tensor(rng.uniform(-8, 8, qn).astype(np.float32), device=dev)
        bb = aa + 2.0
        hh = torch.tensor(0.3, device=dev)
        k = ops.aqp_batch_moments(xs, hh, aa, bb)
        check(k.shape == (5, qn), f"aqp_batch n={n} q={qn} shape")
        held_five(k, ref.aqp_batch_moments(xs, hh, aa, bb), f"aqp_batch n={n} q={qn}")
        cnt, sm = ops.aqp_batch_sums(xs, hh, aa, bb)
        check(torch.equal(cnt, k[0]) and torch.equal(sm, k[1]),
              f"aqp_batch_sums n={n} q={qn}: not the moments launch's first two rows")
    for n, qn, d in [(1, 1, 1), (4097, 1, 1), (4097, 5, 2), (4097, 0, 3), (0, 4, 2),
                     (33, 31, 3)] + [(700 + d, 9, d) for d in range(1, 9)]:
        xs = torch.as_tensor(rng.normal(0, 1.5, (n, d)).astype(np.float32), device=dev)
        hh = torch.as_tensor(rng.uniform(0.2, 0.8, d).astype(np.float32), device=dev)
        ll = torch.as_tensor(rng.uniform(-3, 1, (qn, d)).astype(np.float32), device=dev)
        uu = ll + 1.5
        tt = torch.as_tensor(rng.integers(0, d, qn).astype(np.int32), device=dev)
        k = ops.aqp_box_moments(xs, hh, ll, uu, tt)
        check(k.shape == (5, qn), f"aqp_boxes n={n} q={qn} d={d} shape")
        held_five(k, ref.aqp_box_moments(xs, hh, ll, uu, tt), f"aqp_boxes n={n} q={qn} d={d}")
        cnt, sm = ops.aqp_box_sums(xs, hh, ll, uu, tt)
        check(torch.equal(cnt, k[0]) and torch.equal(sm, k[1]),
              f"aqp_box_sums n={n} q={qn} d={d}: not the moments launch's first two rows")
    print(f"extra shape aqp_batch q={a_t.shape[0]}; edge shapes n=0/1/33/4097/32773, "
          f"q=0/1/3/31/33, d=1..8 (aqp, five sums; the two-sum wrappers are the moments "
          f"launch's first rows), n=1/2/3/127-129/{tile - 1}-{tile + 1}/{3 * tile + 5}/4097 "
          f"(pairwise, every kind): kernels match plain versions")
    torch.cuda.synchronize()
    return out


def held_dev(torch, a, b, rtol: float, atol: float, what: str, rows: int = 4096) -> float:
    """held() for large device tensors, compared on the card in row slabs."""
    check(tuple(a.shape) == tuple(b.shape), f"{what}: shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    ok, worst = True, 0.0
    for s in range(0, a2.shape[0], rows):
        x, y = a2[s:s + rows].double(), b2[s:s + rows].double()
        e = (x - y).abs()
        ok = ok and bool(torch.all(e <= atol + rtol * y.abs()))
        worst = max(worst, float(e.max()))
    check(ok, f"{what}: max abs error {worst} beyond rtol {rtol} atol {atol}")
    return worst


def oracle_quadform_sum(x, m, c_k, c_kk) -> float:
    """sum_{i<j} c_kk exp(-s/4) - 2 c_k exp(-s/2) in float64, s = v^T M v."""
    x = np.asarray(x, np.float64)
    m = np.asarray(m, np.float64)
    n = x.shape[0]
    total = 0.0
    for s in range(0, n, 512):
        v = x[s:s + 512, None, :] - x[None]
        q = np.einsum("ijd,de,ije->ij", v, m, v)
        i = s + np.arange(q.shape[0])
        t = c_kk * np.exp(-0.25 * q) - 2.0 * c_k * np.exp(-0.5 * q)
        total += float(np.where(i[:, None] < np.arange(n)[None], t, 0.0).sum())
    return total


def first_d1_gh(calls_d):
    """The inputs of path D's first 1-D gh_fused_sums call."""
    return next(c for c in calls_d["gh_fused_sums"] if c[0][0].shape[1] == 1)


def lscv_kernels_vs_plain(torch, rt, calls_a, calls_b, calls_d):
    """The LSCV kernels against their plain versions on the inputs of every
    call of path A (sv_matrix, lscv_grid_sums), the first and last batches
    of path B and the first 1-D batch of path D (gh_fused_sums, each sum of
    a batch), at edge shapes (n not a multiple of a tile, d = 1..8 for
    gh_fused_sums and gh_fused_sum), and against float64; two launches of
    lscv_grid_sums and gh_fused_sums on the same inputs give the same bits,
    as do a batch and its rows launched one by one; all five sums of path A's aqp_batch /
    aqp_boxes calls against theirs and float64; LSCV_h at n = 512 on the
    card against the paper's sequential float64 oracle."""
    ops, ref, lscv = rt["ops"], rt["ref"], rt["lscv"]
    dev = torch.device(DEV)
    rng = np.random.default_rng(11)
    out = {}

    range_box_vs_plain(torch, rt, calls_a, "path A (LSCV_h bandwidths)")

    errs = []
    for args, kw in calls_a["sv_matrix"]:
        k = ops.sv_matrix(*args, **kw)
        p = ref.sv_matrix(args[0], args[1])
        errs.append(held_dev(torch, k, p, SV_RTOL, SV_ATOL,
                             f"sv_matrix {call_shape('sv_matrix', args, kw)}"))
        del k, p
    out["sv_matrix"] = max(errs)
    x, m = calls_a["sv_matrix"][-1][0][:2]
    sub = x[:1024].contiguous()
    x64, m64 = sub.double().cpu().numpy(), m.double().cpu().numpy()
    v = x64[:, None] - x64[None]
    s64 = np.triu(np.einsum("ijd,de,ije->ij", v, m64, v), 1)
    held(ops.sv_matrix(sub, m).cpu(), s64, SV_RTOL, SV_ATOL, "sv_matrix vs float64")
    for n in (1, 2, 4097):
        for d in (1, 3, 16):
            xs = torch.as_tensor(rng.normal(0, 1, (n, d)).astype(np.float32), device=dev)
            m0 = rng.normal(0, 1, (d, d))
            ms = torch.as_tensor((0.2 * m0 @ m0.T + np.eye(d)).astype(np.float32), device=dev)
            p = ref.sv_matrix(xs, ms)
            for alg in ("paper", "mxu"):
                held_dev(torch, ops.sv_matrix(xs, ms, algorithm=alg), p, SV_RTOL, SV_ATOL,
                         f"sv_matrix n={n} d={d} {alg}")
    print(f"sv_matrix: {len(errs)} path-A calls match plain, max |err| {max(errs):.3g}; "
          f"n=1024 d={x.shape[1]} within tolerance of float64; edge shapes n=1/2/4097 x "
          f"d=1/3/16 x paper/mxu match plain")

    errs = []
    for args, kw in calls_a["lscv_grid_sums"]:
        k = ops.lscv_grid_sums(*args, **kw).cpu()
        p = ref.lscv_grid_sums(*args, **kw).cpu()
        errs.append(held(k, p, GRID_RTOL, GRID_ATOL,
                         f"lscv_grid_sums {call_shape('lscv_grid_sums', args, kw)}"))
    out["lscv_grid_sums"] = max(errs)
    x, m, hg, c_k, c_kk = calls_a["lscv_grid_sums"][0][0]
    s_mat = ops.sv_matrix(x, m)
    same = torch.equal(ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk),
                       ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk))
    check(same, "lscv_grid_sums: two launches on path A's first S differ")
    del s_mat
    for n in (1, 2, 65, 4097, 4100):
        xs = torch.as_tensor(rng.normal(0, 1, (n, 2)).astype(np.float32), device=dev)
        ms = torch.eye(2, device=dev)
        hg = torch.linspace(0.05, 2.0, 150, device=dev)
        held(ops.lscv_grid_sums(xs, ms, hg, 0.3, 0.2).cpu(),
             ref.lscv_grid_sums(xs, ms, hg, 0.3, 0.2).cpu(), GRID_RTOL, GRID_ATOL,
             f"lscv_grid_sums n={n}")
    xs = rng.normal(0.0, 1.0, (512, 3)).astype(np.float32)
    res = lscv.lscv_h(xs, backend="cuda", device=DEV)
    worst = 0.0
    for i in (0, 50, 100, 149):
        oracle = lscv.g_of_h_sequential(xs, float(res.h_grid[i]))
        rel = abs(float(res.g_values[i]) - oracle) / abs(oracle)
        check(rel < 2e-3, f"LSCV_h n=512 g[{i}] {float(res.g_values[i])} vs float64 {oracle}")
        worst = max(worst, rel)
    print(f"lscv_grid_sums: {len(errs)} path-A calls match plain, max |err| {max(errs):.3g}; "
          f"two launches give the same bits; edge shapes n=1/2/65/4097/4100 match; LSCV_h "
          f"n=512 d=3 on the kernels within {worst:.2g} relative of the sequential float64 "
          f"oracle at 4 grid points")

    made = calls_b["gh_fused_sums"]
    errs = []
    for tag, (args, kw) in (("first path-B", made[0]), ("last path-B", made[-1]),
                            ("first 1-D path-D", first_d1_gh(calls_d))):
        errs.append(held(ops.gh_fused_sums(*args, **kw).cpu(),
                         ref.gh_fused_sums(*args, **kw).cpu(), GH_RTOL, GH_ATOL,
                         f"gh_fused_sums {tag} call ({call_shape('gh_fused_sums', args, kw)})"))
    out["gh_fused_sum"] = max(errs)
    (x, params), kw = made[0]
    sums = ops.gh_fused_sums(x, params, **kw)
    check(torch.equal(sums, ops.gh_fused_sums(x, params, **kw)),
          "gh_fused_sums: two launches on path B's first inputs differ")
    d = x.shape[1]
    alone = torch.stack([ops.gh_fused_sum(x, row[:d * d].reshape(d, d), row[d * d],
                                          row[d * d + 1], **kw) for row in params])
    check(torch.equal(sums, alone),
          "gh_fused_sums: path B's first batch differs from its rows launched one by one")
    x, params = made[-1][0]
    sub = x[:4096].contiguous()
    p64 = params.double().cpu().numpy()
    held(ops.gh_fused_sums(sub, params).cpu(),
         [oracle_quadform_sum(sub.cpu().numpy(), p[:d * d].reshape(d, d), p[d * d], p[d * d + 1])
          for p in p64], GH_RTOL, GH_ATOL, "gh_fused_sums vs float64")
    for n in (1, 2, 513, 4097):
        for d in range(1, 9):
            xs = torch.as_tensor(rng.normal(0, 1, (n, d)).astype(np.float32), device=dev)
            hs = []
            for _ in range(3):
                m0 = rng.normal(0, 1, (d, d))
                hs.append((0.1 * m0 @ m0.T + np.eye(d)).astype(np.float32))
            ps = ref.gh_params(torch.as_tensor(np.stack(hs), device=dev),
                               torch.tensor([0.31, 0.29, 0.33], device=dev),
                               torch.tensor([0.17, 0.19, 0.15], device=dev))
            held(ops.gh_fused_sums(xs, ps).cpu(), ref.gh_fused_sums(xs, ps).cpu(),
                 GH_RTOL, GH_ATOL, f"gh_fused_sums n={n} d={d} B=3")
            held(float(ops.gh_fused_sum(xs, ps[0, :d * d].reshape(d, d), 0.31, 0.17)),
                 float(ref.gh_fused_sum(xs, ps[0, :d * d].reshape(d, d), 0.31, 0.17)),
                 GH_RTOL, GH_ATOL, f"gh_fused_sum n={n} d={d}")
    print(f"gh_fused_sums: first and last of {len(made)} path-B batches and path D's first "
          f"1-D batch match plain, max |err| {max(errs):.3g}; two launches give the same bits, "
          f"as do the first batch's rows launched one by one; n=4096 within tolerance of "
          f"float64; edge shapes n=1/2/513/4097 x d=1..8 (batches of 3, and one H) match plain")
    fit_plan_vs_plain(torch, rt, made)
    torch.cuda.synchronize()
    return out


def fit_plan_vs_plain(torch, rt, made):
    """An LSCV_H fit's launch path (`ops.gh_fused_plan`, its rows rewritten
    each round trip) on path B's first and last batches: the sums held to
    `ref.gh_fused_sums` and bit-equal to the plan-less wrapper's.  Then, obs
    on, one fit at d = 3 (path B's sample) and one at d = 8 (16 384 rows),
    whose `lscv_H.round_trip_host_us` medians are printed."""
    ops, ref, lscv, obs = rt["ops"], rt["ref"], rt["lscv"], rt["obs"]
    errs = []
    for tag, ((x, params), kw) in (("first", made[0]), ("last", made[-1])):
        plan = ops.gh_fused_plan(x, params.shape[0] + 2)
        b = params.shape[0]
        plan.params[:b].copy_(params)
        sums = ops.gh_fused_sums(x, plan.params[:b], plan=plan).cpu()
        errs.append(held(sums, ref.gh_fused_sums(x, params).cpu(), GH_RTOL, GH_ATOL,
                         f"gh_fused_sums through a fit's plan, {tag} path-B batch (B={b})"))
        check(torch.equal(sums, ops.gh_fused_sums(x, params).cpu()),
              f"gh_fused_sums: the plan's sums of path B's {tag} batch differ from the wrapper's")
    rng = np.random.default_rng(17)
    z = rng.normal(0.0, 1.0, (16384, 8))
    x8 = torch.as_tensor((z + 0.5 * z[:, :1]).astype(np.float32), device=DEV)
    reg = obs.get_registry()
    prev = obs.set_tracer(obs.Tracer())
    obs.enable()
    try:
        medians = {}
        for x in (made[0][0][0], x8):
            d = x.shape[1]
            before = reg.sum_histogram("lscv_H.round_trip_host_us", d=d)[1]
            res = lscv.lscv_H(x, device=DEV)
            (_, hist), = reg.collect_histograms("lscv_H.round_trip_host_us", d=d)
            check(hist.count - before >= res.it + 1,
                  f"lscv_H.round_trip_host_us at d={d}: {hist.count - before} round trips "
                  f"recorded, {res.it} steps")
            medians[d] = (hist.summary()["p50"], hist.mean)
    finally:
        obs.disable()
        obs.set_tracer(prev)
    print(f"gh_fused_sums through a fit's plan: path B's first and last batches match plain "
          f"(max |err| {max(errs):.3g}) with the wrapper's bits; lscv_H.round_trip_host_us "
          f"(obs on, launches fenced and excluded) median / mean: d=3 {medians[3][0]:.1f} / "
          f"{medians[3][1]:.1f} us, d=8 {medians[8][0]:.1f} / {medians[8][1]:.1f} us")


def fullh_grouped_vs_plain(torch, rt, calls_c, calls_d, calls_dx, calls_e):
    """The GROUP BY and full-H kernels against their plain versions on the
    inputs of their calls on paths C, D and E, at edge shapes, and against
    float64 on a subsample.  qmc_box_reduce is held at the reference's rtol
    1e-5 with an atol of 1e-6 of the call's largest |sum|: each sum adds up
    to 1.07e9 positive kernel values in float32, in another order than the
    plain version, and a SUM over a box whose target axis changes sign can
    cancel far below the terms it adds."""
    ops, ref = rt["ops"], rt["ref"]
    dev = torch.device(DEV)
    rng = np.random.default_rng(13)
    out = {}

    def t32(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def grouped_pair(args, what):
        k, p = ops.aqp_grouped_sums(*args), ref.aqp_grouped_sums(*args)
        return max(held(k[0].cpu(), p[0].cpu(), AQP_RTOL, CNT_ATOL, what + " count"),
                   held(k[1].cpu(), p[1].cpu(), AQP_RTOL, SUM_ATOL, what + " sum"))

    def moments_pair(args, what):
        k, p = ops.aqp_grouped_moments(*args), ref.aqp_grouped_moments(*args)
        check(tuple(k.shape) == (args[2].shape[0], 5, args[4].shape[1]), f"{what} shape")
        return max(held(k[:, t].cpu(), p[:, t].cpu(), AQP_RTOL,
                        CNT_ATOL if t in (0, 2) else SUM_ATOL, f"{what} sum {t}")
                   for t in range(5))

    made = calls_c["aqp_grouped_moments"]
    out["aqp_grouped_sums"] = max(moments_pair(a, f"aqp_grouped_moments "
                                                  f"{call_shape('aqp_grouped_moments', a, k)}")
                                  for a, k in made)
    args = made[0][0]
    check(torch.equal(ops.aqp_grouped_moments(*args), ops.aqp_grouped_moments(*args)),
          "aqp_grouped_moments: two launches on the same inputs differ")
    x, h, lo, hi, wlo, whi, win, g_axes, tgts = args
    sub = x[:4096].contiguous()
    for f in (0, next(i for i, (g, t) in enumerate(zip(g_axes, tgts)) if g == t)):
        g_axis, tgt, G = g_axes[f], tgts[f], wlo.shape[1]
        blo = lo[f].double().repeat(G, 1)
        bhi = hi[f].double().repeat(G, 1)
        blo[:, g_axis], bhi[:, g_axis] = wlo[win[f]].double(), whi[win[f]].double()
        five64 = oracle_boxes_dev(torch, sub.double(), h.double(), blo, bhi, [tgt] * G,
                                  moments=True)
        five = ops.aqp_grouped_moments(sub, h, lo[f:f + 1], hi[f:f + 1], wlo, whi, [win[f]],
                                       [g_axis], [tgt])[0]
        for t in range(5):
            held(five[t].cpu(), five64[t], AQP_RTOL, CNT_ATOL if t in (0, 2) else SUM_ATOL,
                 f"aqp_grouped_moments family {f} (tgt={tgt}) sum {t} vs float64")
        k = ops.aqp_grouped_sums(sub, h, lo[f], hi[f], wlo[win[f]], whi[win[f]], g_axis, tgt)
        held(k[0].cpu(), five64[0], AQP_RTOL, CNT_ATOL, f"aqp_grouped tgt={tgt} count vs float64")
        held(k[1].cpu(), five64[1], AQP_RTOL, SUM_ATOL, f"aqp_grouped tgt={tgt} sum vs float64")
    for n, d, G, ga, tg in ((1, 1, 1, 0, 0), (4097, 3, 1, 1, 0), (4097, 2, 130, 0, 1),
                            (4097, 3, 64, 2, 2), (0, 2, 4, 1, 0), (50, 3, 0, 1, 1)):
        xs = t32(rng.normal(0, 1.5, (n, d)).astype(np.float32))
        hs = t32(rng.uniform(0.2, 0.8, d).astype(np.float32))
        ls = t32(rng.uniform(-2, 0, d).astype(np.float32))
        codes = np.arange(G, dtype=np.float32) * 0.05 - 1.5
        k = ops.aqp_grouped_sums(xs, hs, ls, ls + 2.0, t32(codes), t32(codes + 0.05), ga, tg)
        check(k[0].shape == (G,), f"aqp_grouped n={n} G={G} shape")
        grouped_pair((xs, hs, ls, ls + 2.0, t32(codes), t32(codes + 0.05), ga, tg),
                     f"aqp_grouped n={n} d={d} G={G}")
    # the batched kernel at edge shapes: n not a multiple of a block's rows,
    # d = 1..8, F = 1 and 104, G = 1, the group axis as the target, and
    # families over differing window tables (three tables of G = 1, 5, 64)
    tables = [np.arange(G, dtype=np.float32) * (3.0 / G) - 1.5 for G in (1, 5, 64)]
    wl = np.zeros((3, 64), np.float32)
    wh = np.zeros((3, 64), np.float32)
    for i, c in enumerate(tables):
        wl[i, :len(c)], wh[i, :len(c)] = c - 0.5, c + 0.5
    for n, d, F in [(1, 1, 1), (33, 2, 104), (4097, 3, 104), (32_768 + 5, 3, 7)] + \
            [(1000 + d, d, 6) for d in range(1, 9)]:
        xs = t32(rng.normal(0, 1.5, (n, d)).astype(np.float32))
        hs = t32(rng.uniform(0.2, 0.8, d).astype(np.float32))
        ls = rng.uniform(-2, 0, (F, d)).astype(np.float32)
        ga = rng.integers(0, d, F)
        tg = np.where(rng.uniform(size=F) < 0.3, ga, rng.integers(0, d, F))
        wi = rng.integers(0, 3, F)
        margs = (xs, hs, t32(ls), t32(ls + 2.0), t32(wl), t32(wh), wi.tolist(), ga.tolist(),
                 tg.tolist())
        moments_pair(margs, f"aqp_grouped_moments n={n} d={d} F={F}")
    print(f"aqp_grouped: the path-C call ({call_shape('aqp_grouped_moments', args, {})}) "
          f"matches plain on all five sums, max |err| {out['aqp_grouped_sums']:.3g}; two "
          f"launches give the same bits; n=4096 within tolerance of float64 on both target "
          f"branches (five sums, and the one-family wrapper); one-family edge shapes "
          f"n=0/1/4097, G=0/1/130, d=1/2/3 and batched edge shapes n=1/33/4097/32773, "
          f"d=1..8, F=1/6/7/104 over window tables of G=1/5/64 match plain")

    def qmc_pair(args, what):
        split = len(args) > 7
        k = (ops.qmc_box_reduce_split if split else ops.qmc_box_reduce)(*args)
        p = (ref.qmc_box_reduce_split if split else ref.qmc_box_reduce)(*args)
        errs = []
        for kk, pp, ch in ((k[0], p[0], "count"), (k[1], p[1], "sum")):
            rows = kk.shape[0] if kk.dim() == 2 else 1
            for j, (kr, pr) in enumerate(zip(kk.reshape(rows, -1), pp.reshape(rows, -1))):
                atol = QMC_ATOL * max(float(pr.abs().max()) if pr.numel() else 0.0, 1.0)
                errs.append(held(kr.cpu(), pr.cpu(), QMC_RTOL, atol, f"{what} {ch} row {j}"))
        return max(errs, default=0.0)

    made = calls_dx["qmc_box_reduce_split"] + calls_d["qmc_box_reduce_split"]
    out["qmc_box_reduce"] = max(
        qmc_pair(a, f"qmc_box_reduce {call_shape('qmc_box_reduce_split', a, k)}")
        for a, k in made)
    args = made[0][0]
    k1, k2 = ops.qmc_box_reduce_split(*args), ops.qmc_box_reduce_split(*args)
    check(torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1]),
          "qmc_box_reduce: two launches on the same inputs differ")
    nodes, x, h_inv, log_norm, lo, hi, tgt, _ = calls_dx["qmc_box_reduce_split"][-1][0]
    ns, xs, ls, hs, ts = (nodes[:4096].contiguous(), x[:2048].contiguous(), lo[:32].contiguous(),
                          hi[:32].contiguous(), tgt[:32].contiguous())
    k = ops.qmc_box_reduce(ns, xs, h_inv, log_norm, ls, hs, ts)
    n64, x64, hi64 = ns.double(), xs.double(), h_inv.double()
    f64 = torch.empty(ns.shape[0], dtype=torch.float64, device=dev)
    for s in range(0, ns.shape[0], 512):
        diff = n64[s:s + 512, None, :] - x64[None]
        f64[s:s + 512] = torch.exp(float(log_norm) - 0.5 * torch.sum((diff @ hi64) * diff, -1)).sum(1)
    w = torch.all((n64[None] >= ls.double()[:, None]) & (n64[None] <= hs.double()[:, None]), 2) * f64[None]
    c64 = w.sum(1)
    s64 = (w * n64.T[ts.long()]).sum(1)
    held(k[0].cpu(), c64.cpu(), QMC_RTOL, QMC_ATOL * float(c64.abs().max()), "qmc_box_reduce count vs float64")
    held(k[1].cpu(), s64.cpu(), QMC_RTOL, QMC_ATOL * float(s64.abs().max().clamp_min(1.0)),
         "qmc_box_reduce sum vs float64")

    def qmc_args(n, d, q, m):
        xs = t32(rng.normal(0, 1, (n, d)).astype(np.float32))
        ns = t32(rng.uniform(-2, 2, (m, d)).astype(np.float32))
        a0 = rng.normal(0, 0.3, (d, d))
        Hm = a0 @ a0.T + 0.5 * np.eye(d)
        ls = t32(rng.uniform(-2, 0, (q, d)).astype(np.float32))
        return (ns, xs, t32(np.linalg.inv(Hm).astype(np.float32)),
                float(-0.5 * d * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(Hm)[1]),
                ls, ls + 1.5, t32(rng.integers(0, d, q), torch.int32))

    for n, d, q, m in ((1, 1, 1, 1), (4097, 3, 70, 1000), (300, 8, 5, 33), (0, 2, 3, 4),
                       (10, 2, 0, 4), (10, 2, 3, 0)):
        args = qmc_args(n, d, q, m)
        check(ops.qmc_box_reduce(*args)[0].shape == (q,), f"qmc_box_reduce q={q} shape")
        qmc_pair(args, f"qmc_box_reduce n={n} d={d} q={q} m={m}")
    # the split launch at edge shapes: m below one density block's 512 nodes,
    # n not a multiple of a chunk, a split tail, d = 1..8, 0 and 16 splits
    for n, d, q, m, sp in [(4100, 1, 70, 300, 8), (32_768 + 7, 1, 256, 4096, 8),
                           (999, 2, 5, 33, 16), (3000, 5, 9, 1000, 0), (8, 2, 3, 17, 8)] + \
            [(700 + d, d, 17, 777, 3) for d in range(1, 9)]:
        args = qmc_args(n, d, q, m) + (sp,)
        check(ops.qmc_box_reduce_split(*args)[0].shape == (sp + 1, q),
              f"qmc_box_reduce_split splits={sp} shape")
        qmc_pair(args, f"qmc_box_reduce_split n={n} d={d} q={q} m={m} splits={sp}")
    print(f"qmc_box_reduce: all {len(made)} calls of paths D exact and D "
          f"({call_shape('qmc_box_reduce_split', made[0][0], {})} first) match plain on "
          f"every row (the whole sample and each CI chunk), max |err| "
          f"{out['qmc_box_reduce']:.3g}; two launches give the same bits; m=4096 n=2048 q=32 "
          f"within tolerance of float64; edge shapes n/m/q = 0 and 1, d=1..8, m < 512, "
          f"split tails, 0 and 16 splits match plain")

    def rff_pair(name, args, what):
        k, p = getattr(ops, name)(*args), getattr(ref, name)(*args)
        if name == "rff_density":
            return held(k.cpu(), p.cpu(), RFF_RTOL, RFF_ATOL, what)
        check(tuple(k[0].shape) == (args[4], args[0].shape[0]), f"{what} blocks shape")
        return max(held(k[0].cpu(), p[0].cpu(), RFF_RTOL, RFF_ATOL, what + " blocks"),
                   held(k[1].cpu(), p[1].cpu(), RFF_RTOL, RFF_ATOL, what + " estimate"))

    made = [(w, a) for w in WRAPPERS["rff_density"] for a, _ in calls_d[w]]
    out["rff_density"] = max(rff_pair(w, a, f"{w} {call_shape(w, a, {})}") for w, a in made)
    for w, a in made[:1] + made[-1:]:
        k1, k2 = getattr(ops, w)(*a), getattr(ops, w)(*a)
        same = torch.equal(k1, k2) if w == "rff_density" else (
            torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1]))
        check(same, f"{w}: two launches on the same inputs differ")
    big = max((a for _, a in made), key=lambda a: a[0].shape[0] * a[1].shape[0])
    p, w_, b_, z_ = big[:4]
    ps = p[:512].contiguous()
    kb, ke = ops.rff_density_blocks(ps, w_, b_, z_, 8)
    cos64 = torch.cos(ps.double() @ w_.double().T + b_.double()[None])
    cb = w_.shape[0] // 8
    held(ke.cpu(), (cos64 @ z_.double()).cpu(), RFF_RTOL, RFF_ATOL, "rff_density vs float64")
    held(kb.cpu(), torch.stack([cos64[:, j * cb:(j + 1) * cb] @ z_[j * cb:(j + 1) * cb].double()
                                for j in range(8)]).cpu(),
         RFF_RTOL, RFF_ATOL, "rff_density blocks vs float64")
    # with one sub-chunk per block the kernel adds the same partials in the
    # same order for one block and for eight
    check(torch.equal(ops.rff_density(p, w_, b_, z_), ops.rff_density_blocks(p, w_, b_, z_, 8)[1])
          or w_.shape[0] != 8 * rt["rff_eval"].TILE or p.device.type != "cuda",
          "rff_density: the one-block estimate differs from the 8-block launch's")
    # edge shapes: m, D = 0 and 1, D mod B != 0, d = 1..8, blocks of one feature
    for m, D, d, nb in [(1, 16, 1, 1), (4097, 515, 8, 8), (0, 16, 2, 1), (5, 0, 2, 1),
                        (4097, 2050, 1, 8), (513, 64, 2, 64), (32_768 + 3, 2048, 3, 8)] + \
            [(700 + d, 300 + d, d, 3) for d in range(1, 9)]:
        args = (t32(rng.normal(0, 1, (m, d)).astype(np.float32)),
                t32(rng.normal(0, 3, (D, d)).astype(np.float32)),
                t32(rng.uniform(0, 2 * np.pi, D).astype(np.float32)),
                t32((rng.normal(0, 1, D) * 2.0 / max(D, 1)).astype(np.float32)))
        check(ops.rff_density(*args).shape == (m,), f"rff_density m={m} shape")
        rff_pair("rff_density", args, f"rff_density m={m} D={D} d={d}")
        rff_pair("rff_density_blocks", args + (nb,), f"rff_density_blocks m={m} D={D} d={d} "
                                                      f"blocks={nb}")
    print(f"rff_density: {len(made)} path-D calls ({', '.join(sorted({w for w, _ in made}))}) "
          f"match plain on the estimate and every block, max |err| {out['rff_density']:.3g}; "
          f"two launches give the same bits; m=512 D={w_.shape[0]} within tolerance of float64 "
          f"for the estimate and the 8 blocks (the projection reaches "
          f"{float((p @ w_.T + b_).abs().max()):.0f} rad); edge shapes m/D = 0 and 1, "
          f"D mod blocks != 0, d=1..8, 64 blocks of one feature match plain")

    def kde_pair(args, what):
        return held(ops.kde_eval(*args).cpu(), ref.kde_eval(*args).cpu(), KDE_RTOL, KDE_ATOL, what)

    made = calls_e["kde_eval"]
    out["kde_eval"] = max(kde_pair(a, f"kde_eval {call_shape('kde_eval', a, k)}")
                          for a, k in made)
    for args, kw in made[:3]:                  # the grids at d = 1 and 3, a trapezoid grid
        check(torch.equal(ops.kde_eval(*args), ops.kde_eval(*args)),
              f"kde_eval {call_shape('kde_eval', args, kw)}: two launches on the same "
              f"inputs differ")
    # a point's density has the same bits alone and inside its grid (the
    # launcher cuts the sample from n alone, each point is its own centre)
    for args, kw in made[:3]:
        pts, x, h = args
        whole = ops.kde_eval(*args, **kw)
        for i in (0, pts.shape[0] // 3, pts.shape[0] - 1):
            check(torch.equal(ops.kde_eval(pts[i:i + 1].contiguous(), x, h, **kw), whole[i:i + 1]),
                  f"kde_eval {call_shape('kde_eval', args, kw)}: point {i} alone differs from "
                  f"its bits in the grid")
    for pts, x, h in (made[0][0], made[1][0]):
        ps = pts[:256].contiguous()
        k = ops.kde_eval(ps, x, h)
        d = x.shape[1]
        h64 = float(h)
        diff = (ps.double()[:, None, :] - x.double()[None]) / h64
        want = ((2 * math.pi) ** (-d / 2) * h64 ** (-d)
                * torch.exp(-0.5 * torch.sum(diff * diff, -1)).mean(1))
        held(k.cpu(), want.cpu(), KDE_RTOL, KDE_ATOL, f"kde_eval d={d} vs float64")
    # data far from 0 (|x| / h near 1e4): the folded exponent's rounding
    # follows |x - p| / h about each point p, not |x| / h
    for d in (1, 3):
        xs = rng.normal(2000.0, 1.0, (4097, d)).astype(np.float32)
        ps = (2000.0 + np.sort(rng.normal(0.0, 1.5, (1024, d)), axis=0)).astype(np.float32)
        k = ops.kde_eval(t32(ps), t32(xs), 0.2)
        diff = (ps.astype(np.float64)[:, None, :] - xs.astype(np.float64)[None]) / 0.2
        want = ((2 * math.pi) ** (-d / 2) * 0.2 ** (-d)
                * np.exp(-0.5 * np.sum(diff * diff, -1)).mean(1))
        held(k.cpu(), want, KDE_RTOL, KDE_ATOL, f"kde_eval d={d} |x|/h=1e4 vs float64")
    for m, n, d in ((1, 1, 1), (4097, 3000, 16), (513, 4097, 16), (0, 10, 2)):
        args = (t32(rng.normal(0, 1, (m, d)).astype(np.float32)),
                t32(rng.normal(0, 1, (n, d)).astype(np.float32)), 0.6)
        check(ops.kde_eval(*args).shape == (m,), f"kde_eval m={m} shape")
        kde_pair(args, f"kde_eval m={m} n={n} d={d}")
    print(f"kde_eval: all {len(made)} path-E calls (two grids, {len(made) - 2} trapezoid "
          f"grids) match plain, max |err| {out['kde_eval']:.3g}; two launches give the same "
          f"bits, and a point alone its bits in the grid (both grids, a trapezoid grid); 256 points against the full sample, and "
          f"1024 points on data at |x|/h = 1e4, within tolerance of float64 (d=1, 3); edge "
          f"shapes m=0/1/513, n=1, d=16 match plain")
    torch.cuda.synchronize()
    return out


def time_ms(torch, fn, reps: int = 15, warm: int = 3) -> float:
    """Median of `reps` warm runs, each between two CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


# FLOPs per pair of the pairwise kernel (an FMA counts two), with the scale
# and the constants folded into x and the block factor: sub, square, exp2,
# and the polynomial in v with its product with the density and the sum
# (k6: an add and three FMAs; k4: an add and two FMAs; the Gaussian: the
# add)
PAIR_OPS = {"k6": 10, "k4": 8, "gauss": 4}
# SFU (MUFU) instructions per erfc: common.cuh's erfc_gauss takes one ex2
# and one reciprocal, and its ex2 is also the exponential of the density of
# eq. 10, so a first moment's density difference takes none of its own
MUFU_ERFC = 2


def bound_ms(name: str, args, kwargs, poly_share: float = 0.0) -> tuple:
    """(bound ms, "bytes" or "operations", SFU ops) for the work of one call
    on an H100.  The bound is the larger of bytes (each input read once,
    each output written once) over HBM bandwidth and FLOPs over the FP32
    peak, with an FMA as two FLOPs (the convention of the 67 TFLOP/s peak)
    and an exp / erfc / cos as one; a sum of k products is one multiply
    and k - 1 FMAs (its first term needs no add).  SFU ops are the MUFU
    instructions the kernel issues (an exp or exp2 one, an erfcf MUFU_ERFC,
    a reciprocal one, a cos.approx one); the caller turns them into the SFU floor at the SM clock it
    reads.  Per unit of work, FLOPs / SFU ops:
      pairwise_scaled_ksum: PAIR_OPS / 1 per pair;
      aqp_batch_moments: 30 / 2 erfc per (query, point): z_a, z_b (sub,
        mul each), the Phi difference (add, 2 mul, 2 erfc, sub, mul), the
        count add, the density difference (2 x square, mul, exp; sub, mul),
        the moment (FMA, mul, add) and the three FMAs of c^2, s^2, c s; the
        density's two exponentials are the erfcs' own (erfc_gauss), so they
        take no SFU op of their own;
      aqp_box_moments: 13 / 2 erfc per (query, row, axis) (z_a, z_b, the Phi
        difference, two products) and 20 per (query, row) (count add; the
        target's density difference, FMA, mul, product, add; three FMAs);
      sv_matrix: d subs, the quadratic form (d rows of d - a products each
        and the sum of d products: d + 1 multiplies, d(d-1)/2 + d - 1 FMAs)
        per pair: d^2 + 3d - 1 / none;
      lscv_grid_sums: 6 / (1 - poly_share) per (pair, h) (the scale, the
        exp2, two FMAs; poly_share of the exp2 are the kernel's polynomial);
        the grid phase alone, the strict upper triangle of S read once;
      gh_fused_sum: d subs, the quadratic form as in sv_matrix, the exp2,
        two FMAs per pair: (d^2 + 3d + 4) / 1 (the kernel issues one FMA
        more: its sum of d products starts from 0); gh_fused_sums B times
        that, each launch reading x again;
      aqp_grouped_moments (F families over W window tables in one call):
        per (row, window of a table) the Phi difference, 11 / 2 erfc (z_a,
        z_b: sub, mul each; the tail select's add, 2 mul, 2 erfc, sub, mul),
        and 11 more for its first moment where a family with the group axis
        as target uses the table; per (row, family, kept axis) the same
        11 / 2 erfc and the product's mul; per (row, family) with the
        target on a kept axis its first moment, 11; per (row, family,
        category) 10 (two products, two adds, three FMAs for the squares
        and the cross product: 7 instructions); the first moments'
        exponentials are the erfcs' own;
      qmc_box_reduce_split (K row chunks): d subs, the quadratic form (d
        sums of d products, d multiplies and d^2 - d FMAs, then the sum of
        the d products with log_norm, d FMAs), exp, add per (node, row):
        (2d^2 + 2d + 2) / 1, and per (box, node) 2d compares and an add and
        an FMA for each of the K + 1 rows: 2d + 3(K + 1) / none;
      rff_density_blocks (B feature blocks and the estimate): the
        projection (a mul and d - 1 FMAs), the phase add, cos and an FMA
        per (point, feature): 2d + 3 / 1 (the kernel's cosine is one
        cos.approx after its range reduction);
      kde_eval: d subs, the sum of d squares (a multiply, d - 1 FMAs), exp2,
        add per (point, row): 3d + 1 / 1 (the scale is folded into the
        points and rows as they are loaded)."""
    mufu = 0
    if name == "pairwise_scaled_ksum":
        x = args[0]
        n = x.shape[0]
        nbytes = 4 * n + 4 + 4
        pairs = n * (n - 1) // 2
        ops, mufu = PAIR_OPS[kwargs["kind"]] * pairs, pairs
    elif name == "aqp_batch_moments":
        x, _h, a, _b = args
        n, q = x.shape[0], a.shape[0]
        nbytes = 4 * n + 4 + 8 * q + 20 * q
        ops, mufu = 30 * n * q, 2 * MUFU_ERFC * n * q
    elif name == "aqp_box_moments":
        x, _h, lo, _hi, _t = args
        (n, d), q = x.shape, lo.shape[0]
        nbytes = 4 * n * d + 4 * d + 8 * q * d + 4 * q + 20 * q
        ops = (13 * d + 20) * n * q
        mufu = 2 * MUFU_ERFC * d * n * q
    elif name == "sv_matrix":
        n, d = args[0].shape
        nbytes = 4 * n * d + 4 * d * d + 4 * n * n
        ops = (d * d + 3 * d - 1) * n * (n - 1) // 2
    elif name == "lscv_grid_sums":
        n, n_h = args[0].shape[0], args[2].shape[0]
        nbytes = 4 * n * (n - 1) // 2 + 8 * n_h + 8
        terms = n_h * n * (n - 1) // 2
        ops, mufu = 6 * terms, round((1.0 - poly_share) * terms)
    elif name in ("gh_fused_sum", "gh_fused_sums"):
        (n, d), B = args[0].shape, (args[1].shape[0] if name == "gh_fused_sums" else 1)
        nbytes = B * (4 * n * d + 4 * d * d + 8 + 4)
        pairs = B * (n * (n - 1) // 2)
        ops, mufu = (d * d + 3 * d + 4) * pairs, pairs
    elif name == "aqp_grouped_moments":
        x, _h, lo, _hi, wlo, _whi, win, g_axes, tgts = args
        (n, d), F, (W, G) = x.shape, lo.shape[0], wlo.shape
        nbytes = 4 * n * d + 4 * d + 8 * F * d + 8 * W * G + 20 * F * G
        fams = list(zip(win, g_axes, tgts))
        tables = {(w, g) for w, g, _ in fams}
        self_tables = {(w, g) for w, g, t in fams if g == t}
        kept_tgt = sum(g != t for _, g, t in fams)
        ops = (n * G * (11 * len(tables) + 11 * len(self_tables))
               + n * F * (d - 1) * 12 + n * kept_tgt * 11 + n * F * G * 10)
        mufu = n * G * 2 * MUFU_ERFC * len(tables) + n * F * (d - 1) * 2 * MUFU_ERFC
    elif name == "qmc_box_reduce_split":
        (m, d), n, q, k = args[0].shape, args[1].shape[0], args[4].shape[0], args[7]
        nbytes = 4 * (m * d + n * d + d * d + 1 + 2 * q * d + q) + 8 * q * (k + 1)
        ops = (2 * d * d + 2 * d + 2) * m * n + (2 * d + 3 * (k + 1)) * q * m
        mufu = m * n
    elif name in ("rff_density", "rff_density_blocks"):
        (m, d), nf = args[0].shape, args[1].shape[0]
        n_out = 1 + (args[4] if name == "rff_density_blocks" else 0)
        nbytes = 4 * (m * d + nf * d + 2 * nf) + 4 * m * n_out
        ops, mufu = (2 * d + 3) * m * nf, m * nf
    elif name == "kde_eval":
        (m, d), n = args[0].shape, args[1].shape[0]
        nbytes = 4 * (m * d + n * d + 1) + 4 * m
        ops, mufu = (3 * d + 1) * m * n, m * n
    else:
        raise KeyError(f"bound_ms: no count of {name}'s work")
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", mufu
    return t_bytes, "bytes", mufu


def sfu_floor_ms(mufu: int, clock_mhz: float) -> float:
    """MUFU instructions over 16 per clock per SM on 132 SMs at the SM
    clock read (MHz)."""
    return mufu / (SFU_LANES * clock_mhz * 1e6) * 1e3


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def timings(torch, rt, first, main_calls, calls_a, calls_d, calls_dx, calls_e):
    """Kernel and plain version on the inputs of each kernel's first call
    on its path (`first`: name -> (wrapper, args, kwargs)), in the order plain,
    kernel, kernel, plain, with the SM clock read just after the kernel's
    windows for its SFU floor.  lscv_grid_sums is timed as its grid phase
    alone, over the S that sv_matrix makes from those inputs.  A plain
    version whose first call takes over a second is timed over 2 runs, one
    over a tenth of a second over 5, the rest over 15; each line says
    which."""
    ops, ref = rt["ops"], rt["ref"]
    poly_share = rt["lscv_grid"].POLY_SHARE
    out = {}
    for name in TPU_KERNELS:
        wrapper, args, kw = first[name]
        note = "" if wrapper == name else f", {wrapper}"
        if name == "lscv_grid_sums":
            x, m, hg, c_k, c_kk = args
            s_mat = ops.sv_matrix(x, m)

            def kern():
                return ops.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk)

            def plain():
                return ref.lscv_grid_sums_from_s(s_mat, hg, c_k, c_kk)
            note = ", grid phase alone over its S"
        else:
            def kern():
                return getattr(ops, wrapper)(*args, **kw)

            def plain():
                return getattr(ref, wrapper)(*args, **({} if name == "sv_matrix" else kw))
        probe = time_ms(torch, plain, reps=1, warm=0)
        reps, warm = (2, 0) if probe > 1000 else ((5, 1) if probe > 100 else (15, 3))
        p1 = time_ms(torch, plain, reps=reps, warm=warm)
        k1 = time_ms(torch, kern)
        k2 = time_ms(torch, kern)
        mhz = sm_clock_mhz()
        p2 = time_ms(torch, plain, reps=reps, warm=warm)
        s_mat = None
        b, by, mufu = bound_ms(wrapper, args, kw, poly_share)
        sfu = sfu_floor_ms(mufu, mhz)
        out[name] = (min(k1, k2), min(p1, p2), b, by, sfu, mhz)
        which = "largest" if name == "rff_density" else "first"
        print(f"time {name} ({call_shape(wrapper, args, kw)}, the {which} call on path "
              f"{KERNEL_PATH[name]}{note}): kernel {k1:.4f} / {k2:.4f} ms (median of 15), "
              f"plain {p1:.4f} / {p2:.4f} ms (median of {reps}), bound {b:.4f} ms ({by}), "
              f"SFU floor {sfu:.4f} ms ({mufu} MUFU at {mhz:.0f} MHz); no single PyTorch "
              f"call computes it (library_ms null)")
    x, h = main_calls["aqp_batch_moments"][0][0][:2]
    a, b = all_range_bounds(torch, main_calls)
    k1 = time_ms(torch, lambda: ops.aqp_batch_moments(x, h, a, b))
    k2 = time_ms(torch, lambda: ops.aqp_batch_moments(x, h, a, b))
    print(f"time aqp_batch_sums extra shape ({call_shape('aqp_batch_moments', (x, h, a, b), {})}"
          f", all range groups in one launch): kernel {k1:.4f} / {k2:.4f} ms, "
          f"bound {bound_ms('aqp_batch_moments', (x, h, a, b), {})[0]:.4f} ms")
    x, m = calls_a["sv_matrix"][-1][0][:2]
    k1 = time_ms(torch, lambda: ops.sv_matrix(x, m))
    k2 = time_ms(torch, lambda: ops.sv_matrix(x, m))
    print(f"time sv_matrix extra shape ({call_shape('sv_matrix', (x, m), {})}, the joint's "
          f"call on path A): kernel {k1:.4f} / {k2:.4f} ms, "
          f"bound {bound_ms('sv_matrix', (x, m), {})[0]:.4f} ms")
    args, kw = first_d1_gh(calls_d)
    p1 = time_ms(torch, lambda: ref.gh_fused_sums(*args, **kw))
    k1 = time_ms(torch, lambda: ops.gh_fused_sums(*args, **kw))
    k2 = time_ms(torch, lambda: ops.gh_fused_sums(*args, **kw))
    mhz = sm_clock_mhz()
    p2 = time_ms(torch, lambda: ref.gh_fused_sums(*args, **kw))
    b, by, mufu = bound_ms("gh_fused_sums", args, kw)
    print(f"time gh_fused_sum second shape ({call_shape('gh_fused_sums', args, kw)}, the first "
          f"1-D call on path D): kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
          f"bound {b:.4f} ms ({by}), SFU floor {sfu_floor_ms(mufu, mhz):.4f} ms at {mhz:.0f} MHz")
    args, kw = next(c for c in calls_dx["qmc_box_reduce_split"] if c[0][1].shape[1] == 3)
    p1 = time_ms(torch, lambda: ref.qmc_box_reduce_split(*args, **kw), reps=5, warm=1)
    k1 = time_ms(torch, lambda: ops.qmc_box_reduce_split(*args, **kw))
    k2 = time_ms(torch, lambda: ops.qmc_box_reduce_split(*args, **kw))
    mhz = sm_clock_mhz()
    p2 = time_ms(torch, lambda: ref.qmc_box_reduce_split(*args, **kw), reps=5, warm=1)
    b, by, mufu = bound_ms("qmc_box_reduce_split", args, kw)
    print(f"time qmc_box_reduce second shape ({call_shape('qmc_box_reduce_split', args, kw)}, "
          f"the joint's call on path D exact): kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
          f"{p2:.4f} ms (median of 5), bound {b:.4f} ms ({by}), SFU floor "
          f"{sfu_floor_ms(mufu, mhz):.4f} ms at {mhz:.0f} MHz")
    for what, (args, kw) in (("the joint's grid", calls_e["kde_eval"][1]),
                             ("the first trapezoid grid", calls_e["kde_eval"][2])):
        p1 = time_ms(torch, lambda: ref.kde_eval(*args, **kw))
        k1 = time_ms(torch, lambda: ops.kde_eval(*args, **kw))
        k2 = time_ms(torch, lambda: ops.kde_eval(*args, **kw))
        mhz = sm_clock_mhz()
        p2 = time_ms(torch, lambda: ref.kde_eval(*args, **kw))
        b, by, mufu = bound_ms("kde_eval", args, kw)
        print(f"time kde_eval other shape ({call_shape('kde_eval', args, kw)}, {what} on path "
              f"E): kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, bound "
              f"{b:.4f} ms ({by}), SFU floor {sfu_floor_ms(mufu, mhz):.4f} ms at {mhz:.0f} MHz")
    return out


# --- phase K: the kernel-centred box kernel ---------------------------------------------

K_CELL = (16_384, 64, 128, 8, 8)     # m, draws a row, boxes, d, CI chunks: joint8.lscv_H.kernel


def k_inputs(torch, rt, rng, m: int, draws: int, q: int, d: int):
    """A sample of m rows, an SPD H's float32 Cholesky factor, the cached
    draws and q boxes of the benchmark's width over the sample's spread."""
    x = rng.normal(0.0, 1.0, (m, d)).astype(np.float32)
    a = rng.normal(0.0, 0.3, (d, d))
    L = np.linalg.cholesky(a @ a.T + 0.05 * np.eye(d)).astype(np.float32)
    lo = rng.uniform(-1.5, 0.3, (q, d)).astype(np.float32)
    hi = (lo + rng.uniform(0.6, 2.5, (q, d))).astype(np.float32)
    dev = torch.device("cuda")
    z = rt["aqp_multid"].kernel_normals(m, draws, d, dev)
    return (torch.as_tensor(x, device=dev), z, torch.as_tensor(L, device=dev),
            torch.as_tensor(lo, device=dev), torch.as_tensor(hi, device=dev),
            torch.as_tensor(rng.integers(0, d, q).astype(np.int32), device=dev))


def k_bound_ms(m: int, draws: int, q: int, d: int, chunks: int) -> float:
    """`bench/metrics/draw_box_reduce_roofline.py`'s count: per draw d(d+1)
    FLOPs of x_i + L z, per (draw, box) 2d + 3; bytes of x, L, the boxes
    and targets and the float64 sums once (z, a constant of the shape, not
    counted)."""
    n = m * draws
    flops = n * d * (d + 1) + n * q * (2 * d + 3)
    nbytes = 4 * m * d + 4 * d * d + 8 * q * d + 4 * q + 16 * (chunks + 1) * q
    return 1e3 * max(nbytes / PEAK_BYTES, flops / PEAK_FP32)


def phase_k(torch, rt) -> dict:
    """`ops.draw_box_reduce` against its plain version (`kernels/ref.py`) at
    the cell's shape and at edge shapes (d = 1..8; m = 1, 2, 513; no chunks,
    8 and 16; K = 1 and 64): the counts within two draws of the plain
    version's (a draw within a float32 rounding of a face may fall on the
    other side when x_i + L z is formed in another order), the sums within
    1e-5 plus two draws at the largest bound; two launches give the same
    bits; a draw lying on a face is counted; one launch a call; then the
    kernel and the plain version timed at the cell's shape beside the
    bound."""
    ops, ref = rt["ops"], rt["ref"]
    rng = np.random.default_rng(33)
    ops.reset_launch_counts()
    cases = [K_CELL] + [(m, draws, 17, d, splits) for d in range(1, 9)
                        for m, draws, splits in ((1, 64, 0), (2, 1, 0), (513, 64, 8))]
    cases += [(700, 7, 33, 5, 16)]
    worst = 0.0
    for m, draws, q, d, splits in cases:
        args = k_inputs(torch, rt, rng, m, draws, q, d) + (splits,)
        k = ops.draw_box_reduce(*args)
        p = ref.draw_box_reduce(*args)
        torch.cuda.synchronize()
        bound = float(torch.maximum(args[3].abs(), args[4].abs()).max())
        dc = float((k[0] - p[0]).abs().max())
        ds = float(((k[1] - p[1]).abs() - 1e-5 * p[1].abs()).max())
        check(dc <= 2.0 and ds <= 2.0 * bound,
              f"draw_box_reduce m={m} K={draws} q={q} d={d} S={splits}: counts off by "
              f"{dc}, sums by {ds} past 1e-5 (two draws: {2.0 * bound})")
        worst = max(worst, dc)
        again = ops.draw_box_reduce(*args)
        check(torch.equal(k[0], again[0]) and torch.equal(k[1], again[1]),
              f"draw_box_reduce m={m} d={d}: two launches differ")
    n_launch = ops.launch_counts()["draw_box_reduce"]
    check(n_launch == 2 * len(cases), f"draw_box_reduce: {n_launch} launches for "
          f"{2 * len(cases)} calls")
    # a draw on a face: L = I makes the draws x_i + z exactly; a point box
    # at the first draw holds it
    for d in (1, 8):
        x, z, _, _, _, tgt = k_inputs(torch, rt, rng, 4, 64, 1, d)
        eye = torch.eye(d, device=x.device)
        y0 = (x[0] + z[0])[None].contiguous()
        cnt, _ = ops.draw_box_reduce(x, z, eye, y0, y0, tgt[:1].contiguous(), 0)
        check(float(cnt[0, 0]) >= 1.0, f"draw_box_reduce d={d}: the draw on the face missed")
    m, draws, q, d, splits = K_CELL
    args = k_inputs(torch, rt, rng, m, draws, q, d) + (splits,)
    p1 = time_ms(torch, lambda: ref.draw_box_reduce(*args), reps=5, warm=1)
    k1 = time_ms(torch, lambda: ops.draw_box_reduce(*args))
    k2 = time_ms(torch, lambda: ops.draw_box_reduce(*args))
    mhz = sm_clock_mhz()
    p2 = time_ms(torch, lambda: ref.draw_box_reduce(*args), reps=5, warm=1)
    b = k_bound_ms(m, draws, q, d, splits)
    print(f"time draw_box_reduce (m={m}, K={draws}, q={q}, d={d}, {splits} CI chunks, the "
          f"cell joint8.lscv_H.kernel's launch): kernel {k1:.4f} / {k2:.4f} ms (median of 15), "
          f"plain {p1:.4f} / {p2:.4f} ms (median of 5), bound {b:.4f} ms (operations) at "
          f"{mhz:.0f} MHz; replaces no TPU kernel; no single PyTorch call computes it")
    return {"cases": len(cases), "max_count_err": worst, "launches": n_launch,
            "kernel_ms": [k1, k2], "plain_ms": [p1, p2], "bound_ms": b,
            "roofline_pct": 100.0 * b / min(k1, k2), "sm_clock_mhz": mhz, "card": card_line()}


def runtime(torch) -> dict:
    """The port's modules, imported from this checkout's `src`."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch import obs, synopses
    from repro_torch.core import (aqp, aqp_ci, aqp_multid, aqp_query, binned, distributed,
                                  gaussian, kde, lscv, plugin, reductions)
    from repro_torch.data import aqp_store
    from repro_torch.kernels import (_build, _launch, aqp_batch, aqp_boxes, autotune,
                                     lscv_grid, ops, pairwise_reduce, qmc_reduce, ref,
                                     rff_eval, triangle)
    from repro_torch.launch import serve
    return {"query": aqp_query, "plugin": plugin, "lscv": lscv, "store": aqp_store,
            "ops": ops, "ref": ref, "pairwise_reduce": pairwise_reduce, "aqp": aqp,
            "aqp_ci": aqp_ci, "aqp_batch": aqp_batch, "aqp_boxes": aqp_boxes,
            "launch": _launch, "lscv_grid": lscv_grid, "rff_eval": rff_eval,
            "aqp_multid": aqp_multid, "kde": kde, "synopses": synopses, "obs": obs,
            "serve": serve, "qmc_reduce": qmc_reduce, "autotune": autotune,
            "build": _build, "binned": binned, "distributed": distributed,
            "gaussian": gaussian, "reductions": reductions, "triangle": triangle,
            "dist": dist}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", choices=["tuned", "restore"], default=None,
                    help="run as phase T's or path H's second process")
    ap.add_argument("--cache", help="--child tuned: the tile cache to load")
    ap.add_argument("--snapshot", help="--child restore: the snapshot directory")
    ap.add_argument("--out", help="--child: where to write its answers (npz)")
    ap.add_argument("--only", choices=["kernel-boxes"], default=None,
                    help="run the card line, the build and phase K alone")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.child:
        return child_main(args)
    rt = runtime(torch)
    _build = rt["build"]
    t_start = time.perf_counter()

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s ({', '.join(_build.SOURCES.values())})")
    if args.only == "kernel-boxes":
        print(json.dumps({"phase_k": phase_k(torch, rt)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    store, specs, gspecs, stream = build_store(args, rt, rt["query"])
    counts = {}
    counts["plugin"], calls_main = main_path(torch, rt, store, specs, stream)
    counts["A"], calls_a = path_a(torch, rt, store, specs, stream)
    counts["B"], calls_b = path_b(torch, rt, store)
    print(f"phases through path B: {time.perf_counter() - t_start:.1f} s")
    counts["C"], calls_c = path_c(torch, rt, store, gspecs, stream)
    counts["D"], calls_d, counts["D exact"], calls_dx = path_d(torch, rt, store, specs)
    counts["E"], calls_e = path_e(torch, rt, store, specs)
    print(f"phases through path E: {time.perf_counter() - t_start:.1f} s")
    t_f = time.perf_counter()
    counts["F"], calls_f, rounds_f, summary_f, errs_f = path_f(torch, rt, args, stream, specs)
    f_kernels = path_f_timings(torch, rt, rounds_f, calls_f, errs_f, counts["F"])
    print(f"path F: {time.perf_counter() - t_f:.1f} s in all ({summary_f['setup_s']:.2f} s "
          f"set-up); through path F: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"path_f": summary_f}))
    t_g = time.perf_counter()
    summary_g, g_ctx = path_g(torch, rt, args, stream, calls_main, calls_c, calls_d, calls_dx)
    print(f"path G: {time.perf_counter() - t_g:.1f} s in all ({summary_g['setup_s']:.2f} s "
          f"set-up); through path G: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"path_g": summary_g}))
    t_t = time.perf_counter()
    summary_t = phase_t(torch, rt, args, store, specs, stream, g_ctx)
    print(f"phase T: {time.perf_counter() - t_t:.1f} s; through phase T: "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"phase_t": summary_t}))
    t_h = time.perf_counter()
    summary_h = path_h(torch, rt, args, g_ctx)
    del g_ctx
    print(f"path H: {time.perf_counter() - t_h:.1f} s; through path H: "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"path_h": summary_h}))
    t_i = time.perf_counter()
    summary_i = phase_i(torch, rt, stream)
    print(f"phase I: {time.perf_counter() - t_i:.1f} s; through phase I: "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"phase_i": summary_i}))
    t_l = time.perf_counter()
    summary_l = phase_l(torch, rt)
    print(f"phase L: {time.perf_counter() - t_l:.1f} s; through phase L: "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"phase_l": summary_l}))
    t_r = time.perf_counter()
    summary_r = phase_r(torch, rt)
    print(f"phase R: {time.perf_counter() - t_r:.1f} s; through phase R: "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"phase_r": summary_r}))
    t_m = time.perf_counter()
    summary_m = phase_m(torch, rt)
    print(f"phase M: {time.perf_counter() - t_m:.1f} s; through phase M: "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"phase_m": summary_m}))
    t_k = time.perf_counter()
    summary_k = phase_k(torch, rt)
    print(f"phase K: {time.perf_counter() - t_k:.1f} s")
    print(json.dumps({"phase_k": summary_k}))
    errs = kernels_vs_plain(torch, rt, calls_main, calls_c)
    errs.update(lscv_kernels_vs_plain(torch, rt, calls_a, calls_b, calls_d))
    errs.update(fullh_grouped_vs_plain(torch, rt, calls_c, calls_d, calls_dx, calls_e))
    print(f"phases through the plain-version checks: {time.perf_counter() - t_start:.1f} s")
    paths = {"plugin": calls_main, "A": calls_a, "B": calls_b, "C": calls_c, "D": calls_d,
             "D exact": calls_dx, "E": calls_e, "F": calls_f}
    first = {}
    for name in TPU_KERNELS:
        made = paths[KERNEL_PATH[name]]
        wrapper = next(w for w in WRAPPERS[name] if made[w])
        first[name] = (wrapper,) + made[wrapper][0]
    first["rff_density"] = max(
        ((w,) + c for w in WRAPPERS["rff_density"] for c in calls_d[w]),
        key=lambda c: c[1][0].shape[0] * c[1][1].shape[0])
    times = timings(torch, rt, first, calls_main, calls_a, calls_d, calls_dx, calls_e)
    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        k_ms, p_ms, b_ms, by, sfu, mhz = times[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[KERNEL_PATH[name]][name],
                        "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                        "sfu_floor_ms": sfu, "sm_clock_mhz": mhz})
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"path_f_kernels": f_kernels}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
