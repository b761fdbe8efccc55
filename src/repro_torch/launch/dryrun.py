"""Multi-pod dry run (counterpart: `repro/launch/dryrun.py`): trace every
(architecture x input shape) cell on the production meshes and extract
memory, cost and roofline records, in one process and without the cards.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all              # 16 x 16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod  # 2 x 16 x 16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --mesh-shape 2,2 \\
      --arch llama3.2-1b --shape decode_32k

The mesh spans a fake process group (`launch.mesh`): collectives move
nothing.  The model is built at full size on fake tensors (nothing is
allocated), its parameters placed as DTensors under the specs of
`models.api`, and one step traced under `roofline.TraceCostModel`: the
train step (with `param_constraint` when gathering once), the prefill or
the decode step.  Like every entry point of the port it wants the CUDA
device (fake tensors on "cuda", a "cuda" mesh) and raises without one
unless `--device cpu`.

One JSON record per cell (appended to --out as a line), with the
reference's keys, so its readers (`benchmarks/bench_roofline.py`,
`bench_serving.py`) read these records as they are.  In the port they hold:
  compile_s               the seconds of the trace (nothing is compiled);
  memory.*_gb_per_dev     from the trace, not from a compiler's buffer
                          assignment: argument = the local shards of the
                          parameters, AdamW moments, batch and cache;
                          temp = the peak of the live bytes the step made;
                          output = the step's results' local bytes;
                          alias = what the step updates in place (the
                          parameters and moments on train, the cache on
                          decode).  They do not compare with the
                          reference's gigabytes;
  cost_raw.flops_per_dev  every local op's FLOPs by the formulas of
                          `torch.utils.flop_counter` (bytes: None);
  hlo_dot_flops_per_dev   TraceCostModel's dot FLOPs of one device;
  collective_bytes_per_dev / collective_by_kind  its collective bytes;
  model_flops, analytic_hbm_bytes  the reference's formulas (`roofline`);
  roofline                the three terms with the H100's figures.
The SSM families' loops over time are traced one step and scaled by the
trip count (`models.layers.time_scan` under the trace).

`--kde n,d,n_h` records the paper's own technique instead: the distributed
LSCV_h grid (`core.distributed.sharded_lscv_h_grid`) over every rank on
the "torch" backend, the reference's own algorithm ("mxu" by default).
The "cuda" backend cannot be traced: its kernels launch through ctypes on
data pointers, which fake tensors lack.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback


def default_n_micro(shape, dp_total: int) -> int:
    if shape.kind != "train":
        return 1
    # one-to-two sequences per device per microbatch
    n = max(1, shape.global_batch // max(dp_total, 1) // 2)
    while shape.global_batch % n:
        n -= 1
    return n


def _fix_batch_specs(cfg, shape, dp):
    """Replicate the batch when it cannot shard over dp (e.g. long_500k B=1)."""
    from repro_torch.models import batch_specs
    from repro_torch.sharding import P
    specs = batch_specs(cfg, dp)
    if shape.global_batch == 1:
        specs = {k: P(*([None] * len(s))) for k, s in specs.items()}
    return specs


def _fake_inputs(structs: dict, vocab: int):
    """Tensors of the given (shape, dtype)s (under a fake mode: nothing
    allocated): token ids below `vocab`, zeros for the rest."""
    import torch
    out = {}
    for k, (shape, dt) in structs.items():
        if dt in (torch.int32, torch.int64):
            out[k] = torch.randint(0, vocab, shape, dtype=torch.long)
        else:
            out[k] = torch.zeros(shape, dtype=dt)
    return out


def _local_bytes(tree) -> int:
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


@contextlib.contextmanager
def _real_redistribution_plans():
    """DTensor plans a redistribution, and cuts a `_StridedShard` (a view
    that merges dims sharded over different mesh axes), with small index
    tensors whose values it reads; under the trace's fake mode those would
    be fake and unreadable.  For the trace, those two run with the fake
    mode off."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute
    from torch.distributed.tensor.placement_types import _StridedShard

    def real(fn):
        def wrapped(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return wrapped

    patched = [(_redistribute, "_gen_transform_infos_non_cached"),
               (_StridedShard, "local_shard_size_and_offset")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in patched]
    for owner, name, fn in saved:
        setattr(owner, name, real(fn))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _resolve(arch, shape, remat_policy: str):
    from repro_torch.configs.base import SHAPES_BY_NAME, get_config
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    return cfg, (SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape)


def lower_cell(arch, shape, mesh, *, n_micro=None, gather_once: bool = False,
               remat_policy: str = "") -> dict:
    """Trace one cell on `mesh`.  `arch`: an architecture id or a
    ModelConfig; `shape`: a shape name or a ShapeConfig.  Returns meta
    (arch, shape, mesh, chips, n_micro[, gather_once]) with the trace's
    "cost" (the TraceCostModel), "seconds" and "memory" (bytes a device)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import sharding
    from repro_torch.launch.mesh import dp_axes, mesh_shape
    from repro_torch.models import (build_model, cache_specs_with_dp, decode_struct,
                                    param_specs_with_dp)
    from repro_torch.models.api import batch_struct
    from repro_torch.optim import adamw
    from repro_torch.roofline import TraceCostModel
    from repro_torch.sharding import P
    from repro_torch.train import make_train_step, train_params

    cfg, shape = _resolve(arch, shape, remat_policy)
    dp = dp_axes(mesh)
    dp_total = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in dp)
    chips = mesh.size()
    dev = mesh.device_type
    meta = {"arch": cfg.name if not isinstance(arch, str) else arch, "shape": shape.name,
            "mesh": mesh_shape(mesh), "chips": chips}
    fake = FakeTensorMode()
    tc = TraceCostModel(one_step_scans=True)
    with fake, torch.device(dev):
        model = build_model(cfg, dev)
        if shape.kind == "train":
            n_micro = n_micro or default_n_micro(shape, dp_total)
            meta["n_micro"] = n_micro
            model.requires_grad_(True)
            sharding.distribute_model(model, param_specs_with_dp(model, "train", dp), mesh)
            params = train_params(model)
            opt = adamw.init(params)
            batch = sharding.distribute(_fake_inputs(batch_struct(cfg, shape), cfg.vocab_size),
                                        _fix_batch_specs(cfg, shape, dp), mesh)
            # gather the FSDP weights once a step whenever the TP-only weights
            # and the float32 accumulators fit (the reference's rule)
            if cfg.param_count() < 20e9:
                gather_once = True
            constraint = None
            if gather_once:
                meta["gather_once"] = True
                constraint = param_specs_with_dp(model, "serve", dp)
            step = make_train_step(model, adamw.AdamWConfig(), n_micro,
                                   param_constraint=constraint)
            args = (params, opt, batch)
            alias = _local_bytes((params, opt))

            def run():
                return step(params, opt, batch)[2]
        else:
            meta["n_micro"] = 1
            sharding.distribute_model(model, param_specs_with_dp(model, "serve", dp), mesh)
            params = dict(model.named_parameters())
            if shape.kind == "prefill":
                structs = batch_struct(cfg, shape)
                structs.pop("labels")
                specs = _fix_batch_specs(cfg, shape, dp)
                batch = sharding.distribute(_fake_inputs(structs, cfg.vocab_size),
                                            {k: specs[k] for k in structs}, mesh)
                args, alias = (params, batch), 0

                def run():
                    return model.prefill(batch)
            else:
                (tok_shape, _), cache_st, _ = decode_struct(cfg, shape)
                cache = sharding.distribute(
                    _fake_inputs(cache_st, 1),
                    cache_specs_with_dp(model, dp, batch_size=shape.global_batch), mesh)
                dpn = tuple(dp) if len(dp) > 1 else dp[0]
                tok_spec = P(dpn, None) if shape.global_batch > 1 else P(None, None)
                tokens = sharding.distribute(
                    {"t": torch.zeros(tok_shape, dtype=torch.long)}, {"t": tok_spec}, mesh)["t"]
                kw = {}
                if cfg.family == "hybrid" and cfg.sliding_window \
                        and shape.seq_len > cfg.sliding_window:
                    kw["window"] = cfg.sliding_window
                args, alias = (params, cache, tokens), _local_bytes(cache)

                def run():
                    return model.decode_step(cache, tokens, shape.seq_len - 1, **kw)
        arg_bytes = tc.register_args(args)
        t0 = time.perf_counter()
        with _real_redistribution_plans(), tc, implicit_replication(), \
                torch.set_grad_enabled(shape.kind == "train"):
            out = run()
        seconds = time.perf_counter() - t0
        out_bytes = _local_bytes(out) if shape.kind != "train" else 0
    meta.update(cost=tc, seconds=seconds,
                memory={"argument": arg_bytes, "temp": tc.peak_bytes, "output": out_bytes,
                        "alias": alias})
    return meta


def _memory_gb(mem: dict) -> dict:
    return {f"{k}_gb_per_dev": v / 1e9 for k, v in mem.items()}


def analyse_cell(arch, shape, mesh, *, n_micro=None, gather_once: bool = False,
                 remat_policy: str = "") -> dict:
    from repro_torch import roofline

    meta = lower_cell(arch, shape, mesh, n_micro=n_micro, gather_once=gather_once,
                      remat_policy=remat_policy)
    cfg, shape = _resolve(arch, shape, remat_policy)
    tc, chips = meta.pop("cost"), meta["chips"]
    seconds, mem = meta.pop("seconds"), meta.pop("memory")
    dot = tc.dot_flops
    coll, by_kind = tc.collective_bytes()
    mf = roofline.model_flops(cfg, shape)
    hbm = roofline.hbm_bytes(cfg, shape, meta.get("n_micro", 1))
    rec = dict(meta)
    rec.update({
        "ok": True,
        "compile_s": round(seconds, 2),
        "memory": _memory_gb(mem),
        "cost_raw": {"flops_per_dev": tc.flops_all, "bytes_accessed_per_dev": None},
        "hlo_dot_flops_per_dev": dot,
        "hlo_dot_flops_global": dot * chips,
        "collective_bytes_per_dev": coll,
        "collective_by_kind": by_kind,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(dot * chips, 1.0),
        "analytic_hbm_bytes": hbm,
        "roofline": roofline.terms(dot * chips, hbm, coll, chips),
    })
    return rec


def analyse_kde_cell(mesh, n: int = 1_048_576, d: int = 4, n_h: int = 150,
                     chunk: int = 64, algorithm: str = "mxu") -> dict:
    """Roofline record of the paper's own technique on the mesh: the
    distributed LSCV_h grid over every rank (float32, off the tensor
    cores: the compute term takes PEAK_FLOPS_FP32)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import roofline
    from repro_torch.core import gaussian as G
    from repro_torch.core.distributed import sharded_lscv_h_grid
    from repro_torch.launch.mesh import mesh_shape

    chips = mesh.size()
    dev = mesh.device_type
    c_k, c_kk, _ = G.lscv_h_consts(d, 1.0)
    fake = FakeTensorMode()
    tc = roofline.TraceCostModel()
    with fake, torch.device(dev):
        x = torch.zeros((n, d), dtype=torch.float32)
        sigma_inv = torch.zeros((d, d), dtype=torch.float32)
        h_grid = torch.linspace(0.05, 0.8, n_h, dtype=torch.float32)
        arg_bytes = tc.register_args((x, sigma_inv, h_grid))
        t0 = time.perf_counter()
        with tc:
            out = sharded_lscv_h_grid(x, sigma_inv, h_grid, c_k, c_kk, chunk=chunk,
                                      algorithm=algorithm, backend="torch", device=dev)
        seconds = time.perf_counter() - t0
        out_bytes = _local_bytes(out)
    coll, by_kind = tc.collective_bytes()
    pairs = n * (n - 1) / 2
    # quadform 2 MACs/dim^2-ish + ~8 flops per (pair, h) for the two exps
    mf = pairs * (4.0 * d * d + 8.0 * n_h)
    hbm = n * d * 4.0 * (pairs / (chunk * n))   # x re-read per row-chunk slab
    return {
        "arch": "kde_lscv_h", "shape": f"n{n}_d{d}_nh{n_h}_{algorithm}",
        "mesh": mesh_shape(mesh), "chips": chips, "ok": True,
        "compile_s": round(seconds, 2),
        "memory": _memory_gb({"argument": arg_bytes, "output": out_bytes,
                              "temp": tc.peak_bytes, "alias": 0}),
        "hlo_dot_flops_per_dev": tc.dot_flops,
        "collective_bytes_per_dev": coll,
        "collective_by_kind": by_kind,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(tc.dot_flops * chips, 1.0),
        "analytic_hbm_bytes": hbm,
        "roofline": roofline.terms(mf, hbm, coll, chips, peak=roofline.PEAK_FLOPS_FP32),
    }


def make_mesh(args):
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh_from_spec, make_production_mesh
    device_type = resolve_device(args.device).type
    if args.mesh_shape:
        return make_mesh_from_spec(args.mesh_shape, device_type)
    return make_production_mesh(multi_pod=args.multi_pod, device_type=device_type)


def _append(path: str, rec: dict) -> None:
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def run(args) -> int:
    from repro_torch.configs.base import ARCH_IDS, SHAPES, cell_runnable
    from repro_torch.launch.mesh import mesh_shape

    mesh = make_mesh(args)
    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                ok, why = cell_runnable(a, s.name)
                if ok:
                    cells.append((a, s.name))
                else:
                    print(f"SKIP {a} x {s.name}: {why}", flush=True)
                    _append(args.out, {"arch": a, "shape": s.name, "mesh": mesh_shape(mesh),
                                       "ok": False, "skipped": True, "reason": why})
    else:
        cells = [(args.arch, args.shape)]

    mesh_tag = "x".join(str(s) for s in mesh.shape)
    if args.kde:
        parts = args.kde.split(",")
        n, d, n_h = int(parts[0]), int(parts[1]), int(parts[2])
        alg = parts[3] if len(parts) > 3 else "mxu"
        rec = analyse_kde_cell(mesh, n, d, n_h, algorithm=alg)
        print(f"PASS kde_lscv_h n{n} d{d} nh{n_h} x {mesh_tag}: "
              f"compile={rec['compile_s']}s dom={rec['roofline']['dominant']} "
              f"compute={rec['roofline']['compute_s']:.2e}s", flush=True)
        _append(args.out, rec)
        return 0

    failures = 0
    for arch, shape_name in cells:
        tag = f"{arch} x {shape_name} x {mesh_tag}"
        try:
            rec = analyse_cell(arch, shape_name, mesh, n_micro=args.n_micro,
                               gather_once=args.gather_once,
                               remat_policy=args.remat_policy)
            print(f"PASS {tag}: compile={rec['compile_s']}s "
                  f"arg/dev={rec['memory']['argument_gb_per_dev']:.2f}GB "
                  f"temp/dev={rec['memory']['temp_gb_per_dev']:.2f}GB "
                  f"dom={rec['roofline']['dominant']}", flush=True)
        except Exception as e:  # noqa: BLE001 - report and continue
            failures += 1
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_shape(mesh),
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"FAIL {tag}: {type(e).__name__}: {str(e)[:300]}", flush=True)
        _append(args.out, rec)
    return failures


def parser() -> argparse.ArgumentParser:
    from repro_torch.configs.base import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser(description="Trace the LM cells on a fake production "
                                             "mesh: memory, cost and roofline records")
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(ARCH_IDS))
    ap.add_argument("--shape", default="train_4k", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--mesh-shape", default="",
                    help="override mesh, e.g. '4,2' or '2,4,2' (tests)")
    ap.add_argument("--gather-once", action="store_true",
                    help="one FSDP weight all-gather per step, not per microbatch")
    ap.add_argument("--remat-policy", default="", choices=["", "nothing", "dots", "dots_full"],
                    help="per-layer remat policy override")
    ap.add_argument("--kde", default="",
                    help="trace the paper's distributed LSCV_h instead: 'n,d,n_h[,algorithm]'")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="'cpu' traces fake CPU tensors on a CPU mesh (default: the CUDA "
                         "device, raising without one)")
    return ap


def main(argv=None) -> None:
    raise SystemExit(1 if run(parser().parse_args(argv)) else 0)


if __name__ == "__main__":
    main()
