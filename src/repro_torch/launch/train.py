"""Fault-tolerant training driver (counterpart: `repro/launch/train.py`).

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 12 \\
        --batch 8 --seq 512 --n-micro 2
    python -m repro_torch.launch.train --smoke --device cpu --steps 50 \\
        --ckpt-dir /tmp/run1

Wires together: config -> model (random weights, seed 0) -> train step
(autograd, microbatches, AdamW) -> token pipeline -> AQP telemetry ->
checkpoint manager (atomic, asynchronous, keep-k) -> straggler monitor.  On
start it resumes from the latest checkpoint in `--ckpt-dir` if one exists
(parameters, optimiser state, the pipeline's cursor), which is the
crash-restart path; `--simulate-failure-at N` exits with code 42 after step
N, to exercise it.  Checkpoints keep the reference's layout, so either
package resumes the other's run.

It runs on the CUDA device and raises without one, unless `--device cpu`
asks for the CPU.  A step's time is taken after its loss is read, which
waits for the device (the reference takes it before, which times the
dispatch only).  The token pipeline feeds tokens only, as the reference's
does, so the VLM and encoder-decoder families, whose losses also need
patch embeddings or encoder frames, are refused.  The reference's
docstring promises `--compress-grads`, which its parser lacks; the port
has no such flag (`optim/grad_compress.py` is reached from its tests).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

TOKEN_ONLY = ("dense", "moe", "ssm", "hybrid")     # families the pipeline feeds whole


def run_train(args) -> dict:
    """Train `args.steps` steps (from the latest checkpoint on); returns the
    model, its parameters and optimiser state, and every step's loss and
    grad norm (floats) and seconds."""
    import torch

    from repro_torch.checkpoint import CheckpointManager, StragglerMonitor
    from repro_torch.configs.base import get_config
    from repro_torch.data.aqp_store import TelemetryStore
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.device import card_line, resolve_device, synchronize
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step, train_params
    from repro_torch.train.train_step import load_state_tree, state_tree

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family not in TOKEN_ONLY:
        raise ValueError(f"{cfg.name} ({cfg.family}) needs frontend inputs the token "
                         f"pipeline does not feed")
    model = build_model(cfg, device, torch.Generator(device=device).manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)
    telemetry = TelemetryStore(device=device)
    pipeline = TokenPipeline(cfg.vocab_size, args.batch, args.seq, telemetry=telemetry,
                             device=device)
    params = train_params(model)
    opt_state = adamw.init(params)
    n_params = sum(p.numel() for p in params.values())
    print(f"[train] {cfg.name} ({cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params:,} parameters, {cfg.param_dtype}, remat "
          f"{cfg.remat_policy if cfg.remat else 'off'}) on {device}; batch {args.batch} x "
          f"{args.seq}, {args.n_micro} microbatch(es)", flush=True)
    if device.type == "cuda":
        print(f"[train] card: {card_line()}", flush=True)
    step0, load_ms, save_ms = 0, None, None

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and ckpt.latest_step() is not None:
        latest = ckpt.latest_step()
        t0 = time.perf_counter()
        tree, extra = ckpt.restore(latest, state_tree(params, opt_state))
        opt_state = load_state_tree(tree, params, opt_state)
        synchronize(device)
        load_ms = (time.perf_counter() - t0) * 1e3
        pipeline.restore(extra["pipeline"])
        step0 = extra["step"]
        print(f"[train] resumed from step {step0} ({load_ms:.1f} ms to restore)", flush=True)

    train_step = make_train_step(model, opt_cfg, args.n_micro)
    monitor = StragglerMonitor()
    losses, norms, seconds = [], [], []

    for step in range(step0, args.steps):
        t0 = time.time()
        batch = pipeline.next()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if args.simulate_failure_at == step:
            print(f"[train] simulated failure at step {step}; restart to resume", flush=True)
            raise SystemExit(42)
        loss = float(metrics["loss"])               # waits for the step
        dt = time.time() - t0
        monitor.record(host=0, step_time=dt)
        telemetry.add_batch({"loss": np.asarray([loss], np.float32)})
        losses.append(loss)
        norms.append(float(metrics["grad_norm"]))
        seconds.append(dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step={step} loss={loss:.4f} gnorm={norms[-1]:.3f} "
                  f"lr={float(metrics['lr']):.2e} dt={dt*1e3:.0f}ms", flush=True)
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state_tree(params, opt_state),
                      {"step": step + 1, "pipeline": pipeline.state()})
    if ckpt is not None:
        t0 = time.perf_counter()
        ckpt.save(args.steps, state_tree(params, opt_state),
                  {"step": args.steps, "pipeline": pipeline.state()})
        ckpt.wait()
        save_ms = (time.perf_counter() - t0) * 1e3
        print(f"[train] checkpoint of step {args.steps} written in {save_ms:.1f} ms", flush=True)

    # AQP over training telemetry (the paper's technique in the loop):
    if "loss" in telemetry.columns and telemetry.columns["loss"].n_seen >= 8:
        lo = float(np.min(telemetry.columns["loss"].sample()))
        hi = float(np.max(telemetry.columns["loss"].sample()))
        frac = telemetry.fraction("loss", lo, (lo + hi) / 2, selector="silverman")
        print(f"[aqp] fraction of steps with loss in lower half-range: {frac:.3f}")
    print("[train] done", flush=True)
    return {"cfg": cfg, "model": model, "params": params, "opt_state": opt_state,
            "losses": losses, "grad_norms": norms, "seconds": seconds, "step0": step0,
            "load_ms": load_ms, "save_ms": save_ms, "stragglers": monitor.stragglers()}


def parser() -> argparse.ArgumentParser:
    from repro_torch.configs.base import ARCH_IDS

    ap = argparse.ArgumentParser(description="Train an LM of the port on the card "
                                             "(or the CPU)")
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, raising without "
                         "one; 'cpu' trains on the CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None) -> None:
    run_train(parser().parse_args(argv))


if __name__ == "__main__":
    main()
