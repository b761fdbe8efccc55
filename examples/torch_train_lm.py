"""End-to-end training on the PyTorch/CUDA port: a ~135M-parameter dense LM
(or a tiny one) for a few hundred steps, with checkpoints, AQP telemetry
over the losses and tokens/s (the port's copy of `examples/train_lm.py`).

    PYTHONPATH=src python examples/torch_train_lm.py [--device cuda]
        [--steps 300] [--batch 8] [--seq 256] [--tiny] [--ckpt-dir DIR]

--tiny shrinks the model (2 layers x 128, vocab 1 024); the default is a
llama-style config of 12 layers x 768, vocab 32 768.  It runs on the CUDA
device (the default; it raises without one); `--device cpu` runs it on the
CPU.  Checkpoints go to `--ckpt-dir` (default: a temporary directory,
removed at the end), every 100 steps and at the end.
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data.aqp_store import TelemetryStore  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.device import resolve_device, synchronize  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import make_train_step, train_params  # noqa: E402
from repro_torch.train.train_step import state_tree  # noqa: E402


def config(tiny: bool) -> ModelConfig:
    if tiny:
        return ModelConfig(name="demo-tiny", family="dense", n_layers=2,
                           d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                           vocab_size=1024, q_chunk=64)
    # ~100M params: 12 x (4*768^2 + 3*768*2048) + 2*32768*768 ~ 135M
    return ModelConfig(name="demo-100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                       vocab_size=32768, q_chunk=128)


def train(args, ckpt_dir: str) -> None:
    device = resolve_device(args.device)
    cfg = config(args.tiny)
    model = build_model(cfg, device, torch.Generator(device=device).manual_seed(0))
    params = train_params(model)
    print(f"[example] {cfg.name}: {sum(p.numel() for p in params.values()) / 1e6:.1f}M "
          f"params on {device}")
    opt_state = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(lr=6e-4, warmup_steps=20,
                                total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg)
    telemetry = TelemetryStore(device=device)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, telemetry=telemetry,
                         device=device)
    ckpt = CheckpointManager(ckpt_dir, keep=2)

    synchronize(device)
    t0 = time.time()
    for step in range(args.steps):
        params, opt_state, m = step_fn(params, opt_state, pipe.next())
        loss = float(m["loss"])
        telemetry.add_batch({"loss": np.asarray([loss], np.float32)})
        if step % 20 == 0 or step == args.steps - 1:
            toks = args.batch * args.seq * (step + 1)
            print(f"step {step:4d}  loss {loss:.4f}  lr {float(m['lr']):.2e}  "
                  f"{toks / (time.time() - t0):,.0f} tok/s")
        if (step + 1) % 100 == 0 or step == args.steps - 1:
            ckpt.save(step + 1, state_tree(params, opt_state),
                      {"step": step + 1, "pipeline": pipe.state()})
    ckpt.wait()

    # AQP over the training history (the paper's technique, in the loop)
    losses = telemetry.columns["loss"]
    lo, hi = losses.sample().min(), losses.sample().max()
    mid = (lo + hi) / 2
    print(f"[aqp] P(loss <= {mid:.2f}) ~ "
          f"{telemetry.fraction('loss', float(lo) - 1, float(mid), selector='silverman'):.3f} "
          f"over {losses.n_seen} recorded steps; checkpoints at {ckpt.all_steps()}")
    print("[example] done")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        train(args, args.ckpt_dir)
    else:
        with tempfile.TemporaryDirectory(prefix="torch_train_lm_") as d:
            train(args, d)


if __name__ == "__main__":
    main()
