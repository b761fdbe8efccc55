"""Serving scenario on the PyTorch/CUDA port: batched prefill + greedy
decode with KV caches, for a dense LM, an attention-free SSM (O(1) decode
state) and an encoder-decoder (self + cross caches) side by side (the
port's copy of `examples/serve_lm.py`).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cuda]
        [--batch 4] [--prompt-len 12] [--max-new 12]

Each model is its architecture's smoke config with random weights (seed
0) and random prompts (seed 1).  It runs on the CUDA device (the default;
it raises without one); `--device cpu` runs it on the CPU.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.device import resolve_device, synchronize  # noqa: E402
from repro_torch.models import build_model, random_inputs  # noqa: E402
from repro_torch.train import greedy_generate  # noqa: E402


def demo(arch: str, device, batch: int, prompt_len: int, max_new: int) -> None:
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device, torch.Generator(device=device).manual_seed(0))
    inputs = random_inputs(cfg, batch, prompt_len, torch.Generator(device=device).manual_seed(1))
    prompt = inputs.pop("tokens")     # whisper keeps its encoder frames (the frontend stub)
    synchronize(device)
    t0 = time.perf_counter()
    out = greedy_generate(model, prompt, max_new, extra_batch=inputs)
    synchronize(device)
    dt = time.perf_counter() - t0
    print(f"[{arch:18s}] generated {out.shape[0]}x{out.shape[1]} tokens "
          f"in {dt:.2f}s on {device}; sample: {out[0, prompt_len:].tolist()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=12)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for arch in ("llama3.2-1b",        # dense GQA: growing KV cache
                 "falcon-mamba-7b",    # SSM: constant-size state
                 "whisper-base"):      # enc-dec: self + cross caches
        demo(arch, device, args.batch, args.prompt_len, args.max_new)


if __name__ == "__main__":
    main()
