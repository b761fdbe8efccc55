"""LM serving on the port (`repro_torch/train/serve_step.py`,
`repro_torch.launch.serve --mode lm`): greedy generation against the
reference's own `greedy_generate` where that is sound, the reference's
padding by shape coincidence (ROADMAP queue 3 item 9) against the port's
padding by name, decode continuing the teacher-forced forward on all ten
smoke configs, and the serve CLI's LM mode on the CPU.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as P
from repro.configs.base import ARCH_IDS
from repro.train import greedy_generate as ref_greedy_generate
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model, random_inputs
from repro_torch.train import greedy_generate, make_decode_step

ROOT = Path(__file__).resolve().parents[1]


def ref_pad_by_shape(cache, S0, max_len):
    """The reference's padding rule, as `greedy_generate` writes it
    (`src/repro/train/serve_step.py:24-30`): every leaf whose axis 2 is S0."""
    return jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0)] * 2 + [(0, max_len - a.shape[2])] + [(0, 0)] * (a.ndim - 3))
        if a.ndim >= 3 and a.shape[2] == S0 else a, cache)


# --- the reference's padding by shape coincidence -----------------------------------

@pytest.mark.parametrize("arch,prompt,error", [("zamba2-1.2b", 4, TypeError),
                                               ("falcon-mamba-7b", 3, ValueError)])
def test_reference_greedy_pads_by_shape_coincidence(arch, prompt, error):
    """zamba2 with a prompt of 4 (= ssm_heads: its SSM state gets padded)
    and falcon-mamba with 3 (= d_conv - 1: its conv tail gets padded): the
    reference's greedy_generate raises.  The port answers at those lengths,
    with the tokens of the reference's own prefill + decode loop whose
    caches are padded by name."""
    c = P.Case(arch, "float32", prompt=prompt)
    with pytest.raises(error):
        ref_greedy_generate(c.ref, c.params, c.jbatch["tokens"], P.NEW)
    P.check_greedy(c)


def test_reference_greedy_pads_whisper_cross_caches():
    """whisper with a prompt of 30 (= enc_seq): the reference's rule pads
    the cross-attention caches ck / cv with zero keys, and its first decode
    step's logits move against padding k / v alone; the port pads by name
    and generates the by-name loop's tokens."""
    c = P.Case("whisper-base", "float32", prompt=30)
    logits, cache = c.ref.prefill(c.params, c.jbatch)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    by_shape = ref_pad_by_shape(cache, 30, 30 + P.NEW)
    assert by_shape["ck"].shape[2] == 30 + P.NEW
    by_name = P.pad_by_name(cache, 30 + P.NEW)
    assert by_name["ck"].shape[2] == 30
    moved = c.ref.decode_step(c.params, by_shape, tok, jnp.int32(30))[0]
    right = c.ref.decode_step(c.params, by_name, tok, jnp.int32(30))[0]
    assert float(jnp.abs(moved - right).max()) > 1e-3
    P.check_greedy(c)


def test_reference_greedy_decodes_a_vlm_inside_its_image_prefix():
    """internvl2: the prefill's caches hold n_vision + S0 positions, so the
    reference's rule pads nothing and decodes at S0 + i, over slots of the
    image prefix: its tokens leave the by-name loop's (which decodes from
    n_vision + S0 on).  The port generates the by-name loop's tokens."""
    c = P.Case("internvl2-2b", "float32")
    extra = {"patch_embeds": c.jbatch["patch_embeds"]}
    got = np.asarray(ref_greedy_generate(c.ref, c.params, c.jbatch["tokens"], P.NEW,
                                         extra_batch=extra))[:, P.S:]
    assert c.ref_generate["start"] == c.cfg.n_vision_tokens + P.S
    assert not np.array_equal(got, c.ref_generate["tokens"])
    P.check_greedy(c)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "internvl2-2b"])
def test_greedy_generate_equals_the_reference_function(arch):
    """Where the reference's greedy_generate is sound (no shape coincidence
    at S0 = 16, no image prefix), the port's tokens equal it, float32."""
    c = P.Case(arch, "float32")
    extra = {k: v for k, v in c.jbatch.items() if k != "tokens"}
    want = np.asarray(ref_greedy_generate(c.ref, c.params, c.jbatch["tokens"], P.NEW,
                                          extra_batch=extra or None))
    textra = {k: v for k, v in c.tbatch.items() if k != "tokens"}
    got = greedy_generate(c.port, c.tbatch["tokens"], P.NEW, extra_batch=textra)
    np.testing.assert_array_equal(got.numpy(), want)


# --- decode continues the teacher-forced forward ----------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode_continues_apply(arch):
    """The reference's own consistency test (`tests/test_models.py`), on the
    port and on every smoke config: the logits of the prefill's last
    position and of each decode step equal the teacher-forced `apply` at
    those positions, bf16 at rtol 5e-2 / atol 6e-2.  A MoE model runs with
    capacity_factor E / k, where no assignment is dropped: a 2-token decode
    step drops what a 32-token forward keeps."""
    cfg = get_config(arch, smoke=True)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
    inputs = random_inputs(cfg, P.B, P.S, torch.Generator().manual_seed(3))
    prompt = inputs.pop("tokens")
    with torch.no_grad():
        tokens, logits = greedy_generate(model, prompt, 6, extra_batch=inputs, with_logits=True)
        full = model.apply({"tokens": tokens[:, :-1], **inputs})
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())
    P.assert_close(logits.float().numpy(), full[:, -6:].float().numpy(), "bfloat16", arch)


def test_make_decode_step_is_the_model_step():
    cfg = get_config("llama3.2-1b", smoke=True)
    model = build_model(cfg, "cpu")
    inputs = random_inputs(cfg, 2, 5, torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, cache = model.prefill(inputs)
        cache = {k: torch.cat([v, torch.zeros_like(v[:, :, :1])], 2) for k, v in cache.items()}
        twin = {k: v.clone() for k, v in cache.items()}
        a = make_decode_step(model)(cache, inputs["tokens"][:, :1], 5)[0]
        b = model.decode_step(twin, inputs["tokens"][:, :1], 5)[0]
    assert torch.equal(a, b)


# --- serve --mode lm --------------------------------------------------------------

def test_run_lm_on_the_cpu_repeats_its_tokens():
    args = argparse.Namespace(device="cpu", arch="whisper-base", smoke=True, batch=2,
                              prompt_len=5, max_new=3)
    out = tserve.run_lm(args)
    first, second = out["runs"]
    assert torch.equal(first["tokens"], second["tokens"])
    assert torch.equal(first["logits"], second["logits"])
    assert tuple(second["tokens"].shape) == (2, 8) and second["logits"].shape[1] == 3
    assert out["tokens_per_s"] > 0 and out["card"] is None and out["device"] == "cpu"
    assert sorted(out["extra"]) == ["enc_frames"]


def _serve(*extra, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
                           "--smoke", "--prompt-len", "8", "--max-new", "4", *extra],
                          cwd=str(ROOT), env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_serve_lm_on_the_cpu_exits_zero_and_repeats():
    runs = [_serve("--device", "cpu", "--arch", "falcon-mamba-7b") for _ in range(2)]
    for out in runs:
        assert out.returncode == 0, out.stdout + out.stderr
        assert "[serve:lm] falcon-mamba-7b-smoke (ssm, 2 layers" in out.stdout
        assert "new tokens/s warm" in out.stdout
    sample = [next(ln for ln in r.stdout.splitlines() if "sample:" in ln) for r in runs]
    assert sample[0] == sample[1]


def test_serve_lm_without_a_card_and_without_device_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: serve runs on it by default")
    out = _serve()
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_serve_lm_refuses_empty_sizes():
    with pytest.raises(SystemExit):
        tserve.main(["--mode", "lm", "--device", "cpu", "--smoke", "--max-new", "0"])
