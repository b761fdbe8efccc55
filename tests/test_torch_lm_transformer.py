"""The port's dense and VLM transformers (`repro_torch/models/transformer.py`)
against the JAX package's on carried weights: `apply`, `loss`, `prefill`
(logits and every cache leaf), `decode_step` from the reference's own
cache, and `greedy_generate`'s tokens against the reference's prefill +
decode loop, for stablelm-12b, llama3.2-1b, glm4-9b, qwen2.5-14b and
internvl2-2b smoke configs in float32 and bf16 (tolerances in
`tests/lm_parity.py`).  The MoE family is in test_torch_lm_moe.py.
"""
import numpy as np
import pytest
import torch

import lm_parity as P
from repro_torch.models import layers as L

ARCHS = ("stablelm-12b", "llama3.2-1b", "glm4-9b", "qwen2.5-14b", "internvl2-2b")
CASES = [(a, d) for a in ARCHS for d in P.DTYPES]


@pytest.fixture(scope="module")
def case():
    made = {}

    def get(arch, dtype):
        if (arch, dtype) not in made:
            made[(arch, dtype)] = P.Case(arch, dtype)
        return made[(arch, dtype)]
    return get


@pytest.mark.parametrize("arch,dtype", CASES)
def test_apply_matches_reference(case, arch, dtype):
    P.check_apply(case(arch, dtype))


@pytest.mark.parametrize("arch,dtype", CASES)
def test_loss_matches_reference(case, arch, dtype):
    P.check_loss(case(arch, dtype))


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_matches_reference(case, arch, dtype):
    P.check_prefill(case(arch, dtype))


@pytest.mark.parametrize("arch,dtype", CASES)
def test_decode_step_from_reference_cache(case, arch, dtype):
    P.check_decode_step(case(arch, dtype))


@pytest.mark.parametrize("arch,dtype", CASES)
def test_greedy_generate_matches_reference_loop(case, arch, dtype):
    P.check_greedy(case(arch, dtype))


def test_vlm_prepends_projected_patches_and_loss_skips_them(case):
    """internvl2: the image positions come first (the cache holds
    n_vision + S positions), and the loss is the next-token loss over the
    text positions only."""
    c = case("internvl2-2b", "float32")
    nv = c.cfg.n_vision_tokens
    with torch.no_grad():
        logits, cache = c.port.prefill(c.tbatch)
        loss = c.port.loss(c.tlabels)
    assert logits.shape[1] == nv + P.S and cache["k"].shape[2] == nv + P.S
    want = L.cross_entropy(logits[:, nv:][:, :-1], c.tlabels["labels"][:, 1:])
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    other = dict(c.tbatch, patch_embeds=c.tbatch["patch_embeds"] * 2)
    with torch.no_grad():
        moved = c.port.apply(other)
    assert float((moved - logits).abs().max()) > 1e-3


def test_decode_step_writes_only_its_slot(case):
    c = case("llama3.2-1b", "float32")
    with torch.no_grad():
        _, cache = c.port.prefill(c.tbatch)
        cache = {k: torch.cat([v, torch.zeros_like(v[:, :, :3])], dim=2) for k, v in cache.items()}
        before = {k: v.clone() for k, v in cache.items()}
        _, after = c.port.decode_step(cache, c.tbatch["tokens"][:, :1], P.S)
    assert after is cache
    for k in ("k", "v"):
        np.testing.assert_array_equal(after[k][:, :, :P.S].numpy(), before[k][:, :, :P.S].numpy())
        assert float(after[k][:, :, P.S].abs().max()) > 0
        assert float(after[k][:, :, P.S + 1:].abs().max()) == 0.0
