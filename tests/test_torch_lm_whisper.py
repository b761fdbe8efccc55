"""The port's Whisper encoder-decoder (`repro_torch/models/whisper.py`)
against the JAX package's on carried weights: `apply`, `loss`, `prefill`
(logits, self and cross caches), `decode_step` from the reference's own
cache and `greedy_generate`, whisper-base smoke in float32 and bf16
(tolerances in `tests/lm_parity.py`), plus the sinusoidal positions, the
encoder on its own and with chunked (non-causal) attention, and the cross
caches a decode step leaves as they are.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as P
from repro.models import whisper as ref_whisper
from repro_torch import convert
from repro_torch.models import whisper
from repro_torch.train.serve_step import pad_caches

CASES = [("whisper-base", d) for d in P.DTYPES]


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


@pytest.mark.parametrize("shape", [(7,), (2, 5)])
@pytest.mark.parametrize("d_model", [64, 512])
def test_sinusoid_positions_match_reference(shape, d_model):
    """Angles up to 1 500 rad: one float32 ulp of an angle is 1.2e-4 there,
    so sin / cos agree to atol 2.5e-4."""
    pos = np.random.default_rng(0).integers(0, 1500, shape)
    want = ref_whisper.sinusoid_positions(jnp.asarray(pos), d_model)
    got = whisper.sinusoid_positions(torch.tensor(pos), d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2.5e-4)


@pytest.mark.parametrize("q_chunk", [32, 8])
def test_encoder_matches_reference(case, q_chunk):
    """The encoder alone, float32; at q_chunk 8 its 30 frames go through the
    chunked non-causal path (4 chunks over all keys)."""
    c = case("whisper-base", "float32")
    rcfg = dataclasses.replace(c.ref_cfg, q_chunk=q_chunk)
    ref = ref_whisper.EncDecLM(rcfg)
    want = np.asarray(jax.jit(ref.encode)(c.params, c.jbatch["enc_frames"]))
    port = convert.lm_params_from_numpy(dataclasses.replace(c.cfg, q_chunk=q_chunk),
                                        c.np_params, device="cpu")
    with torch.no_grad():
        got = port.encode(c.tbatch["enc_frames"])
    P.assert_close(got.numpy(), want, "float32")


def test_decode_leaves_cross_caches_and_other_slots(case):
    c = case("whisper-base", "float32")
    with torch.no_grad():
        _, cache = c.port.prefill(c.tbatch)
        cache = pad_caches(cache, P.S + 2)
        before = {k: v.clone() for k, v in cache.items()}
        _, after = c.port.decode_step(cache, c.tbatch["tokens"][:, :1], P.S)
    for k in ("ck", "cv"):
        assert torch.equal(after[k], before[k])
        assert after[k].shape[2] == c.cfg.enc_seq
    for k in ("k", "v"):
        assert torch.equal(after[k][:, :, :P.S], before[k][:, :, :P.S])
        assert float(after[k][:, :, P.S + 1].abs().max()) == 0.0
