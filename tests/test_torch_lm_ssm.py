"""The port's Mamba-1 LM (`repro_torch/models/ssm.py`, falcon-mamba-7b) and
Zamba2 hybrid (`hybrid.py`) against the JAX package's on carried weights:
`apply`, `loss`, `prefill` (logits, conv tails, SSM states, the shared
block's KV caches), `decode_step` from the reference's own cache and
`greedy_generate`, smoke configs in float32 and bf16 (tolerances in
`tests/lm_parity.py`).  In bf16 the recurrences carry rounding through every
step, and the reference's own bf16 logits stand at or past the tolerance
from its float32 run on the same weights, so bf16 logits and caches are held
to that float32 run: no farther from it than the reference's bf16 outputs
(`lm_parity.FLOAT32_ANCHORED`); decode steps and greedy tokens keep the
reference's tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as P
from repro_torch.train import greedy_generate

ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")
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


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_reference_is_as_far_from_float32(case, arch):
    """Why the bf16 logits are anchored to float32: the reference's own bf16
    logits stand at least 3/4 of the bf16 atol from its float32 run on the
    same weights (zamba2: past the tolerance)."""
    c = case(arch, "bfloat16")
    err = np.abs(c.ref_apply - c.ref_f32[0])
    assert err.max() >= 0.75 * P.BF16_ATOL
    if arch == "zamba2-1.2b":
        assert (err > P.BF16_ATOL + P.BF16_RTOL * np.abs(c.ref_f32[0])).any()


@pytest.mark.parametrize("window", [4, 64])
def test_hybrid_sliding_window_matches_reference(case, window):
    """zamba2's shared attention with a sliding window (S = 48 over q_chunk
    32: the chunked path with its window start), float32."""
    c = case("zamba2-1.2b", "float32")
    tokens = np.random.default_rng(1).integers(0, 256, (1, 48)).astype(np.int32)
    want = np.asarray(c.ref.apply(c.params, {"tokens": jnp.asarray(tokens)}, window=window))
    with torch.no_grad():
        got = c.port.apply({"tokens": torch.tensor(tokens).long()}, window=window)
        whole = c.port.apply({"tokens": torch.tensor(tokens).long()})
    P.assert_close(got.numpy(), want, "float32", f"window {window}")
    moved = float((got - whole).abs().max())
    assert (moved == 0.0) if window >= 48 else (moved > 1e-4)


def test_hybrid_groups_and_tail(case):
    """zamba2 smoke: 5 SSM layers, attention after every 2 -> 2 groups (one
    KV slot each) and a tail of 1 layer with no attention after it."""
    m = case("zamba2-1.2b", "float32").port
    assert (m.n_groups, m.n_tail) == (2, 1)
    assert list(m._sites()) == [(0, None), (1, 0), (2, None), (3, 1), (4, None)]
    cache = m.init_cache(2, 10)
    assert cache["k"].shape[0] == 2 and cache["conv"].shape[0] == 5


@pytest.mark.parametrize("prompt", [1, 2])
def test_prompt_shorter_than_the_conv_continues_apply(prompt):
    """A prompt shorter than d_conv - 1: the port's conv tail is left-padded
    with the causal conv's zeros, and decoding from it continues the
    teacher-forced forward (float32, tight).  The reference's tail is short
    and its decode fails."""
    c = P.Case("falcon-mamba-7b", "float32", prompt=prompt)
    with torch.no_grad():
        _, cache = c.port.prefill(c.tbatch)
        assert cache["conv"].shape[2] == c.cfg.d_conv - 1
        assert float(cache["conv"][:, :, :c.cfg.d_conv - 1 - prompt].abs().max()) == 0.0
        tokens, logits = greedy_generate(c.port, c.tbatch["tokens"], 4, with_logits=True)
        full = c.port.apply({"tokens": tokens[:, :-1]})
    P.assert_close(logits.numpy(), full[:, -4:].numpy(), "float32")
    _, rcache = c.ref.prefill(c.params, c.jbatch)
    with pytest.raises(ValueError):
        c.ref.decode_step(c.params, rcache, c.jbatch["tokens"][:, :1], jnp.int32(prompt))


def test_bf16_prefill_and_decode_continue_one_function(case):
    """The conv sums in float32 in prefill as the decode step's contraction
    does, so bf16 decode steps continue the teacher-forced forward within
    the reference's tolerance on both SSM families."""
    for arch in ARCHS:
        c = case(arch, "bfloat16")
        with torch.no_grad():
            tokens, logits = greedy_generate(c.port, c.tbatch["tokens"], 6, with_logits=True)
            full = c.port.apply({"tokens": tokens[:, :-1]})
        P.assert_close(logits.float().numpy(), full[:, -6:].float().numpy(), "bfloat16", arch)
