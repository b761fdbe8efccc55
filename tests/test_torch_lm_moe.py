"""The port's MoE transformers (`repro_torch/models/transformer.py` with
`moe.py`) against the JAX package's on carried weights: `apply`, `loss`,
`prefill`, `decode_step` from the reference's own cache and
`greedy_generate`, for the qwen3-moe-235b-a22b and granite-moe-1b-a400m
smoke configs in float32 and bf16 (tolerances in `tests/lm_parity.py`).

In bf16 the two packages may route a token to other experts: their hidden
states differ by bf16 rounding, so a near-tie of the router can fall either
way (the reference's own bf16 run flips such tokens against its float32
run too), and a flip moves other tokens' capacity drops.  Both packages'
routing is recorded (the reference's from inside its jitted scan), and bf16
outputs are compared where no routing difference reaches
(`lm_parity.routed_alike`); every top-k difference must sit at a near-tie
of the port's router.  float32 routes alike and compares whole.
"""
import numpy as np
import pytest
import torch

import lm_parity as P

ARCHS = ("qwen3-moe-235b-a22b", "granite-moe-1b-a400m")
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
def test_bf16_routes_alike_on_most_tokens(case, arch):
    """Both packages route most of the batch alike in bf16, and exactly
    alike in float32."""
    for dtype, share in (("bfloat16", 0.5), ("float32", 1.0)):
        c = case(arch, dtype)
        c.moe16 = True                       # record the float32 routes too
        try:
            with torch.no_grad(), P.port_routes(c) as mine:
                c.port.apply(c.tbatch)
            with P.ref_routes(c) as theirs:
                P.jax.jit(c.ref.apply)(c.params, c.jbatch)
        finally:
            c.moe16 = dtype == "bfloat16"
        assert len(mine) == len(theirs) == c.cfg.n_layers
        assert P.routed_alike(c, mine, theirs, P.B, P.S).mean() >= share


def test_capacity_rule_matches_the_port(case):
    """`lm_parity.kept`, the drop rule the comparison applies to both
    packages' routes, is the port's: at cf 0.3 the tokens it drops are the
    ones whose MoE output loses an expert."""
    import dataclasses

    from repro_torch.models import moe
    c = case("granite-moe-1b-a400m", "float32")
    cfg = dataclasses.replace(c.cfg, capacity_factor=0.3)
    p = c.port.layers[0]["moe"]
    x = torch.randn(P.B, P.S, cfg.d_model, generator=torch.Generator().manual_seed(0))
    probs = torch.softmax(x.reshape(-1, cfg.d_model) @ p["router"]["w"], -1)
    ids = torch.sort(torch.topk(probs, cfg.top_k, -1).indices, -1).values
    keep = P.kept(ids.reshape(P.B, P.S, -1).numpy(), cfg)
    assert not keep.all()
    out = moe.moe_block(p, x, cfg)
    full = moe.moe_block(p, x, dataclasses.replace(cfg, capacity_factor=4.0))
    changed = ((out - full).abs().amax(-1) > 0).numpy()
    np.testing.assert_array_equal(changed, ~keep.all(axis=-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_repeats_its_bits(case, arch):
    c = case(arch, "bfloat16")
    runs = []
    for _ in range(2):
        cache = P.convert.lm_cache_from_numpy(c.cfg, c.ref_generate["padded_cache"], "cpu")
        with torch.no_grad():
            runs.append(c.port.decode_step(cache, c.tbatch["tokens"][:, :1], P.S)[0])
    np.testing.assert_array_equal(runs[0].float().numpy(), runs[1].float().numpy())
