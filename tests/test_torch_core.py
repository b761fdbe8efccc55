"""The port's core math against the JAX reference, on the CPU: Gaussian
kernels and the LSCV constants, reductions (pairwise and quadratic-form),
PLUGIN, silverman, the closed-form AQP passes, the CI moments and
quantiles, and KDE synopses.  Inputs are seeded numpy arrays handed to both
packages.  The LSCV selectors themselves are in `tests/test_torch_lscv.py`.

Tolerances: rtol 1e-6 where both sides evaluate the same float32 expression
elementwise; rtol 3e-4 for PLUGIN's fields (its pairwise sums are the
`tests/test_kernels.py` pairwise case, float32 sums in another order);
rtol 1e-4 (atol 1e-5 on counts, 1e-4 on sums) for the AQP sums, as in
`tests/test_kernels.py`; rtol 1e-3 / atol 1e-3 for the stored S matrix and
5e-4 / 1e-4 for the fused quadratic-form sum, `tests/test_kernels.py`'s
sv_matrix and gh_fused tolerances; 1e-3 relative between a PLUGIN h and the paper's
sequential float32 loops, as in `tests/test_plugin.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aqp as jaqp
from repro.core import aqp_ci as jci
from repro.core import aqp_multid as jmd
from repro.core import gaussian as jG
from repro.core import kde as jkde
from repro.core import plugin as jplugin
from repro.core import reductions as jred
from repro_torch.core import aqp, aqp_ci, aqp_multid, gaussian, kde, plugin, reductions


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --- gaussian ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["INV_SQRT_2PI", "K4_AT_0", "K6_AT_0", "R_K_1D", "MU2_K"])
def test_gaussian_constants_equal_reference(name):
    assert getattr(gaussian, name) == getattr(jG, name)


@pytest.mark.parametrize("fn", ["phi", "k4", "k6"])
def test_gaussian_kernels_match_reference(rng, fn):
    x = rng.normal(0, 3, 1000).astype(np.float32)
    np.testing.assert_allclose(_np(getattr(gaussian, fn)(_t(x))),
                               np.asarray(getattr(jG, fn)(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fn", ["lscv_h_consts", "lscv_H_consts"])
@pytest.mark.parametrize("d", [1, 3])
def test_lscv_constants_match_reference(fn, d):
    got = getattr(gaussian, fn)(d, torch.tensor(0.37))
    want = getattr(jG, fn)(d, jnp.float32(0.37))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# --- reductions ---------------------------------------------------------------------

@pytest.mark.parametrize("n,d,chunk", [(1, 2, 128), (130, 3, 64), (257, 1, 128)])
def test_quadform_reductions_match_reference(rng, n, d, chunk):
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    m0 = rng.normal(0, 1, (d, d))
    m = (0.1 * m0 @ m0.T + np.eye(d)).astype(np.float32)
    np.testing.assert_allclose(
        _np(reductions.pairwise_sv_matrix(_t(x), _t(m), chunk)),
        np.asarray(jred.pairwise_sv_matrix(jnp.asarray(x), jnp.asarray(m), chunk)),
        rtol=1e-3, atol=1e-3)
    got = reductions.pairwise_quadform_reduce(lambda s: torch.exp(-0.5 * s), _t(x),
                                              _t(m), chunk)
    want = jred.pairwise_quadform_reduce(lambda s: jnp.exp(-0.5 * s), jnp.asarray(x),
                                         jnp.asarray(m), chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=5e-4, atol=1e-4)


@pytest.mark.parametrize("n,chunk", [(1, 256), (300, 64), (700, 256)])
def test_pairwise_reduce_matches_reference(rng, n, chunk):
    x = rng.normal(0, 1, n).astype(np.float32)
    got = float(reductions.pairwise_reduce(lambda d: gaussian.k4(d / 0.4), _t(x), chunk))
    want = float(jred.pairwise_reduce(lambda d: jG.k4(d / 0.4), jnp.asarray(x), chunk))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=max(1e-5, 1e-6 * n))


def test_map_reduce_and_sums_match_reference(rng):
    x = rng.normal(1, 2, 5000).astype(np.float32)
    np.testing.assert_allclose(float(reductions.map_reduce(gaussian.phi, _t(x), chunk=999)),
                               float(jred.map_reduce(jG.phi, jnp.asarray(x), chunk=999)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(reductions.reduce_sum(_t(x))),
                               float(jred.reduce_sum(jnp.asarray(x))), rtol=1e-5)
    np.testing.assert_allclose(float(reductions.kahan_sum(_t(x))),
                               float(jred.kahan_sum(jnp.asarray(x))), rtol=1e-6)


# --- PLUGIN ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,loc,scale", [(300, 0.0, 1.0), (700, 5.0, 0.3)])
def test_plugin_fields_match_reference(rng, n, loc, scale):
    x = rng.normal(loc, scale, n).astype(np.float32)
    got = plugin.plugin_bandwidth(x, backend="torch", device="cpu")
    want = jplugin.plugin_bandwidth(jnp.asarray(x), backend="jnp")
    for field in plugin.PluginResult._fields:
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)), rtol=3e-4,
                                   err_msg=field)


def test_plugin_matches_sequential_oracle(rng):
    x = rng.normal(1.0, 2.0, 256).astype(np.float32)
    h = float(plugin.plugin_bandwidth(x, device="cpu").h)
    h_seq = plugin.plugin_bandwidth_sequential(x)
    assert h_seq == jplugin.plugin_bandwidth_sequential(x)
    assert abs(h - h_seq) / h_seq < 1e-3


def test_plugin_kernel_backend_on_cpu_matches_plain(rng):
    x = rng.lognormal(0.0, 0.5, 500).astype(np.float32)
    a = float(plugin.plugin_bandwidth(x, backend="torch", device="cpu").h)
    b = float(plugin.plugin_bandwidth(x, backend="cuda", device="cpu").h)
    assert abs(a - b) / a < 1e-3


def test_plugin_rejects_multivariate_input():
    with pytest.raises(ValueError):
        plugin.plugin_bandwidth(np.zeros((4, 2), np.float32), device="cpu")


def test_entry_points_default_to_cuda_or_raise():
    x = np.linspace(0, 1, 16, dtype=np.float32)
    if torch.cuda.is_available():
        assert plugin.plugin_bandwidth(x).h.device.type == "cuda"
        assert aqp.KDESynopsis.fit(x).x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            plugin.plugin_bandwidth(x)
        with pytest.raises(RuntimeError, match="CUDA"):
            aqp.KDESynopsis.fit(x)


# --- silverman and the 1-D closed forms -----------------------------------------------

def test_silverman_matches_reference(rng):
    x = rng.lognormal(0, 0.7, 999).astype(np.float32)
    np.testing.assert_allclose(float(kde.silverman_h(_t(x))),
                               float(jkde.silverman_h(jnp.asarray(x))), rtol=1e-5)


@pytest.mark.parametrize("a,b", [(-1.0, 1.0), (0.5, 3.0), (2.5, 9.0)])
def test_count_sum_1d_match_reference(rng, a, b):
    x = rng.normal(0, 1.5, 400).astype(np.float32)
    h = np.float32(0.35)
    np.testing.assert_allclose(float(aqp.count_1d(_t(x), _t(h), a, b)),
                               float(jaqp.count_1d(jnp.asarray(x), jnp.float32(h),
                                                   jnp.float32(a), jnp.float32(b))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aqp.sum_1d(_t(x), _t(h), a, b)),
                               float(jaqp.sum_1d(jnp.asarray(x), jnp.float32(h),
                                                 jnp.float32(a), jnp.float32(b))),
                               rtol=1e-5, atol=1e-4)


def _range_batch(rng, n, q):
    x = rng.normal(0, 2, n).astype(np.float32)
    a = rng.uniform(-4, 4, q).astype(np.float32)
    b = (a + rng.uniform(0, 3, q)).astype(np.float32)
    ops = rng.integers(0, 3, q).astype(np.int32)
    return x, np.float32(0.5), a, b, ops


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("q", [1, 70])
def test_batch_query_1d_matches_reference(rng, backend, q):
    x, h, a, b, ops = _range_batch(rng, 333, q)
    got = aqp.batch_query_1d(_t(x), _t(h), _t(a), _t(b), _t(ops, torch.int32), 12.5,
                             backend=backend)
    want = jaqp.batch_query_1d(jnp.asarray(x), jnp.float32(h), jnp.asarray(a),
                               jnp.asarray(b), jnp.asarray(ops), jnp.float32(12.5))
    # atol: scale (12.5) x the AQP kernels' raw-sum atol
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=12.5 * 1e-4)


def _box_batch(rng, n, q, d):
    x = rng.normal(0, 1.5, (n, d)).astype(np.float32)
    h = rng.uniform(0.2, 0.8, d).astype(np.float32)
    lo = rng.uniform(-3, 1, (q, d)).astype(np.float32)
    hi = (lo + rng.uniform(0.2, 3, (q, d))).astype(np.float32)
    tgt = rng.integers(0, d, q).astype(np.int32)
    ops = rng.integers(0, 3, q).astype(np.int32)
    return x, h, lo, hi, tgt, ops


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("q,d", [(1, 1), (3, 2), (130, 3)])
def test_batch_query_box_matches_reference(rng, backend, q, d):
    x, h, lo, hi, tgt, ops = _box_batch(rng, 257, q, d)
    got = aqp_multid.batch_query_box(_t(x), _t(h), _t(lo), _t(hi), _t(tgt, torch.int32),
                                     _t(ops, torch.int32), 3.0, backend=backend)
    want = jmd.batch_query_box(jnp.asarray(x), jnp.asarray(h), jnp.asarray(lo),
                               jnp.asarray(hi), jnp.asarray(tgt), jnp.asarray(ops),
                               jnp.float32(3.0))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=3.0 * 1e-4)


def test_plain_paths_are_tail_stable_against_float64():
    """Far-tail ranges, where 0.5*(erf(zb) - erf(za)) cancels to 0 in float32:
    the engine's plain range and box passes, the single-query closed form
    and the CI moments form the Phi difference from the tail, as the kernels
    do, and hold to a float64 oracle at the AQP kernels' rtol 1e-4."""
    from scipy.special import ndtr

    x = np.linspace(-1.0, 1.0, 200).astype(np.float32)
    a = np.asarray([4.0, 6.0, -7.0], np.float32)
    b = np.asarray([5.0, 9.0, -5.5], np.float32)
    h = np.float32(0.4)
    za = (a[:, None].astype(np.float64) - x[None]) / h
    zb = (b[:, None].astype(np.float64) - x[None]) / h
    want = np.where(za + zb > 0, ndtr(-za) - ndtr(-zb), ndtr(zb) - ndtr(za)).sum(1)
    count = _t(np.zeros(3), torch.int32)
    got = aqp.batch_query_1d(_t(x), _t(h), _t(a), _t(b), count, 1.0, backend="torch")
    np.testing.assert_allclose(_np(got), want, rtol=1e-4)
    np.testing.assert_allclose(_np(aqp_ci.moments_1d(_t(x), _t(h), _t(a), _t(b))[0]),
                               want, rtol=1e-4)
    for i in range(3):
        np.testing.assert_allclose(float(aqp.count_1d(_t(x), _t(h), float(a[i]),
                                                      float(b[i]))), want[i], rtol=1e-4)
    # a second axis whose range covers the whole sample contributes a factor 1
    xb = np.stack([x, np.zeros_like(x)], axis=1)
    hb = np.asarray([h, 0.4], np.float32)
    lo = np.stack([a, np.full(3, -10.0, np.float32)], axis=1)
    hi = np.stack([b, np.full(3, 10.0, np.float32)], axis=1)
    tgt = _t(np.zeros(3), torch.int32)
    got = aqp_multid.batch_query_box(_t(xb), _t(hb), _t(lo), _t(hi), tgt, count, 1.0,
                                     backend="torch")
    np.testing.assert_allclose(_np(got), want, rtol=1e-4)
    np.testing.assert_allclose(
        _np(aqp_ci.moments_box(_t(xb), _t(hb), _t(lo), _t(hi), tgt)[0]), want, rtol=1e-4)


# --- confidence intervals ---------------------------------------------------------------

@pytest.mark.parametrize("p", [1e-6, 0.01, 0.025, 0.5, 0.9, 0.975, 0.999999])
def test_quantiles_equal_reference(p):
    assert aqp_ci.norm_ppf(p) == jci.norm_ppf(p)
    for dof in (1, 4, 30):
        assert aqp_ci.t_ppf(p, dof) == jci.t_ppf(p, dof)


def test_moments_and_se_match_reference(rng):
    x, h, a, b, ops = _range_batch(rng, 300, 70)
    got = aqp_ci.moments_1d(_t(x), _t(h), _t(a), _t(b))
    want = jci.moments_1d(jnp.asarray(x), jnp.float32(h), jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(aqp_ci.se_from_moments(ops, got, 7.0, 300),
                               jci.se_from_moments(ops, want, 7.0, 300),
                               rtol=1e-3, atol=1e-3)
    xb, hb, lo, hi, tgt, opsb = _box_batch(rng, 200, 70, 3)
    got = aqp_ci.moments_box(_t(xb), _t(hb), _t(lo), _t(hi), _t(tgt, torch.int32))
    want = jci.moments_box(jnp.asarray(xb), jnp.asarray(hb), jnp.asarray(lo),
                           jnp.asarray(hi), jnp.asarray(tgt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(aqp_ci.se_from_moments(opsb, got, 2.0, 200),
                               jci.se_from_moments(opsb, want, 2.0, 200),
                               rtol=1e-3, atol=1e-3)


# --- KDE synopses ---------------------------------------------------------------------

@pytest.mark.parametrize("selector", ["plugin", "silverman"])
@pytest.mark.parametrize("d", [1, 3])
def test_synopsis_fit_and_queries_match_reference(rng, selector, d):
    n = 400                          # <= max_sample: no subsampling on either side
    data = rng.normal(1.0, 1.5, (n, d)).astype(np.float32)
    if d == 1:
        data = data[:, 0]
    got = aqp.KDESynopsis.fit(data, selector=selector, max_sample=512, device="cpu")
    want = jaqp.KDESynopsis.fit(jnp.asarray(data), selector=selector, max_sample=512)
    np.testing.assert_array_equal(_np(got.x), np.asarray(want.x))
    np.testing.assert_allclose(_np(got.h), np.asarray(want.h), rtol=3e-4)
    assert got.n_source == want.n_source and got._scale() == want._scale()
    lo, hi = [0.0] * d, [2.0] * d
    if d == 1:
        for fn in ("count", "sum", "avg"):
            np.testing.assert_allclose(float(getattr(got, fn)(0.0, 2.0)),
                                       float(getattr(want, fn)(0.0, 2.0)), rtol=1e-3)
    np.testing.assert_allclose(float(got.count_box(lo, hi)),
                               float(want.count_box(lo, hi)), rtol=1e-3)
    np.testing.assert_allclose(float(got.sum_box(lo, hi, d - 1)),
                               float(want.sum_box(lo, hi, d - 1)), rtol=1e-3)


@pytest.mark.parametrize("selector", ["lscv_h", "lscv_H"])
def test_lscv_selectors_wait_for_their_slice(rng, selector):
    """Both LSCV selectors fit (their slice, ROADMAP queue 1.9, is ported),
    and an LSCV_H synopsis answers its boxes by quasi-MC (the full-H slice,
    queue 1.10), as the reference does under the same H."""
    data = rng.normal(0.0, 1.0, (60, 2)).astype(np.float32)
    syn = aqp.KDESynopsis.fit(data, selector=selector, device="cpu")
    lo, hi = [-1.0, -1.0], [1.0, 1.0]
    if selector == "lscv_h":
        assert syn.H is None and syn.h.shape == ()
        assert 0.0 < float(syn.count_box(lo, hi)) < 60.0
    else:
        assert syn.h is None and syn.H.shape == (2, 2)
        H = jnp.asarray(syn.H.numpy())
        box = (jnp.asarray(data), H, jnp.asarray(lo, jnp.float32),
               jnp.asarray(hi, jnp.float32))
        np.testing.assert_allclose(float(syn.count_box(lo, hi)),
                                   float(jaqp.count_box_H(*box)), rtol=1e-4)
        np.testing.assert_allclose(float(syn.sum_box(lo, hi, 1)),
                                   float(jaqp.sum_box_H(*box, target=1)), rtol=1e-4)


@pytest.mark.parametrize("sel,canon", [("Plugin", "plugin"), ("LSCV_H", "lscv_H"),
                                       ("lscv_h", "lscv_h"), ("SILVERMAN", "silverman")])
def test_canonical_selector_matches_reference(sel, canon):
    assert aqp.canonical_selector(sel) == jaqp.canonical_selector(sel) == canon
