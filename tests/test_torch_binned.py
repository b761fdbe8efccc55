"""The port's binned / FFT KDE (`repro_torch.core.binned`) against the JAX
reference (`repro.core.binned`), on the CPU, with seeded numpy inputs
handed to both packages; and PLUGIN past the sizes where the reference's
int32 products overflow (`n * n` in its `_psi_r` from n = 46 341,
`n * (n - 1)` in its `variance_estimator` from 46 342), against float64.

Every n of a parity test stays below 46 341, where the reference runs.

Tolerances:
- the grid: its first two points and its last, and so the spacing both
  FFT paths read, bit-equal; every point within one float32 spacing of the
  grid's larger end (XLA's CPU code may contract an interior point's last
  multiply-add into one rounding);
- counts within atol 1e-6 (both add each bin's weights in the same order)
  and summing to n;
- `binned_kde_fft` within rtol 1e-4 of its largest value (float32 FFTs of
  two libraries);
- `binned_psi_r` within rtol 1e-3: the reference's own float32 noise
  against float64 reaches 2.8e-4 for Psi6 at n = 40 000;
- `binned_plugin_bandwidth` within rtol 1e-4, and within 2 % of the port's
  exact PLUGIN, the reference's own bound (`tests/test_plugin.py`);
- the variance and the Psi_r normalisation to rtol 1e-5, and the PLUGIN h
  to 1e-3 of float64, the tolerance `tests/test_plugin.py` holds the
  reference's h to against its sequential oracle.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binned as jb
from repro_torch.core import binned, plugin
from repro_torch.core import gaussian as G

F32 = np.float32
SIZES = [(512, 512), (4096, 1024), (40000, 1024)]


def _bounds(x):
    return F32(x.min() - F32(1e-3)), F32(x.max() + F32(1e-3))


def _both(x, g):
    lo, hi = _bounds(x)
    rg, rc = jb.linear_binning(jnp.asarray(x), jnp.float32(lo), jnp.float32(hi), g)
    tg, tc = binned.linear_binning(x, lo, hi, g, device="cpu")
    return (np.asarray(rg), np.asarray(rc)), (tg, tc)


def _sample(n, seed=0):
    rng = np.random.default_rng(seed + n)
    return (rng.normal(0.0, 1.0, n) * 3.0 + 7.0).astype(F32)


@pytest.mark.parametrize("n,g", SIZES + [(1000, 37), (100, 2)])
def test_grid_ends_and_spacing_bit_equal(n, g):
    x = _sample(n)
    (rg, _), (tg, _) = _both(x, g)
    tg = tg.numpy()
    assert tg.dtype == rg.dtype and tg.shape == rg.shape
    assert tg[0] == rg[0] and tg[1] == rg[1] and tg[-1] == rg[-1]
    assert tg[1] - tg[0] == rg[1] - rg[0]
    np.testing.assert_allclose(tg, rg, rtol=0, atol=np.spacing(np.abs(rg).max()))


@pytest.mark.parametrize("n,g", SIZES)
def test_counts_match_reference_and_sum_to_n(n, g):
    x = _sample(n)
    (_, rc), (_, tc) = _both(x, g)
    np.testing.assert_allclose(tc.numpy(), rc, rtol=0, atol=1e-6)
    assert float(torch.sum(tc.double())) == pytest.approx(n, rel=1e-6)


def test_points_on_bin_edges_fall_into_the_reference_bins():
    """x on the grid points themselves, lo and hi included: each bin
    position is formed in float32 as the reference forms it."""
    g = 64
    lo, hi = F32(-1.3), F32(2.9)
    grid = np.asarray(jnp.linspace(jnp.float32(lo), jnp.float32(hi), g))
    x = np.concatenate([grid, grid[::3], [lo, hi]]).astype(F32)
    rg, rc = jb.linear_binning(jnp.asarray(x), jnp.float32(lo), jnp.float32(hi), g)
    tg, tc = binned.linear_binning(x, lo, hi, g, device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))


@pytest.mark.parametrize("n,g", SIZES)
@pytest.mark.parametrize("h", [0.05, 0.4])
def test_kde_fft_matches_reference(n, g, h):
    x = _sample(n)
    (rg, rc), (tg, tc) = _both(x, g)
    want = np.asarray(jb.binned_kde_fft(jnp.asarray(rg), jnp.asarray(rc), jnp.float32(h)))
    got = binned.binned_kde_fft(tg, tc, h, device="cpu").numpy()
    assert got.shape == (g,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n,g", SIZES)
@pytest.mark.parametrize("r,gbw", [(6, 0.3), (6, 0.9), (4, 0.25), (4, 0.7)])
def test_psi_r_matches_reference(n, g, r, gbw):
    x = _sample(n)
    (rg, rc), (tg, tc) = _both(x, g)
    want = float(jb.binned_psi_r(jnp.asarray(rg), jnp.asarray(rc), jnp.float32(gbw), r))
    got = float(binned.binned_psi_r(tg, tc, gbw, r, device="cpu"))
    assert got == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("n", [512, 4096, 40000])
def test_binned_plugin_matches_reference(n):
    x = _sample(n)
    want = float(jb.binned_plugin_bandwidth(jnp.asarray(x)))
    got = binned.binned_plugin_bandwidth(x, device="cpu")
    assert got.shape == () and got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("n", [512, 4096])
def test_binned_plugin_within_two_percent_of_exact(n):
    x = _sample(n, seed=5)
    exact = float(plugin.plugin_bandwidth(x, device="cpu").h)
    assert abs(float(binned.binned_plugin_bandwidth(x, device="cpu")) - exact) / exact < 0.02


def test_binned_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        binned.binned_plugin_bandwidth(_sample(64))


# --- PLUGIN past the reference's int32 n (n - 1) and n * n ----------------------------

def _variance64(x: np.ndarray) -> float:
    return float(np.var(x.astype(np.float64), ddof=1))


@pytest.mark.parametrize("n", [46_340, 46_341, 46_342, 200_000])
def test_variance_estimator_past_int32_matches_float64(n):
    x = _sample(n, seed=11)
    got = float(plugin.variance_estimator(torch.as_tensor(x)))
    assert got == pytest.approx(_variance64(x), rel=1e-5)


@pytest.mark.parametrize("n", [46_340, 46_341, 1_000_000])
@pytest.mark.parametrize("r,k0", [(6, G.K6_AT_0), (4, G.K4_AT_0)])
def test_psi_r_normalisation_past_int32_matches_float64(n, r, k0):
    """(2 S + n K(0)) / (n^2 g^(r+1)) with n^2 beyond int32."""
    pair_sum, g = 1.25e7, 0.3
    got = float(plugin._psi_r(torch.tensor(pair_sum), k0, n, torch.tensor(g), r))
    want = (2 * pair_sum + n * k0) / (float(n) ** 2 * g ** (r + 1))
    assert got == pytest.approx(want, rel=1e-5)


def plugin_h_float64(values: np.ndarray, counts: np.ndarray) -> float:
    """PLUGIN's h (eqs. 12-19) in float64 for a sample that holds each
    `values[a]` `counts[a]` times: each pair sum is sum_a C(c_a, 2) K(0) +
    sum_{a<b} c_a c_b K((v_a - v_b)/g), O(distinct values^2)."""
    v = values.astype(np.float64)
    c = counts.astype(np.float64)
    n = c.sum()
    mean = (c * v).sum() / n
    sigma = math.sqrt((c * (v - mean) ** 2).sum() / (n - 1))
    d = v[:, None] - v[None, :]
    ab = np.triu(c[:, None] * c[None, :], 1)
    same = (c * (c - 1) / 2).sum()

    def pair_sum(fun, g):
        return same * fun(0.0) + (ab * fun(d / g)).sum()

    def k6(t):
        t2 = t * t
        return (((t2 - 15) * t2 + 45) * t2 - 15) * np.exp(-0.5 * t2) / math.sqrt(2 * math.pi)

    def k4(t):
        t2 = t * t
        return ((t2 - 6) * t2 + 3) * np.exp(-0.5 * t2) / math.sqrt(2 * math.pi)

    psi8 = 105.0 / (32.0 * math.sqrt(math.pi) * sigma ** 9)
    g1 = (-2.0 * G.K6_AT_0 / (psi8 * n)) ** (1 / 9)
    psi6 = (2 * pair_sum(k6, g1) + n * G.K6_AT_0) / (n * n * g1 ** 7)
    g2 = (-2.0 * G.K4_AT_0 / (psi6 * n)) ** (1 / 7)
    psi4 = (2 * pair_sum(k4, g2) + n * G.K4_AT_0) / (n * n * g2 ** 5)
    return (G.R_K_1D / (psi4 * n)) ** 0.2


def _rounded_sample(n: int) -> np.ndarray:
    """n normals rounded to 0.01: a few hundred distinct values, so the
    float64 oracle stays cheap at any n."""
    return np.round(_sample(n, seed=13) / 3.0, 2).astype(F32)


def test_float64_plugin_oracle_agrees_with_the_sequential_one():
    x = _rounded_sample(300)
    values, counts = np.unique(x, return_counts=True)
    assert plugin_h_float64(values, counts) == pytest.approx(
        plugin.plugin_bandwidth_sequential(x), rel=1e-3)


@pytest.fixture()
def cuda_device():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pairwise kernel runs only on the card)")
    return torch.device("cuda")


def test_cuda_plugin_past_int32_matches_float64(cuda_device):
    """n = 46 341 on the pairwise kernel (the plain path takes about a
    minute on the CPU at this n)."""
    x = _rounded_sample(46_341)
    values, counts = np.unique(x, return_counts=True)
    got = float(plugin.plugin_bandwidth(x, device=cuda_device).h)
    assert got == pytest.approx(plugin_h_float64(values, counts), rel=1e-3)
