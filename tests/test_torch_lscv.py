"""The port's LSCV selectors against the JAX reference, on the CPU: the
covariance and start points, the h grid, LSCV_h on both `store_s` branches
and on the kernel backend (whose wrappers take the plain versions on the
CPU), the float64 oracle, g(H), Nelder-Mead, LSCV_H and `KDESynopsis.fit`
with either selector.  Inputs are seeded numpy arrays handed to both
packages.

Tolerances:
- rtol 1e-5 for the covariance, H_start and the log-Cholesky maps (float32
  (d, d) algebra through another LAPACK); the h grid is bit-equal.
- rtol 3e-4 on LSCV_h's g values, the tolerance `tests/test_lscv.py` holds
  the reference's own three paths to (float32 sums in another order), with
  atol 3e-4 x max |g|: g crosses zero on the grid, and there the error of a
  float32 sum scales with the terms summed, not with the result.  The
  chosen h is equal where the best g beats the second best by more than
  that; otherwise the port's h must reach the reference's minimum within it
  (an argmin on a flat objective may move one grid step).
- rel 2e-3 against the float64 oracle `g_of_h_sequential`, as in
  `tests/test_lscv.py`.
- rtol 5e-4 on g(H), `tests/test_kernels.py`'s gh_fused tolerance.
- Nelder-Mead on deterministic 2-D functions: x, it and nfev equal; the
  value at x to 1e-3 relative (XLA may fuse the function's multiply-adds).
  In more dimensions the centroid's mean may round otherwise under XLA, so
  only LSCV_H's objective is compared there.
- LSCV_H by its objective: the float64 g of the port's H and of the
  reference's H agree to 1e-2 relative (float32 Nelder-Mead trajectories
  part once one comparison flips, and neither run has converged at the
  iteration cap), H is SPD and g(H) <= g(H_start).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aqp as jaqp
from repro.core import lscv as jl
from repro.core import nelder_mead as jnm
from repro_torch.core import aqp, lscv, nelder_mead

G_RTOL = 3e-4


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _g64_of_H(x, H) -> float:
    """eq. (32) in float64 numpy (the oracle of `tests/test_lscv.py`)."""
    x = np.asarray(x, np.float64)
    H = np.asarray(H, np.float64)
    n, d = x.shape
    det = np.linalg.det(H)
    inv = np.linalg.inv(H)
    v = x[:, None, :] - x[None, :, :]
    s = np.einsum("ijd,de,ije->ij", v, inv, v)
    iu = np.triu_indices(n, 1)
    c_k = (2 * math.pi) ** (-d / 2) * det ** -0.5
    c_kk = (4 * math.pi) ** (-d / 2) * det ** -0.5
    acc = np.sum(c_kk * np.exp(-0.25 * s[iu]) - 2.0 * c_k * np.exp(-0.5 * s[iu]))
    return float(2.0 / (n * n) * acc + c_kk / n)


def _assert_same_argmin(got, want):
    """Equal h where the reference's minimum is clear of its runner-up by
    more than G_RTOL; else the port's h reaches the minimum within it."""
    g_ref = np.asarray(want.g_values, np.float64)
    order = np.argsort(g_ref)
    gap = g_ref[order[1]] - g_ref[order[0]]
    if gap > G_RTOL * abs(g_ref[order[0]]):
        assert float(got.h) == pytest.approx(float(want.h), rel=1e-6)
    else:
        best = int(np.argmin(_np(got.g_values)))
        assert g_ref[best] <= g_ref[order[0]] + G_RTOL * abs(g_ref[order[0]])


# --- covariance, starts and the grid ----------------------------------------------

def test_covariance_and_h_start_match_reference(rng):
    x = rng.normal(0.0, 2.0, (500, 3)).astype(np.float32)
    x[:, 2] += 0.5 * x[:, 0]
    np.testing.assert_allclose(_np(lscv.covariance(torch.as_tensor(x))),
                               np.asarray(jl.covariance(jnp.asarray(x))), rtol=1e-5)
    np.testing.assert_allclose(_np(lscv.h_start(torch.as_tensor(x))),
                               np.asarray(jl.h_start(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("n,d", [(10, 1), (1000, 2), (32768, 3)])
def test_h0_start_equals_reference(n, d):
    assert lscv.h0_start(n, d) == jl.h0_start(n, d)


@pytest.mark.parametrize("n,d,n_h", [(40, 1, 20), (220, 2, 7), (256, 3, 150)])
def test_h_grid_is_bit_equal_to_the_reference_fit(rng, n, d, n_h):
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    want = np.asarray(jl.lscv_h(jnp.asarray(x), n_h=n_h).h_grid)
    np.testing.assert_array_equal(_np(lscv.h_grid_for(n, d, n_h, device="cpu")), want)


def test_log_cholesky_maps_match_reference():
    H = np.array([[0.5, 0.1, 0.02], [0.1, 0.3, -0.05], [0.02, -0.05, 0.2]], np.float32)
    theta = lscv._H_to_theta(torch.as_tensor(H))
    np.testing.assert_allclose(_np(theta), np.asarray(jl._H_to_theta(jnp.asarray(H))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(lscv._theta_to_H(theta, 3)), H, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        _np(lscv._theta_to_H(theta, 3)),
        np.asarray(jl._theta_to_H(jnp.asarray(_np(theta)), 3)), rtol=1e-6, atol=1e-8)


def test_matrix_sqrt_ignores_eigenvector_signs():
    a = np.array([[2.0, 0.3], [0.3, 1.0]], np.float32)
    r = _np(lscv.matrix_sqrt(torch.as_tensor(a)))
    np.testing.assert_allclose(r @ r, a, rtol=1e-5)
    np.testing.assert_allclose(r, np.asarray(jl.matrix_sqrt(jnp.asarray(a))), rtol=1e-5)


# --- LSCV_h ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["store_s", "streaming", "kernel_backend"])
@pytest.mark.parametrize("n,d,n_h", [(220, 2, 20), (300, 1, 150), (150, 3, 40)])
def test_lscv_h_matches_reference(rng, path, n, d, n_h):
    x = rng.normal(0.0, 2.0, (n, d)).astype(np.float32)
    want = jl.lscv_h(jnp.asarray(x), n_h=n_h)
    kw = {"store_s": dict(store_s=True), "streaming": dict(store_s=False),
          "kernel_backend": dict(backend="cuda")}[path]
    got = lscv.lscv_h(x, n_h=n_h, device="cpu", **kw)
    np.testing.assert_array_equal(_np(got.h_grid), np.asarray(want.h_grid))
    g_ref = np.asarray(want.g_values)
    np.testing.assert_allclose(_np(got.g_values), g_ref, rtol=G_RTOL,
                               atol=G_RTOL * np.max(np.abs(g_ref)))
    np.testing.assert_allclose(_np(got.sigma), np.asarray(want.sigma), rtol=1e-5)
    np.testing.assert_allclose(float(got.det_sigma), float(want.det_sigma), rtol=1e-5)
    assert float(got.h0) == float(want.h0)
    _assert_same_argmin(got, want)


def test_lscv_h_matches_float64_oracle(rng):
    x = rng.normal(0.0, 1.0, (150, 3)).astype(np.float32)
    for kw in (dict(store_s=True), dict(store_s=False), dict(backend="cuda")):
        res = lscv.lscv_h(x, n_h=7, device="cpu", **kw)
        for i in (0, 3, 6):
            oracle = lscv.g_of_h_sequential(x, float(res.h_grid[i]))
            assert float(res.g_values[i]) == pytest.approx(oracle, rel=2e-3)


def test_g_of_h_sequential_is_the_reference_oracle(rng):
    x = rng.normal(0.0, 1.0, (40, 2)).astype(np.float32)
    assert lscv.g_of_h_sequential(x, 0.4) == jl.g_of_h_sequential(x, 0.4)


def test_lscv_h_one_dimensional_input_and_interior_optimum(rng):
    x = rng.normal(0.0, 1.0, 400).astype(np.float32)
    res = lscv.lscv_h(x, device="cpu")
    assert res.g_values.shape == (lscv.N_H_DEFAULT,)
    assert float(res.h_grid[0]) < float(res.h) < float(res.h_grid[-1])


# --- LSCV_H ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("n,d", [(120, 2), (77, 3)])
def test_g_of_H_matches_reference(rng, backend, n, d):
    x = rng.normal(0.0, 1.0, (n, d)).astype(np.float32)
    m0 = rng.normal(0, 1, (d, d))
    H = (0.05 * m0 @ m0.T + 0.2 * np.eye(d)).astype(np.float32)
    got = float(lscv.g_of_H(x, torch.as_tensor(H), backend=backend, device="cpu"))
    want = float(jl.g_of_H(jnp.asarray(x), jnp.asarray(H)))
    assert got == pytest.approx(want, rel=5e-4)
    assert got == pytest.approx(_g64_of_H(x, H), rel=2e-3)


def _rosen(p):
    return (1 - p[0]) ** 2 + 100.0 * (p[1] - p[0] ** 2) ** 2


def _quad(p):
    return (p[0] - 1.0) ** 2 + 3.0 * (p[1] + 2.0) ** 2


def _spike(p):
    """A saddle of two ridges: from the origin, steps shrink the simplex."""
    return 1.0 - 1.0 / (1.0 + 64.0 * abs(p[0] * p[1])) + 0.001 * abs(p[0] + p[1])


@pytest.mark.parametrize("fun,x0,kw", [
    (_rosen, [-1.2, 1.0], dict(max_iter=400, init_scale=0.5)),
    (_rosen, [0.5, -0.5], dict(max_iter=60)),
    (_quad, [0.3, 0.3], dict(max_iter=200)),
    (_spike, [0.0, 0.0], dict(max_iter=100)),
])
def test_nelder_mead_trajectory_equals_reference(fun, x0, kw):
    got = nelder_mead.minimize(fun, torch.tensor(x0), **kw)
    want = jnm.minimize(fun, jnp.asarray(x0, jnp.float32), **kw)
    np.testing.assert_array_equal(_np(got.x), np.asarray(want.x))
    assert (got.it, got.nfev) == (int(want.it), int(want.nfev))
    # the value is fun(x) as each framework evaluates it: XLA may fuse the
    # cancelling multiply-adds of Rosenbrock's valley into FMAs
    assert float(got.fun) == float(fun(got.x))
    assert float(got.fun) == pytest.approx(float(want.fun), rel=1e-3, abs=1e-12)


def test_nelder_mead_evaluates_shrinks_only_when_taken():
    calls = []

    def counted(p):
        calls.append(1)
        return _spike(p)

    res = nelder_mead.minimize(counted, torch.tensor([0.0, 0.0]), max_iter=100)
    assert res.nfev > 3 + 3 * res.it       # k + 1 = 3 start points, 3 per step
    assert len(calls) == res.nfev


def _correlated(rng, n):
    x = rng.normal(0.0, 1.0, (n, 2)).astype(np.float32)
    x[:, 1] = 0.6 * x[:, 0] + 0.8 * x[:, 1]
    return x


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_lscv_H_matches_reference_by_objective(rng, backend):
    x = _correlated(rng, 200)
    got = lscv.lscv_H(x, max_iter=80, backend=backend, device="cpu")
    want = jl.lscv_H(jnp.asarray(x), max_iter=80)
    assert _g64_of_H(x, _np(got.H)) == pytest.approx(_g64_of_H(x, np.asarray(want.H)),
                                                     rel=1e-2)
    assert np.all(np.linalg.eigvalsh(_np(got.H).astype(np.float64)) > 0)
    g_start = float(lscv.g_of_H(x, got.H_start, device="cpu"))
    assert float(got.g) <= g_start + 1e-7
    np.testing.assert_allclose(_np(got.H_start), np.asarray(want.H_start), rtol=1e-5)


def test_lscv_H_multi_start_never_worse_than_one_start(rng):
    x = _correlated(rng, 120)
    one = lscv.lscv_H(x, max_iter=40, device="cpu")
    three = lscv.lscv_H(x, max_iter=40, multi_start=3, seed=5, device="cpu")
    assert float(three.g) <= float(one.g)
    assert three.nfev > one.nfev
    again = lscv.lscv_H(x, max_iter=40, multi_start=3, seed=5, device="cpu")
    assert torch.equal(again.H, three.H)


# --- synopses -------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 3])
def test_lscv_h_synopsis_matches_reference(rng, d):
    data = rng.normal(1.0, 1.5, (300, d)).astype(np.float32)
    if d == 1:
        data = data[:, 0]
    got = aqp.KDESynopsis.fit(data, selector="lscv_h", max_sample=512, device="cpu")
    want = jaqp.KDESynopsis.fit(jnp.asarray(data), selector="lscv_h", max_sample=512)
    np.testing.assert_array_equal(_np(got.x), np.asarray(want.x))
    assert got.H is None and got.h.shape == ()
    assert float(got.h) == pytest.approx(float(want.h), rel=1e-6)
    lo, hi = [0.0] * d, [2.0] * d
    np.testing.assert_allclose(float(got.count_box(lo, hi)),
                               float(want.count_box(lo, hi)), rtol=1e-4)
    np.testing.assert_allclose(float(got.sum_box(lo, hi, d - 1)),
                               float(want.sum_box(lo, hi, d - 1)), rtol=1e-4)


def test_lscv_H_synopsis_matches_reference_by_objective(rng):
    data = _correlated(rng, 150)
    got = aqp.KDESynopsis.fit(data, selector="lscv_H", max_sample=512, device="cpu")
    want = jaqp.KDESynopsis.fit(jnp.asarray(data), selector="lscv_H", max_sample=512)
    assert got.h is None and got.H.shape == (2, 2)
    assert _g64_of_H(data, _np(got.H)) == pytest.approx(
        _g64_of_H(data, np.asarray(want.H)), rel=1e-2)
    # its boxes answer by quasi-MC, as the reference's do under the same H
    lo, hi = [0.0, 0.0], [1.0, 1.0]
    np.testing.assert_allclose(
        float(got.count_box(lo, hi)),
        float(jaqp.count_box_H(jnp.asarray(data), jnp.asarray(_np(got.H)),
                               jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32))),
        rtol=1e-4)


def test_lscv_h_on_cpu_counts_no_launches(rng):
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    x = rng.normal(0, 1, (64, 2)).astype(np.float32)
    lscv.lscv_h(x, n_h=5, backend="cuda", device="cpu")
    lscv.g_of_H(x, torch.eye(2), backend="cuda", device="cpu")
    assert sum(ops.launch_counts().values()) == 0


def test_lscv_entry_points_default_to_cuda_or_raise():
    x = np.random.default_rng(0).normal(0, 1, (16, 2)).astype(np.float32)
    if torch.cuda.is_available():
        assert lscv.lscv_h(x, n_h=3).h.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            lscv.lscv_h(x, n_h=3)
        with pytest.raises(RuntimeError, match="CUDA"):
            lscv.lscv_H(x, max_iter=2)


# --- a singular covariance: a constant column, or a joint with one constant axis ---------

def _singular(case):
    if case == "constant_column":
        return np.full(64, 3.0, np.float32)
    rng = np.random.default_rng(0)
    return np.stack([rng.normal(size=64), np.full(64, 2.0)], 1).astype(np.float32)


def _same_pattern(got, want):
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))


@pytest.mark.parametrize("case", ["constant_column", "one_constant_axis"])
def test_lscv_h_on_a_singular_covariance_matches_reference(case):
    """The covariance is formed as the reference's jitted fit forms it (its
    two terms differ by 2^-23 on a constant column instead of cancelling)
    and inverted without a singularity check, so the port returns the
    reference's h, grid and non-finite pattern of g where it used to raise."""
    x = _singular(case)
    got = lscv.lscv_h(x, device="cpu")
    want = jl.lscv_h(jnp.asarray(x))
    assert float(got.h) == float(want.h)
    np.testing.assert_array_equal(_np(got.h_grid), np.asarray(want.h_grid))
    g, w = _np(got.g_values), np.asarray(want.g_values)
    _same_pattern(g, w)
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=3e-4)
    np.testing.assert_allclose(_np(got.sigma), np.asarray(want.sigma), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("case", ["constant_column", "one_constant_axis"])
def test_lscv_H_and_h_start_on_a_singular_covariance(case):
    """H_start equals the one inside the reference's (jitted) lscv_H, to
    float32 noise on the constant axis.  On a constant column LSCV_H then
    runs as the reference's does: a finite, vanishing H with an unbounded
    objective, after the full 150 iterations.  With one constant axis
    H_start has rank 1, and whether a float32 Cholesky factor of it exists
    is decided by rounding (of the column sums, and inside the
    factorisation): the reference's last pivot rounds positive, the port's
    negative, so the port's LSCV_H returns NaN where the reference's returns
    a finite, meaningless H.  It does not raise: the port's log-Cholesky map
    gives NaN on a matrix that is not positive definite, as jnp's cholesky
    does."""
    x = _singular(case)
    xr = x if x.ndim == 2 else x[:, None]
    got = lscv.lscv_H(x, device="cpu")
    want = jl.lscv_H(jnp.asarray(xr))
    H0, W0 = _np(got.H_start), np.asarray(want.H_start)
    np.testing.assert_allclose(H0, W0, rtol=1e-5, atol=1e-5 * np.abs(W0).max())
    np.testing.assert_array_equal(_np(lscv.h_start(torch.tensor(xr))), H0)
    for H in (np.array([[1.0, 2.0], [2.0, 1.0]], np.float32), np.eye(2, dtype=np.float32)):
        _same_pattern(_np(lscv._H_to_theta(torch.tensor(H))),
                      np.asarray(jl._H_to_theta(jnp.asarray(H))))
    if case == "constant_column":
        assert got.it == int(want.it) == 150
        for g, w in ((_np(got.H), np.asarray(want.H)), (float(got.g), float(want.g))):
            _same_pattern(np.asarray(g), np.asarray(w))
        assert 0.0 < float(got.H[0, 0]) < 1e-30 and float(got.g) < -1e15
    else:
        assert np.all(np.isnan(_np(got.H)))


def test_lscv_h_store_query_over_a_constant_column_matches_reference():
    from repro.core import aqp_query as jq
    from repro.data import aqp_store as jstore
    from repro_torch.core import aqp_query as tq
    from repro_torch.data import aqp_store as tstore

    rng = np.random.default_rng(4)
    batch = {"flat": np.full(300, 3.0, np.float32),
             "loss": rng.normal(2.0, 0.5, 300).astype(np.float32)}
    ref = jstore.TelemetryStore(capacity=128, seed=0)
    port = tstore.TelemetryStore(capacity=128, seed=0, device="cpu")
    for s in (ref, port):
        s.add_batch(batch)
    specs = [(m.AqpQuery("count", (m.Range("flat", 2.5, 3.5),)),
              m.AqpQuery("avg", (m.Range("flat", 2.9, 3.05),)),
              m.AqpQuery("sum", (m.Range("loss", 1.5, 2.5),))) for m in (tq, jq)]
    got = port.query(list(specs[0]), selector="lscv_h")
    want = ref.query(list(specs[1]), selector="lscv_h")
    assert float(port.synopsis("flat", "lscv_h").h) == float(ref.synopsis("flat", "lscv_h").h)
    for g, w in zip(got, want):
        assert g.path == w.path == "range1d"
        np.testing.assert_allclose(g.estimate, w.estimate, rtol=1e-4, atol=1e-3)
