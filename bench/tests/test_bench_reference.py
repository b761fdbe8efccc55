"""CPU tests of the benchmark's plain reference against brute-force NumPy
at n of a few hundred, and of its reservoir replay against the program's
store on the same stream."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from bench import reference, streams
from bench.streams import SpecRow


def _pairs(x, a_inv):
    i, j = np.triu_indices(x.shape[0], 1)
    v = x[i] - x[j]
    return np.einsum("pk,kl,pl->p", v, a_inv, v)


def test_lscv_h_curve_matches_brute_force():
    rng = np.random.default_rng(5)
    x = rng.normal(2.0, 0.7, 300)
    grid, g, g_at = reference.lscv_h_curve(x, 150, extra_h=[0.2])
    n = x.size
    var = np.var(x, ddof=1)
    s = _pairs(x[:, None], np.array([[1.0 / var]]))
    h0 = (4.0 / 3.0) ** 0.2 * n ** -0.2
    np.testing.assert_allclose(grid, np.linspace(h0 / 4, 4 * h0, 150), rtol=1e-12)
    c_k, c_kk = (2 * math.pi) ** -0.5 / math.sqrt(var), (4 * math.pi) ** -0.5 / math.sqrt(var)

    def brute(h):
        t = np.sum(c_kk * np.exp(-s / (4 * h * h)) - 2 * c_k * np.exp(-s / (2 * h * h)))
        return (2.0 / n ** 2 * t + c_kk / n) / h

    np.testing.assert_allclose(g, [brute(h) for h in grid], rtol=1e-9)
    assert g_at[0] == pytest.approx(brute(0.2), rel=1e-9)


def test_g_of_H_matches_brute_force():
    rng = np.random.default_rng(6)
    x = rng.normal(0.0, 1.0, (200, 3)) @ np.array([[1, 0.3, 0], [0, 1, 0.2], [0, 0, 2.0]])
    H = np.array([[0.3, 0.05, 0.0], [0.05, 0.2, 0.01], [0.0, 0.01, 0.5]])
    got = reference.g_of_H_rows(x, H)
    s = _pairs(x, np.linalg.inv(H))
    det = np.linalg.det(H)
    c_k, c_kk = (2 * math.pi) ** -1.5 / math.sqrt(det), (4 * math.pi) ** -1.5 / math.sqrt(det)
    n = x.shape[0]
    want = 2.0 / n ** 2 * np.sum(c_kk * np.exp(-s / 4) - 2 * c_k * np.exp(-s / 2)) + c_kk / n
    assert got == pytest.approx(want, rel=1e-10)


def test_nelder_mead_descends_and_stops_at_its_limit():
    def f(p):
        return float((p[0] - 1.0) ** 2 + 10 * (p[1] + 0.5) ** 2)

    x, fx, nfev = reference.nelder_mead(f, np.array([0.3, 0.4]), max_iter=150)
    assert fx < 1e-6 and np.allclose(x, [1.0, -0.5], atol=1e-3)
    _, _, nfev3 = reference.nelder_mead(f, np.array([0.3, 0.4]), max_iter=3)
    assert nfev3 >= 3 + 3 * 3
    H = np.array([[0.5, 0.1], [0.1, 0.3]])
    np.testing.assert_allclose(reference.theta_to_H(reference.H_to_theta(H), 2), H)


def test_range_answers_match_brute_force():
    from scipy.special import ndtr
    rng = np.random.default_rng(7)
    x = rng.normal(2.0, 0.5, 400)
    specs = [SpecRow("range", agg, ("c",), (1.5,), (2.4,), 0) for agg in ("count", "sum", "avg")]
    got = reference.range_answers(x, 0.1, specs, n_source=4000, ci_level=0.95)
    za, zb = (1.5 - x) / 0.1, (2.4 - x) / 0.1
    tc = ndtr(zb) - ndtr(za)
    ts = x * tc - 0.1 * (np.exp(-zb ** 2 / 2) - np.exp(-za ** 2 / 2)) / math.sqrt(2 * math.pi)
    m, s = x.size, 4000 / x.size
    z = 1.959963984540054
    cnt, tot = s * tc.sum(), s * ts.sum()
    se_c = s * math.sqrt(m * np.var(tc, ddof=1))
    se_s = s * math.sqrt(m * np.var(ts, ddof=1))
    r = ts.sum() / tc.sum()
    se_a = s * math.sqrt(m * np.var(ts - r * tc, ddof=1) + m / (m - 1) * 0) / cnt
    want = [(cnt, cnt - z * se_c, cnt + z * se_c), (tot, tot - z * se_s, tot + z * se_s),
            (tot / cnt, tot / cnt - z * se_a, tot / cnt + z * se_a)]
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_qmc_box_answers_match_brute_force():
    rng = np.random.default_rng(8)
    x = rng.normal(0.0, 1.0, (256, 2)).astype(np.float32).astype(np.float64)
    H = np.array([[0.2, 0.05], [0.05, 0.3]])
    specs = [SpecRow("box", agg, ("a", "b"), (-0.5, -1.0), (0.7, 0.4), t)
             for agg, t in (("count", 0), ("sum", 1), ("avg", 0))]
    got = reference.qmc_box_answers(x, H, specs, n_source=2560, n_qmc=4096, k_sub=8,
                                    ci_level=0.95)
    # brute force: the planned hull is the one box itself (inside the support)
    lo, hi = np.array([-0.5, -1.0]), np.array([0.7, 0.4])
    n_nodes = 4096
    u = reference.halton(n_nodes, 2)
    nodes = (lo.astype(np.float32) + u * (hi - lo).astype(np.float32)).astype(np.float64)
    inv, det = np.linalg.inv(H), np.linalg.det(H)
    diff = nodes[:, None, :] - x[None]
    kern = np.exp(-0.5 * np.einsum("nmk,kl,nml->nm", diff, inv, diff)) / (2 * math.pi * math.sqrt(det))
    vol = np.prod(hi - lo)
    cnt = 2560 / 256 * vol / n_nodes * kern.sum()
    tot1 = 2560 / 256 * vol / n_nodes * (nodes[:, 1] * kern.sum(1)).sum()
    tot0 = 2560 / 256 * vol / n_nodes * (nodes[:, 0] * kern.sum(1)).sum()
    np.testing.assert_allclose([g[0] for g in got], [cnt, tot1, tot0 / cnt], rtol=1e-9)
    chunks = kern.reshape(n_nodes, 8, 32).sum(2)            # (nodes, K)
    reps = 2560 / 32 * vol / n_nodes * chunks.sum(0)
    t7 = 2.3646242515927844                                  # t_{0.975, 7}
    half = t7 * np.std(reps, ddof=1) / math.sqrt(8)
    assert got[0][2] - got[0][0] == pytest.approx(half, rel=1e-8)


def test_eq_answers_are_exact_counts():
    codes = {0.0: 5, 1.0: 7, 2.0: 3}
    specs = [SpecRow("eq", agg, ("m",), (0.5,), (1.5,), 0) for agg in ("count", "sum", "avg")]
    assert reference.eq_answers(codes, specs) == [(7.0, 7.0, 7.0), (7.0, 7.0, 7.0),
                                                  (1.0, 1.0, 1.0)]


def test_quantiles_and_tf32_rounding():
    from scipy import stats
    assert reference.t_ppf(0.975, 7) == pytest.approx(stats.t.ppf(0.975, 7), rel=1e-10)
    assert reference.norm_ppf(0.975) == pytest.approx(stats.norm.ppf(0.975), rel=1e-12)
    a = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12])
    np.testing.assert_array_equal(reference.tf32_round(a).numpy(),
                                  [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10])


def test_reservoir_replay_matches_the_program_store():
    from repro_torch.data.aqp_store import TelemetryStore
    config = {"latent_factors": 1, "stream_rows": 9000, "columns": [
        {"name": "a", "base": 1.0, "loadings": [0.5], "noise": 0.3},
        {"name": "b", "base": 2.0, "loadings": [0.2], "noise": 0.3, "transform": "exp"},
        {"name": "m", "codes": 8}]}
    traffic = {"ingest_rows": 1000, "pool_batches": 4, "probe_rows": 1000}
    seed = 2 ** 31 + 3
    st = streams.make_stream(seed, config, traffic)
    store = TelemetryStore(capacity=512, seed=seed, device="cpu")
    store.track_categorical("m")
    store.track_joint(("a", "b"))
    ing = reference.Ingest(512, seed, ["a", "b", "m"], [("a", "b")], ["m"])
    for batch in st.setup + st.pool:
        store.add_batch(batch)
        ing.add(batch)
    for c in ("a", "b", "m"):
        np.testing.assert_array_equal(store.columns[c].sample(), ing.columns[c].sample())
        assert store.columns[c].n_seen == ing.columns[c].n_seen
    np.testing.assert_array_equal(store.joints[("a", "b")].sample(),
                                  ing.joints[("a", "b")].sample())
    assert store.categoricals["m"].counts == ing.codes["m"]
