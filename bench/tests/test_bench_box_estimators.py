"""CPU tests of the reference's kernel-centred box integrator
(`reference.kernel_box_answers`) against closed forms and brute-force Monte
Carlo, of the configuration's choice of integrator in the harness, and of
the stream's exact answers that `stream_err` reads against."""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
from scipy.special import ndtr

from bench import check, harness, reference, streams
from bench.streams import SpecRow
from bench.tests.test_bench_control import SEED, run, small

K = 64


def _phi(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def test_one_column_matches_the_closed_form():
    """d = 1: each row's mass in [a, b] is Phi((b - X_i)/h) - Phi((a - X_i)/h).
    A row's K draws are Halton points K i + 1 .. K i + K in base 2, one in
    each stratum [r/K, (r+1)/K): only the two strata that hold the interval's
    ends miss, each by a count of variance at most 1/4.  So the COUNT's error
    has a standard deviation under n_source sqrt(2 / 4 / m) / K; the bound is
    four of them (SUM: times the largest |bound|, the weight a draw inside
    can carry)."""
    rng = np.random.default_rng(11)
    m, h, n_src = 400, 0.3, 4000
    x = rng.normal(0.0, 1.0, m).astype(np.float32).astype(np.float64)
    a, b = -0.5, 0.8
    specs = [SpecRow("box", agg, ("c",), (a,), (b,), 0) for agg in ("count", "sum", "avg")]
    got = reference.kernel_box_answers(x, np.array([[h * h]]), specs, n_src, K, 8, 0.95)
    za, zb = (a - x) / h, (b - x) / h
    tc = ndtr(zb) - ndtr(za)
    ts = x * tc - h * (_phi(zb) - _phi(za))
    cnt, tot = n_src / m * tc.sum(), n_src / m * ts.sum()
    tol_c = 4.0 * n_src * math.sqrt(0.5 / m) / K
    tol_s = tol_c * max(abs(a), abs(b))
    assert abs(got[0][0] - cnt) <= tol_c
    assert abs(got[1][0] - tot) <= tol_s
    assert abs(got[2][0] - tot / cnt) <= (tol_s + abs(tot / cnt) * tol_c) / (cnt - tol_c)
    for est, lo, hi in got:
        assert lo < est < hi


def test_three_columns_diagonal_H_match_the_product_of_phi_differences():
    """d = 3, H diagonal: a row's mass is the product over the axes of its
    Phi differences, and its SUM term the target axis' first moment times
    the other two.  Halton draws do no worse than m K independent draws:
    the bound is four standard deviations of such a Monte Carlo estimate,
    n_source sqrt(p (1 - p) / (m K)) for the COUNT at its share p of the
    mass (the SUM's: the target's largest |bound| times sqrt(p / (m K)))."""
    rng = np.random.default_rng(12)
    m, n_src = 400, 4000
    x = rng.normal(0.0, 1.0, (m, 3)).astype(np.float32).astype(np.float64)
    sd = np.array([0.3, 0.5, 0.2])
    lo, hi = np.array([-0.5, -1.0, -0.2]), np.array([0.7, 0.4, 1.1])
    specs = [SpecRow("box", agg, ("a", "b", "c"), tuple(lo), tuple(hi), t)
             for agg, t in (("count", 0), ("sum", 1), ("sum", 2), ("avg", 2))]
    got = reference.kernel_box_answers(x, np.diag(sd ** 2), specs, n_src, K, 8, 0.95)
    za, zb = (lo - x) / sd, (hi - x) / sd
    pc = ndtr(zb) - ndtr(za)                                   # (m, 3)
    first = x * pc - sd * (_phi(zb) - _phi(za))                # E[y_t 1[lo_t <= y_t <= hi_t]]
    p = np.prod(pc, axis=1)
    share = p.mean()
    cnt = n_src * share
    sd_c = n_src * math.sqrt(share * (1.0 - share) / (m * K))
    assert abs(got[0][0] - cnt) <= 4.0 * sd_c
    tot, sd_s = {}, {}
    for t in (1, 2):
        tot[t] = n_src / m * np.sum(np.prod(np.delete(pc, t, axis=1), axis=1) * first[:, t])
        sd_s[t] = n_src * max(abs(lo[t]), abs(hi[t])) * math.sqrt(share / (m * K))
    assert abs(got[1][0] - tot[1]) <= 4.0 * sd_s[1]
    assert abs(got[2][0] - tot[2]) <= 4.0 * sd_s[2]
    avg = tot[2] / cnt
    assert abs(got[3][0] - avg) <= 4.0 * (sd_s[2] + abs(avg) * sd_c) / (cnt - 4.0 * sd_c)


def _mc(x, H, lo, hi, draws, seed, targets=()):
    """Brute-force Monte Carlo of the KDE's box mass: `draws` normal draws a
    row from a seeded generator.  (share inside, {target: mean weighted
    indicator})."""
    g = np.random.default_rng(seed)
    L = np.linalg.cholesky(H)
    inside, weighted = 0.0, {t: 0.0 for t in targets}
    for r0 in range(0, x.shape[0], 64):
        y = x[r0:r0 + 64, None, :] + g.standard_normal((min(64, x.shape[0] - r0), draws,
                                                        x.shape[1])) @ L.T
        ins = np.all((y >= lo) & (y <= hi), axis=2)
        inside += ins.sum()
        for t in targets:
            weighted[t] += (ins * y[..., t]).sum()
    n = x.shape[0] * draws
    return inside / n, {t: w / n for t, w in weighted.items()}


def test_eight_columns_full_H_match_brute_force_monte_carlo():
    """d = 8, full H: against Monte Carlo with ten times the draws (640 a
    row from a seeded generator).  Both estimate one mass, so they differ by
    at most four standard deviations of the difference of an m K-draw and
    an m 10K-draw Monte Carlo estimate (Halton's draws doing no worse than
    independent ones).  The sample is narrower than its kernel (axis scales
    0.1 .. 1, correlation 0.7), so each box's mass turns on H's shape: with
    L^T L in H's place the six boxes' masses (2-8 %) fall by 13-20 of those
    deviations."""
    rng = np.random.default_rng(13)
    d, m, n_src = 8, 256, 10_000
    scale = np.geomspace(0.1, 1.0, d)
    H = scale[:, None] * (0.7 + 0.3 * np.eye(d)) * scale[None]
    x = (rng.normal(0.0, 0.3, (m, d)) * scale).astype(np.float32).astype(np.float64)
    boxes = []
    for _ in range(6):
        lo = rng.uniform(-1.5, 0.0, d) * scale
        boxes.append((lo, lo + rng.uniform(1.0, 3.0, d) * scale))
    specs = []
    for lo, hi in boxes:
        specs += [SpecRow("box", "count", tuple("abcdefgh"), tuple(lo), tuple(hi), 0),
                  SpecRow("box", "sum", tuple("abcdefgh"), tuple(lo), tuple(hi), 3),
                  SpecRow("box", "avg", tuple("abcdefgh"), tuple(lo), tuple(hi), 5)]
    got = reference.kernel_box_answers(x, H, specs, n_src, K, 8, 0.95)
    shares = []
    for j, (lo, hi) in enumerate(boxes):
        share, w = _mc(x, H, lo, hi, 10 * K, seed=100 + j, targets=(3, 5))
        shares.append(share)
        both = math.sqrt(1.0 / (m * K) + 1.0 / (m * 10 * K))
        sd_c = n_src * math.sqrt(share * (1.0 - share)) * both
        assert abs(got[3 * j][0] - n_src * share) <= 4.0 * sd_c
        sd_s = n_src * np.max(np.abs([lo[3], hi[3]])) * math.sqrt(share) * both
        assert abs(got[3 * j + 1][0] - n_src * w[3]) <= 4.0 * sd_s
        avg = w[5] / share
        sd_a = (n_src * np.max(np.abs([lo[5], hi[5]])) * math.sqrt(share) * both
                + abs(avg) * sd_c) / (n_src * share - 4.0 * sd_c)
        assert abs(got[3 * j + 2][0] - avg) <= 4.0 * sd_a
    assert 0.02 <= min(shares) and max(shares) <= 0.08, shares


def _joint8_sample(m):
    """A small copy of `joint8-n16384` under the `lscv_H.boxes` recipe: a
    20 000-row stream, an m-row joint reservoir, 30 boxes of the mix's
    quantile recipe, and H_start (eq. 37) of the sample."""
    cell = harness.load_cell("joint8.lscv_H", config="joint8-n16384", like="joint3.lscv_H")
    cfg = dict(cell.config, stream_rows=20_000)
    tr = json.loads(json.dumps(cell.traffic))
    tr.update(ingest_rows=5000, pool_batches=2, probe_rows=20_000)
    tr["dashboard"][0]["count"] = 30
    seed = 2 ** 31 + 11
    st = streams.make_stream(seed, cfg, tr)
    rows = streams.make_dashboard(seed, cfg, tr, st.probe)
    cols = cfg["joints"][0]
    res = reference.Reservoir(m, 7, width=len(cols))
    for b in st.setup:
        res.add(np.stack([b[c] for c in cols], axis=1))
    x = res.sample().astype(np.float64)
    return x, reference.h_start(x), rows, cfg


def test_witness_the_hull_misses_mass_that_the_kernel_centred_answer_finds():
    """At d = 8 the hull's Halton nodes can leave a box with no node under
    any kernel's mass: `qmc_box_answers` answers exactly 0 on a box in
    which brute-force Monte Carlo (2 000 draws a row) finds the KDE's mass
    positive, and the kernel-centred answer's 95 % interval holds that
    mass."""
    x, H, rows, cfg = _joint8_sample(1024)
    n_src = 20_000
    hull = reference.qmc_box_answers(x, H, rows, n_src, int(cfg["n_qmc"]), 8, 0.95)
    zero = next(i for i, a in enumerate(hull) if a[0] == 0.0 and rows[i].aggregate == "count")
    kern = reference.kernel_box_answers(x, H, rows, n_src, K, 8, 0.95)
    share, _ = _mc(x, H, np.array(rows[zero].lo), np.array(rows[zero].hi), 2000, seed=21)
    mass = n_src * share
    assert mass > 0.0
    est, lo, hi = kern[zero]
    assert lo <= mass <= hi, (est, lo, hi, mass)
    # every COUNT the kernel-centred answer gives is positive
    assert all(a[0] > 0.0 for a, r in zip(kern, rows) if r.aggregate == "count")


def test_kernel_answers_repeat_bit_for_bit_and_the_tf32_control_departs():
    """The construction is fixed: two float64 runs give the same bits.  The
    TF32 control keeps 10 mantissa bits of L z, so draws within about 2^-11
    of their size from a face cross it: estimates move by more than 1e-4 of
    their size somewhere (float64 rounding moves them by under 1e-12)."""
    x, H, rows, _ = _joint8_sample(512)
    a = reference.kernel_box_answers(x, H, rows, 20_000, K, 8, 0.95)
    assert reference.kernel_box_answers(x, H, rows, 20_000, K, 8, 0.95) == a
    # another row block only regroups the float64 sums
    b = reference.kernel_box_answers(x, H, rows, 20_000, K, 8, 0.95, row_block=300)
    np.testing.assert_allclose(b, a, rtol=1e-12)
    c = np.asarray(reference.kernel_box_answers(x, H, rows, 20_000, K, 8, 0.95, prec="tf32"))
    ref = np.asarray(a)
    rel = np.abs(c[:, 0] - ref[:, 0]) / np.maximum(np.abs(ref[:, 0]), 1e-300)
    assert rel.max() > 1e-4, rel.max()
    assert check.answer_errors(c, a)["answer_err"] > 0.0


# --- the configuration's choice in the harness ----------------------------------

def _spy(monkeypatch, name):
    calls = []
    original = getattr(reference, name)

    def spy(*args, **kw):
        calls.append(kw)
        return original(*args, **kw)

    monkeypatch.setattr(reference, name, spy)
    return calls


def test_a_configuration_without_the_key_answers_by_the_hull_as_before(monkeypatch):
    """No `box_estimator`: the hull's integrator with the configuration's
    n_qmc, and the same `checks`, bit for bit, as the key set to its
    default."""
    plain = small("joint3.lscv_H")
    assert "box_estimator" not in plain.config
    hull = _spy(monkeypatch, "qmc_box_answers")
    kern = _spy(monkeypatch, "kernel_box_answers")
    res = run(plain)
    assert hull and not kern
    assert all(c["n_qmc"] == int(plain.config["n_qmc"]) for c in hull)
    named = small("joint3.lscv_H")
    named.config["box_estimator"] = "hull_qmc"
    again = run(named)
    assert res["correct"] and again["checks"] == res["checks"]
    assert again["not_compared"] == res["not_compared"]


def test_a_kernel_qmc_configuration_is_answered_by_the_kernel_integrator(monkeypatch):
    cell = small("joint3.lscv_H")
    cell.config.update(box_estimator="kernel_qmc", box_draws=16)
    hull = _spy(monkeypatch, "qmc_box_answers")
    kern = _spy(monkeypatch, "kernel_box_answers")
    res = run(cell)
    assert kern and not hull
    assert all(c["draws"] == 16 for c in kern)
    assert set(res["checks"]) == {"reservoir_mismatch", "H_shortfall", "answer_err", "ci_err"}


def test_an_unknown_box_estimator_raises():
    cell = small("joint3.lscv_H")
    cell.config["box_estimator"] = "hull"
    with pytest.raises(ValueError, match="box_estimator"):
        harness.box_integrator(cell.config)
    with pytest.raises(ValueError, match="box_estimator"):
        run(cell)


# --- the stream's exact answers -----------------------------------------------

def test_stream_answers_match_a_brute_force_count():
    """Refresh k has ingested the set-up batches and pool batches of
    refreshes 0 .. k (refresh j: pool[j % P]); every spec counted row by
    row over those rows, past the pool's wrap too."""
    cell = small("kde1d.lscv_h.all-cols")
    joint = small("joint3.lscv_H")
    for c in (cell, joint):
        st = streams.make_stream(SEED, c.config, c.traffic)
        rows = streams.make_dashboard(SEED, c.config, c.traffic, st.probe)
        ks = [0, 1, 2, 7]
        got = reference.stream_answers(st.setup, st.pool, rows, ks)
        for r, k in enumerate(ks):
            seen = st.setup + [st.refresh_batch(j) for j in range(k + 1)]
            for i, sp in enumerate(rows):
                cnt, tot = 0, 0.0
                for b in seen:
                    vals = np.stack([np.asarray(b[col], np.float64) for col in sp.columns], 1)
                    ins = np.all((vals >= sp.lo) & (vals <= sp.hi), axis=1)
                    cnt += int(ins.sum())
                    tot += float(vals[ins, sp.target].sum())
                want = {"count": cnt, "sum": tot,
                        "avg": tot / cnt if cnt > 0 else 0.0}[sp.aggregate]
                assert got[r, i] == pytest.approx(want, rel=1e-12, abs=1e-9), (k, sp)


def test_stream_errors_read_the_programs_answers_against_the_exact_ones():
    assert check.stream_errors([[1.1, 2.0, 5.0]], [[1.0, 2.5, 0.0]]) == pytest.approx(
        {"stream_err.median": 0.15, "stream_err.max": 0.2})
    assert check.stream_errors([[np.inf, 3.0]], [[1.0, 2.0]]) == {
        "stream_err.median": 0.5, "stream_err.max": 0.5}
    assert check.stream_errors([[1.0]], [[0.0]]) == {}


@pytest.mark.parametrize("name", ["kde1d.lscv_h.all-cols", "joint3.lscv_H"])
def test_a_run_reports_stream_err_beside_the_check(name, monkeypatch):
    """Both cells read stream_err, not compared.  The exact Eq path of
    cell 1 reads 0 against the stream's count: the refreshes' rows are
    counted as the store ingested them."""
    captured = {}
    original = check.stream_errors

    def spy(est, exact):
        captured["est"], captured["exact"] = np.asarray(est), np.asarray(exact)
        return original(est, exact)

    monkeypatch.setattr(check, "stream_errors", spy)
    cell = small(name)
    res = run(cell)
    nc = res["not_compared"]
    assert {"stream_err.median", "stream_err.max"} <= set(nc)
    assert 0.0 <= nc["stream_err.median"] <= nc["stream_err.max"] < 1.0
    assert "stream_err.median" not in res["checks"]
    st = streams.make_stream(SEED, cell.config, cell.traffic)
    rows = streams.make_dashboard(SEED, cell.config, cell.traffic, st.probe)
    eq = [i for i, r in enumerate(rows) if r.kind == "eq"]
    if eq:
        np.testing.assert_array_equal(captured["est"][:, eq], captured["exact"][:, eq])
    assert captured["est"].shape[1] == len(rows)

