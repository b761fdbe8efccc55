"""The full-H slice of the port, on the CPU: scalar-h KDE evaluation
(`kde_eval`, five kernels, and the trapezoid forms of eqs. 9-10), the
quasi-MC planning (Halton nodes and `_qmc_plan`, bit-equal to the
reference's), the qmc_reduce / rff_eval / kde_eval plain versions against
the JAX package's oracles and its Pallas kernels in interpret mode,
`batch_query_qmc`, the subsample CI, the RFF synopsis (fit, eval, feature
blocks, snapshots), and `store.query(selector="lscv_H")` on the exact and
RFF density backends against the JAX store, with the reference's fitted
state carried across.  On a machine with a CUDA device each kernel is held
against its plain version.

Tolerances are the reference's own (`tests/test_kernels.py`,
`tests/test_synopses.py`): rtol 1e-5 / atol 1e-6 for qmc_box_reduce, 2e-5 /
2e-5 for rff_density, 5e-4 / 1e-7 for kde_eval (float32 sums in another
order).  Engine answers on identical fitted state (a carried snapshot)
agree at rtol 1e-4 plus atol 1e-4 x scale, the store tests' tolerance; the
port's own LSCV_H fits differ from the reference's within the Nelder-Mead
tolerance of `tests/test_torch_lscv.py`, so those answers are held inside
the reference's CIs instead.  The port's RFF draws come from a
`torch.Generator`, not `jax.random`: its own RFF answers are held to its
exact path within four feature-block CI half-widths, as the reference
holds its own.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aqp as jaqp
from repro.core import aqp_ci as jci
from repro.core import aqp_multid as jmd
from repro.core import aqp_query as jq
from repro.core import kde as jkde
from repro.data import aqp_store as jstore
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.synopses import rff as jrff
from repro_torch import convert
from repro_torch.core import aqp, aqp_ci, aqp_multid, aqp_query as tq, kde
from repro_torch.data import aqp_store as tstore
from repro_torch.kernels import ops, ref
from repro_torch.synopses import RFFSynopsis, available, get_backend
from repro_torch.synopses import rff as trff

QMC_TOL = dict(rtol=1e-5, atol=1e-6)
RFF_TOL = dict(rtol=2e-5, atol=2e-5)
KDE_TOL = dict(rtol=5e-4, atol=1e-7)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np(t):
    return t.detach().cpu().numpy()


def _spd(rng, d, noise=0.3, ridge=0.5):
    a = rng.normal(0, noise, (d, d))
    return (a @ a.T + np.eye(d) * ridge).astype(np.float32)


# --- Halton nodes and the quasi-MC plan ---------------------------------------------

@pytest.mark.parametrize("n,d", [(1, 1), (100, 3), (4096, 2), (513, 12)])
def test_halton_nodes_are_bit_equal(n, d):
    np.testing.assert_array_equal(aqp._halton(n, d), np.asarray(jaqp._halton(n, d)))
    np.testing.assert_array_equal(aqp_multid._halton_unit(n, d),
                                  np.asarray(jmd._halton_unit(n, d)))


@pytest.mark.parametrize("d", [1, 3])
def test_qmc_plan_is_bit_equal(rng, d):
    x = rng.normal(0, 1, (300, d)).astype(np.float32)
    H = _spd(rng, d)
    lo = rng.uniform(-2, 0, (9, d))
    hi = lo + rng.uniform(0.01, 2.0, (9, d))
    lo[0, 0], hi[1, -1] = -1e30, 1e30            # unconstrained axes clip to support
    lo[2], hi[2] = 0.5, 0.5                       # one zero-measure box
    for n_qmc in (64, 4096):
        got = aqp_multid._qmc_plan(x.astype(np.float64), H, lo, hi, n_qmc)
        want = jmd._qmc_plan(x.astype(np.float64), H, lo, hi, n_qmc)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        assert got[4] == want[4]
    flat = np.zeros((2, d))
    assert aqp_multid._qmc_plan(x.astype(np.float64), H, flat, flat, 64) is None
    assert jmd._qmc_plan(x.astype(np.float64), H, flat, flat, 64) is None


# --- qmc_box_reduce ------------------------------------------------------------------

def _qmc_inputs(rng, n, d, q, m):
    x = rng.normal(0, 1.0, (n, d)).astype(np.float32)
    nodes = rng.uniform(-2, 2, (m, d)).astype(np.float32)
    Hm = _spd(rng, d)
    h_inv = np.linalg.inv(Hm).astype(np.float32)
    log_norm = np.float32(-0.5 * d * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(Hm)[1])
    lo = rng.uniform(-2, 0, (q, d)).astype(np.float32)
    hi = lo + np.float32(1.5)
    tgt = rng.integers(0, d, q).astype(np.int32)
    return nodes, x, h_inv, log_norm, lo, hi, tgt


def _port_qmc(args):
    nodes, x, h_inv, log_norm, lo, hi, tgt = args
    return [_np(v) for v in ops.qmc_box_reduce(_t(nodes), _t(x), _t(h_inv),
                                               float(log_norm), _t(lo), _t(hi),
                                               _t(tgt, torch.int32))]


@pytest.mark.parametrize("n,d,q,m", [(17, 2, 3, 33), (65, 2, 17, 129), (100, 1, 1, 200),
                                     (128, 4, 15, 256), (300, 3, 70, 64)])
def test_qmc_box_reduce_plain_matches_reference_oracle(rng, n, d, q, m):
    args = _qmc_inputs(rng, n, d, q, m)
    got = _port_qmc(args)
    want = jref.qmc_box_reduce(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **QMC_TOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **QMC_TOL)


def test_qmc_box_reduce_plain_matches_reference_kernel(rng):
    args = _qmc_inputs(rng, 65, 2, 17, 129)
    got = _port_qmc(args)
    want = jops.qmc_box_reduce(*[jnp.asarray(a) for a in args], tile=64, m_tile=32,
                               q_tile=8)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **QMC_TOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **QMC_TOL)


@pytest.mark.parametrize("n,d,q,m,splits", [(200, 2, 9, 129, 8),    # n = 8 x 25: no tail
                                             (203, 2, 9, 129, 8),    # a 3-row tail
                                             (37, 1, 4, 50, 5),
                                             (66, 3, 70, 64, 2),
                                             (30, 2, 3, 33, 0)])     # no splits
def test_qmc_box_reduce_split_plain_matches_reference_per_chunk(rng, n, d, q, m, splits):
    """Row 0 is the reference's qmc_box_reduce over the whole sample, row
    1 + j the reference's on row chunk j (c = n // splits rows each), and the
    rows past the chunks enter row 0 only, at the reference's rtol 1e-5."""
    args = _qmc_inputs(rng, n, d, q, m)
    nodes, x, h_inv, log_norm, lo, hi, tgt = args
    cnt, sm = ops.qmc_box_reduce_split(_t(nodes), _t(x), _t(h_inv), float(log_norm),
                                       _t(lo), _t(hi), _t(tgt, torch.int32), splits)
    assert cnt.shape == sm.shape == (splits + 1, q)
    c = n // splits if splits else 0
    chunks = [x] + [x[j * c:(j + 1) * c] for j in range(splits)]
    for row, xs in enumerate(chunks):
        want = jref.qmc_box_reduce(*[jnp.asarray(a) for a in (nodes, xs, h_inv, log_norm,
                                                              lo, hi, tgt)])
        np.testing.assert_allclose(_np(cnt[row]), np.asarray(want[0]), **QMC_TOL)
        np.testing.assert_allclose(_np(sm[row]), np.asarray(want[1]), **QMC_TOL)
    tail = jref.qmc_box_reduce(*[jnp.asarray(a) for a in (nodes, x[splits * c:], h_inv,
                                                          log_norm, lo, hi, tgt)])
    np.testing.assert_allclose(_np(cnt[0]), _np(cnt[1:].sum(0)) + np.asarray(tail[0]),
                               **QMC_TOL)
    with pytest.raises(ValueError):
        ops.qmc_box_reduce_split(_t(nodes), _t(x[:3]), _t(h_inv), float(log_norm),
                                 _t(lo), _t(hi), _t(tgt, torch.int32), 4)


@pytest.mark.parametrize("n,q,m", [(0, 3, 4), (10, 0, 4), (10, 3, 0)])
def test_qmc_box_reduce_empty_inputs_give_zeros(rng, n, q, m):
    args = _qmc_inputs(rng, n, 2, q, m)
    got = _port_qmc(args)
    want = jops.qmc_box_reduce(*[jnp.asarray(a) for a in args])
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape == (q,)
        np.testing.assert_array_equal(g, np.zeros(q, np.float32))


# --- rff_density -----------------------------------------------------------------------

def _rff_inputs(rng, m, D, d):
    return (rng.normal(0, 1, (m, d)).astype(np.float32),
            rng.normal(0, 1, (D, d)).astype(np.float32),
            rng.uniform(0, 2 * np.pi, D).astype(np.float32),
            rng.normal(0, 1, D).astype(np.float32))


@pytest.mark.parametrize("m,D,d", [(1, 16, 1), (7, 130, 3), (300, 64, 2), (33, 515, 8)])
def test_rff_density_plain_matches_reference(rng, m, D, d):
    args = _rff_inputs(rng, m, D, d)
    got = _np(ops.rff_density(*[_t(a) for a in args]))
    np.testing.assert_allclose(got, np.asarray(jref.rff_density(*map(jnp.asarray, args))),
                               **RFF_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.rff_density(*map(jnp.asarray, args),
                                                                tile=64, p_tile=16)),
                               **RFF_TOL)


@pytest.mark.parametrize("m,D", [(0, 16), (5, 0)])
def test_rff_density_empty_inputs(rng, m, D):
    args = _rff_inputs(rng, m, D, 2)
    got = _np(ops.rff_density(*[_t(a) for a in args]))
    want = np.asarray(jops.rff_density(*map(jnp.asarray, args)))
    assert got.shape == want.shape == (m,)
    np.testing.assert_array_equal(got, np.zeros(m, np.float32))


# --- kde_eval ----------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gaussian", "epanechnikov", "biweight", "triangular",
                                  "uniform"])
@pytest.mark.parametrize("m,n,d", [(3, 17, 1), (65, 64, 2), (40, 130, 3)])
def test_kde_eval_matches_reference(rng, kind, m, n, d):
    pts = rng.normal(0, 1, (m, d)).astype(np.float32)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    got = kde.kde_eval(pts, x, 0.6, kind=kind, device="cpu")
    want = jkde.kde_eval(jnp.asarray(pts), jnp.asarray(x), jnp.float32(0.6), kind=kind)
    np.testing.assert_allclose(_np(got), np.asarray(want), **KDE_TOL)


@pytest.mark.parametrize("m,n,d", [(3, 17, 1), (65, 64, 2), (128, 500, 8), (10, 40, 16)])
def test_kde_eval_plain_matches_reference_kernel(rng, m, n, d):
    pts = rng.normal(0, 1, (m, d)).astype(np.float32)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    got = ops.kde_eval(_t(pts), _t(x), 0.6)
    want = jops.kde_eval(jnp.asarray(pts), jnp.asarray(x), jnp.float32(0.6), tile=64)
    np.testing.assert_allclose(_np(got), np.asarray(want), **KDE_TOL)
    np.testing.assert_allclose(_np(got), np.asarray(jref.kde_eval(
        jnp.asarray(pts), jnp.asarray(x), jnp.float32(0.6))), **KDE_TOL)


def test_kde_eval_empty_points_and_one_dimensional_input(rng):
    x = rng.normal(0, 1, 50).astype(np.float32)
    assert ops.kde_eval(torch.zeros((0, 1)), _t(x), 0.5).shape == (0,)
    got = kde.kde_eval(x[:7], x, 0.5, device="cpu")          # (m,) and (n,) inputs
    want = jkde.kde_eval(jnp.asarray(x[:7]), jnp.asarray(x), jnp.float32(0.5))
    np.testing.assert_allclose(_np(got), np.asarray(want), **KDE_TOL)


def test_kde_eval_kernel_backend_takes_only_the_gaussian(rng):
    x = rng.normal(0, 1, (20, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="Gaussian"):
        kde.kde_eval(x[:3], x, 0.5, backend="cuda", kind="epanechnikov", device="cpu")
    # the default backend keeps the compact kernels on the plain path
    assert kde.kde_eval(x[:3], x, 0.5, kind="uniform", device="cpu").shape == (3,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kde.kde_eval(x[:3], x, 0.5)


def test_kde_eval_H_matches_reference(rng):
    x = rng.normal(0, 1, (150, 3)).astype(np.float32)
    pts = rng.normal(0, 1, (70, 3)).astype(np.float32)
    H = _spd(rng, 3, ridge=0.3)
    got = kde.kde_eval_H(pts, x, H, chunk=32, device="cpu")
    want = jkde.kde_eval_H(jnp.asarray(pts), jnp.asarray(x), jnp.asarray(H), chunk=32)
    np.testing.assert_allclose(_np(got), np.asarray(want), **KDE_TOL)


@pytest.mark.parametrize("a,b", [(0.5, 2.5), (-3.0, 1.0), (1.9, 2.0)])
def test_numeric_1d_forms_match_reference_and_closed_forms(rng, a, b):
    x = rng.normal(1.5, 1.0, 300).astype(np.float32)
    h = np.float32(0.35)
    for name in ("count_1d_numeric", "sum_1d_numeric"):
        got = float(getattr(aqp, name)(_t(x), h, a, b))
        want = float(getattr(jaqp, name)(jnp.asarray(x), jnp.float32(h),
                                         jnp.float32(a), jnp.float32(b)))
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-4)
    closed = (float(aqp.count_1d(_t(x), _t(h), a, b)), float(aqp.sum_1d(_t(x), _t(h), a, b)))
    numeric = (float(aqp.count_1d_numeric(_t(x), h, a, b)),
               float(aqp.sum_1d_numeric(_t(x), h, a, b)))
    np.testing.assert_allclose(numeric, closed, rtol=1e-3, atol=1e-3)


# --- full-H boxes ----------------------------------------------------------------------

def test_box_qmc_terms_match_reference(rng):
    x = rng.normal(0, 1, (120, 2)).astype(np.float32)
    H = _spd(rng, 2, ridge=0.2)
    lo, hi = np.asarray([-1.0, -0.5], np.float32), np.asarray([0.8, 1.5], np.float32)
    got = aqp.box_qmc_terms(_t(x), _t(H), _t(lo), _t(hi), target=1, n_qmc=512)
    want = jaqp.box_qmc_terms(jnp.asarray(x), jnp.asarray(H), jnp.asarray(lo),
                              jnp.asarray(hi), target=1, n_qmc=512)
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want],
                               rtol=1e-4)


def _boxes(rng, x, q):
    mu, sd = x.mean(axis=0), x.std(axis=0)
    lo = mu + sd * rng.uniform(-1.5, 0.0, (q, x.shape[1]))
    hi = lo + sd * rng.uniform(0.3, 2.5, (q, x.shape[1]))
    lo[0, -1] = -1e30                              # an unconstrained target axis
    hi[0, -1] = 1e30
    tgt = rng.integers(0, x.shape[1], q).astype(np.int32)
    ops_ = (np.arange(q) % 3).astype(np.int32)
    return lo, hi, tgt, ops_


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("d", [1, 2])
def test_batch_query_qmc_matches_reference(rng, backend, d):
    x = rng.normal(0, 1, (160, d)).astype(np.float32)
    H = _spd(rng, d, ridge=0.2)
    lo, hi, tgt, ops_ = _boxes(rng, x, 9)
    got = aqp_multid.batch_query_qmc(_t(x), _t(H), lo, hi, tgt, ops_, 12.5,
                                     n_qmc=256, backend=backend)
    want = jmd.batch_query_qmc(jnp.asarray(x), jnp.asarray(H), lo, hi, tgt, ops_,
                               jnp.float32(12.5), n_qmc=256)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-3)
    flat = np.zeros((2, d))
    assert _np(aqp_multid.batch_query_qmc(_t(x), _t(H), flat, flat, tgt[:2],
                                          ops_[:2], 1.0)).tolist() == [0.0, 0.0]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_qmc_subsample_se_matches_reference(rng, backend):
    x = rng.normal(0, 1, (200, 2)).astype(np.float32)
    H = _spd(rng, 2, ridge=0.2)
    lo, hi, tgt, ops_ = _boxes(rng, x, 6)
    got, dof = aqp_ci.qmc_subsample_se(_t(x), _t(H), lo, hi, tgt, ops_, 5000, 256,
                                       backend=backend)
    want, wdof = jci.qmc_subsample_se(jnp.asarray(x), jnp.asarray(H), lo, hi, tgt,
                                      ops_, 5000, 256)
    assert dof == wdof == 7
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    se, dof = aqp_ci.qmc_subsample_se(_t(x[:3]), _t(H), lo, hi, tgt, ops_, 5000, 256)
    assert dof == 1 and np.all(np.isinf(se))


def test_qmc_answers_and_se_match_reference_estimate_and_ci(rng):
    """The one-launch full-H answers and batch-means SE of the "cuda"
    backend (the plain versions on the CPU) against the reference's
    `batch_query_qmc` and `qmc_subsample_se`, and the per-chunk SE against
    the port's own plain chunk passes."""
    x = rng.normal(0, 1, (203, 2)).astype(np.float32)
    H = _spd(rng, 2, ridge=0.2)
    lo, hi, tgt, ops_ = _boxes(rng, x, 9)
    ans, se, dof = aqp_ci.qmc_answers_and_se(_t(x), _t(H), lo, hi, tgt, ops_, 12.5,
                                             5000, 256)
    want = jmd.batch_query_qmc(jnp.asarray(x), jnp.asarray(H), lo, hi, tgt, ops_,
                               jnp.float32(12.5), n_qmc=256)
    np.testing.assert_allclose(_np(ans), np.asarray(want), rtol=1e-4, atol=1e-3)
    want_se, wdof = jci.qmc_subsample_se(jnp.asarray(x), jnp.asarray(H), lo, hi, tgt,
                                         ops_, 5000, 256)
    assert dof == wdof == 7
    np.testing.assert_allclose(se, want_se, rtol=1e-3, atol=1e-3)
    plain, _ = aqp_ci.qmc_subsample_se(_t(x), _t(H), lo, hi, tgt, ops_, 5000, 256,
                                       backend="torch")
    np.testing.assert_allclose(se, plain, rtol=1e-4, atol=1e-6)
    ans3, se3, dof3 = aqp_ci.qmc_answers_and_se(_t(x[:3]), _t(H), lo, hi, tgt, ops_,
                                                12.5, 5000, 256)
    assert dof3 == 1 and np.all(np.isinf(se3)) and np.all(np.isfinite(_np(ans3)))
    flat = np.zeros((2, 2))
    ans0, se0, dof0 = aqp_ci.qmc_answers_and_se(_t(x), _t(H), flat, flat, tgt[:2],
                                                ops_[:2], 12.5, 5000, 256)
    assert _np(ans0).tolist() == [0.0, 0.0] and se0.tolist() == [0.0, 0.0] and dof0 == 7


# --- the RFF synopsis ---------------------------------------------------------------------

def test_mean_cos_matches_reference_on_the_same_draw(rng):
    x = rng.normal(0, 1, (5000, 2)).astype(np.float32)
    w = rng.normal(0, 2, (96, 2)).astype(np.float32)
    b = rng.uniform(0, 2 * np.pi, 96).astype(np.float32)
    got = trff._mean_cos(_t(x), _t(w), _t(b), chunk=1024)
    want = jrff._mean_cos(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), chunk=1024)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def _carried_rff(rng, n=400, d=2, n_features=256):
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    H = _spd(rng, d, ridge=0.2)
    want = jrff.RFFSynopsis.fit(jnp.asarray(x), jnp.asarray(H), n_features=n_features,
                                seed=3)
    arrays, meta = want.to_state()
    got = convert.rff_from_numpy(arrays["w"], arrays["b"], arrays["z"], meta["norm"],
                                 meta["n_fitted"], meta["seed"], device="cpu")
    return x, H, want, got


def test_carried_rff_state_evaluates_as_the_reference(rng):
    x, _H, want, got = _carried_rff(rng)
    pts = rng.normal(0, 1.5, (77, 2)).astype(np.float32)
    np.testing.assert_allclose(_np(got.eval_batch(pts)),
                               np.asarray(want.eval_batch(jnp.asarray(pts))), **RFF_TOL)
    np.testing.assert_allclose(_np(got.block_densities(pts, 8)),
                               np.asarray(want.block_densities(jnp.asarray(pts), 8)),
                               **RFF_TOL)
    assert (got.n_features, got.d, got.seed, got.norm) == \
        (want.n_features, want.d, want.seed, want.norm)
    assert got.nbytes == want.nbytes


def test_rff_fit_is_deterministic_and_round_trips(rng):
    x = rng.normal(0, 1, (300, 2)).astype(np.float32)
    H = _spd(rng, 2, ridge=0.2)
    a = RFFSynopsis.fit(x, H, n_features=128, seed=11, device="cpu")
    b = RFFSynopsis.fit(_t(x), _t(H), n_features=128, seed=11)
    c = RFFSynopsis.fit(x, H, n_features=128, seed=12, device="cpu")
    for k in ("w", "b", "z"):
        assert torch.equal(getattr(a, k), getattr(b, k))
    assert not torch.equal(a.w, c.w)
    assert all(getattr(a, k).is_contiguous() for k in ("w", "b", "z"))   # the launcher needs it
    assert a.n_fitted == a.n_source == 300
    back = RFFSynopsis.from_state(*a.to_state(), device="cpu")
    pts = x[:40]
    assert torch.equal(back.eval_batch(pts), a.eval_batch(pts))
    assert back.error_metadata()["n_features"] == 128
    with pytest.raises(ValueError, match="positive definite"):
        RFFSynopsis.fit(x, np.diag([1.0, -1.0]), seed=0, device="cpu")


def test_registry_and_exact_backend(rng):
    assert available() == ["exact", "rff"]
    x = rng.normal(0, 1, (80, 2)).astype(np.float32)
    H = _spd(rng, 2, ridge=0.2)
    ex = get_backend("exact").fit(_t(x), _t(H))
    np.testing.assert_allclose(_np(ex.eval_batch(x[:9])),
                               np.asarray(jkde.kde_eval_H(jnp.asarray(x[:9]), jnp.asarray(x),
                                                          jnp.asarray(H))), **KDE_TOL)
    back = get_backend("exact").from_state(*ex.to_state(), device="cpu")
    assert torch.equal(back.x, ex.x) and ex.error_metadata()["exact"] is True
    with pytest.raises(KeyError):
        get_backend("warp")


# --- the store: full-H serving ---------------------------------------------------------

CAPACITY = 200
PAIR = ("loss", "latency")


def _stream(seed: int, batches: int = 2, rows: int = 300):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        loss = rng.gamma(2.0, 1.5, rows)
        out.append({"loss": loss.astype(np.float32),
                    "latency": (10 + 3 * loss + rng.normal(0, 2, rows)).astype(np.float32)})
    return out


def _fill(store, stream):
    store.track_joint(PAIR)
    for batch in stream:
        store.add_batch(batch)
    return store


def _specs(m):
    """Range specs on both columns (LSCV_H fits 1-D columns with a 1 x 1 H,
    so these take the qmc path too) and boxes on the joint."""
    return [
        m.AqpQuery("count", (m.Range("loss", 1.0, 4.0),)),
        m.AqpQuery("avg", (m.Range("loss", 0.5, 3.0),)),
        m.AqpQuery("sum", (m.Range("latency", 15.0, 25.0),)),
        m.AqpQuery("count", (m.Box(PAIR, (1.0, 10.0), (4.0, 25.0)),)),
        m.AqpQuery("sum", (m.Box(PAIR, (0.5, 12.0), (3.0, 30.0)),), target="latency"),
        m.AqpQuery("avg", (m.Box(PAIR, (2.0, 0.0), (6.0, 60.0)),), target="loss"),
        m.AqpQuery("count", (m.Box(PAIR, (0.0, 0.0), (0.0, 0.0)),)),
    ]


def _assert_match(got, want, scale, rtol=1e-4):
    assert [g.path for g in got] == [w.path for w in want]
    for g, w in zip(got, want):
        for field in ("estimate", "ci_lo", "ci_hi"):
            np.testing.assert_allclose(getattr(g, field), getattr(w, field), rtol=rtol,
                                       atol=1e-4 * scale, err_msg=f"{g.path} {field}")
        assert (g.synopsis_version, g.n_effective) == (w.synopsis_version, w.n_effective)


@pytest.fixture(scope="module")
def lscv_H_stores():
    """The reference store after an lscv_H query (its fits cached), the
    port's store carried from its snapshot, and the port's own store."""
    stream = _stream(21)
    ref_store = _fill(jstore.TelemetryStore(capacity=CAPACITY, seed=0), stream)
    want = ref_store.query(_specs(jq), selector="lscv_H")
    carried = convert.store_from_state(*ref_store.to_state(), device="cpu")
    own = _fill(tstore.TelemetryStore(capacity=CAPACITY, seed=0, device="cpu"), stream)
    return ref_store, carried, own, want


def test_lscv_H_query_from_carried_fits_matches_reference(lscv_H_stores):
    _, carried, _, want = lscv_H_stores
    assert {w.path for w in want} == {"qmc"}
    misses = carried.cache.stats()["misses"]
    got = carried.query(_specs(tq), selector="lscv_H")
    assert carried.cache.stats()["misses"] == misses    # the LSCV_H fits came along
    _assert_match(got, want, 600 / CAPACITY)
    assert got[-1].estimate == 0.0                       # zero-measure box


@pytest.mark.parametrize("backend,path", [("torch", "qmc"), ("cuda", "qmc:cuda")])
def test_lscv_H_query_on_own_fits_within_reference_ci(lscv_H_stores, backend, path):
    _, _, own, want = lscv_H_stores
    got = own.query(_specs(tq), selector="lscv_H", backend=backend)
    assert {g.path for g in got} == {path}
    for g, w in zip(got, want):
        assert w.ci_lo - 1e-3 <= g.estimate <= w.ci_hi + 1e-3
        assert g.ci_lo <= g.estimate <= g.ci_hi
    again = own.query(_specs(tq), selector="lscv_H", backend=backend)
    assert [r.estimate for r in again] == [r.estimate for r in got]


def _fullh_stores(rng, n, h_scale):
    """Both packages' stores over one joint with the same hand-built full-H
    synopsis cached under selector "lscv_H" (no O(n^2) fit)."""
    loss = rng.gamma(2.0, 1.5, n)
    x = np.stack([loss, 10 + 3 * loss + rng.normal(0, 2, n)], 1).astype(np.float32)
    batch = {"loss": x[:, 0], "latency": x[:, 1]}
    ref_store = jstore.TelemetryStore(capacity=n, seed=0)
    port = tstore.TelemetryStore(capacity=n, seed=0, device="cpu")
    for s in (ref_store, port):
        s.track_joint(PAIR)
        s.add_batch(batch)
    res = ref_store.joints[PAIR]
    xs = res.sample()
    H = (np.cov(xs.T) * h_scale).astype(np.float32)
    ref_store.cache.put(PAIR, "lscv_H", res.version, jaqp.KDESynopsis(
        x=jnp.asarray(xs), H=jnp.asarray(H), n_source=res.n_seen, selector="lscv_H"))
    port.cache.put(PAIR, "lscv_H", res.version, aqp.KDESynopsis(
        x=_t(xs), H=_t(H), n_source=res.n_seen, selector="lscv_H"), backend="torch")
    return ref_store, port, xs


def _pair_boxes(m, x, k=6, seed=3):
    rng = np.random.default_rng(seed)
    mu, sd = x.mean(axis=0), x.std(axis=0)
    out = []
    for i in range(k):
        lo = mu + sd * rng.uniform(-1.5, 0.0, 2)
        hi = lo + sd * rng.uniform(1.0, 2.5, 2)
        out.append(m.AqpQuery(["count", "sum", "avg"][i % 3],
                              (m.Box(PAIR, tuple(lo), tuple(hi)),),
                              target=None if i % 3 == 0 else PAIR[i % 2]))
    return out


def test_rff_answers_from_a_carried_snapshot_match_reference(rng):
    ref_store, _, xs = _fullh_stores(rng, 1500, h_scale=0.4)
    engine = jq.QueryEngine(ref_store, selector="lscv_H", kde_backend="rff")
    want = engine.execute(_pair_boxes(jq, xs))
    assert {w.path for w in want} == {"qmc:rff"}
    carried = convert.store_from_state(*ref_store.to_state(), device="cpu")
    misses = carried.cache.stats()["misses"]
    got = tq.QueryEngine(carried, selector="lscv_H", kde_backend="rff").execute(
        _pair_boxes(tq, xs))
    assert carried.cache.stats()["misses"] == misses     # the RFF fit came along
    _assert_match(got, want, 1.0, rtol=2e-4)
    rff = carried.cache.get(PAIR + ("#rff2048",), "lscv_H",
                            carried.joints[PAIR].version, backend="torch")
    assert isinstance(rff, RFFSynopsis) and not rff.degraded
    assert rff.probe_rel_err <= tq.RFF_GATE_TOL


def test_own_rff_fit_within_its_feature_block_ci_of_exact(rng):
    _, port, xs = _fullh_stores(rng, 2000, h_scale=0.4)
    engine = port.engine(selector="lscv_H")
    queries = _pair_boxes(tq, xs)
    r_exact = engine.execute(queries, kde_backend="exact")
    r_rff = engine.execute(queries, kde_backend="rff")
    assert {r.path for r in r_exact} == {"qmc"}
    assert {r.path for r in r_rff} == {"qmc:rff"}
    scale_ref = max(abs(r.estimate) for r in r_exact)
    for re_, rr in zip(r_exact, r_rff):
        assert rr.ci_lo <= rr.estimate <= rr.ci_hi
        half = max((rr.ci_hi - rr.ci_lo) / 2.0, 0.02 * scale_ref)
        assert abs(rr.estimate - re_.estimate) <= 4.0 * half
    again = engine.execute(queries, kde_backend="rff")
    assert [r.estimate for r in again] == [r.estimate for r in r_rff]


def test_exact_backend_matches_reference_on_the_same_H(rng):
    ref_store, port, xs = _fullh_stores(rng, 1200, h_scale=0.4)
    want = ref_store.engine(selector="lscv_H").execute(_pair_boxes(jq, xs),
                                                       kde_backend="exact")
    got = port.engine(selector="lscv_H").execute(_pair_boxes(tq, xs), kde_backend="exact")
    _assert_match(got, want, 1.0)


def test_exact_pass_on_cuda_is_one_split_launch_per_group_and_matches_reference(
        rng, monkeypatch):
    """On the "cuda" backend (CPU tensors: the plain versions) a full-H
    group takes its estimates and its batch-means CI from one split pass:
    one `qmc_box_reduce_split` call, no other density pass; answers and CI
    bounds match the reference's on the same H."""
    ref_store, port, xs = _fullh_stores(rng, 1200, h_scale=0.4)
    res = port.joints[PAIR]
    port.cache.put(PAIR, "lscv_H", res.version,
                   port.cache.get(PAIR, "lscv_H", res.version, backend="torch"),
                   backend="cuda")
    want = ref_store.engine(selector="lscv_H").execute(_pair_boxes(jq, xs),
                                                       kde_backend="exact")
    calls = {"qmc_box_reduce_split": 0, "qmc_box_reduce": 0}

    def spy(name):
        orig = getattr(ops, name)

        def counted(*a, **k):
            calls[name] += 1
            return orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)

    for name in calls:
        spy(name)
    monkeypatch.setattr(aqp_multid, "kde_eval_H", None)      # no plain density pass
    got = port.engine(selector="lscv_H").execute(_pair_boxes(tq, xs), kde_backend="exact",
                                                 backend="cuda")
    assert calls == {"qmc_box_reduce_split": 1, "qmc_box_reduce": 0}
    assert {g.path for g in got} == {"qmc:cuda"}
    for g, w in zip(got, want):
        for field in ("estimate", "ci_lo", "ci_hi"):
            np.testing.assert_allclose(getattr(g, field), getattr(w, field), rtol=1e-4,
                                       atol=1e-4, err_msg=field)


def test_auto_backend_routes_around_the_crossover(rng, monkeypatch):
    _, port, xs = _fullh_stores(rng, 800, h_scale=0.4)
    queries = _pair_boxes(tq, xs, k=3)
    assert {r.path for r in port.engine(selector="lscv_H").execute(queries)} == {"qmc"}
    assert {r.path for r in port.engine(selector="lscv_H", kde_crossover=800)
            .execute(queries)} == {"qmc:rff"}
    assert {r.path for r in port.engine(selector="lscv_H", kde_crossover=801)
            .execute(queries)} == {"qmc"}
    monkeypatch.setattr(tq, "KDE_CROSSOVER", 100)
    assert {r.path for r in port.engine(selector="lscv_H").execute(queries)} == {"qmc:rff"}
    # a per-query override beats the engine default; unknown names are refused
    forced = dataclasses.replace(queries[0], kde_backend="rff")
    eng = port.engine(selector="lscv_H", kde_backend="exact")
    assert eng.execute([queries[0]])[0].path == "qmc"
    assert eng.execute([forced])[0].path == "qmc:rff"
    with pytest.raises(ValueError):
        dataclasses.replace(queries[0], kde_backend="warp")
    with pytest.raises(ValueError):
        port.engine(selector="lscv_H", kde_backend="warp")


def test_degraded_rff_fit_is_cached_and_answers_on_the_exact_pass(rng):
    """A bandwidth far too narrow for the feature budget trips the probe
    gate: answers stay on the exact pass and the degraded fit is cached, not
    refitted."""
    _, port, xs = _fullh_stores(rng, 1500, h_scale=0.002)
    engine = port.engine(selector="lscv_H", kde_backend="rff")
    queries = _pair_boxes(tq, xs, k=3)
    fits = []
    orig = RFFSynopsis.fit.__func__

    def counting_fit(cls, *a, **k):
        fits.append(1)
        return orig(cls, *a, **k)

    RFFSynopsis.fit = classmethod(counting_fit)
    try:
        r1 = engine.execute(queries)
        r2 = engine.execute(queries)
    finally:
        RFFSynopsis.fit = classmethod(orig)
    assert {r.path for r in r1} == {r.path for r in r2} == {"qmc"}
    assert len(fits) == 1
    rff = port.cache.get(PAIR + ("#rff2048",), "lscv_H", port.joints[PAIR].version,
                         backend="torch")
    assert rff.degraded and rff.probe_rel_err > tq.RFF_GATE_TOL


def test_cache_sizes_rff_entries_by_their_own_nbytes(rng):
    _, port, xs = _fullh_stores(rng, 600, h_scale=0.4)
    before = port.cache.stats()["bytes"]
    port.engine(selector="lscv_H", kde_backend="rff", rff_features=256).execute(
        _pair_boxes(tq, xs, k=2))
    rff = port.cache.get(PAIR + ("#rff256",), "lscv_H", port.joints[PAIR].version,
                         backend="torch")
    assert rff.n_features == 256
    assert port.cache.stats()["bytes"] == before + rff.nbytes == before + 256 * 4 * 4


# --- on the card ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def test_cuda_fullh_kernels_match_plain_versions(cuda_device, rng):
    dev = cuda_device
    ops.reset_launch_counts()
    for n, d, q, m in ((1, 1, 1, 1), (4097, 3, 70, 1000), (3000, 2, 5, 4097)):
        nodes, x, h_inv, ln, lo, hi, tgt = _qmc_inputs(rng, n, d, q, m)
        args = [_t(a).to(dev) for a in (nodes, x, h_inv)] + [float(ln)] + \
            [_t(a).to(dev) for a in (lo, hi)] + [_t(tgt, torch.int32).to(dev)]
        k = ops.qmc_box_reduce(*args)
        p = ref.qmc_box_reduce(*args)
        np.testing.assert_allclose(_np(k[0]), _np(p[0]), **QMC_TOL)
        np.testing.assert_allclose(_np(k[1]), _np(p[1]), **QMC_TOL)
    for m, D, d in ((1, 16, 1), (4097, 2048, 3), (300, 515, 8)):
        p, w, b, z = _rff_inputs(rng, m, D, d)
        args = [_t(a).to(dev) for a in (p, w, b, z * (2.0 / D))]   # a fit's z scale
        np.testing.assert_allclose(_np(ops.rff_density(*args)), _np(ref.rff_density(*args)),
                                   **RFF_TOL)
    for m, n, d in ((1, 1, 1), (4097, 3000, 3), (65, 4097, 16)):
        pts = _t(rng.normal(0, 1, (m, d))).to(dev)
        x = _t(rng.normal(0, 1, (n, d))).to(dev)
        np.testing.assert_allclose(_np(ops.kde_eval(pts, x, 0.6)),
                                   _np(ref.kde_eval(pts, x, 0.6)), **KDE_TOL)
    counts = ops.launch_counts()
    assert (counts["qmc_box_reduce"], counts["rff_density"], counts["kde_eval"]) == (3, 3, 3)


def test_cuda_qmc_split_kernel_matches_plain_version(cuda_device, rng):
    """The split launch against its plain version: nodes fewer than a
    density block holds (m < 512), n not a multiple of a chunk, a split tail,
    d = 1..8, no splits and 16; two launches give the same bits."""
    dev = cuda_device
    ops.reset_launch_counts()
    cases = [(4100, 1, 70, 300, 8), (4097, 3, 256, 4096, 8), (999, 2, 5, 33, 16),
             (3000, 5, 9, 1000, 0)] + [(700 + d, d, 17, 777, 3) for d in range(1, 9)]
    for n, d, q, m, splits in cases:
        nodes, x, h_inv, ln, lo, hi, tgt = _qmc_inputs(rng, n, d, q, m)
        args = [_t(a).to(dev) for a in (nodes, x, h_inv)] + [float(ln)] + \
            [_t(a).to(dev) for a in (lo, hi)] + [_t(tgt, torch.int32).to(dev), splits]
        k = ops.qmc_box_reduce_split(*args)
        p = ref.qmc_box_reduce_split(*args)
        for kk, pp in zip(k, p):
            np.testing.assert_allclose(_np(kk), _np(pp), rtol=QMC_TOL["rtol"],
                                       atol=QMC_TOL["atol"] * max(float(pp.abs().max()), 1.0))
        again = ops.qmc_box_reduce_split(*args)
        assert torch.equal(k[0], again[0]) and torch.equal(k[1], again[1])
    assert ops.launch_counts()["qmc_box_reduce"] == 2 * len(cases)


def test_qmc_box_answers_of_legacy_box_queries_match_reference(rng):
    """The batched full-H answers for the reference's BoxQuery objects (the
    port takes any object with lo, hi, op and target_index())."""
    x = rng.normal(0, 1, (150, 2)).astype(np.float32)
    H = _spd(rng, 2, ridge=0.2)
    qs = [jmd.BoxQuery("count", (-1.0, -0.5), (0.8, 1.5)),
          jmd.BoxQuery("sum", (-2.0, -2.0), (0.0, 1.0), target=1),
          jmd.BoxQuery("avg", (0.0, -1.0), (2.0, 1.0), target=0)]
    got = aqp_multid._qmc_box_answers(
        aqp.KDESynopsis(x=_t(x), H=_t(H), n_source=3000, selector="lscv_H"), qs, n_qmc=256)
    want = jmd._qmc_box_answers(
        jaqp.KDESynopsis(x=jnp.asarray(x), H=jnp.asarray(H), n_source=3000,
                         selector="lscv_H"), qs, n_qmc=256)
    np.testing.assert_allclose(got, want, rtol=1e-4)
