"""The port's kernels: their plain PyTorch versions (`repro_torch.kernels.ref`,
the `ops.py` wrappers' CPU path) against the JAX reference's oracles
(`repro.kernels.ref`) and Pallas kernels in interpret mode (`repro.kernels.ops`),
the Appendix-A tile mapping, the port's kernel contract, and — on a machine
with a CUDA device — each CUDA kernel against its plain version.

Tolerances are `tests/test_kernels.py`'s: rtol 3e-4 (atol max(1e-5, 1e-6 n))
for the pairwise sums, whose K^(6) terms cancel; rtol 1e-4 with atol 1e-5 on
counts and 1e-4 on sums for the AQP kernels (float32 sums over n points in
another order); rtol 1e-3 / atol 1e-3 for sv_matrix (the reference's "mxu"
expansion cancels for close pairs) and for lscv_grid_sums; rtol 5e-4 / atol
1e-4 for gh_fused_sum.  The port's plain versions take the Phi difference
from the tail a pair sits in instead of as an erf difference; the
tolerances hold both ways.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import triangle as jtri
from repro_torch.kernels import gh_fused as tgh
from repro_torch.kernels import lscv_grid as tlg
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pairwise_reduce as tpr
from repro_torch.kernels import sv_precompute as tsv
from repro_torch.kernels.triangle import bx_to_ql, n_tri_tiles, ql_to_bx

KERNELS_DIR = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _pair_tol(n):
    return dict(rtol=3e-4, atol=max(1e-5, 1e-6 * n))


@pytest.fixture()
def cuda_device():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# --- pairwise_scaled_ksum ------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 257, 700])
@pytest.mark.parametrize("kind", ["k4", "k6", "gauss"])
def test_pairwise_plain_matches_reference_oracle(n, kind):
    x = np.random.default_rng(1234 + n).normal(0, 1, n).astype(np.float32)
    got = float(ops.pairwise_scaled_ksum(_t(x), _t(0.4), kind))
    want = float(jref.pairwise_scaled_ksum(jnp.asarray(x), jnp.float32(0.4), kind))
    np.testing.assert_allclose(got, want, **_pair_tol(n))


@pytest.mark.parametrize("n", [65, 257])
@pytest.mark.parametrize("kind", ["k4", "k6"])
def test_pairwise_plain_matches_reference_kernel(n, kind):
    x = np.random.default_rng(99 + n).normal(0, 1, n).astype(np.float32)
    got = float(ref.pairwise_scaled_ksum(_t(x), _t(0.5), kind))
    want = float(jops.pairwise_scaled_ksum(jnp.asarray(x), jnp.float32(0.5),
                                           kind=kind, tile=64))
    np.testing.assert_allclose(got, want, **_pair_tol(n))


# --- aqp_batch_sums --------------------------------------------------------------

def _batch_inputs(rng, n, q):
    x = rng.normal(0, 2, n).astype(np.float32)
    a = rng.uniform(-4, 4, q).astype(np.float32)
    b = a + rng.uniform(0, 3, q).astype(np.float32)
    return x, np.float32(0.5), a, b


def _assert_aqp_close(got, want):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,q", [(1, 1), (17, 3), (64, 16), (500, 257), (300, 1)])
def test_aqp_batch_plain_matches_reference(rng, n, q):
    x, h, a, b = _batch_inputs(rng, n, q)
    got = ops.aqp_batch_sums(_t(x), _t(h), _t(a), _t(b))
    _assert_aqp_close(got, jref.aqp_batch_sums(jnp.asarray(x), jnp.float32(h),
                                               jnp.asarray(a), jnp.asarray(b)))
    _assert_aqp_close(got, jops.aqp_batch_sums(
        jnp.asarray(x), jnp.float32(h), jnp.asarray(a), jnp.asarray(b),
        tile=64, q_tile=16))


def test_aqp_batch_plain_empty_queries(rng):
    x, h, a, b = _batch_inputs(rng, 40, 0)
    cnt, sm = ops.aqp_batch_sums(_t(x), _t(h), _t(a), _t(b))
    assert cnt.shape == (0,) and sm.shape == (0,)


def test_aqp_batch_plain_tightens_tails_against_float64():
    """Far-tail ranges: the erf difference cancels, the tail form does not."""
    from scipy.special import ndtr

    x = np.linspace(-1.0, 1.0, 200).astype(np.float32)
    a = np.asarray([4.0, 6.0, -7.0], np.float32)
    b = np.asarray([5.0, 9.0, -5.5], np.float32)
    h = 0.4
    za = (a[:, None].astype(np.float64) - x[None]) / h
    zb = (b[:, None].astype(np.float64) - x[None]) / h
    want = (ndtr(-za) - ndtr(-zb)).sum(1)        # upper/lower tail, float64
    want[2] = (ndtr(zb[2]) - ndtr(za[2])).sum()
    got = ref.aqp_batch_sums(_t(x), _t(h), _t(a), _t(b))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


# --- aqp_box_sums --------------------------------------------------------------------

def _box_inputs(rng, n, q, d):
    x = rng.normal(0, 1.5, (n, d)).astype(np.float32)
    h = rng.uniform(0.2, 0.8, d).astype(np.float32)
    lo = rng.uniform(-3, 1, (q, d)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 3, (q, d)).astype(np.float32)
    tgt = rng.integers(0, d, q).astype(np.int32)
    return x, h, lo, hi, tgt


@pytest.mark.parametrize("n,q,d", [(1, 1, 1), (17, 3, 2), (65, 17, 1),
                                   (130, 1, 3), (500, 130, 4)])
def test_aqp_boxes_plain_matches_reference(rng, n, q, d):
    x, h, lo, hi, tgt = _box_inputs(rng, n, q, d)
    got = ops.aqp_box_sums(_t(x), _t(h), _t(lo), _t(hi), _t(tgt, torch.int32))
    jargs = (jnp.asarray(x), jnp.asarray(h), jnp.asarray(lo), jnp.asarray(hi),
             jnp.asarray(tgt, jnp.int32))
    _assert_aqp_close(got, jref.aqp_box_sums(*jargs))
    _assert_aqp_close(got, jops.aqp_box_sums(*jargs, tile=64, q_tile=16))


def test_aqp_boxes_plain_empty_queries(rng):
    x, h, lo, hi, tgt = _box_inputs(rng, 30, 0, 2)
    cnt, sm = ops.aqp_box_sums(_t(x), _t(h), _t(lo), _t(hi), _t(tgt, torch.int32))
    assert cnt.shape == (0,) and sm.shape == (0,)


# --- LSCV: sv_matrix, gh_fused_sum, lscv_grid_sums -------------------------------------

SV_TOL = dict(rtol=1e-3, atol=1e-3)
GH_TOL = dict(rtol=5e-4, atol=1e-4)
GRID_TOL = dict(rtol=1e-3, atol=1e-3)


def _spd(rng, d, scale):
    m0 = rng.normal(0, 1, (d, d)).astype(np.float32)
    return (scale * (m0 @ m0.T) + np.eye(d, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("n,d", [(1, 1), (2, 3), (9, 1), (64, 2), (130, 5), (257, 3),
                                 (300, 16)])
@pytest.mark.parametrize("alg", ["paper", "mxu"])
def test_sv_matrix_plain_matches_reference(rng, n, d, alg):
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    m = _spd(rng, d, 0.2)
    got = ops.sv_matrix(_t(x), _t(m), algorithm=alg).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.sv_matrix(jnp.asarray(x), jnp.asarray(m))),
                               **SV_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.sv_matrix(
        jnp.asarray(x), jnp.asarray(m), tile=64, algorithm=alg)), **SV_TOL)
    assert np.all(np.tril(got) == 0.0)


def test_sv_matrix_plain_takes_a_nonsymmetric_m(rng):
    x = rng.normal(0, 1, (70, 3)).astype(np.float32)
    m = rng.normal(0, 1, (3, 3)).astype(np.float32)
    np.testing.assert_allclose(ref.sv_matrix(_t(x), _t(m)).numpy(),
                               np.asarray(jref.sv_matrix(jnp.asarray(x), jnp.asarray(m))),
                               **SV_TOL)


@pytest.mark.parametrize("n,d", [(1, 1), (2, 3), (40, 2), (222, 4), (257, 3), (513, 8)])
def test_gh_fused_plain_matches_reference(rng, n, d):
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    m = _spd(rng, d, 0.1)
    got = float(ops.gh_fused_sum(_t(x), _t(m), 0.31, 0.17))
    np.testing.assert_allclose(got, float(jref.gh_fused_sum(jnp.asarray(x), jnp.asarray(m),
                                                            0.31, 0.17)), **GH_TOL)
    if n >= 2:
        np.testing.assert_allclose(got, float(jops.gh_fused_sum(
            jnp.asarray(x), jnp.asarray(m), 0.31, 0.17, tile=64)), **GH_TOL)


@pytest.mark.parametrize("n,d,n_h", [(1, 1, 3), (2, 2, 4), (100, 2, 5), (257, 3, 13),
                                     (130, 1, 150)])
def test_lscv_grid_plain_matches_reference(rng, n, d, n_h):
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    m = _spd(rng, d, 0.1)
    hg = np.linspace(0.3, 2.0, n_h).astype(np.float32)
    got = ops.lscv_grid_sums(_t(x), _t(m), _t(hg), 0.3, 0.2).numpy()
    want = np.asarray(jref.lscv_grid_sums(jnp.asarray(x), jnp.asarray(m), jnp.asarray(hg),
                                          0.3, 0.2))
    np.testing.assert_allclose(got, want, **GRID_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.lscv_grid_sums(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(hg), 0.3, 0.2, tile=64, h_tile=4)),
        **GRID_TOL)
    # the grid phase alone, over a precomputed S
    s = ops.sv_matrix(_t(x), _t(m))
    np.testing.assert_allclose(ops.lscv_grid_sums_from_s(s, _t(hg), 0.3, 0.2).numpy(),
                               want, **GRID_TOL)


# --- Appendix-A tile mapping ----------------------------------------------------------

def test_triangle_mapping_exhaustive_to_512_tiles():
    n_tri = n_tri_tiles(512)
    bx = torch.arange(n_tri)
    q, l = bx_to_ql(bx)
    assert torch.equal(ql_to_bx(q, l), bx)
    assert bool(torch.all((q >= 0) & (q <= l) & (l < 512)))
    jq, jl = jtri.bx_to_ql(jnp.arange(n_tri, dtype=jnp.int32))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))


@pytest.mark.parametrize("n_tiles", [1, 2, 3, 128, 512])
def test_n_tri_tiles_matches_reference(n_tiles):
    assert n_tri_tiles(n_tiles) == jtri.n_tri_tiles(n_tiles)


# --- the port's kernel contract -------------------------------------------------------

def _launcher_modules():
    return sorted(p for p in KERNELS_DIR.glob("*.py")
                  if "_build.load(" in p.read_text() and not p.name.startswith("_"))


def test_every_kernel_module_has_source_wrapper_plain_version_and_counter():
    ops_defs = {n.name for n in ast.parse((KERNELS_DIR / "ops.py").read_text()).body
                if isinstance(n, ast.FunctionDef)}
    ref_defs = {n.name for n in ast.parse((KERNELS_DIR / "ref.py").read_text()).body
                if isinstance(n, ast.FunctionDef)}
    mods = _launcher_modules()
    assert {m.stem for m in mods} == {"pairwise_reduce", "aqp_batch", "aqp_boxes",
                                      "sv_precompute", "lscv_grid", "gh_fused",
                                      "aqp_grouped", "qmc_reduce", "rff_eval",
                                      "kde_eval"}
    for mod in mods:
        text = mod.read_text()
        assert (KERNELS_DIR / "csrc" / f"{mod.stem}.cu").exists(), mod.name
        tree = ast.parse(text)
        public = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                  and not n.name.startswith("_") and "ptr(" in ast.unparse(n)
                  and "launches.inc()" in ast.unparse(n)]
        assert public, f"{mod.name}: no launching function counts its launches"
        counters = [n for n in tree.body if isinstance(n, ast.Assign)
                    and ast.unparse(n.value).startswith("LaunchCounter(")]
        assert counters, f"{mod.name}: no LaunchCounter"
        for fn in public:
            assert fn.name in ops_defs, f"{fn.name}: no ops.py wrapper"
            assert fn.name in ref_defs, f"{fn.name}: no ref.py plain version"
            args = fn.args.args
            defaults = dict(zip([a.arg for a in args[len(args) - len(fn.args.defaults):]],
                                fn.args.defaults))
            for a in args:
                if a.arg.endswith("tile"):
                    assert a.arg not in defaults, f"{fn.name}: {a.arg} has a default"


def test_wrappers_take_plain_version_on_cpu_and_count_nothing(rng):
    ops.reset_launch_counts()
    x, h, a, b = _batch_inputs(rng, 50, 4)
    ops.aqp_batch_sums(_t(x), _t(h), _t(a), _t(b))
    ops.pairwise_scaled_ksum(_t(x), _t(0.4), "k6")
    xd, m = _t(x.reshape(25, 2)), torch.eye(2)
    ops.sv_matrix(xd, m)
    ops.gh_fused_sum(xd, m, 0.3, 0.2)
    ops.lscv_grid_sums(xd, m, _t([0.5, 1.0]), 0.3, 0.2)
    ops.aqp_grouped_sums(xd, _t([0.5, 0.5]), _t([-1, -1]), _t([1, 1]), _t([0.0, 1.0]),
                         _t([0.5, 1.5]), 1, 0)
    ops.qmc_box_reduce(xd, xd, m, -1.0, _t([[-1, -1]]), _t([[1, 1]]),
                       _t([0], torch.int32))
    ops.rff_density(xd, m, _t([0.1, 0.2]), _t([0.5, 0.5]))
    ops.kde_eval(xd, xd, 0.5)
    assert ops.launch_counts() == {"pairwise_scaled_ksum": 0, "aqp_batch_sums": 0,
                                   "aqp_box_sums": 0, "sv_matrix": 0,
                                   "lscv_grid_sums": 0, "gh_fused_sum": 0,
                                   "aqp_grouped_sums": 0, "qmc_box_reduce": 0,
                                   "rff_density": 0, "kde_eval": 0}


@pytest.mark.parametrize("bad", ["cpu", "float64", "2d"])
def test_launchers_refuse_what_the_kernel_does_not_take(bad):
    x = torch.zeros(8, dtype=torch.float64 if bad == "float64" else torch.float32)
    if bad == "2d":
        x = x.reshape(2, 4)
    with pytest.raises((ValueError, TypeError)):
        tpr.pairwise_scaled_ksum(x, torch.tensor([0.5]), "k4", tile=256)


@pytest.mark.parametrize("call", ["sv_cpu", "sv_d17", "sv_algorithm", "gh_d9",
                                  "gh_float64", "grid_not_square", "grid_cpu"])
def test_lscv_launchers_refuse_what_the_kernel_does_not_take(call):
    with pytest.raises((ValueError, TypeError)):
        if call == "sv_cpu":
            tsv.sv_matrix(torch.zeros(4, 2), torch.eye(2), tile=256)
        elif call == "sv_d17":
            tsv.sv_matrix(torch.zeros(4, 17), torch.eye(17), tile=256)
        elif call == "sv_algorithm":
            ops.sv_matrix(torch.zeros(4, 2), torch.eye(2), algorithm="tf32")
        elif call == "gh_d9":
            tgh.gh_fused_sum(torch.zeros(4, 9), torch.eye(9), 0.3, 0.2, tile=256)
        elif call == "gh_float64":
            tgh.gh_fused_sum(torch.zeros(4, 2, dtype=torch.float64), torch.eye(2),
                             0.3, 0.2, tile=256)
        elif call == "grid_not_square":
            tlg.lscv_grid_sums_from_s(torch.zeros(4, 5), torch.ones(3), 0.3, 0.2,
                                      h_tile=256)
        else:
            tlg.lscv_grid_sums_from_s(torch.zeros(4, 4), torch.ones(3), 0.3, 0.2,
                                      h_tile=256)


@pytest.mark.parametrize("call", ["grouped_cpu", "qmc_cpu", "rff_cpu", "kde_cpu",
                                  "kde_empty_sample"])
def test_fullh_and_grouped_launchers_refuse_what_the_kernel_does_not_take(call):
    """The launchers take CUDA tensors only: the wrappers in ops.py hand CPU
    tensors to the plain versions, and nothing falls back."""
    from repro_torch.kernels import aqp_grouped, kde_eval, qmc_reduce, rff_eval

    x, v, g = torch.zeros(8, 2), torch.zeros(2), torch.zeros(3)
    with pytest.raises((ValueError, TypeError)):
        if call == "grouped_cpu":
            aqp_grouped.aqp_grouped_sums(x, v, v, v, g, g, 0, 1, tile=128)
        elif call == "qmc_cpu":
            qmc_reduce.qmc_box_reduce(x, x, torch.eye(2), 0.0, x[:1], x[:1],
                                      torch.zeros(1, dtype=torch.int32), tile=1024,
                                      m_tile=256)
        elif call == "rff_cpu":
            rff_eval.rff_density(x, x, torch.zeros(8),
                                 torch.zeros(8), tile=256, threads=256)
        elif call == "kde_cpu":
            kde_eval.kde_eval(x, x, 0.5, tile=kde_eval.TILE)
        else:
            kde_eval.kde_eval(x, torch.zeros(0, 2), 0.5, tile=kde_eval.TILE)


# --- on the card -----------------------------------------------------------------------

def test_cuda_kernels_match_plain_versions(cuda_device, rng):
    dev = cuda_device
    ops.reset_launch_counts()
    for n in (1, 300, 4097):
        x = _t(rng.normal(0, 1, n).astype(np.float32)).to(dev)
        g = torch.tensor(0.4, device=dev)
        for kind in ("k4", "k6", "gauss"):
            np.testing.assert_allclose(float(ops.pairwise_scaled_ksum(x, g, kind)),
                                       float(ref.pairwise_scaled_ksum(x, g, kind)),
                                       **_pair_tol(n))
    for n, q in ((1, 1), (4097, 3), (1000, 300)):
        args = [_t(v).to(dev) for v in _batch_inputs(rng, n, q)]
        _assert_aqp_close([t.cpu() for t in ops.aqp_batch_sums(*args)],
                          [t.cpu() for t in ref.aqp_batch_sums(*args)])
    for n, q, d in ((1, 1, 1), (4097, 5, 2), (1000, 200, 3)):
        x, h, lo, hi, tgt = _box_inputs(rng, n, q, d)
        args = [_t(v).to(dev) for v in (x, h, lo, hi)] + [_t(tgt, torch.int32).to(dev)]
        _assert_aqp_close([t.cpu() for t in ops.aqp_box_sums(*args)],
                          [t.cpu() for t in ref.aqp_box_sums(*args)])
    counts = ops.launch_counts()
    assert counts == {"pairwise_scaled_ksum": 6, "aqp_batch_sums": 3,
                      "aqp_box_sums": 3, "sv_matrix": 0, "lscv_grid_sums": 0,
                      "gh_fused_sum": 0, "aqp_grouped_sums": 0, "qmc_box_reduce": 0,
                      "rff_density": 0, "kde_eval": 0}
    q_t, l_t = tpr.triangle_map(n_tri_tiles(512), dev)
    q_c, l_c = bx_to_ql(torch.arange(n_tri_tiles(512)))
    assert torch.equal(q_t.cpu().long(), q_c) and torch.equal(l_t.cpu().long(), l_c)


def test_cuda_lscv_kernels_match_plain_versions(cuda_device, rng):
    dev = cuda_device
    ops.reset_launch_counts()
    for n, d in ((1, 1), (2, 3), (300, 16), (4097, 3)):
        x = _t(rng.normal(0, 1, (n, d)).astype(np.float32)).to(dev)
        m = _t(_spd(rng, d, 0.2)).to(dev)
        for alg in ("paper", "mxu"):
            np.testing.assert_allclose(ops.sv_matrix(x, m, tile=64, algorithm=alg).cpu(),
                                       ref.sv_matrix(x, m).cpu(), **SV_TOL)
    for n, d in ((2, 1), (513, 8), (4097, 3)):
        x = _t(rng.normal(0, 1, (n, d)).astype(np.float32)).to(dev)
        m = _t(_spd(rng, d, 0.1)).to(dev)
        np.testing.assert_allclose(float(ops.gh_fused_sum(x, m, 0.31, 0.17, tile=64)),
                                   float(ref.gh_fused_sum(x, m, 0.31, 0.17)), **GH_TOL)
    for n, d, n_h in ((1, 1, 3), (257, 3, 13), (4097, 2, 150)):
        x = _t(rng.normal(0, 1, (n, d)).astype(np.float32)).to(dev)
        m = _t(_spd(rng, d, 0.1)).to(dev)
        hg = torch.linspace(0.3, 2.0, n_h, device=dev)
        np.testing.assert_allclose(ops.lscv_grid_sums(x, m, hg, 0.3, 0.2).cpu(),
                                   ref.lscv_grid_sums(x, m, hg, 0.3, 0.2).cpu(), **GRID_TOL)
    counts = ops.launch_counts()
    # sv_matrix: 4 shapes x 2 algorithms, and once inside each lscv_grid_sums
    assert (counts["sv_matrix"], counts["gh_fused_sum"], counts["lscv_grid_sums"]) == \
        (8 + 3, 3, 3)
