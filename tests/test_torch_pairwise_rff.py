"""PLUGIN's pairwise kernel and the RFF eval kernel as designed for the H100
(`csrc/pairwise_reduce.cu`, `csrc/rff_eval.cu`), checked on the CPU where
their arithmetic and index maps can be: a float32 model of the pairwise
term with the folded constants and ex2.approx.ftz, over the tile walk that
`kernels/pairwise_reduce.py` mirrors (every pair i < j once, for n around
the tile), against the JAX reference's Pallas kernel in interpret mode;
`ops.rff_density_blocks` (the plain version on CPU tensors) against the
reference's `block_densities` and `eval_batch` on carried state; the
"cuda" backend's RFF group pass, with CPU tensors, making one plan and one
`rff_density_blocks` call per group and answering as the reference does;
and the RFF probe gate of both packages on the same sample and H.  On a
machine with a CUDA device, both kernels at their edges and twice on the
same inputs.

Tolerances: the reference tests' rtol 3e-4 (atol max(1e-5, 1e-6 n)) for
the pairwise sums, whose K^(6) terms cancel (the model sums its float32
terms in float64, not in the kernel's order); rtol / atol 2e-5 for the RFF
dots; rtol 2e-4 / atol 1e-4 for engine answers and CI bounds on carried
RFF state, as `tests/test_torch_fullh.py` holds them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aqp_query as jq
from repro.core import kde as jkde
from repro.kernels import ops as jops
from repro.synopses import rff as jrff
from repro_torch import convert
from repro_torch.core import aqp_multid
from repro_torch.core import aqp_query as tq
from repro_torch.core import kde as tkde
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import pairwise_reduce as tpr
from repro_torch.kernels import rff_eval as trff
from repro_torch.kernels import triangle
from repro_torch.synopses import RFFSynopsis

from test_torch_fullh import PAIR, _assert_match, _fullh_stores, _pair_boxes
from test_torch_lscv_kernels import CSRC, F32, _constants, _fmaf, ex2_ftz

RFF_TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np(t):
    return t.detach().cpu().numpy()


def _pair_tol(n):
    return dict(rtol=3e-4, atol=max(1e-5, 1e-6 * n))


# --- pairwise_scaled_ksum: the tile walk and the folded term ---------------------------

def _tile_cases():
    return [(n, tile) for tile in (128, tpr.TILE)
            for n in (2, 3, tile - 1, tile, tile + 1, 3 * tile + 5)]


def _walk(n, tile, blocks=None):
    """(k, the pairs of each block) of a launch over `blocks` = (begin,
    count) of the triangle tiles (None: all of them)."""
    k = tpr.tile_for(n, tile)
    n_tri = (-(-n // k)) * (-(-n // k) + 1) // 2
    begin, count = triangle.block_range(blocks, n_tri)
    return k, [tpr.block_pairs(b, n, k, begin) for b in range(count)]


@pytest.mark.parametrize("n,tile", _tile_cases())
def test_pairwise_tile_walk_covers_every_pair_once(n, tile):
    k, pairs = _walk(n, tile)
    assert k % (32 * tpr.ROWS) == 0 and k <= max(tile, 32 * tpr.ROWS)
    i = torch.cat([p[0] for p in pairs])
    j = torch.cat([p[1] for p in pairs])
    lo, hi = torch.minimum(i, j), torch.maximum(i, j)
    assert bool(torch.all((0 <= lo) & (lo < hi) & (hi < n)))
    assert lo.numel() == n * (n - 1) // 2
    assert torch.unique(lo * n + hi).numel() == lo.numel()


@pytest.mark.parametrize("n,tile", _tile_cases())
def test_pairwise_diagonal_tiles_give_every_row_the_same_count(n, tile):
    """On a diagonal tile every row takes (m - 1) // 2 pairs, or one more:
    no lane idles for half the tile."""
    k, pairs = _walk(n, tile)
    for bx, (i, _) in enumerate(pairs):
        q, l = (int(v) for v in tpr.bx_to_ql(bx))
        if q != l:
            continue
        m = min(k, n - q * k)
        per_row = torch.bincount(i - q * k, minlength=m)
        assert int(per_row.min()) >= (m - 1) // 2 and int(per_row.max()) - int(per_row.min()) <= 1


def pairwise_emulated(x: np.ndarray, g: float, kind: str, tile: int, blocks=None) -> float:
    """pairwise_tiles in float32: x - x[0] scaled by s = sqrt(c) / g, c =
    log2(e) / 2; per pair v = -u^2 (u the scaled difference), 2^v, t^2 =
    v (-1 / c) and the polynomial with its integer coefficients, over the
    pairs each block of the launch over `blocks` adds, each block's sum
    times 1/sqrt(2 pi)."""
    kc = _constants("pairwise_reduce.cu")
    assert kc["kRows"] == tpr.ROWS
    assert abs(kc["kSqrtHalfLog2e"] ** 2 - 0.5 * np.log2(np.e)) < 1e-7
    assert abs(kc["kNegTwoLn2"] * 0.5 * np.log2(np.e) + 1.0) < 1e-7
    s = F32(F32(kc["kSqrtHalfLog2e"]) / F32(g))
    neg_inv_c = F32(kc["kNegTwoLn2"])
    xs = ((x - x[0]).astype(F32) * s).astype(F32)
    _, pairs = _walk(x.shape[0], tile, blocks)
    total = 0.0
    for i, j in pairs:
        d = (xs[i.numpy()] - xs[j.numpy()]).astype(F32)
        v = (d * -d).astype(F32)
        e = ex2_ftz(v).astype(np.float64)
        t2 = (v * neg_inv_c).astype(F32)
        if kind == "k6":
            t = _fmaf(_fmaf((t2 - F32(15)).astype(F32), t2, F32(45)), t2, F32(-15)) * e
        elif kind == "k4":
            t = _fmaf((t2 - F32(6)).astype(F32), t2, F32(3)) * e
        else:
            t = e
        total += float(F32(F32(np.sum(t)) * F32(0.39894228040143267794)))
    return total


@pytest.mark.parametrize("n,tile", [(2, 128), (3, 128), (300, 128), (700, 512), (1541, 512)])
@pytest.mark.parametrize("kind", ["k4", "k6", "gauss"])
def test_pairwise_emulated_matches_reference_kernel(rng, n, tile, kind):
    x = (rng.normal(0, 1, n) * 2.0 + 40.0).astype(F32)      # an offset far above g
    want = float(jops.pairwise_scaled_ksum(jnp.asarray(x), jnp.float32(0.5), kind=kind,
                                           tile=256))
    np.testing.assert_allclose(pairwise_emulated(x, 0.5, kind, tile), want, **_pair_tol(n))


@pytest.mark.parametrize("n,tile", [(3, 128), (700, 128), (1541, 512)])
@pytest.mark.parametrize("world", [2, 3, 4])
def test_pairwise_share_walks_together_cover_every_pair_once(n, tile, world):
    """The walks of the world's shares (`triangle.share`): every pair i < j
    once across them, each block once."""
    k = tpr.tile_for(n, tile)
    n_tri = triangle.n_tri_tiles(-(-n // k))
    walks = [_walk(n, tile, triangle.share(n_tri, r, world))[1] for r in range(world)]
    assert sum(len(w) for w in walks) == n_tri
    i = torch.cat([p[0] for w in walks for p in w])
    j = torch.cat([p[1] for w in walks for p in w])
    lo, hi = torch.minimum(i, j), torch.maximum(i, j)
    assert lo.numel() == n * (n - 1) // 2
    assert torch.unique(lo * n + hi).numel() == lo.numel()


@pytest.mark.parametrize("kind", ["k4", "k6"])
def test_pairwise_emulated_shares_sum_to_reference_kernel(rng, kind):
    n, tile, world = 1541, 512, 4
    x = (rng.normal(0, 1, n) * 2.0 + 40.0).astype(F32)
    want = float(jops.pairwise_scaled_ksum(jnp.asarray(x), jnp.float32(0.5), kind=kind,
                                           tile=256))
    n_tri = triangle.n_tri_tiles(-(-n // tpr.tile_for(n, tile)))
    got = sum(pairwise_emulated(x, 0.5, kind, tile, triangle.share(n_tri, r, world))
              for r in range(world))
    np.testing.assert_allclose(got, want, **_pair_tol(n))


def test_pairwise_share_wrapper_on_cpu_sums_to_the_whole(rng):
    """`ops.pairwise_scaled_ksum(blocks=...)` on a CPU tensor: the plain
    version over the share's pairs; the shares add up to the whole."""
    x = _t(rng.normal(0, 1, 1300))
    g = _t(0.45)
    n_tri = triangle.n_tri_tiles(-(-1300 // tpr.tile_for(1300, 256)))
    whole = float(ops.pairwise_scaled_ksum(x, g, "k6"))
    parts = [float(ops.pairwise_scaled_ksum(x, g, "k6", tile=256,
                                            blocks=triangle.share(n_tri, r, 3)))
             for r in range(3)]
    np.testing.assert_allclose(sum(parts), whole, **_pair_tol(1300))
    assert float(ops.pairwise_scaled_ksum(x, g, "k6", tile=256, blocks=(2, 0))) == 0.0


def test_pairwise_tile_for_keeps_the_small_n_tile_and_refuses_bad_tiles():
    assert [tpr.tile_for(n, tpr.TILE) for n in (1, 2, 100, 129, 300, 10 ** 6)] == \
        [128, 128, 128, 256, 512, 512]
    assert tpr.tile_for(10 ** 6, 1024) == 1024 and tpr.tile_for(10 ** 6, 32) == 128
    for bad in (0, 48, 2048):
        with pytest.raises(ValueError):
            tpr.tile_for(4096, bad)


# --- rff_density_blocks ------------------------------------------------------------------

def _carried(rng, D, d=2, n=500):
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    a0 = rng.normal(0, 0.3, (d, d))
    H = (a0 @ a0.T + 0.2 * np.eye(d)).astype(np.float32)
    want = jrff.RFFSynopsis.fit(jnp.asarray(x), jnp.asarray(H), n_features=D, seed=5)
    arrays, meta = want.to_state()
    got = convert.rff_from_numpy(arrays["w"], arrays["b"], arrays["z"], meta["norm"],
                                 meta["n_fitted"], meta["seed"], device="cpu")
    return want, got


@pytest.mark.parametrize("D", [2048, 2050])
def test_rff_density_blocks_match_reference_blocks_and_estimate(rng, D):
    want, got = _carried(rng, D)
    pts = rng.normal(0, 1.5, (300, 2)).astype(np.float32)
    blocks, est = ops.rff_density_blocks(_t(pts), got.w, got.b, got.z, 8)
    assert blocks.shape == (8, 300) and est.shape == (300,)
    rescale = D / (D // 8)
    np.testing.assert_allclose(_np(got.norm * rescale * blocks),
                               np.asarray(want.block_densities(jnp.asarray(pts), 8)),
                               **RFF_TOL)
    np.testing.assert_allclose(_np(got.norm * est),
                               np.asarray(want.eval_batch(jnp.asarray(pts))), **RFF_TOL)
    f, fb = got.densities_and_blocks(pts, 8)
    assert torch.equal(fb, got.block_densities(pts, 8))
    np.testing.assert_allclose(_np(f), _np(got.eval_batch(pts)), **RFF_TOL)
    # the remainder features are in the estimate only
    rem = ref.rff_density(_t(pts), got.w[8 * (D // 8):], got.b[8 * (D // 8):],
                          got.z[8 * (D // 8):])
    np.testing.assert_allclose(_np(est), _np(blocks.sum(0) + rem), **RFF_TOL)


def test_rff_density_blocks_with_one_block_is_rff_density(rng):
    p, w = _t(rng.normal(0, 1, (77, 3))), _t(rng.normal(0, 2, (515, 3)))
    b, z = _t(rng.uniform(0, 6.28, 515)), _t(rng.normal(0, 1e-3, 515))
    blocks, est = ops.rff_density_blocks(p, w, b, z, 1)
    assert torch.equal(est, ops.rff_density(p, w, b, z)) and torch.equal(blocks[0], est)
    for bad in (0, 516):
        with pytest.raises(ValueError):
            ops.rff_density_blocks(p, w, b, z, bad)


def test_rff_sub_chunks_split_blocks_and_remainder():
    assert trff.n_sub_chunks(2048, 8, 256) == 8
    assert trff.n_sub_chunks(2048, 1, 256) == 8
    assert trff.n_sub_chunks(2050, 8, 256) == 9
    assert trff.n_sub_chunks(515, 8, 32) == 8 * 2 + 1
    assert [trff.record_floats(d) for d in range(1, 9)] == [4, 4, 8, 8, 8, 8, 12, 12]


def test_rff_launcher_refuses_cpu_tensors():
    x = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="must be on a CUDA device"):
        trff.rff_density_blocks(x, x, torch.zeros(4), torch.zeros(4), 2, tile=trff.TILE,
                                threads=trff.THREADS)


# --- the "cuda" backend's RFF group pass ---------------------------------------------------

def test_rff_group_on_cuda_is_one_plan_and_one_launch_and_matches_reference(
        rng, monkeypatch):
    """On the "cuda" backend (CPU tensors: the plain versions) an RFF group
    takes its answers and its feature-block CI from one plan and one
    `rff_density_blocks` call, with no `rff_density` call; answers and CI
    bounds match the reference's on the same carried RFF state."""
    ref_store, _, xs = _fullh_stores(rng, 1500, h_scale=0.4)
    want = jq.QueryEngine(ref_store, selector="lscv_H", kde_backend="rff").execute(
        _pair_boxes(jq, xs))
    assert {w.path for w in want} == {"qmc:rff"}
    carried = convert.store_from_state(*ref_store.to_state(), device="cpu")
    ver = carried.joints[PAIR].version
    rkey = PAIR + ("#rff2048",)
    for key in (PAIR, rkey):
        carried.cache.put(key, "lscv_H", ver,
                          carried.cache.get(key, "lscv_H", ver, backend="torch"),
                          backend="cuda")
    calls = {"rff_density_blocks": 0, "rff_density": 0, "_qmc_plan": 0}

    def spy(owner, name):
        orig = getattr(owner, name)

        def counted(*a, **k):
            calls[name] += 1
            return orig(*a, **k)
        monkeypatch.setattr(owner, name, counted)

    spy(ops, "rff_density_blocks")
    spy(ops, "rff_density")
    spy(aqp_multid, "_qmc_plan")
    misses = carried.cache.stats()["misses"]
    got = tq.QueryEngine(carried, selector="lscv_H", kde_backend="rff").execute(
        _pair_boxes(tq, xs), backend="cuda")
    assert carried.cache.stats()["misses"] == misses
    assert calls == {"rff_density_blocks": 1, "rff_density": 0, "_qmc_plan": 1}
    _assert_match(got, want, 1.0, rtol=2e-4)
    # the "torch" backend keeps its two passes, with the same answers
    again = tq.QueryEngine(carried, selector="lscv_H", kde_backend="rff").execute(
        _pair_boxes(tq, xs))
    assert calls == {"rff_density_blocks": 2, "rff_density": 1, "_qmc_plan": 3}
    _assert_match(again, want, 1.0, rtol=2e-4)


def test_qmc_rff_answers_and_se_match_the_two_pass_form(rng):
    x = rng.normal(0, 1, (600, 2)).astype(np.float32)
    H = np.array([[0.3, 0.05], [0.05, 0.2]], np.float32)
    rff = RFFSynopsis.fit(x, H, n_features=256, seed=4, device="cpu")
    lo = np.array([[-1.0, -1.0], [0.0, -2.0], [0.5, 0.5], [0.0, 0.0]])
    hi = np.array([[1.0, 0.5], [2.0, 1.0], [0.5, 0.5], [0.0, 0.0]])
    tgt, op = np.array([0, 1, 0, 0], np.int32), np.array([0, 1, 2, 0], np.int32)
    ans, se, dof = aqp_multid.qmc_rff_answers_and_se(rff, x, H, lo, hi, tgt, op, 5.0,
                                                     3000, 256)
    want = aqp_multid.batch_query_qmc_rff(x, H, rff, lo, hi, tgt, op, 5.0, n_qmc=256)
    se2, dof2 = aqp_multid.qmc_rff_se(rff, x, H, lo, hi, tgt, op, 3000, 256)
    assert ans.device.type == "cpu" and dof == dof2 == 7
    np.testing.assert_allclose(_np(ans), _np(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(se, se2, rtol=1e-5, atol=1e-6)
    ans0, se0, _ = aqp_multid.qmc_rff_answers_and_se(rff, x, H, lo[2:], hi[2:], tgt[2:],
                                                     op[2:], 5.0, 3000, 256)
    assert _np(ans0).tolist() == [0.0, 0.0] and se0.tolist() == [0.0, 0.0]


# --- the RFF probe gate of both packages on the same sample and H --------------------------

def _telemetry(rng, n):
    """chip_smoke.py's loss, latency_ms, grad_norm columns (one latent
    factor)."""
    latent = rng.normal(0.0, 1.0, n)
    return np.stack([2.0 + 0.5 * latent + rng.normal(0.0, 0.4, n),
                     np.exp(3.0 + 0.3 * latent + rng.normal(0.0, 0.3, n)),
                     1.0 + 0.3 * latent + rng.normal(0.0, 0.5, n)], 1).astype(np.float32)


def probe_errors(x: np.ndarray, H: np.ndarray, seed: int):
    """(reference, port) probe_rel_err of the engine's gate: the mean
    relative density error of a 2 048-feature fit on the first
    RFF_GATE_PROBES sample rows against eq. 6, each package with its own
    fit, draws and kde_eval_H."""
    p = x[:tq.RFF_GATE_PROBES]
    want = jrff.RFFSynopsis.fit(jnp.asarray(x), jnp.asarray(H), n_features=2048, seed=seed)
    fe = np.asarray(jkde.kde_eval_H(jnp.asarray(p), jnp.asarray(x), jnp.asarray(H)),
                    np.float64)
    e_ref = np.mean(np.abs(np.asarray(want.eval_batch(jnp.asarray(p)), np.float64) - fe)) \
        / np.mean(fe)
    got = RFFSynopsis.fit(x, H, n_features=2048, seed=seed, device="cpu")
    fe = _np(tkde.kde_eval_H(_t(p), _t(x), _t(H), device="cpu")).astype(np.float64)
    e_port = np.mean(np.abs(_np(got.eval_batch(p)).astype(np.float64) - fe)) / np.mean(fe)
    return float(e_ref), float(e_port)


@pytest.mark.parametrize("cols,h_mult", [((0,), 1.0), ((1,), 1.0), ((0, 1, 2), 0.25)])
def test_probe_gates_of_both_packages_decide_alike_far_from_the_tolerance(cols, h_mult):
    """The normal-scale H of a 32 768-row sample (chip_smoke's capacity),
    times h_mult, on 4 000 rows: both packages pass the 1-D columns and
    fail the narrowed joint, for three draws each, every error at least
    0.05 from RFF_GATE_TOL."""
    assert jq.RFF_GATE_TOL == tq.RFF_GATE_TOL and jq.RFF_GATE_PROBES == tq.RFF_GATE_PROBES
    x = np.ascontiguousarray(_telemetry(np.random.default_rng(0), 4000)[:, list(cols)])
    d = len(cols)
    H = (h_mult * (4 / (d + 2)) ** (2 / (d + 4)) * 32768 ** (-2 / (d + 4))
         * np.atleast_2d(np.cov(x.T))).astype(np.float32)
    for seed in (1, 2, 3):
        e_ref, e_port = probe_errors(x, H, seed)
        print(f"cols {cols} H x {h_mult} seed {seed}: probe_rel_err reference {e_ref:.4f}, "
              f"port {e_port:.4f}")
        assert (e_ref > tq.RFF_GATE_TOL) == (e_port > tq.RFF_GATE_TOL)
        assert min(abs(e_ref - tq.RFF_GATE_TOL), abs(e_port - tq.RFF_GATE_TOL)) > 0.05


# --- the sources -----------------------------------------------------------------------

def test_pairwise_kernel_keeps_the_polynomials_integer_coefficients():
    """Psi6's terms cancel about 10^4-fold: a coefficient rounded to float
    (a polynomial in v = -u^2 would carry 15c, 45c^2, 15c^3) would move the
    sum by more than its tolerance, so the source keeps 15, 45, 6 and 3."""
    text = (CSRC / "pairwise_reduce.cu").read_text()
    assert "fmaf(fmaf(fmaf(t2 - 15.0f, t2, 45.0f), t2, -15.0f), e, acc)" in text
    assert "fmaf(fmaf(t2 - 6.0f, t2, 3.0f), e, acc)" in text
    assert "ex2_ftz(" in text and not any("fast" in f for f in _build.NVCC_FLAGS)


# --- on the card -----------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def test_cuda_pairwise_ragged_edges_kinds_and_repeats(cuda_device, rng):
    dev = cuda_device
    ops.reset_launch_counts()
    g = torch.tensor(0.4, device=dev)
    cases = [2, 3, 127, 128, 129, 511, 512, 513, 3 * 512 + 5, 4097]
    for n in cases:
        x = _t(rng.normal(0, 1, n) + 30.0).to(dev)
        for kind in ("k4", "k6", "gauss"):
            k1 = ops.pairwise_scaled_ksum(x, g, kind)
            k2 = ops.pairwise_scaled_ksum(x, g, kind)
            assert torch.equal(k1, k2), f"n={n} {kind}: two launches differ"
            np.testing.assert_allclose(float(k1), float(ref.pairwise_scaled_ksum(x, g, kind)),
                                       **_pair_tol(n))
    assert ops.launch_counts()["pairwise_scaled_ksum"] == 2 * 3 * len(cases)


def test_cuda_pairwise_shares_sum_to_the_whole_and_keep_its_bits(cuda_device, rng):
    """A launch over all the tiles given as blocks gives blocks=None's bits;
    the shares of 1-5 ranks add up to the whole; an empty share launches
    nothing."""
    dev = cuda_device
    g = torch.tensor(0.4, device=dev)
    for n, tile in ((129, 128), (4097, 512), (32_768, 512)):
        x = _t(rng.normal(0, 1, n)).to(dev)
        n_tri = triangle.n_tri_tiles(-(-n // tpr.tile_for(n, tile)))
        for kind in ("k4", "k6"):
            whole = ops.pairwise_scaled_ksum(x, g, kind, tile=tile)
            assert torch.equal(whole, ops.pairwise_scaled_ksum(x, g, kind, tile=tile,
                                                               blocks=(0, n_tri)))
            for world in range(1, 6):
                parts = [float(ops.pairwise_scaled_ksum(
                    x, g, kind, tile=tile, blocks=triangle.share(n_tri, r, world)))
                    for r in range(world)]
                np.testing.assert_allclose(sum(parts), float(whole), **_pair_tol(n))
    ops.reset_launch_counts()
    assert float(ops.pairwise_scaled_ksum(x, g, "k4", tile=512, blocks=(3, 0))) == 0.0
    assert ops.launch_counts()["pairwise_scaled_ksum"] == 0


def test_cuda_rff_density_blocks_edges_and_repeats(cuda_device, rng):
    dev = cuda_device
    ops.reset_launch_counts()
    cases = [(1, 16, 1, 1), (4097, 2048, 1, 8), (4097, 2050, 3, 8), (300, 515, 8, 8),
             (513, 64, 2, 64)] + [(700, 300 + d, d, 3) for d in range(1, 9)]
    for m, D, d, nb in cases:
        args = [_t(a).to(dev) for a in (rng.normal(0, 1, (m, d)), rng.normal(0, 3, (D, d)),
                                        rng.uniform(0, 2 * np.pi, D),
                                        rng.normal(0, 1, D) * (2.0 / D))]
        kb, ke = ops.rff_density_blocks(*args, nb)
        pb, pe = ref.rff_density_blocks(*args, nb)
        np.testing.assert_allclose(_np(kb), _np(pb), **RFF_TOL)
        np.testing.assert_allclose(_np(ke), _np(pe), **RFF_TOL)
        kb2, ke2 = ops.rff_density_blocks(*args, nb)
        assert torch.equal(kb, kb2) and torch.equal(ke, ke2)
        if nb == 8 and D == 2048:
            assert torch.equal(ke, ops.rff_density(*args))
    assert ops.launch_counts()["rff_density"] == 2 * len(cases) + 1
