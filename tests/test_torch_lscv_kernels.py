"""The two LSCV kernels of the port as designed for the H100
(`csrc/gh_fused.cu`, `csrc/lscv_grid.cu`), checked on the CPU where their
arithmetic and index maps can be: the polynomial 2^x of lscv_grid.cu read
from its source and emulated in float32, the gh_fused tile walk mirrored
in `kernels/gh_fused.py`, both kernels' sums emulated in float32 against
the JAX reference (`repro.kernels.ref`), and the launchers' argument checks.
On a machine with a CUDA device, the kernels themselves at their ragged
edges and twice on the same inputs.

Tolerances: 2 ulp for the polynomial (a degree-6 minimax, 0.93 ulp of
approximation and rounding error); the reference tests' rtol 5e-4 / atol
1e-4 for gh_fused_sum and rtol 1e-3 / atol 1e-3 for lscv_grid_sums.  fmaf
is emulated as the float64 sum of an exact float64 product rounded once to
float32, which can differ from a fused float32 rounding by one ulp in rare
double-rounding cases; the 2-ulp bound leaves room for that.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import gh_fused as tgh
from repro_torch.kernels import lscv_grid as tlg
from repro_torch.kernels._launch import scalar_arg
from repro_torch.kernels.triangle import bx_to_ql

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
GH_TOL = dict(rtol=5e-4, atol=1e-4)
GRID_TOL = dict(rtol=1e-3, atol=1e-3)
F32 = np.float32


def _constants(fname: str) -> dict:
    """`constexpr float|int NAME = VALUE[f];` lines of a CUDA source."""
    text = (CSRC / fname).read_text()
    return {m.group(2): (float if m.group(1) == "float" else int)(m.group(3))
            for m in re.finditer(r"constexpr (float|int) (k\w+) = ([-+0-9.eE]+)f?;", text)}


def _poly_block() -> dict:
    text = (CSRC / "lscv_grid.cu").read_text()
    block = text[text.index("// BEGIN EXP2_POLY"):text.index("// END EXP2_POLY")]
    return {m.group(1): F32(m.group(2))
            for m in re.finditer(r"constexpr float (k\w+) = ([-+0-9.eE]+)f;", block)}


def _fmaf(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(F32)


def exp2_poly(x: np.ndarray) -> np.ndarray:
    """lscv_grid.cu's exp2_poly, step by step in float32 / int32."""
    k = _poly_block()
    coefs = [k[f"kExp2P{i}"] for i in range(7)]
    x = np.asarray(x, F32)
    with np.errstate(invalid="ignore", over="ignore"):
        t = (x + k["kExp2Magic"]).astype(F32)
        f = (x - (t - k["kExp2Magic"]).astype(F32)).astype(F32)
        p = np.full_like(f, coefs[6])
        for c in coefs[5::-1]:
            p = _fmaf(p, f, F32(c))
    bits = (p.view(np.int32).astype(np.int64) + (t.view(np.int32).astype(np.int64) << 23))
    r = (bits & 0xFFFFFFFF).astype(np.uint32).view(F32)
    return np.where(x >= F32(-126.0), r, np.where(x < F32(-126.0), F32(0.0), x))


def ex2_ftz(x: np.ndarray) -> np.ndarray:
    """ex2.approx.ftz.f32, modelled as the correctly rounded 2^x with
    results below 2^-126 flushed to +0."""
    with np.errstate(over="ignore"):
        r = np.exp2(np.asarray(x, np.float64)).astype(F32)
    return np.where(r < F32(2.0 ** -126), F32(0.0), r)


# --- (a) the polynomial 2^x ------------------------------------------------------------

def test_exp2_poly_within_2_ulp_where_normal_and_zero_below_minus_126():
    ints = np.arange(-150, 1, dtype=F32)
    x = np.concatenate([np.linspace(-150, 0, 1_500_001, dtype=F32), ints,
                        ints + F32(0.5), ints - F32(0.5)])
    got = exp2_poly(x)
    normal = x >= F32(-126.0)
    want = np.exp2(x[normal].astype(np.float64))
    ulp = np.spacing(want.astype(F32)).astype(np.float64)
    err = np.abs(got[normal].astype(np.float64) - want) / ulp
    assert err.max() <= 2.0, f"max {err.max():.3f} ulp at x={x[normal][err.argmax()]}"
    assert np.all(got[~normal] == 0.0)
    assert np.all(exp2_poly(np.array([-np.inf, -1e30, -126.5], F32)) == 0.0)
    # a power of two is exact: the polynomial's constant term is 1
    assert np.array_equal(exp2_poly(ints[ints >= -126]),
                          np.exp2(ints[ints >= -126].astype(np.float64)).astype(F32))


def test_exp2_poly_keeps_a_nan():
    """A NaN argument comes back as NaN, as from ex2.approx.ftz (the bits
    of a NaN shifted into the exponent would give a finite value)."""
    got = exp2_poly(np.array([np.nan, -np.nan, 0.0], F32))
    assert np.isnan(got[:2]).all() and got[2] == 1.0
    text = (CSRC / "lscv_grid.cu").read_text()
    assert "return x >= -126.0f ? r : (x < -126.0f ? 0.0f : x);" in text


def test_polynomial_share_is_fixed_by_position_and_within_the_measured_range():
    k = _constants("lscv_grid.cu")
    share = k["kPolyTerms"] / (4 * k["kGroup"])
    assert 1 / 8 <= share <= 1 / 3 and share == tlg.POLY_SHARE
    assert k["kGridTile"] == tlg.TILE


# --- (b) the gh_fused tile walk --------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 257, 1000, 4097])
@pytest.mark.parametrize("tile", [32, 128, 256, tgh.TILE, 1024])
def test_gh_tile_walk_covers_every_pair_once(n, tile):
    k, threads, n_tri = tgh.tile_shape(n, tile)
    assert k == tgh.ROWS * threads and threads % 32 == 0
    assert n_tri == (-(-n // k)) * (-(-n // k) + 1) // 2
    pairs = [tgh.block_pairs(bx, n, k) for bx in range(n_tri)]
    i = torch.cat([p[0] for p in pairs]) if pairs else torch.zeros(0, dtype=torch.int64)
    j = torch.cat([p[1] for p in pairs]) if pairs else torch.zeros(0, dtype=torch.int64)
    assert bool(torch.all((0 <= i) & (i < j) & (j < n)))
    assert i.numel() == n * (n - 1) // 2
    assert torch.unique(i * n + j).numel() == i.numel()


@pytest.mark.parametrize("tile", [32, 64, 128, 512, 1024])
def test_gh_tile_shape_rounds_the_tile_up_to_one_warp_of_rows(tile):
    k, threads, _ = tgh.tile_shape(10 ** 6, tile)
    assert (k, threads) == {32: (128, 32), 64: (128, 32), 128: (128, 32),
                            512: (512, 128), 1024: (1024, 256)}[tile]


# --- both kernels' arithmetic, emulated, against the JAX reference ---------------------

def _scaled_coefs(m: np.ndarray) -> list:
    d = m.shape[0]
    out = []
    for a in range(d):
        for b in range(a, d):
            mab = m[a, a] if a == b else F32(m[a, b] + m[b, a])
            out.append(F32(F32(-0.36067376022224085) * mab))
    return out


def gh_fused_emulated(x: np.ndarray, m: np.ndarray, c_k: float, c_kk: float,
                      tile: int) -> float:
    """gh_tiles' terms in float32 (the folded quadratic form of the
    difference, ex2, T_H by two fmaf) over the pairs each block adds."""
    n, d = x.shape
    k, _, n_tri = tgh.tile_shape(n, tile)
    c = _scaled_coefs(m)
    m2ck, ckk = F32(-2.0 * F32(c_k)), F32(c_kk)
    total = 0.0
    for bx in range(n_tri):
        i, j = (t.numpy() for t in tgh.block_pairs(bx, n, k))
        v = (x[i] - x[j]).astype(F32)
        s = np.zeros(len(i), F32)
        e = 0
        for a in range(d):
            w = (c[e] * v[:, a]).astype(F32)
            e += 1
            for b in range(a + 1, d):
                w = _fmaf(np.full_like(w, c[e]), v[:, b], w)
                e += 1
            s = _fmaf(v[:, a], w, s)
        e4 = ex2_ftz(s)
        total += float(np.sum(_fmaf(e4, _fmaf(np.full_like(e4, m2ck), e4, ckk), F32(0.0)),
                              dtype=np.float64))
    return total


@pytest.mark.parametrize("n,d,tile", [(2, 1, 512), (45, 3, 32), (200, 2, 64),
                                      (300, 3, 128), (130, 8, 64)])
def test_gh_fused_emulated_matches_reference(rng, n, d, tile):
    x = rng.normal(0, 1, (n, d)).astype(F32)
    m0 = rng.normal(0, 1, (d, d)).astype(F32)
    m = (0.1 * (m0 @ m0.T) + np.eye(d, dtype=F32)).astype(F32)
    want = float(jref.gh_fused_sum(jnp.asarray(x), jnp.asarray(m), 0.31, 0.17))
    np.testing.assert_allclose(gh_fused_emulated(x, m, 0.31, 0.17, tile), want, **GH_TOL)


def lscv_grid_emulated(s_mat: np.ndarray, h_grid: np.ndarray, c_k: float,
                       c_kk: float) -> np.ndarray:
    """lscv_grid_tiles in float32: +inf outside the strict upper triangle,
    the term at group g, lane L on the polynomial when
    (3 - L) * kGroup + g < kPolyTerms, four lane sums per (tile, h)."""
    kc = _constants("lscv_grid.cu")
    tile, group, poly = kc["kGridTile"], kc["kGroup"], kc["kPolyTerms"]
    n = s_mat.shape[0]
    nt = -(-n // tile)
    lane = np.arange(tile * tile) % 4
    g = (np.arange(tile * tile) // 4) % group
    on_poly = (3 - lane) * group + g < poly
    a_h = (F32(-0.25 * np.log2(np.e)) / (h_grid * h_grid).astype(F32)).astype(F32)
    m2ck, ckk = F32(-2.0 * F32(c_k)), F32(c_kk)
    out = np.zeros(len(h_grid))
    for bx in range(nt * (nt + 1) // 2):
        q, l = (int(v) for v in bx_to_ql(bx))
        ii = q * tile + np.arange(tile)[:, None]
        jj = l * tile + np.arange(tile)[None]
        ok = (ii < jj) & (jj < n)
        blk = np.full((tile, tile), np.inf, F32)
        blk[ok] = s_mat[np.minimum(ii, n - 1), np.minimum(jj, n - 1)][ok]
        blk = blk.reshape(-1)
        for h, a in enumerate(a_h):
            arg = (blk * a).astype(F32)
            e4 = np.where(on_poly, exp2_poly(arg), ex2_ftz(arg))
            terms = _fmaf(e4, _fmaf(np.full_like(e4, m2ck), e4, ckk), F32(0.0))
            lanes = [np.sum(terms[lane == L], dtype=np.float64) for L in range(4)]
            out[h] += (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    return out


@pytest.mark.parametrize("n,d,n_h", [(1, 1, 3), (64, 2, 4), (130, 3, 5), (200, 1, 7)])
def test_lscv_grid_emulated_matches_reference(rng, n, d, n_h):
    x = rng.normal(0, 1, (n, d)).astype(F32)
    m0 = rng.normal(0, 1, (d, d)).astype(F32)
    m = (0.1 * (m0 @ m0.T) + np.eye(d, dtype=F32)).astype(F32)
    hg = np.linspace(0.05, 2.0, n_h).astype(F32)
    want = np.asarray(jref.lscv_grid_sums(jnp.asarray(x), jnp.asarray(m), jnp.asarray(hg),
                                          0.3, 0.2))
    s_mat = ref.sv_matrix(torch.as_tensor(x), torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(lscv_grid_emulated(s_mat, hg, 0.3, 0.2), want, **GRID_TOL)


# --- (c) argument checks before any launch, (d) the sources' contract ------------------

@pytest.mark.parametrize("bad,err", [(torch.ones(2), ValueError), ("0.3", TypeError),
                                     (True, TypeError), (None, TypeError)])
def test_scalar_arg_refuses_what_the_kernels_do_not_take(bad, err):
    with pytest.raises(err):
        scalar_arg(bad, "c_k", torch.device("cpu"))


def test_scalar_arg_gives_a_0d_float32_tensor_on_the_device():
    cpu = torch.device("cpu")
    for value, want in ((0.25, 0.25), (np.float32(0.5), 0.5), (3, 3.0)):
        got = scalar_arg(value, "c_k", cpu)
        assert got.dtype == torch.float32 and got.shape == () and float(got) == want
    t = torch.tensor(0.3)
    assert scalar_arg(t, "c_k", t.device).data_ptr() == t.data_ptr()
    got = scalar_arg(torch.tensor([0.3], dtype=torch.float64), "c_k", t.device)
    assert got.dtype == torch.float32 and got.shape == ()


@pytest.mark.parametrize("tile", [0, 48, 2048, 100])
def test_tile_shape_refuses_tiles_the_kernel_cannot_take(tile):
    with pytest.raises(ValueError):
        tgh.tile_shape(4096, tile)


@pytest.mark.parametrize("call", ["gh", "grid"])
def test_redesigned_launchers_refuse_cpu_tensors(call):
    """The launchers take CUDA tensors only; ops.py hands CPU tensors to
    the plain versions, and nothing falls back."""
    with pytest.raises(ValueError, match="must be on a CUDA device"):
        if call == "gh":
            tgh.gh_fused_sum(torch.zeros(40, 3), torch.eye(3), 0.3, 0.2, tile=tgh.TILE)
        else:
            tlg.lscv_grid_sums_from_s(torch.zeros(4, 4), torch.ones(3), 0.3, 0.2,
                                      h_tile=tlg.H_TILE)


@pytest.mark.parametrize("fname", ["gh_fused.cu", "lscv_grid.cu"])
def test_redesigned_sources_carry_their_note_and_no_switch(fname):
    text = (CSRC / fname).read_text()
    assert "Replaces the TPU kernel repro/kernels/" in text
    assert "Bound on the H100" in text and "What the design does about it" in text
    assert "ex2_ftz(" in text and "exp2f(" not in text
    assert "getenv" not in text and "#ifdef" not in text and "#ifndef" not in text


def test_ftz_stays_local_to_the_two_kernels():
    assert not any("ftz" in f for f in _build.NVCC_FLAGS)
    users = sorted(p.name for p in CSRC.glob("*.cu") if "ex2_ftz(" in p.read_text())
    assert users == ["gh_fused.cu", "lscv_grid.cu"]


def test_cpu_wrappers_still_take_the_plain_versions(rng):
    x = torch.as_tensor(rng.normal(0, 1, (30, 2)).astype(F32))
    ops.reset_launch_counts()
    ck, ckk = torch.tensor(0.31), torch.tensor(0.17)
    got = ops.gh_fused_sum(x, torch.eye(2), ck, ckk)
    assert torch.equal(got, ref.gh_fused_sum(x, torch.eye(2), ck, ckk))
    assert ops.launch_counts()["gh_fused_sum"] == 0


# --- on the card -----------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def test_cuda_gh_fused_ragged_edges_all_d_and_repeats(cuda_device, rng):
    dev = cuda_device
    for d in range(1, 9):
        for n, tile in ((2, 512), (33, 512), (513, 512), (1000, 128), (700, 64), (97, 32)):
            x = torch.as_tensor(rng.normal(0, 1, (n, d)).astype(F32), device=dev)
            m0 = rng.normal(0, 1, (d, d))
            m = torch.as_tensor((0.1 * m0 @ m0.T + np.eye(d)).astype(F32), device=dev)
            ck, ckk = torch.tensor(0.31, device=dev), 0.17
            k1 = ops.gh_fused_sum(x, m, ck, ckk, tile=tile)
            k2 = ops.gh_fused_sum(x, m, ck, ckk, tile=tile)
            assert torch.equal(k1, k2), f"n={n} d={d}: two launches differ"
            np.testing.assert_allclose(float(k1), float(ref.gh_fused_sum(x, m, 0.31, ckk)),
                                       **GH_TOL)


def test_cuda_lscv_grid_ragged_edges_and_repeats(cuda_device, rng):
    dev = cuda_device
    for n, d, n_h in ((1, 1, 3), (65, 2, 33), (1001, 3, 150), (1024, 1, 150), (4100, 2, 7)):
        x = torch.as_tensor(rng.normal(0, 1, (n, d)).astype(F32), device=dev)
        m = torch.eye(d, device=dev)
        hg = torch.linspace(0.05, 2.0, n_h, device=dev)
        s = ops.sv_matrix(x, m)
        k1 = ops.lscv_grid_sums_from_s(s, hg, 0.3, torch.tensor(0.2, device=dev))
        k2 = ops.lscv_grid_sums_from_s(s, hg, 0.3, torch.tensor(0.2, device=dev))
        assert torch.equal(k1, k2), f"n={n}: two launches differ"
        np.testing.assert_allclose(k1.cpu(), ref.lscv_grid_sums_from_s(s, hg, 0.3, 0.2).cpu(),
                                   **GRID_TOL)
