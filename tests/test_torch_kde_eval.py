"""The direct KDE kernel of the port as designed for the H100
(`csrc/kde_eval.cu`, launcher `kernels/kde_eval.py`), checked on the CPU
where its arithmetic and its partition can be: a float32 model of the
kernel (the warps' point tiles, the lanes' strided rows, the fixed shuffle
tree, the float64 second pass and the normalisation applied there, with the
points per warp and the row ranges read from the launcher) against the
plain version `ref.kde_eval` and the JAX package's Pallas kernel in
interpret mode; the cut of the grid (every row in one range, every point in
one tile, within two waves of resident blocks on 132 SMs); and the folded
exponent against float64 on data far from 0.  On a machine with a CUDA
device, the kernel itself: one launch a call, two launches bit-equal, edge
shapes, and data far from 0 against float64.

Tolerance: the reference's for kde_eval (`tests/test_kernels.py`), rtol
5e-4 / atol 1e-7 (float32 sums in another order).  The model takes fmaf as
the float64 sum of an exact float64 product rounded once to float32 and
ex2.approx as exp2 correctly rounded (the card's is within 2 ulp), so it
stands for the kernel within that tolerance, not bit for bit.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import kde_eval as tkde
from repro_torch.kernels import ops, ref
from repro_torch.kernels._launch import GRID_Y_MAX

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
KDE_TOL = dict(rtol=5e-4, atol=1e-7)
F32 = np.float32
SMS = 132                     # H100 SXM
BPS = 8                       # resident 256-thread blocks an SM holds at <= 32 registers


def _source() -> dict:
    text = (CSRC / "kde_eval.cu").read_text()
    return {m.group(2): (float if m.group(1) == "float" else int)(m.group(3))
            for m in re.finditer(r"constexpr (float|int) (k\w+) = ([-+0-9.eE]+)f?;", text)}


def _fma(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _scale(h) -> F32:
    """c = sqrt(log2(e) / 2) / h as the kernel forms it (a float division)."""
    return F32(F32(_source()["kSqrtHalfLog2e"]) / F32(h))


def _terms(points, x, h, per_warp, centred=True):
    """(m, n) float32 terms 2^(-sum v^2) of the kernel, v = c p - c x formed
    about the warp's first point o as fmaf(c, ., -(c o)) (centred) or as
    c p - c x about 0."""
    c = _scale(h)
    m = points.shape[0]
    out = np.empty((m, x.shape[0]), F32)
    for s in range(0, m, 256):                       # whole warps: 256 % per_warp == 0
        p = points[s:s + 256]
        if centred:
            o = points[s + (np.arange(p.shape[0]) // per_warp) * per_warp]
            nco = -(c * o).astype(F32)
            pc = _fma(c, p, nco)
            xr = _fma(c, x[None], nco[:, None])
        else:
            pc, xr = (c * p).astype(F32), (c * x).astype(F32)[None]
        v = (pc[:, None, :] - xr).astype(F32)
        acc = (-(v[..., 0] * v[..., 0])).astype(F32)
        for k in range(1, x.shape[1]):
            acc = _fma(-v[..., k], v[..., k], acc)
        t = np.exp2(acc.astype(np.float64)).astype(F32)
        out[s:s + 256] = np.where(t < 2.0 ** -126, F32(0), t)
    return out


def _lanes(vals, dtype):
    """Each of 32 lanes adds its strided share (lane l: l, l + 32, ...) of
    the last axis in order, then the fixed shuffle-down tree: lane 0's sum."""
    k = vals.shape[-1]
    iters = -(-k // 32)
    pad = np.zeros(vals.shape[:-1] + (iters * 32,), dtype)
    pad[..., :k] = vals
    lanes = pad.reshape(vals.shape[:-1] + (iters, 32))
    acc = np.zeros(vals.shape[:-1] + (32,), dtype)
    for it in range(lanes.shape[-2]):
        acc = (acc + lanes[..., it, :]).astype(dtype)
    for off in (16, 8, 4, 2, 1):
        acc[..., :off] = (acc[..., :off] + acc[..., off:2 * off]).astype(dtype)
    return acc[..., 0]


def kernel_model(points, x, h, bps=BPS, sms=SMS):
    """The two kernels of one call on (m, d) points and (n, d) rows: the
    terms, each warp's lanes over each row range, one partial per (point,
    range), then per point the float64 sum of its partials times
    (2 pi)^(-d/2) h^(-d) / n."""
    m, d = points.shape
    n = x.shape[0]
    per_warp = tkde.point_tile(d) // tkde.WARPS
    rows = tkde.row_range(n, m, d, sms, bps)
    terms = _terms(points, x, h, per_warp)
    partials = np.stack([_lanes(terms[:, r:r + rows], F32) for r in range(0, n, rows)], 1)
    hd = float(F32(h))
    for _ in range(1, d):
        hd *= float(F32(h))
    norm_n = (2 * math.pi) ** (-0.5 * d) / n
    return (norm_n / hd * _lanes(partials.astype(np.float64), np.float64)).astype(F32)


def _data(rng, m, n, d):
    """Points near a sample, with an h that keeps the densities far above
    the tolerance's atol at every d."""
    sd = 1.0 if d <= 3 else 0.3
    x = rng.normal(0.0, sd, (n, d)).astype(F32)
    pts = rng.normal(0.0, 1.2 * sd, (m, d)).astype(F32)
    return pts, x, F32(0.6 if d <= 3 else 0.5)


# --- the source and the launcher ------------------------------------------------------

def test_source_constants_match_the_launcher():
    k = _source()
    text = (CSRC / "kde_eval.cu").read_text()
    assert k["kWarps"] == tkde.WARPS
    assert {4: k["kPtsD4"], 8: k["kPtsD8"], 16: k["kPtsD16"]} == tkde.PTS_PER_WARP
    assert "return D <= 4 ? kPtsD4 : (D <= 8 ? kPtsD8 : kPtsD16);" in text
    assert "if constexpr (D < 16)" in text and tkde.MAX_D == 16
    assert abs(k["kSqrtHalfLog2e"] - math.sqrt(math.log2(math.e) / 2)) < 1e-7
    assert "acc[r] += ex2_ftz(s);" in text
    assert [tkde.point_tile(d) for d in (1, 4, 5, 8, 9, 16)] == [64, 64, 32, 32, 16, 16]


# --- the kernel's partition and sums, modelled in float32 -----------------------------

@pytest.mark.parametrize("m,n,d", [(1, 1, 1), (513, 4097, 1), (4097, 3000, 3),
                                   (65, 4097, 16)])
def test_kernel_model_matches_plain_and_reference_kernel(rng, m, n, d):
    pts, x, h = _data(rng, m, n, d)
    got = kernel_model(pts, x, h)
    plain = ref.kde_eval(torch.as_tensor(pts), torch.as_tensor(x), float(h)).numpy()
    want = np.asarray(jops.kde_eval(jnp.asarray(pts), jnp.asarray(x), jnp.float32(h), tile=64))
    assert got.shape == (m,) and got.dtype == F32
    assert np.median(want) > 1e3 * KDE_TOL["atol"]
    np.testing.assert_allclose(got, plain, **KDE_TOL)
    np.testing.assert_allclose(got, want, **KDE_TOL)


@pytest.mark.parametrize("bps", [1, 6, 8])
@pytest.mark.parametrize("d", [1, 3, 16])
@pytest.mark.parametrize("m", [1, 513, 4096])
def test_cut_covers_rows_and_points_once_and_fills_its_waves(m, d, bps):
    n = 32_768
    rows = tkde.row_range(n, m, d, SMS, bps)
    assert rows % 32 == 0 and 32 <= rows <= tkde.TILE
    n_ranges = -(-n // rows)
    seen = np.zeros(n, np.int64)
    for r in range(n_ranges):                      # lane l: begin + l, begin + l + 32, ...
        begin, end = r * rows, min(n, (r + 1) * rows)
        for lane in range(32):
            seen[begin + lane:end:32] += 1
    assert np.all(seen == 1)
    tile = tkde.point_tile(d)
    per_warp = tile // tkde.WARPS
    written = np.zeros(m, np.int64)
    for t in range(-(-m // tile)):
        for w in range(tkde.WARPS):
            p0 = (t * tkde.WARPS + w) * per_warp
            written[p0:min(m, p0 + per_warp)] += 1
    assert np.all(written == 1)
    blocks = -(-m // tile) * n_ranges
    if rows < tkde.TILE:             # else the tile caps the ranges: more blocks, no fewer
        assert blocks <= tkde.WAVES * SMS * bps
    if 128 < rows < tkde.TILE:       # ranges long enough that rounding them up costs little
        assert blocks >= 0.8 * tkde.WAVES * SMS * bps
    assert blocks > 96 or m == 1     # the first design's grid at m = 513

@pytest.mark.parametrize("n", [1, 31, 4097, 32_768, 1_000_000, 100_000_000])
def test_ranges_stay_within_the_grid_limit(n):
    for m, d in ((1, 1), (513, 1), (4096, 3), (100_000, 16)):
        rows = tkde.row_range(n, m, d, SMS, BPS)
        assert -(-n // rows) <= GRID_Y_MAX


# --- the folded exponent against float64 ----------------------------------------------

def _telemetry(rng, ratio, d, h=F32(0.2)):
    """Samples with a large mean (|x| / h near `ratio`) and a sorted grid
    of points over them, as a latency or counter column would give."""
    mean = ratio * float(h)
    x = (mean + rng.normal(0.0, 1.0, (3000, d))).astype(F32)
    pts = (mean + np.sort(rng.normal(0.0, 1.5, (512, d)), axis=0)).astype(F32)
    return pts, x, h


def _f64(pts, x, h):
    diff = (pts.astype(np.float64)[:, None] - x.astype(np.float64)[None]) / float(h)
    return np.exp(-0.5 * np.sum(diff * diff, -1)).sum(1)


def _rel(got, want):
    big = want > 1e-3 * want.max()
    return float(np.max(np.abs(got[big] - want[big]) / want[big]))


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("ratio", [1e3, 1e4, 1e5])
def test_folded_exponent_holds_float64_far_from_zero(rng, ratio, d):
    """Scaling points and rows by c about the warp's first point keeps the
    terms within the tolerance however far the data lies from 0; scaling
    about 0 loses digits in proportion to |x| / h."""
    pts, x, h = _telemetry(rng, ratio, d)
    want = _f64(pts, x, h)
    per_warp = tkde.point_tile(d) // tkde.WARPS
    centred = _terms(pts, x, h, per_warp).astype(np.float64).sum(1)
    about0 = _terms(pts, x, h, per_warp, centred=False).astype(np.float64).sum(1)
    assert _rel(centred, want) < 2e-5
    print(f"|x|/h={ratio:g} d={d}: centred {_rel(centred, want):.3g}, "
          f"about 0 {_rel(about0, want):.3g}")
    assert _rel(about0, want) > 10 * _rel(centred, want)
    if ratio >= 1e4:
        assert _rel(about0, want) > KDE_TOL["rtol"]


# --- on the card -----------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


def test_cuda_kde_eval_is_one_launch_a_call_and_none_at_m0(cuda_device, rng):
    pts, x, h = _on(cuda_device, *_data(rng, 513, 4097, 1)[:2], np.float32(0.6))
    ops.reset_launch_counts()
    ops.kde_eval(pts, x, h)
    ops.kde_eval(pts[:0], x, h)
    torch.cuda.synchronize()
    assert ops.launch_counts()["kde_eval"] == 1


@pytest.mark.parametrize("m,n,d", [(4096, 32_768, 1), (4096, 32_768, 3), (513, 32_768, 1),
                                   (513, 4097, 16)])
def test_cuda_kde_eval_repeats_bit_equal(cuda_device, rng, m, n, d):
    pts, x, h = _on(cuda_device, *_data(rng, m, n, d))
    assert torch.equal(ops.kde_eval(pts, x, h), ops.kde_eval(pts, x, h))


@pytest.mark.parametrize("m", [0, 1, 513])
def test_cuda_kde_eval_matches_plain_at_d16(cuda_device, rng, m):
    pts, x, h = _data(rng, m, 4097, 16)
    got = ops.kde_eval(*_on(cuda_device, pts, x), float(h))
    assert got.shape == (m,)
    np.testing.assert_allclose(got.cpu().numpy(), kernel_model(pts, x, h), **KDE_TOL)
    np.testing.assert_allclose(got.cpu().numpy(), ref.kde_eval(
        torch.as_tensor(pts), torch.as_tensor(x), float(h)).numpy(), **KDE_TOL)


@pytest.mark.parametrize("d", [1, 3])
def test_cuda_kde_eval_holds_float64_far_from_zero(cuda_device, rng, d):
    pts, x, h = _telemetry(rng, 1e4, d)
    got = ops.kde_eval(*_on(cuda_device, pts, x), float(h)).cpu().numpy()
    want = (2 * math.pi) ** (-d / 2) * float(h) ** (-d) * _f64(pts, x, h) / x.shape[0]
    np.testing.assert_allclose(got, want, **KDE_TOL)
