"""The range and box groups of the port, on the CPU: the plain versions of
the aqp_batch / aqp_boxes kernels' five moment sums (`ref.aqp_batch_moments`,
`ref.aqp_box_moments`) against the JAX package's CI moment passes and its
plain sums; a model of the kernels' walk (every (query, point) pair once,
every partial written once, at the tile edges); a float32 model of the
erfc / exponential helper the kernels share (`csrc/common.cuh`,
`erfc_gauss`) against float64; the "cuda" backend's range and box groups
answering estimate and CI from one moment launch and no separate moment
pass, with answers and CI bounds equal to the "torch" backend's and within
the parity tolerances of the reference's.  On a machine with a CUDA device
both kernels are held against their plain versions, in the far tails
against float64, and two launches against each other.

Tolerances are `tests/test_kernels.py`'s for the AQP kernels: rtol 1e-4 with
atol 1e-5 on the sums of c and c^2 and 1e-4 on those that hold s (float32
sums over n points in another order); store answers as in
`tests/test_torch_store.py`.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erfc, ndtr

from repro.core import aqp_ci as jci
from repro.core import aqp_query as jq
from repro.data import aqp_store as jstore
from repro.kernels import ref as jref
from repro_torch.core import aqp_ci as tci
from repro_torch.core import aqp_query as tq
from repro_torch.data import aqp_store as tstore
from repro_torch.kernels import aqp_batch as tab
from repro_torch.kernels import aqp_boxes as tabx
from repro_torch.kernels import ops, ref
from repro_torch.kernels._launch import point_range

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
CNT_TOL = dict(rtol=1e-4, atol=1e-5)
SUM_TOL = dict(rtol=1e-4, atol=1e-4)
TOLS = (CNT_TOL, SUM_TOL, CNT_TOL, SUM_TOL, SUM_TOL)    # c, s, c^2, s^2, c s
F32 = np.float32


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _range_inputs(rng, n, q):
    x = rng.normal(0.0, 2.0, n).astype(F32)
    a = rng.uniform(-5.0, 3.0, q).astype(F32)
    b = (a + rng.uniform(0.1, 4.0, q)).astype(F32)
    return x, F32(rng.uniform(0.2, 0.8)), a, b


def _box_inputs(rng, n, q, d):
    x = rng.normal(0.0, 1.5, (n, d)).astype(F32)
    h = rng.uniform(0.2, 0.8, d).astype(F32)
    lo = rng.uniform(-3.0, 1.0, (q, d)).astype(F32)
    hi = (lo + rng.uniform(0.5, 3.0, (q, d))).astype(F32)
    return x, h, lo, hi, rng.integers(0, d, q).astype(np.int32)


def _assert_five(got, want, what=""):
    for k in range(5):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), **TOLS[k],
                                   err_msg=f"{what} sum {k}")


# --- plain versions against the reference ------------------------------------------

@pytest.mark.parametrize("n,q", [(1, 1), (1, 7), (300, 1), (300, 70), (513, 65)])
def test_batch_moments_plain_match_reference(rng, n, q):
    x, h, a, b = _range_inputs(rng, n, q)
    got = ref.aqp_batch_moments(_t(x), _t(h), _t(a), _t(b))
    assert got.shape == (5, q) and got.dtype == torch.float32
    _assert_five(got, jci.moments_1d(jnp.asarray(x), jnp.float32(h), jnp.asarray(a),
                                     jnp.asarray(b)))
    want = jref.aqp_batch_sums(jnp.asarray(x), jnp.float32(h), jnp.asarray(a), jnp.asarray(b))
    _assert_five(list(got[:2]) + [0] * 3, list(want) + [0] * 3)
    cnt, sm = ref.aqp_batch_sums(_t(x), _t(h), _t(a), _t(b))
    assert torch.equal(cnt, got[0]) and torch.equal(sm, got[1])


@pytest.mark.parametrize("n,q,d", [(1, 1, 1), (1, 5, 3), (200, 1, 2), (200, 70, 1),
                                   (200, 70, 2), (257, 33, 3)])
def test_box_moments_plain_match_reference(rng, n, q, d):
    x, h, lo, hi, tgt = _box_inputs(rng, n, q, d)
    got = ref.aqp_box_moments(_t(x), _t(h), _t(lo), _t(hi), _t(tgt, torch.int32))
    assert got.shape == (5, q) and got.dtype == torch.float32
    jargs = (jnp.asarray(x), jnp.asarray(h), jnp.asarray(lo), jnp.asarray(hi),
             jnp.asarray(tgt))
    _assert_five(got, jci.moments_box(*jargs))
    _assert_five(list(got[:2]) + [0] * 3, list(jref.aqp_box_sums(*jargs)) + [0] * 3)
    cnt, sm = ref.aqp_box_sums(_t(x), _t(h), _t(lo), _t(hi), _t(tgt, torch.int32))
    assert torch.equal(cnt, got[0]) and torch.equal(sm, got[1])


def test_moment_passes_are_the_plain_versions(rng):
    """The "torch" backend's CI passes call the kernels' plain versions: one
    copy of the per-point math."""
    x, h, a, b = _range_inputs(rng, 100, 9)
    five = ref.aqp_batch_moments(_t(x), _t(h), _t(a), _t(b))
    assert all(torch.equal(m, f) for m, f in zip(tci.moments_1d(_t(x), _t(h), _t(a), _t(b)),
                                                 five))
    xb, hb, lo, hi, tgt = _box_inputs(rng, 100, 9, 3)
    args = (_t(xb), _t(hb), _t(lo), _t(hi), _t(tgt, torch.int32))
    assert all(torch.equal(m, f) for m, f in zip(tci.moments_box(*args),
                                                 ref.aqp_box_moments(*args)))


@pytest.mark.parametrize("kind", ["batch", "box"])
def test_empty_inputs_give_zero_moments(kind):
    if kind == "batch":
        got = ops.aqp_batch_moments(torch.zeros(0), torch.tensor(0.5), torch.zeros(3),
                                    torch.ones(3))
        assert torch.equal(got, torch.zeros(5, 3))
        got = ops.aqp_batch_moments(torch.zeros(4), torch.tensor(0.5), torch.zeros(0),
                                    torch.zeros(0))
        assert got.shape == (5, 0)
    else:
        got = ops.aqp_box_moments(torch.zeros(0, 2), torch.ones(2), torch.zeros(3, 2),
                                  torch.ones(3, 2), torch.zeros(3, dtype=torch.int32))
        assert torch.equal(got, torch.zeros(5, 3))


# --- the kernels' walk and partial layout, modelled on the CPU -----------------------

def _source_tiles(fname):
    text = (CSRC / fname).read_text()
    rows = int(re.search(r"constexpr int kRows = (\d+);", text).group(1))
    warps = int(re.search(r"constexpr int kWarps = (\d+);", text).group(1))
    return rows, warps


def _walk(n, q, pts, rows, warps):
    """The kernels' walk: block (query tile, range), warp w holding queries
    q0 .. q0 + rows - 1 (q0 = (tile * warps + w) * rows; a warp past q
    returns), lane l taking points begin + l, begin + l + 32, ... below
    end; lane 0 writes partial ((k q + query) ranges + range).  Returns the
    (q, n) count of visits and the count of writes per partial slot."""
    n_ranges = -(-n // pts)
    q_tiles = -(-q // (rows * warps))
    visits = np.zeros((q, n), np.int64)
    writes = np.zeros(5 * q * n_ranges, np.int64)
    for qt in range(q_tiles):
        for w in range(warps):
            q0 = (qt * warps + w) * rows
            if q0 >= q:
                continue
            for r in range(n_ranges):
                begin, end = r * pts, min(n, (r + 1) * pts)
                pts_seen = np.concatenate([np.arange(begin + lane, end, 32)
                                           for lane in range(32)])
                for i in range(rows):
                    if q0 + i >= q:
                        break
                    np.add.at(visits[q0 + i], pts_seen, 1)
                    for k in range(5):
                        writes[(k * q + q0 + i) * n_ranges + r] += 1
    return visits, writes


@pytest.mark.parametrize("fname,mod", [("aqp_batch.cu", tab), ("aqp_boxes.cu", tabx)])
def test_source_tiles_match_the_launcher(fname, mod):
    rows, warps = _source_tiles(fname)
    assert rows * warps == mod.Q_TILE


@pytest.mark.parametrize("n", [1, 31, 32, 33, 95, 96, 97, 289])
@pytest.mark.parametrize("q", [1, 3, 4, 5, 31, 32, 33, 65])
def test_walk_visits_every_pair_once_and_writes_every_partial_once(n, q):
    rows, warps = _source_tiles("aqp_batch.cu")
    pts = 96                                      # ranges of 3 x 32 points
    visits, writes = _walk(n, q, pts, rows, warps)
    assert np.all(visits == 1)
    assert np.all(writes == 1)


@pytest.mark.parametrize("bps", [1, 3, 8])
@pytest.mark.parametrize("q", [1, 256, 384, 5000])
@pytest.mark.parametrize("n", [1, 31, 4097, 32_768, 1_000_000])
def test_point_range_keeps_the_grid_within_its_waves(n, q, bps):
    """The ranges never open a wave past WAVES (where the query tiles alone
    do not), and fill at least half of the waves once n has 32 points per
    range to spare."""
    sms, waves, tile = 132, tab.WAVES, tab.TILE
    q_tiles = -(-q // tab.Q_TILE)
    pts = point_range(n, q_tiles, sms, bps, waves, tile)
    assert pts % 32 == 0 and 32 <= pts <= tile
    blocks = q_tiles * -(-n // pts)
    if pts < tile:
        assert blocks <= max(waves * sms * bps, q_tiles)
    target = max(1, waves * sms * bps // q_tiles)
    if n >= 32 * target and 32 < pts < tile:
        assert blocks >= q_tiles * target / 2


# --- the shared erfc / exponential helper, modelled in float32 -----------------------

def _helper():
    """erfc_gauss of common.cuh evaluated step by step in float32 (each fmaf
    rounded once; ex2 and rcp correctly rounded, the card's are within 2 ulp),
    with the constants and coefficients read from the source."""
    text = (CSRC / "common.cuh").read_text()
    consts = {k: F32(v) for k, v in re.findall(r"constexpr float (\w+) = ([-+0-9.e]+)f;",
                                               text)}
    body = text[text.index("void erfc_gauss("):text.index("void phi_dens_diff(")]
    coef = [F32(c) for c in re.findall(r"p = (?:fmaf\(p, q, )?([-+0-9.e]+)f", body)]
    assert len(coef) == 10

    def f64(v):
        return np.asarray(v, np.float64)

    def fma(a, b, c):
        return F32(f64(a) * f64(b) + f64(c))

    def erfc_gauss(z):
        z = np.asarray(z, F32)
        t = np.abs(z)
        t = np.where(t > 16, F32(16), t).astype(F32)
        ht = F32(0.5) * t
        s_hi = ht * t
        s_lo = fma(ht, t, -s_hi)
        y = s_hi * consts["kNegLog2e"]
        r = fma(y, -consts["kLn2Hi"], -s_hi)
        r = fma(y, -consts["kLn2Lo"], r) - s_lo
        e = F32(np.exp2(f64(y)))
        e = np.where(e < 2.0 ** -126, F32(0), e).astype(F32)
        g = fma(e, r, e)
        den_q = t + consts["kErfcK"]
        den_p = fma(consts["kSqrt2"], t, F32(1))
        inv = F32(1.0 / f64(den_q * den_p))
        q = fma(F32(-2) * consts["kErfcK"], inv * den_p, F32(1))
        p = coef[0]
        for c in coef[1:]:
            p = fma(p, q, c)
        tail = g * (p * (inv * den_q))
        return np.where(z < 0, F32(2) - tail, tail).astype(F32), g

    return erfc_gauss


def test_erfc_gauss_holds_float64_across_both_tails():
    erfc_gauss = _helper()
    z = np.concatenate([np.linspace(-13.0, 13.0, 52_001), np.linspace(-0.01, 0.01, 2001)])
    z = z.astype(F32)
    ec, g = erfc_gauss(z)
    z64 = z.astype(np.float64)
    want_ec, want_g = erfc(z64 / np.sqrt(2.0)), np.exp(-0.5 * z64 * z64)
    assert np.max(np.abs(ec - want_ec) / want_ec) < 1e-6
    assert np.max(np.abs(g - want_g) / want_g) < 5e-7
    # beyond |z| = 13.2 the exponential flushes to 0, and at 16 both are 0
    big = erfc_gauss(np.asarray([14.0, 16.0, 1e30, -1e30], F32))
    assert np.array_equal(big[0], [0, 0, 0, 2]) and np.array_equal(big[1], [0, 0, 0, 0])
    assert np.all(np.isnan(erfc_gauss(np.asarray([np.nan], F32))))


def test_helper_phi_difference_is_tail_stable_against_float64():
    """Phi(zb) - Phi(za) as the kernels take it (the tail the pair sits in),
    with the density difference from the same exponentials, at rtol 1e-5
    out to |z| = 12."""
    erfc_gauss = _helper()
    za = np.asarray([4.0, 6.0, 9.0, -12.0, -7.0, -1.0, 0.2], F32)
    zb = np.asarray([5.0, 9.0, 12.0, -9.5, -5.5, 2.0, 0.3], F32)
    upper = za + zb > 0
    eu, gu = erfc_gauss(np.where(upper, za, -zb))
    ev, gv = erfc_gauss(np.where(upper, zb, -za))
    d_phi = np.where(upper, 1, -1) * F32(1 / np.sqrt(2 * np.pi)) * (gv - gu)
    a64, b64 = za.astype(np.float64), zb.astype(np.float64)
    want = np.where(upper, ndtr(-a64) - ndtr(-b64), ndtr(b64) - ndtr(a64))
    np.testing.assert_allclose(F32(0.5) * (eu - ev), want, rtol=1e-5)
    want_phi = (np.exp(-0.5 * b64 * b64) - np.exp(-0.5 * a64 * a64)) / np.sqrt(2 * np.pi)
    np.testing.assert_allclose(d_phi, want_phi, rtol=1e-5)


# --- the engine: one launch per range / box group on "cuda" ---------------------------

CAPACITY = 256
JOINT = ("loss", "latency", "grad")


def _stream(seed, batches=3, rows=700):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        latent = rng.normal(0, 1, rows)
        out.append({
            "loss": (2.0 + 0.5 * latent + rng.normal(0, 0.4, rows)).astype(F32),
            "latency": np.exp(3.0 + 0.3 * latent + rng.normal(0, 0.3, rows)).astype(F32),
            "grad": (1.0 + 0.3 * latent + rng.normal(0, 0.5, rows)).astype(F32),
        })
    return out


def _fill(store, stream):
    store.track_joint(JOINT)
    for batch in stream:
        store.add_batch(batch)
    return store


def _specs(m):
    """Two range groups (loss, latency) and one box group (the joint), each
    COUNT / SUM / AVG, one range in the far upper tail of loss."""
    return [
        m.AqpQuery("count", (m.Range("loss", 1.5, 2.5),)),
        m.AqpQuery("sum", (m.Range("loss", 0.0, 2.0),)),
        m.AqpQuery("avg", (m.Range("loss", 1.0, 3.5),)),
        m.AqpQuery("count", (m.Range("loss", 6.0, 9.0),)),
        m.AqpQuery("avg", (m.Range("latency", 15.0, 30.0),)),
        m.AqpQuery("sum", (m.Range("latency", 20.0, 90.0),)),
        m.AqpQuery("count", (m.Box(JOINT, (1.0, 10.0, 0.0), (3.0, 30.0, 2.0)),)),
        m.AqpQuery("sum", (m.Box(JOINT, (1.5, 15.0, 0.5), (2.5, 40.0, 1.5)),),
                   target="latency"),
        m.AqpQuery("avg", (m.Box(JOINT, (0.0, 0.0, -1.0), (3.0, 50.0, 3.0)),),
                   target="grad"),
    ]


@pytest.fixture(scope="module")
def stores():
    stream = _stream(3)
    ref_store = _fill(jstore.TelemetryStore(capacity=CAPACITY, seed=0), stream)
    port = _fill(tstore.TelemetryStore(capacity=CAPACITY, seed=0, device="cpu"), stream)
    return ref_store, port, ref_store.query(_specs(jq))


def _spy(monkeypatch, calls, mod, name):
    orig = getattr(mod, name)

    def counted(*a, **k):
        calls[name] += 1
        return orig(*a, **k)
    monkeypatch.setattr(mod, name, counted)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_cuda_groups_take_one_moment_launch_and_no_moment_pass(stores, monkeypatch,
                                                               backend):
    """On "cuda" (CPU tensors: the wrappers take the plain versions) each
    range or box group makes one aqp_*_moments call and runs no moments_*
    pass; "torch" keeps the reference's separate passes."""
    _, port, _ = stores
    names = ("moments_1d", "moments_box", "aqp_batch_moments", "aqp_box_moments",
             "aqp_batch_sums", "aqp_box_sums")
    calls = dict.fromkeys(names, 0)
    for name in names[:2]:
        _spy(monkeypatch, calls, tq, name)
    for name in names[2:]:
        _spy(monkeypatch, calls, ops, name)
    port.query(_specs(tq), backend=backend)
    if backend == "cuda":
        assert calls == dict(moments_1d=0, moments_box=0, aqp_batch_moments=2,
                             aqp_box_moments=1, aqp_batch_sums=0, aqp_box_sums=0)
    else:
        assert calls == dict(moments_1d=2, moments_box=1, aqp_batch_moments=0,
                             aqp_box_moments=0, aqp_batch_sums=0, aqp_box_sums=0)


def test_cuda_answers_and_ci_bounds_equal_the_torch_backend(stores):
    """The same plain sums on both backends of a CPU store: answers and CI
    bounds agree to float32 rounding (rtol 1e-6), and hold the reference's
    within the parity tolerances."""
    ref_store, port, want = stores
    got = port.query(_specs(tq), backend="cuda")
    plain = port.query(_specs(tq), backend="torch")
    scale = (3 * 700) / CAPACITY
    for g, p, w in zip(got, plain, want):
        assert g.path == p.path + ":cuda" and p.path == w.path
        for field in ("estimate", "ci_lo", "ci_hi"):
            np.testing.assert_allclose(getattr(g, field), getattr(p, field), rtol=1e-6,
                                       atol=1e-6 * scale, err_msg=field)
            np.testing.assert_allclose(getattr(g, field), getattr(w, field), rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=field)
    assert {g.path for g in got} == {"range1d:cuda", "box:cuda"}


def test_answers_and_se_helpers_match_the_separate_passes(rng):
    x, h, a, b = _range_inputs(rng, 300, 12)
    ops_np = np.arange(12, dtype=np.int32) % 3
    ans, se = tci.range_answers_and_se(_t(x), _t(h), _t(a), _t(b), ops_np, 4.0, 300)
    want = tq.batch_query_1d(_t(x), _t(h), _t(a), _t(b), _t(ops_np, torch.int32), 4.0)
    assert torch.equal(ans, want) and ans.device.type == "cpu"
    np.testing.assert_array_equal(
        se, tci.se_from_moments(ops_np, tci.moments_1d(_t(x), _t(h), _t(a), _t(b)), 4.0, 300))
    xb, hb, lo, hi, tgt = _box_inputs(rng, 200, 12, 3)
    args = (_t(xb), _t(hb), _t(lo), _t(hi), _t(tgt, torch.int32))
    ans, se = tci.box_answers_and_se(*args, ops_np, 2.5, 200)
    want = tq.batch_query_box(*args, _t(ops_np, torch.int32), 2.5)
    assert torch.equal(ans, want)
    np.testing.assert_array_equal(se, tci.se_from_moments(ops_np, tci.moments_box(*args),
                                                          2.5, 200))


# --- on the card -----------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def test_cuda_batch_moments_match_plain_and_repeat_bit_equal(cuda_device, rng):
    ops.reset_launch_counts()
    shapes = ((1, 1), (31, 1), (33, 5), (4097, 3), (4097, 33), (32_768 + 5, 257))
    for n, q in shapes:
        args = [_t(v).to(cuda_device) for v in _range_inputs(rng, n, q)]
        k = ops.aqp_batch_moments(*args)
        _assert_five(k.cpu(), ref.aqp_batch_moments(*args).cpu(), f"n={n} q={q}")
        assert torch.equal(k, ops.aqp_batch_moments(*args))
        cnt, sm = ops.aqp_batch_sums(*args)
        assert torch.equal(cnt, k[0]) and torch.equal(sm, k[1])
    assert ops.launch_counts()["aqp_batch_sums"] == 3 * len(shapes)


def test_cuda_box_moments_match_plain_every_d_and_repeat_bit_equal(cuda_device, rng):
    ops.reset_launch_counts()
    shapes = [(1, 1, 1), (33, 5, 2), (4097, 70, 3), (32_768 + 5, 384, 3)] + \
        [(700 + d, 9, d) for d in range(1, 9)]
    for n, q, d in shapes:
        x, h, lo, hi, tgt = _box_inputs(rng, n, q, d)
        args = [_t(v).to(cuda_device) for v in (x, h, lo, hi)] + \
            [_t(tgt, torch.int32).to(cuda_device)]
        k = ops.aqp_box_moments(*args)
        _assert_five(k.cpu(), ref.aqp_box_moments(*args).cpu(), f"n={n} q={q} d={d}")
        assert torch.equal(k, ops.aqp_box_moments(*args))
    assert ops.launch_counts()["aqp_box_sums"] == 2 * len(shapes)
    # a target outside [0, d): NaN in the sums that hold s, the count sums kept
    x, h, lo, hi, _ = _box_inputs(rng, 100, 2, 2)
    args = [_t(v).to(cuda_device) for v in (x, h, lo, hi)]
    k = ops.aqp_box_moments(*args, _t([0, 2], torch.int32).to(cuda_device)).cpu()
    assert torch.isnan(k[[1, 3, 4], 1]).all() and torch.isfinite(k[:, 0]).all()
    assert torch.isfinite(k[[0, 2], 1]).all()


def test_cuda_kernels_are_tail_stable_against_float64(cuda_device):
    """Far-tail ranges, where an erf difference cancels to 0 in float32: the
    count and sum sums at rtol 1e-4 of float64 with no atol, the squared sums
    with an atol of 1e-30 (a squared term of 1e-36 underflows float32)."""
    x = np.linspace(-1.0, 1.0, 2000).astype(F32)
    a = np.asarray([4.0, 6.0, -7.0, 3.0], F32)
    b = np.asarray([5.0, 9.0, -5.5, 3.2], F32)
    h = 0.4
    za = (a[:, None].astype(np.float64) - x[None]) / F32(h)
    zb = (b[:, None].astype(np.float64) - x[None]) / F32(h)
    c = np.where(za + zb > 0, ndtr(-za) - ndtr(-zb), ndtr(zb) - ndtr(za))
    dphi = (np.exp(-0.5 * zb * zb) - np.exp(-0.5 * za * za)) / np.sqrt(2 * np.pi)
    s = x[None] * c - F32(h) * dphi
    want = [c.sum(1), s.sum(1), (c * c).sum(1), (s * s).sum(1), (c * s).sum(1)]
    dev = cuda_device
    k = ops.aqp_batch_moments(_t(x).to(dev), torch.tensor(h, device=dev), _t(a).to(dev),
                              _t(b).to(dev)).cpu()
    for t in range(5):
        np.testing.assert_allclose(k[t].numpy(), want[t], rtol=1e-4,
                                   atol=0.0 if t < 2 else 1e-30, err_msg=f"sum {t}")
    # the same ranges on axis 0 of a box whose second axis covers everything
    xb = np.stack([x, np.zeros_like(x)], axis=1)
    lo = np.stack([a, np.full(4, -10.0, F32)], axis=1)
    hi = np.stack([b, np.full(4, 10.0, F32)], axis=1)
    k = ops.aqp_box_moments(_t(xb).to(dev), _t([h, 0.4]).to(dev), _t(lo).to(dev),
                            _t(hi).to(dev), torch.zeros(4, dtype=torch.int32, device=dev))
    for t in range(5):
        np.testing.assert_allclose(k[t].cpu().numpy(), want[t], rtol=1e-4,
                                   atol=0.0 if t < 2 else 1e-30, err_msg=f"box {t}")
