"""The kernel-centred quasi-MC path of full-H groups (`kde_backend="kernel"`,
path `qmc:kernel`): the engine's answers held to the benchmark's plain
reference (`bench/reference.kernel_box_answers`, float64, importing nothing
of the program), the closed box, the CI's row chunks, what the path
refuses, the exact path left as it was, and, on a machine with a CUDA
device, the draw_box_reduce kernel against its plain version.

Tolerances.  The program forms its draws in float32 from the same Halton
points as the reference's float64 draws, so a draw moves by about 1e-7 of
its size and lands on the other side of a box face only within that
distance of it: at these sizes under one such draw is expected over all
the boxes of a test, and each answer is allowed one draw's weight
w = n_source / (m K) (COUNT), one draw at the box's largest target bound
B plus float32 rounding of the summed coordinates (SUM), and their ratio's
share of both (AVG).  A CI half-width moves by at most t (the chunk
answers' move) / sqrt(k - 1), plus 1e-4 of itself for the program's
Cornish-Fisher t quantile against the reference's integrated one.  L
rounded to TF32 moves every draw by about 5e-4 of its size and breaks
these bounds.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import reference, streams
from repro_torch.core import aqp_ci, aqp_multid
from repro_torch.core import aqp_query as q
from repro_torch.core.aqp import OP_CODES
from repro_torch.data.aqp_store import TelemetryStore
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "bench" / "configs" / "joint8-n16384.json").read_text())
COLUMNS = [c["name"] for c in CONFIG["columns"]]
SEED = 2 ** 31 + 33
M, K, N_BOXES = 256, 64, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs beside other test files in
    parallel workers (as `bench/tests/conftest.py` does), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _np(t):
    return np.asarray(t.detach().cpu(), np.float64)


def _store(cols, capacity=M, rows=4000):
    """A CPU store over `cols` (a joint when there are several) fed `rows`
    rows of the joint8 configuration's telemetry."""
    rng = np.random.default_rng(SEED)
    batch = streams.make_rows(rng, CONFIG, rows)
    store = TelemetryStore(capacity=capacity, seed=SEED, device="cpu")
    if len(cols) > 1:
        store.track_joint(tuple(cols))
    store.add_batch({c: batch[c] for c in cols})
    return store, batch


def _boxes(cols, batch, count=N_BOXES):
    """`count` boxes of the benchmark's recipe over `cols` (lower quantile
    in [0, 0.4], width in [0.4, 0.9]; COUNT / SUM / AVG in turn)."""
    traffic = {"dashboard": [{"kind": "box", "columns": list(cols), "count": count,
                              "lo_q": [0.0, 0.4], "width_q": [0.4, 0.9]}]}
    return streams.make_dashboard(SEED, CONFIG, traffic, batch)


def _engine_answers(store, cols, rows, backend="torch", kde_backend="kernel"):
    engine = store.engine(selector="lscv_H", backend=backend, kde_backend=kde_backend)
    res = engine.execute(streams.to_aqp(rows, q))
    key = tuple(cols) if len(cols) > 1 else cols[0]
    reservoir = store.joints[key] if len(cols) > 1 else store.columns[key]
    syn = store.cache.peek(key, "lscv_H", reservoir.version, backend=backend)
    x = _np(syn.x).reshape(syn.x.shape[0], -1)
    return res, x, _np(syn.H), int(syn.n_source)


def _tolerances(rows, want, m, n_source, k=8, draws=K):
    """Per answer (estimate tolerance, half-width tolerance), as the
    module's docstring sets them out."""
    w = n_source / (m * draws)
    t = reference.t_ppf(0.975, k - 1)
    out = []
    for r, (est, lo, hi) in zip(rows, want):
        b = max(abs(r.lo[r.target]), abs(r.hi[r.target]))
        count = next(a[0] for rr, a in zip(rows, want) if rr.lo == r.lo and
                     rr.aggregate == "count") if r.aggregate == "avg" else est

        def tol(weight):
            tol_c = weight
            tol_s = weight * b + 1e-6 * b * abs(count)
            if r.aggregate == "count":
                return tol_c
            if r.aggregate == "sum":
                return tol_s
            return (tol_s + abs(est) * tol_c) / max(0.5 * abs(count), weight)

        half = 0.5 * (hi - lo)
        out.append((tol(w), t * tol(k * w) / math.sqrt(k - 1) + 1e-4 * half))
    return out


def _outside(got, want, tols):
    """Answers whose estimate or half-width departs by more than its
    tolerance."""
    bad = []
    for i, ((est, lo, hi), (e_tol, h_tol)) in enumerate(zip(want, tols)):
        g = got[i]
        if abs(g.estimate - est) > e_tol or \
                abs(0.5 * (g.ci_hi - g.ci_lo) - 0.5 * (hi - lo)) > h_tol:
            bad.append(i)
    return bad


def _with_avg_counts(rows):
    """The dashboard with a COUNT of each AVG box appended, so an AVG's
    tolerance can read its box's count."""
    extra = [streams.SpecRow("box", "count", r.columns, r.lo, r.hi, r.target)
             for r in rows if r.aggregate == "avg"]
    return list(rows) + extra


@pytest.mark.parametrize("d", [1, 3, 8])
def test_engine_kernel_answers_match_the_plain_reference(d):
    cols = COLUMNS[:d]
    store, batch = _store(cols)
    rows = _with_avg_counts(_boxes(cols, batch))
    got, x, H, n_src = _engine_answers(store, cols, rows)
    assert {r.path for r in got} == {"qmc:kernel"}
    assert x.shape == (M, d)
    want = reference.kernel_box_answers(x, H, rows, n_src, K, 8, 0.95)
    tols = _tolerances(rows, want, M, n_src)
    assert _outside(got, want, tols) == []
    # the "cuda" backend's one-launch path (its plain version on the CPU),
    # on the same fitted synopsis, gives the same estimates and intervals
    key = tuple(cols) if d > 1 else cols[0]
    version = (store.joints[key] if d > 1 else store.columns[key]).version
    store.cache.put(key, "lscv_H", version,
                    store.cache.peek(key, "lscv_H", version, backend="torch"), backend="cuda")
    cuda = store.engine(selector="lscv_H", backend="cuda",
                        kde_backend="kernel").execute(streams.to_aqp(rows, q))
    assert {r.path for r in cuda} == {"qmc:kernel:cuda"}
    for a, b in zip(cuda, got):
        # the chunks' float64 sums regroup the whole sample's
        assert a.estimate == pytest.approx(b.estimate, rel=1e-12)
        assert a.ci_hi - a.ci_lo == pytest.approx(b.ci_hi - b.ci_lo, rel=1e-12)


def test_tf32_rounded_cholesky_factor_departs(monkeypatch):
    """The same comparison with L rounded to TF32 in the program: some
    answer leaves its tolerance."""
    cols = COLUMNS[:3]
    store, batch = _store(cols)
    rows = _with_avg_counts(_boxes(cols, batch))
    original = aqp_multid._kernel_factor
    monkeypatch.setattr(aqp_multid, "_kernel_factor",
                        lambda H: reference.tf32_round(torch.as_tensor(original(H))).numpy())
    got, x, H, n_src = _engine_answers(store, cols, rows)
    want = reference.kernel_box_answers(x, H, rows, n_src, K, 8, 0.95)
    assert _outside(got, want, _tolerances(rows, want, M, n_src))


def _direct(x, H, lo, hi, tgt, ops_, n_source, draws=K):
    scale = n_source / x.shape[0]
    return aqp_ci.kernel_answers_and_se(_t(x), _t(H), np.asarray(lo, np.float64),
                                        np.asarray(hi, np.float64),
                                        np.asarray(tgt, np.int32),
                                        np.asarray(ops_, np.int32), scale, n_source, draws)


def test_a_box_over_the_whole_support_counts_every_row():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (M, 3)).astype(np.float32)
    H = np.diag([0.2, 0.3, 0.1])
    big = np.full((1, 3), 1e30)
    ans, _, _ = _direct(x, H, -big, big, [0], [OP_CODES["count"]], 12_345)
    assert float(ans[0]) == 12_345.0


def test_a_draw_on_a_face_is_counted():
    """With L = I the draws are x_i + z exactly in float32: a box whose
    faces all pass through the first draw (lo = hi = that draw) holds it."""
    rng = np.random.default_rng(6)
    for d in (1, 3):
        x = rng.normal(0, 1, (8, d)).astype(np.float32)
        z = aqp_multid.kernel_normals(8, K, d, "cpu")
        y0 = (torch.as_tensor(x[0]) + z[0]).numpy()[None].astype(np.float64)
        ans, _, _ = _direct(x, np.eye(d), y0, y0, [0], [OP_CODES["count"]], 8 * K)
        assert float(ans[0]) >= 1.0                       # one draw's weight: 1
        shifted = np.nextafter(y0.astype(np.float32), np.float32(np.inf)).astype(np.float64)
        ans, _, _ = _direct(x, np.eye(d), shifted, shifted, [0], [OP_CODES["count"]], 8 * K)
        assert float(ans[0]) < 1.0                        # the open side misses it


def test_chunks_leave_the_tail_to_the_estimate():
    """m = 260 rows, k = 8 chunks of 32: the 4 rows past 256 enter the
    estimate only, as in the reference, whose answers the path matches."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (260, 2)).astype(np.float32)
    H = np.array([[0.3, 0.1], [0.1, 0.2]])
    lo = np.array([[-0.5, -1.0], [-2.0, -0.2], [0.0, 0.0]])
    hi = np.array([[1.0, 0.5], [0.3, 2.0], [1.5, 1.0]])
    z = aqp_multid.kernel_normals(260, K, 2, "cpu")
    L = torch.as_tensor(np.linalg.cholesky(H).astype(np.float32))
    cnt, _ = ref.draw_box_reduce(_t(x), z, L, _t(lo), _t(hi), _t([0, 1, 0], torch.int32), 8)
    tail, _ = ref.draw_box_reduce(_t(x[256:]), aqp_multid.kernel_normals(260, K, 2, "cpu")[256 * K:],
                                  L, _t(lo), _t(hi), _t([0, 1, 0], torch.int32), 0)
    np.testing.assert_array_equal(_np(cnt[0]), _np(cnt[1:].sum(dim=0) + tail[0]))
    chunk3, _ = ref.draw_box_reduce(_t(x[96:128]), z[96 * K:128 * K], L, _t(lo), _t(hi),
                                    _t([0, 1, 0], torch.int32), 0)
    np.testing.assert_array_equal(_np(cnt[4]), _np(chunk3[0]))
    rows = _with_avg_counts([streams.SpecRow("box", agg, ("a", "b"), tuple(lo[i]),
                                             tuple(hi[i]), i % 2)
                             for i, agg in enumerate(("count", "sum", "avg"))])
    lo = np.asarray([r.lo for r in rows])
    hi = np.asarray([r.hi for r in rows])
    ops_ = [OP_CODES[r.aggregate] for r in rows]
    ans, se, dof = _direct(x, H, lo, hi, [r.target for r in rows], ops_, 26_000)
    assert dof == 7
    want = reference.kernel_box_answers(x, H, rows, 26_000, K, 8, 0.95)
    t = aqp_ci.t_ppf(0.975, dof)
    got = [q.AqpResult(float(a), "qmc:kernel", 0.0, 0, ci_lo=float(a - t * s),
                       ci_hi=float(a + t * s)) for a, s in zip(ans, se)]
    assert _outside(got, want, _tolerances(rows, want, 260, 26_000)) == []


def test_what_the_path_refuses():
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (64, 9)).astype(np.float32)
    box = np.zeros((1, 9))
    with pytest.raises(ValueError, match="d <= 8"):
        _direct(x, np.eye(9), box - 1, box + 1, [0], [0], 640)
    with pytest.raises(ValueError, match="d <= 8"):
        ref.draw_box_reduce(_t(x), aqp_multid.kernel_normals(64, 4, 9, "cpu"), torch.eye(9),
                            _t(box), _t(box), _t([0], torch.int32), 0)
    store, _ = _store(COLUMNS[:3])
    with pytest.raises(ValueError, match="kde_backend"):
        store.engine(selector="lscv_H", kde_backend="kernels")
    with pytest.raises(ValueError, match="kde_backend"):
        q.AqpQuery("count", (q.Box(tuple(COLUMNS[:3]), (0, 0, 0), (1, 1, 1)),),
                   kde_backend="hull")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_exact_answers_are_the_qmc_paths_as_before(backend):
    """`kde_backend="exact"` on a 3-d group runs the hull path's functions,
    untouched: the engine's answers are theirs bit for bit."""
    cols = COLUMNS[:3]
    store, batch = _store(cols)
    rows = _boxes(cols, batch)
    got, x, H, n_src = _engine_answers(store, cols, rows, backend=backend,
                                       kde_backend="exact")
    assert {r.path for r in got} == {"qmc" if backend == "torch" else "qmc:cuda"}
    n = len(rows)
    lo = np.asarray([r.lo for r in rows], np.float64)
    hi = np.asarray([r.hi for r in rows], np.float64)
    tgt = np.asarray([r.target for r in rows], np.int32)
    ops_ = np.asarray([OP_CODES[r.aggregate] for r in rows], np.int32)
    pad = q._pad_count(n)
    lo, hi, tgt, ops_ = (q._pad_rows(a, pad) for a in (lo, hi, tgt, ops_))
    syn_x, syn_H = _t(x), _t(H)
    scale = n_src / x.shape[0]
    if backend == "cuda":
        ans, se, dof = aqp_ci.qmc_answers_and_se(syn_x, syn_H, lo, hi, tgt, ops_, scale,
                                                 n_src, 4096)
    else:
        ans = aqp_multid.batch_query_qmc(syn_x, syn_H, lo, hi, tgt, ops_, scale, n_qmc=4096)
        se, dof = aqp_ci.qmc_subsample_se(syn_x, syn_H, lo, hi, tgt, ops_, n_src, 4096)
    t = aqp_ci.t_ppf(0.975, dof)
    for i, r in enumerate(got):
        est = float(np.float64(_np(ans)[i]))
        assert r.estimate == est
        assert (r.ci_lo, r.ci_hi) == (est - t * se[i], est + t * se[i])


def test_engine_keyword_sets_the_draws_and_counts_hits():
    cols = COLUMNS[:3]
    store, batch = _store(cols)
    rows = _with_avg_counts(_boxes(cols, batch, count=3))
    engine = store.engine(selector="lscv_H", kde_backend="kernel", kernel_draws=16)
    assert q.QueryEngine(store).kernel_draws == q.KERNEL_DRAWS == 64
    got = engine.execute(streams.to_aqp(rows, q))
    reservoir = store.joints[tuple(cols)]
    syn = store.cache.peek(tuple(cols), "lscv_H", reservoir.version, backend="torch")
    want = reference.kernel_box_answers(_np(syn.x), _np(syn.H), rows, int(syn.n_source), 16,
                                        8, 0.95)
    assert _outside(got, want, _tolerances(rows, want, M, int(syn.n_source), draws=16)) == []
    assert store.metrics.sum_counter("aqp.synopsis.hits", backend="kernel") == len(rows)


# --- on the card -----------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def test_cuda_draw_box_reduce_matches_plain_version(cuda_device):
    """The kernel against its plain version: d = 1..8, one row, a chunk
    tail, no chunks and 16; counts within two draws (faces under float32
    sums in another order), two launches the same bits."""
    dev = cuda_device
    rng = np.random.default_rng(9)
    ops.reset_launch_counts()
    cases = [(1, 1, 64, 5, 0), (2, 3, 64, 9, 0), (513, 8, 64, 128, 8), (700, 5, 7, 33, 16)]
    for m, d, draws, nq, splits in cases:
        x = _t(rng.normal(0, 1, (m, d))).to(dev)
        A = rng.normal(0, 0.3, (d, d))
        L = _t(np.linalg.cholesky(A @ A.T + 0.2 * np.eye(d))).to(dev)
        z = aqp_multid.kernel_normals(m, draws, d, dev)
        lo = _t(rng.uniform(-1.5, 0.0, (nq, d))).to(dev)
        hi = lo + _t(rng.uniform(0.5, 2.5, (nq, d))).to(dev)
        tgt = _t(rng.integers(0, d, nq), torch.int32).to(dev)
        k = ops.draw_box_reduce(x, z, L, lo, hi, tgt, splits)
        p = ref.draw_box_reduce(x, z, L, lo, hi, tgt, splits)
        np.testing.assert_allclose(_np(k[0]), _np(p[0]), atol=2.0)
        np.testing.assert_allclose(_np(k[1]), _np(p[1]), rtol=1e-5, atol=2.0 * 4.0)
        again = ops.draw_box_reduce(x, z, L, lo, hi, tgt, splits)
        assert torch.equal(k[0], again[0]) and torch.equal(k[1], again[1])
    assert ops.launch_counts()["draw_box_reduce"] == 2 * len(cases)
