"""The GROUP BY slice of the port, on the CPU: the factored grouped sums
(`ops.aqp_grouped_sums`, whose CPU path is the plain version) against the JAX
package's oracle and its Pallas kernel in interpret mode, against the same
boxes fanned out through the box sums, in the far tails against float64,
`batch_query_box_grouped` against the reference, and `store.query` with
GROUP BY specs over a joint that holds the dictionary column, against the JAX
store on both backends.  On a machine with a CUDA device the kernel is held
against its plain version.

Tolerances are `tests/test_kernels.py`'s for the AQP kernels: rtol 1e-4 with
atol 1e-5 on counts and 1e-4 on sums (float32 sums over n rows in another
order).  The port forms each Phi difference from the tail its pair sits in
(erfc) where the reference takes an erf difference, which cancels in the far
tails; there the port is held to float64.  Store answers: as in
`tests/test_torch_store.py`, exact paths bit-equal, KDE estimates and CI
bounds at rtol 1e-4 plus atol 1e-4 x scale, and each estimate inside the
reference's CI.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import ndtr

from repro.core import aqp_multid as jmd
from repro.core import aqp_query as jq
from repro.data import aqp_store as jstore
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import aqp_multid as tmd
from repro_torch.core import aqp_query as tq
from repro_torch.data import aqp_store as tstore
from repro_torch.kernels import ops, ref

CNT_TOL = dict(rtol=1e-4, atol=1e-5)
SUM_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _family(rng, n, d, G, spread=1.0):
    """A sample, per-axis bandwidths, a shared box and G unit-wide code
    windows on the group axis (codes 0..G-1, as a dictionary column)."""
    x = rng.normal(0.0, spread, (n, d)).astype(np.float32)
    h = rng.uniform(0.2, 0.6, d).astype(np.float32)
    lo = rng.uniform(-2.0, -0.5, d).astype(np.float32)
    hi = (lo + rng.uniform(1.0, 3.0, d)).astype(np.float32)
    codes = np.arange(G, dtype=np.float32) * (3.0 / max(G, 1)) - 1.5
    return x, h, lo, hi, codes - 0.5, codes + 0.5


def _both(args, g_axis, tgt):
    got = ops.aqp_grouped_sums(*[_t(a) for a in args], g_axis, tgt)
    want = jref.aqp_grouped_sums(*[jnp.asarray(a) for a in args], g_axis, tgt)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("n,d,G,g_axis,tgt", [
    (300, 3, 5, 1, 0),      # target on a kept axis
    (300, 3, 5, 1, 1),      # target is the group axis
    (131, 2, 1, 0, 1),      # G = 1; n not a multiple of a tile
    (257, 1, 4, 0, 0),      # d = 1: the group axis is the only axis
    (64, 4, 17, 3, 2),
])
def test_grouped_plain_matches_reference_oracle(rng, n, d, G, g_axis, tgt):
    args = _family(rng, n, d, G)
    got, want = _both(args, g_axis, tgt)
    np.testing.assert_allclose(got[0], want[0], **CNT_TOL)
    np.testing.assert_allclose(got[1], want[1], **SUM_TOL)


@pytest.mark.parametrize("tgt", [0, 2])
def test_grouped_plain_matches_reference_kernel(rng, tgt):
    """Against the Pallas kernel in interpret mode, tiled so that several
    data tiles and category tiles run (n = 150 over tiles of 64, G = 11
    over tiles of 8)."""
    x, h, lo, hi, glo, ghi = _family(rng, 150, 3, 11)
    got = ops.aqp_grouped_sums(*[_t(a) for a in (x, h, lo, hi, glo, ghi)], 2, tgt)
    want = jops.aqp_grouped_sums(*[jnp.asarray(a) for a in (x, h, lo, hi, glo, ghi)],
                                 2, tgt, tile=64, g_tile=8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **CNT_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **SUM_TOL)


@pytest.mark.parametrize("n,G", [(0, 4), (50, 0), (0, 0)])
def test_grouped_empty_inputs_give_zeros(rng, n, G):
    x, h, lo, hi, glo, ghi = _family(rng, n, 2, G)
    got, want = _both((x, h, lo, hi, glo, ghi), 1, 0)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (G,)
        np.testing.assert_array_equal(g, np.zeros(G, np.float32))


@pytest.mark.parametrize("tgt", [0, 1, 2])
def test_grouped_family_equals_its_box_fan_out(rng, tgt):
    """The factored pass computes what the box sums compute on the family's
    boxes fanned out (each box = the shared box with its category's window
    on the group axis)."""
    g_axis, G = 1, 6
    x, h, lo, hi, glo, ghi = _family(rng, 400, 3, G)
    cnt, sm = ops.aqp_grouped_sums(*[_t(a) for a in (x, h, lo, hi, glo, ghi)],
                                   g_axis, tgt)
    blo = np.repeat(lo[None], G, axis=0)
    bhi = np.repeat(hi[None], G, axis=0)
    blo[:, g_axis], bhi[:, g_axis] = glo, ghi
    bc, bs = ref.aqp_box_sums(_t(x), _t(h), _t(blo), _t(bhi),
                              _t(np.full(G, tgt), torch.int32))
    np.testing.assert_allclose(cnt.numpy(), bc.numpy(), **CNT_TOL)
    np.testing.assert_allclose(sm.numpy(), bs.numpy(), **SUM_TOL)


def _grouped64(x, h, lo, hi, glo, ghi, g_axis, tgt):
    x, h = x.astype(np.float64), h.astype(np.float64)
    za, zb = (lo - x) / h, (hi - x) / h
    dP = ndtr(zb) - ndtr(za)
    mom = x * dP - h * (np.exp(-0.5 * zb ** 2) - np.exp(-0.5 * za ** 2)) / math.sqrt(2 * math.pi)
    xg, hg = x[:, g_axis:g_axis + 1], h[g_axis]
    gza, gzb = (glo[None] - xg) / hg, (ghi[None] - xg) / hg
    gP = ndtr(gzb) - ndtr(gza)
    gmom = xg * gP - hg * (np.exp(-0.5 * gzb ** 2) - np.exp(-0.5 * gza ** 2)) / math.sqrt(2 * math.pi)
    keep = np.arange(x.shape[1]) != g_axis
    cnt_i = np.prod(np.where(keep, dP, 1.0), axis=1)
    if tgt == g_axis:
        return (cnt_i[:, None] * gP).sum(0), (cnt_i[:, None] * gmom).sum(0)
    fac = np.where(np.arange(x.shape[1]) == tgt, mom, dP)
    sm_i = np.prod(np.where(keep, fac, 1.0), axis=1)
    return (cnt_i[:, None] * gP).sum(0), (sm_i[:, None] * gP).sum(0)


@pytest.mark.parametrize("tgt", [0, 1])
def test_grouped_plain_is_tail_stable_against_float64(rng, tgt):
    """Category windows far in the upper tail of the group axis (z of 4 and
    more for every row), where the reference's erf difference cancels to
    nothing in float32; the port holds float64."""
    x = rng.normal(0.0, 1.0, (200, 2)).astype(np.float32)
    h = np.asarray([0.5, 0.5], np.float32)
    lo, hi = np.asarray([-1.0, 0.0], np.float32), np.asarray([1.0, 0.0], np.float32)
    glo = np.asarray([5.0, 5.5, 6.0], np.float32)
    ghi = glo + 0.5
    cnt, sm = ops.aqp_grouped_sums(*[_t(a) for a in (x, h, lo, hi, glo, ghi)], 1, tgt)
    c64, s64 = _grouped64(x, h, lo, hi, glo, ghi, 1, tgt)
    np.testing.assert_allclose(cnt.numpy(), c64, rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(sm.numpy(), s64, rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("op", [0, 1, 2])
def test_batch_query_box_grouped_matches_reference(rng, backend, op):
    x, h, lo, hi, glo, ghi = _family(rng, 300, 3, 7)
    got = tmd.batch_query_box_grouped(_t(x), _t(h), lo, hi, glo, ghi, g_axis=2,
                                      tgt=0, op=op, scale=12.5, backend=backend)
    want = jmd.batch_query_box_grouped(jnp.asarray(x), jnp.asarray(h), lo, hi, glo,
                                       ghi, g_axis=2, tgt=0, op=op,
                                       scale=jnp.float32(12.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


# --- the store: GROUP BY over a joint that holds the dictionary column ------------

CAPACITY = 256
GJOINT = ("loss", "latency", "code")


def _stream(seed: int, batches: int = 3, rows: int = 600):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        latent = rng.normal(0, 1, rows)
        out.append({
            "loss": (2.0 + 0.5 * latent + rng.normal(0, 0.4, rows)).astype(np.float32),
            "latency": np.exp(3.0 + 0.3 * latent + rng.normal(0, 0.3, rows)).astype(np.float32),
            "code": rng.integers(0, 6, rows).astype(np.float32),
        })
    return out


def _fill(store, stream):
    store.track_joint(GJOINT)
    store.track_categorical("code")
    for batch in stream:
        store.add_batch(batch)
    return store


def _gspecs(m):
    """GROUP BY specs (COUNT / SUM / AVG, ranges on two columns, the group
    column in the joint), AVG of the group column itself (the tgt == g_axis
    branch), pinned categories, plus a plain box and an exact Eq."""
    preds = (m.Range("loss", 1.0, 3.0), m.Range("latency", 10.0, 40.0))
    return [
        m.AqpQuery("count", preds, group_by="code"),
        m.AqpQuery("sum", preds, target="loss", group_by="code"),
        m.AqpQuery("avg", preds, target="latency", group_by="code"),
        m.AqpQuery("avg", preds, target="code", group_by="code"),
        m.AqpQuery("count", (m.Range("loss", 2.0, 2.5), m.Range("latency", 0.0, 30.0)),
                   group_by=m.GroupBy("code", values=(1.0, 4.0))),
        m.AqpQuery("count", (m.Box(GJOINT, (1.0, 10.0, 0.0), (3.0, 30.0, 2.0)),)),
        m.AqpQuery("count", (m.Eq("code", 3),)),
    ]


@pytest.fixture(scope="module")
def gstores():
    stream = _stream(5)
    ref_store = _fill(jstore.TelemetryStore(capacity=CAPACITY, seed=0), stream)
    port = _fill(tstore.TelemetryStore(capacity=CAPACITY, seed=0, device="cpu"), stream)
    return ref_store, port, ref_store.query(_gspecs(jq))


@pytest.mark.parametrize("backend,suffix", [("torch", ""), ("cuda", ":cuda")])
def test_group_by_query_matches_reference(gstores, backend, suffix):
    _, port, want = gstores
    got = port.query(_gspecs(tq), backend=backend)
    assert len(got) == len(want) == 6 * 4 + 2 + 2
    scale = (3 * 600) / CAPACITY
    for g, w in zip(got, want):
        assert g.group == w.group and g.synopsis_version == w.synopsis_version
        if w.path == "exact":
            assert g.path == "exact"
            assert (g.estimate, g.ci_lo, g.ci_hi) == (w.estimate, w.ci_lo, w.ci_hi)
            continue
        assert g.path == w.path + suffix
        for field in ("estimate", "ci_lo", "ci_hi"):
            np.testing.assert_allclose(getattr(g, field), getattr(w, field),
                                       rtol=1e-4, atol=1e-4 * scale, err_msg=field)
        assert w.ci_lo - 1e-3 <= g.estimate <= w.ci_hi + 1e-3
    assert {g.path for g in got} == {"box:grouped" + suffix, "box" + suffix, "exact"}


def test_group_by_repeat_is_bit_identical_and_launches_nothing_on_cpu(gstores):
    _, port, _ = gstores
    ops.reset_launch_counts()
    first = port.query(_gspecs(tq), backend="cuda")
    misses = port.cache.stats()["misses"]
    again = port.query(_gspecs(tq), backend="cuda")
    assert [(r.estimate, r.ci_lo, r.ci_hi, r.path) for r in first] == \
        [(r.estimate, r.ci_lo, r.ci_hi, r.path) for r in again]
    assert port.cache.stats()["misses"] == misses
    assert sum(ops.launch_counts().values()) == 0     # CPU tensors: plain versions


def test_group_by_family_matches_fanned_out_box_queries(gstores):
    """A GROUP BY family answers what one Box spec per category answers."""
    _, port, _ = gstores
    grouped = port.query([tq.AqpQuery("sum", (tq.Range("loss", 1.0, 3.0),
                                              tq.Range("latency", 10.0, 40.0)),
                                      target="loss", group_by="code")])
    boxes = [tq.AqpQuery("sum", (tq.Box(GJOINT, (1.0, 10.0, r.group - 0.5),
                                        (3.0, 40.0, r.group + 0.5)),), target="loss")
             for r in grouped]
    fanned = port.query(boxes)
    assert {r.path for r in grouped} == {"box:grouped"}
    assert {r.path for r in fanned} == {"box"}
    np.testing.assert_allclose([r.estimate for r in grouped],
                               [r.estimate for r in fanned], rtol=1e-4, atol=1e-3)


# --- on the card ------------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def test_cuda_grouped_kernel_matches_plain_version(cuda_device, rng):
    ops.reset_launch_counts()
    for n, d, G, g_axis, tgt in ((1, 1, 1, 0, 0), (4097, 3, 64, 2, 0),
                                 (4097, 3, 64, 2, 2), (1000, 2, 130, 0, 1)):
        args = [_t(a).to(cuda_device) for a in _family(rng, n, d, G)]
        k = ops.aqp_grouped_sums(*args, g_axis, tgt)
        p = ref.aqp_grouped_sums(*args, g_axis, tgt)
        np.testing.assert_allclose(k[0].cpu(), p[0].cpu(), **CNT_TOL)
        np.testing.assert_allclose(k[1].cpu(), p[1].cpu(), **SUM_TOL)
    assert ops.launch_counts()["aqp_grouped_sums"] == 4
