"""A query's "cuda" answer does not depend on its micro-batch: the aqp_batch,
aqp_boxes and aqp_grouped launchers cut the sample into ranges from its
shape alone, so a query's per-range partials, and the fixed-order pass that
adds them, are the same whatever else rides in the launch.  Admission
sessions coalesce specs into small micro-batches, and their answers must be
bit-identical to one `QueryEngine.execute` of the same specs.

On the CPU the launchers run with their kernel call, device checks and
stream faked, to read the cut each would launch with; a float32 model of
the kernels' reduction order (lanes striding a range, the warp's shuffle
tree, the float64 second pass of `sum_tile_partials`; for GROUP BY a
thread's rows in order and `sum_partial_columns`) then gives one query the
same bits in a batch of 8 as in a batch of 256, where the earlier cut,
which took the range length from the query count, did not.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core.gaussian import phi_diff
from repro_torch.kernels import _launch, autotune, ops
from repro_torch.kernels import aqp_batch as tab
from repro_torch.kernels import aqp_boxes as tabx
from repro_torch.kernels import aqp_grouped as tagr

QS = (1, 8, 64, 256, 1024)
NS = (4096, 32_768)
F32 = np.float32


@pytest.fixture
def faked_launch(monkeypatch):
    """Run the launchers on CPU tensors up to their kernel call, recording
    the range length (points or rows per block) each passes to the kernel;
    the SM count, were a launcher to read it, raises."""
    seen = []

    def recorder(pos):
        def kernel(*args):
            seen.append(int(args[pos]))
            return 0
        return kernel

    def no_sm_count(index):
        raise AssertionError("the cut must not read the SM count")

    for mod, pos in ((tab, 6), (tabx, 8), (tagr, 14)):
        monkeypatch.setattr(mod, "_fn", lambda pos=pos: recorder(pos))
        monkeypatch.setattr(mod, "check_tensor", lambda *a, **k: None)
        monkeypatch.setattr(mod, "stream", lambda device: None)
    monkeypatch.setattr(_launch, "sm_count", no_sm_count)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    tagr._family_table.cache_clear()
    counts = (tab.launches.value, tabx.launches.value, tagr.launches.value)
    yield seen
    tagr._family_table.cache_clear()
    for c, v in zip((tab.launches, tabx.launches, tagr.launches), counts):
        c.value = v


def _cut(seen, launch):
    seen.clear()
    launch()
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("n", NS)
def test_range_cut_is_the_same_for_every_batch_size(faked_launch, n):
    x1, xd = torch.zeros(n), torch.zeros(n, 3)
    cuts = {"batch": set(), "boxes": set(), "grouped": set()}
    for q in QS:
        a = torch.zeros(q)
        cuts["batch"].add(_cut(faked_launch, lambda: tab.aqp_batch_moments(
            x1, torch.ones(1), a, a, tile=tab.TILE, ranges=tab.RANGES)))
        lo = torch.zeros(q, 3)
        cuts["boxes"].add(_cut(faked_launch, lambda: tabx.aqp_box_moments(
            xd, torch.ones(3), lo, lo, torch.zeros(q, dtype=torch.int32), tile=tabx.TILE,
            ranges=tabx.RANGES)))
        w = torch.zeros(1, 64)
        cuts["grouped"].add(_cut(faked_launch, lambda: tagr.aqp_grouped_moments(
            xd, torch.ones(3), lo, lo, w, w, [0] * q, [2] * q, [i % 3 for i in range(q)],
            tile=tagr.TILE, ranges=tagr.RANGES)))
    assert cuts == {"batch": {_launch.fixed_range(n, tab.RANGES, 32, tab.TILE)},
                    "boxes": {_launch.fixed_range(n, tabx.RANGES, 32, tabx.TILE)},
                    "grouped": {_launch.fixed_range(n, tagr.RANGES, tagr.SUB, tagr.TILE)}}


@pytest.mark.parametrize("n", NS)
def test_a_tuned_cut_stays_a_function_of_n(faked_launch, n):
    """With tuned `ranges` in the tile cache, each recorded at one batch
    size, the `ops` wrappers (on meta tensors, standing in for the card)
    cut the sample the same way for every batch size: the range kernels'
    cache key leaves the batch out, so a tuned cut keeps a query's bits
    independent of its micro-batch."""
    tuned = {"aqp_batch_sums": ({"n": n, "G": 256}, 32),
             "aqp_box_sums": ({"n": n, "d": 3, "G": 8}, 128),
             "aqp_grouped_sums": ({"n": n, "d": 3, "G": 64}, 64)}
    mods = {"aqp_batch_sums": tab, "aqp_box_sums": tabx, "aqp_grouped_sums": tagr}
    autotune.reset()
    try:
        for kernel, (shape, ranges) in tuned.items():
            autotune.record(kernel, shape, {"tile": mods[kernel].TILE, "ranges": ranges})
        meta = {"device": "meta"}
        x1, xd, h3 = torch.zeros(n, **meta), torch.zeros(n, 3, **meta), torch.ones(3, **meta)
        w = torch.zeros(1, 64, **meta)
        cuts = {k: set() for k in tuned}
        for q in QS:
            a, lo = torch.zeros(q, **meta), torch.zeros(q, 3, **meta)
            cuts["aqp_batch_sums"].add(_cut(faked_launch, lambda: ops.aqp_batch_moments(
                x1, torch.ones(1, **meta), a, a)))
            cuts["aqp_box_sums"].add(_cut(faked_launch, lambda: ops.aqp_box_moments(
                xd, h3, lo, lo, torch.zeros(q, dtype=torch.int32, **meta))))
            cuts["aqp_grouped_sums"].add(_cut(faked_launch, lambda: ops.aqp_grouped_moments(
                xd, h3, lo, lo, w, w, [0] * q, [2] * q, [i % 3 for i in range(q)])))
    finally:
        autotune.reset()
    want = {k: {_launch.fixed_range(n, r, 32, mods[k].TILE)} for k, (_s, r) in tuned.items()}
    assert cuts == want
    for k, (_s, r) in tuned.items():      # and the cache was read, not the constant
        assert want[k] != {_launch.fixed_range(n, mods[k].RANGES, 32, mods[k].TILE)}


@pytest.mark.parametrize("ranges,step,tile", [(160, 32, 4096), (64, 32, 4096),
                                              (128, 32, 1024)])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 4095, 4096, 32_768, 1_000_000])
def test_fixed_range_is_a_step_multiple_within_the_tile(n, ranges, step, tile):
    per = _launch.fixed_range(n, ranges, step, tile)
    assert per % step == 0 and step <= per <= tile
    assert -(-n // per) <= ranges or per == tile
    if per > step:                      # the fewest that keep within `ranges`
        assert -(-n // (per - step)) > ranges or per == tile


def test_main_path_shapes_keep_their_earlier_cut():
    """At the main path's n = 32 768 the cut is the one the earlier,
    occupancy-driven rule chose for its launches there (q = 256 ranges,
    q = 384 boxes at d = 3, 104 GROUP BY families in 4 family tiles), so
    those launches keep their device times."""
    assert _launch.fixed_range(32_768, tab.RANGES, 32, tab.TILE) == \
        _launch.point_range(32_768, 256 // tab.Q_TILE, 132, 5, 2, tab.TILE) == 224
    assert _launch.fixed_range(32_768, tabx.RANGES, 32, tabx.TILE) == \
        _launch.point_range(32_768, 384 // tabx.Q_TILE, 132, 3, 2, tabx.TILE) == 512
    ranges = -(-4 * 132 // 4)
    assert _launch.fixed_range(32_768, tagr.RANGES, tagr.SUB, tagr.TILE) == \
        -(-(-(-32_768 // ranges)) // 32) * 32 == 256


# --- the kernels' reduction order, modelled in float32 ---------------------------------

def _warp_ranges(terms, pts):
    """aqp_batch.cu / aqp_boxes.cu: per range of `pts` points, lane l adds
    points l, l + 32, ... in float32, then the warp's shuffle-down tree;
    returns (q, ranges) float32 partials."""
    q, n = terms.shape
    n_ranges = -(-n // pts)
    steps = -(-pts // 32)
    padded = np.zeros((q, n_ranges * steps * 32), F32)
    for r in range(n_ranges):
        begin, end = r * pts, min(n, (r + 1) * pts)
        padded[:, r * steps * 32:r * steps * 32 + end - begin] = terms[:, begin:end]
    lanes = padded.reshape(q, n_ranges, steps, 32)
    acc = np.zeros((q, n_ranges, 32), F32)
    for s in range(steps):
        acc = (acc + lanes[:, :, s, :]).astype(F32)
    for off in (16, 8, 4, 2, 1):
        acc = np.concatenate([acc[..., :32 - off] + acc[..., off:], acc[..., 32 - off:]],
                             axis=-1).astype(F32)
    return acc[..., 0]


def _sum_tile_partials(partials):
    """common.cuh's sum_tile_partials: 256 threads add strided partials in
    float64, then a shared-memory tree; the float32 result per row."""
    q, m = partials.shape
    width = 256 * -(-m // 256)
    padded = np.zeros((q, width), np.float64)
    padded[:, :m] = partials
    s = padded.reshape(q, -1, 256)
    acc = np.zeros((q, 256), np.float64)
    for k in range(s.shape[1]):
        acc = acc + s[:, k, :]
    w = 128
    while w:
        acc = np.concatenate([acc[:, :w] + acc[:, w:2 * w], acc[:, w:]], axis=1)
        w //= 2
    return acc[:, 0].astype(F32)


def _grouped_columns(terms, rows):
    """aqp_grouped.cu: a thread adds its range's rows in order in float32;
    sum_partial_columns adds the ranges in order in float32."""
    q, n = terms.shape
    out = np.zeros(q, F32)
    for r in range(-(-n // rows)):
        part = np.zeros(q, F32)
        for i in range(r * rows, min(n, (r + 1) * rows)):
            part = (part + terms[:, i]).astype(F32)
        out = (out + part).astype(F32)
    return out


def _range_terms(rng, n, q):
    """(q, n) float32 count terms c_qi of a range batch, as the plain
    version forms them."""
    x = torch.as_tensor(rng.normal(0.0, 2.0, n).astype(F32))
    a = torch.as_tensor(rng.uniform(-4.0, 1.0, q).astype(F32))
    b = a + torch.as_tensor(rng.uniform(0.5, 4.0, q).astype(F32))
    h = torch.tensor(0.3)
    return phi_diff((a[:, None] - x[None, :]) / h,
                    (b[:, None] - x[None, :]) / h).numpy().astype(F32)


def _kernel_sums(terms, pts):
    return _sum_tile_partials(_warp_ranges(terms, pts))


@pytest.mark.parametrize("n", NS)
def test_a_query_has_the_same_bits_in_a_batch_of_8_as_in_256(rng, faked_launch, n):
    terms = _range_terms(rng, n, 256)
    x1 = torch.zeros(n)

    def cut(q):
        a = torch.zeros(q)
        return _cut(faked_launch, lambda: tab.aqp_batch_moments(x1, torch.ones(1), a, a,
                                                                tile=tab.TILE,
                                                                ranges=tab.RANGES))

    big = _kernel_sums(terms, cut(256))[:8]
    small = _kernel_sums(terms[:8], cut(8))
    assert np.array_equal(small.view(np.int32), big.view(np.int32))


def test_the_earlier_cut_gave_a_query_other_bits_in_a_smaller_batch(rng):
    """The fault this repairs: the earlier cut took the range length from
    the query tiles (and the card's occupancy), 32-point ranges at q = 8
    against 224-point ones at q = 256 at n = 32 768, and some queries'
    float32 sums then differed in their last bits (each query of the 256
    taken alone in a batch of 8, against the batch of 256)."""
    n = 32_768
    terms = _range_terms(rng, n, 256)
    old = {q: _launch.point_range(n, -(-q // tab.Q_TILE), 132, 5, 2, tab.TILE)
           for q in (8, 256)}
    assert old == {8: 32, 256: 224}
    old_small = _kernel_sums(terms, old[8])
    old_big = _kernel_sums(terms, old[256])
    assert np.any(old_small.view(np.int32) != old_big.view(np.int32))
    np.testing.assert_allclose(old_small, old_big, rtol=1e-5)


def test_a_family_has_the_same_bits_whatever_families_share_its_launch(rng,
                                                                       faked_launch):
    n = 4096
    terms = _range_terms(rng, n, 104)
    xd, w = torch.zeros(n, 3), torch.zeros(1, 64)

    def cut(f):
        lo = torch.zeros(f, 3)
        return _cut(faked_launch, lambda: tagr.aqp_grouped_moments(
            xd, torch.ones(3), lo, lo, w, w, [0] * f, [2] * f, [0] * f, tile=tagr.TILE,
            ranges=tagr.RANGES))

    big = _grouped_columns(terms, cut(104))[:8]
    small = _grouped_columns(terms[:8], cut(8))
    assert np.array_equal(small.view(np.int32), big.view(np.int32))
