"""The "cuda" distributed LSCV_h without a whole S: the sv_precompute
kernel's column blocks of S (`ops.sv_matrix(..., cols=(c0, c1))`), the
lscv_grid kernel over a block (`ops.lscv_grid_sums_from_s(..., slab=(c0,
n))`), the walk of a tile share in runs whose slabs fit a byte budget
(`kernels.lscv_grid.slab_walk`) and `core.distributed.sharded_lscv_h_grid`
over it, on the CPU through the wrappers' plain versions, against the
whole-S path and the JAX reference's `lscv_grid_sums`.  On a machine with
a CUDA device, the kernels themselves: a slab has the whole S's bits, and
each run's sums the bits of the same tiles launched over the whole S (the
file imports JAX only inside the test that needs the reference, so the card
tests run where JAX is not installed).

Tolerances: a block's entries equal the whole S's (the same differences and
products); sums over a slab against the whole S's at rtol 1e-5 (float32
sums in another order); the chunked walk against one share and against the
reference at `tests/test_torch_lscv_kernels.py`'s rtol 1e-4 / atol 1e-3 for
the kernel's tile sums.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.kernels import lscv_grid as tlg
from repro_torch.kernels import ops, triangle
from repro_torch.kernels.sv_precompute import slab_cols
from repro_torch.kernels.triangle import bx_to_ql, n_tri_tiles

F32 = np.float32
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
SHARE_TOL = dict(rtol=1e-4, atol=1e-3)


def _data(rng, n, d):
    x = torch.as_tensor(rng.normal(0, 1, (n, d)).astype(F32))
    a = rng.normal(0, 0.3, (d, d))
    m = torch.as_tensor((a @ a.T + np.eye(d)).astype(F32))
    return x, m


@pytest.mark.parametrize("n,d,cols", [(1, 1, (0, 1)), (70, 1, (0, 64)), (200, 3, (64, 128)),
                                      (200, 3, (128, 200)), (131, 2, (5, 6)), (40, 2, (7, 7))])
def test_slab_is_the_whole_s_transposed(rng, n, d, cols):
    """A slab is the column block S[:c1, c0:c1] of the whole S, bit for bit."""
    x, m = _data(rng, n, d)
    whole = ops.sv_matrix(x, m)
    slab = ops.sv_matrix(x, m, cols=cols)
    c0, c1 = cols
    assert slab.shape == (c1, c1 - c0)
    torch.testing.assert_close(slab, whole[:c1, c0:c1], rtol=0, atol=0)


def test_slab_rows_are_checked():
    """The columns a slab is cut at are checked against n."""
    for cols in ((-1, 3), (4, 3), (0, 51)):
        with pytest.raises(ValueError):
            slab_cols(cols, 50)
    assert slab_cols((3, 50), 50) == (3, 50)


@pytest.mark.parametrize("n", [1, 64, 65, 300, 1000])
@pytest.mark.parametrize("budget", [1, 64 * 64 * 4 * 3, 1 << 20, 1 << 40])
def test_walk_covers_its_tiles_once_in_runs_that_fit(n, budget):
    tile = tlg.TILE
    n_tri = n_tri_tiles(-(-n // tile))
    for world in (1, 3):
        for rank in range(world):
            begin, count = triangle.share(n_tri, rank, world)
            runs = list(tlg.slab_walk(n, (begin, count), budget))
            assert sum(c for _, c, _, _ in runs) == count
            nxt = begin
            for b, c, c0, c1 in runs:
                assert b == nxt and c >= 1
                nxt = b + c
                cols = {int(bx_to_ql(t)[1]) for t in range(b, b + c)}
                assert c0 == min(cols) * tile and c1 == min(n, (max(cols) + 1) * tile)
                if len(cols) > 1:
                    assert 4 * (c1 - c0) * c1 <= budget
            if budget >= 4 * n * n and count:
                assert len(runs) == 1


@pytest.mark.parametrize("n,d,n_h", [(100, 1, 7), (300, 2, 15), (257, 3, 4)])
def test_slab_sums_equal_the_whole_s_sums(rng, n, d, n_h):
    x, m = _data(rng, n, d)
    hg = torch.linspace(0.1, 1.5, n_h)
    whole = ops.sv_matrix(x, m)
    n_tri = n_tri_tiles(-(-n // tlg.TILE))
    for blocks in ((0, n_tri), triangle.share(n_tri, 1, 3), (n_tri - 1, 1)):
        want = ops.lscv_grid_sums_from_s(whole, hg, 0.3, 0.2, blocks=blocks)
        for b, c, c0, c1 in tlg.slab_walk(n, blocks, 1 << 40):
            slab = ops.sv_matrix(x, m, cols=(c0, c1))
            got = ops.lscv_grid_sums_from_s(slab, hg, 0.3, 0.2, blocks=(b, c), slab=(c0, n))
            torch.testing.assert_close(got, want, **SUM_TOL)


def test_chunked_walk_sums_to_the_share_and_the_reference(rng):
    jnp = pytest.importorskip("jax.numpy")           # the reference, where JAX is installed
    from repro.kernels import ref as jref
    n, d, n_h = 400, 2, 12
    x, m = _data(rng, n, d)
    hg = torch.linspace(0.1, 1.5, n_h)
    whole = ops.sv_matrix(x, m)
    n_tri = n_tri_tiles(-(-n // tlg.TILE))
    want_ref = np.asarray(jref.lscv_grid_sums(jnp.asarray(x.numpy()), jnp.asarray(m.numpy()),
                                              jnp.asarray(hg.numpy()), 0.3, 0.2))
    total = torch.zeros(n_h, dtype=torch.float64)
    n_runs = 0
    for rank in range(3):
        share = triangle.share(n_tri, rank, 3)
        runs = list(tlg.slab_walk(n, share, 4 * 128 * 256))
        n_runs += len(runs)
        got = torch.zeros(n_h)
        for b, c, c0, c1 in runs:
            slab = ops.sv_matrix(x, m, cols=(c0, c1))
            got = got + ops.lscv_grid_sums_from_s(slab, hg, 0.3, 0.2, blocks=(b, c),
                                                  slab=(c0, n))
        one = ops.lscv_grid_sums_from_s(whole, hg, 0.3, 0.2, blocks=share)
        np.testing.assert_allclose(got, one, **SHARE_TOL)
        total += got.double()
    assert n_runs > 3
    np.testing.assert_allclose(total, want_ref, **SHARE_TOL)


@pytest.fixture()
def group1(tmp_path):
    D.init_group(str(tmp_path / "store"), 0, 1, device="cpu", timeout_s=60)
    yield None
    torch.distributed.destroy_process_group()


def test_distributed_grid_walks_slabs_of_its_budget(group1, rng, monkeypatch):
    """`sharded_lscv_h_grid` on "cuda" makes one sv_matrix slab and one
    lscv_grid call a run of its walk, no slab above the budget when a run
    holds more than one column, and sums the runs to the unchunked grid."""
    x, m = _data(rng, 330, 2)
    hg = torch.linspace(0.1, 1.5, 9)
    seen = []
    real = ops.sv_matrix

    def spy(xx, mm, tile=None, algorithm="mxu", cols=None):
        out = real(xx, mm, tile=tile, algorithm=algorithm, cols=cols)
        seen.append((cols, out.numel() * 4))
        return out

    monkeypatch.setattr(ops, "sv_matrix", spy)
    budget = 4 * 128 * 200
    got = D.sharded_lscv_h_grid(x, m, hg, 0.3, 0.2, backend="cuda", device="cpu",
                                slab_bytes=budget)
    runs = list(tlg.slab_walk(330, None, budget))
    assert [c for c, _ in seen] == [(c0, c1) for _, _, c0, c1 in runs] and len(runs) > 2
    big = D.sharded_lscv_h_grid(x, m, hg, 0.3, 0.2, backend="cuda", device="cpu")
    np.testing.assert_allclose(got, big, **SHARE_TOL)
    want = D.sharded_lscv_h_grid(x, m, hg, 0.3, 0.2, backend="torch", device="cpu")
    np.testing.assert_allclose(got, want, **SHARE_TOL)


# --- on the card -----------------------------------------------------------------------

@pytest.fixture()
def cuda_device():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def test_cuda_slab_has_the_whole_s_bits_and_the_walk_its_sums(cuda_device, rng):
    dev = cuda_device
    for n, d, n_h in ((1, 1, 3), (65, 2, 33), (1001, 3, 150), (4100, 1, 7)):
        x, m = (t.to(dev) for t in _data(rng, n, d))
        whole = ops.sv_matrix(x, m)
        hg = torch.linspace(0.05, 2.0, n_h, device=dev)
        want = ops.lscv_grid_sums_from_s(whole, hg, 0.3, 0.2).double()
        got = torch.zeros(n_h, dtype=torch.float64, device=dev)
        for b, c, c0, c1 in tlg.slab_walk(n, None, 4 * 512 * 1024):
            slab = ops.sv_matrix(x, m, cols=(c0, c1))
            assert torch.equal(slab, whole[:c1, c0:c1]), f"n={n} columns {c0}..{c1}"
            k1 = ops.lscv_grid_sums_from_s(slab, hg, 0.3, 0.2, blocks=(b, c), slab=(c0, n))
            k2 = ops.lscv_grid_sums_from_s(slab, hg, 0.3, 0.2, blocks=(b, c), slab=(c0, n))
            assert torch.equal(k1, k2)
            # the same tiles of the same values in the same order: the same bits
            assert torch.equal(k1, ops.lscv_grid_sums_from_s(whole, hg, 0.3, 0.2,
                                                             blocks=(b, c)))
            got += k1.double()
        np.testing.assert_allclose(got.cpu(), want.cpu(), **SHARE_TOL)
