"""The port's distributed selectors (`repro_torch.core.distributed`) on the
CPU over gloo, against the JAX reference's single-path results and its own
sharded functions, with seeded numpy inputs handed to both packages.

- World size 1 in this process (a `file://` store, destroyed after each
  test), on both backends: "torch" is the reference's strided algorithm,
  "cuda" the kernels' tile shares, whose wrappers take the plain versions
  on CPU tensors.
- 4 gloo ranks as 4 processes (with a timeout), each passing the same x:
  every rank's all_reduced sums equal, and close to the reference's single
  path; then a tile cache seen by one rank only, which every rank refuses.
- The reference's own `sharded_pairwise_reduce` / `distributed_lscv_h` on
  4 placeholder devices, run only in a process of their own, outside
  pytest's error::DeprecationWarning filter (JAX 0.9 deprecates the
  `jax.lax.pvary` they call), against the port's 4 ranks.
- `triangle.share`: every tile once, in contiguous runs that differ by at
  most one tile.

Tolerances are `tests/test_distributed.py`'s: rtol 1e-4 on a pairwise sum,
1e-3 on g values at world size 1 and 2e-3 across devices, and the same h.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import gaussian as jG
from repro.core import lscv_h as j_lscv_h
from repro.core.reductions import pairwise_reduce as j_pairwise_reduce
from repro_torch.core import distributed as D
from repro_torch.core import gaussian as G
from repro_torch.kernels import triangle

ROOT = Path(__file__).resolve().parents[1]
F32 = np.float32
WORLD = 4
TIMEOUT = 300


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, 1000).astype(F32), rng.normal(0, 1, (300, 3)).astype(F32))


def _reference_single(x, x2, n_h):
    """The reference's single path: pairwise_reduce's K4 / K6 / K4 sums and lscv_h."""
    xj = jnp.asarray(x)
    res = j_lscv_h(jnp.asarray(x2), n_h=n_h)
    return {"k4": float(j_pairwise_reduce(lambda d: jG.k4(d / 0.3), xj)),
            "k6": float(j_pairwise_reduce(lambda d: jG.k6(d / 0.4), xj)),
            "h": float(res.h), "g": np.asarray(res.g_values)}


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu")


@pytest.fixture()
def group1(tmp_path):
    """A gloo group of one rank, destroyed after the test."""
    D.init_group(str(tmp_path / "store"), 0, 1, device="cpu", timeout_s=60)
    yield None
    dist.destroy_process_group()


# --- world size 1, in this process -------------------------------------------------

def test_sharded_pairwise_reduce_one_rank(group1):
    x, _ = _inputs()
    want = float(j_pairwise_reduce(lambda d: jG.k6(d / 0.4), jnp.asarray(x)))
    got = D.sharded_pairwise_reduce(lambda d: G.k6(d / 0.4), x, device="cpu")
    assert got.shape == () and float(got) == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_plugin_psi_sums_one_rank(group1, backend):
    x, x2 = _inputs()
    ref = _reference_single(x, x2[:20], 3)
    s6, s4 = D.sharded_plugin_psi_sums(x, 0.4, 0.3, backend=backend, device="cpu")
    assert float(s6) == pytest.approx(ref["k6"], rel=1e-4)
    assert float(s4) == pytest.approx(ref["k4"], rel=1e-4)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("d", [1, 2])
def test_distributed_lscv_h_one_rank(group1, rng, backend, d):
    x = rng.normal(0, 1, (200, d)).astype(F32)
    ref = j_lscv_h(jnp.asarray(x), n_h=15)
    h, grid, g = D.distributed_lscv_h(x, n_h=15, backend=backend, device="cpu")
    np.testing.assert_allclose(g.numpy(), np.asarray(ref.g_values), rtol=1e-3)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(ref.h_grid))
    assert float(h) == float(ref.h)


def test_lscv_grid_algorithms_agree_one_rank(group1, rng):
    x = rng.normal(0, 1, (150, 3)).astype(F32)
    hg = np.linspace(0.1, 1.0, 11).astype(F32)
    out = {alg: D.sharded_lscv_h_grid(x, np.eye(3, dtype=F32), hg, 0.3, 0.2, algorithm=alg,
                                      backend="torch", device="cpu").numpy()
           for alg in ("mxu", "einsum")}
    kern = D.sharded_lscv_h_grid(x, np.eye(3, dtype=F32), hg, 0.3, 0.2, backend="cuda",
                                 device="cpu").numpy()
    np.testing.assert_allclose(out["mxu"], out["einsum"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(kern, out["einsum"], rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="unknown algorithm"):
        D.sharded_lscv_h_grid(x, np.eye(3, dtype=F32), hg, 0.3, 0.2, algorithm="paper",
                              device="cpu")


@pytest.mark.parametrize("call", ["pairwise", "psi", "lscv"])
def test_uninitialised_group_raises(call):
    assert not dist.is_initialized()
    x, x2 = _inputs()
    with pytest.raises(RuntimeError, match="not initialised"):
        if call == "pairwise":
            D.sharded_pairwise_reduce(G.k4, x, device="cpu")
        elif call == "psi":
            D.sharded_plugin_psi_sums(x, 0.4, 0.3, backend="cuda", device="cpu")
        else:
            D.distributed_lscv_h(x2, n_h=5, device="cpu")


# --- the share of each rank ----------------------------------------------------------

@pytest.mark.parametrize("n_tri", [0, 1, 3, 15, 21, 528, 131_328])
@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_share_covers_every_tile_once(n_tri, world):
    parts = [triangle.share(n_tri, r, world) for r in range(world)]
    assert parts[0][0] == 0
    for (b0, c0), (b1, _) in zip(parts, parts[1:]):
        assert b0 + c0 == b1
    assert sum(c for _, c in parts) == n_tri
    counts = [c for _, c in parts]
    assert max(counts) - min(counts) <= 1
    for b, c in parts:
        assert triangle.block_range((b, c), n_tri) == (b, c)


def test_share_and_block_range_refuse_what_they_cannot_cut():
    for rank, world in ((4, 4), (-1, 4), (0, 0)):
        with pytest.raises(ValueError):
            triangle.share(10, rank, world)
    for blocks in ((-1, 2), (3, 8), (0, -1)):
        with pytest.raises(ValueError):
            triangle.block_range(blocks, 10)
    assert triangle.block_range(None, 10) == (0, 10)


def test_pair_tile_is_the_tile_of_eqs_49_50():
    i, j = torch.meshgrid(torch.arange(300), torch.arange(300), indexing="ij")
    keep = i < j
    bx = triangle.pair_tile(i[keep], j[keep], 64)
    q, l = triangle.bx_to_ql(bx)
    assert torch.equal(q, i[keep] // 64) and torch.equal(l, j[keep] // 64)


# --- 4 gloo ranks, and the reference's own sharded functions ---------------------------

WORKER = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.core import distributed as D, gaussian as G
from repro_torch.kernels import autotune
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
D.init_group(d + "/store", rank, world, device="cpu", timeout_s=120)
x, x2 = np.load(d + "/x.npy"), np.load(d + "/x2.npy")
out = {"k4": float(D.sharded_pairwise_reduce(lambda t: G.k4(t / 0.3), x, device="cpu"))}
for be in ("torch", "cuda"):
    s6, s4 = D.sharded_plugin_psi_sums(x, 0.4, 0.3, backend=be, device="cpu")
    h, grid, g = D.distributed_lscv_h(x2, n_h=20, backend=be, device="cpu")
    out[be] = {"k6": float(s6), "k4": float(s4), "h": float(h), "g": g.tolist()}
if rank == 0:      # a tuned tile that only this rank has seen
    autotune.record("pairwise_scaled_ksum", {"n": x.shape[0]}, {"tile": 256})
try:
    D.sharded_plugin_psi_sums(x, 0.4, 0.3, backend="cuda", device="cpu")
    out["mismatch"] = ""
except RuntimeError as e:
    out["mismatch"] = str(e)
json.dump(out, open(d + "/out%d.json" % rank, "w"))
dist.destroy_process_group()
"""

REFERENCE_SHARDED = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.core import gaussian as G
from repro.core.distributed import distributed_lscv_h, sharded_pairwise_reduce
d = sys.argv[1]
mesh = jax.make_mesh((2, 2), ("data", "model"))
x, x2 = jnp.asarray(np.load(d + "/x.npy")), jnp.asarray(np.load(d + "/x2.npy"))
h, grid, g = distributed_lscv_h(x2, mesh, n_h=20)
print(json.dumps({"k4": float(sharded_pairwise_reduce(lambda t: G.k4(t / 0.3), x, mesh)),
                  "k6": float(sharded_pairwise_reduce(lambda t: G.k6(t / 0.4), x, mesh)),
                  "h": float(h), "g": np.asarray(g).tolist()}))
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The port on 4 gloo ranks and the reference's sharded functions on 4
    placeholder devices, each in processes of their own, on one input."""
    d = tmp_path_factory.mktemp("dist4")
    x, x2 = _inputs()
    np.save(d / "x.npy", x)
    np.save(d / "x2.npy", x2)
    ranks = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(WORLD), str(d)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    jref = subprocess.run([sys.executable, "-c", REFERENCE_SHARDED, str(d)], env=_env(),
                          capture_output=True, text=True, timeout=TIMEOUT)
    try:
        errs = [p.communicate(timeout=TIMEOUT)[1] for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for p, err in zip(ranks, errs):
        assert p.returncode == 0, err[-2000:]
    assert jref.returncode == 0, jref.stderr[-2000:]
    outs = [json.loads((d / f"out{r}.json").read_text()) for r in range(WORLD)]
    return outs, json.loads(jref.stdout.strip().splitlines()[-1]), _reference_single(x, x2, 20)


def test_four_ranks_agree_with_each_other(four_ranks):
    outs, _, _ = four_ranks
    for out in outs[1:]:
        assert {k: v for k, v in out.items() if k != "mismatch"} == \
            {k: v for k, v in outs[0].items() if k != "mismatch"}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_four_ranks_match_reference_single_path(four_ranks, backend):
    outs, _, ref = four_ranks
    got = outs[0][backend]
    assert outs[0]["k4"] == pytest.approx(ref["k4"], rel=1e-4)
    assert got["k4"] == pytest.approx(ref["k4"], rel=1e-4)
    assert got["k6"] == pytest.approx(ref["k6"], rel=1e-4)
    np.testing.assert_allclose(got["g"], ref["g"], rtol=2e-3)
    assert got["h"] == ref["h"]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_four_ranks_match_reference_sharded(four_ranks, backend):
    outs, jsharded, _ = four_ranks
    got = outs[0][backend]
    assert outs[0]["k4"] == pytest.approx(jsharded["k4"], rel=1e-4)
    assert got["k6"] == pytest.approx(jsharded["k6"], rel=1e-4)
    np.testing.assert_allclose(got["g"], jsharded["g"], rtol=2e-3)
    assert got["h"] == jsharded["h"]


def test_four_ranks_refuse_a_tile_one_rank_tuned(four_ranks):
    outs, _, _ = four_ranks
    for out in outs:
        assert "disagree" in out["mismatch"] and "tile" in out["mismatch"]
