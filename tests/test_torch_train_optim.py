"""The port's AdamW (`repro_torch/optim/adamw.py`) and int8 gradient
compression (`repro_torch/optim/grad_compress.py`) against the JAX
package's, on the same numpy inputs.

Tolerances:
- `schedule`: rtol 1e-6 (XLA's float32 cos and PyTorch's differ in the last
  bit at some steps);
- `update` in float32: parameters, m and v within 1e-6 relative (atol 1e-6
  x the leaf's max |value|), grad_norm rtol 1e-6, lr as `schedule`;
- `update` on bf16 parameters: within one bf16 ulp of the reference's (the
  update is computed in float32 and rounded once, in both packages);
- `quantize`: payload, scale and residual bit-equal;
- `compressed_psum` on 4 gloo ranks, each a process of its own, against the
  reference's on 4 placeholder devices in a process of its own: the reduced
  gradients bit-equal; the residuals g + e - q scale within one float32 ulp
  of max |g + e| (jitted XLA contracts the product and the difference into
  one FMA, PyTorch rounds the product first), and so the second call, which
  carries them, within rtol 1e-6.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import adamw as R
from repro.optim import grad_compress as RC
from repro_torch.core import distributed as D
from repro_torch.optim import adamw, grad_compress

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 300
SHAPES = {"a": (37, 11), "b": (5,), "c": (3, 4, 6)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size tensors run on one intra-op thread: under the parallel
    test run several workers' thread pools would otherwise oversubscribe
    the cores (a 2.5 s test took 47 s beside one other worker)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port_cfg(cfg: R.AdamWConfig) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(**cfg.__dict__)


# --- AdamW ----------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [R.AdamWConfig(warmup_steps=3, total_steps=12),
                                 R.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=5,
                                               min_lr_frac=0.0),
                                 R.AdamWConfig()],
                         ids=["warm3", "nowarm", "default"])
def test_schedule_matches_reference(cfg):
    steps = range(0, min(cfg.total_steps + 3, 300))
    want = np.array([np.float32(R.schedule(cfg, jnp.int32(s))) for s in steps])
    got = np.array([adamw.schedule(_port_cfg(cfg), torch.tensor(s, dtype=torch.int32)).item()
                    for s in steps], np.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0 and want[0] == 0.0


def _trees(rng, dtype: str, grad_scale: float):
    p = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
    g = {k: (rng.normal(0, 1, s) * grad_scale).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    tp = {k: torch.tensor(np.asarray(jp[k], np.float32)).to(getattr(torch, dtype)) for k in jp}
    return jp, tp, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_update_matches_reference(rng, dtype, grad_scale):
    """Three updates of a random tree: parameters, m, v, grad_norm, lr and
    count; with grad_scale 10 the global norm is far above grad_clip and
    the clip is active."""
    cfg = R.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jp, tp, g = _trees(rng, dtype, grad_scale)
    jst, tst = R.init(jp), adamw.init(tp)
    jupdate = jax.jit(lambda g, s, p: R.update(cfg, g, s, p))
    for it in range(3):
        grads = {k: v * (it + 1) for k, v in g.items()}
        jp, jst, jm = jupdate({k: jnp.asarray(v) for k, v in grads.items()}, jst, jp)
        tp, tst, tm = adamw.update(_port_cfg(cfg), {k: torch.tensor(v) for k, v in grads.items()},
                                   tst, tp)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    if grad_scale > 1:
        assert float(jm["grad_norm"]) > 10 * cfg.grad_clip
    assert int(tst.count) == int(jst.count) == 3 and tst.count.dtype == torch.int32
    for k in SHAPES:
        assert tp[k].dtype == getattr(torch, dtype)
        assert tst.m[k].dtype == tst.v[k].dtype == torch.float32
        for got, want in ((tst.m[k], jst.m[k]), (tst.v[k], jst.v[k])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
        want = np.asarray(jp[k], np.float32)
        got = tp[k].float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        else:                          # one bf16 ulp: 2^-7 of the binade
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
            assert (np.abs(got - want) <= ulp).all()


def test_update_takes_lists_and_keeps_the_parameters_tensors():
    params = [torch.ones(3, 2), torch.zeros(4, dtype=torch.bfloat16)]
    ids = [id(p) for p in params]
    state = adamw.init(params)
    out, state, metrics = adamw.update(adamw.AdamWConfig(warmup_steps=1),
                                       [torch.ones(3, 2), torch.ones(4)], state, params)
    assert [id(p) for p in out] == ids
    assert float(out[0][0, 0]) < 1.0 and float(out[1][0]) < 0.0
    assert float(metrics["grad_norm"]) == pytest.approx(np.sqrt(10.0))
    assert int(state.count) == 1


def test_global_norm_matches_reference(rng):
    tree = {k: rng.normal(0, 3, s).astype(np.float32) for k, s in SHAPES.items()}
    want = float(R.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = float(adamw.global_norm({k: torch.tensor(v).to(torch.bfloat16).float()
                                   if k == "b" else torch.tensor(v) for k, v in tree.items()}))
    want_b = float(R.global_norm({k: jnp.asarray(v, jnp.bfloat16) if k == "b" else
                                  jnp.asarray(v) for k, v in tree.items()}))
    assert got == pytest.approx(want_b, rel=1e-6) and want_b == pytest.approx(want, rel=1e-2)


@pytest.mark.parametrize("sizes", [[5, 1 << 28, 3, 4, 1 << 27, 1 << 27, 1], [1], [],
                                   [1 << 29, 1 << 29], [7] * 10])
def test_chunks_cover_every_leaf_in_order(sizes):
    chunks = list(adamw._chunks(sizes))
    assert [i for lo, hi in chunks for i in range(lo, hi)] == list(range(len(sizes)))
    for lo, hi in chunks:
        assert hi - lo == 1 or sum(sizes[lo:hi]) <= adamw.CHUNK_ELEMENTS


def test_update_in_chunks_equals_one_chunk(rng, monkeypatch):
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    tree = {k: torch.tensor(rng.normal(0, 1, s).astype(np.float32)) for k, s in SHAPES.items()}
    grads = {k: torch.tensor(rng.normal(0, 1, s).astype(np.float32)) for k, s in SHAPES.items()}
    whole = {k: v.clone() for k, v in tree.items()}
    _, s1, _ = adamw.update(cfg, grads, adamw.init(whole), whole)
    monkeypatch.setattr(adamw, "CHUNK_ELEMENTS", 50)
    assert len(list(adamw._chunks([v.numel() for v in tree.values()]))) == 3
    _, s2, _ = adamw.update(cfg, grads, adamw.init(tree), tree)
    for k in tree:
        assert torch.equal(tree[k], whole[k]) and torch.equal(s1.v[k], s2.v[k])


# --- gradient compression ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_the_references_bit_for_bit(rng, dtype):
    for scale in (1.0, 1e-4, 300.0):
        g = (rng.normal(0, 1, (257,)) * scale).astype(np.float32)
        e = (rng.normal(0, 1, (257,)) * scale * 1e-3).astype(np.float32)
        jq, js, je = RC.quantize(jnp.asarray(g, dtype), jnp.asarray(e))
        tq, ts, te = grad_compress.quantize(torch.tensor(np.asarray(jnp.asarray(g, dtype),
                                                                   np.float32)).to(
            getattr(torch, dtype)), torch.tensor(e))
        assert tq.dtype == torch.int8 and te.dtype == ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.item() == np.float32(js)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_quantize_rounds_half_to_even_and_clips():
    g = torch.tensor([127.0, -127.0, 0.5, 1.5, 2.5, 63.5])
    q, scale, resid = grad_compress.quantize(g, torch.zeros(6))
    assert float(scale) == pytest.approx(1.0)
    assert q.tolist() == [127, -127, 0, 2, 2, 64]
    assert torch.equal(resid, g - q.float() * scale)


def test_init_error_and_wire_bytes_match_reference():
    params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    tparams = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in SHAPES.items()}
    errs = grad_compress.init_error(tparams)
    assert {k: (tuple(v.shape), v.dtype) for k, v in errs.items()} == \
        {k: (s, torch.float32) for k, s in SHAPES.items()}
    for compressed in (True, False):
        assert grad_compress.wire_bytes(tparams, compressed) == \
            RC.wire_bytes({k: jnp.asarray(v) for k, v in params.items()}, compressed)


@pytest.fixture()
def group1(tmp_path):
    D.init_group(str(tmp_path / "store"), 0, 1, device="cpu", timeout_s=60)
    yield None
    dist.destroy_process_group()


def test_compressed_psum_one_rank_is_quantise_dequantise(group1, rng):
    grads = {"w": torch.tensor(rng.normal(0, 1, (64, 3)).astype(np.float32)),
             "h": torch.tensor(rng.normal(0, 1, (10,)).astype(np.float32)).to(torch.bfloat16)}
    errors = {k: torch.tensor(rng.normal(0, 1e-3, tuple(v.shape)).astype(np.float32))
              for k, v in grads.items()}
    out, carried = grad_compress.compressed_psum(grads, errors)
    out2, carried2 = grad_compress.compressed_psum(grads, carried)
    for k, g in grads.items():
        for e_in, o, e_out in ((errors[k], out[k], carried[k]), (carried[k], out2[k], carried2[k])):
            q, scale, resid = grad_compress.quantize(g, e_in)
            assert torch.equal(o, q.float() * scale) and torch.equal(e_out, resid)
        # error feedback: the output plus the residual is g + e exactly
        torch.testing.assert_close(out[k] + carried[k], g.float() + errors[k], rtol=0,
                                   atol=1e-6)


WORKER = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.core import distributed as D
from repro_torch.optim import grad_compress as gc
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
D.init_group(d + "/store", rank, world, device="cpu", timeout_s=120)
z = np.load(d + "/in.npz")
grads = {"w": torch.tensor(z["w"][rank]), "b": torch.tensor(z["b"][rank])}
errs = {"w": torch.tensor(z["ew"][rank]), "b": torch.tensor(z["eb"][rank])}
out, new_e = gc.compressed_psum(grads, errs)
out2, new_e2 = gc.compressed_psum(grads, new_e)
np.savez(d + "/out%d.npz" % rank, **{"w": out["w"].numpy(), "b": out["b"].numpy(),
         "ew": new_e["w"].numpy(), "eb": new_e["b"].numpy(), "w2": out2["w"].numpy(),
         "b2": out2["b"].numpy()})
dist.destroy_process_group()
"""

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.optim.grad_compress import compressed_psum
d = sys.argv[1]
z = np.load(d + "/in.npz")
mesh = jax.make_mesh((4,), ("dp",))
g = {"w": jnp.asarray(z["w"]), "b": jnp.asarray(z["b"])}
e = {"w": jnp.asarray(z["ew"]), "b": jnp.asarray(z["eb"])}

def f(g, e):
    g = jax.tree.map(lambda a: a[0], g)
    e = jax.tree.map(lambda a: a[0], e)
    out, new_e = compressed_psum(g, e, "dp")
    out2, _ = compressed_psum(g, new_e, "dp")
    return jax.tree.map(lambda a: a[None], (out, new_e, out2))

spec = P("dp")
out, new_e, out2 = jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(spec, spec),
                                            out_specs=spec))(g, e)
np.savez(d + "/ref.npz", w=np.asarray(out["w"]), b=np.asarray(out["b"]),
         ew=np.asarray(new_e["w"]), eb=np.asarray(new_e["b"]), w2=np.asarray(out2["w"]),
         b2=np.asarray(out2["b"]))
print("REF_OK")
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """compressed_psum twice (the second call carrying the first's
    residuals) on 4 gloo ranks and on the reference's 4 placeholder
    devices, each rank with its own gradients and residuals."""
    d = tmp_path_factory.mktemp("compress4")
    rng = np.random.default_rng(11)
    np.savez(d / "in.npz", w=rng.normal(0, 1, (WORLD, 33, 7)).astype(np.float32),
             b=(rng.normal(0, 1, (WORLD, 19)) * 1e-3).astype(np.float32),
             ew=rng.normal(0, 1e-3, (WORLD, 33, 7)).astype(np.float32),
             eb=rng.normal(0, 1e-6, (WORLD, 19)).astype(np.float32))
    ranks = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(WORLD), str(d)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(d)], env=_env(),
                         capture_output=True, text=True, timeout=TIMEOUT)
    try:
        errs = [p.communicate(timeout=TIMEOUT)[1] for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for p, err in zip(ranks, errs):
        assert p.returncode == 0, err[-2000:]
    assert ref.returncode == 0 and "REF_OK" in ref.stdout, ref.stderr[-2000:]
    with np.load(d / "ref.npz") as z:
        want = {k: z[k] for k in z.files}
    got = []
    for r in range(WORLD):
        with np.load(d / f"out{r}.npz") as z:
            got.append({k: z[k] for k in z.files})
    return got, want


@pytest.mark.parametrize("key", ["w", "b"])
def test_compressed_psum_four_ranks_is_the_references(four_ranks, key):
    got, want = four_ranks
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r][key], want[key][r])
        np.testing.assert_array_equal(got[r][key], got[0][key])


@pytest.mark.parametrize("key,inputs", [("ew", "w"), ("eb", "b")])
def test_compressed_psum_four_ranks_residuals_are_the_references(four_ranks, key, inputs):
    got, want = four_ranks
    for r in range(WORLD):
        ulp = np.spacing(np.abs(want[inputs][r]).max() + np.abs(want[key][r]).max())
        np.testing.assert_allclose(got[r][key], want[key][r], rtol=0, atol=ulp)


@pytest.mark.parametrize("key", ["w2", "b2"])
def test_compressed_psum_four_ranks_carry_the_residual_as_the_reference(four_ranks, key):
    got, want = four_ranks
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][key], want[key][r], rtol=1e-6,
                                   atol=1e-6 * np.abs(want[key][r]).max())
        np.testing.assert_array_equal(got[r][key], got[0][key])
    assert not np.array_equal(got[0][key], got[0][key[0]])
