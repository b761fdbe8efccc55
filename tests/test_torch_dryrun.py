"""The port's dry run (`repro_torch.launch.dryrun`) on fake meshes "2,2"
and "2,2,2" (fake process groups, so each mesh runs in processes of its
own): every architecture at its smoke config through one train, one
prefill and one decode cell, each record `ok` with dot FLOPs > 0, a
dominant term, temp > 0, and `model_flops` / `analytic_hbm_bytes` equal to
the reference's formulas on the same config and shape; `cell_runnable`'s
skips equal to the reference's; and the paper's LSCV_h cell (n 4 096, d 2,
n_h 16, "2,2") against the reference's: the same dot FLOPs a device, and
the same collective bytes a device as its compiled HLO holds (one
all-reduce of the 16 sums; the reference's own `HloCostModel` reports 0
there, because its parser drops instructions marked ROOT).

The "2,2,2" cells run in three processes side by side: DTensor's sharding
propagation over a 3-D mesh costs some 15-40 s a train cell here.
The reference's four full-config cells (tests/test_dryrun_small.py) run in
a test marked slow, as the reference marks its own.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro import roofline as ref_roofline
from repro.configs.base import ARCH_IDS, SHAPES
from repro.configs.base import ShapeConfig as RefShape
from repro.configs.base import cell_runnable as ref_cell_runnable
from repro.configs.base import get_config as ref_get_config
from repro_torch.configs.base import cell_runnable

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("train_s", 32, 4, "train"), ("prefill_s", 32, 4, "prefill"),
         ("decode_s", 64, 4, "decode"))
GROUPS = {"2,2": [ARCH_IDS],
          "2,2,2": [ARCH_IDS[0:3] + ARCH_IDS[8:9], ARCH_IDS[3:6] + ARCH_IDS[9:],
                    ARCH_IDS[6:8]]}

PORT_CODE = r"""
import json, sys
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_from_spec
spec, archs, cells, out = sys.argv[1], sys.argv[2].split(","), json.loads(sys.argv[3]), sys.argv[4]
mesh = make_mesh_from_spec(spec, device_type="cpu")
with open(out, "w") as f:
    for arch in archs:
        for name, seq, batch, kind in cells:
            rec = dryrun.analyse_cell(get_config(arch, smoke=True),
                                      ShapeConfig(name, seq, batch, kind), mesh)
            f.write(json.dumps(dict(rec, arch=arch)) + "\n")
"""

REF_KDE_CODE = r"""
import os, re, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import roofline
from repro.core import gaussian as G
from repro.core.distributed import sharded_lscv_h_grid
mesh = jax.make_mesh((2, 2), ("data", "model"))
c_k, c_kk, _ = G.lscv_h_consts(2, 1.0)
h = jnp.linspace(0.05, 0.8, 16, dtype=jnp.float32)
rep = NamedSharding(mesh, P())
with mesh:
    c = jax.jit(lambda x, s: sharded_lscv_h_grid(x, s, h, c_k, c_kk, mesh, 64),
                in_shardings=(rep, rep)).lower(
        jax.ShapeDtypeStruct((4096, 2), jnp.float32),
        jax.ShapeDtypeStruct((2, 2), jnp.float32)).compile()
text = c.as_text()
hlo = roofline.HloCostModel(text)
coll = 0
for line in text.splitlines():
    m = re.search(r"=\s*(\w+\[[\d,]*\])\S*\s+(all-reduce|all-gather|reduce-scatter|"
                  r"all-to-all|collective-permute)\(", line)
    if m:
        coll += roofline._shape_bytes(m.group(1))
print(json.dumps({"dot": hlo.dot_flops(), "parsed": hlo.collective_bytes()[0],
                  "hlo_collective_bytes": coll}))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cells of both meshes and the small LSCV_h cell, their processes
    started together."""
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for spec, groups in GROUPS.items():
        for i, archs in enumerate(groups):
            out = tmp / f"{spec}_{i}.jsonl"
            procs[(spec, i)] = (out, subprocess.Popen(
                [sys.executable, "-c", PORT_CODE, spec, ",".join(archs), json.dumps(CELLS),
                 str(out)], env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    kde_out = tmp / "kde.jsonl"
    procs["kde"] = (kde_out, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
         "--mesh-shape", "2,2", "--kde", "4096,2,16", "--out", str(kde_out)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    procs["ref_kde"] = (None, subprocess.Popen(
        [sys.executable, "-c", REF_KDE_CODE], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    records, outputs = {}, {}
    for key, (out, p) in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=420)
        finally:
            p.kill()
        assert p.returncode == 0, (key, stderr[-3000:])
        outputs[key] = stdout
        if out is not None and key != "kde":
            for line in out.read_text().splitlines():
                rec = json.loads(line)
                records[(key[0], rec["arch"], rec["shape"])] = rec
    kde = json.loads(kde_out.read_text().splitlines()[-1])
    return records, kde, json.loads(outputs["ref_kde"].strip().splitlines()[-1]), outputs


@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", list(GROUPS))
def test_smoke_cell_record(runs, mesh, arch, cell):
    records = runs[0]
    rec = records[(mesh, arch, cell)]
    name, seq, batch, kind = next(c for c in CELLS if c[0] == cell)
    assert rec["ok"] and rec["shape"] == name
    assert rec["chips"] == (4 if mesh == "2,2" else 8)
    assert rec["hlo_dot_flops_per_dev"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["temp_gb_per_dev"] > 0
    assert rec["memory"]["argument_gb_per_dev"] > 0
    assert rec["collective_bytes_per_dev"] == sum(rec["collective_by_kind"].values())
    ref_cfg, shape = ref_get_config(arch, smoke=True), RefShape(name, seq, batch, kind)
    assert rec["model_flops"] == pytest.approx(ref_roofline.model_flops(ref_cfg, shape),
                                               rel=1e-12)
    assert rec["analytic_hbm_bytes"] == pytest.approx(
        ref_roofline.hbm_bytes(ref_cfg, shape, rec["n_micro"]), rel=1e-12)
    if kind == "train":
        assert rec["gather_once"] is True            # every smoke config is < 20 B params
        assert rec["memory"]["alias_gb_per_dev"] > 0
    if kind == "decode":
        assert rec["memory"]["alias_gb_per_dev"] > 0  # the cache, updated in place


def test_cell_runnable_skips_equal_reference():
    for arch in ARCH_IDS:
        for s in SHAPES:
            assert cell_runnable(arch, s.name) == ref_cell_runnable(arch, s.name)
    ok, why = cell_runnable("llama3.2-1b", "long_500k")
    assert not ok and "full-attention" in why


def test_kde_cell_equals_reference(runs):
    _, kde, ref, outputs = runs
    assert kde["ok"] and kde["chips"] == 4
    assert kde["hlo_dot_flops_per_dev"] == ref["dot"]
    assert kde["collective_bytes_per_dev"] == ref["hlo_collective_bytes"] == 16 * 4
    assert kde["collective_by_kind"] == {"all-reduce": 64.0}
    assert ref["parsed"] == 0.0                      # the reference parser's miss (ROOT)
    assert "PASS kde_lscv_h n4096 d2 nh16 x 2x2" in outputs["kde"]


def test_cli_wants_a_card_without_device_cpu(tmp_path):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh-shape", "2",
                        "--kde", "64,1,4"], env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


# the reference's four full-config cells (tests/test_dryrun_small.py)
FULL_CELLS = [
    ("llama3.2-1b", "train_4k", "4,2"),
    ("granite-moe-1b-a400m", "decode_32k", "4,2"),
    ("falcon-mamba-7b", "long_500k", "2,2,2"),
    ("whisper-base", "prefill_32k", "2,2,2"),
]


@pytest.mark.slow
@pytest.mark.parametrize("arch,shape,mesh", FULL_CELLS)
def test_full_config_cell(arch, shape, mesh, tmp_path):
    out = tmp_path / "dry.jsonl"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--mesh-shape", mesh, "--out", str(out),
                        "--device", "cpu"],
                       env=_env(), capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["ok"], rec
    assert rec["hlo_dot_flops_per_dev"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["temp_gb_per_dev"] > 0
    assert re.search(r"^PASS ", r.stdout, re.M)


def test_shape_lists_and_jobs_run_an_arch_a_process(monkeypatch, tmp_path, capsys):
    """`--shape` takes a comma-separated list; `--all` prints the
    reference's SKIP lines, starts one process an architecture with its
    runnable shapes, no more at a time than the cores it may use, and
    appends their records to --out in the architectures' order (the
    children faked here: a full config is never traced on this CPU)."""
    from repro_torch.launch import dryrun

    ap = dryrun.parser()
    assert ap.parse_args(["--shape", "train_4k,decode_32k"]).shape == "train_4k,decode_32k"
    with pytest.raises(SystemExit):
        ap.parse_args(["--shape", "train_4k,nope"])
    started, live = [], []

    class FakeChild:
        def __init__(self, argv, **kw):
            arch, shapes, out = (argv[argv.index(f) + 1] for f in ("--arch", "--shape", "--out"))
            started.append((arch, shapes, argv[argv.index("--out") + 2:]))
            live.append(len(started) - sum(done))
            with open(out, "w") as f:
                for s in shapes.split(","):
                    f.write(json.dumps({"arch": arch, "shape": s, "ok": True}) + "\n")
            self.returncode = 1 if arch == ARCH_IDS[2] else 0

        def poll(self):
            return self.returncode

        def communicate(self):
            done.append(1)
            return "PASS", None

    done = []
    monkeypatch.setattr(subprocess, "Popen", FakeChild)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1, 2})
    out = tmp_path / "all.jsonl"
    args = ap.parse_args(["--all", "--device", "cpu", "--mesh-shape", "2,2",
                          "--out", str(out)])
    try:
        assert dryrun.run(args) == 1                        # the one failing child
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    skips = [r for r in recs if r.get("skipped")]
    ran = [(r["arch"], r["shape"]) for r in recs if not r.get("skipped")]
    want = [(a, s.name) for a in ARCH_IDS for s in SHAPES if cell_runnable(a, s.name)[0]]
    assert ran == want and len(skips) == 4 * len(ARCH_IDS) - len(want)
    assert [a for a, _, _ in started] == list(ARCH_IDS) and max(live) == 3
    assert all(extra == ["--mesh-shape", "2,2", "--device", "cpu"] for _, _, extra in started)
    assert capsys.readouterr().out.count("SKIP ") == len(skips)
