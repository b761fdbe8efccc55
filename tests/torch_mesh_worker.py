"""One gloo rank of the port's multi-rank CPU tests, started as a process
of its own by `tests/test_torch_train_sharded.py` and
`tests/test_torch_pipeline.py`:

    python tests/torch_mesh_worker.py MODE STORE RANK WORLD IN_NPZ OUT_DIR

MODE "train": for each architecture in the input, a float32 smoke model on
a 2 x 2 (data, model) mesh under the train specs takes one sharded train
step from the given parameters and batch, with and without
`param_constraint` (the serve specs); rank 0 writes the loss, grad norm and
whole parameters.  Then the state is saved from the 2 x 2 mesh and
restored with `shardings` onto a 4 x 1 mesh, and every rank checks the
restored whole tensors against the saved ones bit for bit.
MODE "pipeline": the reference's pipeline case on WORLD stages.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import sharding  # noqa: E402
from repro_torch.core.distributed import init_group  # noqa: E402


def train(rank: int, inp: dict, out_dir: str) -> None:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import dp_axes, make_host_mesh
    from repro_torch.models import batch_specs, build_model, param_specs_with_dp
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step, train_params

    mesh = make_host_mesh(2, 2, device_type="cpu")
    dp = dp_axes(mesh)
    results = {}
    for arch in inp["archs"]:
        cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype="float32")
        state = {k[len(arch) + 1:]: torch.from_numpy(v) for k, v in inp["arrays"].items()
                 if k.startswith(arch + "/")}
        batch = {k: state.pop(k) for k in ("batch.tokens", "batch.labels")}
        for constrained in (False, True):
            model = build_model(cfg, "cpu")
            model.load_state_dict(state, strict=True)
            model.requires_grad_(True)
            sharding.distribute_model(model, param_specs_with_dp(model, "train", dp), mesh)
            params = train_params(model)
            opt = adamw.init(params)
            b = sharding.distribute({k.split(".")[1]: v.long() for k, v in batch.items()},
                                    batch_specs(cfg, dp), mesh)
            step = make_train_step(model, adamw.AdamWConfig(), inp["n_micro"],
                                   param_constraint=(param_specs_with_dp(model, "serve", dp)
                                                     if constrained else None))
            params, opt, met = step(params, opt, b)
            whole = {k: p.detach().full_tensor().numpy() for k, p in params.items()}
            tag = f"{arch}/{'constrained' if constrained else 'plain'}"
            results[tag] = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                            "placements": {k: str(p.placements) for k, p in params.items()}}
            if rank == 0:
                np.savez(os.path.join(out_dir, tag.replace("/", "__") + ".npz"), **whole)
        # save from the 2 x 2 mesh, restore onto a 4 x 1 mesh
        ckpt = CheckpointManager(os.path.join(out_dir, f"ckpt_{arch}_{rank}"), async_save=False)
        ckpt.save(1, (params, opt))
        torch.distributed.barrier()                    # rank 0's step is on disk
        mesh41 = make_host_mesh(4, 1, device_type="cpu")
        specs = param_specs_with_dp(model, "train", dp_axes(mesh41))
        shard = {k: (mesh41, sharding.placements(specs[k], mesh41, p.dim()))
                 for k, p in params.items()}
        rep = (mesh41, (sharding.Replicate(),) * 2)
        restored, _ = CheckpointManager(os.path.join(out_dir, f"ckpt_{arch}_0")).restore(
            1, (params, opt), shardings=(shard, adamw.AdamWState(shard, shard, rep)))
        r_params, r_opt = restored
        same = all(torch.equal(r_params[k].full_tensor(), params[k].full_tensor())
                   and torch.equal(r_opt.m[k].full_tensor(), opt.m[k].full_tensor())
                   and torch.equal(r_opt.v[k].full_tensor(), opt.v[k].full_tensor())
                   and r_params[k].device_mesh is mesh41
                   for k in params)
        results[f"{arch}/restore"] = {"same": same, "keys": len(params),
                                      "count": int(r_opt.count.full_tensor())}
    with open(os.path.join(out_dir, f"result_{rank}.json"), "w") as f:
        json.dump(results, f)


def pipeline(rank: int, inp: dict, out_dir: str) -> None:
    from repro_torch.launch.pipeline import spmd_pipeline

    W, b, xs = (torch.from_numpy(inp["arrays"][k]) for k in ("W", "b", "xs"))
    out = spmd_pipeline(lambda p, x: torch.tanh(x @ p[0] + p[1]), (W, b), xs)
    np.save(os.path.join(out_dir, f"pipeline_{rank}.npy"), out.numpy())


def main() -> None:
    mode, store, rank, world, in_npz, out_dir = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with np.load(in_npz) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("meta")))
    init_group(store, rank, world, device="cpu", timeout_s=120)
    try:
        (train if mode == "train" else pipeline)(rank, dict(meta, arrays=arrays), out_dir)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
