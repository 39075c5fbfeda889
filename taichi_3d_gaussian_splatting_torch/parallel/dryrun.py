"""A dry run of multi-view data parallelism: n processes in one process
group take one batch step of a 32x32 toy scene, one view each.

    python -m taichi_3d_gaussian_splatting_torch.parallel.dryrun --n 2
    python -m taichi_3d_gaussian_splatting_torch.parallel.dryrun --n 4 \\
        --device cuda          # NCCL, one card per rank

`spawn_ranks` starts the processes (gloo on the CPU, NCCL on the cards,
rendezvous on a file store) and returns what each rank's function
returned.
"""

from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600


def _rank_entry(rank, fn, n, device, store, out_dir, args):
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = fn(torch.device(device, rank) if device == "cuda"
                    else torch.device("cpu"), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n: int, device: str = "cuda", args=()) -> list:
    """Run `fn(device, *args)` in `n` new processes joined in one process
    group (gloo on the CPU, NCCL with one card per rank on `cuda`); return
    their results in rank order. `fn` must be importable by name, and its
    result tensors or arrays."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_entry, args=(fn, n, device, os.path.join(tmp, "store"),
                               tmp, tuple(args)),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"the {n} ranks did not finish in "
                                   f"{TIMEOUT_S} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]


def toy_scene(n=128, seed=0):
    """(pc (n, 3), feats (n, 56)) of a small random scene in front of the
    camera."""
    rng = np.random.default_rng(seed)
    pc = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                         rng.uniform(1.0, 4.0, (n, 1))],
                        axis=1).astype(np.float32)
    feats = np.zeros((n, 56), np.float32)
    q = rng.normal(size=(n, 4))
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-2.5, -1.0, (n, 3))
    feats[:, 7] = rng.normal(size=n)
    feats[:, 8] = rng.normal(size=n) + 1
    feats[:, 24] = rng.normal(size=n)
    feats[:, 40] = rng.normal(size=n)
    return pc, feats


def toy_batch_step(device):
    """One batch step of the toy scene with one view per rank; returns the
    loss and the features before and after."""
    from ..camera import CameraInfo
    from ..models.scene import GaussianPointCloudScene, SceneConfig
    from ..ops.rasterizer import RasterizerConfig
    from ..training.adam import AdamGroup, adam_init
    from ..training.controller import ControllerState
    from ..training.loss import LossFunction, LossFunctionConfig
    from ..training.step import TrainStep
    from .sharding import (make_data_parallel_train_step, make_mesh,
                           replicate_scene)

    h = w = 32
    intr = np.array([[25.0, 0, w / 2], [0, 25.0, h / 2], [0, 0, 1]],
                    np.float32)
    cam = CameraInfo(camera_intrinsics=intr, camera_height=h, camera_width=w)
    pc, feats = toy_scene()
    scene = GaussianPointCloudScene.from_arrays(
        pc, SceneConfig(), point_cloud_features=feats, device=device)
    mesh = make_mesh()
    opt_feat = adam_init(scene.point_cloud_features)
    opt_pos = adam_init(scene.point_cloud)
    ctrl = ControllerState.zeros(scene.capacity, device)
    replicate_scene(mesh, scene, opt_feat, opt_pos, ctrl)
    step = make_data_parallel_train_step(mesh, cam, TrainStep(
        RasterizerConfig(near_plane=0.1, far_plane=100.0),
        LossFunction(LossFunctionConfig(enable_regularization=False)),
        AdamGroup(1e-3), AdamGroup(1e-5)))

    b = mesh.size
    rng = np.random.default_rng(1)

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    images = put(rng.random((b, h, w, 3)))
    qs = put(np.tile([[[0.0, 0.0, 0.0, 1.0]]], (b, 1, 1)))
    ts = put(rng.normal(scale=0.05, size=(b, 1, 3)))
    new_scene, _, _, _, metrics, _, _ = step(
        scene, opt_feat, opt_pos, ctrl, images, qs, ts,
        np.tile(intr[None], (b, 1, 1)), 1)
    return {"loss": float(metrics["loss"]),
            "before": scene.point_cloud_features.cpu(),
            "after": new_scene.point_cloud_features.cpu(),
            "positions": new_scene.point_cloud.cpu()}


def dryrun_multichip(n: int, device: str = "cuda") -> dict:
    """One batch step of the toy scene in `n` processes (one view each):
    the loss is finite, the parameters moved, and every rank holds the
    same parameters bit for bit. Returns the loss and the largest
    feature change."""
    results = spawn_ranks(toy_batch_step, n, device)
    loss = results[0]["loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun_multichip({n}): loss {loss}")
    delta = float((results[0]["after"] - results[0]["before"]).abs().max())
    if not delta > 0:
        raise AssertionError(f"dryrun_multichip({n}): no parameter update")
    for r, res in enumerate(results[1:], 1):
        for key in ("after", "positions"):
            if not torch.equal(res[key], results[0][key]):
                raise AssertionError(f"dryrun_multichip({n}): rank {r}'s "
                                     f"{key} differ from rank 0's")
    print(f"dryrun_multichip({n}, {device}): loss={loss:.4f} "
          f"max_param_delta={delta:.2e} ranks identical OK", flush=True)
    return {"loss": loss, "max_param_delta": delta}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=2)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
