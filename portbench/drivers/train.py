"""Traffic kind `train`: a closed loop of optimizer steps through the
port's `GaussianPointCloudTrainer.step` on views from the trainer's own
device cache, as `train()` takes them, with no densify, validation or
logging.

The inputs come first: the true scene drawn from the seed, `views`
ground-truth views of it rendered by the plain reference on poses drawn
as the render mix draws them (`harness.inputs.poses`), written as PNGs,
with the scene perturbed (positions + N(0, `position_noise`), features +
N(0, `feature_noise`)) as the point cloud, in the trainer's dataset format
under the run's temporary directory. That is the benchmark's work, not the
program's, and `setup_s` leaves it out. Set-up proper builds the trainer
on the dataset (its scene in `slots_ratio` times as many slots) and drives
the first `checked_steps` steps through the window's own call, keeping
what the comparison reads: each step's loss, Adam's first moments after
the first step, the scene and the controller's statistics after the last.

The window runs steps until `--seconds` have passed. Once it has closed
and the memory peak is read, the trainer is freed and the plain reference
(`reference/train.py`) follows the checked steps from the same start
(`reference/compare.py` reads the gaps).

With `--trace 1`, after the window: `events_steps` steps with CUDA events
at the trainer's stage marks, then `trace_steps` steps under
torch.profiler, each on one of `work_views` views drawn from the seed,
whose work the reference's pair counts give on the scene as it stands.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from portbench.harness import clock, inputs, trace
from portbench.harness.main import RunResult, note
from portbench.reference import compare
from portbench.reference import projection as RP
from portbench.reference import raster as RR
from portbench.reference import train as RT
from portbench.work.unit import step_work

ADAM_B1 = 0.9


class Inputs(NamedTuple):
    """What both sides get: the perturbed scene the trainer loads (numpy),
    the ground truth (V, H, W, 3) uint8, the camera-to-world matrices of
    the views (V, 4, 4) and the camera."""
    pc: np.ndarray
    feats: np.ndarray
    gt: torch.Tensor
    pose_matrices: np.ndarray
    cam: RP.Camera


def hyper(cell) -> RT.Hyper:
    c = cell.config["train"]
    return RT.Hyper(
        near=c["near"], far=c["far"],
        depth_scale=c["depth_to_sort_key_scale"],
        feature_lr=c["feature_learning_rate"],
        position_lr=c["position_learning_rate"],
        position_lr_decay=c["position_learning_rate_decay_rate"],
        position_lr_interval=c["position_learning_rate_decay_interval"],
        lambda_value=c["lambda_value"], regularization=c["regularization"],
        regularization_weight=c["regularization_weight"],
        grad_scale=tuple(c["grad_factors"][k] for k in (
            "q", "s", "alpha", "color", "high_order_color")),
        sh_band=int(cell.traffic["sh_band"]))


def make_inputs(cell, seed: int, device) -> Inputs:
    """The true scene and the trained one from the seed, and the ground
    truth: the reference's render of the true scene on each of the mix's
    views, clipped and rounded to 8 bits."""
    cfg, tr = cell.config, cell.traffic
    fx, fy, cx, cy, width, height = inputs.camera(cfg)
    cam = RP.Camera(fx, fy, cx, cy, width, height)
    hp = hyper(cell)
    n = int(cfg["points"])
    gen = torch.Generator(device).manual_seed(seed)
    pc, feats = inputs.scene(cfg, n, gen)
    q, t = inputs.poses(tr, int(tr["views"]), seed)
    invalid = torch.zeros(n, dtype=torch.int8, device=device)
    gt = []
    for v in range(q.shape[0]):
        qv, tv = q[v].to(device), t[v].to(device)
        image = RR.render_view(
            lambda: RP.project(pc, feats, invalid, qv, tv, cam, hp.near,
                               hp.far), hp.depth_scale, cam)
        gt.append(torch.round(torch.clamp(image, 0.0, 1.0) * 255.0).to(
            torch.uint8))
    pc0 = pc + float(tr["position_noise"]) * torch.randn(
        pc.shape, generator=gen, device=device)
    feats0 = feats + float(tr["feature_noise"]) * torch.randn(
        feats.shape, generator=gen, device=device)
    rot = inputs.rotation(q[:, 0])
    mats = np.zeros((q.shape[0], 4, 4), np.float32)
    mats[:, :3, :3] = rot.numpy()
    mats[:, :3, 3] = t[:, 0].numpy()
    mats[:, 3, 3] = 1.0
    return Inputs(pc0.cpu().numpy(), feats0.cpu().numpy(),
                  torch.stack(gt).cpu(), mats, cam)


def write_dataset(x: Inputs, root: str) -> dict:
    """The PNGs, the dataset JSON and the point-cloud parquet; returns the
    paths."""
    import pandas as pd
    import PIL.Image
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        FEATURE_COLUMNS)
    cam = x.cam
    intr = [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]]
    records = []
    for v in range(x.gt.shape[0]):
        path = os.path.join(root, f"view_{v:03d}.png")
        PIL.Image.fromarray(x.gt[v].numpy()).save(path, compress_level=1)
        records.append({"image_path": path,
                        "T_pointcloud_camera": x.pose_matrices[v].tolist(),
                        "camera_intrinsics": intr,
                        "camera_height": cam.height,
                        "camera_width": cam.width, "camera_id": 0})
    paths = {"dataset": os.path.join(root, "views.json"),
             "parquet": os.path.join(root, "point_cloud.parquet")}
    with open(paths["dataset"], "w") as f:
        json.dump(records, f)
    pd.concat([pd.DataFrame(x.pc, columns=["x", "y", "z"]),
               pd.DataFrame(x.feats, columns=FEATURE_COLUMNS)],
              axis=1).to_parquet(paths["parquet"])
    return paths


def make_trainer(cell, seed: int, paths: dict, root: str, device):
    """The trainer on the written dataset, its logger without TensorBoard:
    the window logs nothing, and TensorBoard's import can load TensorFlow,
    and with it JAX, where they are installed."""
    sys.modules.setdefault("torch.utils.tensorboard", None)
    from taichi_3d_gaussian_splatting_torch.models.scene import SceneConfig
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        RasterizerConfig)
    from taichi_3d_gaussian_splatting_torch.training.loss import (
        LossFunctionConfig)
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer, TrainConfig)
    c = cell.config["train"]
    g = c["grad_factors"]
    config = TrainConfig(
        train_dataset_json_path=paths["dataset"],
        val_dataset_json_path=paths["dataset"],
        pointcloud_parquet_path=paths["parquet"],
        feature_learning_rate=c["feature_learning_rate"],
        position_learning_rate=c["position_learning_rate"],
        position_learning_rate_decay_rate=c[
            "position_learning_rate_decay_rate"],
        position_learning_rate_decay_interval=c[
            "position_learning_rate_decay_interval"],
        summary_writer_log_dir=os.path.join(root, "logs"),
        output_model_dir=os.path.join(root, "out"), seed=seed,
        save_full_checkpoint=False,
        rasterisation_config=RasterizerConfig(
            near_plane=c["near"], far_plane=c["far"],
            depth_to_sort_key_scale=c["depth_to_sort_key_scale"],
            grad_color_factor=g["color"],
            grad_high_order_color_factor=g["high_order_color"],
            grad_s_factor=g["s"], grad_q_factor=g["q"],
            grad_alpha_factor=g["alpha"]),
        gaussian_point_cloud_scene_config=SceneConfig(
            max_num_points_ratio=c["slots_ratio"]),
        loss_function_config=LossFunctionConfig(
            lambda_value=c["lambda_value"],
            enable_regularization=c["regularization"],
            regularization_weight=c["regularization_weight"]))
    return GaussianPointCloudTrainer(config, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _leaf_copy(trainer):
    s = trainer.scene
    return s.point_cloud.clone(), s.point_cloud_features.clone()


def reference_side(cell, x: Inputs, seed: int, device, dtype=torch.float32,
                   loss_rows=None) -> compare.TrainSide:
    """The plain reference's readings of the checked steps from the
    inputs: the trainer's scene worked out again (padding and Morton
    order), its view order (`randperm` of the trainer's data generator,
    seeded with the seed), the views' poses as the dataset reads them
    (the Shepperd quaternion of each matrix)."""
    hp = hyper(cell)
    steps = int(cell.traffic["checked_steps"])
    pc, feats, invalid = RT.padded_and_sorted(
        x.pc, x.feats, float(cell.config["train"]["slots_ratio"]))
    state = RT.initial_state(torch.tensor(pc, device=device),
                             torch.tensor(feats, device=device),
                             torch.tensor(invalid, device=device))
    start = (state.pc, state.feats)
    order = torch.randperm(x.gt.shape[0],
                           generator=torch.Generator().manual_seed(seed))
    mats = torch.tensor(x.pose_matrices)
    q_all = RP.rotation_matrix_to_quaternion(mats[:, :3, :3])
    losses, first = [], None
    prev = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(steps):
            v = int(order[i])
            gt = x.gt[v].to(device).to(torch.float32) / 255.0
            out = RT.step(state, gt, q_all[v:v + 1].to(device),
                          mats[v:v + 1, :3, 3].to(device), x.cam, hp, dtype,
                          loss_rows)
            losses.append(out.loss)
            if first is None:
                first = (out.grad_pc, out.grad_feats)
            state = out.state
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev
    return compare.TrainSide(losses, *first, *start, state.pc, state.feats,
                             tuple(state.stats))


def open_trainer(cell, seed: int, paths: dict, root: str, device):
    """Build the trainer on the dataset at `paths` (the memory peak counted
    from here) and its device cache; returns (trainer, cache, one_step),
    `one_step(mark)` the window's call: the next view of the cache as
    `train()` takes it, through `trainer.step`."""
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import _no_mark
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    trainer = make_trainer(cell, seed, paths, root, device)
    cache = trainer._device_cache(trainer.train_dataset, 1)
    trainer._pos = len(trainer.train_dataset)
    sh_band = int(cell.traffic["sh_band"])

    def one_step(mark=_no_mark):
        images, qs, ts, intrs, cam = trainer._next_views(cache, None, 1, 1)
        return trainer.step(images[0], qs[0], ts[0], sh_band,
                            dataclasses.replace(cam,
                                                camera_intrinsics=intrs[0]),
                            mark=mark)

    return trainer, cache, one_step


def program_side(cell, trainer, one_step) -> compare.TrainSide:
    """Drive the checked steps through `one_step` and keep what the
    comparison reads: each step's loss, the first step's gradients from
    Adam's first moments, the scene before and after, the statistics."""
    start = _leaf_copy(trainer)
    losses, first = [], None
    for _ in range(int(cell.traffic["checked_steps"])):
        losses.append(float(one_step().metrics["loss"]))
        if first is None:
            first = tuple(a.mu / (1.0 - ADAM_B1) for a in (
                trainer.opt_positions, trainer.opt_features))
    return compare.TrainSide(losses, *first, *start, *_leaf_copy(trainer),
                             tuple(v.clone() for v in trainer.ctrl_state))


def run(cell, args, t0: float) -> RunResult:
    from taichi_3d_gaussian_splatting_torch.ops import _build
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if device.type == "cuda":
        _build.load_library()
        torch.zeros(1, device=device)   # the CUDA context, in set-up
    inputs_start = time.time()
    x = make_inputs(cell, args.seed, device)
    root = tempfile.mkdtemp(prefix="portbench-")
    try:
        paths = write_dataset(x, root)
        inputs_s = time.time() - inputs_start
        note(t0, f"inputs drawn, rendered and written in {inputs_s:.2f} s "
                 f"(not set-up)")
        trainer, cache, one_step = open_trainer(cell, args.seed, paths,
                                                root, device)
        note(t0, "trainer built")
        prog = program_side(cell, trainer, one_step)
        _sync(device)
        setup_s = time.time() - t0 - inputs_s
        note(t0, f"checked steps done; setup_s {setup_s:.2f}")

        steps, half = 0, None
        window_start = time.perf_counter()
        while (now := time.perf_counter() - window_start) < args.seconds:
            if half is None and now >= args.seconds / 2:
                half = (steps, now)
            one_step()
            steps += 1
        _sync(device)
        window_s = time.perf_counter() - window_start
        note(t0, f"window: {steps} steps in {window_s:.3f} s (first half "
                 f"{half[1] / max(half[0], 1) * 1e3:.4f} ms a step, then "
                 f"{(window_s - half[1]) / max(steps - half[0], 1) * 1e3:.4f}"
                 f" ms)")
        e2e = {"setup_s": setup_s, "step_ms": window_s / steps * 1e3}

        readings, summary = {}, None
        if args.trace and device.type == "cuda":
            readings, summary = _per_layer(cell, args.seed, trainer, cache)
            note(t0, f"per-layer stretch: {readings['unit_ms']:.4f} ms a "
                     f"step by CUDA events")
        peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                else 0)
        del trainer, cache, one_step
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        note(t0, "per-layer stretches done" if args.trace else "peak read")
        checks = compare.train_readings(
            prog, reference_side(cell, x, args.seed, device))
        note(t0, "reference steps compared")
        if "work_state" in readings:
            readings["work"] = _work(cell, readings.pop("work_state"), x,
                                     device)
            note(t0, "work counted")
        return RunResult(steps, 0, e2e, readings, checks, peak, summary)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _per_layer(cell, seed, trainer, cache):
    """Stage and step times by CUDA events, then a traced stretch, over
    steps on the work views; and the scene as it stands, for their work."""
    tr = cell.traffic
    sh_band = int(tr["sh_band"])
    views = inputs.sample(seed, inputs.WORK, int(tr["views"]),
                          int(tr["work_views"]))
    cam_info, images, qs, ts, intrs = cache

    def step(j, mark=None):
        v = views[j % len(views)]
        kwargs = {} if mark is None else {"mark": mark}
        trainer.step(images[v].to(torch.float32) / 255.0, qs[v], ts[v],
                     sh_band, dataclasses.replace(
                         cam_info, camera_intrinsics=intrs[v]), **kwargs)

    scene = trainer.scene
    work_state = (scene.point_cloud.clone(),
                  scene.point_cloud_features.clone(),
                  scene.point_invalid_mask.clone(), views)
    unit_ms, stages = clock.timed_units(step, int(tr["events_steps"]),
                                        mark_stages=True)
    units = int(tr["trace_steps"])
    summary = trace.summarize(trace.run_traced(step, units), units)
    return {"unit_ms": unit_ms, "stages_ms": stages, "trace": summary,
            "work_state": work_state}, summary


def _work(cell, work_state, x: Inputs, device):
    """Mean work of a step on the work views, from the scene as the traced
    steps found it (quaternions normalized, as a step reads them)."""
    pc, feats, invalid, views = work_state
    hp = hyper(cell)
    feats = RT.normalize_quaternions(feats)
    mats = torch.tensor(x.pose_matrices)
    q_all = RP.rotation_matrix_to_quaternion(mats[:, :3, :3])
    cam = x.cam
    num_tiles = cam.tiles_x * cam.tiles_y
    works = []
    for v in views:
        qv, tv = q_all[v:v + 1].to(device), mats[v:v + 1, :3, 3].to(device)
        _, counts = RR.render_view(
            lambda: RP.project(pc, feats, invalid, qv, tv, cam, hp.near,
                               hp.far), hp.depth_scale, cam, counts=True)
        works.append(step_work(counts, pc.shape[0], num_tiles,
                               cam.width * cam.height))
    return {"flops": float(np.mean([w["flops"] for w in works])),
            "blend_backward_bound_ms": float(np.mean(
                [w["k3"]["bound_ms"] for w in works]))}
