"""Traffic kind `train_batch`: a closed loop of batch steps through the
port's `GaussianPointCloudTrainer.batch_step`, as `train()` and
`train_iteration` call it when `batch_size` > 1: each step on the next B
views of the epoch's permutation, from the trainer's own device cache
(`_next_views`), with no densify, validation or logging. The trainer is
built from a `TrainConfig` with the configuration's `batch_size` and its
three batch rules (`scale_lr_with_batch`, `scale_schedules_with_batch`,
`scale_betas_with_batch`).

The inputs, the dataset and the window are the `train` kind's
(`drivers/train.py`: `make_inputs` and `write_dataset` as they are);
`step_ms` is the window's time over the batch steps finished in it. The
checked steps are `checked_steps` batch steps: each step's mean loss, the
first step's summed gradients (Adam's first moments over 1 - b1 of the
batch's own betas), the scene before and after, the statistics; the plain
reference (`reference/batch.py`) follows them from the same start on the
same views.

With `--trace 1`, after the window: `events_steps` batch steps with CUDA
events at the step's marks (the `accumulate` stage summed over its views),
then `trace_steps` batch steps under torch.profiler, each on the
`work_views` views drawn from the seed (B of them), whose work
`work/batch.py` counts from the reference's pair counts on the scene as
it stands.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time

import torch

from portbench.harness import clock, inputs, spec, trace
from portbench.harness.main import RunResult, note
from portbench.reference import batch as RB
from portbench.reference import compare
from portbench.reference import projection as RP
from portbench.reference import train as RT
from portbench.work.batch import batch_step_work

TRAIN = spec.driver("train")
make_inputs = TRAIN.make_inputs
write_dataset = TRAIN.write_dataset


def rules(cell) -> RB.Rules:
    c = cell.config["train"]
    return RB.Rules(int(c["batch_size"]), c["scale_lr_with_batch"],
                    bool(c["scale_schedules_with_batch"]),
                    bool(c["scale_betas_with_batch"]))


def make_trainer(cell, seed: int, paths: dict, root: str, device):
    """The trainer on the written dataset with the configuration's batch
    and its rules; the rest as `drivers/train.py` builds it (its logger
    without TensorBoard)."""
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
    r = rules(cell)
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
        batch_size=r.size, scale_lr_with_batch=r.lr,
        scale_schedules_with_batch=r.schedules,
        scale_betas_with_batch=r.betas,
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


def open_trainer(cell, seed: int, paths: dict, root: str, device):
    """Build the trainer on the dataset at `paths` (the memory peak counted
    from here) and its device cache; returns (trainer, cache, one_step),
    `one_step(mark)` the window's call: the next B views of the cache as
    `train()` takes them, through `trainer.batch_step`."""
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import _no_mark
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    trainer = make_trainer(cell, seed, paths, root, device)
    cache = trainer._device_cache(trainer.train_dataset, 1)
    trainer._pos = len(trainer.train_dataset)
    sh_band = int(cell.traffic["sh_band"])
    b = trainer.config.batch_size

    def one_step(mark=_no_mark):
        images, qs, ts, intrs, cam = trainer._next_views(cache, None, 1, b)
        return trainer.batch_step(images, qs, ts, intrs, sh_band, cam,
                                  mark=mark)

    return trainer, cache, one_step


def program_side(cell, trainer, one_step) -> compare.TrainSide:
    """Drive the checked batch steps through `one_step` and keep what the
    comparison reads: each step's mean loss, the first step's summed
    gradients from Adam's first moments, the scene before and after, the
    statistics."""
    start = TRAIN._leaf_copy(trainer)
    b1 = trainer.betas[0]
    losses, first = [], None
    for _ in range(int(cell.traffic["checked_steps"])):
        losses.append(float(one_step().metrics["loss"]))
        if first is None:
            first = tuple(a.mu / (1.0 - b1) for a in (
                trainer.opt_positions, trainer.opt_features))
    return compare.TrainSide(losses, *first, *start,
                             *TRAIN._leaf_copy(trainer),
                             tuple(v.clone() for v in trainer.ctrl_state))


def batches_in_order(seed: int, num_views: int, size: int, steps: int):
    """The dataset indices of each batch step's views: the next `size` of
    the epoch's permutation, wrapping within it where a step runs past its
    end, and a new permutation for the step after that, drawn by the
    trainer's data generator (seeded with the seed)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    perm, pos, out = None, num_views, []
    for _ in range(steps):
        if pos >= num_views:
            perm, pos = torch.randperm(num_views, generator=gen), 0
        out.append([int(perm[(pos + i) % num_views]) for i in range(size)])
        pos += size
    return out


def reference_side(cell, x, seed: int, device, dtype=torch.float32,
                   loss_rows=None, drop_view: bool = False
                   ) -> compare.TrainSide:
    """The plain reference's readings of the checked batch steps from the
    inputs: the trainer's scene worked out again (`reference/train.py`
    padded_and_sorted), the batches of its view order, the views' poses as
    the dataset reads them. `drop_view` leaves each step's last view out
    under the same rules (a fault, for calibration)."""
    hp = TRAIN.hyper(cell)
    r = rules(cell)
    steps = int(cell.traffic["checked_steps"])
    pc, feats, invalid = RT.padded_and_sorted(
        x.pc, x.feats, float(cell.config["train"]["slots_ratio"]))
    state = RT.initial_state(torch.tensor(pc, device=device),
                             torch.tensor(feats, device=device),
                             torch.tensor(invalid, device=device))
    start = (state.pc, state.feats)
    mats = torch.tensor(x.pose_matrices)
    q_all = RP.rotation_matrix_to_quaternion(mats[:, :3, :3])
    losses, first = [], None
    prev = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for batch in batches_in_order(seed, x.gt.shape[0], r.size, steps):
            if drop_view:
                batch = batch[:-1]
            views = [(x.gt[v].to(device).to(torch.float32) / 255.0,
                      q_all[v:v + 1].to(device),
                      mats[v:v + 1, :3, 3].to(device)) for v in batch]
            out = RB.batch_step(state, views, x.cam, hp, r, dtype, loss_rows)
            losses.append(out.loss)
            if first is None:
                first = (out.grad_pc, out.grad_feats)
            state = out.state
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev
    return compare.TrainSide(losses, *first, *start, state.pc, state.feats,
                             tuple(state.stats))


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
        note(t0, f"trainer built, {trainer.config.batch_size} views a step")
        prog = program_side(cell, trainer, one_step)
        TRAIN._sync(device)
        setup_s = time.time() - t0 - inputs_s
        note(t0, f"checked steps done; setup_s {setup_s:.2f}")

        steps = 0
        window_start = time.perf_counter()
        while time.perf_counter() - window_start < args.seconds:
            one_step()
            steps += 1
        TRAIN._sync(device)
        window_s = time.perf_counter() - window_start
        note(t0, f"window: {steps} batch steps in {window_s:.3f} s")
        e2e = {"setup_s": setup_s, "step_ms": window_s / steps * 1e3}

        readings, summary = {}, None
        if args.trace and device.type == "cuda":
            readings, summary = _per_layer(cell, args.seed, trainer, cache)
            note(t0, f"per-layer stretch: {readings['unit_ms']:.4f} ms a "
                     f"batch step by CUDA events")
        peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                else 0)
        trainer.logger.close()
        del trainer, cache, one_step
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        note(t0, "per-layer stretches done" if args.trace else "peak read")
        checks = compare.train_readings(
            prog, reference_side(cell, x, args.seed, device))
        note(t0, "reference steps compared")
        if "work_state" in readings:
            state = readings.pop("work_state")
            per_view = TRAIN._work(cell, state, x, device)
            readings["work"] = batch_step_work(
                per_view["flops"], per_view["blend_backward_bound_ms"],
                len(state[3]), state[0].shape[0])
            note(t0, "work counted")
        return RunResult(steps, 0, e2e, readings, checks, peak, summary)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _per_layer(cell, seed, trainer, cache):
    """Stage and step times by CUDA events, then a traced stretch, over
    batch steps on the work views; and the scene as it stands, for their
    work."""
    tr = cell.traffic
    sh_band = int(tr["sh_band"])
    b = trainer.config.batch_size
    if int(tr["work_views"]) != b:
        raise ValueError(f"work_views {tr['work_views']} is not the batch "
                         f"size {b}")
    views = inputs.sample(seed, inputs.WORK, int(tr["views"]), b)
    cam, images, qs, ts, intrs = cache
    idx = torch.tensor(views)
    dev_idx = idx.to(images.device)

    def step(j, mark=None):
        kwargs = {} if mark is None else {"mark": mark}
        trainer.batch_step(images[dev_idx].to(torch.float32) / 255.0,
                           qs[dev_idx], ts[dev_idx], intrs[idx.numpy()],
                           sh_band, cam, **kwargs)

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
