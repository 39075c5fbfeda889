"""Multi-view data-parallel training on torch.distributed.

Layout:
- one process per device in a process group (NCCL on the card, gloo on
  the CPU); the scene, both Adam states and the controller accumulators
  are replicated on every rank;
- a batch of B views is cut into W contiguous blocks: rank r renders views
  [r B / W, (r + 1) B / W), so the batch's last view lives on rank W - 1.
  B must be a multiple of W;
- the per-point gradients and the controller's additions are all-reduced
  (summed), so every rank takes the same Adam update from the same sums
  and the replicas stay bitwise identical;
- without an initialized process group W = 1 and no collective is
  called.

Gradients are summed over the views, not averaged: one step on B views
equals the single-view step's accumulation over B frames before one
optimizer update. Each view's gradients and the update come from the step
module (training/step.py); the trainer (training/trainer.py) takes this
step whenever `batch_size > 1`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..camera import CameraInfo
from ..ops.rasterizer import BackwardStats, _no_mark
from ..training import step as steps
from ..training.adam_cuda import accumulate_view_gradients
from ..training.controller import ControllerState, update_stats
from ..training.ssim import psnr as psnr_fn
from ..utils.profiling import span


class Mesh(NamedTuple):
    """This process's place in the data-parallel group."""
    rank: int
    size: int
    distributed: bool   # a process group carries the collectives


def make_mesh(mesh_devices: int = 0) -> Mesh:
    """The initialized process group's rank and size, or (0, 1) without
    one. `mesh_devices` 0 takes the group's size; any other value must
    equal it."""
    if dist.is_available() and dist.is_initialized():
        mesh = Mesh(dist.get_rank(), dist.get_world_size(), True)
    else:
        mesh = Mesh(0, 1, False)
    if mesh_devices and mesh_devices != mesh.size:
        raise ValueError(f"mesh_devices={mesh_devices}, but the process "
                         f"group has {mesh.size} ranks")
    return mesh


def replicate_scene(mesh: Mesh, *states):
    """Broadcast every tensor of `states` (NamedTuples of tensors: the
    scene, Adam and controller states) from rank 0, in place. Returns
    `states`."""
    if mesh.distributed:
        for state in states:
            for x in state:
                dist.broadcast(x, src=0)
    return states


def make_data_parallel_train_step(mesh: Mesh, camera_info: CameraInfo,
                                  train_step: steps.TrainStep) -> Callable:
    """The multi-view training step over `mesh`, each view's gradients and
    the update taken by `train_step`.

    The returned function has the signature
      step(scene, opt_feat, opt_pos, ctrl_state,
           images (B, H, W, 3), qs (B, 1, 4), ts (B, 1, 3),
           intrinsics (B, 3, 3), sh_band, mark=_no_mark)
        -> (scene, opt_feat, opt_pos, ctrl_state, metrics, densify_inputs,
            last_view_maps)
    with the same B views on every rank. All views share the camera's
    image shape; their intrinsics may differ. `densify_inputs` = (stats,
    in_frustum, point_depth, point_uv) of the batch's LAST view, as
    `training.controller.densify_step` takes them; `last_view_maps` =
    (pred (H, W, 3), depth (H, W), valid count (H, W) float) of that view.
    `mark(stage)` is called after each stage of each view (those of
    `rasterize_with_vjp`, "loss" and "accumulate": the controller
    statistics and the running sums, `accumulate_view_gradients`, one
    kernel a view on the card), after "allreduce" and after "adam"; each
    stage is a span of that name (`utils/profiling.py`).
    """

    def all_sum(x):
        if mesh.distributed:
            dist.all_reduce(x)
        return x

    def from_last_rank(x):
        x = x.contiguous()
        if mesh.distributed:
            dist.broadcast(x, src=mesh.size - 1)
        return x

    def step(scene, opt_feat, opt_pos, ctrl_state, images, qs, ts,
             intrinsics, sh_band, mark=_no_mark):
        b = images.shape[0]
        if b % mesh.size:
            raise ValueError(f"a batch of {b} views does not split over "
                             f"{mesh.size} ranks")
        per_rank = b // mesh.size
        first = mesh.rank * per_rank
        dev = scene.point_cloud.device
        scale, band_mask = train_step.constants(dev, sh_band)

        # the running sums, written whole by the rank's first view
        grad_pc, grad_feats = (
            torch.empty_like(x, memory_format=torch.contiguous_format)
            for x in (scene.point_cloud, scene.point_cloud_features))
        ctrl = ctrl_state
        float_sums, count_sums = [], []
        for i in range(first, first + per_rank):
            cam = dataclasses.replace(camera_info,
                                      camera_intrinsics=intrinsics[i])
            view = steps.view_gradients(
                scene, images[i], qs[i], ts[i], cam,
                train_step.raster_config, train_step.loss_fn, scale,
                band_mask, mark)
            with span("accumulate", mark):
                aux = view.result.aux
                # the controller takes each view's raw position gradient
                ctrl = update_stats(ctrl, view.stats, view.grad_pc,
                                    aux.in_frustum)
                accumulate_view_gradients(
                    grad_feats, grad_pc, view.grad_feats_raster,
                    view.grad_pc, scale, band_mask, view.grad_feats_direct,
                    first=i == first)
                float_sums.append(torch.stack([
                    view.loss, view.l1, view.ssim_loss,
                    psnr_fn(view.image, images[i])]))
                count_sums.append(torch.stack([
                    aux.total_keys, aux.nonfinite_points]).long())

        with span("allreduce", mark):
            # sums over the views of every rank
            grad_pc = all_sum(grad_pc)
            grad_feats = all_sum(grad_feats)
            ctrl = ControllerState(*(old + all_sum(new - old)
                                     for old, new in zip(ctrl_state, ctrl)))
            loss_mean, l1_mean, ssim_mean, psnr_mean = (
                all_sum(torch.stack(float_sums).sum(0)) / b).unbind()
            total_keys, nonfinite_points = all_sum(
                torch.stack(count_sums).sum(0)).unbind()

            # densify inputs and image maps of the batch's last view (the
            # reference's trigger-frame semantics), from the last rank
            stats = view.stats
            densify_inputs = (
                BackwardStats(
                    grad_viewspace=from_last_rank(stats.grad_viewspace),
                    magnitude_grad_viewspace=from_last_rank(
                        stats.magnitude_grad_viewspace),
                    num_affected_pixels=from_last_rank(
                        stats.num_affected_pixels),
                    magnitude_grad_viewspace_on_image=torch.zeros(
                        (1, 1, 2), device=dev)),
                from_last_rank(aux.in_frustum.to(torch.uint8)).bool(),
                from_last_rank(aux.point_depth),
                from_last_rank(aux.point_uv))
            maps = (from_last_rank(view.image),
                    from_last_rank(view.result.depth),
                    from_last_rank(view.result.pixel_valid_point_count
                                   .to(torch.float32)))

        # containment after the sums, as in the single-view step; the
        # statistics were taken above, from each view's raw gradient
        with span("adam", mark):
            new = train_step.update(scene, opt_feat, opt_pos, ctrl_state,
                                    grad_feats, grad_pc, loss_mean,
                                    lambda _: ctrl)

        zero = torch.zeros((), dtype=torch.int32, device=dev)
        metrics = {
            "loss": loss_mean, "l1": l1_mean, "ssim_loss": ssim_mean,
            "psnr": psnr_mean, "ssim": 1.0 - ssim_mean,
            "key_overflow": zero, "big_point_overflow": zero,
            "tile_cap_overflow": zero,
            "total_keys": total_keys, "nonfinite_points": nonfinite_points,
            "nonfinite_grad_rows": new.nonfinite_grad_rows,
            "skipped_nonfinite_step": (~new.loss_ok).to(torch.int32),
        }
        return (*new[:4], metrics, densify_inputs, maps)

    return step
