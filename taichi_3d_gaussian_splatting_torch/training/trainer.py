"""The training loop: `GaussianPointCloudTrainer`, fed a `TrainConfig`.

Each step, on one view:
- re-normalize the stored quaternions (outside autograd);
- render with `rasterize_with_vjp` (projection, binning, the forward blend
  kernel);
- L1 + SSIM (+ the scale regularizer) on the image clipped to [0, 1];
- the backward blend kernel, per-point routing and autograd through the
  projection (`vjp_fn`); the rasterizer-path feature gradients are scaled
  per group (`_grad_group_scale`) and masked to the active SH bands, and
  the regularizer's gradient is added unscaled;
- non-finite gradient rows are zeroed, and a non-finite loss skips the
  whole update (Adam moments and controller statistics included);
- two Adam chains: features at `feature_learning_rate`, positions at
  `position_learning_rate * decay_rate ** ceil(count / decay_interval)`.

Around the steps: densify every `num_iterations_densify` after warm-up
from the trigger step's pre-optimizer positions, alpha reset every
`num_iterations_reset_alpha`, coarse-to-fine downsampling (halved every
`half_downsample_factor_interval`), the SH-band curriculum, a loss-spike
detector, validation every `val_interval` (and at 5000 and 7000) writing
`scene_{it}.parquet`, `best_scene.parquet` and a full checkpoint, and
resume from that checkpoint.

The training set lives on the device (uint8) when every image has one
shape and fits `device_cache_max_bytes`; otherwise a thread pool streams
it. Per-step metrics stay on the device and reach the host once per
`log_loss_interval`.

The same YAML files load as for the JAX package. Its capacity knobs are
accepted and ignored (the port's binning has no budgets), and so are
`enable_profiler` and its two settings. `batch_size > 1` (the multi-view
data-parallel step) is not ported and raises.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import config as config_io
from ..camera import CameraInfo
from ..data.dataset import DatasetItem, ImagePoseDataset, PrefetchLoader
from ..models.scene import GaussianPointCloudScene, SceneConfig
from ..ops.rasterizer import (BackwardStats, RasterizeResult,
                              RasterizerConfig, _no_mark, rasterize,
                              rasterize_with_vjp)
from ..ops.sh import feature_sh_band_mask
from .adam import AdamState, adam_init, adam_update, exponential_decay_lr
from .checkpoint import load_checkpoint, save_checkpoint
from .controller import (AdaptiveControllerConfig, ControllerState,
                         densify_step, reset_alpha, update_stats)
from .loss import LossFunction, LossFunctionConfig
from .ssim import psnr as psnr_fn


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's TrainConfig schema (same YAML files)."""
    train_dataset_json_path: str = ""
    val_dataset_json_path: str = ""
    pointcloud_parquet_path: str = ""
    num_iterations: int = 300000
    val_interval: int = 1000
    feature_learning_rate: float = 1e-3
    position_learning_rate: float = 1e-5
    position_learning_rate_decay_rate: float = 0.97
    position_learning_rate_decay_interval: int = 100
    increase_color_max_sh_band_interval: int = 1000
    log_loss_interval: int = 10
    log_metrics_interval: int = 100
    print_metrics_to_console: bool = False
    log_image_interval: int = 1000
    enable_taichi_kernel_profiler: bool = False  # accepted, ignored
    log_taichi_kernel_profile_interval: int = 1000  # accepted, ignored
    log_validation_image: bool = True
    initial_downsample_factor: int = 4
    half_downsample_factor_interval: int = 250
    summary_writer_log_dir: str = "logs"
    output_model_dir: Optional[str] = None
    seed: int = 0
    save_full_checkpoint: bool = True
    resume_from_checkpoint: str = ""
    # accepted and ignored (the JAX package's profiler hook)
    enable_profiler: bool = False
    profiler_start_iteration: int = 100
    profiler_num_steps: int = 5
    # accepted and ignored (the JAX package's capacity budgets; this
    # package's binning has none)
    overflow_check_interval: int = 10
    auto_capacity: bool = False
    auto_capacity_headroom: float = 2.0
    auto_capacity_probe_views: int = 4
    fail_on_capacity_overflow: bool = False
    capacity_recovery: bool = True
    recovery_tail_fraction: float = 0.02
    capacity_probe_ahead: bool = True
    capacity_probe_ahead_margin: float = 1.2
    # multi-view data parallelism: only batch_size 1 is ported
    batch_size: int = 1
    mesh_devices: int = 0
    scale_schedules_with_batch: bool = True
    scale_lr_with_batch: str = "sqrt"
    scale_betas_with_batch: bool = False
    # the training set on the device (uint8) when shapes are uniform and
    # it fits this many bytes; otherwise a thread pool streams it
    cache_dataset_on_device: bool = True
    device_cache_max_bytes: int = 4 * 1024 ** 3
    # Morton-order the initial point pool (locality of the slab gather)
    spatial_sort: bool = True
    rasterisation_config: RasterizerConfig = dataclasses.field(
        default_factory=RasterizerConfig)
    adaptive_controller_config: AdaptiveControllerConfig = dataclasses.field(
        default_factory=AdaptiveControllerConfig)
    gaussian_point_cloud_scene_config: SceneConfig = dataclasses.field(
        default_factory=SceneConfig)
    loss_function_config: LossFunctionConfig = dataclasses.field(
        default_factory=LossFunctionConfig)

    @staticmethod
    def from_yaml_file(path: str) -> "TrainConfig":
        return config_io.from_yaml_file(TrainConfig, path)

    def to_yaml_file(self, path: str):
        config_io.to_yaml_file(self, path)


def _grad_group_scale(config: RasterizerConfig) -> np.ndarray:
    """(56,) per-feature scale of the rasterizer-path gradients."""
    scale = np.full((56,), config.grad_high_order_color_factor, np.float32)
    scale[0:4] = config.grad_q_factor
    scale[4:7] = config.grad_s_factor
    scale[7] = config.grad_alpha_factor
    scale[8] = config.grad_color_factor
    scale[24] = config.grad_color_factor
    scale[40] = config.grad_color_factor
    return scale


def _downsample_item(item: DatasetItem, factor: int) -> DatasetItem:
    """Image and camera downsampled on the host (bilinear, through uint8)."""
    if factor <= 1:
        return item
    import PIL.Image
    cam = item.camera_info.downsample(factor)
    pil = PIL.Image.fromarray((item.image * 255.0).astype(np.uint8))
    resized = pil.resize((item.camera_info.camera_width // factor,
                          item.camera_info.camera_height // factor),
                         PIL.Image.BILINEAR)
    arr = np.asarray(resized, np.float32)[:cam.camera_height,
                                          :cam.camera_width, :3] / 255.0
    return DatasetItem(np.ascontiguousarray(arr), item.q_pointcloud_camera,
                       item.t_pointcloud_camera, cam)


def _to_uint8(image: np.ndarray) -> np.ndarray:
    """Lossless for PNG-sourced images (k / 255 rounds back to k)."""
    return np.round(np.asarray(image, np.float32) * 255.0).astype(np.uint8)


def _cache_image_to_float(x: torch.Tensor) -> torch.Tensor:
    # true division, as the dataset's png / 255.0
    return x.to(torch.float32) / 255.0


class MetricsLogger:
    """JSONL + console (`key=value;` lines) + TensorBoard, when the
    `tensorboard` package is installed."""

    def __init__(self, log_dir: str, print_to_console: bool,
                 enable_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.print_to_console = print_to_console
        self.tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(log_dir=log_dir)

    def scalars(self, iteration: int, values: dict, console_keys=()):
        rec = {"iteration": iteration}
        rec.update({k: float(v) for k, v in values.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(k, float(v), iteration)
        if self.print_to_console:
            for k in (console_keys or values.keys()):
                print(f"{k.replace('/', '_')}={float(values[k])};")

    def image(self, iteration: int, tag: str, image_hwc: np.ndarray):
        if self.tb is not None:
            self.tb.add_image(tag, np.transpose(
                np.clip(image_hwc, 0, 1), (2, 0, 1)), iteration)

    def histogram(self, iteration: int, tag: str, values: np.ndarray):
        if self.tb is not None and np.size(values):
            self.tb.add_histogram(tag, values, iteration)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class StepOutput(NamedTuple):
    """What one training step leaves for the loop."""
    metrics: dict                # name -> 0-d tensor on the device
    stats: BackwardStats         # for densify
    result: RasterizeResult      # no autograd graph
    image: torch.Tensor          # the clipped render (H, W, 3)


class GaussianPointCloudTrainer:
    def __init__(self, config: TrainConfig, device="cuda"):
        if config.output_model_dir is None:
            config.output_model_dir = config.summary_writer_log_dir
        if config.batch_size != 1:
            raise NotImplementedError(
                "batch_size > 1 (the multi-view data-parallel step) is not "
                "ported to taichi_3d_gaussian_splatting_torch")
        self.config = config
        self.device = torch.device(device)
        os.makedirs(config.summary_writer_log_dir, exist_ok=True)
        os.makedirs(config.output_model_dir, exist_ok=True)
        self.logger = MetricsLogger(config.summary_writer_log_dir,
                                    config.print_metrics_to_console)
        self.train_dataset = ImagePoseDataset(config.train_dataset_json_path)
        self.val_dataset = ImagePoseDataset(config.val_dataset_json_path)
        self.scene = GaussianPointCloudScene.from_parquet(
            config.pointcloud_parquet_path,
            config.gaussian_point_cloud_scene_config,
            rng=np.random.default_rng(config.seed), device=self.device)
        if config.spatial_sort:
            self.scene = self.scene.spatially_sorted()
        self.ctrl_state = ControllerState.zeros(self.scene.capacity,
                                                self.device)
        self.loss_fn = LossFunction(config.loss_function_config)
        self.best_psnr_score = 0.0
        # densify's split draws (on the device) and the view order (host)
        self.generator = torch.Generator(self.device).manual_seed(
            config.seed)
        self.data_generator = torch.Generator().manual_seed(config.seed)
        self.opt_features = adam_init(self.scene.point_cloud_features)
        self.opt_positions = adam_init(self.scene.point_cloud)
        self._grad_scale = torch.as_tensor(
            _grad_group_scale(config.rasterisation_config),
            device=self.device)
        self._band_masks = {}
        self._val_cache = None
        self._order = []  # view indices left in the current epoch
        self.start_iteration = 0
        if config.resume_from_checkpoint:
            self.load(config.resume_from_checkpoint)

    # ------------------------------------------------------------------
    # state <-> checkpoint
    # ------------------------------------------------------------------

    def state_arrays(self) -> dict:
        """The whole training state as named tensors (see `load`)."""
        arrays = {f"scene.{k}": v for k, v in self.scene._asdict().items()}
        for name, st in (("adam_features", self.opt_features),
                         ("adam_positions", self.opt_positions)):
            arrays.update({f"{name}.{k}": v for k, v in st._asdict().items()})
        arrays.update({f"controller.{k}": v
                       for k, v in self.ctrl_state._asdict().items()})
        arrays["generator"] = self.generator.get_state()
        arrays["data_generator"] = self.data_generator.get_state()
        return arrays

    def save(self, path: str, iteration: int):
        save_checkpoint(path, self.state_arrays(), iteration,
                        self.best_psnr_score)

    def load(self, path: str):
        """Restore what `save` wrote; training resumes at its iteration."""
        arrays, self.start_iteration, self.best_psnr_score = \
            load_checkpoint(path)
        dev = self.device

        def group(prefix, cls):
            return cls(*(torch.tensor(arrays[f"{prefix}.{f}"], device=dev)
                         for f in cls._fields))

        self.scene = group("scene", GaussianPointCloudScene)
        self.opt_features = group("adam_features", AdamState)
        self.opt_positions = group("adam_positions", AdamState)
        self.ctrl_state = group("controller", ControllerState)
        self.generator.set_state(torch.tensor(arrays["generator"]))
        self.data_generator.set_state(torch.tensor(arrays["data_generator"]))

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------

    def _band_mask(self, sh_band: int) -> torch.Tensor:
        if sh_band not in self._band_masks:
            self._band_masks[sh_band] = feature_sh_band_mask(
                sh_band, device=self.device)
        return self._band_masks[sh_band]

    def step(self, image_gt: torch.Tensor, q: torch.Tensor, t: torch.Tensor,
             sh_band: int, camera_info: CameraInfo,
             mark=_no_mark) -> StepOutput:
        """One optimizer step on one view (all tensors on the trainer's
        device); updates the scene, both Adam states and the controller
        statistics. `mark(stage)` is called after each stage (those of
        `rasterize_with_vjp`, "loss" and "adam"), a timing hook."""
        cfg = self.config
        scene = self.scene
        feats = scene.point_cloud_features
        # re-normalize the stored quaternion; the norm is floored so an
        # all-zero padding slot stays 0
        qnorm = feats[:, 0:4] / torch.clamp(torch.linalg.norm(
            feats[:, 0:4], dim=1, keepdim=True), min=1e-12)
        feats = torch.cat([qnorm, feats[:, 4:]], dim=1)

        result, vjp_fn = rasterize_with_vjp(
            scene.point_cloud, feats, scene.point_invalid_mask,
            scene.point_object_id, q, t, camera_info,
            cfg.rasterisation_config, mark=mark)

        # loss on the clipped image; its gradient with respect to the image
        # and, for the regularizer, directly to the features
        image = result.image.detach().requires_grad_(True)
        feats_leaf = feats.detach().requires_grad_(True)
        with torch.enable_grad():
            img = torch.clamp(image, 0.0, 1.0)
            loss, l1, ld_ssim = self.loss_fn(
                img, image_gt, point_invalid_mask=scene.point_invalid_mask,
                pointcloud_features=feats_leaf)
            g_image, g_feats_direct = torch.autograd.grad(
                loss, (image, feats_leaf), allow_unused=True)
        if g_feats_direct is None:
            g_feats_direct = torch.zeros_like(feats)
        mark("loss")

        grad_pc, grad_feats_raster, stats = vjp_fn(g_image)
        grad_feats = (grad_feats_raster * self._grad_scale
                      * self._band_mask(sh_band) + g_feats_direct)

        # a culled degenerate splat's VJP can still give 0 * inf = NaN
        # rows: zero them so one point cannot poison its Adam moments
        feat_row_ok = torch.isfinite(grad_feats).all(dim=1, keepdim=True)
        pc_row_ok = torch.isfinite(grad_pc).all(dim=1, keepdim=True)
        nonfinite_grad_rows = (~feat_row_ok[:, 0] | ~pc_row_ok[:, 0]).sum(
            dtype=torch.int32)
        grad_feats = torch.where(feat_row_ok, grad_feats,
                                 torch.zeros_like(grad_feats))
        grad_pc = torch.where(pc_row_ok, grad_pc, torch.zeros_like(grad_pc))
        # a non-finite loss poisons every gradient: keep the old state
        loss = loss.detach()
        loss_ok = torch.isfinite(loss)

        new_feats, opt_f = adam_update(feats, grad_feats, self.opt_features,
                                       cfg.feature_learning_rate)
        pos_lr = exponential_decay_lr(
            cfg.position_learning_rate,
            cfg.position_learning_rate_decay_rate,
            cfg.position_learning_rate_decay_interval,
            self.opt_positions.count)
        new_pc, opt_p = adam_update(scene.point_cloud, grad_pc,
                                    self.opt_positions, pos_lr)

        def keep_if_ok(new, old):
            return type(old)(*(torch.where(loss_ok, a, b)
                               for a, b in zip(new, old)))

        self.opt_features = keep_if_ok(opt_f, self.opt_features)
        self.opt_positions = keep_if_ok(opt_p, self.opt_positions)
        self.scene = scene._replace(
            point_cloud=torch.where(loss_ok, new_pc, scene.point_cloud),
            point_cloud_features=torch.where(loss_ok, new_feats, feats))
        self.ctrl_state = keep_if_ok(
            update_stats(self.ctrl_state, stats, grad_pc,
                         result.aux.in_frustum), self.ctrl_state)
        mark("adam")

        img = img.detach()
        metrics = {
            "loss": loss, "l1": l1.detach(), "ssim_loss": ld_ssim.detach(),
            "psnr": psnr_fn(img, image_gt), "ssim": 1.0 - ld_ssim.detach(),
            "total_keys": result.aux.total_keys,
            "nonfinite_points": result.aux.nonfinite_points,
            "nonfinite_grad_rows": nonfinite_grad_rows,
            "skipped_nonfinite_step": (~loss_ok).to(torch.int32),
        }
        return StepOutput(metrics, stats, result, img)

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def _device_cache(self, dataset: ImagePoseDataset, factor: int):
        """(camera, images (V, H, W, 3) uint8, qs (V, 1, 4), ts (V, 1, 3))
        on the device and the intrinsics (V, 3, 3) as numpy, or None when
        the images' shapes differ or they would exceed
        device_cache_max_bytes."""
        items = [_downsample_item(dataset[i], factor)
                 for i in range(len(dataset))]
        shapes = {(it.camera_info.camera_height, it.camera_info.camera_width)
                  for it in items}
        if (len(items) == 0 or len(shapes) != 1
                or sum(it.image.size for it in items)
                > self.config.device_cache_max_bytes):
            return None

        def stack(arrays, dtype=np.float32):
            return torch.as_tensor(np.stack(
                [np.asarray(a, dtype) for a in arrays]), device=self.device)

        return (items[0].camera_info,
                stack([_to_uint8(it.image) for it in items], np.uint8),
                stack([it.q_pointcloud_camera for it in items]),
                stack([it.t_pointcloud_camera for it in items]),
                np.stack([np.asarray(it.camera_info.camera_intrinsics,
                                     np.float32) for it in items]))

    def _next_view(self, cache, stream, factor):
        """(image_gt, q, t, camera) of the next training view."""
        if cache is not None:
            cam, images, qs, ts, intrs = cache
            if not self._order:
                self._order = torch.randperm(
                    images.shape[0], generator=self.data_generator).tolist()
            idx = self._order.pop(0)
            cam = dataclasses.replace(cam, camera_intrinsics=intrs[idx])
            return _cache_image_to_float(images[idx]), qs[idx], ts[idx], cam
        item = _downsample_item(next(stream), factor)
        dev = self.device
        return (torch.as_tensor(item.image, device=dev),
                torch.as_tensor(item.q_pointcloud_camera, device=dev),
                torch.as_tensor(item.t_pointcloud_camera, device=dev),
                item.camera_info)

    def train(self):
        config = self.config
        ctrl_cfg = config.adaptive_controller_config
        loader = stream = None
        cache = None
        cache_factor = -1
        downsample_factor = config.initial_downsample_factor
        recent_losses = collections.deque(maxlen=100)
        pending = []
        self._previous_problematic_iteration = -1000
        self._last_containment_warn = -1000
        start = self.start_iteration
        # replay the downsample schedule up to the resume point
        for it in range(1, start):
            if (it % config.half_downsample_factor_interval == 0
                    and downsample_factor > 1):
                downsample_factor //= 2
        last_time = time.perf_counter()
        try:
            for iteration in range(start, config.num_iterations):
                if (iteration % config.half_downsample_factor_interval == 0
                        and iteration > 0 and downsample_factor > 1):
                    downsample_factor //= 2
                sh_band = (iteration
                           // config.increase_color_max_sh_band_interval)
                if (config.cache_dataset_on_device
                        and cache_factor != downsample_factor):
                    cache = self._device_cache(self.train_dataset,
                                               downsample_factor)
                    cache_factor = downsample_factor
                    self._order = []
                if cache is None and stream is None:
                    loader = PrefetchLoader(self.train_dataset, shuffle=True,
                                            num_workers=4, seed=config.seed)
                    stream = iter(loader)
                densify_due = (iteration >= ctrl_cfg.num_iterations_warm_up
                               and iteration
                               % ctrl_cfg.num_iterations_densify == 0)
                # a copy: densify seeds new points from the positions
                # before this step's optimizer update
                pos_before = (self.scene.point_cloud.clone() if densify_due
                              else None)
                image_gt, q, t, cam = self._next_view(cache, stream,
                                                      downsample_factor)
                out = self.step(image_gt, q, t, sh_band, cam)

                if densify_due:
                    self._densify(iteration, out, pos_before, cam)
                if (iteration >= ctrl_cfg.num_iterations_warm_up
                        and iteration
                        % ctrl_cfg.num_iterations_reset_alpha == 0):
                    self.scene = reset_alpha(self.scene, ctrl_cfg)

                now = time.perf_counter()
                pending.append((iteration, out.metrics, now - last_time))
                last_time = now
                validation_due = ((iteration % config.val_interval == 0
                                   and iteration != 0)
                                  or iteration in (5000, 7000))
                is_problematic = False
                if (iteration % config.log_loss_interval == 0
                        or validation_due
                        or iteration == config.num_iterations - 1):
                    is_problematic = self._flush_metrics(pending,
                                                         recent_losses)
                    pending = []
                if (self.logger.tb is not None
                        and (iteration % config.log_image_interval == 0
                             or is_problematic)):
                    self._log_panel(iteration, is_problematic, out,
                                    image_gt)
                if validation_due:
                    self.validation(iteration)
            self.validation(config.num_iterations,
                            completed=config.num_iterations)
        finally:
            if loader is not None:
                loader.close()

    def _densify(self, iteration, out, pos_before, cam):
        ctrl_cfg = self.config.adaptive_controller_config
        aux = out.result.aux
        self._log_histograms(iteration, out.stats)
        self.scene, self.ctrl_state, counts = densify_step(
            self.scene, self.ctrl_state, out.stats, aux.in_frustum,
            aux.point_depth, pos_before, iteration, self.generator, ctrl_cfg)
        if (self.logger.tb is not None
                and iteration % ctrl_cfg.plot_densify_interval == 0):
            from ..utils.visualization import densify_scatter_figure
            img = densify_scatter_figure(
                aux.point_uv.cpu().numpy(), counts.floater_mask.cpu().numpy(),
                counts.over_reconstructed_mask.cpu().numpy(),
                counts.under_reconstructed_mask.cpu().numpy(),
                cam.camera_height, cam.camera_width)
            if img is not None:
                self.logger.image(iteration, "densify/scatter", img)
        self.logger.scalars(iteration, {
            "densify/num_transparent": counts.num_transparent,
            "densify/num_floaters": counts.num_floaters,
            "densify/num_candidates": counts.num_candidates,
            "densify/num_fillable": counts.num_fillable,
            "densify/num_over_reconstructed": counts.num_over_reconstructed,
            "value/num_valid_points": counts.num_valid_after,
        })

    def _flush_metrics(self, pending, recent_losses) -> bool:
        """Bring the queued per-step metrics to the host in one copy, run
        the loss-spike detector and log. Returns whether an iteration was
        problematic (loss above 1.5x the mean of the last 100, or a skipped
        non-finite step)."""
        config = self.config
        if not pending:
            return False
        names = list(pending[0][1])
        fetched = torch.stack([
            torch.stack([m[k].to(torch.float32) for k in names])
            for _, m, _ in pending]).cpu().numpy()
        mean_wall = sum(w for _, _, w in pending) / len(pending)
        any_problematic = False
        for (iteration, _, _), row in zip(pending, fetched):
            vals = dict(zip(names, row.tolist()))
            loss_value = vals["loss"]
            recent_losses.append(loss_value)
            if (len(recent_losses) == recent_losses.maxlen
                    and iteration - self._previous_problematic_iteration
                    > recent_losses.maxlen):
                if loss_value > 1.5 * sum(recent_losses) / len(recent_losses):
                    any_problematic = True
                    self._previous_problematic_iteration = iteration
            nonfin = (vals["nonfinite_points"] + vals["nonfinite_grad_rows"]
                      + vals["skipped_nonfinite_step"])
            severe = (vals["skipped_nonfinite_step"] > 0
                      or not math.isfinite(loss_value))
            if nonfin > 0 or severe:
                if severe:
                    any_problematic = True
                    self._previous_problematic_iteration = iteration
                if severe or iteration - self._last_containment_warn >= 100:
                    self._last_containment_warn = iteration
                    print(f"WARNING: numeric containment at iteration "
                          f"{iteration}: culled_points="
                          f"{vals['nonfinite_points']:.0f} zeroed_grad_rows="
                          f"{vals['nonfinite_grad_rows']:.0f} skipped_step="
                          f"{vals['skipped_nonfinite_step']:.0f} "
                          f"loss={loss_value}", flush=True)
                self.logger.scalars(iteration, {
                    "train/nonfinite_points": vals["nonfinite_points"],
                    "train/nonfinite_grad_rows": vals["nonfinite_grad_rows"],
                    "train/skipped_nonfinite_step":
                        vals["skipped_nonfinite_step"]})
            if iteration % config.log_loss_interval == 0:
                self.logger.scalars(iteration, {
                    "train/iter_wall_seconds": mean_wall,
                    "train/loss": vals["loss"],
                    "train/l1 loss": vals["l1"],
                    "train/ssim loss": vals["ssim_loss"],
                    "train/total_keys": vals["total_keys"],
                }, console_keys=(
                    ("train/loss", "train/l1 loss", "train/ssim loss")
                    if config.print_metrics_to_console else ()))
                if config.print_metrics_to_console:
                    print(f"train_iteration={iteration};")
            if iteration % config.log_metrics_interval == 0:
                self.logger.scalars(iteration, {
                    "train/psnr": vals["psnr"], "train/ssim": vals["ssim"]})
                if config.print_metrics_to_console:
                    print(f"train_psnr={vals['psnr']};")
                    print(f"train_psnr_{iteration}={vals['psnr']};")
                    print(f"train_ssim={vals['ssim']};")
                    print(f"train_ssim_{iteration}={vals['ssim']};")
        return any_problematic

    def _log_panel(self, iteration, is_problematic, out, image_gt):
        """[pred | gt | depth | points per pixel | error] panel."""
        from ..utils.visualization import (easy_cmap, make_image_grid,
                                           normalized_gray)
        pred = out.image.cpu().numpy()
        gt = image_gt.cpu().numpy()
        panel = make_image_grid([
            pred, gt, easy_cmap(out.result.depth.cpu().numpy()),
            normalized_gray(out.result.pixel_valid_point_count.cpu().numpy()),
            np.abs(pred - gt)], nrow=2)
        self.logger.image(iteration, "train/image_problematic"
                          if is_problematic else "train/image", panel)

    def _log_histograms(self, iteration, stats):
        if self.logger.tb is None:
            return
        feats = self.scene.point_cloud_features.cpu().numpy()
        fv = feats[self.scene.point_invalid_mask.cpu().numpy() == 0]
        for tag, values in (
                ("value/q", fv[:, 0:4]), ("value/s", fv[:, 4:7]),
                ("value/alpha", fv[:, 7]),
                ("value/sigmoid_alpha", 1.0 / (1.0 + np.exp(-fv[:, 7]))),
                ("value/r", fv[:, 8:24]), ("value/g", fv[:, 24:40]),
                ("value/b", fv[:, 40:56]),
                ("grad/uv_grad", stats.grad_viewspace.cpu().numpy()),
                ("grad/uv_grad_magnitude",
                 stats.magnitude_grad_viewspace.cpu().numpy()),
                ("value/num_affected_pixels",
                 stats.num_affected_pixels.cpu().numpy())):
            self.logger.histogram(iteration, tag, values)

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------

    def validation(self, iteration: int, completed: Optional[int] = None):
        """Mean loss / PSNR / SSIM over the validation set; writes
        scene_{iteration}.parquet, best_scene.parquet on a new best PSNR,
        and the full checkpoint (resuming at `completed`)."""
        config = self.config
        if completed is None:
            completed = iteration + 1
        if self._val_cache is None:
            self._val_cache = (self._device_cache(self.val_dataset, 1)
                               if config.cache_dataset_on_device else None)
        views = []
        if self._val_cache is not None:
            cam, images, qs, ts, intrs = self._val_cache
            for i in range(images.shape[0]):
                views.append((dataclasses.replace(
                    cam, camera_intrinsics=intrs[i]), qs[i], ts[i],
                    _cache_image_to_float(images[i])))
        else:
            for i in range(len(self.val_dataset)):
                item = self.val_dataset[i]
                views.append((item.camera_info,
                              torch.as_tensor(item.q_pointcloud_camera,
                                              device=self.device),
                              torch.as_tensor(item.t_pointcloud_camera,
                                              device=self.device),
                              torch.as_tensor(item.image,
                                              device=self.device)))
        if not views:
            return
        per_view = []
        t0 = time.perf_counter()
        with torch.no_grad():
            for idx, (cam, q, t, gt) in enumerate(views):
                img = torch.clamp(rasterize(
                    *self.scene, q, t, cam,
                    config.rasterisation_config).image, 0.0, 1.0)
                loss, _, ld_ssim = self.loss_fn(img, gt)
                per_view.append(torch.stack([loss, psnr_fn(img, gt),
                                             1.0 - ld_ssim]))
                if config.log_validation_image and self.logger.tb is not None:
                    self.logger.image(iteration, f"val/image {idx}",
                                      np.concatenate([img.cpu().numpy(),
                                                      gt.cpu().numpy()], 1))
        mean_loss, mean_psnr, mean_ssim = (
            torch.stack(per_view).mean(dim=0).tolist())
        mean_time = (time.perf_counter() - t0) * 1000.0 / len(views)
        self.logger.scalars(iteration, {
            "val/loss": mean_loss, "val/psnr": mean_psnr,
            "val/ssim": mean_ssim, "val/inference_time": mean_time})
        if config.print_metrics_to_console:
            print(f"val_loss={mean_loss};")
            print(f"val_psnr={mean_psnr};")
            print(f"val_psnr_{iteration}={mean_psnr};")
            print(f"val_ssim={mean_ssim};")
            print(f"val_ssim_{iteration}={mean_ssim};")
            print(f"val_inference_time={mean_time};")
        self.scene.to_parquet(os.path.join(config.output_model_dir,
                                           f"scene_{iteration}.parquet"))
        if mean_psnr > self.best_psnr_score:
            self.best_psnr_score = mean_psnr
            self.scene.to_parquet(os.path.join(config.output_model_dir,
                                               "best_scene.parquet"))
        if config.save_full_checkpoint:
            self.save(os.path.join(config.output_model_dir,
                                   "train_state.npz"), completed)
