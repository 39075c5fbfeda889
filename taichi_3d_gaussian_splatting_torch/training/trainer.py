"""The training loop: `GaussianPointCloudTrainer`, fed a `TrainConfig`.

Each step is `training/step.py`'s: on one view, `TrainStep.single_view`
(render, the loss and its gradient, the rasterizer's VJP, then the update
of both Adam chains under the loss guard, `TrainStep.update`); the
position group's rate is `position_learning_rate * decay_rate **
ceil(count / decay_interval)`.

With `batch_size` B > 1 a step takes B views through
`parallel/sharding.py`: the views are split over the ranks of the
torch.distributed process group (one rank without a group), gradients and
controller statistics are summed over all B views, and densify takes the
batch's last view. The iteration schedules are then divided by B and the
learning rates multiplied by 1, sqrt(B) or B (`_scale_schedules_for_batch`);
`scale_betas_with_batch` raises Adam's betas to the power B. Only rank 0
writes metrics, parquets and checkpoints and runs the validation.

Around the steps, what depends on the iteration alone is one method,
`train_iteration`: the SH-band curriculum, densify every
`num_iterations_densify` after warm-up from the trigger step's
pre-optimizer positions (span `densify`), alpha reset every
`num_iterations_reset_alpha` (span `reset alpha`). `train()` feeds it the
views and keeps the rest: coarse-to-fine downsampling (halved every
`half_downsample_factor_interval`), the view stream, a loss-spike
detector, validation every `val_interval` (and at 5000 and 7000) writing
`scene_{it}.parquet`, `best_scene.parquet` and a full checkpoint, and
resume from that checkpoint.

The training set lives on the device (uint8) when every image has one
shape and fits `device_cache_max_bytes`; otherwise a thread pool streams
it. Per-step metrics stay on the device and reach the host once per
`log_loss_interval`.

With `enable_profiler`, iterations [`profiler_start_iteration`,
`profiler_start_iteration + profiler_num_steps`) run under torch.profiler
(`utils/profiling.py`), each in a range `iteration {i}`, and each rank
writes its trace to `<summary_writer_log_dir>/profile/`, also when the run
ends inside the window. A tqdm progress bar shows on rank 0 when tqdm is
installed.

The same YAML files load as for the JAX package. Its capacity knobs are
accepted and ignored (the port's binning has no budgets).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
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
from ..ops.rasterizer import RasterizerConfig, _no_mark, rasterize
from ..parallel.sharding import (make_data_parallel_train_step, make_mesh,
                                 replicate_scene)
from ..utils.profiling import TraceWindow, span
from .adam import AdamGroup, AdamState, adam_init, exponential_decay_lr
from .checkpoint import load_checkpoint, save_checkpoint
from .controller import (AdaptiveControllerConfig, ControllerState,
                         count_round, densify_step, reset_alpha)
from .loss import LossFunction, LossFunctionConfig
from .loss_cuda import image_loss
from .ssim import psnr as psnr_fn
from .step import TrainStep


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
    # a torch.profiler trace of iterations [start, start + num_steps)
    # under <summary_writer_log_dir>/profile/
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
    # views per optimizer step, split over the ranks of the process group
    # (a multiple of their number); mesh_devices 0 = the group's size
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


def _scale_schedules_for_batch(config: TrainConfig) -> TrainConfig:
    """A copy of `config` for `batch_size` B > 1: with
    `scale_schedules_with_batch`, the iteration schedules (warm-up,
    densify, alpha reset, floater start, SH unlock, downsample, position-LR
    decay) divided by B (at least 1), so that they keep their cadence per
    image; both learning rates times 1, sqrt(B) or B
    (`scale_lr_with_batch` none / sqrt / linear). `num_iterations` and
    `val_interval` stay as given."""
    b = int(config.batch_size)
    if b <= 1:
        return config
    lr_mult = {"none": 1.0, "sqrt": float(b) ** 0.5,
               "linear": float(b)}[config.scale_lr_with_batch]
    lrs = dict(feature_learning_rate=config.feature_learning_rate * lr_mult,
               position_learning_rate=config.position_learning_rate * lr_mult)
    if not config.scale_schedules_with_batch:
        return dataclasses.replace(config, **lrs)

    def div(x):
        return max(int(x) // b, 1)

    ctrl = config.adaptive_controller_config
    ctrl = dataclasses.replace(
        ctrl, num_iterations_warm_up=div(ctrl.num_iterations_warm_up),
        num_iterations_densify=div(ctrl.num_iterations_densify),
        num_iterations_reset_alpha=div(ctrl.num_iterations_reset_alpha),
        iteration_start_remove_floater=div(
            ctrl.iteration_start_remove_floater))
    scaled = dataclasses.replace(
        config, adaptive_controller_config=ctrl,
        increase_color_max_sh_band_interval=div(
            config.increase_color_max_sh_band_interval),
        half_downsample_factor_interval=div(
            config.half_downsample_factor_interval),
        position_learning_rate_decay_interval=div(
            config.position_learning_rate_decay_interval), **lrs)
    logging.getLogger(__name__).info(
        "batch_size=%d: iteration schedules divided by the batch size "
        "(densify %d, warm-up %d, alpha reset %d, SH unlock %d, downsample "
        "%d, position-LR decay %d)", b, ctrl.num_iterations_densify,
        ctrl.num_iterations_warm_up, ctrl.num_iterations_reset_alpha,
        scaled.increase_color_max_sh_band_interval,
        scaled.half_downsample_factor_interval,
        scaled.position_learning_rate_decay_interval)
    return scaled


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
    `tensorboard` package is installed. With `write` False (a rank other
    than 0) it writes nothing."""

    def __init__(self, log_dir: str, print_to_console: bool,
                 enable_tensorboard: bool = True, write: bool = True):
        self.jsonl = None
        self.print_to_console = print_to_console and write
        self.tb = None
        if not write:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(log_dir=log_dir)

    def scalars(self, iteration: int, values: dict, console_keys=()):
        if self.jsonl is None:
            return
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
        if self.jsonl is not None:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class StepOutput(NamedTuple):
    """What one training step leaves for the loop."""
    metrics: dict          # name -> 0-d tensor on the device
    densify_inputs: tuple  # (BackwardStats, in_frustum, point_depth,
    #                        point_uv) of the step's (last) view
    maps: tuple            # (clipped render (H, W, 3), depth (H, W),
    #                        valid point count (H, W)) of that view
    densify_counts: object = None  # the iteration's round's DensifyCounts
    #                                (`train_iteration`), if one ran


class GaussianPointCloudTrainer:
    def __init__(self, config: TrainConfig, device="cuda"):
        """`device` is this rank's device. Under an initialized
        torch.distributed process group the batch is split over its ranks
        (`parallel/sharding.py`), and the state is broadcast from rank 0
        after init and after a resume."""
        # the caller's config object gets only its output_model_dir filled
        if config.output_model_dir is None:
            config.output_model_dir = config.summary_writer_log_dir
        config = _scale_schedules_for_batch(config)
        self.config = config
        self.device = torch.device(device)
        self.mesh = make_mesh(config.mesh_devices)
        if config.batch_size < 1 or config.batch_size % self.mesh.size:
            raise ValueError(f"batch_size {config.batch_size} is not a "
                             f"multiple of the {self.mesh.size} ranks")
        self.is_main = self.mesh.rank == 0
        b = config.batch_size
        self.betas = ((0.9 ** b, 0.999 ** b) if config.scale_betas_with_batch
                      else (0.9, 0.999))
        os.makedirs(config.summary_writer_log_dir, exist_ok=True)
        os.makedirs(config.output_model_dir, exist_ok=True)
        self.logger = MetricsLogger(config.summary_writer_log_dir,
                                    config.print_metrics_to_console,
                                    write=self.is_main)
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
        # what every step holds fixed, each group's Adam among it
        self.train_step = TrainStep(
            config.rasterisation_config, self.loss_fn,
            AdamGroup(config.feature_learning_rate, *self.betas),
            AdamGroup(self._position_learning_rate, *self.betas))
        self._batch_steps = {}
        self._val_cache = None
        # the epoch's view permutation and the position in it
        self._perm = None
        self._pos = 0
        self.start_iteration = 0
        if config.resume_from_checkpoint:
            self.load(config.resume_from_checkpoint)
        replicate_scene(self.mesh, self.scene, self.opt_features,
                        self.opt_positions, self.ctrl_state)

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
        self.load_state(arrays)

    def load_state(self, arrays: dict):
        """Put back the state `state_arrays` names, from numpy arrays or
        tensors, copied; the next view starts a new permutation, as a
        resumed `train()` does."""
        dev = self.device

        def copy(v):
            if isinstance(v, torch.Tensor):
                return v.to(dev, copy=True)
            return torch.tensor(v, device=dev)

        def group(prefix, cls):
            return cls(*(copy(arrays[f"{prefix}.{f}"]) for f in cls._fields))

        self.scene = group("scene", GaussianPointCloudScene)
        self.opt_features = group("adam_features", AdamState)
        self.opt_positions = group("adam_positions", AdamState)
        self.ctrl_state = group("controller", ControllerState)
        self.generator.set_state(torch.as_tensor(arrays["generator"]))
        self.data_generator.set_state(
            torch.as_tensor(arrays["data_generator"]))
        self._pos = len(self.train_dataset)

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------

    def _position_learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """The position group's rate after `count` updates."""
        cfg = self.config
        return exponential_decay_lr(
            cfg.position_learning_rate,
            cfg.position_learning_rate_decay_rate,
            cfg.position_learning_rate_decay_interval, count)

    def step(self, image_gt: torch.Tensor, q: torch.Tensor, t: torch.Tensor,
             sh_band: int, camera_info: CameraInfo,
             mark=_no_mark) -> StepOutput:
        """One optimizer step on one view (all tensors on the trainer's
        device), in the span `step`; updates the scene, both Adam states
        and the controller statistics. `mark(stage)` is called after each
        stage (those of `rasterize_with_vjp`, "loss" and "adam"), a timing
        hook; each stage is a span of that name."""
        with span("step"):
            out = self.train_step.single_view(
                self.scene, self.opt_features, self.opt_positions,
                self.ctrl_state, image_gt, q, t, sh_band, camera_info,
                self._set_state, mark)
        return StepOutput(*out)

    def _set_state(self, new):
        """The training state after a step's update (`step.Updated`)."""
        (self.scene, self.opt_features, self.opt_positions,
         self.ctrl_state) = new[:4]

    def batch_step(self, images: torch.Tensor, qs: torch.Tensor,
                   ts: torch.Tensor, intrinsics, sh_band: int,
                   camera_info: CameraInfo, mark=_no_mark) -> StepOutput:
        """One optimizer step on B views (images (B, H, W, 3), qs (B, 1, 4),
        ts (B, 1, 3), intrinsics (B, 3, 3), the same on every rank), this
        rank taking its block of them (`parallel/sharding.py`), in the
        span `step`."""
        key = (camera_info.camera_height, camera_info.camera_width)
        if key not in self._batch_steps:
            self._batch_steps[key] = make_data_parallel_train_step(
                self.mesh, camera_info, self.train_step)
        with span("step"):
            (self.scene, self.opt_features, self.opt_positions,
             self.ctrl_state, metrics, densify_inputs,
             maps) = self._batch_steps[key](
                self.scene, self.opt_features, self.opt_positions,
                self.ctrl_state, images, qs, ts, intrinsics, sh_band,
                mark=mark)
        return StepOutput(metrics, densify_inputs, maps)

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

    def _next_views(self, cache, stream, factor, count):
        """(images (B, H, W, 3), qs (B, 1, 4), ts (B, 1, 3) on the device,
        intrinsics (B, 3, 3) numpy, camera) of the next `count` training
        views. From the device cache they are the next entries of the
        epoch's permutation, wrapping within it when `count` runs past its
        end; the next step after that draws a new permutation."""
        if cache is not None:
            cam, images, qs, ts, intrs = cache
            num_views = images.shape[0]
            if self._pos >= num_views:
                self._perm = torch.randperm(num_views,
                                            generator=self.data_generator)
                self._pos = 0
            idxs = self._perm[(self._pos + torch.arange(count)) % num_views]
            self._pos += count
            dev_idxs = idxs.to(images.device)
            return (_cache_image_to_float(images[dev_idxs]), qs[dev_idxs],
                    ts[dev_idxs], intrs[idxs.numpy()], cam)
        items = [_downsample_item(next(stream), factor) for _ in range(count)]
        cam = items[-1].camera_info
        if any((it.camera_info.camera_height, it.camera_info.camera_width)
               != (cam.camera_height, cam.camera_width) for it in items):
            raise ValueError("batch_size > 1 needs training images of one "
                             "shape")

        def stack(arrays):
            return torch.as_tensor(np.stack(arrays), device=self.device)

        return (stack([it.image for it in items]),
                stack([it.q_pointcloud_camera for it in items]),
                stack([it.t_pointcloud_camera for it in items]),
                np.stack([np.asarray(it.camera_info.camera_intrinsics,
                                     np.float32) for it in items]), cam)

    def train(self):
        config = self.config
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
        window = (TraceWindow(config.summary_writer_log_dir,
                              config.profiler_start_iteration,
                              config.profiler_num_steps, self.device,
                              self.mesh.rank)
                  if config.enable_profiler else None)
        progress = range(start, config.num_iterations)
        if self.is_main:
            try:
                from tqdm import tqdm
                progress = tqdm(progress, initial=start,
                                total=config.num_iterations)
            except ImportError:
                pass
        last_time = time.perf_counter()
        try:
            for iteration in progress:
                if window is not None:
                    window.begin(iteration)
                if (iteration % config.half_downsample_factor_interval == 0
                        and iteration > 0 and downsample_factor > 1):
                    downsample_factor //= 2
                if (config.cache_dataset_on_device
                        and cache_factor != downsample_factor):
                    cache = self._device_cache(self.train_dataset,
                                               downsample_factor)
                    cache_factor = downsample_factor
                    self._pos = len(self.train_dataset)  # a new permutation
                if cache is None and stream is None:
                    loader = PrefetchLoader(self.train_dataset, shuffle=True,
                                            num_workers=4, seed=config.seed)
                    stream = iter(loader)
                images, qs, ts, intrs, cam = self._next_views(
                    cache, stream, downsample_factor, config.batch_size)
                out = self.train_iteration(iteration, images, qs, ts, intrs,
                                           cam)
                if not self.is_main:
                    continue

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
                                    images[-1])
                if validation_due:
                    self.validation(iteration)
            if window is not None:     # the last validation is not traced
                window.close()
            if self.is_main:
                self.validation(config.num_iterations,
                                completed=config.num_iterations)
        finally:
            if window is not None:
                window.close()
            if hasattr(progress, "close"):
                progress.close()
            if loader is not None:
                loader.close()

    def train_iteration(self, iteration: int, images: torch.Tensor,
                        qs: torch.Tensor, ts: torch.Tensor, intrs, cam,
                        mark=_no_mark) -> StepOutput:
        """Iteration `iteration` of the schedule on its views, as
        `_next_views` gives them: the step at the curriculum's SH band
        (single-view, or `batch_step` with `batch_size` > 1), then, where
        due, a densify round in the span `densify` seeded from the
        positions before the step's optimizer update, and an alpha reset in
        the span `reset alpha`. `mark` as in `step`, called also at the end
        of each of these spans and of the round's own."""
        config = self.config
        ctrl_cfg = config.adaptive_controller_config
        sh_band = iteration // config.increase_color_max_sh_band_interval
        after_warm_up = iteration >= ctrl_cfg.num_iterations_warm_up
        densify_due = (after_warm_up
                       and iteration % ctrl_cfg.num_iterations_densify == 0)
        # a copy: densify seeds new points from the positions before this
        # step's optimizer update
        pos_before = (self.scene.point_cloud.clone() if densify_due
                      else None)
        if config.batch_size == 1:
            out = self.step(images[0], qs[0], ts[0], sh_band,
                            dataclasses.replace(cam,
                                                camera_intrinsics=intrs[0]),
                            mark=mark)
        else:
            out = self.batch_step(images, qs, ts, intrs, sh_band, cam,
                                  mark=mark)
        if densify_due:
            with span("densify", mark):
                out = out._replace(densify_counts=self._densify(
                    iteration, out, pos_before, cam, mark))
        if (after_warm_up
                and iteration % ctrl_cfg.num_iterations_reset_alpha == 0):
            with span("reset alpha", mark):
                self.scene = reset_alpha(self.scene, ctrl_cfg)
        return out

    def _densify(self, iteration, out, pos_before, cam, mark=_no_mark):
        ctrl_cfg = self.config.adaptive_controller_config
        stats, in_frustum, point_depth, point_uv = out.densify_inputs
        self._log_histograms(iteration, stats)
        self.scene, self.ctrl_state, counts = densify_step(
            self.scene, self.ctrl_state, stats, in_frustum, point_depth,
            pos_before, iteration, self.generator, ctrl_cfg, mark)
        with span("densify/log", mark):
            count_round(counts)
            if (self.logger.tb is not None
                    and iteration % ctrl_cfg.plot_densify_interval == 0):
                from ..utils.visualization import densify_scatter_figure
                img = densify_scatter_figure(
                    point_uv.cpu().numpy(),
                    counts.floater_mask.cpu().numpy(),
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
                "densify/num_over_reconstructed":
                    counts.num_over_reconstructed,
                "value/num_valid_points": counts.num_valid_after,
            })
        return counts

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
        """[pred | gt | depth | points per pixel | error] panel of the
        step's (last) view."""
        from ..utils.visualization import (easy_cmap, make_image_grid,
                                           normalized_gray)
        pred, depth, count = (x.cpu().numpy() for x in out.maps)
        gt = image_gt.cpu().numpy()
        panel = make_image_grid([pred, gt, easy_cmap(depth),
                                 normalized_gray(count), np.abs(pred - gt)],
                                nrow=2)
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
                loss, _, ld_ssim = image_loss(
                    img, gt, self.loss_fn.config.lambda_value)[:3]
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
