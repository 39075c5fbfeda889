"""One training step, as the trainer's single-view step and the batch step
(`parallel/sharding.py`) both take it.

A step on one view (`view_gradients`):
- render the stored features with `rasterize_with_vjp` (projection,
  binning, the forward blend kernel); the projection normalizes each
  quaternion where it reads it, so no step copies the features;
- L1 + SSIM on the image clipped to [0, 1] and their gradient with
  respect to the render, `training/loss_cuda.py::image_loss` (one kernel
  on the card), plus the scale regularizer by autograd when it is on;
- the backward blend kernel, per-point routing and autograd through the
  projection (`vjp_fn`); the rasterizer-path feature gradients are scaled
  per group (`grad_group_scale`) and masked to the active SH bands, and
  the regularizer's gradient is added unscaled.

The update that ends every step (`TrainStep.update`, in the span `adam`):
non-finite gradient rows are zeroed, and a non-finite loss skips the whole
update (Adam moments and controller statistics included); two Adam chains:
features at the features group's rate, positions at the positions group's
scheduled rate. The stored quaternions are normalized there, and Adam
takes q / |q| with the gradient with respect to it. The scaling and
masking, the normalization, the containment, both chains and the loss
guard are one call, `training/adam_cuda.py::optimizer_update` (one kernel
on the card).

The single-view step hands that call the raw rasterizer-path gradient with
its group scale and band mask, so that the kernel combines them in its one
pass; the batch step combines each view's gradient and adds it into its
running sums first (`accumulate_view_gradients`, one kernel a view on the
card).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.scene import GaussianPointCloudScene
from ..ops.rasterizer import (BackwardStats, RasterizeResult,
                              RasterizerConfig, _no_mark, rasterize_with_vjp)
from ..ops.sh import feature_sh_band_mask
from ..utils.profiling import span
from .adam import AdamState
from .adam_cuda import combine_feature_gradients, keep_if_ok, optimizer_update
from .controller import ControllerState, update_stats
from .loss_cuda import image_loss
from .ssim import psnr as psnr_fn


def grad_group_scale(config: RasterizerConfig) -> np.ndarray:
    """(56,) per-feature scale of the rasterizer-path gradients."""
    scale = np.full((56,), config.grad_high_order_color_factor, np.float32)
    scale[0:4] = config.grad_q_factor
    scale[4:7] = config.grad_s_factor
    scale[7] = config.grad_alpha_factor
    scale[8] = config.grad_color_factor
    scale[24] = config.grad_color_factor
    scale[40] = config.grad_color_factor
    return scale


class ViewGradients(NamedTuple):
    """One view's loss and raw gradients (`view_gradients`)."""
    loss: torch.Tensor           # () detached
    l1: torch.Tensor
    ssim_loss: torch.Tensor
    image: torch.Tensor          # the clipped render (H, W, 3)
    grad_pc: torch.Tensor        # (N, 3)
    grad_feats_raster: torch.Tensor  # (N, 56), the rasterizer path's
    # (N, 56), the loss's own (the regularizer's); None when the loss does
    # not read the features
    grad_feats_direct: Optional[torch.Tensor]
    grad_scale: torch.Tensor     # (56,) per-group scale of the raster path
    band_mask: torch.Tensor      # (56,) the active SH bands
    stats: BackwardStats
    result: RasterizeResult      # no autograd graph

    @property
    def grad_feats(self) -> torch.Tensor:
        """(N, 56): the rasterizer path's gradients scaled and band-masked,
        plus the loss's own."""
        return combine_feature_gradients(
            self.grad_feats_raster, self.grad_scale, self.band_mask,
            self.grad_feats_direct)


def view_gradients(scene, image_gt, q, t, camera_info, raster_config,
                   loss_fn, grad_scale, band_mask,
                   mark=_no_mark) -> ViewGradients:
    """Render one view of `scene` with its stored features, take the loss
    on the image clipped to [0, 1] and its gradient with respect to the
    render (`image_loss`) and, by autograd, the regularizer's with respect
    to the features when it is on, then the rasterizer's VJP. The
    quaternion's gradients are with respect to the stored quaternion with
    its norm held constant. The rasterizer-path feature gradients are
    scaled per group and masked to the active SH bands; the regularizer's
    are added unscaled."""
    result, vjp_fn = rasterize_with_vjp(*scene, q, t, camera_info,
                                        raster_config, mark=mark)
    with span("loss", mark):
        terms = image_loss(result.image, image_gt,
                           loss_fn.config.lambda_value)
        loss, g_feats_direct = terms.loss, None
        if loss_fn.config.enable_regularization:
            feats_leaf = scene.point_cloud_features.detach().requires_grad_(
                True)
            with torch.enable_grad():
                reg = loss_fn.regularization_term(scene.point_invalid_mask,
                                                  feats_leaf)
                g_feats_direct, = torch.autograd.grad(reg, feats_leaf)
            loss = loss + reg.detach()

    grad_pc, grad_feats_raster, stats = vjp_fn(terms.grad)
    return ViewGradients(loss, terms.l1, terms.ssim_loss, terms.image,
                         grad_pc, grad_feats_raster, g_feats_direct,
                         grad_scale, band_mask, stats, result)


class Updated(NamedTuple):
    """The training state after a step's update (as it was where the loss
    was not finite), the loss guard (0-d bool) and the number of slots
    whose gradient rows were zeroed (0-d int32)."""
    scene: GaussianPointCloudScene
    opt_features: AdamState
    opt_positions: AdamState
    ctrl_state: ControllerState
    loss_ok: torch.Tensor
    nonfinite_grad_rows: torch.Tensor


class TrainStep:
    """What every training step holds fixed: the rasterizer config, the
    loss, both Adam groups (`training.adam.AdamGroup`), and one cache of
    the step's per-device constants, the group scale and the band mask,
    keyed by (device, SH band): a copy to the card waits for the card, so
    each is made there once."""

    def __init__(self, raster_config: RasterizerConfig, loss_fn, features,
                 positions):
        self.raster_config = raster_config
        self.loss_fn = loss_fn
        self.features = features
        self.positions = positions
        self._scale = grad_group_scale(raster_config)
        self._constants = {}

    def constants(self, device, sh_band: int):
        """(group scale, band mask), both (56,) on `device`."""
        key = (str(device), int(sh_band))
        if key not in self._constants:
            self._constants[key] = (
                torch.as_tensor(self._scale, device=device),
                feature_sh_band_mask(sh_band, device=device))
        return self._constants[key]

    def update(self, scene, opt_features, opt_positions, ctrl_state,
               grad_feats, grad_pc, loss,
               with_stats: Callable[[torch.Tensor], ControllerState],
               grad_scale=None, band_mask=None,
               grad_feats_direct=None) -> Updated:
        """The update that ends a step (its caller's span `adam`): the loss
        guard, `optimizer_update` of both groups from the scene's stored
        features and positions, and the controller state `with_stats(the
        contained position gradient)` kept only where `loss` is finite.
        `grad_scale`, `band_mask` and `grad_feats_direct` as
        `optimizer_update` takes them."""
        loss_ok = torch.isfinite(loss)
        up = optimizer_update(
            scene.point_cloud_features, grad_feats, scene.point_cloud,
            grad_pc, opt_features, opt_positions, self.features,
            self.positions, loss_ok, grad_scale, band_mask, grad_feats_direct)
        scene = scene._replace(point_cloud=up.pc,
                               point_cloud_features=up.feats)
        ctrl = keep_if_ok(loss_ok, with_stats(up.grad_pc), ctrl_state)
        return Updated(scene, up.opt_features, up.opt_positions, ctrl,
                       loss_ok, up.nonfinite_grad_rows)

    def single_view(self, scene, opt_features, opt_positions, ctrl_state,
                    image_gt, q, t, sh_band: int, camera_info, on_update,
                    mark=_no_mark):
        """One optimizer step on one view (all tensors on one device).
        `on_update(new)` takes the state after the update (`Updated`)
        inside the span `adam`, so that its mark sees that state. Returns
        (metrics, densify_inputs, maps): the metrics 0-d tensors on the
        device, densify_inputs (stats, in_frustum, point_depth, point_uv)
        and maps (clipped render, depth, valid point count) of the view.
        `mark(stage)` is called after each stage (those of
        `rasterize_with_vjp`, "loss" and "adam"); each stage is a span of
        that name."""
        scale, band_mask = self.constants(scene.device, sh_band)
        view = view_gradients(scene, image_gt, q, t, camera_info,
                              self.raster_config, self.loss_fn, scale,
                              band_mask, mark)
        aux = view.result.aux
        with span("adam", mark):
            new = self.update(
                scene, opt_features, opt_positions, ctrl_state,
                view.grad_feats_raster, view.grad_pc, view.loss,
                lambda grad_pc: update_stats(ctrl_state, view.stats, grad_pc,
                                             aux.in_frustum),
                scale, band_mask, view.grad_feats_direct)
            on_update(new)
        metrics = {
            "loss": view.loss, "l1": view.l1, "ssim_loss": view.ssim_loss,
            "psnr": psnr_fn(view.image, image_gt),
            "ssim": 1.0 - view.ssim_loss,
            "total_keys": aux.total_keys,
            "nonfinite_points": aux.nonfinite_points,
            "nonfinite_grad_rows": new.nonfinite_grad_rows,
            "skipped_nonfinite_step": (~new.loss_ok).to(torch.int32),
        }
        return (metrics,
                (view.stats, aux.in_frustum, aux.point_depth, aux.point_uv),
                (view.image, view.result.depth,
                 view.result.pixel_valid_point_count))
