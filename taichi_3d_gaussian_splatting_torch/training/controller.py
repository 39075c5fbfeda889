"""Adaptive density controller on torch tensors.

The scene is a fixed-capacity pool: pruning marks slots invalid, and
densification writes new points into invalid slots. Each step accumulates
per-point statistics (`update_stats`); every `num_iterations_densify` steps
after warm-up, `densify_step` prunes transparent points and floaters,
chooses candidates by their view-space gradients, and fills invalid slots
with split or cloned copies, seeded from the trigger step's positions
before the optimizer step; every `num_iterations_reset_alpha` steps,
`reset_alpha` clamps the alpha logits from above.

The masks and counts are exact functions of their inputs; the split
positions are drawn from an explicit `torch.Generator`.

A round's stages are spans under the trainer's `densify` span
(`utils/profiling.py`): `densify/masks` (removal and candidate masks),
`densify/assign` (free slots to candidates by rank, with the host read of
the candidate count) and `densify/fill` (the gathers, the split shrink,
the split draws and the clone nudge, the counts). `round_counts` adds up
what the rounds did, once a round and on the device (`count_round`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.scene import GaussianPointCloudScene
from ..ops import gaussian as G
from ..ops.rasterizer import BackwardStats
from ..utils.profiling import _no_mark, span

# what the trainer's densify rounds did since reset_round_counts(): rounds,
# slots filled, points pruned (transparent and floaters), filled slots that
# are splits and that are clones; all but `rounds` are 0-d device tensors
# once a round has counted
round_counts = {"rounds": 0, "points_added": 0, "points_pruned": 0,
                "splits": 0, "clones": 0}


def reset_round_counts():
    for name in round_counts:
        round_counts[name] = 0


@dataclasses.dataclass
class AdaptiveControllerConfig:
    num_iterations_warm_up: int = 500
    num_iterations_densify: int = 100
    transparent_alpha_threshold: float = -0.5
    densification_view_space_position_gradients_threshold: float = 6e-6
    densification_view_avg_space_position_gradients_threshold: float = 1e3
    densification_multi_frame_view_space_position_gradients_threshold: float = 1e3
    densification_multi_frame_view_pixel_avg_space_position_gradients_threshold: float = 1e3
    densification_multi_frame_position_gradients_threshold: float = 1e3
    gaussian_split_factor_phi: float = 1.6
    num_iterations_reset_alpha: int = 3000
    reset_alpha_value: float = 0.1
    floater_num_pixels_threshold: int = 10000
    floater_near_camrea_num_pixels_threshold: int = 10000  # sic: YAML key
    floater_depth_threshold: float = 100.0
    iteration_start_remove_floater: int = 2000
    plot_densify_interval: int = 200
    under_reconstructed_num_pixels_threshold: int = 512
    under_reconstructed_move_factor: float = 100.0
    enable_ellipsoid_offset: bool = False
    enable_sample_from_point: bool = True


class ControllerState(NamedTuple):
    """Per-point accumulators."""
    accumulated_num_pixels: torch.Tensor           # (N,) int32
    accumulated_num_in_camera: torch.Tensor        # (N,) int32
    accumulated_view_space_grad: torch.Tensor      # (N,) f32
    accumulated_view_space_grad_avg: torch.Tensor  # (N,) f32
    accumulated_position_grad: torch.Tensor        # (N, 3) f32
    accumulated_position_grad_norm: torch.Tensor   # (N,) f32

    @staticmethod
    def zeros(n: int, device="cuda") -> "ControllerState":
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)
        return ControllerState(
            z((n,), torch.int32), z((n,), torch.int32),
            z((n,), torch.float32), z((n,), torch.float32),
            z((n, 3), torch.float32), z((n,), torch.float32))

    @staticmethod
    def from_numpy(arrays, device="cuda") -> "ControllerState":
        """From six array-likes in field order (e.g. the fields of the JAX
        package's ControllerState)."""
        dtypes = (np.int32, np.int32, np.float32, np.float32, np.float32,
                  np.float32)
        return ControllerState(*(torch.tensor(np.asarray(x, d), device=device)
                                 for x, d in zip(arrays, dtypes)))


class DensifyCounts(NamedTuple):
    """What one densify round did, and the per-point masks behind it."""
    num_transparent: torch.Tensor
    num_floaters: torch.Tensor
    num_candidates: torch.Tensor
    num_fillable: torch.Tensor
    num_over_reconstructed: torch.Tensor
    num_valid_after: torch.Tensor
    floater_mask: Optional[torch.Tensor] = None             # (N,) bool
    over_reconstructed_mask: Optional[torch.Tensor] = None  # (N,) bool
    under_reconstructed_mask: Optional[torch.Tensor] = None  # (N,) bool


def update_stats(state: ControllerState, stats: BackwardStats,
                 grad_pointcloud: torch.Tensor,
                 in_frustum: torch.Tensor) -> ControllerState:
    """Add one step's statistics, for in-frustum points only."""
    seen = in_frustum.to(torch.int32)
    seen_f = in_frustum.to(torch.float32)
    npix = stats.num_affected_pixels
    mag = stats.magnitude_grad_viewspace * seen_f
    avg = torch.where(npix > 0, mag / npix.to(torch.float32),
                      torch.zeros_like(mag))
    gpos = grad_pointcloud * seen_f[:, None]
    return ControllerState(
        accumulated_num_pixels=state.accumulated_num_pixels + npix * seen,
        accumulated_num_in_camera=state.accumulated_num_in_camera + seen,
        accumulated_view_space_grad=state.accumulated_view_space_grad + mag,
        accumulated_view_space_grad_avg=(state.accumulated_view_space_grad_avg
                                         + avg),
        accumulated_position_grad=state.accumulated_position_grad + gpos,
        accumulated_position_grad_norm=(
            state.accumulated_position_grad_norm
            + torch.linalg.norm(gpos, dim=1)),
    )


def _rank_assignment(dst_mask, src_mask):
    """For each destination slot (dst_mask) the index of the source with
    the same rank among the sources, or -1: the k-th free slot takes the
    k-th candidate."""
    n = dst_mask.shape[0]
    src_idx = torch.nonzero(src_mask).flatten()
    dst_rank = torch.cumsum(dst_mask.to(torch.int64), 0) - 1
    take = dst_mask & (dst_rank < src_idx.shape[0])
    out = torch.full((n,), -1, dtype=torch.int64, device=dst_mask.device)
    out[take] = src_idx[dst_rank[take]]
    return out


def densify_step(
    scene: GaussianPointCloudScene,
    state: ControllerState,
    stats: BackwardStats,
    in_frustum: torch.Tensor,        # (N,) of the trigger step
    point_depth: torch.Tensor,       # (N,) camera depth of the trigger step
    position_before_optimizer: torch.Tensor,  # (N, 3)
    iteration: int,
    generator: Optional[torch.Generator],
    config: AdaptiveControllerConfig,
    mark=_no_mark,
) -> Tuple[GaussianPointCloudScene, ControllerState, DensifyCounts]:
    """One prune + densify round; returns the new scene, zeroed
    accumulators and the counts. Pure: the inputs are not modified.
    `mark(stage)` is called at the end of each of the round's spans."""
    n = scene.capacity
    pc = scene.point_cloud
    feats = scene.point_cloud_features
    invalid = scene.point_invalid_mask
    valid = invalid == 0
    zero = torch.zeros((), dtype=torch.float32, device=pc.device)

    npix_frame = stats.num_affected_pixels
    mag_frame = stats.magnitude_grad_viewspace

    with span("densify/masks", mark):
        # ---- removal masks ----
        floater_mask = (in_frustum
                        & (npix_frame
                           > config.floater_near_camrea_num_pixels_threshold)
                        & (point_depth < config.floater_depth_threshold)
                        & valid)
        floater_mask &= iteration > config.iteration_start_remove_floater
        alpha = feats[:, 7]
        nan_mask = torch.isnan(feats).any(dim=1)
        transparent_mask = (((alpha < config.transparent_alpha_threshold)
                             | nan_mask) & valid & ~floater_mask)
        remove_mask = floater_mask | transparent_mask

        # ---- densify candidates ----
        npix_f = npix_frame.to(torch.float32)
        single_frame = (mag_frame > config
                        .densification_view_space_position_gradients_threshold)
        single_frame |= torch.where(
            npix_f > 0, mag_frame / torch.clamp(npix_f, min=1.0), zero
        ) > config.densification_view_avg_space_position_gradients_threshold
        single_frame &= in_frustum & ~remove_mask

        seen = state.accumulated_num_in_camera.to(torch.float32)
        safe_seen = torch.clamp(seen, min=1.0)
        multi_view = torch.where(
            seen > 0, state.accumulated_view_space_grad / safe_seen, zero)
        multi_frame = multi_view > (
            config.densification_multi_frame_view_space_position_gradients_threshold)
        avg_pixels = torch.where(seen > 0, state.accumulated_num_pixels.to(
            torch.float32) / safe_seen, zero)
        multi_avg = torch.where(
            seen > 0, state.accumulated_view_space_grad_avg / safe_seen, zero)
        multi_frame |= torch.where(
            avg_pixels > 0, multi_avg / torch.clamp(avg_pixels, min=1e-12),
            zero
        ) > (config.
             densification_multi_frame_view_pixel_avg_space_position_gradients_threshold)
        multi_frame |= torch.where(
            seen > 0, state.accumulated_position_grad_norm / safe_seen, zero
        ) > config.densification_multi_frame_position_gradients_threshold

        densify_mask = (single_frame | multi_frame) & ~remove_mask & valid
        grad_position = torch.where(
            seen[:, None] > 0,
            state.accumulated_position_grad / safe_seen[:, None], zero)
        over_reconstructed = (
            state.accumulated_num_pixels
            > config.under_reconstructed_num_pixels_threshold)
        size_reduction = torch.where(
            densify_mask & over_reconstructed, torch.full_like(
                alpha, math.log(config.gaussian_split_factor_phi)), zero)

    with span("densify/assign", mark):
        # ---- removals, then candidates into the free slots by rank ----
        invalid = torch.where(remove_mask, torch.ones_like(invalid), invalid)
        src_for_dst = _rank_assignment(invalid == 1, densify_mask)
        filled = src_for_dst >= 0
        src = torch.clamp(src_for_dst, min=0)
        # the candidates that got a slot (there may be fewer slots)
        fillable_src_mask = torch.zeros((n,), dtype=torch.bool,
                                        device=pc.device)
        fillable_src_mask[src[filled]] = True

    with span("densify/fill", mark):
        # a new point starts from its source's position before the optimizer
        new_pc = torch.where(filled[:, None],
                             position_before_optimizer[src], pc)
        new_feats = torch.where(filled[:, None], feats[src], feats)
        new_obj = torch.where(filled, scene.point_object_id[src],
                              scene.point_object_id)

        # split: both copies shrink (only candidates that got a slot)
        red_src = size_reduction[src]
        new_feats = new_feats.clone()
        new_feats[:, 4:7] -= torch.where(filled, red_src, zero)[:, None]
        new_feats[:, 4:7] -= torch.where(fillable_src_mask, size_reduction,
                                         zero)[:, None]

        split_dst = filled & (red_src > 1e-6)
        clone_dst = filled & (red_src <= 1e-6)
        if config.enable_sample_from_point:
            # split: resample both copies from the shrunken gaussian, each
            # with its own draw; the new copy around its source's current
            # position, the original around its own
            dst_samples = G.sample_from_gaussian(
                pc[src], new_feats[:, 0:4], new_feats[:, 4:7], generator)
            new_pc = torch.where(split_dst[:, None], dst_samples, new_pc)
            split_src = fillable_src_mask & (size_reduction > 1e-6)
            src_samples = G.sample_from_gaussian(
                new_pc, new_feats[:, 0:4], new_feats[:, 4:7], generator)
            new_pc = torch.where(split_src[:, None], src_samples, new_pc)
            # clone: nudge the new copy along the accumulated gradient
            new_pc = new_pc + torch.where(
                clone_dst[:, None],
                grad_position[src] * config.under_reconstructed_move_factor,
                zero)

        if config.enable_ellipsoid_offset:
            offset = G.ellipsoid_foci_vector(new_feats[:, 0:4],
                                             new_feats[:, 4:7])
            new_pc = new_pc + torch.where(filled[:, None], offset, zero)
            new_pc = new_pc - torch.where(fillable_src_mask[:, None],
                                          offset, zero)

        invalid = torch.where(filled, torch.zeros_like(invalid), invalid)

        def count(mask):
            return mask.to(torch.int32).sum(dtype=torch.int32)

        counts = DensifyCounts(
            num_transparent=count(transparent_mask),
            num_floaters=count(floater_mask),
            num_candidates=count(densify_mask),
            num_fillable=count(filled),
            num_over_reconstructed=count(split_dst),
            num_valid_after=count(invalid == 0),
            floater_mask=floater_mask,
            over_reconstructed_mask=densify_mask & over_reconstructed,
            under_reconstructed_mask=densify_mask & ~over_reconstructed,
        )
    new_scene = GaussianPointCloudScene(
        point_cloud=new_pc, point_cloud_features=new_feats,
        point_invalid_mask=invalid, point_object_id=new_obj)
    return new_scene, ControllerState.zeros(n, pc.device), counts


def count_round(counts: DensifyCounts):
    """Add a round's counts to `round_counts`, on the counts' device: no
    host read (a count becomes a 0-d tensor there; `int()` reads it)."""
    added = counts.num_fillable
    round_counts["rounds"] += 1
    round_counts["points_added"] += added
    round_counts["points_pruned"] += (counts.num_transparent
                                      + counts.num_floaters)
    round_counts["splits"] += counts.num_over_reconstructed
    round_counts["clones"] += added - counts.num_over_reconstructed


def reset_alpha(scene: GaussianPointCloudScene,
                config: AdaptiveControllerConfig) -> GaussianPointCloudScene:
    """Clamp the alpha logits from above at `reset_alpha_value`."""
    feats = scene.point_cloud_features.clone()
    feats[:, 7] = torch.clamp(feats[:, 7], max=config.reset_alpha_value)
    return scene._replace(point_cloud_features=feats)
