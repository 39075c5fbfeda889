"""Plain density-control round and alpha reset, and the numbers that
compare a round of the program with this one.

Written from the port's controller (`training/controller.py`
`densify_step`, `reset_alpha`, and the schedule of `training/trainer.py`)
and from the adaptive density control of 3D Gaussian Splatting (Kerbl et
al. 2023, section 5), in float32 with torch alone: nothing of the port.

A round at iteration i, on a pool of N slots (positions (N, 3), features
(N, 56), an invalid flag (N,), object ids (N,)), from the six accumulators
since the last round and the trigger step's own statistics (the pixels a
point touched, its view-space gradient magnitude, whether it was in the
frustum, its camera depth):
- prune: floaters (in the frustum, more than
  `floater_near_camrea_num_pixels_threshold` pixels, nearer than
  `floater_depth_threshold`, once i passes
  `iteration_start_remove_floater`) and, of the other valid points, those
  whose alpha logit is under `transparent_alpha_threshold` or whose row
  holds a NaN;
- candidates: the valid points not pruned whose trigger-step magnitude, or
  magnitude a pixel, passes its threshold (in the frustum), or whose mean
  magnitude a view, mean magnitude a pixel a view, or mean
  position-gradient norm a view does;
- assignment: the k-th free slot (pruned ones included) by index takes the
  k-th candidate by index; candidates beyond the free slots wait;
- fill: a filled slot copies its source's features and object id and takes
  its source's position before the trigger step's optimizer update. A
  source with more than `under_reconstructed_num_pixels_threshold`
  accumulated pixels splits: both copies' log-scales shrink by log(phi),
  and both are drawn anew from the shrunken Gaussian, the copy around the
  source's position and then the source around its own, one standard
  normal triple a slot for every slot of the pool, in slot order, from the
  generator it is given. Otherwise the copy is a clone, moved by the mean
  position gradient a view times `under_reconstructed_move_factor`;
- the accumulators start again from zero.
The alpha reset clamps every alpha logit from above at
`reset_alpha_value`. A round is due at iterations i >= the warm-up that
`num_iterations_densify` divides, a reset where `num_iterations_reset_alpha`
does.

Departures from the published method, each the port's (and the JAX
package's):
- a filled slot keeps the Adam moments its slot had: they are not reset;
- the pool is fixed: new points go into free slots by rank, and the
  candidates beyond them wait for a later round;
- a split keeps the source in its slot, drawn anew, where the paper
  replaces it by two new points;
- a point splits by its accumulated pixel count, not by its scale against
  a share of the scene's extent;
- a clone moves along the mean position gradient, where the paper's stays
  at its source;
- floaters, by the trigger step's footprint and depth, are pruned too;
- the reset clamps the alpha logit, where the paper sets opacity to 0.01;
- a draw's rotation is that of the stored quaternion as it stands (each
  step stores it normalized).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# the keys of a configuration's `controller` block that a round reads
KEYS = ("num_iterations_warm_up", "num_iterations_densify",
        "num_iterations_reset_alpha", "reset_alpha_value",
        "transparent_alpha_threshold",
        "densification_view_space_position_gradients_threshold",
        "densification_view_avg_space_position_gradients_threshold",
        "densification_multi_frame_view_space_position_gradients_threshold",
        "densification_multi_frame_view_pixel_avg_space_position_gradients_threshold",
        "densification_multi_frame_position_gradients_threshold",
        "gaussian_split_factor_phi", "floater_near_camrea_num_pixels_threshold",
        "floater_depth_threshold", "iteration_start_remove_floater",
        "under_reconstructed_num_pixels_threshold",
        "under_reconstructed_move_factor", "enable_sample_from_point",
        "enable_ellipsoid_offset")
# the six counts of a round, in the port's order and under its names
COUNTS = ("num_transparent", "num_floaters", "num_candidates",
          "num_fillable", "num_over_reconstructed", "num_valid_after")
# a share of a feature row
FEATURE_LEAVES = {"rotation": [0, 1, 2, 3], "scale": [4, 5, 6],
                  "opacity": [7], "colour_dc": [8, 24, 40],
                  "colour_rest": [i for i in range(8, 56)
                                  if i not in (8, 24, 40)]}


class Pool(NamedTuple):
    pc: torch.Tensor       # (N, 3)
    feats: torch.Tensor    # (N, 56)
    invalid: torch.Tensor  # (N,) int8, 1 = free slot
    obj: torch.Tensor      # (N,) int32


class Trigger(NamedTuple):
    """The trigger step's statistics and the positions before its
    optimizer update."""
    num_pixels: torch.Tensor   # (N,) int32
    magnitude: torch.Tensor    # (N,) view-space gradient magnitude
    in_frustum: torch.Tensor   # (N,) bool
    depth: torch.Tensor        # (N,)
    pc_before: torch.Tensor    # (N, 3)


class Round(NamedTuple):
    pool: Pool
    counts: dict      # COUNTS -> int
    written: torch.Tensor  # (N,) bool: the filled slots, the split sources
    origin: torch.Tensor   # (N, 3): where a written slot's draw or move
    #                        started (its source's position before the
    #                        optimizer for a filled slot, its own for a
    #                        split source)


def controller(block: dict) -> dict:
    """The round's settings from a configuration's `controller` block,
    which has to state every one of KEYS; the ellipsoid offset (off in
    config/tat_truck.yaml and by default) is refused."""
    missing = [k for k in KEYS if k not in block]
    if missing:
        raise KeyError("the controller block lacks " + ", ".join(missing))
    if block["enable_ellipsoid_offset"]:
        raise ValueError("the reference has no ellipsoid offset")
    return {k: block[k] for k in KEYS}


def due(iteration: int, c: dict):
    """(a round is due, an alpha reset is due) at `iteration`."""
    on = iteration >= c["num_iterations_warm_up"]
    return (on and iteration % c["num_iterations_densify"] == 0,
            on and iteration % c["num_iterations_reset_alpha"] == 0)


def _rotation(q):
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _draw(mean, feats, generator, dtype):
    """mean + R(q) (exp(log-scales) * z), z standard normal (N, 3) from
    the generator, drawn in float32 whatever `dtype`."""
    z = torch.randn(mean.shape, generator=generator, dtype=torch.float32,
                    device=mean.device).to(dtype)
    local = torch.exp(feats[:, 4:7]) * z
    return mean + (_rotation(feats[:, 0:4]) * local[:, None, :]).sum(-1)


def densify_round(pool: Pool, acc: tuple, trig: Trigger, iteration: int,
                  generator: torch.Generator, c: dict,
                  dtype=torch.float32) -> Round:
    """One round on `pool` from the accumulators `acc` (pixels, views in
    the camera, magnitude, magnitude a pixel, position gradient (N, 3),
    its norm) and the trigger step. `dtype` is the type of the round's
    arithmetic (the masks' quotients and tests, the shrink and the draws);
    the pool comes back in float32."""
    n = pool.pc.shape[0]
    dev = pool.pc.device
    f = pool.feats.to(dtype)
    valid = pool.invalid == 0
    npix = trig.num_pixels
    mag = trig.magnitude.to(dtype)

    floaters = (trig.in_frustum
                & (npix > c["floater_near_camrea_num_pixels_threshold"])
                & (trig.depth.to(dtype) < c["floater_depth_threshold"])
                & valid)
    if not iteration > c["iteration_start_remove_floater"]:
        floaters = torch.zeros_like(floaters)
    transparent = (((f[:, 7] < c["transparent_alpha_threshold"])
                    | torch.isnan(pool.feats).any(dim=1))
                   & valid & ~floaters)
    pruned = floaters | transparent

    npix_f = npix.to(dtype)
    per_pixel = torch.where(npix_f > 0, mag / torch.clamp(npix_f, min=1.0),
                            torch.zeros_like(mag))
    single = ((mag > c["densification_view_space_position_gradients_threshold"])
              | (per_pixel > c[
                  "densification_view_avg_space_position_gradients_threshold"]))
    single = single & trig.in_frustum & ~pruned

    acc_pix, acc_views, acc_mag, acc_mag_pixel, acc_grad, acc_norm = acc
    views = acc_views.to(dtype)
    seen = views > 0
    per_view = torch.clamp(views, min=1.0)
    zero = torch.zeros_like(views)
    mean_mag = torch.where(seen, acc_mag.to(dtype) / per_view, zero)
    mean_pix = torch.where(seen, acc_pix.to(dtype) / per_view, zero)
    mean_mag_pixel = torch.where(seen, acc_mag_pixel.to(dtype) / per_view,
                                 zero)
    pixel_rate = torch.where(mean_pix > 0, mean_mag_pixel / torch.clamp(
        mean_pix, min=1e-12), zero)
    mean_norm = torch.where(seen, acc_norm.to(dtype) / per_view, zero)
    multi = ((mean_mag > c[
        "densification_multi_frame_view_space_position_gradients_threshold"])
        | (pixel_rate > c["densification_multi_frame_view_pixel_avg_space"
                          "_position_gradients_threshold"])
        | (mean_norm > c[
            "densification_multi_frame_position_gradients_threshold"]))
    candidates = (single | multi) & ~pruned & valid
    shrink = torch.tensor(math.log(c["gaussian_split_factor_phi"]),
                          dtype=dtype, device=dev)
    # a factor phi of 1 shrinks nothing and splits nothing
    splits = (candidates & (acc_pix
                            > c["under_reconstructed_num_pixels_threshold"])
              & bool(shrink > 1e-6))
    mean_grad = torch.where(seen[:, None], acc_grad.to(dtype)
                            / per_view[:, None], torch.zeros_like(acc_grad,
                                                                  dtype=dtype))

    invalid = torch.where(pruned, torch.ones_like(pool.invalid),
                          pool.invalid)
    free = torch.nonzero(invalid == 1).flatten()
    wanting = torch.nonzero(candidates).flatten()
    m = min(free.shape[0], wanting.shape[0])
    dst, src = free[:m], wanting[:m]
    split_dst = splits[src]
    split_src = src[split_dst]

    pc = pool.pc.to(dtype).clone()
    feats = f.clone()
    obj = pool.obj.clone()
    pc[dst] = trig.pc_before.to(dtype)[src]
    feats[dst] = f[src]
    obj[dst] = pool.obj[src]
    feats[dst[split_dst], 4:7] -= shrink
    feats[split_src, 4:7] -= shrink
    origin = torch.zeros((n, 3), dtype=dtype, device=dev)
    origin[dst] = pc[dst]
    origin[split_src] = pc[split_src]
    if c["enable_sample_from_point"]:
        source_pc = torch.zeros_like(pc)
        source_pc[dst] = pool.pc.to(dtype)[src]
        drawn = _draw(source_pc, feats, generator, dtype)
        pc[dst[split_dst]] = drawn[dst[split_dst]]
        drawn = _draw(pc, feats, generator, dtype)
        pc[split_src] = drawn[split_src]
        clone_dst = dst[~split_dst]
        pc[clone_dst] = pc[clone_dst] + (
            mean_grad[src[~split_dst]] * c["under_reconstructed_move_factor"])
    invalid[dst] = 0
    written = torch.zeros(n, dtype=torch.bool, device=dev)
    written[dst] = True
    written[split_src] = True
    counts = dict(zip(COUNTS, (
        int(transparent.sum()), int(floaters.sum()), int(candidates.sum()),
        m, int(split_dst.sum()), int((invalid == 0).sum()))))
    return Round(Pool(pc.float(), feats.float(), invalid, obj), counts,
                 written, origin.float())


def reset_alpha(pool: Pool, c: dict) -> Pool:
    feats = pool.feats.clone()
    feats[:, 7] = torch.clamp(feats[:, 7], max=c["reset_alpha_value"])
    return pool._replace(feats=feats)


def _rel(p, r, scale):
    d = float(torch.linalg.norm((p - r).double()))
    return d / max(float(torch.linalg.norm(scale.double())), 1e-30)


def readings(prog_counts: dict, prog: Pool, ref: Round, ref_pool: Pool) -> dict:
    """The numbers of a round (and the reset after it, in `ref_pool`):
    - `count_gap`: the largest relative gap of the six counts;
    - `validity_gap`: the slots whose validity differs, over the valid
      slots after the reference's round;
    - `filled_gap`: over the slots the reference's round wrote, the worst
      of |p - r| / |r - origin| for the positions (the draw or move, not
      where it started) and |p - r| / |r| for each leaf of the features;
    - `pool_gap`: the worst of |p - r| / |r| over the whole pool for the
      positions and each leaf of the features (the reset's clamp and every
      slot the round should have left alone).
    """
    count_gap = max(abs(prog_counts[k] - ref.counts[k])
                    / max(ref.counts[k], 1) for k in COUNTS)
    differ = int(((prog.invalid == 0) != (ref_pool.invalid == 0)).sum())
    validity_gap = differ / max(ref.counts["num_valid_after"], 1)
    w = ref.written
    filled = [_rel(prog.pc[w], ref_pool.pc[w], ref_pool.pc[w] - ref.origin[w])]
    whole = [_rel(prog.pc, ref_pool.pc, ref_pool.pc)]
    for cols in FEATURE_LEAVES.values():
        r = ref_pool.feats[:, cols]
        p = prog.feats[:, cols]
        filled.append(_rel(p[w], r[w], r[w]))
        whole.append(_rel(p, r, r))
    return {"count_gap": count_gap, "validity_gap": validity_gap,
            "filled_gap": max(filled) if bool(w.any()) else 0.0,
            "pool_gap": max(whole)}
