"""The numbers that decide `correct`, each a gap between what the timed
path produced and what the plain reference produced from the same inputs.

Rendering: per checked frame the mean and the largest absolute difference
of the two images over pixels and channels, and of those the worst frame.

Training, over the first steps (the reference follows them from the same
start):
- `loss_gap`: the largest relative difference of a step's loss;
- `grad_gap`: the first step's gradient as the optimizer gets it, by the
  worst leaf: the gap between the two norms of a leaf, over the larger of
  the reference's norm of that leaf and of the median leaf;
- `change_gap`: the same of each leaf's change from the start to after the
  last checked step, leaving out a leaf whose reference gradient is under
  a thousandth of the median leaf's (Adam moves it by round-off alone);
- `stats_gap`: the same of the density controller's six accumulators
  after the last checked step.
The leaves are the positions and five groups of the features: rotation,
scales, opacity, the three DC colour coefficients, the other 45.
"""

from __future__ import annotations

import statistics
from typing import NamedTuple

import torch

FEATURE_LEAVES = {"rotation": [0, 1, 2, 3], "scale": [4, 5, 6],
                  "opacity": [7], "colour_dc": [8, 24, 40],
                  "colour_rest": [i for i in range(8, 56)
                                  if i not in (8, 24, 40)]}
NEGLIGIBLE_GRAD = 1e-3


class TrainSide(NamedTuple):
    """One side's readings of the checked steps."""
    losses: list          # floats, one a step
    grad_pc: torch.Tensor  # first step's gradients as the optimizer gets
    grad_feats: torch.Tensor
    start_pc: torch.Tensor
    start_feats: torch.Tensor
    end_pc: torch.Tensor   # after the last checked step
    end_feats: torch.Tensor
    stats: tuple           # the controller's six accumulators


def leaves(pc, feats) -> dict:
    out = {"positions": pc}
    for name, cols in FEATURE_LEAVES.items():
        out[name] = feats[:, cols]
    return out


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


def worst_gap(prog: dict, ref: dict, names=None):
    """(the largest | |p| - |r| | / max(|r|, median |r|) over the leaves
    `names` (default all), the leaf)."""
    names = list(ref) if names is None else list(names)
    p, r = _norms({k: prog[k] for k in names}), _norms(
        {k: ref[k] for k in names})
    med = statistics.median(r.values())
    gaps = {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_readings(prog: TrainSide, ref: TrainSide) -> dict:
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog.losses,
                                                       ref.losses))
    g_prog = leaves(prog.grad_pc, prog.grad_feats)
    g_ref = leaves(ref.grad_pc, ref.grad_feats)
    grad_gap, _ = worst_gap(g_prog, g_ref)
    ref_grad = _norms(g_ref)
    med = statistics.median(ref_grad.values())
    moving = [k for k, v in ref_grad.items() if v >= NEGLIGIBLE_GRAD * med]
    change_gap, _ = worst_gap(
        leaves(prog.end_pc - prog.start_pc, prog.end_feats - prog.start_feats),
        leaves(ref.end_pc - ref.start_pc, ref.end_feats - ref.start_feats),
        moving)
    names = ("num_pixels", "num_in_camera", "view_space_grad",
             "view_space_grad_avg", "position_grad", "position_grad_norm")
    stats_gap, _ = worst_gap(
        {k: v.float() for k, v in zip(names, prog.stats)},
        {k: v.float() for k, v in zip(names, ref.stats)})
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "stats_gap": stats_gap}


def image_readings(prog_images: list, ref_images: list) -> dict:
    """Worst frame's mean and largest absolute difference."""
    mean_abs = max_abs = 0.0
    for a, b in zip(prog_images, ref_images):
        d = (a.float() - b.float()).abs()
        mean_abs = max(mean_abs, float(d.double().mean()))
        max_abs = max(max_abs, float(d.max()))
    return {"image_mean_abs": mean_abs, "image_max_abs": max_abs}
