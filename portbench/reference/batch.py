"""Plain batch step: B views' gradients summed before one optimizer update,
with the semantics of the port's batch step (`parallel/sharding.py`, and
`training/trainer.py` `batch_step`, `_scale_schedules_for_batch` and the
betas), written from them on `reference/train.py`'s functions.

A step on B views from a state of positions (N, 3), features (N, 56) and
an invalid mask (N,):
- each view as `train.step` takes it up to its gradients
  (`view_gradients`, a copy of that part of `train.step`): the stored
  quaternions normalized, the render, L = (1 - lambda) L1 + lambda (1 -
  SSIM) on the clipped image, the gradients of the points and the
  features, the features' gradients scaled per group and masked to the SH band; no
  row is zeroed there;
- the controller's six accumulators add each view's statistics for the
  points in its frustum, from the view's raw position gradient, so that a
  non-finite row reaches them as it is (`add_stats`, a copy of that part
  of `train.step`);
- the gradients are summed over the views, not averaged, and the rows of
  the sums with a non-finite value are zeroed;
- the step's loss is the mean of the views'; a non-finite mean leaves the
  state as it was, accumulators included;
- one Adam update of each chain (`train.adam_update`) under the batch
  rules (`Rules`, `scaled`): both rates times 1, sqrt(B) or B, the position
  rate's decay interval divided by B (at least 1), the betas 0.9 ** B and
  0.999 ** B.

Imports torch and numpy alone: nothing of the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import projection as P
from . import raster as R
from . import train as T


class Rules(NamedTuple):
    """The batch of views and the rules that scale the update by it."""
    size: int
    lr: str = "sqrt"          # none / sqrt / linear
    schedules: bool = True    # the decay interval divided by the size
    betas: bool = True        # Adam's betas to the power of the size


def scaled(hp: T.Hyper, rules: Rules):
    """(the step's Hyper with its rates and decay interval scaled, (b1,
    b2)) under `rules`; a batch of one changes nothing."""
    b = int(rules.size)
    if b <= 1:
        return hp, (0.9, 0.999)
    m = {"none": 1.0, "sqrt": float(b) ** 0.5, "linear": float(b)}[rules.lr]
    interval = (max(int(hp.position_lr_interval) // b, 1) if rules.schedules
                else hp.position_lr_interval)
    betas = (0.9 ** b, 0.999 ** b) if rules.betas else (0.9, 0.999)
    return hp._replace(feature_lr=hp.feature_lr * m,
                       position_lr=hp.position_lr * m,
                       position_lr_interval=interval), betas


class ViewGradients(NamedTuple):
    """One view's loss and raw gradients, and what its statistics take."""
    loss: float
    grad_pc: torch.Tensor      # (N, 3), no row zeroed
    grad_feats: torch.Tensor   # (N, 56) scaled, band-masked, + regularizer
    num_pixels: torch.Tensor   # (N,) the blend's per-point counts
    magnitude: torch.Tensor    # (N,)
    in_frustum: torch.Tensor   # (N,) bool


def view_gradients(state: T.State, gt, q, t, cam: P.Camera, hp: T.Hyper,
                   dtype=torch.float32,
                   loss_rows: Optional[int] = None) -> ViewGradients:
    """`train.step` up to its gradients, before any row is zeroed. `dtype`
    and `loss_rows` as there."""
    device = state.pc.device
    feats = T.normalize_quaternions(state.feats)
    pc_leaf = state.pc.detach().requires_grad_(True)
    f_leaf = feats.detach().requires_grad_(True)
    with torch.enable_grad():
        p = P.project(pc_leaf, f_leaf, state.invalid, q, t, cam, hp.near,
                      hp.far)
    binning = R.bin_keys(p.cols[0], p.cols[1], p.depth, p.radius_x,
                         p.radius_y, p.emit, cam, hp.depth_scale)
    image = R.render([c.detach() for c in p.cols], binning, cam, dtype)
    image_leaf = image.requires_grad_(True)
    reg_leaf = feats.detach().requires_grad_(True)
    with torch.enable_grad():
        img = torch.clamp(image_leaf, 0.0, 1.0)
        if loss_rows is not None:
            img, gt = img[:loss_rows], gt[:loss_rows]
        loss, _, _ = T.loss_of(img, gt, hp, reg_leaf, state.invalid)
        g_image, g_reg = torch.autograd.grad(loss, (image_leaf, reg_leaf),
                                             allow_unused=True)
    kg = R.backward(p.cols, binning, cam, g_image, dtype)
    grad_pc, grad_f = torch.autograd.grad(
        p.cols, (pc_leaf, f_leaf), tuple(kg.cotangents))
    grad_f = grad_f * T.feature_scale(hp, device)
    if g_reg is not None:
        grad_f = grad_f + g_reg
    return ViewGradients(float(loss.detach()), grad_pc, grad_f,
                         kg.num_pixels, kg.magnitude, p.in_frustum)


def add_stats(st: T.Stats, v: ViewGradients) -> T.Stats:
    """The accumulators plus one view's statistics for the points in its
    frustum, from its raw position gradient."""
    seen = v.in_frustum.to(torch.int32)
    seen_f = v.in_frustum.to(torch.float32)
    npix = v.num_pixels.to(torch.int32)
    mag = v.magnitude * seen_f
    avg = torch.where(npix > 0, mag / npix.to(torch.float32),
                      torch.zeros_like(mag))
    gpos = v.grad_pc * seen_f[:, None]
    return T.Stats(st.num_pixels + npix * seen, st.num_in_camera + seen,
                   st.view_space_grad + mag, st.view_space_grad_avg + avg,
                   st.position_grad + gpos,
                   st.position_grad_norm + torch.linalg.norm(gpos, dim=1))


def batch_step(state: T.State, views, cam: P.Camera, hp: T.Hyper,
               rules: Rules, dtype=torch.float32,
               loss_rows: Optional[int] = None) -> T.StepOut:
    """One optimizer step on `views`, a list of (ground truth (H, W, 3),
    q (1, 4), t (1, 3)), under `rules` (whose size is the batch's:
    handing fewer views is a fault, for calibration). Returns the state
    after it, the mean loss and the summed gradients as the update takes
    them. `dtype` and `loss_rows` as in `train.step`."""
    hp_b, (b1, b2) = scaled(hp, rules)
    sum_pc = torch.zeros_like(state.pc)
    sum_f = torch.zeros_like(state.feats)
    stats, losses = state.stats, []
    for gt, q, t in views:
        v = view_gradients(state, gt, q, t, cam, hp, dtype, loss_rows)
        stats = add_stats(stats, v)
        sum_pc = sum_pc + v.grad_pc
        sum_f = sum_f + v.grad_feats
        losses.append(v.loss)
    feat_ok = torch.isfinite(sum_f).all(dim=1, keepdim=True)
    pc_ok = torch.isfinite(sum_pc).all(dim=1, keepdim=True)
    sum_pc = torch.where(pc_ok, sum_pc, torch.zeros_like(sum_pc))
    sum_f = torch.where(feat_ok, sum_f, torch.zeros_like(sum_f))
    loss = float(np.mean(losses))
    if not math.isfinite(loss):
        return T.StepOut(state, loss, sum_pc, sum_f)

    feats = T.normalize_quaternions(state.feats)
    new_f, adam_f = T.adam_update(feats, sum_f, state.adam_feats,
                                  hp_b.feature_lr, b1, b2)
    lr_pc = hp_b.position_lr * torch.pow(
        hp_b.position_lr_decay,
        torch.ceil(state.adam_pc.count / hp_b.position_lr_interval))
    new_pc, adam_pc = T.adam_update(state.pc, sum_pc, state.adam_pc, lr_pc,
                                    b1, b2)
    return T.StepOut(T.State(new_pc.detach(), new_f.detach(), state.invalid,
                             adam_f, adam_pc, stats),
                     loss, sum_pc, sum_f)
