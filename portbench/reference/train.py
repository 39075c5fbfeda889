"""Plain training step: render, L1 + SSIM, the blend's and the
projection's gradients, two Adam chains and the density controller's
statistics, with the semantics of the port's trainer (`training/
trainer.py`, `adam.py`, `loss.py`, `ssim.py`, `controller.py
update_stats`), written from them.

A step, on one view, from a state of positions (N, 3), features (N, 56)
and an invalid mask (N,):
- the stored quaternions are normalized (norm floored at 1e-12);
- the image is rendered (`raster.render`), clipped to [0, 1], and
  L = (1 - lambda) L1 + lambda (1 - SSIM) taken against the view;
- the gradients of L reach the nine blend columns (`raster.backward`) and,
  by autograd through `projection.project`, the points and the features;
  the feature gradients are scaled per group and masked to the SH band;
- rows with a non-finite gradient are zeroed, and a non-finite loss
  leaves the state as it was;
- Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) on the normalized
  features at the feature rate, and on the positions at the position rate
  times decay ** ceil(count / interval);
- the controller's six accumulators add the step's statistics for the
  points in the frustum.

Also the scene's load path: the capacity padding of the trainer's scene
and its Morton order. Imports torch and numpy alone: nothing of the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import projection as P
from . import raster as R


class Adam(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor


class Stats(NamedTuple):
    """The controller's accumulators, in the port's field order."""
    num_pixels: torch.Tensor
    num_in_camera: torch.Tensor
    view_space_grad: torch.Tensor
    view_space_grad_avg: torch.Tensor
    position_grad: torch.Tensor
    position_grad_norm: torch.Tensor


class State(NamedTuple):
    pc: torch.Tensor
    feats: torch.Tensor
    invalid: torch.Tensor
    adam_feats: Adam
    adam_pc: Adam
    stats: Stats


class Hyper(NamedTuple):
    """What a step needs of the configuration."""
    near: float
    far: float
    depth_scale: float
    feature_lr: float
    position_lr: float
    position_lr_decay: float
    position_lr_interval: int
    lambda_value: float
    regularization: bool
    regularization_weight: float
    grad_scale: tuple   # (q, s, alpha, colour, high-order colour) factors
    sh_band: int


def adam_init(param):
    return Adam(torch.zeros_like(param), torch.zeros_like(param),
                torch.zeros((), dtype=torch.int32, device=param.device))


def stats_init(n, device):
    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return Stats(z((n,), torch.int32), z((n,), torch.int32), z((n,)),
                 z((n,)), z((n, 3)), z((n,)))


def initial_state(pc, feats, invalid):
    return State(pc, feats, invalid, adam_init(feats), adam_init(pc),
                 stats_init(pc.shape[0], pc.device))


def padded_and_sorted(pc: np.ndarray, feats: np.ndarray, ratio: float):
    """(positions, features, invalid) of the trainer's scene from the
    points it loads: padded to int(N * ratio) slots (zeros, an identity
    quaternion, invalid), then the valid points in Morton order of their
    positions, the padding after them."""
    n = pc.shape[0]
    cap = int(n * ratio)
    pad = cap - n
    pad_feats = np.zeros((pad, feats.shape[1]), np.float32)
    pad_feats[:, 3] = 1.0
    pc = np.concatenate([pc, np.zeros((pad, 3), np.float32)])
    feats = np.concatenate([feats, pad_feats])
    invalid = np.concatenate([np.zeros(n, np.int8), np.ones(pad, np.int8)])
    valid = invalid == 0
    v = pc[valid]
    lo = v.min(axis=0)
    span = np.maximum(v.max(axis=0) - lo, 1e-12)
    q = np.clip(((v - lo) / span) * ((1 << 21) - 1), 0,
                (1 << 21) - 1).astype(np.uint64)

    def spread(x):
        x &= np.uint64(0x1FFFFF)
        x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
        return x

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    idx = np.arange(cap)
    perm = np.concatenate([idx[valid][np.argsort(code, kind="stable")],
                           idx[~valid]])
    return pc[perm], feats[perm], invalid[perm]


def normalize_quaternions(feats):
    q = feats[:, 0:4] / torch.clamp(torch.linalg.norm(
        feats[:, 0:4], dim=1, keepdim=True), min=1e-12)
    return torch.cat([q, feats[:, 4:]], dim=1)


def _gaussian_window(device):
    coords = np.arange(11, dtype=np.float64) - 5
    g = np.exp(-(coords ** 2) / (2 * 1.5 ** 2))
    g /= g.sum()
    return torch.tensor(g.astype(np.float32), device=device)


def ssim(x, y):
    """Mean SSIM of (H, W, 3) images in [0, 1]: window 11, sigma 1.5, K1
    0.01, K2 0.03, separable valid convolutions (pytorch_msssim's)."""
    x1 = x[None].permute(0, 3, 1, 2)
    x2 = y[None].permute(0, 3, 1, 2)
    win = _gaussian_window(x.device).to(x.dtype)
    wv = win.reshape(1, 1, -1, 1).expand(3, 1, -1, 1)
    wh = win.reshape(1, 1, 1, -1).expand(3, 1, 1, -1)

    def blur(z):
        return F.conv2d(F.conv2d(z, wv, groups=3), wh, groups=3)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = blur(x1), blur(x2)
    s1 = blur(x1 * x1) - mu1 * mu1
    s2 = blur(x2 * x2) - mu2 * mu2
    s12 = blur(x1 * x2) - mu1 * mu2
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    return (((2 * mu1 * mu2 + c1) / (mu1 * mu1 + mu2 * mu2 + c1)) * cs).mean()


def loss_of(image, gt, hp: Hyper, feats=None, invalid=None):
    """(L, L1, 1 - SSIM) of the clipped render."""
    l1 = torch.abs(image - gt).mean()
    ld = 1.0 - ssim(image, gt)
    loss = (1.0 - hp.lambda_value) * l1 + hp.lambda_value * ld
    if hp.regularization and feats is not None:
        valid_b = invalid == 0
        valid = valid_b.to(torch.float32)
        s = torch.where(valid_b[:, None], feats[:, 4:7],
                        torch.zeros_like(feats[:, 4:7]))
        norms = torch.linalg.norm(torch.exp(s), dim=1) * valid
        loss = loss + hp.regularization_weight * (
            torch.sum(norms) / torch.clamp(torch.sum(valid), min=1.0))
    return loss, l1, ld


def feature_scale(hp: Hyper, device):
    """(56,) per-feature gradient factor times the SH band mask."""
    q, s, alpha, colour, high = hp.grad_scale
    scale = np.full((56,), high, np.float32)
    scale[0:4], scale[4:7], scale[7] = q, s, alpha
    scale[[8, 24, 40]] = colour
    band = (0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3)
    mask = np.ones((56,), np.float32)
    for ch in range(3):
        mask[8 + 16 * ch:24 + 16 * ch] = [float(b <= hp.sh_band) for b in band]
    return torch.tensor(scale * mask, device=device)


def adam_update(param, grad, st: Adam, lr, b1=0.9, b2=0.999, eps=1e-8):
    mu = (1.0 - b1) * grad + b1 * st.mu
    nu = (1.0 - b2) * (grad * grad) + b2 * st.nu
    count = st.count + 1
    c = count.to(torch.float32)
    mu_hat = mu / (1.0 - torch.pow(b1, c))
    nu_hat = nu / (1.0 - torch.pow(b2, c))
    return param - lr * (mu_hat / (torch.sqrt(nu_hat) + eps)), Adam(mu, nu,
                                                                   count)


class StepOut(NamedTuple):
    state: State
    loss: float
    grad_pc: torch.Tensor      # as the optimizer gets them
    grad_feats: torch.Tensor


def step(state: State, gt, q, t, cam: P.Camera, hp: Hyper,
         dtype=torch.float32, loss_rows: Optional[int] = None) -> StepOut:
    """One training step. `dtype` is the type the blend's pairs are
    computed in; `loss_rows` takes the loss over the image's first rows
    alone (a fault, for calibration)."""
    device = state.pc.device
    feats = normalize_quaternions(state.feats)
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
        loss, _, _ = loss_of(img, gt, hp, reg_leaf, state.invalid)
        g_image, g_reg = torch.autograd.grad(loss, (image_leaf, reg_leaf),
                                             allow_unused=True)
    kg = R.backward(p.cols, binning, cam, g_image, dtype)
    grad_pc, grad_f = torch.autograd.grad(
        p.cols, (pc_leaf, f_leaf), tuple(kg.cotangents))
    grad_f = grad_f * feature_scale(hp, device)
    if g_reg is not None:
        grad_f = grad_f + g_reg
    feat_ok = torch.isfinite(grad_f).all(dim=1, keepdim=True)
    pc_ok = torch.isfinite(grad_pc).all(dim=1, keepdim=True)
    grad_pc = torch.where(pc_ok, grad_pc, torch.zeros_like(grad_pc))
    grad_f = torch.where(feat_ok, grad_f, torch.zeros_like(grad_f))
    loss_value = float(loss.detach())
    if not np.isfinite(loss_value):
        return StepOut(state, loss_value, grad_pc, grad_f)

    new_f, adam_f = adam_update(feats, grad_f, state.adam_feats,
                                hp.feature_lr)
    lr_pc = hp.position_lr * torch.pow(
        hp.position_lr_decay,
        torch.ceil(state.adam_pc.count / hp.position_lr_interval))
    new_pc, adam_pc = adam_update(state.pc, grad_pc, state.adam_pc, lr_pc)

    seen = p.in_frustum.to(torch.int32)
    seen_f = p.in_frustum.to(torch.float32)
    npix = kg.num_pixels.to(torch.int32)
    mag = kg.magnitude * seen_f
    avg = torch.where(npix > 0, mag / npix.to(torch.float32),
                      torch.zeros_like(mag))
    gpos = grad_pc * seen_f[:, None]
    st = state.stats
    stats = Stats(st.num_pixels + npix * seen, st.num_in_camera + seen,
                  st.view_space_grad + mag, st.view_space_grad_avg + avg,
                  st.position_grad + gpos,
                  st.position_grad_norm + torch.linalg.norm(gpos, dim=1))
    return StepOut(State(new_pc.detach(), new_f.detach(), state.invalid,
                         adam_f, adam_pc, stats),
                   loss_value, grad_pc, grad_f)
