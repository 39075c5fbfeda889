"""The image loss kernel's arithmetic on the CPU (`csrc/image_loss.cu`
behind `training/loss_cuda.py::image_loss`; its launch on the card is in
tests/test_torch_cuda.py).

`mirror` is a float64 copy of what the kernel computes, written as it
does: the five blurs as shifted sums, the SSIM map's three derivative
maps, the transposed blur as shifted sums over zero padding, the clamp's
mask with both ends included and the L1 sign that is 0 at ties. It is held
against `torch.autograd.grad` of the plain loss (`loss.image_terms`, the
package's own `ssim`, in float64) to 1e-9, and against the float32 plain
version. `image_loss`'s plain version is held bit for bit against the
loss stage it replaced, and the trainer's steps against that stage."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_torch.training import loss as TL
from taichi_3d_gaussian_splatting_torch.training import loss_cuda as TLC
from taichi_3d_gaussian_splatting_torch.training import ssim as TS
from taichi_3d_gaussian_splatting_torch.training import step as TSTEP

from torch_train_fixtures import (assert_bitwise_equal, batch_step_state,
                                  loss_images, one_step_state, write_dataset)

torch.set_num_threads(1)
SOURCE = (Path(TLC.__file__).resolve().parent.parent / "csrc"
          / "image_loss.cu")
REACH = TS.WIN_SIZE - 1
LAMBDA = 0.2
# sizes below, at and past the kernel's 32-pixel tile, down to 11x11
SIZES = [(11, 11), (11, 40), (33, 17), (45, 70), (64, 32)]


TAPS64 = TS._gaussian_window("cpu").to(torch.float64)


def _shifted_sum(x, taps, dim, n):
    """sum_t taps[t] x[..., t : t + n, ...] along `dim`: one pass of a
    VALID blur."""
    return sum(float(taps[t]) * x.narrow(dim, t, n)
               for t in range(len(taps)))


def _blur(x, taps):
    """(C, H, W) -> (C, H - 10, W - 10): vertical, then horizontal."""
    v = _shifted_sum(x, taps, 1, x.shape[1] - REACH)
    return _shifted_sum(v, taps, 2, x.shape[2] - REACH)


def _blur_t(d, taps):
    """The transposed blur, (C, H - 10, W - 10) -> (C, H, W):
    out[p] = sum_t taps[t] d[p - t], horizontal, then vertical."""
    c, qh, qw = d.shape
    dp = torch.nn.functional.pad(d, (REACH, REACH))
    hsum = sum(float(taps[t]) * dp[:, :, REACH - t:REACH - t + qw + REACH]
               for t in range(len(taps)))
    hp = torch.nn.functional.pad(hsum, (0, 0, REACH, REACH))
    return sum(float(taps[t]) * hp[:, REACH - t:REACH - t + qh + REACH, :]
               for t in range(len(taps)))


def mirror(render, gt, lam):
    """The kernel's arithmetic in float64: (loss, L1, 1 - SSIM, dL/d
    render (H, W, 3), the clamped render)."""
    x = render.to(torch.float64).permute(2, 0, 1)
    y = gt.to(torch.float64).permute(2, 0, 1)
    taps = TAPS64
    x1 = torch.where(x < 0, 0.0, torch.where(x > 1, 1.0, x))
    mu1, mu2 = _blur(x1, taps), _blur(y, taps)
    e11, e22, e12 = _blur(x1 * x1, taps), _blur(y * y, taps), _blur(x1 * y,
                                                                   taps)
    c1, c2 = TS.K1 ** 2, TS.K2 ** 2
    a1 = 2 * mu1 * mu2 + c1
    b1 = mu1 * mu1 + mu2 * mu2 + c1
    a2 = 2 * (e12 - mu1 * mu2) + c2
    b2 = (e11 - mu1 * mu1) + (e22 - mu2 * mu2) + c2
    l, cs = a1 / b1, a2 / b2
    s = l * cs
    d_12 = 2 * l / b2
    d_11 = -s / b2
    d_mu = 2 * cs * (mu2 - l * mu1) / b1 - mu2 * d_12 - 2 * mu1 * d_11
    ds = (_blur_t(d_mu, taps) + 2 * x1 * _blur_t(d_11, taps)
          + y * _blur_t(d_12, taps))
    l1 = (x1 - y).abs().mean()
    ld = 1 - s.mean()
    loss = (1 - lam) * l1 + lam * ld
    sign = (x1 > y).to(x.dtype) - (x1 < y).to(x.dtype)
    mask = (x >= 0) & (x <= 1)
    grad = torch.where(mask, (1 - lam) / x.numel() * sign
                       - lam / s.numel() * ds, 0.0)
    return loss, l1, ld, grad.permute(1, 2, 0), x1.permute(1, 2, 0)


def _plain64(render, gt, monkeypatch):
    """The plain version in float64: the package's clamp, image_terms and
    ssim (its window's float32 taps in float64) and autograd.grad."""
    monkeypatch.setattr(TS, "_gaussian_window", lambda device: TAPS64)
    return TLC.image_loss_torch(render.to(torch.float64),
                                gt.to(torch.float64), LAMBDA)


def test_taps_are_the_windows():
    """The kernel's constant taps are _gaussian_window's float32 values,
    bit for bit."""
    text = SOURCE.read_text()
    body = re.search(r"kTaps\[kWin\]\s*=\s*\{([^}]*)\}", text).group(1)
    taps = [float.fromhex(v.strip().rstrip("f")) for v in body.split(",")]
    want = TS._gaussian_window("cpu")
    assert torch.equal(torch.tensor(taps, dtype=torch.float32), want)
    assert all(float(np.float32(t)) == t for t in taps)


@pytest.mark.parametrize("h, w", SIZES)
def test_mirror_matches_autograd(h, w, monkeypatch):
    """The analytic backward against autograd of the plain loss, both in
    float64, to 1e-9 relative (the gradient against its largest value), on
    renders with values outside [0, 1], ties with the ground truth and
    values exactly 0 and 1; the clamped render exactly."""
    render, gt = loss_images(h, w, seed=h * 100 + w)
    got = mirror(render, gt, LAMBDA)
    want = _plain64(render, gt, monkeypatch)
    for a, b in zip(got[:3], want[:3]):
        assert abs(float(a) - float(b)) <= 1e-9 * abs(float(b))
    scale = float(want.grad.abs().max())
    np.testing.assert_allclose(got[3].numpy(), want.grad.numpy(), rtol=1e-9,
                               atol=1e-9 * scale)
    assert torch.equal(got[4], want.image)
    # the ties and the ends are in the image and take their gradient: 0 off
    # [0, 1], the SSIM term alone at a tie
    r = render.to(torch.float64)
    assert (r == 0).any() and (r == 1).any() and (r == gt).any()
    assert (got[3][(r < 0) | (r > 1)] == 0).all()


@pytest.mark.parametrize("h, w", SIZES)
def test_mirror_matches_the_float32_plain_version(h, w):
    """The float32 plain version (autograd through cuDNN's or the CPU's
    convolutions) within float32's reach of the float64 mirror: values to
    1e-5 relative, the gradient of the pixels' sum (3 H W dL/dx) at rtol
    2e-3 / atol 1e-4, the tolerances of the card's test."""
    render, gt = loss_images(h, w, seed=h * 100 + w + 1)
    got = TLC.image_loss_torch(render, gt, LAMBDA)
    want = mirror(render, gt, LAMBDA)
    for a, b in zip(got[:3], want[:3]):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    n = render.numel()
    np.testing.assert_allclose(got.grad.double().numpy() * n,
                               want[3].numpy() * n, rtol=2e-3, atol=1e-4)


def _todays_loss_stage(image, image_gt, loss_fn, point_invalid_mask, feats):
    """The loss stage before image_loss: one autograd graph over the
    clamp, LossFunction (with the regularizer) and autograd.grad."""
    image = image.detach().requires_grad_(True)
    feats_leaf = feats.detach().requires_grad_(True)
    with torch.enable_grad():
        img = torch.clamp(image, 0.0, 1.0)
        loss, l1, ld_ssim = loss_fn(img, image_gt,
                                    point_invalid_mask=point_invalid_mask,
                                    pointcloud_features=feats_leaf)
        g_image, g_feats = torch.autograd.grad(loss, (image, feats_leaf),
                                               allow_unused=True)
    return loss.detach(), l1.detach(), ld_ssim.detach(), g_image, \
        img.detach(), g_feats


@pytest.mark.parametrize("h, w", [(11, 11), (45, 70)])
def test_plain_version_is_the_replaced_chain(h, w):
    """On the CPU image_loss is the clamp, LossFunction and autograd.grad
    as the step ran them, bit for bit."""
    render, gt = loss_images(h, w, seed=7)
    loss_fn = TL.LossFunction(TL.LossFunctionConfig(
        lambda_value=LAMBDA, enable_regularization=False))
    want = _todays_loss_stage(render, gt, loss_fn, None,
                              torch.zeros(4, 56))
    got = TLC.image_loss(render, gt, LAMBDA)
    assert want[5] is None
    assert_bitwise_equal(tuple(got), want[:5])


def _parent_view_gradients(scene, image_gt, q, t, camera_info,
                           raster_config, loss_fn, grad_scale, band_mask,
                           mark=TSTEP._no_mark):
    """step.view_gradients with the loss stage it had before
    image_loss."""
    result, vjp_fn = TSTEP.rasterize_with_vjp(
        *scene, q, t, camera_info, raster_config, mark=mark)
    with TSTEP.span("loss", mark):
        loss, l1, ld_ssim, g_image, img, g_feats_direct = _todays_loss_stage(
            result.image, image_gt, loss_fn, scene.point_invalid_mask,
            scene.point_cloud_features)
    grad_pc, grad_feats_raster, stats = vjp_fn(g_image)
    return TSTEP.ViewGradients(loss, l1, ld_ssim, img, grad_pc,
                               grad_feats_raster, g_feats_direct, grad_scale,
                               band_mask, stats, result)


@pytest.mark.parametrize("regularize", [True, False])
def test_steps_match_the_replaced_loss_stage(tmp_path, monkeypatch,
                                             regularize):
    """A single-view step and two batch steps on the CPU leave the same
    loss and state, bit for bit, as with the loss stage before image_loss
    (the regularizer on, as the trainer's default, and off), patched in
    once, where both steps take it: once for the single view, once for
    each of the batch steps' four views."""
    root = str(tmp_path)
    write_dataset(root)
    over = {"loss_function_config": {"enable_regularization": regularize}}
    cpu = torch.device("cpu")
    single = one_step_state(root, "cpu", **over)
    batch = batch_step_state(cpu, root, **over)
    calls = []

    def parent(*args, **kwargs):
        calls.append(len(calls))
        return _parent_view_gradients(*args, **kwargs)

    monkeypatch.setattr(TSTEP, "view_gradients", parent)
    parent_single = one_step_state(root, "cpu", **over)
    assert len(calls) == 1
    parent_batch = batch_step_state(cpu, root, **over)
    assert len(calls) == 1 + 4
    assert single[0] == parent_single[0]
    assert batch["losses"] == parent_batch["losses"]
    for got, want in ((single[1], parent_single[1]),
                      (batch["state"], parent_batch["state"])):
        assert got.keys() == want.keys()
        for k in want:
            assert_bitwise_equal(torch.as_tensor(got[k]),
                                 torch.as_tensor(want[k]), k)


@pytest.mark.parametrize("shape", [(10, 40, 3), (40, 10, 3), (16, 16, 4),
                                   (16, 16)])
def test_image_loss_refuses_what_the_kernel_cannot_take(shape):
    """Images under 11 pixels a side, or not (H, W, 3), raise on every
    device, and a ground truth of another shape raises."""
    x = torch.zeros(shape)
    with pytest.raises(ValueError):
        TLC.image_loss(x, x, LAMBDA)
    with pytest.raises(ValueError):
        TLC.image_loss(torch.zeros(16, 16, 3), torch.zeros(16, 17, 3),
                       LAMBDA)
