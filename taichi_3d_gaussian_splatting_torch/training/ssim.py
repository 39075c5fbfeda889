"""SSIM and PSNR on torch tensors, with pytorch_msssim's conventions:
gaussian window 11, sigma 1.5, K1 = 0.01, K2 = 0.03, a separable depthwise
convolution with VALID padding, the mean over everything.

Full float32 is load-bearing: sigma = blur(x^2) - mu^2 cancels, and at
reduced precision the variances go negative by several times the
stabilizer C2. cuDNN runs float32 convolutions in TF32 by default on
Ampere and later, so the blur turns TF32 off around its own forward and
backward convolutions, whatever the caller's setting.

The training step and validation take SSIM on the card through
`loss_cuda.image_loss`'s kernel, which keeps these conventions; this
module is its plain version's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

K1 = 0.01
K2 = 0.03
WIN_SIZE = 11
WIN_SIGMA = 1.5


def _gaussian_window(device) -> torch.Tensor:
    coords = np.arange(WIN_SIZE, dtype=np.float64) - WIN_SIZE // 2
    g = np.exp(-(coords ** 2) / (2 * WIN_SIGMA ** 2))
    g /= g.sum()
    return torch.tensor(g.astype(np.float32), device=device)


@contextlib.contextmanager
def _ieee_f32_convs():
    """cuDNN float32 convolutions in full float32 (no TF32) inside."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _Blur(torch.autograd.Function):
    """Separable depthwise gaussian blur, VALID padding, of (B, C, H, W);
    forward and backward convolutions in full float32."""

    @staticmethod
    def forward(ctx, x, win):
        c = x.shape[1]
        wv = win.reshape(1, 1, -1, 1).expand(c, 1, -1, 1)
        wh = win.reshape(1, 1, 1, -1).expand(c, 1, 1, -1)
        ctx.save_for_backward(wv, wh)
        with _ieee_f32_convs():
            return F.conv2d(F.conv2d(x, wv, groups=c), wh, groups=c)

    @staticmethod
    def backward(ctx, g):
        wv, wh = ctx.saved_tensors
        c = g.shape[1]
        with _ieee_f32_convs():
            gx = F.conv_transpose2d(F.conv_transpose2d(g, wh, groups=c), wv,
                                    groups=c)
        return gx, None


def ssim(img1, img2, data_range: float = 1.0):
    """Mean SSIM. Inputs (H, W, C) or (B, H, W, C), channel-last."""
    if img1.dim() == 3:
        img1 = img1[None]
    if img2.dim() == 3:
        img2 = img2[None]
    x1 = img1.permute(0, 3, 1, 2)
    x2 = img2.permute(0, 3, 1, 2)
    win = _gaussian_window(x1.device)
    c1 = (K1 * data_range) ** 2
    c2 = (K2 * data_range) ** 2

    def blur(x):
        return _Blur.apply(x, win)

    mu1 = blur(x1)
    mu2 = blur(x2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = blur(x1 * x1) - mu1_sq
    sigma2_sq = blur(x2 * x2) - mu2_sq
    sigma12 = blur(x1 * x2) - mu1_mu2

    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean()


def psnr(img1, img2, data_range: float = 1.0):
    """10 log10(range^2 / mse)."""
    mse = torch.mean((img1 - img2) ** 2)
    return 10.0 * torch.log10(data_range * data_range / mse)
