"""The image terms of the training loss and their gradient in one pass:
the clamp, L1, SSIM and the gradient with respect to the unclamped render,
as one CUDA kernel (`csrc/image_loss.cu`) and a second small launch that
adds up the blocks' sums, behind `image_loss`, which every training step
(through `step.view_gradients`) and validation call.

`image_loss_torch` is its plain version: the clamp, `loss.image_terms`
(L1 and `ssim.ssim`) and `torch.autograd.grad`. CPU tensors take it; CUDA
tensors launch the kernel or raise; any other device raises. There is no
fallback. On the card the kernel reads nothing back to the host and takes
no cuDNN convolution and no autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops._build import launch, on_card
from .loss import image_terms
from .ssim import WIN_SIZE

# pixels a side of the kernel's blocks (csrc/image_loss.cu kTile): the
# blocks' sums take 2 doubles each, 3 ceil(H / TILE) ceil(W / TILE) blocks
TILE = 32


class ImageLoss(NamedTuple):
    """The image terms of one view's loss: L = (1 - lambda) L1 +
    lambda (1 - SSIM), L1 and 1 - SSIM as 0-d tensors, dL/d(render)
    (H, W, 3) and the render clamped to [0, 1] (H, W, 3)."""
    loss: torch.Tensor
    l1: torch.Tensor
    ssim_loss: torch.Tensor
    grad: torch.Tensor
    image: torch.Tensor


def image_loss_torch(image, image_gt, lambda_value) -> ImageLoss:
    """The plain version of `image_loss`."""
    image = image.detach().requires_grad_(True)
    with torch.enable_grad():
        img = torch.clamp(image, 0.0, 1.0)
        loss, l1, ld_ssim = image_terms(img, image_gt, lambda_value)
        grad, = torch.autograd.grad(loss, image)
    return ImageLoss(loss.detach(), l1.detach(), ld_ssim.detach(), grad,
                     img.detach())


def _check(image, image_gt):
    if image.dim() != 3 or image.shape[2] != 3:
        raise ValueError(f"the render must be (H, W, 3), got "
                         f"{tuple(image.shape)}")
    if tuple(image_gt.shape) != tuple(image.shape):
        raise ValueError(f"the ground truth {tuple(image_gt.shape)} is not "
                         f"the render's {tuple(image.shape)}")
    h, w = image.shape[:2]
    if h < WIN_SIZE or w < WIN_SIZE:
        raise ValueError(f"SSIM's {WIN_SIZE}-tap window needs images of at "
                         f"least {WIN_SIZE}x{WIN_SIZE}, got {h}x{w}")
    if image_gt.device != image.device:
        raise ValueError(f"the ground truth is on {image_gt.device}, the "
                         f"render on {image.device}")


def image_loss(image, image_gt, lambda_value: float) -> ImageLoss:
    """The image terms of the loss of the render `image` (H, W, 3), before
    the clamp, against `image_gt` (H, W, 3), and their gradient with respect
    to `image`: the clamp passes it where 0 <= image <= 1.

    CPU tensors take `image_loss_torch`; CUDA tensors (float32) launch the
    kernel, with no host sync; any other device raises."""
    _check(image, image_gt)
    if not on_card(image, "image_loss"):
        return image_loss_torch(image, image_gt, lambda_value)
    if image.dtype != torch.float32 or image_gt.dtype != torch.float32:
        raise ValueError(f"image_loss takes float32 images on the card, got "
                         f"{image.dtype} and {image_gt.dtype}")
    device = image.device
    h, w = image.shape[:2]
    image = image.detach().contiguous()
    image_gt = image_gt.contiguous()
    scratch = 2 * 3 * -(-h // TILE) * -(-w // TILE)
    lam = float(lambda_value)
    ssim_positions = 3 * (h - WIN_SIZE + 1) * (w - WIN_SIZE + 1)
    grad = torch.empty_like(image)
    clamped = torch.empty_like(image)
    partials = torch.empty(scratch, dtype=torch.float64, device=device)
    out = torch.empty(3, dtype=torch.float32, device=device)
    launch("image_loss", image.data_ptr(), image_gt.data_ptr(), h, w,
           (1.0 - lam) / (3 * h * w), -lam / ssim_positions, 1.0 - lam, lam,
           grad.data_ptr(), clamped.data_ptr(), partials.data_ptr(), scratch,
           out.data_ptr(), device=device)
    return ImageLoss(out[0], out[1], out[2], grad, clamped)
