"""Training: loss, SSIM, the density controller, checkpoints, trainer."""
