"""Training loss: L = (1 - lambda) L1 + lambda (1 - SSIM), plus an optional
scale regularizer. The training step and validation take the image terms
through `loss_cuda.image_loss` (one kernel on the card); `image_terms` is
their plain form."""

from __future__ import annotations

import dataclasses

import torch

from .ssim import ssim


@dataclasses.dataclass
class LossFunctionConfig:
    lambda_value: float = 0.2
    enable_regularization: bool = True
    regularization_weight: float = 2.0


def image_terms(predicted_image, ground_truth_image, lambda_value):
    """The image terms of the loss: ((1 - lambda) L1 + lambda (1 - SSIM),
    L1, 1 - SSIM) of channel-last images."""
    l1 = torch.abs(predicted_image - ground_truth_image).mean()
    ld_ssim = 1.0 - ssim(predicted_image, ground_truth_image, data_range=1.0)
    loss = (1.0 - lambda_value) * l1 + lambda_value * ld_ssim
    return loss, l1, ld_ssim


class LossFunction:
    def __init__(self, config: LossFunctionConfig):
        self.config = config

    def __call__(self, predicted_image, ground_truth_image,
                 point_invalid_mask=None, pointcloud_features=None):
        """Images are channel-last (H, W, 3) in [0, 1].

        Returns (L, L1, 1 - SSIM)."""
        loss, l1, ld_ssim = image_terms(predicted_image, ground_truth_image,
                                        self.config.lambda_value)
        if (pointcloud_features is not None
                and self.config.enable_regularization):
            loss = loss + self.regularization_term(point_invalid_mask,
                                                   pointcloud_features)
        return loss, l1, ld_ssim

    def regularization_term(self, point_invalid_mask, pointcloud_features):
        """The regularizer as the loss adds it (weight included)."""
        return (self.config.regularization_weight
                * self._regularization_loss(point_invalid_mask,
                                            pointcloud_features))

    @staticmethod
    def _regularization_loss(point_invalid_mask, pointcloud_features):
        """Mean over valid points of ||exp(s)||_2. The mask is applied
        before exp, so an invalid slot with huge or NaN log-scales adds
        exactly 0 (not inf * 0 = NaN)."""
        valid_b = point_invalid_mask == 0
        valid = valid_b.to(torch.float32)
        s = torch.where(valid_b[:, None], pointcloud_features[:, 4:7],
                        torch.zeros_like(pointcloud_features[:, 4:7]))
        norms = torch.linalg.norm(torch.exp(s), dim=1) * valid
        return torch.sum(norms) / torch.clamp(torch.sum(valid), min=1.0)
