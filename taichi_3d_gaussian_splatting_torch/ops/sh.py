"""Real spherical harmonics basis, hard-coded to degree 3 (16 coefficients).

The basis also serves as its own jacobian with respect to the coefficient
vector.
"""

from __future__ import annotations

import torch

NUM_SH_COEFFS = 16

# Number of active coefficients per SH band of the curriculum.
SH_BAND_TO_NUM_COEFFS = {0: 1, 1: 4, 2: 9, 3: 16}

# band of each of the 16 coefficients
_COEFF_BAND = (0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3)


def sh_basis_from_direction(direction):
    """Directions (..., 3) (not necessarily normalized) -> SH basis (..., 16).

    Normalizes internally."""
    d = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    one = torch.ones_like(x)
    return torch.stack([
        0.28209479177387814 * one,
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y,
        -1.0925484305920792 * y * z,
        0.94617469575755997 * z * z - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * x * x - 0.54627421529603959 * y * y,
        0.59004358992664352 * y * (-3.0 * x * x + y * y),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z * z),
        0.3731763325901154 * z * (5.0 * z * z - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z * z),
        1.4453057213202769 * z * (x * x - y * y),
        0.59004358992664352 * x * (-x * x + 3.0 * y * y),
    ], dim=-1)


def evaluate_sh(factors, direction):
    """dot(factors, basis(direction)); factors (..., 16), direction (..., 3)."""
    return torch.sum(factors * sh_basis_from_direction(direction), dim=-1)


def sh_band_mask(max_band, dtype=torch.float32, device=None):
    """(16,) mask with 1.0 for coefficients active at `max_band`.

    `max_band` is an int or a 0-d tensor; a tensor's device wins over
    `device`."""
    if isinstance(max_band, torch.Tensor):
        device = max_band.device
    coeff_band = torch.tensor(_COEFF_BAND, dtype=torch.int32, device=device)
    return (coeff_band <= max_band).to(dtype)


def feature_sh_band_mask(max_band, num_features: int = 56,
                         dtype=torch.float32, device=None):
    """(num_features,) mask that keeps non-SH features plus active SH bands
    (zeroes the gradients of inactive bands)."""
    sh = sh_band_mask(max_band, dtype, device)
    head = torch.ones((8,), dtype=dtype, device=sh.device)
    return torch.cat([head, sh, sh, sh])[:num_features]
