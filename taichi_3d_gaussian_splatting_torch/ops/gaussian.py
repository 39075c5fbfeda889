"""Per-Gaussian feature layout, the constants the render keys off, and the
sampling helpers of the density controller.

Feature-row layout of the (N, 56) feature table:
[0:4] quaternion xyzw, [4:7] log-scales, [7] alpha logit,
[8:24]/[24:40]/[40:56] R/G/B SH coefficients.
"""

import torch

from .transforms import rotation_matrix_from_quaternion

# Feature layout slices
FEATURE_Q = slice(0, 4)
FEATURE_S = slice(4, 7)
FEATURE_ALPHA = 7
FEATURE_R_SH = slice(8, 24)
FEATURE_G_SH = slice(24, 40)
FEATURE_B_SH = slice(40, 56)
NUM_FEATURES = 56

# Low-pass filter added to the projected covariance diagonal so every
# Gaussian is at least ~1 pixel wide.
COV_LOW_PASS = 0.3

# The blend skips (and passes no gradient through) any per-pixel
# contribution below this. The blend kernel, its plain version and the
# projection's opacity-aware extent bound all key off this one constant.
ALPHA_SKIP_THRESHOLD = 1.0 / 255.0


def _mat3_vec(R, v):
    """Batched (..., 3, 3) @ (..., 3)."""
    return (R * v[..., None, :]).sum(dim=-1)


def ellipsoid_foci_vector(q, log_s):
    """Vector from each ellipsoid's centre to a focus, along its major
    axis. q: (..., 4) unit xyzw; log_s: (..., 3) log-scales."""
    sx, sy, sz = log_s[..., 0], log_s[..., 1], log_s[..., 2]
    base_y = (sx < sy) & (sy > sz)
    base_z = (sx < sz) & (sy < sz)
    eye = torch.eye(3, dtype=log_s.dtype, device=log_s.device)
    base = torch.where(base_y[..., None], eye[1],
                       torch.where(base_z[..., None], eye[2], eye[0]))
    base = _mat3_vec(rotation_matrix_from_quaternion(q), base)
    s = torch.exp(log_s)
    r_c = s.amax(dim=-1)
    r_a = s.amin(dim=-1)
    return torch.sqrt(r_c * r_c - r_a * r_a)[..., None] * base


def sample_from_gaussian(xyz, q, log_s, generator=None):
    """One position drawn from each 3D Gaussian (mean xyz, rotation q,
    scales exp(log_s)): xyz + R (s * z), z standard normal from
    `generator` (a torch.Generator on xyz's device; None = the global
    one)."""
    z = torch.randn(xyz.shape, generator=generator, dtype=xyz.dtype,
                    device=xyz.device)
    return xyz + _mat3_vec(rotation_matrix_from_quaternion(q),
                           torch.exp(log_s) * z)
