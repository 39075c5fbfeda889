"""Per-Gaussian feature layout, the constants the render keys off, the
per-point geometry (pinhole projection, the EWA covariance projection,
conic and density) and the sampling helpers of the density controller.

Feature-row layout of the (N, 56) feature table:
[0:4] quaternion xyzw, [4:7] log-scales, [7] alpha logit,
[8:24]/[24:40]/[40:56] R/G/B SH coefficients.

The geometry helpers are batched over leading axes; `T_camera_world` is
(..., 4, 4) and `intrinsics` one (3, 3) matrix.
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


def project_points(xyz, T_camera_world, intrinsics):
    """World points (..., 3) -> (uv (..., 2), xyz_camera (..., 3))."""
    xyz_cam = (_mat3_vec(T_camera_world[..., :3, :3], xyz)
               + T_camera_world[..., :3, 3])
    x, y, z = xyz_cam[..., 0], xyz_cam[..., 1], xyz_cam[..., 2]
    u = (intrinsics[0, 0] * x + intrinsics[0, 1] * y
         + intrinsics[0, 2] * z) / z
    v = (intrinsics[1, 0] * x + intrinsics[1, 1] * y
         + intrinsics[1, 2] * z) / z
    return torch.stack([u, v], dim=-1), xyz_cam


def projective_transform_jacobian(intrinsics, xyz_cam):
    """The approximated (..., 2, 3) pinhole jacobian: the cx, cy terms are
    dropped, as in the render's covariance projection."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    x, y, z = xyz_cam[..., 0], xyz_cam[..., 1], xyz_cam[..., 2]
    zero = torch.zeros_like(z)
    row0 = torch.stack([fx / z, zero, -(fx * x) / (z * z)], dim=-1)
    row1 = torch.stack([zero, fy / z, -(fy * y) / (z * z)], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def covariance_3d(q, log_s):
    """Sigma = R S S^T R^T with S = diag(exp(log_s)), (..., 3, 3)."""
    R = rotation_matrix_from_quaternion(q)
    M = R * torch.exp(2.0 * log_s)[..., None, :]   # R diag(s^2)
    return (M[..., :, None, :] * R[..., None, :, :]).sum(dim=-1)


def project_covariance(q, log_s, T_camera_world, intrinsics, xyz_cam):
    """The EWA-projected (..., 2, 2) covariance P P^T, P = J W R S."""
    W = T_camera_world[..., :3, :3]
    M = rotation_matrix_from_quaternion(q) * torch.exp(log_s)[..., None, :]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    x, y, z = xyz_cam[..., 0], xyz_cam[..., 1], xyz_cam[..., 2]
    inv_z = 1.0 / z
    j00 = fx * inv_z
    j02 = -fx * x * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * y * inv_z * inv_z
    jw0 = j00[..., None] * W[..., 0, :] + j02[..., None] * W[..., 2, :]
    jw1 = j11[..., None] * W[..., 1, :] + j12[..., None] * W[..., 2, :]
    p0 = (jw0[..., :, None] * M).sum(dim=-2)       # row 0 of (J W) M
    p1 = (jw1[..., :, None] * M).sum(dim=-2)
    a = (p0 * p0).sum(-1)
    b = (p0 * p1).sum(-1)
    c = (p1 * p1).sum(-1)
    return torch.stack([torch.stack([a, b], -1), torch.stack([b, c], -1)],
                       dim=-2)


def conic_and_rescale(cov_uv):
    """(..., 2, 2) covariance -> (a, b, c, rescale) (..., 4): the conic of
    the covariance with COV_LOW_PASS added to its diagonal, and the density
    rescale sqrt(det before / det after), which carries no gradient."""
    a0, b0 = cov_uv[..., 0, 0], cov_uv[..., 0, 1]
    b0t, c0 = cov_uv[..., 1, 0], cov_uv[..., 1, 1]
    det_pre = a0 * c0 - b0 * b0t
    a = a0 + COV_LOW_PASS
    c = c0 + COV_LOW_PASS
    det = a * c - b0 * b0t
    rescale = torch.sqrt(torch.clamp(det_pre / det, min=0.0)).detach()
    inv_det = 1.0 / det
    return torch.stack([c * inv_det, -b0 * inv_det, a * inv_det, rescale],
                       dim=-1)


def density_from_conic(xy, mean, conic_and_rescale_v):
    """The unnormalized 2D Gaussian density at `xy`, times the rescale."""
    d = xy - mean
    a, b, c, w = conic_and_rescale_v.unbind(-1)
    exponent = (-0.5 * (d[..., 0] * d[..., 0] * a + d[..., 1] * d[..., 1] * c)
                - d[..., 0] * d[..., 1] * b)
    return torch.exp(exponent) * w


def point_radii(cov_uv):
    """3 sigma of the major axis of the unfiltered (..., 2, 2) covariance."""
    a, b = cov_uv[..., 0, 0], cov_uv[..., 0, 1]
    bt, c = cov_uv[..., 1, 0], cov_uv[..., 1, 1]
    large_eig = (a + c + torch.sqrt((a - c) * (a - c) + 4.0 * b * bt)) / 2.0
    return torch.sqrt(torch.clamp(large_eig, min=0.0)) * 3.0


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
