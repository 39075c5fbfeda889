"""Point-parallel attribute pipeline: 3D Gaussians -> per-point 2D attributes.

One batched, differentiable torch stage over the whole point pool: frustum
test, EWA projection of the covariance, conic with low-pass rescale, SH
colour along the camera ray, and the opacity-aware tile extents. Per-point
quantities are (N,) columns (structure of arrays), as in the JAX package,
so the two can be compared column by column.

The stored quaternion is normalized on read with a straight-through
jacobian: gradients are taken with respect to the normalized value.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..camera import CameraInfo, TILE_WIDTH, TILE_HEIGHT, BOUNDARY_TILES
from .gaussian import ALPHA_SKIP_THRESHOLD, COV_LOW_PASS
from .transforms import quaternion_normalize, rotation_matrix_from_quaternion


class PointAttributes(NamedTuple):
    """Per-point 2D attributes as (N,) columns."""
    u: torch.Tensor
    v: torch.Tensor
    depth: torch.Tensor              # camera-space z
    conic_a: torch.Tensor
    conic_b: torch.Tensor
    conic_c: torch.Tensor
    rescale: torch.Tensor            # low-pass density rescale (no gradient)
    alpha_after_activation: torch.Tensor
    color_r: torch.Tensor
    color_g: torch.Tensor
    color_b: torch.Tensor
    radii: torch.Tensor              # 3 sqrt(lambda_max)
    in_frustum: torch.Tensor         # (N,) bool, pure frustum & valid mask
    radius_x: torch.Tensor           # per-axis extents (3-sigma marginals,
    radius_y: torch.Tensor           # opacity-bounded); the binning's bbox
    nonfinite_points: torch.Tensor   # () int32 valid points culled because
    #   an attribute went inf/NaN
    emit: torch.Tensor               # (N,) bool, in_frustum & finite &
    #   visible: the binning's emission mask

    @property
    def uv(self):
        return torch.stack([self.u, self.v], dim=-1)


def normalize_straight_through_columns(qx, qy, qz, qw):
    """Value = q/|q| componentwise, jacobian = diag(1/|q|).

    The squared norm is floored so an all-zero quaternion (a padded pool
    slot) yields 0 rather than NaN."""
    inv = torch.rsqrt(torch.clamp(qx * qx + qy * qy + qz * qz + qw * qw,
                                  min=1e-24)).detach()
    return qx * inv, qy * inv, qz * inv, qw * inv


def _per_object_columns(rows, point_object_id):
    """(16, K) table -> 16 columns: scalars when K == 1 (they broadcast),
    else one gather by object id -> (N,) columns."""
    if rows.shape[1] == 1:
        return tuple(rows[:, 0])
    return tuple(rows[:, point_object_id.long()])


def compute_point_attributes(
    pointcloud: torch.Tensor,           # (N, 3)
    pointcloud_features: torch.Tensor,  # (N, 56)
    point_invalid_mask: torch.Tensor,   # (N,) int8/bool; 1 = invalid
    point_object_id: torch.Tensor,      # (N,) int32 in [0, K)
    q_camera_pointcloud: torch.Tensor,  # (K, 4)
    t_camera_pointcloud: torch.Tensor,  # (K, 3)
    t_pointcloud_camera: torch.Tensor,  # (K, 3) ray origins per object
    camera_info: CameraInfo,
    near_plane: float,
    far_plane: float,
    color_sh_mask: Optional[torch.Tensor] = None,  # (16,) band mask
    object_edit=None,                   # optional (q (K,4), s (K,3), t (K,3))
    #   per-object scene-editing transform: each point becomes
    #   R_e @ (p * s_e + t_e) and its covariance R_e S_e Sigma S_e R_e^T
) -> PointAttributes:
    device = pointcloud.device
    intrinsics = torch.as_tensor(camera_info.camera_intrinsics,
                                 dtype=torch.float32, device=device)
    fx = intrinsics[0, 0]
    fy = intrinsics[1, 1]
    cx = intrinsics[0, 2]
    cy = intrinsics[1, 2]

    # per-object camera rotation and translation, one (16, K) table
    R_obj = rotation_matrix_from_quaternion(
        quaternion_normalize(q_camera_pointcloud))       # (K, 3, 3)
    num_objects = q_camera_pointcloud.shape[0]
    table = torch.cat([
        R_obj.reshape(num_objects, 9).T,
        t_camera_pointcloud.T, t_pointcloud_camera.T,
        torch.zeros((1, num_objects), dtype=torch.float32, device=device),
    ], dim=0)                                             # (16, K)
    (w00, w01, w02, w10, w11, w12, w20, w21, w22,
     tcx, tcy, tcz, ox, oy, oz, _) = _per_object_columns(table,
                                                        point_object_id)

    px, py, pz = pointcloud[:, 0], pointcloud[:, 1], pointcloud[:, 2]
    feats_t = pointcloud_features.T                       # (56, N)

    if object_edit is not None:
        # scene editing: p' = R_e (p * s_e + t_e)
        q_e, s_e, t_e = (torch.as_tensor(x, dtype=torch.float32,
                                         device=device) for x in object_edit)
        R_e = rotation_matrix_from_quaternion(quaternion_normalize(q_e))
        edit_tbl = torch.cat([
            R_e.reshape(num_objects, 9).T, s_e.T, t_e.T,
            torch.zeros((1, num_objects), dtype=torch.float32, device=device),
        ], dim=0)                                         # (16, K)
        (e00, e01, e02, e10, e11, e12, e20, e21, e22,
         sex, sey, sez, tex, tey, tez, _) = _per_object_columns(
             edit_tbl, point_object_id)
        ax = px * sex + tex
        ay = py * sey + tey
        az = pz * sez + tez
        px = e00 * ax + e01 * ay + e02 * az
        py = e10 * ax + e11 * ay + e12 * az
        pz = e20 * ax + e21 * ay + e22 * az

    # ---- project position ----
    xc = w00 * px + w01 * py + w02 * pz + tcx
    yc = w10 * px + w11 * py + w12 * pz + tcy
    zc = w20 * px + w21 * py + w22 * pz + tcz
    # Project with zc clamped at the near plane: exact for every renderable
    # point (in-frustum requires zc > near_plane), and culled points behind
    # or at the camera get bounded attributes with finite jacobians instead
    # of 0 * inf = NaN. The frustum test below keeps the TRUE zc.
    zc_proj = torch.clamp(zc, min=near_plane)
    inv_z = 1.0 / zc_proj
    u = fx * xc * inv_z + cx
    v = fy * yc * inv_z + cy

    # ---- quaternion (straight-through normalize) + rotation ----
    qx, qy, qz_, qw = normalize_straight_through_columns(
        feats_t[0], feats_t[1], feats_t[2], feats_t[3])
    r00 = 1 - 2 * (qy * qy + qz_ * qz_)
    r01 = 2 * (qx * qy - qw * qz_)
    r02 = 2 * (qx * qz_ + qw * qy)
    r10 = 2 * (qx * qy + qw * qz_)
    r11 = 1 - 2 * (qx * qx + qz_ * qz_)
    r12 = 2 * (qy * qz_ - qw * qx)
    r20 = 2 * (qx * qz_ - qw * qy)
    r21 = 2 * (qy * qz_ + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    sx = torch.exp(feats_t[4])
    sy = torch.exp(feats_t[5])
    sz = torch.exp(feats_t[6])
    # M = R diag(s): columns scaled
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    if object_edit is not None:
        # Sigma' = (R_e S_e) Sigma (R_e S_e)^T, i.e. M' = R_e (S_e M)
        b0j0, b0j1, b0j2 = sex * m00, sex * m01, sex * m02
        b1j0, b1j1, b1j2 = sey * m10, sey * m11, sey * m12
        b2j0, b2j1, b2j2 = sez * m20, sez * m21, sez * m22
        m00 = e00 * b0j0 + e01 * b1j0 + e02 * b2j0
        m01 = e00 * b0j1 + e01 * b1j1 + e02 * b2j1
        m02 = e00 * b0j2 + e01 * b1j2 + e02 * b2j2
        m10 = e10 * b0j0 + e11 * b1j0 + e12 * b2j0
        m11 = e10 * b0j1 + e11 * b1j1 + e12 * b2j1
        m12 = e10 * b0j2 + e11 * b1j2 + e12 * b2j2
        m20 = e20 * b0j0 + e21 * b1j0 + e22 * b2j0
        m21 = e20 * b0j1 + e21 * b1j1 + e22 * b2j1
        m22 = e20 * b0j2 + e21 * b1j2 + e22 * b2j2

    # ---- EWA covariance: cov2d = P P^T with P = (J W) M ----
    j00 = fx * inv_z
    j02 = -fx * xc * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * yc * inv_z * inv_z
    jw0x = j00 * w00 + j02 * w20
    jw0y = j00 * w01 + j02 * w21
    jw0z = j00 * w02 + j02 * w22
    jw1x = j11 * w10 + j12 * w20
    jw1y = j11 * w11 + j12 * w21
    jw1z = j11 * w12 + j12 * w22
    p00 = jw0x * m00 + jw0y * m10 + jw0z * m20
    p01 = jw0x * m01 + jw0y * m11 + jw0z * m21
    p02 = jw0x * m02 + jw0y * m12 + jw0z * m22
    p10 = jw1x * m00 + jw1y * m10 + jw1z * m20
    p11 = jw1x * m01 + jw1y * m11 + jw1z * m21
    p12 = jw1x * m02 + jw1y * m12 + jw1z * m22
    cov_a = p00 * p00 + p01 * p01 + p02 * p02
    cov_b = p00 * p10 + p01 * p11 + p02 * p12
    cov_c = p10 * p10 + p11 * p11 + p12 * p12

    # ---- conic + low-pass rescale ----
    det_pre = cov_a * cov_c - cov_b * cov_b
    fa = cov_a + COV_LOW_PASS
    fc = cov_c + COV_LOW_PASS
    # cov2d is PSD, so det >= COV_LOW_PASS^2 mathematically; in f32 the
    # subtraction cancels once cov ~ COV_LOW_PASS/eps and can round to <= 0.
    # Flooring at the true lower bound keeps the conic and its jacobian
    # finite.
    det = torch.clamp(fa * fc - cov_b * cov_b,
                      min=COV_LOW_PASS * COV_LOW_PASS)
    rescale = torch.sqrt(torch.clamp(det_pre / det, min=0.0)).detach()
    inv_det = 1.0 / det
    conic_a = fc * inv_det
    conic_b = -cov_b * inv_det
    conic_c = fa * inv_det

    # ---- radius = 3 sigma of the major axis, from the UNFILTERED
    # covariance; per-axis 3-sigma extents from the marginal variances ----
    large_eig = (cov_a + cov_c + torch.sqrt(
        (cov_a - cov_c) * (cov_a - cov_c) + 4.0 * cov_b * cov_b)) / 2.0
    radii = torch.sqrt(torch.clamp(large_eig, min=0.0)) * 3.0
    radius_x = torch.sqrt(torch.clamp(cov_a, min=0.0)) * 3.0
    radius_y = torch.sqrt(torch.clamp(cov_c, min=0.0)) * 3.0

    alpha_act = torch.sigmoid(feats_t[7])

    # ---- opacity-aware extent bound (exact wrt the blend's skip gate) ----
    # Pixels beyond the Mahalanobis radius r_eff, where the peak decays to
    # the 1/255 skip threshold, can never blend, so tiles wholly beyond it
    # get no keys. r_eff^2 = 2 ln(255 * peak), capped at the 3-sigma box;
    # the marginal extents use the FILTERED variances (fa, fc), the matrix
    # the blend's conic inverts.
    peak = (rescale * alpha_act).detach()
    r_eff = torch.sqrt(torch.clamp(
        2.0 * torch.log(255.0 * torch.clamp(peak, min=1e-30)), min=0.0))
    radius_x = torch.minimum(radius_x,
                             r_eff * torch.sqrt(torch.clamp(fa, min=0.0)))
    radius_y = torch.minimum(radius_y,
                             r_eff * torch.sqrt(torch.clamp(fc, min=0.0)))
    visible = peak >= ALPHA_SKIP_THRESHOLD

    # ---- SH color along the camera->point ray ----
    dx = px - ox
    dy = py - oy
    dz = pz - oz
    dn = torch.rsqrt(dx * dx + dy * dy + dz * dz + 1e-37)
    x, y, z = dx * dn, dy * dn, dz * dn
    one = torch.ones_like(x)
    basis = [
        0.28209479177387814 * one,
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y,
        -1.0925484305920792 * y * z,
        0.94617469575755997 * z * z - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * (x * x - y * y),
        0.59004358992664352 * y * (-3.0 * x * x + y * y),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z * z),
        0.3731763325901154 * z * (5.0 * z * z - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z * z),
        1.4453057213202769 * z * (x * x - y * y),
        0.59004358992664352 * x * (-x * x + 3.0 * y * y),
    ]
    if color_sh_mask is not None:
        basis = [b * color_sh_mask[i] for i, b in enumerate(basis)]
    r_sum = sum(feats_t[8 + i] * basis[i] for i in range(16))
    g_sum = sum(feats_t[24 + i] * basis[i] for i in range(16))
    b_sum = sum(feats_t[40 + i] * basis[i] for i in range(16))
    color_r = torch.sigmoid(r_sum)
    color_g = torch.sigmoid(g_sum)
    color_b = torch.sigmoid(b_sum)

    # ---- frustum test, on the TRUE zc ----
    bw = TILE_WIDTH * BOUNDARY_TILES
    bh = TILE_HEIGHT * BOUNDARY_TILES
    valid = point_invalid_mask.to(torch.int32) == 0
    in_frustum = ((zc > near_plane) & (zc < far_plane)
                  & (u >= -bw) & (u < camera_info.camera_width + bw)
                  & (v >= -bh) & (v < camera_info.camera_height + bh)
                  & valid)

    # ---- numeric containment: cull non-finite splats ----
    # One NaN pixel would make the loss NaN and poison every gradient, so a
    # splat with any non-finite attribute does not render this frame. The
    # count runs over ALL valid slots (a NaN u/v/depth already fails the
    # frustum comparisons) so poisoned parameters are always reported.
    finite = torch.isfinite(u) & torch.isfinite(v) & torch.isfinite(zc)
    for col in (conic_a, conic_b, conic_c, rescale, alpha_act,
                color_r, color_g, color_b, radius_x, radius_y):
        finite = finite & torch.isfinite(col)
    nonfinite_points = torch.sum((valid & ~finite).to(torch.int32),
                                 dtype=torch.int32)
    # emission mask: splats whose peak is below the skip gate emit no keys;
    # in_frustum stays the pure frustum membership
    emit = in_frustum & finite & visible

    return PointAttributes(
        u=u, v=v, depth=zc,
        conic_a=conic_a, conic_b=conic_b, conic_c=conic_c, rescale=rescale,
        alpha_after_activation=alpha_act,
        color_r=color_r, color_g=color_g, color_b=color_b,
        radii=radii, in_frustum=in_frustum,
        radius_x=radius_x, radius_y=radius_y,
        nonfinite_points=nonfinite_points,
        emit=emit,
    )
