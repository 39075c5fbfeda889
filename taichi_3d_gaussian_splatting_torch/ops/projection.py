"""Point-parallel attribute pipeline: 3D Gaussians -> per-point 2D attributes.

One batched torch stage over the whole point pool: frustum test, EWA
projection of the covariance, conic with low-pass rescale, SH colour along
the camera ray, and the opacity-aware tile extents. Per-point quantities
are (N,) columns (structure of arrays), as in the JAX package, so the two
can be compared column by column.

These are the plain versions of the projection kernels
(ops/projection_cuda.py): `compute_point_attributes` is the forward (P1),
differentiable by torch autograd, and `project_points_backward_torch` the
analytic VJP of the blend's nine input columns (P2). Both evaluate the
formulas of `_forward_terms` in the order the kernels do.

The stored quaternion is normalized on read with a straight-through
jacobian: gradients are taken with respect to the normalized value.
"""

from __future__ import annotations

import types
from typing import NamedTuple, Optional

import torch

from ..camera import CameraInfo, TILE_WIDTH, TILE_HEIGHT, BOUNDARY_TILES
from .gaussian import ALPHA_SKIP_THRESHOLD, COV_LOW_PASS
from .transforms import quaternion_normalize, rotation_matrix_from_quaternion

# the floor of both logarithms of the blend's logw column
LOG_FLOOR = 1e-30
# real spherical-harmonics constants of the 16-coefficient basis
SH_C0 = 0.28209479177387814
SH_C1 = 0.48860251190291987
SH_C2 = 1.0925484305920792
SH_C3 = 0.94617469575755997
SH_C3_OFFSET = 0.31539156525251999
SH_C4 = 0.54627421529603959
SH_C5 = 0.59004358992664352
SH_C6 = 2.8906114426405538
SH_C7 = 0.45704579946446572
SH_C8 = 0.3731763325901154
SH_C9 = 1.4453057213202769


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


def _inverse_norm(qx, qy, qz, qw):
    """1/|q|, the squared norm floored so that an all-zero quaternion (a
    padded pool slot) yields 0 rather than NaN; no gradient."""
    return torch.rsqrt(torch.clamp(qx * qx + qy * qy + qz * qz + qw * qw,
                                   min=1e-24)).detach()


def normalize_straight_through_columns(qx, qy, qz, qw):
    """Value = q/|q| componentwise, jacobian = diag(1/|q|)."""
    inv = _inverse_norm(qx, qy, qz, qw)
    return qx * inv, qy * inv, qz * inv, qw * inv


def camera_table(q_camera_pointcloud, t_camera_pointcloud,
                 t_pointcloud_camera):
    """Per-object (16, K) table: the camera rotation W row-major (rows
    0-8), t_camera (9-11), the ray origin (12-14), 0."""
    num_objects = q_camera_pointcloud.shape[0]
    R_obj = rotation_matrix_from_quaternion(
        quaternion_normalize(q_camera_pointcloud))       # (K, 3, 3)
    return torch.cat([
        R_obj.reshape(num_objects, 9).T,
        t_camera_pointcloud.T, t_pointcloud_camera.T,
        torch.zeros((1, num_objects), dtype=torch.float32,
                    device=q_camera_pointcloud.device),
    ], dim=0)


def edit_table(object_edit, num_objects, device):
    """Per-object (16, K) table of the scene-editing transform (q (K, 4),
    s (K, 3), t (K, 3)): R_e row-major (rows 0-8), s_e (9-11), t_e
    (12-14), 0; None without one."""
    if object_edit is None:
        return None
    q_e, s_e, t_e = (torch.as_tensor(x, dtype=torch.float32, device=device)
                     for x in object_edit)
    R_e = rotation_matrix_from_quaternion(quaternion_normalize(q_e))
    return torch.cat([
        R_e.reshape(num_objects, 9).T, s_e.T, t_e.T,
        torch.zeros((1, num_objects), dtype=torch.float32, device=device),
    ], dim=0)


def _per_object_columns(rows, point_object_id):
    """(16, K) table -> 16 columns: scalars when K == 1 (they broadcast),
    else one gather by object id -> (N,) columns."""
    if rows.shape[1] == 1:
        return tuple(rows[:, 0])
    return tuple(rows[:, point_object_id.long()])


def _sh_basis(x, y, z):
    """The 16 basis functions at the unit direction (x, y, z)."""
    return [
        SH_C0 * torch.ones_like(x),
        -SH_C1 * y,
        SH_C1 * z,
        -SH_C1 * x,
        SH_C2 * x * y,
        -SH_C2 * y * z,
        SH_C3 * z * z - SH_C3_OFFSET,
        -SH_C2 * x * z,
        SH_C4 * (x * x - y * y),
        SH_C5 * y * (-3.0 * x * x + y * y),
        SH_C6 * x * y * z,
        SH_C7 * y * (1.0 - 5.0 * z * z),
        SH_C8 * z * (5.0 * z * z - 3.0),
        SH_C7 * x * (1.0 - 5.0 * z * z),
        SH_C9 * z * (x * x - y * y),
        SH_C5 * x * (-x * x + 3.0 * y * y),
    ]


def _forward_terms(pointcloud, pointcloud_features, point_invalid_mask,
                   point_object_id, table, edit, camera_info, near_plane,
                   far_plane, color_sh_mask):
    """Every intermediate of the projection of each point, as (N,) columns
    (a namespace); `table` / `edit` are the (16, K) tables of `camera_table`
    and `edit_table` (or None). Differentiable with respect to the points
    and the features, with the straight-through normalize, the detached
    rescale and the clamps of `compute_point_attributes`."""
    device = pointcloud.device
    intrinsics = torch.as_tensor(camera_info.camera_intrinsics,
                                 dtype=torch.float32, device=device)
    f = types.SimpleNamespace()
    f.fx, f.fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    fx, fy = f.fx, f.fy
    f.w = _per_object_columns(table, point_object_id)
    (w00, w01, w02, w10, w11, w12, w20, w21, w22,
     tcx, tcy, tcz, ox, oy, oz, _) = f.w

    px, py, pz = pointcloud[:, 0], pointcloud[:, 1], pointcloud[:, 2]
    feats_t = pointcloud_features.T                       # (56, N)
    f.feats_t = feats_t

    f.e = None
    if edit is not None:
        # scene editing: p' = R_e (p * s_e + t_e)
        f.e = _per_object_columns(edit, point_object_id)
        (e00, e01, e02, e10, e11, e12, e20, e21, e22,
         sex, sey, sez, tex, tey, tez, _) = f.e
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
    f.xc, f.yc, f.zc, f.inv_z, f.near = xc, yc, zc, inv_z, near_plane

    # ---- quaternion (straight-through normalize) + rotation ----
    f.q_inv = _inverse_norm(feats_t[0], feats_t[1], feats_t[2], feats_t[3])
    qx, qy, qz_, qw = (feats_t[i] * f.q_inv for i in range(4))
    f.q = (qx, qy, qz_, qw)
    r00 = 1 - 2 * (qy * qy + qz_ * qz_)
    r01 = 2 * (qx * qy - qw * qz_)
    r02 = 2 * (qx * qz_ + qw * qy)
    r10 = 2 * (qx * qy + qw * qz_)
    r11 = 1 - 2 * (qx * qx + qz_ * qz_)
    r12 = 2 * (qy * qz_ - qw * qx)
    r20 = 2 * (qx * qz_ - qw * qy)
    r21 = 2 * (qy * qz_ + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    f.r = ((r00, r01, r02), (r10, r11, r12), (r20, r21, r22))
    sx = torch.exp(feats_t[4])
    sy = torch.exp(feats_t[5])
    sz = torch.exp(feats_t[6])
    f.s = (sx, sy, sz)
    # M = R diag(s): columns scaled
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    if edit is not None:
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
    f.m = ((m00, m01, m02), (m10, m11, m12), (m20, m21, m22))

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
    f.jw = ((jw0x, jw0y, jw0z), (jw1x, jw1y, jw1z))
    p00 = jw0x * m00 + jw0y * m10 + jw0z * m20
    p01 = jw0x * m01 + jw0y * m11 + jw0z * m21
    p02 = jw0x * m02 + jw0y * m12 + jw0z * m22
    p10 = jw1x * m00 + jw1y * m10 + jw1z * m20
    p11 = jw1x * m01 + jw1y * m11 + jw1z * m21
    p12 = jw1x * m02 + jw1y * m12 + jw1z * m22
    f.p = ((p00, p01, p02), (p10, p11, p12))
    cov_a = p00 * p00 + p01 * p01 + p02 * p02
    cov_b = p00 * p10 + p01 * p11 + p02 * p12
    cov_c = p10 * p10 + p11 * p11 + p12 * p12
    f.cov_b = cov_b

    # ---- conic + low-pass rescale ----
    det_pre = cov_a * cov_c - cov_b * cov_b
    fa = cov_a + COV_LOW_PASS
    fc = cov_c + COV_LOW_PASS
    # cov2d is PSD, so det >= COV_LOW_PASS^2 mathematically; in f32 the
    # subtraction cancels once cov ~ COV_LOW_PASS/eps and can round to <= 0.
    # Flooring at the true lower bound keeps the conic and its jacobian
    # finite.
    det_raw = fa * fc - cov_b * cov_b
    det = torch.clamp(det_raw, min=COV_LOW_PASS * COV_LOW_PASS)
    rescale = torch.sqrt(torch.clamp(det_pre / det, min=0.0)).detach()
    inv_det = 1.0 / det
    f.fa, f.fc, f.det_raw, f.inv_det = fa, fc, det_raw, inv_det
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
    f.d, f.dn, f.dir = (dx, dy, dz), dn, (x, y, z)
    basis = _sh_basis(x, y, z)
    if color_sh_mask is not None:
        basis = [b * color_sh_mask[i] for i, b in enumerate(basis)]
    f.basis = basis
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

    f.attrs = PointAttributes(
        u=u, v=v, depth=zc,
        conic_a=conic_a, conic_b=conic_b, conic_c=conic_c, rescale=rescale,
        alpha_after_activation=alpha_act,
        color_r=color_r, color_g=color_g, color_b=color_b,
        radii=radii, in_frustum=in_frustum,
        radius_x=radius_x, radius_y=radius_y,
        nonfinite_points=nonfinite_points,
        emit=emit,
    )
    return f


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
    table = camera_table(q_camera_pointcloud, t_camera_pointcloud,
                         t_pointcloud_camera)
    edit = edit_table(object_edit, q_camera_pointcloud.shape[0],
                      pointcloud.device)
    return _forward_terms(pointcloud, pointcloud_features, point_invalid_mask,
                          point_object_id, table, edit, camera_info,
                          near_plane, far_plane, color_sh_mask).attrs


def blend_logw(rescale, alpha):
    """The blend's logw column: log(rescale) without gradient plus
    log(sigmoid(alpha)), both floored at LOG_FLOOR."""
    return (torch.log(torch.clamp(rescale, min=LOG_FLOOR)).detach()
            + torch.log(torch.clamp(alpha, min=LOG_FLOOR)))


def _sh_direction_grads(g, x, y, z):
    """d(sum_i g[i] basis_i)/d(x, y, z) for the 16 basis cotangents g."""
    one_5zz = 1.0 - 5.0 * z * z
    gx = (-SH_C1 * g[3] + SH_C2 * y * g[4] - SH_C2 * z * g[7]
          + 2.0 * SH_C4 * x * g[8] - 6.0 * SH_C5 * x * y * g[9]
          + SH_C6 * y * z * g[10] + SH_C7 * one_5zz * g[13]
          + 2.0 * SH_C9 * x * z * g[14]
          + 3.0 * SH_C5 * (y * y - x * x) * g[15])
    gy = (-SH_C1 * g[1] + SH_C2 * x * g[4] - SH_C2 * z * g[5]
          - 2.0 * SH_C4 * y * g[8] + 3.0 * SH_C5 * (y * y - x * x) * g[9]
          + SH_C6 * x * z * g[10] + SH_C7 * one_5zz * g[11]
          - 2.0 * SH_C9 * y * z * g[14] + 6.0 * SH_C5 * x * y * g[15])
    gz = (SH_C1 * g[2] - SH_C2 * y * g[5] + 2.0 * SH_C3 * z * g[6]
          - SH_C2 * x * g[7] + SH_C6 * x * y * g[10]
          - 10.0 * SH_C7 * y * z * g[11] + SH_C8 * (15.0 * z * z - 3.0) * g[12]
          - 10.0 * SH_C7 * x * z * g[13] + SH_C9 * (x * x - y * y) * g[14])
    return gx, gy, gz


def project_points_backward_torch(
    pointcloud: torch.Tensor,           # (N, 3)
    pointcloud_features: torch.Tensor,  # (N, 56)
    point_object_id: torch.Tensor,      # (N,) int32 in [0, K)
    q_camera_pointcloud: torch.Tensor,  # (K, 4)
    t_camera_pointcloud: torch.Tensor,  # (K, 3)
    t_pointcloud_camera: torch.Tensor,  # (K, 3)
    camera_info: CameraInfo,
    near_plane: float,
    cotangents: torch.Tensor,           # (9, N)
    color_sh_mask: Optional[torch.Tensor] = None,
    object_edit=None,
):
    """Plain version of the projection's backward kernel: the VJP of the
    blend's nine input columns (u, v, conic a, b, c, logw, r, g, b; rows
    of `cotangents`) with respect to the points and the features, for
    `compute_point_attributes` followed by `blend_logw`. Returns
    (grad_pointcloud (N, 3), grad_features (N, 56)).

    The chain rule written out column by column, every term evaluated for
    every point (a zero cotangent times a non-finite partial gives NaN, as
    autograd gives), with what autograd treats as constant: the norm of the
    straight-through quaternion normalize, the rescale, and no gradient
    past a clamp whose input lies below its floor (`torch.clamp`'s rule:
    the gradient passes at the floor itself). No gradient goes to the
    poses or to the edit transform."""
    table = camera_table(q_camera_pointcloud, t_camera_pointcloud,
                         t_pointcloud_camera)
    edit = edit_table(object_edit, q_camera_pointcloud.shape[0],
                      pointcloud.device)
    return backward_from_tables(pointcloud, pointcloud_features,
                                point_object_id, table, edit, camera_info,
                                near_plane, cotangents, color_sh_mask)


def backward_from_tables(pointcloud, pointcloud_features, point_object_id,
                         table, edit, camera_info, near_plane, cotangents,
                         color_sh_mask):
    """`project_points_backward_torch` given the (16, K) tables of
    `camera_table` and `edit_table` (or None)."""
    with torch.no_grad():
        n = pointcloud.shape[0]
        # the frustum (validity, far plane) does not enter the gradient
        f = _forward_terms(
            pointcloud, pointcloud_features,
            torch.zeros(n, dtype=torch.int8, device=pointcloud.device),
            point_object_id, table, edit, camera_info, near_plane,
            float("inf"), color_sh_mask)
        return _backward_from_terms(f, cotangents, color_sh_mask)


def _backward_from_terms(f, cotangents, color_sh_mask):
    g_u, g_v, g_ca, g_cb, g_cc, g_logw, g_r, g_g, g_b = cotangents
    a = f.attrs
    feats_t = f.feats_t
    zero = torch.zeros_like(g_u)
    g_feats = [None] * 56

    # ---- colour: sigmoid, the SH sums, the basis ----
    g_sums = (g_r * (1.0 - a.color_r) * a.color_r,
              g_g * (1.0 - a.color_g) * a.color_g,
              g_b * (1.0 - a.color_b) * a.color_b)
    g_basis = []
    for i in range(16):
        for ch in range(3):
            g_feats[8 + 16 * ch + i] = g_sums[ch] * f.basis[i]
        gb = (g_sums[0] * feats_t[8 + i] + g_sums[1] * feats_t[24 + i]
              + g_sums[2] * feats_t[40 + i])
        if color_sh_mask is not None:
            gb = gb * color_sh_mask[i]
        g_basis.append(gb)
    gx, gy, gz = _sh_direction_grads(g_basis, *f.dir)
    # direction = d * rsqrt(d.d + 1e-37)
    dx, dy, dz = f.d
    dn = f.dn
    g_s = -0.5 * (gx * dx + gy * dy + gz * dz) * (dn * dn * dn)
    g_px = gx * dn + 2.0 * g_s * dx
    g_py = gy * dn + 2.0 * g_s * dy
    g_pz = gz * dn + 2.0 * g_s * dz

    # ---- opacity: logw = ... + log(clamp(sigmoid(alpha), 1e-30)) ----
    alpha = a.alpha_after_activation
    g_alpha = torch.where(alpha >= LOG_FLOOR,
                          g_logw / torch.clamp(alpha, min=LOG_FLOOR), zero)
    g_feats[7] = g_alpha * (1.0 - alpha) * alpha

    # ---- conic (the determinant floored at COV_LOW_PASS^2) ----
    inv_det, fa, fc, cov_b = f.inv_det, f.fa, f.fc, f.cov_b
    g_fc = g_ca * inv_det
    g_fa = g_cc * inv_det
    g_covb = -(g_cb * inv_det)
    g_inv = g_ca * fc - g_cb * cov_b + g_cc * fa
    g_det = torch.where(f.det_raw >= COV_LOW_PASS * COV_LOW_PASS,
                        -g_inv * inv_det * inv_det, zero)
    g_cova = g_fa + g_det * fc
    g_covc = g_fc + g_det * fa
    g_covb = g_covb - 2.0 * g_det * cov_b

    # ---- cov2d = P P^T ----
    (p00, p01, p02), (p10, p11, p12) = f.p
    g_p = ((2.0 * g_cova * p00 + g_covb * p10,
            2.0 * g_cova * p01 + g_covb * p11,
            2.0 * g_cova * p02 + g_covb * p12),
           (g_covb * p00 + 2.0 * g_covc * p10,
            g_covb * p01 + 2.0 * g_covc * p11,
            g_covb * p02 + 2.0 * g_covc * p12))

    # ---- P = (J W) M ----
    m, jw = f.m, f.jw
    g_jw = [[g_p[r][0] * m[k][0] + g_p[r][1] * m[k][1] + g_p[r][2] * m[k][2]
             for k in range(3)] for r in range(2)]
    g_m = [[jw[0][k] * g_p[0][c] + jw[1][k] * g_p[1][c] for c in range(3)]
           for k in range(3)]
    (w00, w01, w02, w10, w11, w12, w20, w21, w22) = f.w[:9]
    g_j00 = g_jw[0][0] * w00 + g_jw[0][1] * w01 + g_jw[0][2] * w02
    g_j02 = g_jw[0][0] * w20 + g_jw[0][1] * w21 + g_jw[0][2] * w22
    g_j11 = g_jw[1][0] * w10 + g_jw[1][1] * w11 + g_jw[1][2] * w12
    g_j12 = g_jw[1][0] * w20 + g_jw[1][1] * w21 + g_jw[1][2] * w22

    # ---- u, v and J from (xc, yc, 1 / clamp(zc, near)) ----
    fx, fy, xc, yc, inv_z = f.fx, f.fy, f.xc, f.yc, f.inv_z
    inv_z2 = inv_z * inv_z
    g_xc = g_u * fx * inv_z - g_j02 * fx * inv_z2
    g_yc = g_v * fy * inv_z - g_j12 * fy * inv_z2
    g_invz = (g_u * fx * xc + g_v * fy * yc + g_j00 * fx + g_j11 * fy
              - 2.0 * g_j02 * fx * xc * inv_z - 2.0 * g_j12 * fy * yc * inv_z)
    g_zc = torch.where(f.zc >= f.near, -g_invz * inv_z2, zero)

    # ---- camera transform: (xc, yc, zc) = W p' + t ----
    g_px = g_px + w00 * g_xc + w10 * g_yc + w20 * g_zc
    g_py = g_py + w01 * g_xc + w11 * g_yc + w21 * g_zc
    g_pz = g_pz + w02 * g_xc + w12 * g_yc + w22 * g_zc

    if f.e is not None:
        # p' = R_e (p * s_e + t_e); M' = R_e (S_e M)
        (e00, e01, e02, e10, e11, e12, e20, e21, e22,
         sex, sey, sez) = f.e[:12]
        g_ax = e00 * g_px + e10 * g_py + e20 * g_pz
        g_ay = e01 * g_px + e11 * g_py + e21 * g_pz
        g_az = e02 * g_px + e12 * g_py + e22 * g_pz
        g_px, g_py, g_pz = g_ax * sex, g_ay * sey, g_az * sez
        e = ((e00, e01, e02), (e10, e11, e12), (e20, e21, e22))
        se = (sex, sey, sez)
        g_m = [[se[k] * (e[0][k] * g_m[0][c] + e[1][k] * g_m[1][c]
                         + e[2][k] * g_m[2][c]) for c in range(3)]
               for k in range(3)]

    # ---- M = R diag(exp(log s)) ----
    r, s = f.r, f.s
    g_rot = [[g_m[k][c] * s[c] for c in range(3)] for k in range(3)]
    for c in range(3):
        g_feats[4 + c] = (g_m[0][c] * r[0][c] + g_m[1][c] * r[1][c]
                          + g_m[2][c] * r[2][c]) * s[c]

    # ---- R(q), q = raw / |raw| with the norm held constant ----
    qx, qy, qz, qw = f.q
    g_qx = 2.0 * (qy * (g_rot[0][1] + g_rot[1][0]) + qz * (g_rot[0][2] + g_rot[2][0])
                  + qw * (g_rot[2][1] - g_rot[1][2])
                  - 2.0 * qx * (g_rot[1][1] + g_rot[2][2]))
    g_qy = 2.0 * (qx * (g_rot[0][1] + g_rot[1][0]) + qz * (g_rot[1][2] + g_rot[2][1])
                  + qw * (g_rot[0][2] - g_rot[2][0])
                  - 2.0 * qy * (g_rot[0][0] + g_rot[2][2]))
    g_qz = 2.0 * (qx * (g_rot[0][2] + g_rot[2][0]) + qy * (g_rot[1][2] + g_rot[2][1])
                  + qw * (g_rot[1][0] - g_rot[0][1])
                  - 2.0 * qz * (g_rot[0][0] + g_rot[1][1]))
    g_qw = 2.0 * (qx * (g_rot[2][1] - g_rot[1][2]) + qy * (g_rot[0][2] - g_rot[2][0])
                  + qz * (g_rot[1][0] - g_rot[0][1]))
    for i, g in enumerate((g_qx, g_qy, g_qz, g_qw)):
        g_feats[i] = g * f.q_inv

    return (torch.stack([g_px, g_py, g_pz], dim=1),
            torch.stack(g_feats, dim=1))
