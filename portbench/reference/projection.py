"""Plain per-point projection: a frozen copy of the port's plain version.

Copied from `taichi_3d_gaussian_splatting_torch/ops/projection.py`
(`_forward_terms`, `camera_table`, `blend_logw`) and `ops/transforms.py`
(the quaternion helpers and the Shepperd conversion), without the
object-edit branch, which the benchmark never drives. The formulas and
their order are the port's, so that depths, and with them the sort keys,
come out as the port's on the same inputs. Differentiable by autograd with
the port's conventions: the straight-through quaternion normalize, the
detached density rescale, and no gradient past a clamp below its floor.

Imports torch alone: nothing of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16
BOUNDARY_TILES = 3
COV_LOW_PASS = 0.3
ALPHA_SKIP_THRESHOLD = 1.0 / 255.0
LOG_FLOOR = 1e-30
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


class Camera(NamedTuple):
    """Pinhole intrinsics and the image size (a multiple of 16 each way)."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def tiles_x(self):
        return self.width // TILE

    @property
    def tiles_y(self):
        return self.height // TILE

    def intrinsics(self, device):
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32,
                            device=device)


class Projected(NamedTuple):
    """The blend's nine input columns and what the binning reads, (N,)."""
    cols: tuple          # u, v, conic a, b, c, logw, r, g, b
    depth: torch.Tensor
    radius_x: torch.Tensor
    radius_y: torch.Tensor
    emit: torch.Tensor   # bool
    in_frustum: torch.Tensor


def quaternion_multiply(q1, q2):
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quaternion_conjugate(q):
    return torch.cat([-q[..., 0:3], q[..., 3:4]], dim=-1)


def quaternion_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_rotate(q, v):
    qv = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    out = quaternion_multiply(quaternion_multiply(q, qv),
                              quaternion_conjugate(q))
    return out[..., :3]


def rotation_matrix_from_quaternion(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotation_matrix_to_quaternion(R):
    """Rotation matrices (..., 3, 3) -> (x, y, z, w): the branch-free
    Shepperd construction, as the port's dataset reads a pose."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    s0 = 0.5 / torch.sqrt(torch.clamp(1 + trace, min=1e-12))
    q0 = torch.stack([(R[..., 2, 1] - R[..., 1, 2]) * s0,
                      (R[..., 0, 2] - R[..., 2, 0]) * s0,
                      (R[..., 1, 0] - R[..., 0, 1]) * s0, 0.25 / s0], dim=-1)
    s1 = 2.0 * torch.sqrt(torch.clamp(
        1 + R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2], min=1e-12))
    q1 = torch.stack([0.25 * s1, (R[..., 0, 1] + R[..., 1, 0]) / s1,
                      (R[..., 0, 2] + R[..., 2, 0]) / s1,
                      (R[..., 2, 1] - R[..., 1, 2]) / s1], dim=-1)
    s2 = 2.0 * torch.sqrt(torch.clamp(
        1 + R[..., 1, 1] - R[..., 0, 0] - R[..., 2, 2], min=1e-12))
    q2 = torch.stack([(R[..., 0, 1] + R[..., 1, 0]) / s2, 0.25 * s2,
                      (R[..., 1, 2] + R[..., 2, 1]) / s2,
                      (R[..., 0, 2] - R[..., 2, 0]) / s2], dim=-1)
    s3 = 2.0 * torch.sqrt(torch.clamp(
        1 + R[..., 2, 2] - R[..., 0, 0] - R[..., 1, 1], min=1e-12))
    q3 = torch.stack([(R[..., 0, 2] + R[..., 2, 0]) / s3,
                      (R[..., 1, 2] + R[..., 2, 1]) / s3, 0.25 * s3,
                      (R[..., 1, 0] - R[..., 0, 1]) / s3], dim=-1)
    mask0 = trace > 0
    mask1 = (~mask0) & (R[..., 0, 0] > R[..., 1, 1]) & (R[..., 0, 0]
                                                        > R[..., 2, 2])
    mask2 = (~mask0) & (~mask1) & (R[..., 1, 1] > R[..., 2, 2])
    return torch.where(mask0[..., None], q0,
                       torch.where(mask1[..., None], q1,
                                   torch.where(mask2[..., None], q2, q3)))


def camera_table(q_pointcloud_camera, t_pointcloud_camera):
    """(16,) of one view: the world-to-camera rotation row-major (0-8), its
    translation (9-11), the ray origin (12-14), 0; from the camera-to-world
    pose (q (1, 4), t (1, 3)), inverted as the port's rasterizer does."""
    q_inv = quaternion_conjugate(q_pointcloud_camera)
    t_inv = -quaternion_rotate(quaternion_normalize(q_inv),
                               t_pointcloud_camera)
    R = rotation_matrix_from_quaternion(quaternion_normalize(q_inv))
    return torch.cat([R.reshape(1, 9).T, t_inv.T, t_pointcloud_camera.T,
                      torch.zeros((1, 1), dtype=torch.float32,
                                  device=q_inv.device)], dim=0)[:, 0]


def _inverse_norm(qx, qy, qz, qw):
    return torch.rsqrt(torch.clamp(qx * qx + qy * qy + qz * qz + qw * qw,
                                   min=1e-24)).detach()


def _sh_basis(x, y, z):
    return [
        SH_C0 * torch.ones_like(x), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2 * x * y, -SH_C2 * y * z, SH_C3 * z * z - SH_C3_OFFSET,
        -SH_C2 * x * z, SH_C4 * (x * x - y * y),
        SH_C5 * y * (-3.0 * x * x + y * y), SH_C6 * x * y * z,
        SH_C7 * y * (1.0 - 5.0 * z * z), SH_C8 * z * (5.0 * z * z - 3.0),
        SH_C7 * x * (1.0 - 5.0 * z * z), SH_C9 * z * (x * x - y * y),
        SH_C5 * x * (-x * x + 3.0 * y * y),
    ]


def project(pointcloud, features, invalid, q, t, cam: Camera, near, far):
    """Project every point of one view: `pointcloud` (N, 3), `features`
    (N, 56), `invalid` (N,) (nonzero = an empty slot), the camera-to-world
    pose q (1, 4), t (1, 3). Differentiable with respect to the points and
    the features."""
    table = camera_table(q, t)
    (w00, w01, w02, w10, w11, w12, w20, w21, w22,
     tcx, tcy, tcz, ox, oy, oz, _) = table
    intr = cam.intrinsics(pointcloud.device)
    fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
    px, py, pz = pointcloud[:, 0], pointcloud[:, 1], pointcloud[:, 2]
    ft = features.T

    xc = w00 * px + w01 * py + w02 * pz + tcx
    yc = w10 * px + w11 * py + w12 * pz + tcy
    zc = w20 * px + w21 * py + w22 * pz + tcz
    inv_z = 1.0 / torch.clamp(zc, min=near)
    u = fx * xc * inv_z + cx
    v = fy * yc * inv_z + cy

    q_inv = _inverse_norm(ft[0], ft[1], ft[2], ft[3])
    qx, qy, qz, qw = (ft[i] * q_inv for i in range(4))
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    sx, sy, sz = torch.exp(ft[4]), torch.exp(ft[5]), torch.exp(ft[6])
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz

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

    det_pre = cov_a * cov_c - cov_b * cov_b
    fa = cov_a + COV_LOW_PASS
    fc = cov_c + COV_LOW_PASS
    det = torch.clamp(fa * fc - cov_b * cov_b, min=COV_LOW_PASS * COV_LOW_PASS)
    rescale = torch.sqrt(torch.clamp(det_pre / det, min=0.0)).detach()
    inv_det = 1.0 / det
    conic_a = fc * inv_det
    conic_b = -cov_b * inv_det
    conic_c = fa * inv_det

    radius_x = torch.sqrt(torch.clamp(cov_a, min=0.0)) * 3.0
    radius_y = torch.sqrt(torch.clamp(cov_c, min=0.0)) * 3.0
    alpha = torch.sigmoid(ft[7])
    peak = (rescale * alpha).detach()
    r_eff = torch.sqrt(torch.clamp(
        2.0 * torch.log(255.0 * torch.clamp(peak, min=1e-30)), min=0.0))
    radius_x = torch.minimum(radius_x,
                             r_eff * torch.sqrt(torch.clamp(fa, min=0.0)))
    radius_y = torch.minimum(radius_y,
                             r_eff * torch.sqrt(torch.clamp(fc, min=0.0)))
    visible = peak >= ALPHA_SKIP_THRESHOLD

    dx, dy, dz = px - ox, py - oy, pz - oz
    dn = torch.rsqrt(dx * dx + dy * dy + dz * dz + 1e-37)
    basis = _sh_basis(dx * dn, dy * dn, dz * dn)
    color = [torch.sigmoid(sum(ft[base + i] * basis[i] for i in range(16)))
             for base in (8, 24, 40)]

    bw = bh = TILE * BOUNDARY_TILES
    in_frustum = ((zc > near) & (zc < far) & (u >= -bw)
                  & (u < cam.width + bw) & (v >= -bh) & (v < cam.height + bh)
                  & (invalid.to(torch.int32) == 0))
    finite = torch.isfinite(u) & torch.isfinite(v) & torch.isfinite(zc)
    for col in (conic_a, conic_b, conic_c, rescale, alpha, *color, radius_x,
                radius_y):
        finite = finite & torch.isfinite(col)
    logw = (torch.log(torch.clamp(rescale, min=LOG_FLOOR)).detach()
            + torch.log(torch.clamp(alpha, min=LOG_FLOOR)))
    return Projected((u, v, conic_a, conic_b, conic_c, logw, *color), zc,
                     radius_x.detach(), radius_y.detach(),
                     in_frustum & finite & visible, in_frustum)
