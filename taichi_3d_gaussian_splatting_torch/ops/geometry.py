"""Auxiliary geometry on torch tensors: ray/ellipsoid intersection, the
vector from a point to a line, per-pixel ray generation. Batched over
leading axes."""

from __future__ import annotations

import torch

from ..camera import CameraInfo
from .transforms import inverse_SE3


def intersect_ray_with_ellipsoid(ray_origin, ray_direction, ellipsoid_R,
                                 ellipsoid_t, ellipsoid_S, eps: float = 1e-5):
    """Ray against ellipsoid (rotation R, centre t, axis scales S).

    Returns (has_intersection (...,) bool, the nearest intersection ahead
    of the origin (..., 3), zeros where there is none). Near-zero |A| and
    discriminants are clamped by `eps`; a grazing hit takes the smaller
    root."""
    o = ray_origin - ellipsoid_t
    # into the unit-sphere frame: S^-1 R^T x
    ot = torch.einsum("...ji,...j->...i", ellipsoid_R, o) / ellipsoid_S
    dt = (torch.einsum("...ji,...j->...i", ellipsoid_R, ray_direction)
          / ellipsoid_S)

    A = (dt * dt).sum(-1)
    A = torch.where(A.abs() < eps, torch.full_like(A, eps), A)
    B = 2.0 * (ot * dt).sum(-1)
    C = (ot * ot).sum(-1) - 1.0
    disc = B * B - 4.0 * A * C
    disc_clamped = torch.where(disc.abs() < eps, torch.zeros_like(disc),
                               torch.clamp(disc, min=0.0))
    sqrt_disc = torch.sqrt(disc_clamped)
    t1 = (-B - sqrt_disc) / (2.0 * A)
    t2 = (-B + sqrt_disc) / (2.0 * A)
    t_hit = torch.where(t1 >= 0, t1, t2)
    t_hit = torch.where((t1 - t2).abs() < eps, torch.minimum(t1, t2), t_hit)
    has_hit = (disc >= 0) & ((t1 >= 0) | (t2 >= 0))

    p_unit = ot + t_hit[..., None] * dt
    p_world = torch.einsum("...ij,...j->...i", ellipsoid_R,
                           p_unit * ellipsoid_S) + ellipsoid_t
    return has_hit, torch.where(has_hit[..., None], p_world,
                                torch.zeros_like(p_world))


def get_point_to_line_vector(point, line_origin, line_direction):
    """Vector from `point` to its projection on the line."""
    op = point - line_origin
    scale = ((op * line_direction).sum(-1)
             / (line_direction * line_direction).sum(-1))
    return point - (line_origin + scale[..., None] * line_direction)


def get_ray_origin_and_direction_from_camera(T_pointcloud_camera,
                                             camera_info: CameraInfo):
    """Rays through the pixel centres of the camera at the (4, 4) pose
    `T_pointcloud_camera`: (origin (3,), unit directions (H, W, 3))."""
    intr = torch.as_tensor(camera_info.camera_intrinsics, dtype=torch.float32,
                           device=T_pointcloud_camera.device)
    fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
    h, w = camera_info.camera_height, camera_info.camera_width
    dev = T_pointcloud_camera.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    ones = torch.ones((h, w), dtype=torch.float32, device=dev)
    dir_cam = torch.stack([((u - cx) / fx).expand(h, w),
                           ((v - cy) / fy).expand(h, w), ones], dim=-1)
    direction = torch.einsum("ij,hwj->hwi", T_pointcloud_camera[:3, :3],
                             dir_cam)
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    return T_pointcloud_camera[:3, 3], direction


def get_ray_origin_and_direction_by_uv(pixel_u, pixel_v, camera_intrinsics,
                                       T_camera_pointcloud):
    """The ray through pixel (u, v), from the camera-from-world transform:
    (origin (..., 3), unit direction (..., 3))."""
    intr = torch.as_tensor(camera_intrinsics, dtype=torch.float32,
                           device=T_camera_pointcloud.device)
    fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
    pixel_u = torch.as_tensor(pixel_u, dtype=torch.float32, device=intr.device)
    pixel_v = torch.as_tensor(pixel_v, dtype=torch.float32, device=intr.device)
    dir_cam = torch.stack([(pixel_u + 0.5 - cx) / fx,
                           (pixel_v + 0.5 - cy) / fy,
                           torch.ones_like(pixel_u)], dim=-1)
    T_pc = inverse_SE3(T_camera_pointcloud)
    direction = torch.einsum("...ij,...j->...i", T_pc[..., :3, :3], dir_cam)
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    return T_pc[..., :3, 3], direction
