"""Quaternion / SE(3) math on torch tensors.

- quaternion layout is (x, y, z, w) throughout;
- ``rotation_matrix_from_quaternion`` assumes a unit quaternion;
- ``rotation_matrix_to_quaternion`` is the branch-free 4-case Shepperd
  construction, selecting the same branch per element as the JAX package.

All functions are batched over leading axes.
"""

from __future__ import annotations

import torch


def quaternion_multiply(q1, q2):
    """Hamilton product with (x, y, z, w) layout."""
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


def quaternion_rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q."""
    qv = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    out = quaternion_multiply(quaternion_multiply(q, qv),
                              quaternion_conjugate(q))
    return out[..., :3]


def quaternion_normalize(q, eps: float = 0.0):
    norm = torch.linalg.norm(q, dim=-1, keepdim=True)
    if eps:
        norm = torch.clamp(norm, min=eps)
    return q / norm


def rotation_matrix_from_quaternion(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def transform_matrix_from_quaternion_and_translation(q, t):
    """(q, t) -> 4x4 SE(3) matrix."""
    R = rotation_matrix_from_quaternion(q)
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def inverse_SE3(transform):
    """Invert 4x4 SE(3) matrices."""
    R_T = transform[..., :3, :3].transpose(-1, -2)
    t = transform[..., :3, 3]
    t_inv = -(R_T * t[..., None, :]).sum(-1)
    top = torch.cat([R_T, t_inv[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=transform.dtype,
                          device=transform.device).expand(
                              transform.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def inverse_SE3_qt(q, t):
    """Invert an SE(3) given as (quaternion, translation)."""
    q_inv = quaternion_conjugate(q)
    t_inv = -quaternion_rotate(quaternion_normalize(q_inv), t)
    return q_inv, t_inv


def rotation_matrix_to_quaternion(R):
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4), (x,y,z,w).

    Branch-free 4-case Shepperd method: every branch is evaluated and the
    right one selected per element."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]

    # Branch 0: trace > 0
    s0 = 0.5 / torch.sqrt(torch.clamp(1 + trace, min=1e-12))
    q0 = torch.stack([
        (R[..., 2, 1] - R[..., 1, 2]) * s0,
        (R[..., 0, 2] - R[..., 2, 0]) * s0,
        (R[..., 1, 0] - R[..., 0, 1]) * s0,
        0.25 / s0,
    ], dim=-1)

    # Branch 1: R00 largest diagonal
    s1 = 2.0 * torch.sqrt(torch.clamp(
        1 + R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2], min=1e-12))
    q1 = torch.stack([
        0.25 * s1,
        (R[..., 0, 1] + R[..., 1, 0]) / s1,
        (R[..., 0, 2] + R[..., 2, 0]) / s1,
        (R[..., 2, 1] - R[..., 1, 2]) / s1,
    ], dim=-1)

    # Branch 2: R11 largest diagonal
    s2 = 2.0 * torch.sqrt(torch.clamp(
        1 + R[..., 1, 1] - R[..., 0, 0] - R[..., 2, 2], min=1e-12))
    q2 = torch.stack([
        (R[..., 0, 1] + R[..., 1, 0]) / s2,
        0.25 * s2,
        (R[..., 1, 2] + R[..., 2, 1]) / s2,
        (R[..., 0, 2] - R[..., 2, 0]) / s2,
    ], dim=-1)

    # Branch 3: R22 largest diagonal
    s3 = 2.0 * torch.sqrt(torch.clamp(
        1 + R[..., 2, 2] - R[..., 0, 0] - R[..., 1, 1], min=1e-12))
    q3 = torch.stack([
        (R[..., 0, 2] + R[..., 2, 0]) / s3,
        (R[..., 1, 2] + R[..., 2, 1]) / s3,
        0.25 * s3,
        (R[..., 1, 0] - R[..., 0, 1]) / s3,
    ], dim=-1)

    mask0 = trace > 0
    mask1 = (~mask0) & (R[..., 0, 0] > R[..., 1, 1]) & (R[..., 0, 0] > R[..., 2, 2])
    mask2 = (~mask0) & (~mask1) & (R[..., 1, 1] > R[..., 2, 2])

    return torch.where(mask0[..., None], q0,
                       torch.where(mask1[..., None], q1,
                                   torch.where(mask2[..., None], q2, q3)))


def SE3_to_quaternion_and_translation(transform):
    """4x4 SE(3) (..., 4, 4) -> (q (..., 4), t (..., 3))."""
    return (rotation_matrix_to_quaternion(transform[..., :3, :3]),
            transform[..., :3, 3])
