"""The projection and its VJP as CUDA kernels: P1 (``csrc/
projection_forward.cu``) and P2 (``csrc/projection_backward.cu``), their
wrappers, and ``ProjectPoints``, the autograd node through which the
rasterizer projects.

``project_forward`` computes every ``PointAttributes`` column of
``ops/projection.py::compute_point_attributes`` and the blend's logw column
(``blend_logw``) in one launch; ``project_backward`` the VJP of the blend's
nine input columns (u, v, conic a, b, c, logw, r, g, b) with respect to
the points and the features in one launch
(``project_points_backward_torch``). On CPU tensors both run their plain
version from ``ops/projection.py``; on CUDA tensors they launch the
kernel or raise; any other device raises. There is no fallback.

The JAX package jits this stage (``taichi_3d_gaussian_splatting_tpu/ops/
projection.py::compute_point_attributes``) and takes its VJP with
``jax.vjp``: XLA fuses both into a few loops over the points. Eager torch
does not fuse, so the port writes them as kernels.

No gradient reaches the poses or the edit transform: ``project_points``
raises if they require one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..camera import BOUNDARY_TILES, CameraInfo, TILE_HEIGHT, TILE_WIDTH
from ._build import launch, on_card
from .projection import (PointAttributes, _forward_terms,
                         backward_from_tables, blend_logw, camera_table,
                         edit_table)

NUM_FEATURES = 56
# Rows of P1's (15, N) float output, then the logw column
FLOAT_ROWS = ("u", "v", "depth", "conic_a", "conic_b", "conic_c", "rescale",
              "alpha_after_activation", "color_r", "color_g", "color_b",
              "radii", "radius_x", "radius_y", "logw")
# Rows of P1's (2, N) uint8 output
MASK_ROWS = ("in_frustum", "emit")
# The blend's input columns, in the order of its slab rows and of P2's
# cotangent rows
BLEND_COLUMNS = ("u", "v", "conic_a", "conic_b", "conic_c", "logw",
                 "color_r", "color_g", "color_b")
# ProjectPoints' outputs: the PointAttributes fields, then logw
OUTPUTS = PointAttributes._fields + ("logw",)
DIFFERENTIABLE = frozenset(BLEND_COLUMNS)


class ProjectionInputs(NamedTuple):
    """What the projection takes besides the points: the per-object
    camera table and edit table ((16, K), `ops/projection.py`), the (3, 3)
    intrinsics on the points' device, the optional (16,) SH band mask, the
    camera and the planes."""
    table: torch.Tensor
    edit: Optional[torch.Tensor]
    intrinsics: torch.Tensor
    color_sh_mask: Optional[torch.Tensor]
    camera_info: CameraInfo
    near_plane: float
    far_plane: float


def projection_inputs(q_camera_pointcloud, t_camera_pointcloud,
                      t_pointcloud_camera, camera_info, near_plane, far_plane,
                      color_sh_mask=None, object_edit=None):
    """The ProjectionInputs of a view, on the device of the poses (a few
    torch ops on K rows)."""
    device = q_camera_pointcloud.device
    table = camera_table(q_camera_pointcloud, t_camera_pointcloud,
                         t_pointcloud_camera)
    edit = edit_table(object_edit, q_camera_pointcloud.shape[0], device)
    intrinsics = torch.as_tensor(camera_info.camera_intrinsics,
                                 dtype=torch.float32, device=device)
    if color_sh_mask is not None:
        color_sh_mask = torch.as_tensor(color_sh_mask, dtype=torch.float32,
                                        device=device).contiguous()
    return ProjectionInputs(table.contiguous(),
                            None if edit is None else edit.contiguous(),
                            intrinsics.contiguous(), color_sh_mask,
                            camera_info, float(near_plane), float(far_plane))


def _check_points(pointcloud, features, object_id, inputs,
                  point_invalid_mask=None):
    n = pointcloud.shape[0]
    if pointcloud.dtype != torch.float32 or tuple(pointcloud.shape) != (n, 3):
        raise ValueError(f"pointcloud must be float32 (N, 3), got "
                         f"{pointcloud.dtype} {tuple(pointcloud.shape)}")
    if (features.dtype != torch.float32
            or tuple(features.shape) != (n, NUM_FEATURES)):
        raise ValueError(f"features must be float32 ({n}, {NUM_FEATURES}), "
                         f"got {features.dtype} {tuple(features.shape)}")
    named = [("features", features), ("point_object_id", object_id),
             ("table", inputs.table), ("intrinsics", inputs.intrinsics)]
    for name, t in (("point_invalid_mask", point_invalid_mask),
                    ("edit", inputs.edit),
                    ("color_sh_mask", inputs.color_sh_mask)):
        if t is not None:
            named.append((name, t))
    for name, t in named:
        if t.device != pointcloud.device:
            raise ValueError(f"{name} is on {t.device}, pointcloud on "
                             f"{pointcloud.device}")
    for name, t in (("point_object_id", object_id),
                    ("point_invalid_mask", point_invalid_mask)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(t.shape)}")
    k = inputs.table.shape[1]
    for name, t in (("table", inputs.table), ("edit", inputs.edit)):
        if t is not None and tuple(t.shape) != (16, k):
            raise ValueError(f"{name} must have shape (16, {k}), got "
                             f"{tuple(t.shape)}")


def _kernel_args(pointcloud, features, object_id, inputs):
    """The points as the kernels take them (contiguous; the features
    16-byte aligned, copied if not) and the arguments both kernels share;
    raises on what they do not take."""
    pointcloud = pointcloud.contiguous()
    features = features.contiguous()
    if features.data_ptr() % 16:
        features = features.clone()
    object_id = object_id.to(torch.int32).contiguous()
    mask = inputs.color_sh_mask
    if mask is not None and tuple(mask.shape) != (16,):
        raise ValueError(f"color_sh_mask must have shape (16,), got "
                         f"{tuple(mask.shape)}")
    return pointcloud, features, object_id, (
        inputs.table.data_ptr(),
        None if inputs.edit is None else inputs.edit.data_ptr(),
        inputs.table.shape[1], inputs.intrinsics.data_ptr(),
        None if mask is None else mask.data_ptr())


def project_forward(pointcloud, features, point_invalid_mask,
                    point_object_id, inputs: ProjectionInputs):
    """(PointAttributes, logw (N,)) of every point, without autograd.

    CPU tensors take the plain version (`compute_point_attributes`'s
    formulas, `blend_logw`); CUDA tensors launch P1; any other device
    raises."""
    _check_points(pointcloud, features, point_object_id, inputs,
                  point_invalid_mask)
    if not on_card(pointcloud, "project_forward"):
        with torch.no_grad():
            attrs = _forward_terms(
                pointcloud, features, point_invalid_mask, point_object_id,
                inputs.table, inputs.edit, inputs.camera_info,
                inputs.near_plane, inputs.far_plane,
                inputs.color_sh_mask).attrs
            return attrs, blend_logw(attrs.rescale,
                                     attrs.alpha_after_activation)
    device = pointcloud.device
    n = pointcloud.shape[0]
    pointcloud, features, object_id, shared = _kernel_args(
        pointcloud, features, point_object_id, inputs)
    if point_invalid_mask.dtype in (torch.bool, torch.int8, torch.uint8):
        invalid = point_invalid_mask.contiguous().view(torch.uint8)
    else:
        invalid = (point_invalid_mask != 0).to(torch.uint8)
    out = torch.empty((len(FLOAT_ROWS), n), dtype=torch.float32,
                      device=device)
    masks = torch.empty((len(MASK_ROWS), n), dtype=torch.uint8,
                        device=device)
    nonfinite = torch.empty((), dtype=torch.int32, device=device)
    cam = inputs.camera_info
    bw, bh = TILE_WIDTH * BOUNDARY_TILES, TILE_HEIGHT * BOUNDARY_TILES
    launch("project_forward", pointcloud.data_ptr(), features.data_ptr(),
           invalid.data_ptr(), object_id.data_ptr(), n, *shared,
           inputs.near_plane, inputs.far_plane, float(-bw),
           float(cam.camera_width + bw), float(-bh),
           float(cam.camera_height + bh), out.data_ptr(), masks.data_ptr(),
           nonfinite.data_ptr(), device=device)
    cols = dict(zip(FLOAT_ROWS, out))
    cols.update(zip(MASK_ROWS, masks.view(torch.bool)))
    logw = cols.pop("logw")
    return PointAttributes(nonfinite_points=nonfinite, **cols), logw


def project_backward(pointcloud, features, point_object_id,
                     inputs: ProjectionInputs, cotangents):
    """(grad_pointcloud (N, 3), grad_features (N, 56)): the VJP of the
    blend's nine columns for the cotangent rows `cotangents` (9, N) (rows
    of unit stride; any row stride).

    CPU tensors take the plain version (`project_points_backward_torch`'s
    formulas); CUDA tensors launch P2; any other device raises."""
    _check_points(pointcloud, features, point_object_id, inputs)
    n = pointcloud.shape[0]
    if (cotangents.dtype != torch.float32
            or tuple(cotangents.shape) != (len(BLEND_COLUMNS), n)
            or (n > 1 and cotangents.stride(1) != 1)
            or cotangents.device != pointcloud.device):
        raise ValueError(f"cotangents must be float32 (9, {n}) rows of unit "
                         f"stride on {pointcloud.device}, got "
                         f"{cotangents.dtype} {tuple(cotangents.shape)} "
                         f"{cotangents.stride()} on {cotangents.device}")
    if not on_card(pointcloud, "project_backward"):
        return backward_from_tables(
            pointcloud, features, point_object_id, inputs.table, inputs.edit,
            inputs.camera_info, inputs.near_plane, cotangents,
            inputs.color_sh_mask)
    device = pointcloud.device
    pointcloud, features, object_id, shared = _kernel_args(
        pointcloud, features, point_object_id, inputs)
    grad_pc = torch.empty((n, 3), dtype=torch.float32, device=device)
    grad_feats = torch.empty((n, NUM_FEATURES), dtype=torch.float32,
                             device=device)
    launch("project_backward", pointcloud.data_ptr(), features.data_ptr(),
           object_id.data_ptr(), n, *shared, inputs.near_plane,
           cotangents.data_ptr(), cotangents.stride(0) if n > 0 else 0,
           grad_pc.data_ptr(), grad_feats.data_ptr(), device=device)
    return grad_pc, grad_feats


def _cotangent_rows(grads, like):
    """The nine cotangents as one (9, N) tensor of unit-stride rows: a view
    when they are consecutive rows of one buffer (as the rasterizer's
    routing leaves them), else stacked (None as zeros)."""
    first = grads[0]
    if all(g is not None and g.dtype == torch.float32 and g.dim() == 1
           and g.stride(0) == 1 for g in grads):
        storage = first.untyped_storage().data_ptr()
        step = grads[1].storage_offset() - first.storage_offset()
        if step >= first.shape[0] and all(
                g.untyped_storage().data_ptr() == storage
                and g.storage_offset() == first.storage_offset() + k * step
                for k, g in enumerate(grads)):
            return first.as_strided((len(grads), first.shape[0]), (step, 1))
    return torch.stack([torch.zeros_like(like) if g is None else g
                        for g in grads])


class ProjectPoints(torch.autograd.Function):
    """The projection as one autograd node: forward P1 (`project_forward`),
    backward P2 (`project_backward`). Outputs: the PointAttributes fields,
    then logw (`OUTPUTS`); only the blend's nine columns carry gradient,
    the others are marked non-differentiable."""

    @staticmethod
    def forward(ctx, pointcloud, features, point_invalid_mask,
                point_object_id, inputs):
        attrs, logw = project_forward(pointcloud, features,
                                      point_invalid_mask, point_object_id,
                                      inputs)
        outputs = tuple(attrs) + (logw,)
        ctx.mark_non_differentiable(*(t for name, t in zip(OUTPUTS, outputs)
                                      if name not in DIFFERENTIABLE))
        ctx.set_materialize_grads(False)
        ctx.inputs = inputs
        ctx.save_for_backward(pointcloud, features, point_object_id)
        return outputs

    @staticmethod
    def backward(ctx, *grads):
        pointcloud, features, point_object_id = ctx.saved_tensors
        by_name = dict(zip(OUTPUTS, grads))
        cot = _cotangent_rows([by_name[c] for c in BLEND_COLUMNS],
                              pointcloud[:, 0])
        grad_pc, grad_feats = project_backward(
            pointcloud, features, point_object_id, ctx.inputs, cot)
        return (grad_pc if ctx.needs_input_grad[0] else None,
                grad_feats if ctx.needs_input_grad[1] else None,
                None, None, None)


def project_points(pointcloud, features, point_invalid_mask, point_object_id,
                   q_camera_pointcloud, t_camera_pointcloud,
                   t_pointcloud_camera, camera_info, near_plane, far_plane,
                   color_sh_mask=None, object_edit=None):
    """(PointAttributes, the blend's nine columns `BLEND_COLUMNS`) through
    `ProjectPoints`: differentiable with respect to the points and the
    features (P2 in the backward). Raises if the poses or the edit
    transform require a gradient."""
    inputs = projection_inputs(q_camera_pointcloud, t_camera_pointcloud,
                               t_pointcloud_camera, camera_info, near_plane,
                               far_plane, color_sh_mask, object_edit)
    if inputs.table.requires_grad or (inputs.edit is not None
                                      and inputs.edit.requires_grad):
        raise ValueError("the projection takes no gradient with respect to "
                         "the poses or the edit transform")
    outputs = ProjectPoints.apply(pointcloud, features, point_invalid_mask,
                                  point_object_id, inputs)
    by_name = dict(zip(OUTPUTS, outputs))
    attrs = PointAttributes(*outputs[:len(PointAttributes._fields)])
    return attrs, tuple(by_name[c] for c in BLEND_COLUMNS)
