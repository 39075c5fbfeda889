"""Render one view: projection -> tile binning -> per-tile blend -> image.

Steps of `rasterize`:
  1. the camera inverse (ops/transforms.py inverse_SE3_qt);
  2. per-point projection, SH colour and culling (ops/projection.py);
  3. tile binning, the depth sort and the blend slab (ops/tiling.py);
  4. the per-tile blend (ops/blend_cuda.py: the CUDA kernel on the card,
     its plain version on the CPU);
  5. the tile-to-image layout (`_tiles_to_image`).

This is the forward render only. Gradients through the blend (the
backward kernel and the per-point gradient routing) are not ported yet, so
`rasterize` refuses inputs that require grad rather than return wrong
gradients.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..camera import CameraInfo, TILE_WIDTH, TILE_HEIGHT
from . import blend_cuda as BC
from .projection import compute_point_attributes
from .tiling import bin_points_to_tiles
from .transforms import inverse_SE3_qt


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    """Rasterizer settings, with the JAX package's field names so that any
    of its configs converts through `dataclasses.asdict`.

    The fields below `grad_alpha_factor` are that package's static-shape
    budgets and layout knobs. This port emits every key exactly and has no
    budgets, so it accepts and ignores them (`slab_format` aside)."""
    near_plane: float = 0.8
    far_plane: float = 1000.0
    depth_to_sort_key_scale: float = 100.0
    rgb_only: bool = False
    grad_color_factor: float = 5.0
    grad_high_order_color_factor: float = 1.0
    grad_s_factor: float = 0.5
    grad_q_factor: float = 1.0
    grad_alpha_factor: float = 20.0
    # accepted and ignored (no static-shape budgets here)
    max_tiles_per_point: int = 32
    big_point_divisor: int = 16
    mid_point_divisor: int = 4
    max_keys: int = 2 ** 21
    chunk: int = 128
    max_tiles_per_huge_point: int = 0
    huge_pool_size: int = 256
    pool_slots: tuple = ()
    pool_caps: tuple = ()
    slab_gather: str = "row"
    tier_a_cap: int = 0
    pool_meta: str = "auto"
    # blend-slab layout of the rgb_only path: "wide16" is the exact (16, MK)
    # f32 slab; "packed8" the (8, MK) int32 slab with colours and depth in
    # round-to-nearest bf16 (geometry and alpha stay exact f32); "auto" =
    # packed8. The full (rgb_only=False) render always uses wide16.
    slab_format: str = "auto"


class RasterizerAux(NamedTuple):
    """Non-differentiable side outputs."""
    in_frustum: torch.Tensor           # (N,) bool
    point_uv: torch.Tensor             # (N, 2)
    point_depth: torch.Tensor          # (N,)
    num_overlap_tiles: torch.Tensor    # (N,) int32
    total_keys: torch.Tensor           # () int32
    key_overflow: torch.Tensor         # () int32, always 0
    big_point_overflow: torch.Tensor   # () int32, always 0
    tile_cap_overflow: torch.Tensor    # () int32, always 0
    pixel_accumulated_alpha: torch.Tensor  # (H, W)
    nonfinite_points: torch.Tensor     # () int32 culled non-finite splats


class RasterizeResult(NamedTuple):
    image: torch.Tensor                # (H, W, 3)
    depth: torch.Tensor                # (H, W)
    pixel_valid_point_count: torch.Tensor  # (H, W) int32
    aux: RasterizerAux


class TileGrid(NamedTuple):
    """Static view of the tile layout."""
    height: int
    width: int
    tiles_per_row: int
    tiles_per_col: int

    @property
    def num_tiles(self):
        return self.tiles_per_row * self.tiles_per_col

    @staticmethod
    def from_camera(camera_info: CameraInfo) -> "TileGrid":
        return TileGrid(camera_info.camera_height, camera_info.camera_width,
                        camera_info.tiles_per_row, camera_info.tiles_per_col)


def _tiles_to_image(tile_out, grid: TileGrid):
    """(num_tiles, C, 256) -> (H, W, C) pixel-major."""
    c = tile_out.shape[1]
    x = tile_out.reshape(grid.tiles_per_col, grid.tiles_per_row, c,
                         TILE_HEIGHT, TILE_WIDTH)
    x = x.permute(0, 3, 1, 4, 2)
    return x.reshape(grid.height, grid.width, c)


def _image_to_tiles(image, grid: TileGrid):
    """(H, W, C) -> (num_tiles, C, 256)."""
    c = image.shape[-1]
    x = image.reshape(grid.tiles_per_col, TILE_HEIGHT, grid.tiles_per_row,
                      TILE_WIDTH, c)
    x = x.permute(0, 2, 4, 1, 3)
    return x.reshape(grid.num_tiles, c, TILE_HEIGHT * TILE_WIDTH)


def _resolve_slab_format(config: RasterizerConfig) -> str:
    """The rgb_only blend-slab layout: "auto" = packed8."""
    if config.slab_format == "auto":
        return "packed8"
    if config.slab_format not in ("wide16", "packed8"):
        raise ValueError(f"slab_format must be auto|wide16|packed8, "
                         f"got {config.slab_format!r}")
    return config.slab_format


def _blend_inputs_from_attrs(attrs):
    """The blend's input columns: (u, v, a, b, c, logw, r, g, b) and depth,
    with logw = log(rescale) + log(sigmoid(alpha)), rescale without
    gradient."""
    rescale_log = torch.log(torch.clamp(attrs.rescale, min=1e-30)).detach()
    logw = rescale_log + torch.log(
        torch.clamp(attrs.alpha_after_activation, min=1e-30))
    cols = (attrs.u, attrs.v, attrs.conic_a, attrs.conic_b, attrs.conic_c,
            logw, attrs.color_r, attrs.color_g, attrs.color_b)
    return cols, attrs.depth.detach()


def _project_and_bin(pointcloud, pointcloud_features, point_invalid_mask,
                     point_object_id, q_pointcloud_camera,
                     t_pointcloud_camera, camera_info, config, color_sh_mask,
                     object_edit=None, slab_format="wide16"):
    q_cam, t_cam = inverse_SE3_qt(q_pointcloud_camera, t_pointcloud_camera)
    attrs = compute_point_attributes(
        pointcloud, pointcloud_features, point_invalid_mask, point_object_id,
        q_cam, t_cam, t_pointcloud_camera, camera_info,
        config.near_plane, config.far_plane, color_sh_mask,
        object_edit=object_edit)
    cols, depth = _blend_inputs_from_attrs(attrs)
    binning = bin_points_to_tiles(
        attrs.u, attrs.v, attrs.depth, attrs.radius_x, attrs.radius_y,
        attrs.emit, camera_info,
        depth_to_sort_key_scale=config.depth_to_sort_key_scale,
        attr_cols=cols + (depth,), slab_format=slab_format)
    return attrs, cols, depth, binning


def _result_from_tile_out(tile_out, attrs, binning, camera_info):
    grid = TileGrid.from_camera(camera_info)
    pix = _tiles_to_image(tile_out, grid)  # (H, W, 8)
    aux = RasterizerAux(
        in_frustum=attrs.in_frustum,
        point_uv=attrs.uv.detach(),
        point_depth=attrs.depth.detach(),
        # exact emission: a point's key count is its tile-overlap count
        num_overlap_tiles=binning.point_kept_keys,
        total_keys=binning.total_keys,
        key_overflow=binning.key_overflow,
        big_point_overflow=binning.big_point_overflow,
        tile_cap_overflow=binning.tile_cap_overflow,
        pixel_accumulated_alpha=pix[:, :, BC.OUT_ACC_ALPHA],
        nonfinite_points=attrs.nonfinite_points,
    )
    return RasterizeResult(
        image=pix[:, :, 0:3], depth=pix[:, :, BC.OUT_DEPTH],
        pixel_valid_point_count=pix[:, :, BC.OUT_COUNT].to(torch.int32),
        aux=aux)


def rasterize(
    pointcloud: torch.Tensor,           # (N, 3)
    pointcloud_features: torch.Tensor,  # (N, 56)
    point_invalid_mask: torch.Tensor,   # (N,)
    point_object_id: torch.Tensor,      # (N,) int32
    q_pointcloud_camera: torch.Tensor,  # (K, 4)
    t_pointcloud_camera: torch.Tensor,  # (K, 3)
    camera_info: CameraInfo,
    config: RasterizerConfig,
    color_sh_mask=None,                 # optional (16,) band curriculum mask
    object_edit=None,                   # optional (q (K,4), s (K,3), t (K,3))
    #   per-object scene-editing transform (see ops/projection.py)
) -> RasterizeResult:
    """Render one view on the device of `pointcloud`.

    With `config.rgb_only` the blend skips depth, count and last-key
    bookkeeping (those outputs are zeros) and reads the slab of
    `config.slab_format`; otherwise it returns depth and count too, from the
    exact wide16 slab. Forward only: raises NotImplementedError when an
    input requires grad."""
    camera_info.validate()
    if torch.is_grad_enabled() and (pointcloud.requires_grad
                                    or pointcloud_features.requires_grad):
        raise NotImplementedError(
            "rasterize is forward-only in taichi_3d_gaussian_splatting_torch:"
            " the blend's backward kernel and gradient routing belong to the"
            " training step (slice 2 in ROADMAP.md) and are not ported yet;"
            " call it under torch.no_grad() or on tensors that do not "
            "require grad")
    slab_format = (_resolve_slab_format(config) if config.rgb_only
                   else "wide16")
    attrs, _, _, binning = _project_and_bin(
        pointcloud, pointcloud_features, point_invalid_mask, point_object_id,
        q_pointcloud_camera, t_pointcloud_camera, camera_info, config,
        color_sh_mask, object_edit=object_edit, slab_format=slab_format)
    grid = TileGrid.from_camera(camera_info)
    tile_out = BC.blend_forward(
        binning.point_data, binning.tile_starts, binning.tile_ends,
        num_tiles=grid.num_tiles, tiles_per_row=grid.tiles_per_row,
        rgb_only=config.rgb_only)
    return _result_from_tile_out(tile_out, attrs, binning, camera_info)
