"""Render one view: projection -> tile binning -> per-tile blend -> image.

Steps of `rasterize`:
  1. the camera inverse (ops/transforms.py inverse_SE3_qt);
  2. per-point projection, SH colour and culling (ops/projection_cuda.py:
     the CUDA kernel on the card, its plain version ops/projection.py on
     the CPU);
  3. tile binning, the depth sort and the blend slab (ops/tiling.py);
  4. the per-tile blend (ops/blend_cuda.py: the CUDA kernel on the card,
     its plain version on the CPU);
  5. the tile-to-image layout (`_tiles_to_image`).

Differentiation (the JAX package's contract): `rasterize` with
`rgb_only=False` is differentiable with respect to the point positions and
all 56 features through a `torch.autograd.Function` around the blend, whose
backward is the backward kernel (ops/blend_cuda.py blend_backward) plus the
per-point routing `_route_to_points`, and the projection's autograd node
(ops/projection_cuda.py ProjectPoints), whose backward is the projection's
backward kernel. Only the colour rows of the blend carry a
gradient: depth, count and the accumulated alpha come back detached, and
the density rescale is a constant. The rgb_only render is inference only:
its image carries no gradient. `rasterize_with_vjp` returns the forward
and an explicit `vjp_fn` that also yields the densification statistics
(`BackwardStats`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from ..camera import CameraInfo, TILE_WIDTH, TILE_HEIGHT
from ..utils.profiling import _no_mark, span
from . import blend_cuda as BC
from .projection_cuda import project_points
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


class BackwardStats(NamedTuple):
    """Per-point statistics of one backward pass, for the density
    controller (N-sized, zeros for points that emitted no key)."""
    grad_viewspace: torch.Tensor              # (N, 2) sum of dL/d(u, v)
    magnitude_grad_viewspace: torch.Tensor    # (N,) sum over pixels of
    #   |(gx, gy)|
    num_affected_pixels: torch.Tensor         # (N,) int32
    magnitude_grad_viewspace_on_image: torch.Tensor  # (H, W, 2)


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


def _project_and_bin(pointcloud, pointcloud_features, point_invalid_mask,
                     point_object_id, q_pointcloud_camera,
                     t_pointcloud_camera, camera_info, config, color_sh_mask,
                     object_edit=None, slab_format="wide16", mark=_no_mark):
    """Projection, then binning, each a span that calls `mark(stage)` when
    it ends (a timing hook, see `rasterize_with_vjp`). Returns (attrs, the
    blend's nine input columns (u, v, a, b, c, logw, r, g, b), depth,
    binning)."""
    with span("projection", mark):
        q_cam, t_cam = inverse_SE3_qt(q_pointcloud_camera,
                                      t_pointcloud_camera)
        attrs, cols = project_points(
            pointcloud, pointcloud_features, point_invalid_mask,
            point_object_id, q_cam, t_cam, t_pointcloud_camera, camera_info,
            config.near_plane, config.far_plane, color_sh_mask,
            object_edit=object_edit)
    with span("binning", mark):
        binning = bin_points_to_tiles(
            attrs.u, attrs.v, attrs.depth, attrs.radius_x, attrs.radius_y,
            attrs.emit, camera_info,
            depth_to_sort_key_scale=config.depth_to_sort_key_scale,
            attr_cols=cols + (attrs.depth,), slab_format=slab_format)
    return attrs, cols, attrs.depth, binning


def _result_from_tile_out(tile_out, attrs, binning, camera_info):
    grid = TileGrid.from_camera(camera_info)
    pix = _tiles_to_image(tile_out, grid)  # (H, W, 8)
    side = pix.detach()                    # only the image carries gradient
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
        pixel_accumulated_alpha=side[:, :, BC.OUT_ACC_ALPHA],
        nonfinite_points=attrs.nonfinite_points,
    )
    return RasterizeResult(
        image=pix[:, :, 0:3], depth=side[:, :, BC.OUT_DEPTH],
        pixel_valid_point_count=side[:, :, BC.OUT_COUNT].to(torch.int32),
        aux=aux)


def _backward_pixel_in(tile_out, g_image, grid: TileGrid):
    """The backward kernel's per-pixel input (T, 8, 256): the image
    cotangent, the forward's colour and its float `last` row, then 0 (the
    rasterizer hands the backward the exact int32 `last` beside it)."""
    g_tiles = _image_to_tiles(g_image.to(torch.float32), grid)  # (T, 3, 256)
    tile_out = tile_out.detach()
    return torch.cat([g_tiles, tile_out[:, 0:3],
                      tile_out[:, BC.OUT_LAST_EFF:BC.OUT_LAST_EFF + 1],
                      torch.zeros_like(g_tiles[:, 0:1])],
                     dim=1).contiguous()


def _backward_blend(tile_out, last, g_image, binning, grid: TileGrid):
    """The backward kernel on the image cotangent, given the forward's
    output and its int32 `last`: (per-key gradient slab (16, MK),
    per-pixel magnitude tiles (T, 8, 256))."""
    pixel_in = _backward_pixel_in(tile_out, g_image, grid)
    return BC.blend_backward(
        binning.point_data, binning.tile_starts, binning.tile_ends, pixel_in,
        num_tiles=grid.num_tiles, tiles_per_row=grid.tiles_per_row,
        last=last)


def _route_to_points(grad_data, mag_tiles, binning, grid: TileGrid, n: int):
    """Per-key gradients -> per point. Every slab column belongs to one
    point (`binning.sorted_point_idx`), so one `index_add_` sums a point's
    keys; it replaces the JAX package's sort by point id and segmented
    scan. Returns the 9 per-point cotangents of the blend's input columns
    (u, v, a, b, c, logw, r, g, b) and the BackwardStats."""
    rows = list(BC.GRAD_ROWS)
    per_point = torch.zeros((len(rows), n), dtype=torch.float32,
                            device=grad_data.device)
    per_point.index_add_(1, binning.sorted_point_idx.long(), grad_data[rows])
    row_of = {r: i for i, r in enumerate(rows)}
    cotangents = tuple(per_point[row_of[r]] for r in BC.GRAD_ROWS[:9])
    stats = BackwardStats(
        grad_viewspace=torch.stack([per_point[row_of[BC.GROW_DU]],
                                    per_point[row_of[BC.GROW_DV]]], dim=-1),
        magnitude_grad_viewspace=per_point[row_of[BC.GROW_MAG_UV]],
        num_affected_pixels=per_point[row_of[BC.GROW_NUM_PIXELS]].to(
            torch.int32),
        magnitude_grad_viewspace_on_image=_tiles_to_image(
            mag_tiles, grid)[:, :, 0:2],
    )
    return cotangents, stats


class _Blend(torch.autograd.Function):
    """The full blend (forward kernel K2) as an autograd node: its primal
    reads the slab gathered from `cols` inside the binning, and its
    backward returns the cotangents of the 9 `cols` through the backward
    kernel, which takes K2's int32 `last` (saved beside the output). Only
    the colour rows of the output carry gradient."""

    @staticmethod
    def forward(ctx, binning, grid, n, *cols):
        tile_out, last = BC.blend_forward_with_last(
            binning.point_data, binning.tile_starts, binning.tile_ends,
            num_tiles=grid.num_tiles, tiles_per_row=grid.tiles_per_row)
        ctx.binning, ctx.grid, ctx.n = binning, grid, n
        ctx.save_for_backward(tile_out, last)
        return tile_out

    @staticmethod
    def backward(ctx, g_tile_out):
        tile_out, last = ctx.saved_tensors
        g_image = _tiles_to_image(g_tile_out[:, 0:3], ctx.grid)
        grad_data, mag_tiles = _backward_blend(tile_out, last, g_image,
                                               ctx.binning, ctx.grid)
        cotangents, _ = _route_to_points(grad_data, mag_tiles, ctx.binning,
                                         ctx.grid, ctx.n)
        return (None, None, None) + cotangents


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
    mark=_no_mark,
) -> RasterizeResult:
    """Render one view on the device of `pointcloud`, in the span `frame`.

    With `config.rgb_only` the blend skips depth, count and last-key
    bookkeeping (those outputs are zeros) and reads the slab of
    `config.slab_format`; the image then carries no gradient. Otherwise it
    returns depth and count too, from the exact wide16 slab, and the image
    is differentiable with respect to `pointcloud` and
    `pointcloud_features`. `mark(stage)` is called after "projection",
    "binning" and "forward blend", as in `rasterize_with_vjp`."""
    with span("frame"):
        camera_info.validate()
        slab_format = (_resolve_slab_format(config) if config.rgb_only
                       else "wide16")
        attrs, cols, _, binning = _project_and_bin(
            pointcloud, pointcloud_features, point_invalid_mask,
            point_object_id, q_pointcloud_camera, t_pointcloud_camera,
            camera_info, config, color_sh_mask, object_edit=object_edit,
            slab_format=slab_format, mark=mark)
        grid = TileGrid.from_camera(camera_info)
        with span("forward blend", mark):
            if config.rgb_only:
                tile_out = BC.blend_forward(
                    binning.point_data, binning.tile_starts,
                    binning.tile_ends, num_tiles=grid.num_tiles,
                    tiles_per_row=grid.tiles_per_row, rgb_only=True)
            else:
                tile_out = _Blend.apply(binning, grid, pointcloud.shape[0],
                                        *cols)
            with span("forward blend/layout"):
                result = _result_from_tile_out(tile_out, attrs, binning,
                                               camera_info)
    return result


def rasterize_with_vjp(
    pointcloud, pointcloud_features, point_invalid_mask, point_object_id,
    q_pointcloud_camera, t_pointcloud_camera, camera_info, config,
    color_sh_mask=None, mark=_no_mark,
) -> Tuple[RasterizeResult, Callable]:
    """Like `rasterize` (always the full, rgb_only=False, forward), but also
    returns `vjp_fn(g_image) -> (grad_pointcloud, grad_pointcloud_features,
    BackwardStats)`, to be called once.

    The gradients are raw: the caller applies any per-group scaling or SH
    band masking. The result's tensors carry no autograd graph.

    `mark(stage)` is called after each stage ("projection", "binning",
    "forward blend"; in vjp_fn "backward blend", "routing", "projection
    backward"), so that a caller can time them on the device; each stage
    is a span of that name (`utils/profiling.py`)."""
    camera_info.validate()
    if config.rgb_only:
        config = dataclasses.replace(config, rgb_only=False)
    n = pointcloud.shape[0]
    pc = pointcloud.detach().requires_grad_(True)
    feats = pointcloud_features.detach().requires_grad_(True)
    with torch.enable_grad():
        attrs, cols, _, binning = _project_and_bin(
            pc, feats, point_invalid_mask, point_object_id,
            q_pointcloud_camera, t_pointcloud_camera, camera_info, config,
            color_sh_mask, mark=mark)
    grid = TileGrid.from_camera(camera_info)
    with span("forward blend", mark):
        tile_out, last = BC.blend_forward_with_last(
            binning.point_data, binning.tile_starts, binning.tile_ends,
            num_tiles=grid.num_tiles, tiles_per_row=grid.tiles_per_row)
        with span("forward blend/layout"):
            result = _result_from_tile_out(tile_out, attrs, binning,
                                           camera_info)

    def vjp_fn(g_image):
        with span("backward blend", mark):
            grad_data, mag_tiles = _backward_blend(tile_out, last, g_image,
                                                   binning, grid)
        with span("routing", mark):
            cotangents, stats = _route_to_points(grad_data, mag_tiles,
                                                 binning, grid, n)
        with span("projection backward", mark):
            grad_pc, grad_feats = torch.autograd.grad(cols, (pc, feats),
                                                      cotangents)
        return grad_pc, grad_feats, stats

    return result, vjp_fn
