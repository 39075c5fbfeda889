"""Tile binning: exact key emission -> one stable sort -> tile ranges, and
the blend slab gathered in sorted key order.

Each point in the emission mask owns one key per tile of its bbox. The
keys are emitted as exactly sum(count) rows (``cumsum`` +
``repeat_interleave``), sorted with one stable ``torch.sort``, and each
tile's range ``[tile_starts[t], tile_ends[t])`` comes from one
``searchsorted`` over the tile boundaries.

The key is the JAX package's int32 ``tile << depth_bits | depth_q`` with
``depth_bits = 31 - max(ceil(log2(num_tiles + 1)), 1)``, and the bbox
clamps and the emission order within a point (tile_u outer, tile_v inner)
are the same. So the sorted order matches whenever no two keys tie.

The JAX package emits into a padded, fixed-size tier layout (static shapes
for XLA) that can drop work; it counts what it drops in ``key_overflow``,
``big_point_overflow`` and ``tile_cap_overflow``. This module has no such
budgets: those three counters are always 0, and its output equals the JAX
output whenever JAX's three counters are 0. Where JAX truncates a splat at
its largest tier's slot count, this module emits (and the blend renders)
the splat whole.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from ..camera import CameraInfo, TILE_WIDTH, TILE_HEIGHT
from ..utils.profiling import span

# float bbox bounds are clamped into this range before the int32 cast, so
# that a huge (but finite) extent saturates instead of wrapping
_COORD_LIMIT = float(1 << 30)


class TileBinning(NamedTuple):
    sorted_key: torch.Tensor          # (MK,) int32 packed tile|depth
    sorted_point_idx: torch.Tensor    # (MK,) int32 owning point id
    sorted_valid: torch.Tensor        # (MK,) bool (all True: no padding)
    tile_starts: torch.Tensor         # (num_tiles,) int32
    tile_ends: torch.Tensor           # (num_tiles,) int32
    point_kept_keys: torch.Tensor     # (N,) int32 keys emitted per point
    total_keys: torch.Tensor          # () int32 keys emitted
    key_overflow: torch.Tensor        # () int32, always 0
    tile_cap_overflow: torch.Tensor   # () int32, always 0
    big_point_overflow: torch.Tensor  # () int32, always 0
    point_data: Optional[torch.Tensor] = None  # blend slab (only when
    #   attribute columns were passed): (16, MK) f32 wide16 (blend_cuda ROW_*
    #   layout) or (8, MK) int32 packed8 (see blend_slab)


def depth_bits_for(num_tiles: int) -> int:
    """Bits of the int32 key left for the quantized depth."""
    return 31 - max(int(math.ceil(math.log2(num_tiles + 1))), 1)


def _floor_to_int(x):
    return torch.floor(torch.clamp(x, -_COORD_LIMIT, _COORD_LIMIT)).to(
        torch.int32)


def tile_bbox(u, v, radius_x, radius_y, camera_info: CameraInfo):
    """Axis-aligned tile bbox [min, max) per axis, with a radius of at least
    one pixel; off-screen points stay in the nearest boundary tile."""
    tiles_x = camera_info.camera_width // TILE_WIDTH
    tiles_y = camera_info.camera_height // TILE_HEIGHT
    rx = torch.clamp(radius_x, min=1.0)
    ry = torch.clamp(radius_y, min=1.0)
    min_u = torch.clamp(u - rx, min=0.0)
    max_u = u + rx
    min_v = torch.clamp(v - ry, min=0.0)
    max_v = v + ry
    min_tile_u = torch.clamp(_floor_to_int(min_u / TILE_WIDTH), max=tiles_x)
    max_tile_u = _floor_to_int(max_u / TILE_WIDTH) + 1
    max_tile_u = torch.clamp(torch.maximum(max_tile_u, min_tile_u + 1),
                             max=tiles_x)
    min_tile_v = torch.clamp(_floor_to_int(min_v / TILE_HEIGHT), max=tiles_y)
    max_tile_v = _floor_to_int(max_v / TILE_HEIGHT) + 1
    max_tile_v = torch.clamp(torch.maximum(max_tile_v, min_tile_v + 1),
                             max=tiles_y)
    return min_tile_u, max_tile_u, min_tile_v, max_tile_v


def num_overlap_tiles(u, v, radius_x, radius_y, in_frustum,
                      camera_info: CameraInfo):
    """(N,) int32 exact tile-overlap counts, 0 for culled points."""
    min_u, max_u, min_v, max_v = tile_bbox(u, v, radius_x, radius_y,
                                           camera_info)
    count = (max_u - min_u) * (max_v - min_v)
    return torch.where(in_frustum, count, torch.zeros_like(count))


def _bf16_hi(x):
    """Round-to-nearest-even bf16 of f32 `x`, as the HIGH 16 bits of an
    int32 (a bf16's bits are the top half of the f32 pattern)."""
    return x.to(torch.bfloat16).to(torch.float32).view(torch.int32) & -65536


def pack_bf16_pair(hi, lo):
    """One int32 word carrying two round-to-nearest-even bf16 values."""
    return _bf16_hi(hi) | ((_bf16_hi(lo) >> 16) & 0xFFFF)


def blend_slab(attr_cols: Sequence[torch.Tensor], sorted_point_idx,
               slab_format: str = "wide16"):
    """Gather the blend slab in sorted key order.

    attr_cols: 10 per-point f32 columns (u, v, conic_a, conic_b, conic_c,
    logw, r, g, b, depth).

    - "wide16": (16, MK) f32, rows [u, v, a, b, c, logw, 0, 0, r, g, b,
      depth, 1, 0, 0, 0] (blend_cuda ROW_* layout), every value exact.
    - "packed8": (8, MK) int32, rows [u, v, a, b, c, logw] as f32 bit
      patterns, row 6 = bf16(r)|bf16(g), row 7 = bf16(b)|bf16(depth).
      Half the bytes; colours and depth carry one bf16 rounding.
    """
    u, v, ca, cb, cc, logw, cr, cg, cb_col, depth = (
        c.detach().to(torch.float32) for c in attr_cols)
    if slab_format == "packed8":
        rows = torch.stack(
            [c.view(torch.int32) for c in (u, v, ca, cb, cc, logw)]
            + [pack_bf16_pair(cr, cg), pack_bf16_pair(cb_col, depth)],
            dim=0)                                       # (8, N) int32
    elif slab_format == "wide16":
        zeros = torch.zeros_like(logw)
        rows = torch.stack([
            u, v, ca, cb, cc, logw, zeros, zeros,
            cr, cg, cb_col, depth, torch.ones_like(logw), zeros, zeros, zeros,
        ], dim=0)                                        # (16, N)
    else:
        raise ValueError(f"slab_format must be wide16|packed8, "
                         f"got {slab_format!r}")
    return torch.index_select(rows, 1, sorted_point_idx)


def bin_points_to_tiles(
    u: torch.Tensor,            # (N,)
    v: torch.Tensor,            # (N,)
    depth: torch.Tensor,        # (N,)
    radius_x: torch.Tensor,     # (N,) per-axis bbox half-extents (pixels)
    radius_y: torch.Tensor,     # (N,)
    in_frustum: torch.Tensor,   # (N,) bool emission mask
    camera_info: CameraInfo,
    depth_to_sort_key_scale: float = 100.0,
    attr_cols: Optional[Sequence[torch.Tensor]] = None,
    slab_format: str = "wide16",
) -> TileBinning:
    """Emit, sort and range the (tile, depth) keys of every point.

    attr_cols: optional 10 per-point columns; when given, the result
    carries `point_data`, the blend slab in `slab_format` (see
    `blend_slab`). Its stages are the spans `binning/emission` (around
    `binning/key count read`, where the host waits for the key count),
    `binning/sort` and `binning/gather`."""
    u, v, depth = u.detach(), v.detach(), depth.detach()
    radius_x, radius_y = radius_x.detach(), radius_y.detach()
    device = u.device
    n = u.shape[0]
    num_tiles = camera_info.num_tiles
    tiles_x = camera_info.camera_width // TILE_WIDTH
    depth_bits = depth_bits_for(num_tiles)

    with span("binning/emission"):
        min_u, max_u, min_v, max_v = tile_bbox(u, v, radius_x, radius_y,
                                               camera_info)
        dv = max_v - min_v
        count = torch.where(in_frustum, (max_u - min_u) * dv,
                            torch.zeros_like(dv))
        # truncation toward zero then clip == clip then floor, for every
        # finite depth; clamping first keeps the int cast defined
        depth_q = torch.clamp(depth * depth_to_sort_key_scale, 0.0,
                              float((1 << depth_bits) - 1)).to(torch.int32)

        # ---- exact emission: key j of point i is its slot j - first[i] --
        ends = torch.cumsum(count, 0, dtype=torch.int64)
        with span("binning/key count read"):
            total = int(ends[-1]) if n else 0
        point_of_key = torch.repeat_interleave(
            torch.arange(n, device=device), count.long(), output_size=total)
        first = ends - count
        slot = torch.arange(total, device=device) - first[point_of_key]
        dv_k = dv.long()[point_of_key]
        du_idx = torch.div(slot, dv_k, rounding_mode="floor")  # tile_u outer
        dv_idx = slot - du_idx * dv_k                           # tile_v inner
        tile = ((min_v.long()[point_of_key] + dv_idx) * tiles_x
                + min_u.long()[point_of_key] + du_idx)
        key = ((tile << depth_bits) | depth_q.long()[point_of_key]).to(
            torch.int32)

    with span("binning/sort"):
        sorted_key, order = torch.sort(key, stable=True)
        sorted_point_idx = point_of_key[order].to(torch.int32)

        boundaries = (torch.arange(num_tiles + 1, device=device,
                                   dtype=torch.int32) << depth_bits)
        edges = torch.searchsorted(sorted_key, boundaries, side="left").to(
            torch.int32)

    point_data = None
    if attr_cols is not None:
        with span("binning/gather"):
            point_data = blend_slab(attr_cols, sorted_point_idx, slab_format)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return TileBinning(
        sorted_key=sorted_key,
        sorted_point_idx=sorted_point_idx,
        sorted_valid=torch.ones((total,), dtype=torch.bool, device=device),
        tile_starts=edges[:-1],
        tile_ends=edges[1:],
        point_kept_keys=count,
        total_keys=torch.full((), total, dtype=torch.int32, device=device),
        key_overflow=zero,
        tile_cap_overflow=zero,
        big_point_overflow=zero,
        point_data=point_data,
    )
