"""Per-tile front-to-back alpha blend and its backward: the CUDA kernels'
wrappers and their plain PyTorch versions.

Each pixel (16x16 tiles, pixel p = v_in * 16 + u_in, centre +0.5) walks
its tile's depth-sorted key range ``[tile_starts[t], tile_ends[t])`` of
the blend slab in order:

- alpha = exp(-0.5 (a dx^2 + c dy^2) - b dx dy + logw), dx, dy = pixel - mean;
- the key is skipped if alpha < 1/255, and alpha is clamped at 0.99;
- if T (1 - alpha) < 1e-4 the pixel is done and this key does not
  contribute;
- otherwise w = alpha T is accumulated with the key's colour, and
  T <- T (1 - alpha).

Output per tile, (num_tiles, 8, 256) f32, rows ``OUT_*``:
[r, g, b, depth, 1 - T, sum w, last + 1, count]. With ``rgb_only`` the
depth, last and count rows are 0. ``depth`` is sum(w d) / max(sum w, 1e-6);
``last`` is the slab column of the last contributing key and ``count`` the
number of contributing keys.

The backward (``blend_backward``) replays the blend per pixel over the keys
the forward blended (not skipped, and below the forward's ``last``) and
returns per key the gradient slab rows ``GROW_*`` and per pixel the sums of
|gx| and |gy| (see ``blend_backward_torch``).

The kernels (``csrc/blend_forward.cu``, ``csrc/blend_backward.cu``) cut
each tile's range into chunks of at most ``CHUNK_KEYS`` keys (the work
list of ``build_work_list``, whose plain version is ``chunk_work_list``),
blend the chunks of one tile in separate blocks from each chunk's
transmittance at its start, and merge them in chunk order; the plain
versions stay sequential and are the yardstick of correctness.

``blend_forward`` and ``blend_backward`` run their kernel on CUDA tensors
and the plain version on CPU tensors; any other device raises. There is no
fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..camera import TILE_WIDTH, TILE_HEIGHT
from .gaussian import ALPHA_SKIP_THRESHOLD

# Row layout of the (16, MK) f32 wide16 slab
ROW_U = 0
ROW_V = 1
ROW_A = 2      # conic a
ROW_B = 3      # conic b
ROW_C = 4      # conic c
ROW_LOGW = 5   # log(rescale * sigmoid(alpha_logit))
# rows 6..7 padding
ROW_R = 8
ROW_G = 9
ROW_B_COL = 10
ROW_DEPTH = 11
ROW_ONE = 12
NUM_DATA_ROWS = 16
# packed8 slab: 8 int32 rows [u, v, a, b, c, logw (f32 bit patterns),
# bf16(r)|bf16(g), bf16(b)|bf16(depth)] (see ops/tiling.py blend_slab)
PACKED_DATA_ROWS = 8

PIXELS_PER_TILE = TILE_WIDTH * TILE_HEIGHT  # 256

ALPHA_CLAMP = 0.99
TRANSMITTANCE_SATURATION = 1e-4

# Forward per-tile output rows in the (num_tiles, 8, 256) buffer
(OUT_R, OUT_G, OUT_B, OUT_DEPTH, OUT_ACC_ALPHA, OUT_NORM, OUT_LAST_EFF,
 OUT_COUNT) = range(8)

# Row of the backward's (num_tiles, 8, 256) per-pixel input [g_r, g_g,
# g_b, C_r, C_g, C_b, last, 0] that holds the forward's OUT_LAST_EFF
PIXEL_IN_LAST = 6

# Rows of the backward's (16, MK) per-key gradient slab (rows 6, 7 and
# 13..15 stay 0)
GROW_DU = 0
GROW_DV = 1
GROW_DA = 2
GROW_DB = 3
GROW_DC = 4
GROW_DLOGW = 5
GROW_DR = 8
GROW_DG = 9
GROW_DB_COL = 10
GROW_MAG_UV = 11       # sum over pixels of |(gx, gy)|
GROW_NUM_PIXELS = 12   # number of pixels the key contributed to
GRAD_ROWS = (GROW_DU, GROW_DV, GROW_DA, GROW_DB, GROW_DC, GROW_DLOGW,
             GROW_DR, GROW_DG, GROW_DB_COL, GROW_MAG_UV, GROW_NUM_PIXELS)

# Kernel launches per kernel (the forward per variant), counted by the
# wrappers only when they launch a CUDA kernel (never for a plain version).
launch_counts = {"blend_forward_rgb": 0, "blend_forward": 0,
                 "blend_backward": 0}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


# Keys per chunk of the kernels' work list (passed to every launch). At
# least the 430k scene's longest tile segment at 976x544 (664 keys), so that
# scene blends in one pass with no merge; short enough that the 1.03M heavy
# scene's 22,500-key tile becomes 30 chunks, each about as long as an
# ordinary tile.
CHUNK_KEYS = 768
# Rows of the forward's per-chunk partials of a split tile (r, g, b, sum w,
# sum w d, last, count, T at its end, state; csrc/blend_forward.cu PartRow)
PARTIAL_ROWS = 9
# The backward reads the forward's `last` as a float, exact below 2**24
MAX_BACKWARD_COLUMNS = 2 ** 24

# Rows of the (5, num_items) int32 work list
ITEM_TILE, ITEM_START, ITEM_END, ITEM_INDEX, ITEM_COUNT = range(5)


class ChunkWorkList(NamedTuple):
    """The kernels' work: each tile's range, clamped into [0, mk], cut into
    chunks of at most `chunk` keys, one item each (an empty tile is one
    empty item). Tiles of more than one chunk ("split" tiles) come first,
    each group in tile order; a tile's items are consecutive.

    items: (5, num_items) int32, rows ITEM_*: tile (-1 past the last item),
      first key, end key, chunk index j in the tile, chunk count n.
    num_items and num_split_items are host integers, bounds that hold for
    disjoint ranges within [0, mk] (the binning's), found without a host
    sync: num_items >= the items, num_split_items >= the items of split
    tiles. A split tile has l > chunk keys and ceil(l / chunk) < 2 l / chunk
    items, and the ranges hold at most mk keys together."""
    items: torch.Tensor
    num_items: int
    num_split_items: int


def _work_bounds(num_tiles, mk, chunk):
    num_items = num_tiles + mk // chunk
    return num_items, min(num_items, 2 * mk // chunk)


def chunk_work_list(tile_starts, tile_ends, mk, chunk=CHUNK_KEYS):
    """Plain version of the kernels' work-list builder
    (csrc/blend_common.cuh build_work_kernel) for the ranges
    [tile_starts, tile_ends) over a slab of `mk` columns, on their device,
    with no host sync."""
    num_tiles = tile_starts.shape[0]
    num_items, num_split = _work_bounds(num_tiles, mk, chunk)
    start = tile_starts.long().clamp(0, mk)
    end = torch.maximum(tile_ends.long().clamp(max=mk), start)
    n = torch.clamp((end - start + (chunk - 1)) // chunk, min=1)
    order = torch.sort((n == 1).to(torch.uint8), stable=True).indices
    n_ord = n[order]
    stop = torch.cumsum(n_ord, 0)
    i = torch.arange(num_items, device=tile_starts.device)
    pos = torch.searchsorted(stop, i, right=True)
    valid = pos < num_tiles
    pos = pos.clamp(max=num_tiles - 1)
    tile = order[pos]
    j = i - (stop[pos] - n_ord[pos])
    item_start = start[tile] + j * chunk
    items = torch.stack([tile, item_start,
                         torch.minimum(item_start + chunk, end[tile]), j,
                         n_ord[pos]])
    items = torch.where(valid[None], items, torch.zeros_like(items))
    items[ITEM_TILE] = torch.where(valid, tile, -1)
    return ChunkWorkList(items.to(torch.int32), num_items, num_split)


def _work_scratch(num_tiles, mk, device):
    """(ChunkWorkList with its items uninitialised, per-tile counters) for
    the kernels to fill."""
    num_items, num_split = _work_bounds(num_tiles, mk, CHUNK_KEYS)
    items = torch.empty((5, num_items), dtype=torch.int32, device=device)
    counters = torch.empty(num_tiles, dtype=torch.int32, device=device)
    return ChunkWorkList(items, num_items, num_split), counters


def build_work_list(tile_starts, tile_ends, mk):
    """The ChunkWorkList at CHUNK_KEYS of int32 ranges (num_tiles >= 1),
    as the blend kernels build it at the start of each launch: CPU tensors
    take the plain version; CUDA tensors launch the builder kernel; any
    other device raises."""
    device = tile_starts.device
    if device.type == "cpu":
        return chunk_work_list(tile_starts, tile_ends, mk)
    if device.type != "cuda":
        raise RuntimeError(f"build_work_list runs on cpu or cuda tensors, "
                           f"got {device}")
    from ._build import load_library
    lib = load_library()
    num_tiles = tile_starts.shape[0]
    work, counters = _work_scratch(num_tiles, mk, device)
    with torch.cuda.device(device):
        err = lib.t3dgs_build_work_list(
            tile_starts.data_ptr(), tile_ends.data_ptr(), num_tiles, mk,
            CHUNK_KEYS, counters.data_ptr(), work.items.data_ptr(), work.num_items,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"work-list kernel launch failed: CUDA error {err}")
    return work


def _slab_columns(point_data):
    """Slab -> the 10 f32 rows (u, v, a, b, c, logw, r, g, b, depth)."""
    if point_data.dtype == torch.float32:
        return tuple(point_data[r] for r in (
            ROW_U, ROW_V, ROW_A, ROW_B, ROW_C, ROW_LOGW,
            ROW_R, ROW_G, ROW_B_COL, ROW_DEPTH))
    head = tuple(point_data[r].view(torch.float32) for r in range(6))
    rg, bd = point_data[6], point_data[7]
    hi = -65536
    return head + ((rg & hi).view(torch.float32),
                   (rg << 16).view(torch.float32),
                   (bd & hi).view(torch.float32),
                   (bd << 16).view(torch.float32))


def _pixel_centres(num_tiles, tiles_per_row, device):
    """(num_tiles, 256) f32 x and y of every tile pixel's centre."""
    t_idx = torch.arange(num_tiles, device=device)
    p_idx = torch.arange(PIXELS_PER_TILE, device=device)
    px = ((t_idx % tiles_per_row) * TILE_WIDTH)[:, None] + (
        p_idx % TILE_WIDTH)[None, :] + 0.5
    py = ((t_idx // tiles_per_row) * TILE_HEIGHT)[:, None] + (
        p_idx // TILE_WIDTH)[None, :] + 0.5
    return px.to(torch.float32), py.to(torch.float32)


def _alpha_exp(cols, k, px, py):
    """exp(exponent) of key k[t] at every pixel of tile t, and dx, dy."""
    u, v, ca, cb, cc, logw = (x[k][:, None] for x in cols[:6])
    dx = px - u
    dy = py - v
    return torch.exp(-0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                     + logw), dx, dy


def blend_forward_torch(point_data, tile_starts, tile_ends, *,
                        num_tiles, tiles_per_row, rgb_only):
    """Plain PyTorch version of the blend kernel, same inputs and output.

    Vectorised over all (num_tiles, 256) pixels; loops in Python over the
    key position j within each tile's segment, up to the longest segment,
    gathering key j of every tile at once."""
    device = point_data.device
    cols = _slab_columns(point_data)
    cr, cg, cbc, dep = cols[6:]
    starts = tile_starts.long()
    seg_len = (tile_ends - tile_starts).long()
    px, py = _pixel_centres(num_tiles, tiles_per_row, device)

    shape = (num_tiles, PIXELS_PER_TILE)
    T = torch.ones(shape, dtype=torch.float32, device=device)
    done = torch.zeros(shape, dtype=torch.bool, device=device)
    acc = torch.zeros((5,) + shape, dtype=torch.float32, device=device)
    last = torch.zeros(shape, dtype=torch.float32, device=device)
    count = torch.zeros(shape, dtype=torch.float32, device=device)
    max_len = int(seg_len.max()) if num_tiles else 0
    for j in range(max_len):
        in_seg = (j < seg_len)[:, None]
        k = torch.where(j < seg_len, starts + j, torch.zeros_like(starts))

        def col(x):
            return x[k][:, None]

        alpha = _alpha_exp(cols, k, px, py)[0]
        live = in_seg & ~done & (alpha >= ALPHA_SKIP_THRESHOLD)
        alpha = torch.clamp(alpha, max=ALPHA_CLAMP)
        t_next = T * (1.0 - alpha)
        saturates = live & (t_next < TRANSMITTANCE_SATURATION)
        contrib = live & ~saturates
        done = done | saturates
        w = torch.where(contrib, alpha * T, torch.zeros_like(T))
        acc = acc + w[None] * torch.stack(
            [col(cr), col(cg), col(cbc), col(dep),
             torch.ones_like(col(dep))])
        T = torch.where(contrib, t_next, T)
        if not rgb_only:
            last = torch.where(contrib, (k[:, None] + 1).to(torch.float32),
                               last)
            count = count + contrib.to(torch.float32)

    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    if rgb_only:
        depth, last, count = zero, zero, zero
    else:
        depth = acc[3] / torch.clamp(acc[4], min=1e-6)
    return torch.stack([acc[0], acc[1], acc[2], depth, 1.0 - T, acc[4],
                        last, count], dim=1)


def _check_inputs(point_data, tile_starts, tile_ends, num_tiles, rgb_only):
    if point_data.dim() != 2:
        raise ValueError(f"point_data must be 2-D, got {tuple(point_data.shape)}")
    rows = point_data.shape[0]
    if rows == NUM_DATA_ROWS:
        if point_data.dtype != torch.float32:
            raise TypeError(f"wide16 slab must be float32, got "
                            f"{point_data.dtype}")
    elif rows == PACKED_DATA_ROWS:
        if point_data.dtype != torch.int32:
            raise TypeError(f"packed8 slab must be int32, got "
                            f"{point_data.dtype}")
        if not rgb_only:
            raise ValueError("the packed8 slab is rgb_only only")
    else:
        raise ValueError(f"slab must have {NUM_DATA_ROWS} (wide16) or "
                         f"{PACKED_DATA_ROWS} (packed8) rows, got {rows}")
    for name, t in (("tile_starts", tile_starts), ("tile_ends", tile_ends)):
        if t.dtype != torch.int32 or tuple(t.shape) != (num_tiles,):
            raise ValueError(f"{name} must be int32 of shape ({num_tiles},),"
                             f" got {t.dtype} {tuple(t.shape)}")
        if t.device != point_data.device:
            raise ValueError(f"{name} is on {t.device}, point_data on "
                             f"{point_data.device}")
    for name, t in (("point_data", point_data), ("tile_starts", tile_starts),
                    ("tile_ends", tile_ends)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if num_tiles < 1:
        raise ValueError(f"num_tiles must be >= 1, got {num_tiles}")


def blend_forward(point_data, tile_starts, tile_ends, *,
                  num_tiles, tiles_per_row, rgb_only):
    """Blend every tile. point_data: (16, MK) f32 wide16 or (8, MK) int32
    packed8 slab, columns in sorted key order; tile_starts/ends: (num_tiles,)
    int32, all contiguous. Returns (num_tiles, 8, 256) f32 (rows OUT_*).

    CPU tensors take the plain version; CUDA tensors launch the kernel;
    any other device raises."""
    _check_inputs(point_data, tile_starts, tile_ends, num_tiles, rgb_only)
    device = point_data.device
    if device.type == "cpu":
        return blend_forward_torch(point_data, tile_starts, tile_ends,
                                   num_tiles=num_tiles,
                                   tiles_per_row=tiles_per_row,
                                   rgb_only=rgb_only)
    if device.type != "cuda":
        raise RuntimeError(f"blend_forward runs on cpu or cuda tensors, "
                           f"got {device}")
    from ._build import load_library
    lib = load_library()
    mk = point_data.shape[1]
    work, counters = _work_scratch(num_tiles, mk, device)
    out = torch.empty((num_tiles, 8, PIXELS_PER_TILE), dtype=torch.float32,
                      device=device)
    # per item of a split tile: T_chunk, and the partials
    scratch = max(work.num_split_items, 1)
    tchunk = torch.empty((scratch, PIXELS_PER_TILE), dtype=torch.float32,
                         device=device)
    partial = torch.empty((scratch, PARTIAL_ROWS, PIXELS_PER_TILE),
                          dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.t3dgs_blend_forward(
            point_data.data_ptr(), tile_starts.data_ptr(),
            tile_ends.data_ptr(), num_tiles, CHUNK_KEYS, work.items.data_ptr(),
            work.num_items, work.num_split_items, counters.data_ptr(),
            tchunk.data_ptr(), partial.data_ptr(), out.data_ptr(), mk,
            tiles_per_row, int(point_data.shape[0] == PACKED_DATA_ROWS),
            int(rgb_only), stream)
    if err != 0:
        raise RuntimeError(f"blend_forward kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["blend_forward_rgb" if rgb_only else "blend_forward"] += 1
    return out


def blend_backward_torch(point_data, tile_starts, tile_ends, pixel_in, *,
                         num_tiles, tiles_per_row, dtype=torch.float32):
    """Plain PyTorch version of the backward kernel, same inputs and outputs.

    Replays the forward per pixel (vectorised over all (num_tiles, 256)
    pixels, one Python iteration per key position of the longest segment)
    over the keys the forward blended: not skipped (alpha >= 1/255) and
    below the forward's `last` (pixel_in row 6; for the sequential forward
    every key between the last contributing key and the saturating one is
    skipped, so no saturation test is needed). For each such key i:
      dL/dalpha_i = c_i.g T_i - (S - P_i) / (1 - alpha_i), with S = g.C and
      P_i = sum_{j<=i} w_j c_j.g;
      G = dL/dalpha_i * exp(exponent): straight through the 0.99 clamp; 0
      for the other keys.
    Written out by hand: autograd through `blend_forward_torch` would zero
    the gradient of a clamped alpha instead of passing it through.

    `dtype` is the float type the gradients are computed and summed in.
    Which keys contribute is decided in float32 whatever it is, so
    torch.float64 gives, for the same contributing keys, a reference for
    the float32 rounding of this version and of the kernel.

    Returns (grad_data (16, MK) with rows GROW_*, each a sum over the
    tile's pixels, and (num_tiles, 8, 256) with rows [sum |gx|, sum |gy|,
    0, ...]), both of `dtype`."""
    device = point_data.device
    cols32 = _slab_columns(point_data)
    cols = tuple(x.to(dtype) for x in cols32)
    cr, cg, cbc = cols[6:9]
    starts = tile_starts.long()
    seg_len = (tile_ends - tile_starts).long()
    px32, py32 = _pixel_centres(num_tiles, tiles_per_row, device)
    px, py = px32.to(dtype), py32.to(dtype)
    last = pixel_in[:, PIXEL_IN_LAST]
    pixel_in = pixel_in.to(dtype)
    g_r, g_g, g_b = pixel_in[:, 0], pixel_in[:, 1], pixel_in[:, 2]
    S = g_r * pixel_in[:, 3] + g_g * pixel_in[:, 4] + g_b * pixel_in[:, 5]

    shape = (num_tiles, PIXELS_PER_TILE)
    T = torch.ones(shape, dtype=dtype, device=device)
    prefix = torch.zeros(shape, dtype=dtype, device=device)
    mag = torch.zeros((2,) + shape, dtype=dtype, device=device)
    grad = torch.zeros((NUM_DATA_ROWS, point_data.shape[1]), dtype=dtype,
                       device=device)
    rows = torch.tensor(GRAD_ROWS, device=device)
    zero = torch.zeros(shape, dtype=dtype, device=device)
    max_len = int(seg_len.max()) if num_tiles else 0
    for j in range(max_len):
        in_seg = j < seg_len
        k = torch.where(in_seg, starts + j, torch.zeros_like(starts))

        def col(x):
            return x[k][:, None]

        alpha_exp, dx, dy = _alpha_exp(cols, k, px, py)
        alpha32 = alpha_exp if dtype == torch.float32 else _alpha_exp(
            cols32, k, px32, py32)[0]
        contrib = (in_seg[:, None] & (k[:, None].to(torch.float32) < last)
                   & (alpha32 >= ALPHA_SKIP_THRESHOLD))
        alpha = torch.clamp(alpha_exp, max=ALPHA_CLAMP)
        t_next = T * (1.0 - alpha)
        cg_px = col(cr) * g_r + col(cg) * g_g + col(cbc) * g_b
        w = torch.where(contrib, alpha * T, zero)
        prefix = prefix + cg_px * w
        G = torch.where(contrib, (cg_px * T - (S - prefix) / (1.0 - alpha))
                        * alpha_exp, zero)
        ca, cb, cc = col(cols[2]), col(cols[3]), col(cols[4])
        gx = G * (ca * dx + cb * dy)
        gy = G * (cc * dy + cb * dx)
        per_pixel = torch.stack([
            gx, gy, -0.5 * G * dx * dx, -G * dx * dy, -0.5 * G * dy * dy, G,
            g_r * w, g_g * w, g_b * w, torch.sqrt(gx * gx + gy * gy),
            contrib.to(dtype)])                          # (11, T, 256)
        sums = per_pixel.sum(dim=2)                      # (11, T)
        grad[rows[:, None], k[in_seg][None, :]] = sums[:, in_seg]
        mag = mag + torch.stack([gx.abs(), gy.abs()])
        T = torch.where(contrib, t_next, T)

    mag_image = torch.zeros((num_tiles, 8, PIXELS_PER_TILE), dtype=dtype,
                            device=device)
    mag_image[:, 0:2] = mag.permute(1, 0, 2)
    return grad, mag_image


def _check_backward_inputs(point_data, tile_starts, tile_ends, pixel_in,
                           num_tiles):
    if point_data.dim() != 2 or point_data.shape[0] != NUM_DATA_ROWS \
            or point_data.dtype != torch.float32:
        raise ValueError(f"the backward takes the ({NUM_DATA_ROWS}, MK) f32 "
                         f"wide16 slab, got {point_data.dtype} "
                         f"{tuple(point_data.shape)}")
    if point_data.shape[1] >= MAX_BACKWARD_COLUMNS:
        raise ValueError(f"the backward takes fewer than 2**24 slab columns "
                         f"(the forward's `last` is exact as a float only "
                         f"below), got {point_data.shape[1]}")
    _check_inputs(point_data, tile_starts, tile_ends, num_tiles, False)
    if (pixel_in.dtype != torch.float32
            or tuple(pixel_in.shape) != (num_tiles, 8, PIXELS_PER_TILE)):
        raise ValueError(f"pixel_in must be f32 of shape ({num_tiles}, 8, "
                         f"{PIXELS_PER_TILE}), got {pixel_in.dtype} "
                         f"{tuple(pixel_in.shape)}")
    if pixel_in.device != point_data.device:
        raise ValueError(f"pixel_in is on {pixel_in.device}, point_data on "
                         f"{point_data.device}")
    if not pixel_in.is_contiguous():
        raise ValueError("pixel_in must be contiguous")


def blend_backward(point_data, tile_starts, tile_ends, pixel_in, *,
                   num_tiles, tiles_per_row):
    """Backward of the full blend. point_data: the (16, MK) f32 wide16 slab
    the forward blended; tile_starts/ends: (num_tiles,) int32; pixel_in:
    (num_tiles, 8, 256) f32 with rows [g_r, g_g, g_b, C_r, C_g, C_b, last,
    0] (image cotangent, forward colour, the forward's OUT_LAST_EFF row);
    all contiguous; fewer than 2**24 slab columns.

    Returns (grad_data (16, MK) f32, GROW_* rows; mag_image (num_tiles, 8,
    256) f32, rows [sum |gx|, sum |gy|, 0, ...]).

    CPU tensors take the plain version; CUDA tensors launch the kernel;
    any other device raises."""
    _check_backward_inputs(point_data, tile_starts, tile_ends, pixel_in,
                           num_tiles)
    device = point_data.device
    if device.type == "cpu":
        return blend_backward_torch(point_data, tile_starts, tile_ends,
                                    pixel_in, num_tiles=num_tiles,
                                    tiles_per_row=tiles_per_row)
    if device.type != "cuda":
        raise RuntimeError(f"blend_backward runs on cpu or cuda tensors, "
                           f"got {device}")
    from ._build import load_library
    lib = load_library()
    mk = point_data.shape[1]
    work, counters = _work_scratch(num_tiles, mk, device)
    grad = torch.zeros((NUM_DATA_ROWS, mk), dtype=torch.float32,
                       device=device)
    mag = torch.empty((num_tiles, 8, PIXELS_PER_TILE), dtype=torch.float32,
                      device=device)
    # per item of a split tile: (T_chunk, Q_chunk) and (sum |gx|, sum |gy|)
    tq, mag_part = torch.empty((2, max(work.num_split_items, 1), 2,
                                PIXELS_PER_TILE), dtype=torch.float32,
                               device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.t3dgs_blend_backward(
            point_data.data_ptr(), tile_starts.data_ptr(),
            tile_ends.data_ptr(), num_tiles, CHUNK_KEYS, work.items.data_ptr(),
            work.num_items, work.num_split_items, counters.data_ptr(),
            pixel_in.data_ptr(), tq.data_ptr(), mag_part.data_ptr(),
            grad.data_ptr(), mag.data_ptr(), mk, tiles_per_row, stream)
    if err != 0:
        raise RuntimeError(f"blend_backward kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["blend_backward"] += 1
    return grad, mag
