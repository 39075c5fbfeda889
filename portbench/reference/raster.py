"""Plain tile binning and a plain front-to-back blend over (pixel, key)
pairs, computed in blocks of tiles so that it fits on the device.

The semantics are the port's render (16x16 tiles, pixel centres at +0.5):

- each emitting point owns one key per tile of its bbox, the key being
  (tile, int(depth * depth_scale)) with ties in point order;
- per pixel, over its tile's keys in that order: alpha = exp(-0.5 (a dx^2
  + c dy^2) - b dx dy + logw); a key with alpha < 1/255 is skipped, alpha
  is clamped at 0.99; the first key that would take the transmittance T
  below 1e-4 ends the pixel and does not contribute; every other key adds
  alpha T times its colour and multiplies T by 1 - alpha.

Where the port walks a pixel's keys one by one, this module evaluates all
of a block's pairs at once: the transmittance is a cumulative product along
the keys, and a pixel's first saturating key is found by a cumulative sum.
The gradient is autograd's through that product, with alpha's clamp passed
straight through (the port's convention) and no gradient through a skipped
or saturating key.

Imports torch alone: nothing of the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .projection import ALPHA_SKIP_THRESHOLD, TILE, Camera

ALPHA_CLAMP = 0.99
TRANSMITTANCE_SATURATION = 1e-4
COORD_LIMIT = float(1 << 30)
# (pixel, key) pairs evaluated at once; a block's temporaries take some
# tens of bytes a pair
BLOCK_PAIRS = 1 << 24


class Binning(NamedTuple):
    """Keys in blend order: the owning point of each, and each tile's
    range [starts[t], ends[t])."""
    point: torch.Tensor   # (K,) int64
    starts: torch.Tensor  # (T,) int64
    ends: torch.Tensor    # (T,) int64


class Counts(NamedTuple):
    """The (pixel, key) pairs of a render by what the sequential blend does
    with them, as host integers: evaluated up to and including a pixel's
    saturating key, `contributing`, `skipped` (alpha < 1/255) and
    `saturating`; `below_last_skipped`, the skipped keys before a pixel's
    last contributing key (the backward's pairs beside the contributing
    ones); and the number of keys."""
    contributing: int
    skipped: int
    saturating: int
    below_last_skipped: int
    keys: int


def _floor_to_int(x):
    return torch.floor(torch.clamp(x, -COORD_LIMIT, COORD_LIMIT)).to(
        torch.int64)


def bin_keys(u, v, depth, radius_x, radius_y, emit, cam: Camera,
             depth_scale: float) -> Binning:
    """Emit, sort and range the keys of every emitting point."""
    u, v, depth = u.detach(), v.detach(), depth.detach()
    device = u.device
    n = u.shape[0]
    tx, ty = cam.tiles_x, cam.tiles_y
    num_tiles = tx * ty
    depth_bits = 31 - max(int(math.ceil(math.log2(num_tiles + 1))), 1)
    rx = torch.clamp(radius_x, min=1.0)
    ry = torch.clamp(radius_y, min=1.0)
    min_tu = torch.clamp(_floor_to_int(torch.clamp(u - rx, min=0.0) / TILE),
                         max=tx)
    max_tu = torch.clamp(torch.maximum(_floor_to_int((u + rx) / TILE) + 1,
                                       min_tu + 1), max=tx)
    min_tv = torch.clamp(_floor_to_int(torch.clamp(v - ry, min=0.0) / TILE),
                         max=ty)
    max_tv = torch.clamp(torch.maximum(_floor_to_int((v + ry) / TILE) + 1,
                                       min_tv + 1), max=ty)
    dv = max_tv - min_tv
    count = torch.where(emit, (max_tu - min_tu) * dv, torch.zeros_like(dv))
    depth_q = torch.clamp(depth * depth_scale, 0.0,
                          float((1 << depth_bits) - 1)).to(torch.int64)
    ends = torch.cumsum(count, 0)
    total = int(ends[-1]) if n else 0
    point = torch.repeat_interleave(torch.arange(n, device=device), count,
                                    output_size=total)
    slot = torch.arange(total, device=device) - (ends - count)[point]
    du = torch.div(slot, dv[point], rounding_mode="floor")
    tile = (min_tv[point] + slot - du * dv[point]) * tx + min_tu[point] + du
    # one sort on (tile, depth bucket, point): the port's stable sort of
    # (tile, depth bucket) over keys emitted in point order
    key = ((tile << depth_bits) | depth_q[point]) * n + point
    order = torch.sort(key).indices
    point = point[order]
    tile = tile[order]
    edges = torch.searchsorted(
        tile, torch.arange(num_tiles + 1, device=device))
    return Binning(point, edges[:-1], edges[1:])


def _blocks(binning: Binning):
    """Groups of tiles, each a (tiles, length) pair of index tensors: the
    tiles by segment length, cut so that a group's padded pairs stay under
    BLOCK_PAIRS."""
    lengths = binning.ends - binning.starts
    order = torch.sort(lengths, stable=True).indices
    sorted_len = lengths[order].tolist()
    order = order.tolist()
    i = 0
    while i < len(order):
        j = i + 1
        while (j < len(order)
               and (j - i + 1) * 256 * max(sorted_len[j], 1) <= BLOCK_PAIRS):
            j += 1
        yield order[i:j], max(sorted_len[j - 1], 1)
        i = j


def _pixel_centres(tiles, cam: Camera, dtype):
    p = torch.arange(256, device=tiles.device)
    px = (tiles % cam.tiles_x * TILE)[:, None] + (p % TILE)[None] + 0.5
    py = (tiles // cam.tiles_x * TILE)[:, None] + (p // TILE)[None] + 0.5
    return px.to(dtype), py.to(dtype)


class _Block(NamedTuple):
    tiles: torch.Tensor   # (B,)
    keys: torch.Tensor    # (B, L) key index, 0 where padded
    valid: torch.Tensor   # (B, L)


def _block(binning: Binning, tile_list, length, device):
    tiles = torch.tensor(tile_list, device=device)
    pos = torch.arange(length, device=device)
    start = binning.starts[tiles]
    valid = pos[None] < (binning.ends[tiles] - start)[:, None]
    keys = torch.where(valid, start[:, None] + pos[None], 0)
    return _Block(tiles, keys, valid)


def _alpha(cols, blk: _Block, px, py, point, dtype, dxdy=None):
    """Each pair's alpha before the clamp, (B, 256, L), and (dx, dy)."""
    idx = point[blk.keys]
    u, v, ca, cb, cc, logw = (c.to(dtype)[idx][:, None, :] for c in cols[:6])
    if dxdy is None:
        dxdy = (px[:, :, None] - u, py[:, :, None] - v)
    dx, dy = dxdy
    return torch.exp(-0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                     + logw), dxdy


def _masks(alpha_raw, valid):
    """(live, contributing, saturating, evaluated, position of the last
    contributing key + 1) of every pair of a block."""
    live = valid[:, None, :] & (alpha_raw >= ALPHA_SKIP_THRESHOLD)
    factor = torch.where(live, 1.0 - torch.clamp(alpha_raw, max=ALPHA_CLAMP),
                         torch.ones_like(alpha_raw))
    t_incl = torch.cumprod(factor, dim=2)
    sat = live & (t_incl < TRANSMITTANCE_SATURATION)
    sat_seen = torch.cumsum(sat.to(torch.int32), dim=2)
    before = (sat_seen - sat.to(torch.int32)) > 0
    first_sat = sat & ~before
    contrib = live & ~sat & ~before
    evaluated = valid[:, None, :] & ~before
    pos = torch.arange(1, alpha_raw.shape[2] + 1, device=alpha_raw.device)
    last = torch.where(contrib, pos, torch.zeros_like(pos)).amax(dim=2)
    return live, contrib, first_sat, evaluated, last


def _composite(alpha_raw, contrib, colours):
    """Per pixel (B, 256, 3): the sum of alpha T c over the contributing
    keys, T the product of (1 - alpha) of the contributing keys before.
    Alpha's clamp passes its gradient straight through."""
    alpha = alpha_raw - torch.clamp(alpha_raw - ALPHA_CLAMP, min=0.0).detach()
    zero = torch.zeros_like(alpha)
    factor = torch.where(contrib, 1.0 - alpha, zero + 1.0)
    t_incl = torch.cumprod(factor, dim=2)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :, :1]),
                        t_incl[:, :, :-1]], dim=2)
    w = torch.where(contrib, alpha * t_excl, zero)
    return torch.stack([(w * c[:, None, :]).sum(dim=2) for c in colours],
                       dim=-1)


def _tiles_to_image(tile_rgb, cam: Camera):
    """(num_tiles, 256, 3) -> (H, W, 3)."""
    x = tile_rgb.reshape(cam.tiles_y, cam.tiles_x, TILE, TILE, 3)
    return x.permute(0, 2, 1, 3, 4).reshape(cam.height, cam.width, 3)


def render(cols, binning: Binning, cam: Camera, dtype=torch.float32,
           counts: bool = False):
    """The image (H, W, 3) float32 of the nine columns (u, v, a, b, c, logw,
    r, g, b) binned as `binning`, without gradient; with `counts`, also the
    Counts. `dtype` is the type the pairs are computed in."""
    device = cols[0].device
    num_tiles = cam.tiles_x * cam.tiles_y
    out = torch.zeros((num_tiles, 256, 3), dtype=torch.float32, device=device)
    tally = [0, 0, 0, 0]
    with torch.no_grad():
        for tile_list, length in _blocks(binning):
            blk = _block(binning, tile_list, length, device)
            px, py = _pixel_centres(blk.tiles, cam, dtype)
            alpha_raw, _ = _alpha(cols, blk, px, py, binning.point, dtype)
            live, contrib, sat, evaluated, last = _masks(alpha_raw, blk.valid)
            idx = binning.point[blk.keys]
            colours = [c.to(dtype)[idx] for c in cols[6:9]]
            out[blk.tiles] = _composite(alpha_raw, contrib, colours).to(
                torch.float32)
            if counts:
                skipped = evaluated & ~live
                pos = torch.arange(1, length + 1, device=device)
                below = skipped & (pos < last[:, :, None])
                tally[0] += int(contrib.sum())
                tally[1] += int(skipped.sum())
                tally[2] += int(sat.sum())
                tally[3] += int(below.sum())
    image = _tiles_to_image(out, cam)
    if counts:
        return image, Counts(*tally, keys=int(binning.point.shape[0]))
    return image


class KeyGradients(NamedTuple):
    """Per point: the cotangents of the nine columns (9, N), and the
    controller's statistics: the sums over pixels of dL/du, dL/dv (N, 2),
    of |(dL/du, dL/dv)| (N,), and the pixels each point's keys blended
    into (N,)."""
    cotangents: torch.Tensor
    grad_uv: torch.Tensor
    magnitude: torch.Tensor
    num_pixels: torch.Tensor


def backward(cols, binning: Binning, cam: Camera, g_image,
             dtype=torch.float32) -> KeyGradients:
    """The gradient of sum(g_image * render(cols)) with respect to the
    nine columns, summed per point, block by block."""
    device = cols[0].device
    n = cols[0].shape[0]
    num_tiles = cam.tiles_x * cam.tiles_y
    g_tiles = g_image.to(dtype).reshape(cam.tiles_y, TILE, cam.tiles_x, TILE,
                                        3).permute(0, 2, 1, 3, 4).reshape(
        num_tiles, 256, 3)
    cot = torch.zeros((9, n), dtype=torch.float32, device=device)
    grad_uv = torch.zeros((n, 2), dtype=torch.float32, device=device)
    magnitude = torch.zeros((n,), dtype=torch.float32, device=device)
    num_pixels = torch.zeros((n,), dtype=torch.float32, device=device)
    detached = [c.detach() for c in cols]
    for tile_list, length in _blocks(binning):
        blk = _block(binning, tile_list, length, device)
        px, py = _pixel_centres(blk.tiles, cam, dtype)
        idx = binning.point[blk.keys]
        with torch.no_grad():
            alpha_raw, (dx, dy) = _alpha(detached, blk, px, py,
                                         binning.point, dtype)
            _, contrib, _, _, _ = _masks(alpha_raw, blk.valid)
        leaves = [c.to(dtype)[idx].requires_grad_(True) for c in detached[2:9]]
        dx = dx.requires_grad_(True)
        dy = dy.requires_grad_(True)
        with torch.enable_grad():
            ca, cb, cc, logw = (x[:, None, :] for x in leaves[:4])
            alpha_raw = torch.exp(-0.5 * (ca * dx * dx + cc * dy * dy)
                                  - cb * dx * dy + logw)
            rgb = _composite(alpha_raw, contrib, leaves[4:7])
            grads = torch.autograd.grad(rgb, [dx, dy] + leaves,
                                        g_tiles[blk.tiles])
        # dL/du of a pair is -dL/d(dx); padded keys carry no gradient
        g_u, g_v = -grads[0], -grads[1]
        keep = blk.valid
        pts = idx[keep]

        def add(row, per_key):
            cot[row].index_add_(0, pts, per_key[keep].to(torch.float32))

        add(0, g_u.sum(dim=1))
        add(1, g_v.sum(dim=1))
        for row, g in zip(range(2, 9), grads[2:]):
            add(row, g)
        grad_uv.index_add_(0, pts, torch.stack(
            [g_u.sum(dim=1)[keep], g_v.sum(dim=1)[keep]], dim=1).to(
                torch.float32))
        magnitude.index_add_(0, pts, torch.sqrt(g_u * g_u + g_v * g_v).sum(
            dim=1)[keep].to(torch.float32))
        num_pixels.index_add_(0, pts, contrib.sum(dim=1)[keep].to(
            torch.float32))
    return KeyGradients(cot, grad_uv, magnitude, num_pixels)


def render_view(project_fn, depth_scale: float, cam: Camera,
                dtype=torch.float32, counts: bool = False,
                colour_round: Optional[torch.dtype] = None):
    """Project (`project_fn()` -> Projected), bin and render one view.
    `colour_round` rounds the colours to that type first (the render's
    packed slab carries them in bfloat16)."""
    with torch.no_grad():
        p = project_fn()
        binning = bin_keys(p.cols[0], p.cols[1], p.depth, p.radius_x,
                           p.radius_y, p.emit, cam, depth_scale)
        cols = list(p.cols)
        if colour_round is not None:
            cols[6:9] = [c.to(colour_round).to(torch.float32)
                         for c in cols[6:9]]
        return render(cols, binning, cam, dtype, counts)
