"""Long-segment fixtures for the chunked blend kernels, the inputs
chip_smoke.py gives the kernels at 976x544, and the work a blend does on
an input: its (pixel, key) pairs by what each costs, its bytes and its
bound (`work`). torch and numpy only (no JAX), so that chip_smoke.py uses
them on the card.

`long_segment_slab(chunk)` builds a slab whose tiles split into several
chunks of `chunk` keys: 8 tiles (4 per row) of lengths 3C+7, C+1, C, 0, 1,
2C+5, 3C+7, 2C+5, with wide splats (sigma 32 px) near each tile's centre
whose opacity sets where pixels saturate: tiles 0-2 and 4 between ~0.97C
and ~1.03C keys (so some pixels saturate on the first key of chunk 1, and
some start chunk 1 with T just above 1e-4), tile 5 in its second chunk,
tile 6 never, tile 7 in its first chunk (its later chunks start
saturated). `shifted_slab` places such a slab at a column offset of a
wider, otherwise zero slab: at `BOUNDARY_OFFSET` its tiles straddle column
2**24, past which a float32 no longer holds every integer.
"""

import numpy as np
import torch

from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene)
from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
from taichi_3d_gaussian_splatting_torch.ops.gaussian import (
    ALPHA_SKIP_THRESHOLD)
from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
    RasterizerConfig, TileGrid, _backward_pixel_in, _project_and_bin)
from taichi_3d_gaussian_splatting_torch.ops.tiling import blend_slab

TILES_PER_ROW = 4
NUM_TILES = 8
SIGMA_PX = 32.0

# one NVIDIA H100 SXM: float32 outside the tensor cores, and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Float operations a (pixel, key) pair needs, by what the key does to the
# pixel (expf counted as one):
#   skipped (alpha < 1/255): the exponent 12 (dx, dy, 6 products, 3 adds,
#     + logw), expf 1, the 1/255 compare 1;
#   saturating (the forward's, once per pixel): skipped's 14, clamp 1,
#     1 - alpha 1, T (1 - alpha) 1, the 1e-4 compare 1;
#   contributing, K1: saturating's 18, w = alpha T 1, rgb 6, sum w 1;
#   contributing, K2: K1's 26 and the depth product and sum 2;
#   contributing, K3: skipped's 14, clamp, 1 - alpha and T 3, c.g 5, w and
#     prefix 3, dL/dalpha 4, G 1, gx and gy 8, conic terms 8, colour terms
#     3, |(gx, gy)| 4, |gx| and |gy| sums 4, the 11 per-key sums over the
#     tile's pixels 11.
OPS_SKIPPED = 14
OPS_SATURATING = 18
OPS_CONTRIBUTING = {"blend_forward_rgb": 26, "blend_forward": 28,
                    "blend_backward": 68}
# rasterize's settings in chip_smoke.py
CFG_MAIN = dict(near_plane=0.4, far_plane=1000.0, max_tiles_per_point=32)
# the long-segment fixture's column offset in the boundary fixture: its
# first tile spans columns 2**24 - 3 .. 2**24 + 2,307
BOUNDARY_OFFSET = 2 ** 24 - 3


def _tile_plan(c):
    """(keys, keys to saturate a tile's centre pixel or None) per tile."""
    return [(3 * c + 7, 0.97 * c), (c + 1, 0.97 * c), (c, 0.97 * c),
            (0, None), (1, 0.97 * c), (2 * c + 5, 1.6 * c),
            (3 * c + 7, 5.0 * c), (2 * c + 5, 0.4 * c)]


def long_segment_slab(chunk, seed=0):
    """(slabs {"wide16", "packed8"}, tile_starts, tile_ends) on the CPU for
    a 64x32 image of 8 tiles (TILES_PER_ROW per row)."""
    rng = np.random.default_rng(seed)
    cols = [[] for _ in range(10)]
    starts, ends = [], []
    for t, (n, n_sat) in enumerate(_tile_plan(chunk)):
        starts.append(sum(len(x) for x in cols[0]))
        ends.append(starts[-1] + n)
        cx = (t % TILES_PER_ROW) * 16 + 8.0
        cy = (t // TILES_PER_ROW) * 16 + 8.0
        # opacity at which n_sat keys take T from 1 to 1e-4
        alpha0 = 1.0 - 1e-4 ** (1.0 / n_sat) if n_sat else 0.5
        inv = 1.0 / SIGMA_PX ** 2
        for dst, x in zip(cols, (
                cx + rng.normal(0, 2, n), cy + rng.normal(0, 2, n),
                np.full(n, inv), np.zeros(n), np.full(n, inv),
                np.log(alpha0) + rng.normal(0, 0.05, n),
                rng.uniform(0, 1, n), rng.uniform(0, 1, n),
                rng.uniform(0, 1, n), np.sort(rng.uniform(1, 50, n)))):
            dst.append(x)
    cols = [torch.as_tensor(np.concatenate(c).astype(np.float32))
            for c in cols]
    idx = torch.arange(cols[0].shape[0])
    slabs = {fmt: blend_slab(cols, idx, fmt) for fmt in ("wide16", "packed8")}
    return (slabs, torch.tensor(starts, dtype=torch.int32),
            torch.tensor(ends, dtype=torch.int32))


def shifted_slab(slab, tile_starts, tile_ends, offset):
    """(slab, tile_starts, tile_ends) with `slab`'s columns at
    [offset, offset + MK) of a slab of offset + MK columns, zero elsewhere
    (no range points there), and the ranges shifted by `offset`; on the
    slab's device."""
    wide = torch.zeros((slab.shape[0], offset + slab.shape[1]),
                       dtype=slab.dtype, device=slab.device)
    wide[:, offset:] = slab
    return wide, tile_starts + offset, tile_ends + offset


def binned_inputs(pc, feats, cam, cfg_kwargs, device):
    """The blend kernels' inputs for a scene (pc, feats) at the identity
    pose: (the binning, {"wide16": slab, "packed8": slab})."""
    n = pc.shape[0]
    scene = GaussianPointCloudScene.from_numpy(pc, feats, np.zeros(n),
                                               np.zeros(n), device)
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=device)
    t = torch.zeros((1, 3), device=device)
    with torch.no_grad():
        _, cols, depth, binning = _project_and_bin(
            *scene, q, t, cam, RasterizerConfig(**cfg_kwargs), None)
        packed = blend_slab(cols + (depth,), binning.sorted_point_idx,
                            "packed8")
    return binning, {"wide16": binning.point_data, "packed8": packed}


def seeded_pixel_in(fwd, cam, seed):
    """The backward kernel's pixel_in as training builds it
    (rasterizer._backward_pixel_in): a seeded normal image cotangent
    beside the forward output `fwd`'s colour and `last`."""
    rng = np.random.default_rng(seed)
    g = torch.as_tensor(rng.normal(size=(
        cam.camera_height, cam.camera_width, 3)).astype(np.float32),
        device=fwd.device)
    return _backward_pixel_in(fwd, g, TileGrid.from_camera(cam))


def pair_counts(slab, tile_starts, tile_ends, *, num_tiles, tiles_per_row,
                last=None, block=64):
    """Per pixel, the (pixel, key) pairs of the sequential blend by what
    they cost, on the slab's device: a dict of (num_tiles, 256) int64.

    The forward evaluates each key up to and including the pixel's
    saturating key (or the whole segment): "contributing" (blended),
    "skipped" (alpha < 1/255) and "saturating" (0 or 1), with "sat_pos"
    the saturating key's position in its tile's segment (-1 if none).
    With `last` ((num_tiles, 256), the forward's int32 `last` or its float
    row OUT_LAST_EFF), also K3's pairs, the keys below `last`:
    "k3_contributing" (not skipped) and "k3_skipped".

    `block` key positions at a time: T before key i is the product of the
    earlier non-skipped keys' (1 - min(alpha, 0.99)), so the pixel
    evaluates key i while that product is >= 1e-4 (it rounds the product in
    another order than the blend, which moves only pixels at the edge)."""
    device = slab.device
    u, v, ca, cb, cc, logw = BC._slab_columns(slab)[:6]
    starts = tile_starts.long()
    seg_len = (tile_ends - tile_starts).long()
    px, py = BC._pixel_centres(num_tiles, tiles_per_row, device)
    T = torch.ones((num_tiles, BC.PIXELS_PER_TILE), device=device)
    names = ["contributing", "skipped", "saturating"]
    if last is not None:
        names += ["k3_contributing", "k3_skipped"]
    counts = {k: torch.zeros_like(T, dtype=torch.long) for k in names}
    sat_pos = torch.full_like(counts["skipped"], -1)
    if last is not None:
        last = last.long()
    max_len = int(seg_len.max()) if num_tiles else 0
    for j0 in range(0, max_len, block):
        pos = j0 + torch.arange(block, device=device)
        in_seg = pos[None] < seg_len[:, None]                    # (T, B)
        k = torch.where(in_seg, starts[:, None] + pos[None], 0)

        def col(x):
            return x[k][:, :, None]                              # (T, B, 1)

        dx = px[:, None] - col(u)
        dy = py[:, None] - col(v)
        alpha = torch.exp(-0.5 * (col(ca) * dx * dx + col(cc) * dy * dy)
                          - col(cb) * dx * dy + col(logw))
        live = in_seg[:, :, None] & (alpha >= ALPHA_SKIP_THRESHOLD)
        factor = torch.where(live, 1.0 - alpha.clamp(max=BC.ALPHA_CLAMP), 1.0)
        incl = T[:, None] * torch.cumprod(factor, dim=1)         # (T, B, 256)
        excl = torch.cat([T[:, None], incl[:, :-1]], dim=1)
        alive = in_seg[:, :, None] & (excl >= BC.TRANSMITTANCE_SATURATION)
        sat_here = alive & live & (incl < BC.TRANSMITTANCE_SATURATION)
        counts["contributing"] += (alive & live & ~sat_here).sum(dim=1)
        counts["skipped"] += (alive & ~live).sum(dim=1)
        counts["saturating"] += sat_here.sum(dim=1)
        if last is not None:
            below = in_seg[:, :, None] & (k[:, :, None] < last[:, None])
            counts["k3_contributing"] += (below & live).sum(dim=1)
            counts["k3_skipped"] += (below & ~live).sum(dim=1)
        hit = sat_here.any(dim=1)
        first = torch.argmax(sat_here.to(torch.int8), dim=1) + j0
        sat_pos = torch.where(hit & (sat_pos < 0), first, sat_pos)
        T = incl[:, -1]
    counts["sat_pos"] = sat_pos
    return counts


def work(name, slab, tile_starts, tile_ends, num_tiles, tiles_per_row,
         last=None):
    """The work of one call of kernel `name` (a blend_cuda.launch_counts
    key) on these inputs: the pairs it evaluates (the forward's up to each
    pixel's saturating key, K3's below the forward's `last`), of them the
    contributing ones, 256 * sum(segment lengths) (no early exit), the
    bytes it must move (each input row it reads once, each output once),
    the float operations (OPS_*), and its bound in ms with what sets it."""
    seg = (tile_ends - tile_starts).long().clamp(min=0)
    mk = slab.shape[1]
    counts = pair_counts(slab, tile_starts, tile_ends, num_tiles=num_tiles,
                         tiles_per_row=tiles_per_row, last=last)
    if name == "blend_backward":
        contributing = int(counts["k3_contributing"].sum())
        skipped = int(counts["k3_skipped"].sum())
        saturating = 0
        # 9 slab rows, 6 pixel_in rows and the int32 `last` in; the
        # gradient slab and the magnitude image out
        nbytes = 4 * (9 * mk + 7 * num_tiles * 256 + 16 * mk
                      + 8 * num_tiles * 256)
    else:
        contributing = int(counts["contributing"].sum())
        skipped = int(counts["skipped"].sum())
        saturating = int(counts["saturating"].sum())
        rows = 8 if name == "blend_forward_rgb" else 10
        # the output tiles, and K2's int32 `last`
        out_rows = 8 if name == "blend_forward_rgb" else 9
        nbytes = 4 * (rows * mk + out_rows * num_tiles * 256)
    nbytes += 4 * 2 * num_tiles                              # tile ranges
    ops = (OPS_CONTRIBUTING[name] * contributing + OPS_SKIPPED * skipped
           + OPS_SATURATING * saturating)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS * 1e3
    return {"pairs": contributing + skipped + saturating,
            "contributing": contributing,
            "pairs_no_exit": 256 * int(seg.sum()), "bytes": nbytes,
            "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
