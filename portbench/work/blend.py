"""The work of one call of a blend kernel, from the (pixel, key) pairs that
the sequential blend gives the call's inputs (`reference.raster.Counts`).

Copied from `tests/torch_chunk_fixtures.py` (`OPS_*`, `work`), the counts
the port's kernels were held to since they were written. Float operations
a (pixel, key) pair needs, by what the key does to the pixel (expf counted
as one):
  skipped (alpha < 1/255): the exponent 12 (dx, dy, 6 products, 3 adds,
    + logw), expf 1, the 1/255 compare 1;
  saturating (the forward's, once per pixel): skipped's 14, clamp 1,
    1 - alpha 1, T (1 - alpha) 1, the 1e-4 compare 1;
  contributing, K1: saturating's 18, w = alpha T 1, rgb 6, sum w 1;
  contributing, K2: K1's 26 and the depth product and sum 2;
  contributing, K3: skipped's 14, clamp, 1 - alpha and T 3, c.g 5, w and
    prefix 3, dL/dalpha 4, G 1, gx and gy 8, conic terms 8, colour terms
    3, |(gx, gy)| 4, |gx| and |gy| sums 4, the 11 per-key sums over the
    tile's pixels 11.
Bytes: each input row read once, each output row written once.
"""

from __future__ import annotations

from .peaks import bound_ms

OPS_SKIPPED = 14
OPS_SATURATING = 18
OPS_CONTRIBUTING = {"blend_forward_rgb": 26, "blend_forward": 28,
                    "blend_backward": 68}


def blend_work(name: str, counts, num_tiles: int) -> dict:
    """{pairs, contributing, bytes, ops, bound_ms, bound_by} of one call of
    kernel `name` ("blend_forward_rgb" K1, "blend_forward" K2,
    "blend_backward" K3) on inputs whose pairs are `counts`."""
    mk = counts.keys
    if name == "blend_backward":
        contributing = counts.contributing
        skipped = counts.below_last_skipped
        saturating = 0
        # 9 slab rows, 6 pixel_in rows and the int32 `last` in; the
        # gradient slab and the magnitude image out
        nbytes = 4 * (9 * mk + 7 * num_tiles * 256 + 16 * mk
                      + 8 * num_tiles * 256)
    else:
        contributing = counts.contributing
        skipped = counts.skipped
        saturating = counts.saturating
        rows = 8 if name == "blend_forward_rgb" else 10
        # the output tiles, and K2's int32 `last`
        out_rows = 8 if name == "blend_forward_rgb" else 9
        nbytes = 4 * (rows * mk + out_rows * num_tiles * 256)
    nbytes += 4 * 2 * num_tiles                              # tile ranges
    ops = (OPS_CONTRIBUTING[name] * contributing + OPS_SKIPPED * skipped
           + OPS_SATURATING * saturating)
    ms, by = bound_ms(ops, nbytes)
    return {"pairs": contributing + skipped + saturating,
            "contributing": contributing, "bytes": nbytes, "ops": ops,
            "bound_ms": ms, "bound_by": by}
