"""The work of a whole frame and of a whole training step, and of the
projection kernels, from the inputs' sizes and the blend's pairs.

Per point (slot) of the pool, P1 and P2 (copied from `chip_smoke.py`
PROJECTION_BYTES / PROJECTION_OPS, counted from the kernels' sources): P1
reads the position (12 bytes), the 56 features (224) and the invalid flag
(1) and writes 15 float columns (60) and 2 mask bytes, in ~420 float
operations; P2 reads the position, the features and 9 cotangents and
writes 3 + 56 gradients, recomputing P1's operations before its own
(~920 in all).

Per pixel, the loss (counted from `training/loss.py`, `training/ssim.py`):
L1 3 a channel; SSIM's five separable 11 + 11 tap blurs 44 each, the three
products 3 and the map 21, a channel; forward 741, backward 789 (the
transposed blurs 220 and the map's derivative 40 a channel, the clip and
L1 9), 1,530 in all.

Per slot, the optimizer and the controller (counted from `training/
adam.py`, `trainer.py`, `controller.py`): Adam 14 an element and keeping
the state on a finite loss 1, over 59 elements; zeroing non-finite rows 3
an element; the group scale and the band mask 2 a feature (56); the
quaternion normalize 12; the statistics 20: 1,206 in all.

Per key, routing the 11 gradient rows to points: 11. The layout of tiles
into the image moves data and takes no operation.
"""

from __future__ import annotations

from .blend import blend_work
from .peaks import PEAK_FLOPS, bound_ms

PROJECTION_BYTES = {"project_forward": 12 + 224 + 1 + 15 * 4 + 2,
                    "project_backward": 12 + 224 + 9 * 4 + 12 + 224}
PROJECTION_OPS = {"project_forward": 420, "project_backward": 920}
LOSS_OPS_PER_PIXEL = 1530
OPTIMIZER_OPS_PER_SLOT = 1206
ROUTING_OPS_PER_KEY = 11


def projection_work(name: str, slots: int) -> dict:
    """{bytes, ops, bound_ms, bound_by} of one P1 ("project_forward") or P2
    ("project_backward") launch over `slots` points."""
    nbytes = PROJECTION_BYTES[name] * slots
    ops = PROJECTION_OPS[name] * slots
    ms, by = bound_ms(ops, nbytes)
    return {"bytes": nbytes, "ops": ops, "bound_ms": ms, "bound_by": by}


def frame_work(counts, slots: int, num_tiles: int) -> dict:
    """The work of one frame of the rgb-only render: P1, K1 (and the
    layout, no operation). {flops, k1, p1}."""
    k1 = blend_work("blend_forward_rgb", counts, num_tiles)
    p1 = projection_work("project_forward", slots)
    return {"flops": k1["ops"] + p1["ops"], "k1": k1, "p1": p1}


def step_work(counts, slots: int, num_tiles: int, pixels: int) -> dict:
    """The work of one training step on one view: P1, K2, the loss, K3,
    routing, P2, and the optimizer and statistics. {flops, k2, k3, p1,
    p2}."""
    k2 = blend_work("blend_forward", counts, num_tiles)
    k3 = blend_work("blend_backward", counts, num_tiles)
    p1 = projection_work("project_forward", slots)
    p2 = projection_work("project_backward", slots)
    flops = (p1["ops"] + k2["ops"] + LOSS_OPS_PER_PIXEL * pixels
             + k3["ops"] + ROUTING_OPS_PER_KEY * counts.keys + p2["ops"]
             + OPTIMIZER_OPS_PER_SLOT * slots)
    return {"flops": flops, "k2": k2, "k3": k3, "p1": p1, "p2": p2}


def mfu_pct(flops: float, unit_ms: float) -> float:
    """Share of the float32 peak, in %, of `flops` done in `unit_ms`."""
    return 100.0 * flops / (unit_ms * 1e-3) / PEAK_FLOPS
