"""S4: the port's K1 with its stages stripped in turn, on the render's
wide16 slab. Which stage of the forward blend costs what?

    python -m taichi_3d_gaussian_splatting_torch.probes.perf_rgb_ablate2 \
        [--scene 430k|heavy]

Replaces the TPU probe scratch/perf_rgb_ablate2.py:112 (the pl.pallas_call
of make_kernel(mode, tiles_per_row), :22); the kernel is
csrc/probes/perf_rgb_ablate2.cu, a copy of K1 (csrc/blend_forward.cu,
RGB_ONLY, wide16) walking each tile in 128-key chunks aligned down from
its first key. Modes (that file's header says what each strips): ``full``
(K1's result), ``no_sat``, ``no_scan``, ``dma_only``. Output (num_tiles, 8,
256) f32 rows [r, g, b, 1 - T, sum w, 0, 0, 0].

The input is the wide16 slab of the port's projection and binning of the
bench's 430k scene at 976x544 (or the 1.03M heavy-tailed scene), padded
once with zero columns to a multiple of 128 outside the timed calls.
`main` prints one JSON line per mode: ms a frame (CUDA events over the
TPU probe's 20 calls), the card's name and power limit. It needs a card.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import blend_cuda as BC
from ..ops.gaussian import ALPHA_SKIP_THRESHOLD
from . import _common as C

REPLACES = "scratch/perf_rgb_ablate2.py:112"
SOURCE = "taichi_3d_gaussian_splatting_torch/csrc/probes/perf_rgb_ablate2.cu"
MODES = ("full", "no_sat", "no_scan", "dma_only")
REPS = 20   # the TPU probe's timed calls a mode

# kernel launches per mode, counted by the wrapper when it launches
launch_counts = {mode: 0 for mode in MODES}


def reset_launch_counts():
    for mode in launch_counts:
        launch_counts[mode] = 0


def rgb_ablate2_torch(slab, tile_starts, tile_ends, *, mode, num_tiles,
                      tiles_per_row):
    """Plain version: the TPU probe's chunk loop with the port's exponent
    (blend_cuda.py `_alpha_exp`, as K1) and the probe's log-doubling prefix
    product and saturation masks. Returns (num_tiles, 8, 256) f32."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    device = slab.device
    n = num_tiles
    px_all, py_all = BC._pixel_centres(num_tiles, tiles_per_row, device)
    state = {"T": torch.ones((n, C.PIXELS), device=device),
             "sat": torch.zeros((n, C.PIXELS), device=device),
             "acc": torch.zeros((n, 8, C.PIXELS), device=device)}

    def step(st, data, in_seg, rows):
        T, sat, acc = st["T"], st["sat"], st["acc"]
        if mode == "dma_only":
            return {"acc": acc + data[:, 8:16].sum(dim=2, keepdim=True)}
        px, py = px_all[rows][:, None], py_all[rows][:, None]

        def row(r):
            return data[:, r, :, None]                        # (a, C, 1)
        dx = px - row(BC.ROW_U)
        dy = py - row(BC.ROW_V)
        alpha = torch.exp(-0.5 * (row(BC.ROW_A) * dx * dx
                                  + row(BC.ROW_C) * dy * dy)
                          - row(BC.ROW_B) * dx * dy + row(BC.ROW_LOGW))
        a_v = torch.where(in_seg[:, :, None]
                          & (alpha >= ALPHA_SKIP_THRESHOLD),
                          torch.clamp(alpha, max=BC.ALPHA_CLAMP),
                          torch.zeros_like(alpha))
        one_minus = 1.0 - a_v
        if mode == "no_scan":
            t_i = T[:, None] * one_minus
        else:
            t_i = T[:, None] * C.cumprod_exclusive(one_minus, 1)
        if mode == "no_sat":
            contribute, T = a_v, t_i[:, -1]
        else:
            contribute, T, sat = C.saturation_masks(a_v, t_i, one_minus, T,
                                                    sat)
        weight = contribute * a_v * t_i
        return {"T": T, "sat": sat,
                "acc": acc + torch.matmul(data[:, 8:16], weight)}

    state = C.chunk_walk(slab, tile_starts, tile_ends, state, step)
    acc = state["acc"]
    zero = torch.zeros_like(state["T"])
    return torch.stack([acc[:, 0], acc[:, 1], acc[:, 2], 1.0 - state["T"],
                        acc[:, 4], zero, zero, zero], dim=1)


def rgb_ablate2(slab, tile_starts, tile_ends, *, mode, num_tiles,
                tiles_per_row):
    """The probe on a (16, MK) f32 slab (MK a multiple of 128) and int32
    tile ranges: CPU tensors take the plain version, CUDA tensors launch
    the kernel (and count the launch), any other device raises."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    kind = C.check_inputs("rgb_ablate2", slab, tile_starts, tile_ends,
                          num_tiles)
    if kind == "cpu":
        return rgb_ablate2_torch(slab, tile_starts, tile_ends, mode=mode,
                                 num_tiles=num_tiles,
                                 tiles_per_row=tiles_per_row)
    out = C.launch_slab_probe(
        "t3dgs_probe_rgb_ablate2", slab, tile_starts, tile_ends,
        mode_index=MODES.index(mode), num_tiles=num_tiles,
        tiles_per_row=tiles_per_row, out_shape=(num_tiles, 8, C.PIXELS))
    launch_counts[mode] += 1
    return out


def inputs(scene, device="cuda"):
    """(padded wide16 slab, tile_starts, tile_ends, camera) of `scene`."""
    slab, starts, ends, cam = C.render_slab(scene, torch.device(device))
    return C.pad_columns(slab), starts, ends, cam


def time_modes(slab, tile_starts, tile_ends, cam, reps=REPS):
    """{mode: ms a frame} of the kernel, each mode timed by CUDA events."""
    kw = dict(num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row)
    return {mode: C.time_ms(lambda: rgb_ablate2(slab, tile_starts, tile_ends,
                                                mode=mode, **kw), reps)
            for mode in MODES}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scene", choices=("430k", "heavy"), default="430k")
    args = parser.parse_args(argv)
    C.require_card()
    name, limit = C.card()
    slab, starts, ends, cam = inputs(args.scene)
    for mode, ms in time_modes(slab, starts, ends, cam).items():
        C.emit({"probe": "S4", "mode": mode, "scene": args.scene,
                "ms": ms, "ms_per_frame": ms, "reps": REPS,
                "slab_columns": slab.shape[1], "card": name,
                "power_limit": limit})


if __name__ == "__main__":
    main()
