"""S3: one stage of the K1 skeleton removed at a time, on S3's synthetic
layout (2,074 tiles, 61 a row, 786,432 slab columns, 646,871 keys).

    python -m taichi_3d_gaussian_splatting_torch.probes.perf_kernel_ablate

Replaces the TPU probe scratch/perf_kernel_ablate.py:116 (the
pl.pallas_call that build(mode), :107, makes of make_kernel(mode), :19).
That file cannot run: it imports _lane_cumprod_exclusive and
_tile_pixel_coords, which ops/blend_pallas.py lost in acf080a, and takes
_saturation_masks, which now holds keys on sublanes (axis 0) where this
probe holds them on lanes; its semantics are those of the helpers at
acf080a^. The kernel is csrc/probes/perf_kernel_ablate.cu; its header says
what each mode (``full``, ``dma_only``, ``no_exp``, ``no_scan``,
``no_sat``, ``no_mxu``) removes. Exponent (a dx + b dy) dx + c dy^2 + logw
with dx = px - u, dy = py - v. Output (num_tiles, 256, 8) f32: per pixel
the 8 rows 8..15 weighted by the blend (rows of the TPU probe's product).

`main` prints one JSON line per mode: ms a frame (CUDA events, the mean of
the TPU probe's 30 calls, as its second round), the card's name and power
limit. It needs a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import blend_cuda as BC
from ..ops.gaussian import ALPHA_SKIP_THRESHOLD
from . import _common as C

REPLACES = "scratch/perf_kernel_ablate.py:116"
SOURCE = "taichi_3d_gaussian_splatting_torch/csrc/probes/perf_kernel_ablate.cu"
MODES = ("full", "dma_only", "no_exp", "no_scan", "no_sat", "no_mxu")
REPS = 30   # the TPU probe's timed calls a round
# the TPU probe's layout (scratch/perf_kernel_ablate.py:13-16, 129)
NUM_TILES = 2074
TILES_PER_ROW = 61
SLAB_COLUMNS = 786432
KEYS = 646871

# kernel launches per mode, counted by the wrapper when it launches
launch_counts = {mode: 0 for mode in MODES}


def reset_launch_counts():
    for mode in launch_counts:
        launch_counts[mode] = 0


def layout(device="cuda"):
    """The TPU probe's synthetic slab and ranges, built as its :122-131
    build them: (slab (16, 786432) f32, tile_starts, tile_ends)."""
    rng = np.random.default_rng(0)
    data = np.zeros((16, SLAB_COLUMNS), np.float32)
    data[BC.ROW_U] = rng.uniform(0, 976, SLAB_COLUMNS)
    data[BC.ROW_V] = rng.uniform(0, 544, SLAB_COLUMNS)
    data[BC.ROW_A] = -0.05
    data[BC.ROW_C] = -0.05
    data[BC.ROW_LOGW] = -1.0
    data[8:11] = 0.5
    data[11] = 10.0
    data[12] = 1.0
    edges = np.linspace(0, KEYS, NUM_TILES + 1).astype(np.int32)
    return (torch.as_tensor(data, device=device),
            torch.as_tensor(edges[:-1], device=device),
            torch.as_tensor(edges[1:], device=device))


def kernel_ablate_torch(slab, tile_starts, tile_ends, *, mode, num_tiles,
                        tiles_per_row):
    """Plain version of the TPU probe's body (helpers of acf080a^): the
    chunk loop, its exponent, the log-doubling prefix product and the
    saturation masks, with keys on dim 1 of (a, keys, 256) maps (the
    probe's lanes).
    Returns (num_tiles, 256, 8) f32."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    device = slab.device
    n = num_tiles
    px_all, py_all = BC._pixel_centres(num_tiles, tiles_per_row, device)
    state = {"T": torch.ones((n, C.PIXELS), device=device),
             "sat": torch.zeros((n, C.PIXELS), device=device),
             "acc": torch.zeros((n, C.PIXELS, 8), device=device)}

    def step(st, data, in_seg, rows):
        T, sat, acc = st["T"], st["sat"], st["acc"]
        if mode == "dma_only":
            return {"acc": acc + data[:, 0].sum(dim=1)[:, None, None]}
        px, py = px_all[rows][:, None], py_all[rows][:, None]

        def row(r):
            return data[:, r, :, None]                        # (a, C, 1)
        dx = px - row(BC.ROW_U)
        dy = py - row(BC.ROW_V)
        exponent = ((row(BC.ROW_A) * dx + row(BC.ROW_B) * dy) * dx
                    + (row(BC.ROW_C) * dy * dy + row(BC.ROW_LOGW)))
        a_exp = exponent if mode == "no_exp" else torch.exp(exponent)
        a_v = torch.where(in_seg[:, :, None]
                          & (a_exp >= ALPHA_SKIP_THRESHOLD),
                          torch.clamp(a_exp, max=BC.ALPHA_CLAMP),
                          torch.zeros_like(a_exp))
        one_minus = 1.0 - a_v
        if mode == "no_scan":
            t_i = T[:, None] * one_minus
        else:
            t_i = T[:, None] * C.doubling_scan(one_minus, 1)
        if mode == "no_sat":
            contribute, T = (a_v > 0).to(a_v.dtype), t_i[:, -1]
        else:
            contribute, T, sat = C.saturation_masks(a_v, t_i, one_minus, T,
                                                    sat)
        weight = contribute * a_v * t_i                       # (a, C, 256)
        if mode == "no_mxu":
            acc = acc + weight.sum(dim=1)[:, :, None]
        else:
            acc = acc + torch.matmul(weight.transpose(1, 2),
                                     data[:, 8:16].transpose(1, 2))
        return {"T": T, "sat": sat, "acc": acc}

    return C.chunk_walk(slab, tile_starts, tile_ends, state, step)["acc"]


def kernel_ablate(slab, tile_starts, tile_ends, *, mode, num_tiles,
                  tiles_per_row):
    """The probe on a (16, MK) f32 slab (MK a multiple of 128) and int32
    tile ranges: CPU tensors take the plain version, CUDA tensors launch
    the kernel (and count the launch), any other device raises."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    kind = C.check_inputs("kernel_ablate", slab, tile_starts, tile_ends,
                          num_tiles)
    if kind == "cpu":
        return kernel_ablate_torch(slab, tile_starts, tile_ends, mode=mode,
                                   num_tiles=num_tiles,
                                   tiles_per_row=tiles_per_row)
    out = C.launch_slab_probe(
        "t3dgs_probe_kernel_ablate", slab, tile_starts, tile_ends,
        mode_index=MODES.index(mode), num_tiles=num_tiles,
        tiles_per_row=tiles_per_row, out_shape=(num_tiles, C.PIXELS, 8))
    launch_counts[mode] += 1
    return out


def time_modes(slab, tile_starts, tile_ends, reps=REPS):
    """{mode: ms a frame} of the kernel on S3's layout, by CUDA events."""
    kw = dict(num_tiles=NUM_TILES, tiles_per_row=TILES_PER_ROW)
    return {mode: C.time_ms(lambda: kernel_ablate(slab, tile_starts,
                                                  tile_ends, mode=mode, **kw),
                            reps)
            for mode in MODES}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
    C.require_card()
    name, limit = C.card()
    slab, starts, ends = layout()
    for mode, ms in time_modes(slab, starts, ends).items():
        C.emit({"probe": "S3", "mode": mode, "ms": ms, "ms_per_frame": ms,
                "reps": REPS, "card": name, "power_limit": limit})


if __name__ == "__main__":
    main()
