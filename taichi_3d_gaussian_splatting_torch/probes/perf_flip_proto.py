"""S2: keys by pixels, the exponent as a tensor-core product of per-key
coefficient rows and per-pixel monomials in absolute coordinates.

    python -m taichi_3d_gaussian_splatting_torch.probes.perf_flip_proto \
        [--scene s2|430k]

Replaces the TPU probe scratch/perf_flip_proto.py:140 (the pl.pallas_call
that build(mode), :139, makes of make_kern(mode), :40); the kernel is
csrc/probes/perf_flip_proto.cu (its header says why the product is FP64).
Slab rows 0-5 are c_xx, c_xy, c_yy, c_x, c_y, c_1 of the exponent
E = c_xx px^2 + c_xy px py + c_yy py^2 + c_x px + c_y py + c_1 (rows 6, 7
meet zero monomials), rows 8-15 are accumulated. Per 128-key chunk:
alpha = exp(E) with K1's skip, clamp and saturation; output (num_tiles, 8,
256) f32 rows [acc0, acc1, acc2, acc3, 1 - T, acc5, acc6, acc7]. Modes
``full`` and ``no_scan`` (every key of a chunk sees its starting T).

Layouts: ``s2``, the TPU probe's own (its :144-165: S3's tiles, ranges and
positions, conics 0.1, 0, 0.1, logw -1); ``430k``, the render's wide16 slab
of the bench's 430k scene rewritten into these rows (`from_wide16`).
`main` prints one JSON line per mode: ms a frame (CUDA events, the TPU
probe's 30 calls), the card's name and power limit. It needs a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import blend_cuda as BC
from ..ops.gaussian import ALPHA_SKIP_THRESHOLD
from . import _common as C
from .perf_kernel_ablate import KEYS, NUM_TILES, SLAB_COLUMNS, TILES_PER_ROW

REPLACES = "scratch/perf_flip_proto.py:140"
SOURCE = "taichi_3d_gaussian_splatting_torch/csrc/probes/perf_flip_proto.cu"
MODES = ("full", "no_scan")
REPS = 30   # the TPU probe's timed calls a round
C_XX, C_XY, C_YY, C_X, C_Y, C_1 = range(6)

# kernel launches per mode, counted by the wrapper when it launches
launch_counts = {mode: 0 for mode in MODES}


def reset_launch_counts():
    for mode in launch_counts:
        launch_counts[mode] = 0


def layout(device="cuda"):
    """The TPU probe's slab and ranges, built as its :144-165 build them
    (numpy float32): (slab (16, 786432) f32, tile_starts, tile_ends)."""
    rng = np.random.default_rng(0)
    u = rng.uniform(0, 976, SLAB_COLUMNS).astype(np.float32)
    v = rng.uniform(0, 544, SLAB_COLUMNS).astype(np.float32)
    ca = np.full(SLAB_COLUMNS, 0.1, np.float32)
    cb = np.zeros(SLAB_COLUMNS, np.float32)
    cc = np.full(SLAB_COLUMNS, 0.1, np.float32)
    logw = np.full(SLAB_COLUMNS, -1.0, np.float32)
    data = np.zeros((16, SLAB_COLUMNS), np.float32)
    data[C_XX] = -0.5 * ca
    data[C_XY] = -cb
    data[C_YY] = -0.5 * cc
    data[C_X] = ca * u + cb * v
    data[C_Y] = cc * v + cb * u
    data[C_1] = logw - 0.5 * (ca * u * u + 2 * cb * u * v + cc * v * v)
    data[8:11] = 0.5
    data[11] = 10.0
    data[12] = 1.0
    edges = np.linspace(0, KEYS, NUM_TILES + 1).astype(np.int32)
    return (torch.as_tensor(data, device=device),
            torch.as_tensor(edges[:-1], device=device),
            torch.as_tensor(edges[1:], device=device))


def from_wide16(slab):
    """A wide16 slab (u, v, a, b, c, logw, ...) rewritten into S2's rows:
    the coefficients of -0.5 (a dx^2 + c dy^2) - b dx dy + logw expanded in
    absolute pixel coordinates, formed in float64 and rounded to float32
    once each; rows 8-15 as they are."""
    u, v, a, b, c, logw = (slab[r].double() for r in range(6))
    out = torch.zeros_like(slab)
    out[C_XX] = (-0.5 * a).float()
    out[C_XY] = (-b).float()
    out[C_YY] = (-0.5 * c).float()
    out[C_X] = (a * u + b * v).float()
    out[C_Y] = (c * v + b * u).float()
    out[C_1] = (logw - 0.5 * (a * u * u + 2.0 * b * u * v + c * v * v)
                ).float()
    out[8:16] = slab[8:16]
    return out


def _monomials(px, py):
    """(a, 256, 8) f32 [px^2, px py, py^2, px, py, 1, 0, 0]."""
    one = torch.ones_like(px)
    zero = torch.zeros_like(px)
    return torch.stack([px * px, px * py, py * py, px, py, one, zero, zero],
                       dim=2)


def _exponent(data, mono, dtype):
    """E (a, C, 256) = coef^T . mono, the product in `dtype`, as float32."""
    return torch.matmul(data[:, 0:8].transpose(1, 2).to(dtype),
                        mono.transpose(1, 2).to(dtype)).float()


def flip_proto_torch(slab, tile_starts, tile_ends, *, mode, num_tiles,
                     tiles_per_row, exponent_dtype=torch.float32):
    """Plain version of the TPU probe's body: the exponent product (in
    float32 by default, as the probe's; float64 rounds it as the kernel's
    FP64 product does), the log-doubling prefix product and the saturation
    masks.
    Returns (num_tiles, 8, 256) f32."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    device = slab.device
    n = num_tiles
    mono_all = _monomials(*BC._pixel_centres(num_tiles, tiles_per_row,
                                             device))
    state = {"T": torch.ones((n, C.PIXELS), device=device),
             "sat": torch.zeros((n, C.PIXELS), device=device),
             "acc": torch.zeros((n, 8, C.PIXELS), device=device)}

    def step(st, data, in_seg, rows):
        T, sat = st["T"], st["sat"]
        a_exp = torch.exp(_exponent(data, mono_all[rows], exponent_dtype))
        a_v = torch.where(in_seg[:, :, None]
                          & (a_exp >= ALPHA_SKIP_THRESHOLD),
                          torch.clamp(a_exp, max=BC.ALPHA_CLAMP),
                          torch.zeros_like(a_exp))
        one_minus = 1.0 - a_v
        if mode == "no_scan":
            t_i = T[:, None] * one_minus
        else:
            t_i = T[:, None] * C.cumprod_exclusive(one_minus, 1)
        contribute, T, sat = C.saturation_masks(a_v, t_i, one_minus, T, sat)
        weight = contribute * a_v * t_i
        return {"T": T, "sat": sat,
                "acc": st["acc"] + torch.matmul(data[:, 8:16], weight)}

    state = C.chunk_walk(slab, tile_starts, tile_ends, state, step)
    acc = state["acc"]
    return torch.cat([acc[:, 0:4], (1.0 - state["T"])[:, None], acc[:, 5:8]],
                     dim=1)


def decision_flips(slab, tile_starts, tile_ends, *, num_tiles,
                   tiles_per_row):
    """The blend decisions of `full` that flip between the exponent as
    float32 computes it (the probe's) and as float64 rounds it (the
    kernel's): {"skip": (pixel, key) pairs in a tile's range whose 1/255
    skip differs, "pairs": such pairs walked, "saturation": pixels whose
    saturating key (or none) differs, "pixels"}. Each run carries its own
    transmittance; the walk stops where both have latched every pixel."""
    device = slab.device
    n = num_tiles
    mono_all = _monomials(*BC._pixel_centres(num_tiles, tiles_per_row,
                                             device))
    shape = (n, C.PIXELS)
    counter = torch.zeros(n, dtype=torch.int64, device=device)
    # "chunk": the chunks walked so far (a tile's chunk i is its i-th step)
    state = {"sat": torch.zeros(shape, device=device), "skip": counter,
             "pairs": counter.clone(), "chunk": counter.clone()}
    runs = (torch.float32, torch.float64)
    for r in range(2):
        state[f"T{r}"] = torch.ones(shape, device=device)
        state[f"sat{r}"] = torch.zeros(shape, device=device)
        state[f"pos{r}"] = torch.full(shape, -1, dtype=torch.int64,
                                      device=device)

    def step(st, data, in_seg, rows):
        out = {}
        live = []
        for r, dtype in enumerate(runs):
            a_exp = torch.exp(_exponent(data, mono_all[rows], dtype))
            ok = in_seg[:, :, None] & (a_exp >= ALPHA_SKIP_THRESHOLD)
            live.append(ok)
            a_v = torch.where(ok, torch.clamp(a_exp, max=BC.ALPHA_CLAMP),
                              torch.zeros_like(a_exp))
            one_minus = 1.0 - a_v
            T, sat = st[f"T{r}"], st[f"sat{r}"]
            t_i = T[:, None] * C.cumprod_exclusive(one_minus, 1)
            hit = (a_v > 0) & (t_i * one_minus < BC.TRANSMITTANCE_SATURATION)
            # the pixel's first saturating key, as its position in the
            # tile's walk
            first = torch.argmax(hit.to(torch.int8), dim=1)      # (a, 256)
            new = hit.any(dim=1) & (sat < 0.5)
            out[f"pos{r}"] = torch.where(
                new, st["chunk"][:, None] * C.CHUNK + first, st[f"pos{r}"])
            _, out[f"T{r}"], out[f"sat{r}"] = C.saturation_masks(
                a_v, t_i, one_minus, T, sat)
        both = in_seg[:, :, None].expand_as(live[0])
        out["skip"] = st["skip"] + (live[0] != live[1]).sum(dim=(1, 2))
        out["pairs"] = st["pairs"] + both.sum(dim=(1, 2))
        out["sat"] = torch.minimum(out["sat0"], out["sat1"])
        out["chunk"] = st["chunk"] + 1
        return out

    state = C.chunk_walk(slab, tile_starts, tile_ends, state, step)
    return {"skip": int(state["skip"].sum()),
            "pairs": int(state["pairs"].sum()),
            "saturation": int((state["pos0"] != state["pos1"]).sum()),
            "pixels": n * C.PIXELS}


def flip_proto(slab, tile_starts, tile_ends, *, mode, num_tiles,
               tiles_per_row):
    """The probe on a (16, MK) f32 slab of S2's rows (MK a multiple of 128)
    and int32 tile ranges: CPU tensors take the plain version, CUDA tensors
    launch the kernel (and count the launch), any other device raises."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    kind = C.check_inputs("flip_proto", slab, tile_starts, tile_ends,
                          num_tiles)
    if kind == "cpu":
        return flip_proto_torch(slab, tile_starts, tile_ends, mode=mode,
                                num_tiles=num_tiles,
                                tiles_per_row=tiles_per_row)
    if slab.data_ptr() % 16 != 0:
        raise ValueError("flip_proto: the slab must be 16-byte aligned")
    out = C.launch_slab_probe(
        "t3dgs_probe_flip_proto", slab, tile_starts, tile_ends,
        mode_index=MODES.index(mode), num_tiles=num_tiles,
        tiles_per_row=tiles_per_row, out_shape=(num_tiles, 8, C.PIXELS))
    launch_counts[mode] += 1
    return out


def inputs(scene, device="cuda"):
    """(slab of S2's rows, tile_starts, tile_ends, num_tiles, tiles_per_row)
    of layout `scene`: "s2" or "430k"."""
    if scene == "s2":
        return (*layout(device), NUM_TILES, TILES_PER_ROW)
    slab, starts, ends, cam = C.render_slab(scene, torch.device(device))
    return (from_wide16(C.pad_columns(slab)), starts, ends, cam.num_tiles,
            cam.tiles_per_row)


def time_modes(slab, tile_starts, tile_ends, num_tiles, tiles_per_row,
               reps=REPS):
    """{mode: ms a frame} of the kernel, by CUDA events."""
    kw = dict(num_tiles=num_tiles, tiles_per_row=tiles_per_row)
    return {mode: C.time_ms(lambda: flip_proto(slab, tile_starts, tile_ends,
                                               mode=mode, **kw), reps)
            for mode in MODES}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scene", choices=("s2", "430k"), default="s2")
    args = parser.parse_args(argv)
    C.require_card()
    name, limit = C.card()
    layout_inputs = inputs(args.scene)
    for mode, ms in time_modes(*layout_inputs).items():
        C.emit({"probe": "S2", "mode": mode, "scene": args.scene, "ms": ms,
                "ms_per_frame": ms, "reps": REPS, "card": name,
                "power_limit": limit})


if __name__ == "__main__":
    main()
