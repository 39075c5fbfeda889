"""What the probes share: the card checks and CUDA-event timing of their
entry points, the 976x544 inputs of the port's render, and the plain
versions' building blocks (the TPU probes' 128-key chunk walk, their
log-doubling prefix scans and scan-free saturation masks)."""

from __future__ import annotations

import json
import subprocess

import torch

from ..camera import TILE_HEIGHT, TILE_WIDTH
from ..ops import blend_cuda as BC

# keys per chunk of the TPU probes
CHUNK = 128
PIXELS = TILE_WIDTH * TILE_HEIGHT


def require_card():
    """Raise unless a CUDA card is present: a probe measures the card, and
    has no CPU path."""
    if not torch.cuda.is_available():
        raise RuntimeError("this probe times its CUDA kernel and needs a "
                           "CUDA card: torch.cuda.is_available() is False")


def card():
    """(name, power limit) of card 0 as nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def time_ms(fn, reps, warmup=2):
    """Mean device time of fn() over `reps` back-to-back calls, by CUDA
    events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def emit(record):
    print(json.dumps(record), flush=True)


def render_slab(scene, device):
    """The wide16 slab and tile ranges of the port's projection and binning
    of a bench scene at the bench's camera (976x544, fx 581.7), near 0.4,
    the identity pose: "430k", the scene `bench.load_scene` gives (the
    bench's synthetic 430k scene unless BENCH_* settings choose another),
    or "heavy", the 1.03M heavy-tailed checkpoint. Returns (slab (16, MK)
    f32, tile_starts, tile_ends, camera)."""
    from .. import bench
    from ..ops.rasterizer import RasterizerConfig, _project_and_bin
    if scene == "heavy":
        pc, feats = (torch.as_tensor(x, device=device)
                     for x in bench._heavy_tailed_checkpoint(1030000))
    elif scene == "430k":
        pc, feats = bench.load_scene(device)
    else:
        raise ValueError(f"scene is '430k' or 'heavy', got {scene!r}")
    cam = bench.bench_camera()
    with torch.no_grad():
        binning = _project_and_bin(
            *bench._scene(pc, feats), *bench._identity_pose(device), cam,
            RasterizerConfig(near_plane=bench.NEAR, far_plane=bench.FAR),
            None)[3]
    return binning.point_data, binning.tile_starts, binning.tile_ends, cam


def pad_columns(slab, multiple=CHUNK):
    """`slab` with zero columns appended up to a multiple of `multiple`
    columns (a chunk of the TPU probes reads whole 128-key blocks)."""
    pad = -slab.shape[1] % multiple
    if pad == 0:
        return slab.contiguous()
    return torch.cat([slab, slab.new_zeros((slab.shape[0], pad))], dim=1)


def check_inputs(name, slab, tile_starts, tile_ends, num_tiles):
    """The probe kernels' inputs: a (16, MK) f32 slab with MK a multiple of
    128, int32 (num_tiles,) ranges, all contiguous on one device. Returns
    the device type ("cpu" or "cuda"); any other device raises."""
    if slab.dim() != 2 or slab.shape[0] != BC.NUM_DATA_ROWS:
        raise ValueError(f"{name}: slab must be (16, MK), got "
                         f"{tuple(slab.shape)}")
    if slab.dtype != torch.float32:
        raise TypeError(f"{name}: slab must be float32, got {slab.dtype}")
    if slab.shape[1] % CHUNK != 0:
        raise ValueError(f"{name}: slab columns must be a multiple of "
                         f"{CHUNK} (pad_columns), got {slab.shape[1]}")
    if num_tiles < 1:
        raise ValueError(f"{name}: num_tiles must be >= 1, got {num_tiles}")
    for label, t in (("tile_starts", tile_starts), ("tile_ends", tile_ends)):
        if t.dtype != torch.int32 or tuple(t.shape) != (num_tiles,):
            raise ValueError(f"{name}: {label} must be int32 of shape "
                             f"({num_tiles},), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != slab.device:
            raise ValueError(f"{name}: {label} is on {t.device}, the slab "
                             f"on {slab.device}")
    for label, t in (("slab", slab), ("tile_starts", tile_starts),
                     ("tile_ends", tile_ends)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    kind = slab.device.type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"{name} runs on cpu or cuda tensors, got "
                           f"{slab.device}")
    return kind


def stream_of(tensor):
    return torch.cuda.current_stream(tensor.device).cuda_stream


def launch_slab_probe(symbol, slab, tile_starts, tile_ends, *, mode_index,
                      num_tiles, tiles_per_row, out_shape):
    """Launch the probe library's slab kernel `symbol` (data, ranges,
    num_tiles, mk, tiles_per_row, mode, out, stream) on CUDA inputs that
    check_inputs passed; returns its float32 output of `out_shape`."""
    from ..ops._build import load_probe_library
    lib = load_probe_library()
    out = torch.empty(out_shape, dtype=torch.float32, device=slab.device)
    with torch.cuda.device(slab.device):
        err = getattr(lib, symbol)(
            slab.data_ptr(), tile_starts.data_ptr(), tile_ends.data_ptr(),
            num_tiles, slab.shape[1], tiles_per_row, mode_index,
            out.data_ptr(), stream_of(slab))
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error "
                           f"{err}")
    return out


def doubling_scan(x, dim, *, op="mul", exclusive=True):
    """Prefix product (op "mul") or sum ("add") along `dim` by the TPU
    probes' log-doubling scan (blend_pallas.py _sub_cumprod_exclusive /
    _sub_cumsum_exclusive, roll as jnp.roll): for k = 1, 2, ... below the
    length, acc = acc op (pos < k ? identity : roll(acc, k)), the same
    operations in the same order, so that it rounds as they do. An
    exclusive scan first shifts by one (identity at position 0); an
    inclusive one (scratch/perf_roll_micro.py's lane and sub) does not."""
    if op not in ("mul", "add"):
        raise ValueError(f"op is 'mul' or 'add', got {op!r}")
    combine = torch.mul if op == "mul" else torch.add
    identity = torch.ones_like(x) if op == "mul" else torch.zeros_like(x)
    n = x.shape[dim]
    pos = torch.arange(n, device=x.device).view(
        [n if d == dim % x.dim() else 1 for d in range(x.dim())])
    acc = (torch.where(pos < 1, identity, torch.roll(x, 1, dim)) if exclusive
           else x)
    k = 1
    while k < n:
        acc = combine(acc, torch.where(pos < k, identity,
                                       torch.roll(acc, k, dim)))
        k *= 2
    return acc


def saturation_masks(a_v, t_i, one_minus, T, sat):
    """The TPU probes' scan-free saturation (blend_pallas.py
    _saturation_masks) with keys on dim 1: a_v, t_i, one_minus (A, keys,
    256), T and sat (A, 256). Returns (contribute, T, sat)."""
    tnext = t_i * one_minus
    positive = (a_v > 0.0).to(a_v.dtype)
    hit = positive * (tnext < BC.TRANSMITTANCE_SATURATION).to(a_v.dtype)
    contribute = (positive
                  * (tnext >= BC.TRANSMITTANCE_SATURATION).to(a_v.dtype)
                  * (1.0 - sat)[:, None])
    col_hit = hit.amax(dim=1)
    t_at_hit = (t_i * hit).amax(dim=1)
    t_new = torch.where(col_hit > 0.5, t_at_hit, tnext[:, -1])
    t_new = torch.where(sat > 0.5, T, t_new)
    return contribute, t_new, torch.maximum(sat, col_hit)


def chunk_walk(slab, tile_starts, tile_ends, state, step):
    """The TPU probes' loop, vectorised over the tiles: each tile's range
    [start, end) clamped into [0, MK] is walked in chunks of CHUNK columns
    from aligned = start // CHUNK * CHUNK; chunk i of every tile that has
    one and whose pixels have not all latched (state["sat"] > 0.5) is
    handed to step(sub_state, data (a, 16, CHUNK), in_seg (a, CHUNK) bool,
    rows (a,)) as a dict of those tiles' state rows; `rows` are their ids.
    `state` is a dict of tensors whose first dimension is the tile; the
    tiles of a mode that never latches walk every chunk. Returns it."""
    mk = slab.shape[1]
    start = tile_starts.long().clamp(0, mk)
    end = torch.maximum(tile_ends.long().clamp(max=mk), start)
    aligned = start // CHUNK * CHUNK
    chunks = torch.where(end > start, (end - aligned + CHUNK - 1) // CHUNK,
                         torch.zeros_like(start))
    lane = torch.arange(CHUNK, device=slab.device)
    for i in range(int(chunks.max())):
        live = (chunks > i) & ~(state["sat"] > 0.5).all(dim=1)
        rows = torch.nonzero(live).flatten()
        if rows.numel() == 0:
            break
        cols = aligned[rows, None] + i * CHUNK + lane[None]     # (a, CHUNK)
        data = slab[:, cols].permute(1, 0, 2)                   # (a, 16, C)
        in_seg = (cols >= start[rows, None]) & (cols < end[rows, None])
        sub = step({k: v[rows] for k, v in state.items()}, data, in_seg,
                   rows)
        for k, v in sub.items():
            state[k][rows] = v
    return state
