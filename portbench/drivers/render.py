"""Traffic kind `render`: a closed loop of frames through the port's
`rasterize(rgb_only=True)`, one caller waiting for each frame, cycling
poses drawn from the seed (`harness.inputs.poses`).

Set-up builds the kernels, draws the scene on the device and renders every
pose once. The window renders frames until `--seconds` have passed; a
frame's latency runs from the start of its call to its synchronized end.
The images of `sample_frames` frames, drawn from the seed among the first
`sample_from_first`, are kept and, once the window has closed and the
memory peak is read, compared with the plain reference's renders of the
same poses (colours rounded to bfloat16 where the configuration's slab,
`packed8`, carries them so).

With `--trace 1`, after the window: `events_rounds` rounds over
`work_poses` poses drawn from the seed, timed by CUDA events, then
`trace_rounds` rounds under torch.profiler; the work of those poses comes
from the reference's pair counts (`work/`).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from portbench.harness import clock, inputs, trace
from portbench.harness.main import RunResult, note
from portbench.reference import compare
from portbench.reference import projection as RP
from portbench.reference import raster as RR
from portbench.work.unit import frame_work

# the type in which each render slab carries the colours
SLAB_COLOURS = {"packed8": torch.bfloat16, "wide16": None}


class Setup(NamedTuple):
    pc: torch.Tensor
    feats: torch.Tensor
    q: torch.Tensor          # (P, 1, 4) on the device
    t: torch.Tensor
    frame: object            # frame(pose index) -> the program's image
    ref_cam: RP.Camera
    render: dict             # the configuration's render settings


def setup(cell, seed: int, device) -> Setup:
    from taichi_3d_gaussian_splatting_torch.camera import CameraInfo
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    from taichi_3d_gaussian_splatting_torch.ops import _build
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        RasterizerConfig, rasterize)
    if device.type == "cuda":
        _build.load_library()
    cfg, tr = cell.config, cell.traffic
    fx, fy, cx, cy, width, height = inputs.camera(cfg)
    cam = CameraInfo(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                              np.float32), height, width)
    n = int(cfg["points"])
    pc, feats = inputs.scene(cfg, n, torch.Generator(device).manual_seed(
        seed))
    scene = GaussianPointCloudScene(
        pc, feats, torch.zeros(n, dtype=torch.int8, device=device),
        torch.zeros(n, dtype=torch.int32, device=device))
    q, t = (x.to(device) for x in inputs.poses(tr, int(tr["poses"]), seed))
    r = cfg["render"]
    raster_cfg = RasterizerConfig(
        near_plane=r["near"], far_plane=r["far"],
        depth_to_sort_key_scale=r["depth_to_sort_key_scale"], rgb_only=True,
        slab_format=r["slab"])

    def frame(i):
        with torch.no_grad():
            return rasterize(*scene, q[i], t[i], cam, raster_cfg).image

    return Setup(pc, feats, q, t, frame,
                 RP.Camera(fx, fy, cx, cy, width, height), r)


def reference_image(s: Setup, pose: int, dtype=torch.float32,
                    counts: bool = False):
    """The plain reference's render of pose `pose` (with `counts`, also
    its pairs). `dtype` other than float32 computes the blend's inputs and
    pairs in that type (the control)."""
    invalid = torch.zeros(s.pc.shape[0], dtype=torch.int8,
                          device=s.pc.device)
    r = s.render

    def project():
        return RP.project(s.pc, s.feats, invalid, s.q[pose], s.t[pose],
                          s.ref_cam, r["near"], r["far"])

    return RR.render_view(project, r["depth_to_sort_key_scale"], s.ref_cam,
                          dtype, counts, colour_round=SLAB_COLOURS[r["slab"]])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(cell, args, t0: float) -> RunResult:
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    tr = cell.traffic
    s = setup(cell, args.seed, device)
    note(t0, "scene drawn")
    poses = s.q.shape[0]
    for i in range(poses):
        s.frame(i)
    _sync(device)
    setup_s = time.time() - t0

    sample = set(inputs.sample(args.seed, inputs.SAMPLE,
                               int(tr["sample_from_first"]),
                               int(tr["sample_frames"])))
    kept = {}
    latencies = []
    start = time.perf_counter()
    frames = 0
    while True:
        a = time.perf_counter()
        image = s.frame(frames % poses)
        if frames in sample:
            kept[frames] = image.clone()
        _sync(device)
        b = time.perf_counter()
        latencies.append(b - a)
        frames += 1
        if b - start >= args.seconds:
            break
    window_s = b - start
    half = len(latencies) // 2
    note(t0, f"window: {frames} frames in {window_s:.3f} s (mean latency "
             f"{np.mean(latencies[:half]) * 1e3:.4f} ms, then "
             f"{np.mean(latencies[half:]) * 1e3:.4f} ms)")
    e2e = {"setup_s": setup_s, "frame_ms": window_s / frames * 1e3,
           "frame_p95_ms": float(np.percentile(latencies, 95)) * 1e3}

    readings, summary = {}, None
    work_poses = inputs.sample(args.seed, inputs.WORK, poses,
                               int(tr["work_poses"]))
    if args.trace and device.type == "cuda":
        k = len(work_poses)
        readings["unit_ms"], _ = clock.timed_units(
            lambda j, mark: s.frame(work_poses[j % k]),
            int(tr["events_rounds"]) * k)
        units = int(tr["trace_rounds"]) * k
        summary = trace.summarize(trace.run_traced(
            lambda j: s.frame(work_poses[j % k]), units), units)
        readings["trace"] = summary
        note(t0, f"per-layer stretch: {readings['unit_ms']:.4f} ms a frame "
                 f"by CUDA events")
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    note(t0, "per-layer stretches done" if args.trace else "peak read")
    refs = [reference_image(s, i % poses) for i in sorted(kept)]
    checks = (compare.image_readings([kept[i] for i in sorted(kept)], refs)
              if kept else {})
    note(t0, f"{len(kept)} frames compared")
    if args.trace and device.type == "cuda":
        num_tiles = s.ref_cam.tiles_x * s.ref_cam.tiles_y
        works = [frame_work(reference_image(s, p, counts=True)[1],
                            s.pc.shape[0], num_tiles) for p in work_poses]
        readings["work"] = {
            "flops": float(np.mean([w["flops"] for w in works])),
            "blend_forward_bound_ms": float(np.mean(
                [w["k1"]["bound_ms"] for w in works])),
            "projection_forward_bound_ms": works[0]["p1"]["bound_ms"]}
        note(t0, "work counted")
    return RunResult(frames, 0, e2e, readings, checks, peak, summary)
