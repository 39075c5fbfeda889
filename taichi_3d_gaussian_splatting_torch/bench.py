"""Benchmark on one CUDA card: render FPS and training-step time at the
reference's benchmark workload, with the record of the repository's
`bench.py` (the JAX/TPU bench).

    python -m taichi_3d_gaussian_splatting_torch.bench [--device cuda|cpu]

The workload is `bench.py`'s: 976x544, fx = fy = 581.7, near 0.4, far
1000, an identity camera, and the scene from

- `BENCH_SCENE` (a parquet, or a `.ply`), else
- `BENCH_SCENE_KIND=heavy`: the heavy-tailed synthetic checkpoint of
  `benchmark/synthetic_checkpoint.py` at `BENCH_POINTS` (default
  1,030,000), else
- the uniform synthetic scene at `BENCH_POINTS` (default 430,000, the
  reference's Truck checkpoint size), from `np.random.default_rng(0)`.

`BENCH_SPATIAL_SORT=1` Morton-orders the scene first (off by default).
The render (`rasterize(rgb_only=True)`, blend slab `BENCH_SLAB_FORMAT`,
default auto = packed8) runs one probe frame, 1 + 10 warm-up frames and
`BENCH_ITERS` (default 50) timed frames. With `BENCH_TRAIN=1` (the
default) it then times `BENCH_TRAIN_ITERS` (default 20) training steps
after 4 warm-up steps (forward, L1 + SSIM loss, backward, Adam at 1e-3 on
the features and 1e-5 on the positions, controller statistics) and 10
densify rounds after one. Each loop is timed as a whole on the host clock
between two synchronizations, host work included: the binning reads its
key count on the host, so frames do not overlap.

`BENCH_CHUNK`, `BENCH_SLAB_GATHER`, `BENCH_POOL_META`, `BENCH_TIER_A` and
`BENCH_PROBE_TIMEOUT` are accepted and ignored: they tune the JAX
package's static capacity layout and its TPU probe, and this package has
neither.

Prints one JSON line, the last of standard output, with `bench.py`'s keys
(`metric`, `value` in FPS, `unit`, `vs_baseline`, `baseline_points`,
`slab_format`, the three dropped-work counters, always 0 here, and with
training `train_step_ms`, `densify_ms`, `train_step_amortized_ms`,
`train_iters_per_sec`) plus `backend`, `device` and `power_limit_w`.
Standard error carries the peak device memory and the blend and
projection kernels' launch counts over the run. Without a CUDA card (and no `--device cpu`),
or when the kernels do not build, it prints `bench.py`'s error record
(`value` 0.0 and an `error`) and exits 2; there is no CPU fallback. When
the training measurement fails it prints the render record with a
`train_error` and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch

from .camera import CameraInfo
from .models.scene import GaussianPointCloudScene
from .ops import _build
from .ops.rasterizer import (RasterizerConfig, _resolve_slab_format,
                             rasterize, rasterize_with_vjp)
from .ops.sh import feature_sh_band_mask
from .training.adam import AdamGroup, AdamState, adam_init
from .training.adam_cuda import optimizer_update
from .training.controller import (AdaptiveControllerConfig, ControllerState,
                                  densify_step, update_stats)
from .training.loss import LossFunction, LossFunctionConfig
from .training.step import view_gradients

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the Taichi reference's RTX 3090 bars (reference: benchmark/README.md:24,
# 3, 8, 31-32): 15.84 ms at 430k, 13.41 ms at 1.03M, 15.01 ms at 2.08M
BASELINE_FPS = 63.1
BASELINE_FPS_BY_POINTS = {430000: BASELINE_FPS,
                          1030000: 1000.0 / 13.41, 2080000: 1000.0 / 15.01}

H, W, FOCAL = 544, 976, 581.7
NEAR, FAR = 0.4, 1000.0
WARMUP_FRAMES = 1 + 10
TRAIN_WARMUP = 4
DENSIFY_REPS = 10
FEATURE_LR, POSITION_LR = 1e-3, 1e-5
# densify runs every 100 steps (the reference controller's default), so
# the amortized step adds densify_ms / 100
DENSIFY_INTERVAL = 100


def _baseline_fps(n_points: int) -> float:
    """Reference bar for the nearest published point count."""
    return BASELINE_FPS_BY_POINTS[_baseline_points(n_points)]


def _baseline_points(n_points: int) -> int:
    return min(BASELINE_FPS_BY_POINTS, key=lambda k: abs(k - n_points))


def _bench_metric_name() -> str:
    """The headline metric name, the same for success and error records."""
    n = int(os.environ.get(
        "BENCH_POINTS",
        "1030000" if os.environ.get("BENCH_SCENE_KIND", "") == "heavy"
        else "430000"))
    return f"render_fps_976x544_{round(n / 1000)}k_points"


def _emit_error_record(detail: str) -> None:
    print(json.dumps({
        "metric": _bench_metric_name(),
        "value": 0.0,
        "unit": "fps",
        "vs_baseline": 0.0,
        "error": detail,
    }), flush=True)
    raise SystemExit(2)


def bench_camera(height: int = H, width: int = W,
                 focal: float = FOCAL) -> CameraInfo:
    intr = np.array([[focal, 0, width / 2], [0, focal, height / 2],
                     [0, 0, 1]], np.float32)
    return CameraInfo(camera_intrinsics=intr, camera_height=height,
                      camera_width=width)


def _identity_pose(device):
    return (torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=device),
            torch.zeros((1, 3), device=device))


def _scene(pc, feats) -> GaussianPointCloudScene:
    """All points valid, one object."""
    n = pc.shape[0]
    return GaussianPointCloudScene(
        pc, feats, torch.zeros((n,), dtype=torch.int8, device=pc.device),
        torch.zeros((n,), dtype=torch.int32, device=pc.device))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _spatial_sort(pc, feats):
    """Morton-order the scene when BENCH_SPATIAL_SORT=1 (off by default,
    as in bench.py)."""
    if os.environ.get("BENCH_SPATIAL_SORT", "0") != "1":
        return pc, feats
    scene = _scene(pc, feats).spatially_sorted()
    return scene.point_cloud, scene.point_cloud_features


def _heavy_tailed_checkpoint(n: int):
    """benchmark/synthetic_checkpoint.py's scene (numpy only; `benchmark/`
    is a directory of scripts, not a package)."""
    bench_dir = os.path.join(REPO_ROOT, "benchmark")
    if not os.path.isfile(os.path.join(bench_dir, "synthetic_checkpoint.py")):
        raise ImportError(f"BENCH_SCENE_KIND=heavy needs "
                          f"{bench_dir}/synthetic_checkpoint.py: run from a "
                          f"checkout of the repository")
    if bench_dir not in sys.path:
        sys.path.insert(0, bench_dir)
    from synthetic_checkpoint import make_heavy_tailed_checkpoint
    return make_heavy_tailed_checkpoint(n, np.random.default_rng(0))


def load_scene(device):
    """(positions (N, 3), features (N, 56)) on `device`, chosen by the
    environment as bench.py's `load_scene` chooses it."""
    path = os.environ.get("BENCH_SCENE", "")
    if path:
        load = (GaussianPointCloudScene.from_ply if path.endswith(".ply")
                else GaussianPointCloudScene.from_parquet)
        scene = load(path, device=device)
        return _spatial_sort(scene.point_cloud, scene.point_cloud_features)
    if os.environ.get("BENCH_SCENE_KIND", "") == "heavy":
        pc, feats = _heavy_tailed_checkpoint(
            int(os.environ.get("BENCH_POINTS", "1030000")))
    else:
        n = int(os.environ.get("BENCH_POINTS", "430000"))
        rng = np.random.default_rng(0)
        pc = np.stack([rng.uniform(-30, 30, n), rng.uniform(-20, 20, n),
                       rng.uniform(2, 60, n)], 1).astype(np.float32)
        feats = np.zeros((n, 56), np.float32)
        q = rng.normal(size=(n, 4))
        feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
        feats[:, 4:7] = rng.uniform(-3.5, -2.0, (n, 3))
        feats[:, 7] = rng.normal(size=n)
        feats[:, 8] = rng.normal(size=n)
        feats[:, 24] = rng.normal(size=n)
        feats[:, 40] = rng.normal(size=n)
    return _spatial_sort(
        torch.tensor(np.asarray(pc, np.float32), device=device),
        torch.tensor(np.asarray(feats, np.float32), device=device))


def measure_render(pc, feats, cam: CameraInfo, cfg: RasterizerConfig,
                   device, iters: int, warmup: int = WARMUP_FRAMES):
    """(ms per frame over `iters` frames after one probe frame and `warmup`
    frames, the probe frame's RasterizerAux)."""
    scene = _scene(pc, feats)
    q, t = _identity_pose(device)

    def frame():
        with torch.no_grad():
            return rasterize(*scene, q, t, cam, cfg)

    probe = frame()
    for _ in range(warmup):
        frame()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        frame()
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e3, probe.aux


class TrainState(NamedTuple):
    point_cloud: torch.Tensor
    point_cloud_features: torch.Tensor
    opt_features: AdamState
    opt_positions: AdamState
    ctrl: ControllerState


def initial_train_state(pc, feats) -> TrainState:
    return TrainState(pc, feats, adam_init(feats), adam_init(pc),
                      ControllerState.zeros(pc.shape[0], pc.device))


def _train_config() -> RasterizerConfig:
    return RasterizerConfig(near_plane=NEAR, far_plane=FAR)


def make_train_step(cam: CameraInfo, device):
    """bench.py's training step (`:352-375`) on `device`: `step(state) ->
    (state, loss)`. The image clipped to [0, 1] is held against a uniform
    image of `default_rng(1)`, and the rasterizer's feature gradients are
    masked to SH band 3, with no per-group scaling and no schedules; the
    update is the trainer's `optimizer_update` (Adam on the normalized
    quaternions)."""
    cfg = _train_config()
    q, t = _identity_pose(device)
    gt = torch.tensor(np.random.default_rng(1).uniform(
        0, 1, (cam.camera_height, cam.camera_width, 3)).astype(np.float32),
        device=device)
    loss_fn = LossFunction(LossFunctionConfig())
    band_mask = feature_sh_band_mask(3, device=device)
    features, positions = AdamGroup(FEATURE_LR), AdamGroup(POSITION_LR)

    def step(state: TrainState):
        view = view_gradients(
            _scene(state.point_cloud, state.point_cloud_features), gt, q, t,
            cam, cfg, loss_fn, 1.0, band_mask)
        up = optimizer_update(
            state.point_cloud_features, view.grad_feats, state.point_cloud,
            view.grad_pc, state.opt_features, state.opt_positions, features,
            positions, torch.isfinite(view.loss))
        ctrl = update_stats(state.ctrl, view.stats, view.grad_pc,
                            view.result.aux.in_frustum)
        return TrainState(up.pc, up.feats, up.opt_features, up.opt_positions,
                          ctrl), view.loss

    return step


def measure_densify(state: TrainState, cam: CameraInfo, device,
                    reps: int = DENSIFY_REPS) -> float:
    """ms per `densify_step` on the trained state (capacity = the point
    count, as in bench.py: no free slots), chained on the scene over `reps`
    rounds after one, from the statistics of one VJP of a ones image."""
    scene = _scene(state.point_cloud, state.point_cloud_features)
    q, t = _identity_pose(device)
    result, vjp_fn = rasterize_with_vjp(*scene, q, t, cam, _train_config())
    _, _, stats = vjp_fn(torch.ones_like(result.image))
    ctrl_cfg = AdaptiveControllerConfig()
    generator = torch.Generator(device).manual_seed(0)

    def densify(sc, iteration):
        return densify_step(sc, state.ctrl, stats, result.aux.in_frustum,
                            result.aux.point_depth, sc.point_cloud,
                            iteration, generator, ctrl_cfg)[0]

    sc = densify(scene, DENSIFY_INTERVAL)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(reps):
        sc = densify(sc, DENSIFY_INTERVAL + i)
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def measure_train_step(pc, feats, cam: CameraInfo, device, reps: int,
                       warmup: int = TRAIN_WARMUP):
    """(ms per training step over `reps` steps after `warmup`, ms per
    densify round on the trained state)."""
    step = make_train_step(cam, device)
    state = initial_train_state(pc, feats)
    for _ in range(warmup):
        state, _ = step(state)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        state, loss = step(state)
    _sync(device)
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"non-finite training loss {float(loss)}")
    return step_ms, measure_densify(state, cam, device)


def build_record(n: int, frame_ms: float, slab_format: str, aux, backend: str,
                 device_name: str, power_limit_w, train_ms=None) -> dict:
    """bench.py's record (`:278-307`) from the measured numbers, plus
    `backend`, `device` and `power_limit_w`. `aux` is the probe frame's
    RasterizerAux; `train_ms` is (step ms, densify ms) or None."""
    fps = 1000.0 / frame_ms
    record = {
        "metric": f"render_fps_976x544_{round(n / 1000)}k_points",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / _baseline_fps(n), 3),
        "baseline_points": _baseline_points(n),
        "slab_format": slab_format,
        "key_overflow": int(aux.key_overflow),
        "big_point_overflow": int(aux.big_point_overflow),
        "tile_cap_overflow": int(aux.tile_cap_overflow),
    }
    if train_ms is not None:
        ms, densify_ms = train_ms
        record["train_step_ms"] = round(ms, 2)
        record["densify_ms"] = round(densify_ms, 2)
        amortized = ms + densify_ms / DENSIFY_INTERVAL
        record["train_step_amortized_ms"] = round(amortized, 2)
        record["train_iters_per_sec"] = round(1000.0 / amortized, 2)
    record["backend"] = backend
    record["device"] = device_name
    record["power_limit_w"] = power_limit_w
    return record


def device_info(device):
    """(name, power limit in W or None): nvidia-smi's `name,power.limit`
    for a card (torch's name and None where nvidia-smi gives no answer);
    ("cpu", None) on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        name, limit = out.strip().splitlines()[0].rsplit(",", 1)
        return name.strip(), float(limit.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return torch.cuda.get_device_name(device), None


def _peak_memory(device, what: str):
    if device.type == "cuda":
        mib = torch.cuda.max_memory_allocated(device) / 2 ** 20
        print(f"peak device memory, {what}: {mib:.1f} MiB", file=sys.stderr,
              flush=True)
        torch.cuda.reset_peak_memory_stats(device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = torch.device(parser.parse_args(argv).device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            _emit_error_record("device unavailable: torch.cuda.is_available() "
                               "is False (--device cpu runs the plain "
                               "blends)")
        try:
            _build.on_card(device, "the bench")
        except (RuntimeError, OSError) as exc:
            _emit_error_record(f"kernel build failed: {exc}")
        torch.cuda.reset_peak_memory_stats(device)
    try:
        pc, feats = load_scene(device)
    except (ImportError, OSError) as exc:
        _emit_error_record(f"scene unavailable: {exc}")
    cam = bench_camera()
    cfg = RasterizerConfig(near_plane=NEAR, far_plane=FAR, rgb_only=True,
                           slab_format=os.environ.get("BENCH_SLAB_FORMAT",
                                                      "auto"))
    _build.reset_launch_counts()
    frame_ms, aux = measure_render(pc, feats, cam, cfg, device,
                                   int(os.environ.get("BENCH_ITERS", "50")))
    _peak_memory(device, "scene and render")
    train_ms = train_error = None
    if os.environ.get("BENCH_TRAIN", "1") == "1":
        try:
            train_ms = measure_train_step(
                pc, feats, cam, device,
                int(os.environ.get("BENCH_TRAIN_ITERS", "20")))
        except Exception as exc:  # the render record is still printed
            traceback.print_exc()
            train_error = f"{type(exc).__name__}: {exc}"
        _peak_memory(device, "training")
    name, power_limit_w = device_info(device)
    record = build_record(pc.shape[0], frame_ms, _resolve_slab_format(cfg),
                          aux, f"torch-{device.type}", name, power_limit_w,
                          train_ms)
    if train_error is not None:
        record["train_error"] = train_error
    print(f"kernel launches: {json.dumps(_build.launch_counts)}",
          file=sys.stderr, flush=True)
    print(json.dumps(record), flush=True)
    if train_error is not None:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
