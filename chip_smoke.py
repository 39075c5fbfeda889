"""Drive the PyTorch/CUDA port's render and training paths on one NVIDIA
Hopper GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. device: a CUDA card of compute capability 9.0, its name and power
     limit, the torch and CUDA versions;
  2. build: the CUDA kernels from taichi_3d_gaussian_splatting_torch/csrc;
  3. kernel vs plain version on the card, for the blend's three variants
     (rgb_only on the packed8 and wide16 slabs, the full render on wide16),
     on the three 32x32 fixtures of tests/ab_runner.py, on the long-segment
     fixture of tests/torch_chunk_fixtures.py (tiles of several chunks,
     pixels that saturate on a chunk's first key) and at 976x544 on the
     binned inputs of a 20k-point scene, of the main path's 430k scene and
     of the 1.03M heavy-tailed scene (whose long tiles split into chunks;
     the work-list kernel is held exactly against its plain version on
     each), with the kernel's and the plain version's device times and each
     kernel's work and bound (tests/torch_chunk_fixtures.py work); then the
     whole render on the card against the port's CPU path on the small
     fixtures;
  4. main path: `rasterize(rgb_only=True)` of the 430k-point synthetic
     scene of bench.py at 976x544 (fx 581.7, near 0.4), frame time over 50
     frames after 10 warm-up frames, a per-stage breakdown, and one full
     render (depth and count) of the same view; the kernels' launch counts
     are read over this phase only. Then the frame time of the 1.03M
     heavy-tailed scene of benchmark/synthetic_checkpoint.py.
  3b. the backward blend kernel against its plain version on the card, on
     the three 32x32 fixtures, the long-segment fixture and the binned 20k,
     430k and 1.03M scenes (a seeded image cotangent; the forward kernel's
     colour and `last` through the rasterizer's `_backward_pixel_in`), with
     both device times at 430k and 1.03M; at 1.03M the conic rows are held
     against the plain version in float64 (see compare_backward);
  5. training path: a 4-view 976x544 dataset rendered by the port from the
     430k scene, an init parquet of its jittered positions, and the port's
     `GaussianPointCloudTrainer(...).train()` for 30 iterations with
     densify every 10 after a 10-step warm-up and one validation; the
     kernels' launch counts are read over this phase only. Then the mean
     step time, a per-stage breakdown of a step and the densify time, and
     one 32x32 step on the card against the same step on the CPU.

The second-to-last line is a JSON object describing each kernel at the
main path's shapes (430k scene; launches from phases 4 and 5): its time,
its plain version's, its bound and what sets it (tests/
torch_chunk_fixtures.py work), the pairs it evaluates, and library_ms null
(no PyTorch call computes the blend). The last line is {"ok": true, "device": {...}}.
Needs no network and imports no JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H, W, FOCAL = 544, 976, 581.7
WARMUP_FRAMES, TIMED_FRAMES = 10, 50
KERNEL_SOURCE = "taichi_3d_gaussian_splatting_torch/csrc/blend_forward.cu"
TPU_KERNEL = "taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py:267"
BACKWARD_SOURCE = "taichi_3d_gaussian_splatting_torch/csrc/blend_backward.cu"
TPU_BACKWARD_KERNEL = "taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py:430"
TRAIN_ITERATIONS = 30
TIMED_STEPS = 10


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def bench_scene(n, seed=0):
    """The synthetic scene of bench.py (uniform positions, small splats)."""
    rng = np.random.default_rng(seed)
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
    return pc, feats


def write_training_set(root, pc, feats, cam):
    """Four views of a scene, rendered by the port's full render on the
    card (small camera translations), as PNGs with train.json / val.json
    (the first view), and an init parquet of the positions jittered by
    0.02 with each point's own colour in r, g, b (as a structure-from-
    motion cloud carries). Returns the three paths."""
    import pandas as pd
    import PIL.Image
    import torch
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        RasterizerConfig, rasterize)
    n = pc.shape[0]
    scene = GaussianPointCloudScene.from_numpy(pc, feats, np.zeros(n),
                                               np.zeros(n), "cuda")
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device="cuda")
    records = []
    for v in range(4):
        t = np.array([0.05 * (v - 1), 0.02 * v, -0.1 * v], np.float32)
        with torch.no_grad():
            img = rasterize(*scene, q, torch.tensor(t[None], device="cuda"),
                            cam, RasterizerConfig(near_plane=0.4,
                                                  far_plane=1000.0)).image
        path = os.path.join(root, f"view_{v}.png")
        PIL.Image.fromarray((img.clamp(0, 1).cpu().numpy() * 255).astype(
            np.uint8)).save(path)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = t
        records.append(dict(
            image_path=path, T_pointcloud_camera=pose.tolist(),
            camera_intrinsics=np.asarray(cam.camera_intrinsics).tolist(),
            camera_height=cam.camera_height, camera_width=cam.camera_width,
            camera_id=0))
    paths = [os.path.join(root, f) for f in ("train.json", "val.json",
                                             "init.parquet")]
    for path, recs in zip(paths, (records, records[:1])):
        with open(path, "w") as f:
            json.dump(recs, f)
    rng = np.random.default_rng(1)
    df = pd.DataFrame(pc + rng.normal(scale=0.02, size=pc.shape).astype(
        np.float32), columns=["x", "y", "z"])
    # the DC colour sigmoid(SH_C0 * f) of each point, in 1..254
    colour = 1.0 / (1.0 + np.exp(-0.28209479177387814 * feats[:, [8, 24, 40]]))
    df[["r", "g", "b"]] = np.clip(np.round(colour * 255), 1, 254).astype(
        np.int64)
    df.to_parquet(paths[2])
    return paths


def make_trainer(root, scene_arrays, cam):
    """The port's trainer on the card, on a 4-view dataset of
    `scene_arrays` at the camera's size written under `root`."""
    from taichi_3d_gaussian_splatting_torch.models.scene import SceneConfig
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        RasterizerConfig)
    from taichi_3d_gaussian_splatting_torch.training.controller import (
        AdaptiveControllerConfig)
    from taichi_3d_gaussian_splatting_torch.training.loss import (
        LossFunctionConfig)
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer, TrainConfig)
    train_json, val_json, init = write_training_set(root, *scene_arrays, cam)
    logs = os.path.join(root, "logs")
    # Tanks and Temples Truck's hyperparameters (config/tat_truck.yaml),
    # with its schedules cut to a 30-step run
    config = TrainConfig(
        train_dataset_json_path=train_json, val_dataset_json_path=val_json,
        pointcloud_parquet_path=init, num_iterations=TRAIN_ITERATIONS,
        val_interval=10 ** 6, feature_learning_rate=0.005,
        position_learning_rate=5e-5, position_learning_rate_decay_rate=0.9847,
        initial_downsample_factor=1, log_loss_interval=1,
        log_image_interval=10 ** 9, summary_writer_log_dir=logs,
        rasterisation_config=RasterizerConfig(
            near_plane=0.4, far_plane=1000.0, depth_to_sort_key_scale=10.0),
        adaptive_controller_config=AdaptiveControllerConfig(
            num_iterations_warm_up=10, num_iterations_densify=10,
            num_iterations_reset_alpha=10 ** 6,
            densification_view_space_position_gradients_threshold=4e-6,
            transparent_alpha_threshold=-2.0,
            under_reconstructed_num_pixels_threshold=256,
            under_reconstructed_move_factor=10.0),
        gaussian_point_cloud_scene_config=SceneConfig(
            max_num_points_ratio=2.0, initial_alpha=0.0,
            initial_covariance_ratio=0.1, max_initial_covariance=3000.0),
        loss_function_config=LossFunctionConfig(enable_regularization=False))
    return GaussianPointCloudTrainer(config, device="cuda")


def train_phase(root, scene_arrays, cam, card, fail):
    """Train the port on a 4-view dataset of `scene_arrays` at the camera's
    size; check the run; time steps, stages and densify. Returns the
    kernel launch counts of the training run."""
    import torch
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import _no_mark
    from taichi_3d_gaussian_splatting_torch.training.controller import (
        densify_step)

    t0 = time.perf_counter()
    trainer = make_trainer(root, scene_arrays, cam)
    config = trainer.config
    logs = config.summary_writer_log_dir
    print(f"training set and trainer ready in "
          f"{time.perf_counter() - t0:.1f} s: {trainer.scene.capacity} "
          f"slots, {trainer.scene.num_valid_points()} valid", flush=True)

    BC.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(BC.launch_counts)
    print(f"kernel launches during the {TRAIN_ITERATIONS}-iteration "
          f"training run: {launches}", flush=True)
    if (launches["blend_forward"] < TRAIN_ITERATIONS
            or launches["blend_backward"] < TRAIN_ITERATIONS):
        fail(f"training did not launch K2 and K3 once per step: {launches}")

    with open(os.path.join(logs, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    if len(losses) != TRAIN_ITERATIONS or not np.isfinite(losses).all():
        fail(f"training losses missing or not finite: {losses}")
    densified = [r for r in records if "densify/num_fillable" in r]
    for r in densified:
        print(f"densify at iteration {r['iteration']}: " + ", ".join(
            f"{k.split('/')[1]} {int(v)}" for k, v in r.items()
            if k != "iteration"), flush=True)
    if not densified:
        fail("densify never ran")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: first {losses[0]}, last {losses[-1]}")
    val = [r for r in records if "val/psnr" in r]
    for name in (f"scene_{TRAIN_ITERATIONS}.parquet", "best_scene.parquet"):
        scene = GaussianPointCloudScene.from_parquet(os.path.join(logs, name))
        if (scene.num_valid_points() == 0 or not bool(torch.isfinite(
                scene.point_cloud_features).all())):
            fail(f"{name} does not load back as a finite scene")
    print(f"training [{W}x{H}, 430k synthetic, 4 views]: "
          f"{TRAIN_ITERATIONS} iterations in {train_s:.2f} s, loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}, validation PSNR "
          f"{val[-1]['val/psnr']:.3f}, {trainer.scene.num_valid_points()} "
          f"valid points after densify ({card})", flush=True)

    # step time, stage breakdown and densify time on the trained state
    cache = trainer._device_cache(trainer.train_dataset, 1)

    def one_step(mark=_no_mark):
        image, q, t, view_cam = trainer._next_view(cache, None, 1)
        return trainer.step(image, q, t, 0, view_cam, mark=mark)

    for _ in range(5):
        one_step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_STEPS):
        out = one_step()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    stage_ms = {}
    for _ in range(5):
        events = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        mark("start")
        out = one_step(mark)
        torch.cuda.synchronize()
        for (_, a), (stage, b) in zip(events, events[1:]):
            stage_ms[stage] = stage_ms.get(stage, 0.0) + a.elapsed_time(b) / 5
    aux = out.result.aux
    pos_before = trainer.scene.point_cloud.clone()
    densify_ms = []
    for _ in range(3):
        start.record()
        densify_step(trainer.scene, trainer.ctrl_state, out.stats,
                     aux.in_frustum, aux.point_depth, pos_before, 100,
                     trainer.generator, config.adaptive_controller_config)
        end.record()
        end.synchronize()
        densify_ms.append(start.elapsed_time(end))
    print(f"training step [{W}x{H}, {trainer.scene.capacity} slots, "
          f"{int(aux.total_keys)} keys]: {step_ms:.4f} ms/step over "
          f"{TIMED_STEPS} steps after 5 warm-up steps; densify "
          f"{np.mean(densify_ms):.4f} ms ({card})", flush=True)
    print("  step stages ms: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in stage_ms.items()),
          flush=True)
    trainer.logger.close()
    return launches


def step_cuda_vs_cpu(root, fail):
    """One 32x32 training step from one state on the card and on the CPU:
    every state array at rtol 2e-3 / atol 1e-4."""
    import torch_port_fixtures as fx
    from torch_train_fixtures import one_step_state, write_dataset
    write_dataset(root)
    loss_gpu, gpu = one_step_state(root, "cuda")
    loss_cpu, cpu = one_step_state(root, "cpu")
    if abs(loss_gpu - loss_cpu) > 1e-4 * abs(loss_cpu):
        fail(f"32x32 step loss: cuda {loss_gpu} vs cpu {loss_cpu}")
    worst = 0.0
    for k in cpu:
        np.testing.assert_allclose(gpu[k], cpu[k], rtol=fx.RTOL,
                                   atol=fx.ATOL, err_msg=f"step {k}")
        worst = max(worst, float(np.abs(gpu[k].astype(np.float64)
                                        - cpu[k]).max()))
    print(f"32x32 training step cuda vs cpu: loss {loss_gpu:.6f} vs "
          f"{loss_cpu:.6f}, max |d state| {worst:.3g}", flush=True)


def main():
    import torch

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs the GPU")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"needs compute capability (9, 0) (Hopper), got {cap}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    for sub in ("", "tests", "benchmark"):
        sys.path.insert(0, os.path.join(REPO, sub))
    import torch_port_fixtures as fx
    from synthetic_checkpoint import make_heavy_tailed_checkpoint
    from torch_chunk_fixtures import (CFG_MAIN, binned_inputs,
                                      long_segment_slab, pair_counts,
                                      seeded_pixel_in, work)
    from taichi_3d_gaussian_splatting_torch.camera import CameraInfo
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    from taichi_3d_gaussian_splatting_torch.ops import _build
    from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
    from taichi_3d_gaussian_splatting_torch.ops.projection import (
        compute_point_attributes)
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        RasterizerConfig, _blend_inputs_from_attrs, _result_from_tile_out,
        rasterize)
    from taichi_3d_gaussian_splatting_torch.ops.tiling import (
        bin_points_to_tiles, blend_slab)
    from taichi_3d_gaussian_splatting_torch.ops.transforms import (
        inverse_SE3_qt)

    cuda = torch.device("cuda")

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc + load)",
          flush=True)
    for line in _build.build_log.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print(f"  {line.strip()}", flush=True)

    def pose(device):
        q, t = fx.identity_pose()
        return (torch.as_tensor(q, device=device),
                torch.as_tensor(t, device=device))

    def scene_on(pc, feats, device):
        n = pc.shape[0]
        return GaussianPointCloudScene.from_numpy(
            pc, feats, np.zeros(n), np.zeros(n), device)

    def time_ms(fn, reps, warmup=2):
        """Mean device time of fn() over `reps` calls, by CUDA events."""
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

    # ---- 3. kernel vs plain version on the card ------------------------
    variants = [("blend_forward_rgb", "packed8", True),
                ("blend_forward_rgb", "wide16", True),
                ("blend_forward", "wide16", False)]
    max_err = {"blend_forward_rgb": 0.0, "blend_forward": 0.0}
    float_rows = {"r": BC.OUT_R, "g": BC.OUT_G, "b": BC.OUT_B,
                  "acc_alpha": BC.OUT_ACC_ALPHA, "norm": BC.OUT_NORM}

    def binned(pc, feats, cam, cfg_kwargs):
        return binned_inputs(pc, feats, cam, cfg_kwargs, cuda)

    def compare(label, cam, binning, slabs):
        for name, fmt, rgb_only in variants:
            kw = dict(num_tiles=cam.num_tiles,
                      tiles_per_row=cam.tiles_per_row, rgb_only=rgb_only)
            args = (slabs[fmt], binning.tile_starts, binning.tile_ends)
            got = BC.blend_forward(*args, **kw)
            ref = BC.blend_forward_torch(*args, **kw)
            torch.cuda.synchronize()
            got, ref = got.cpu().numpy(), ref.cpu().numpy()
            if not np.isfinite(got).all():
                fail(f"{label} {name}/{fmt}: non-finite kernel output")
            devs = {}
            for key, row in float_rows.items():
                devs[key] = float(np.abs(got[:, row] - ref[:, row]).max())
                np.testing.assert_allclose(got[:, row], ref[:, row],
                                           rtol=fx.RTOL, atol=fx.ATOL,
                                           err_msg=f"{label} {name} {key}")
            max_err[name] = max(max_err[name], *devs.values())
            if rgb_only:
                zero_rows = got[:, [BC.OUT_DEPTH, BC.OUT_LAST_EFF,
                                    BC.OUT_COUNT]]
                if np.any(zero_rows != 0):
                    fail(f"{label} {name}/{fmt}: rgb_only rows 3/6/7 not 0")
            else:
                covered = ref[:, BC.OUT_ACC_ALPHA] > fx.COVERED_ALPHA
                d_got = got[:, BC.OUT_DEPTH][covered]
                d_ref = ref[:, BC.OUT_DEPTH][covered]
                devs["depth"] = float(np.abs(d_got - d_ref).max(initial=0))
                np.testing.assert_allclose(d_got, d_ref, rtol=fx.RTOL,
                                           atol=fx.ATOL,
                                           err_msg=f"{label} depth")
                for key, row in (("count", BC.OUT_COUNT),
                                 ("last", BC.OUT_LAST_EFF)):
                    devs[key] = float(np.abs(got[:, row] - ref[:, row]).max())
                    fx.assert_counts_close(ref[:, row], got[:, row],
                                           f"{label} {key}")
            print(f"kernel vs plain [{label}] {name}/{fmt}: max |d| "
                  + " ".join(f"{k}={v:.3g}" for k, v in devs.items()),
                  flush=True)

    small_cam = CameraInfo(fx.camera_intrinsics(), 32, 32)
    for seed, alpha, label, cfg in fx.AB_CASES:
        pc, feats = fx.random_scene(60, seed=seed, alpha=alpha)
        compare(f"ab-{label} 32x32", small_cam, *binned(pc, feats, small_cam,
                                                        cfg))

    def split_report(label, binning, mk):
        """How the kernels' work list cuts this input (one host sync)."""
        work = BC.build_work_list(binning.tile_starts, binning.tile_ends, mk)
        plain = BC.chunk_work_list(binning.tile_starts, binning.tile_ends, mk)
        if not torch.equal(work.items, plain.items):
            fail(f"{label}: the work-list kernel differs from its plain "
                 f"version")
        items = work.items
        valid = items[BC.ITEM_TILE] >= 0
        split = valid & (items[BC.ITEM_COUNT] > 1)
        n_split = int(split.sum())
        tiles = int(torch.unique(items[BC.ITEM_TILE][split]).numel())
        print(f"{label}: work list of {int(valid.sum())} items, {tiles} "
              f"tiles split into {n_split} chunks of at most "
              f"{BC.CHUNK_KEYS} keys", flush=True)
        return tiles

    # tiles of several chunks, with pixels saturating on a chunk's first key
    long_slabs, long_starts, long_ends = long_segment_slab(BC.CHUNK_KEYS)
    long_slabs = {k: v.to(cuda) for k, v in long_slabs.items()}
    long_binning = types.SimpleNamespace(tile_starts=long_starts.to(cuda),
                                         tile_ends=long_ends.to(cuda))
    long_cam = CameraInfo(fx.camera_intrinsics(w=64), 32, 64)
    if split_report("long-segment fixture", long_binning,
                    long_slabs["wide16"].shape[1]) < 5:
        fail("the long-segment fixture does not split its tiles")
    sat_pos = pair_counts(long_slabs["wide16"], long_binning.tile_starts,
                          long_binning.tile_ends,
                          num_tiles=long_cam.num_tiles,
                          tiles_per_row=long_cam.tiles_per_row)["sat_pos"]
    at_boundary = int(((sat_pos % BC.CHUNK_KEYS == 0) & (sat_pos > 0)).sum())
    print(f"long-segment fixture: {at_boundary} pixels saturate on the first "
          f"key of a later chunk", flush=True)
    if at_boundary == 0:
        fail("no pixel of the long-segment fixture saturates at a chunk "
             "boundary")
    compare("long-segment fixture 64x32", long_cam, long_binning, long_slabs)

    intr = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]],
                    np.float32)
    cam = CameraInfo(camera_intrinsics=intr, camera_height=H, camera_width=W)
    cfg_main = CFG_MAIN
    scenes = {"mid 20k": bench_scene(20000),
              "430k synthetic": bench_scene(430000),
              "1.03M heavy-tailed": make_heavy_tailed_checkpoint(
                  1030000, np.random.default_rng(0))}
    kernel_ms, plain_ms, bounds = {}, {}, {}
    for label, (pc, feats) in scenes.items():
        binning, slabs = binned(pc, feats, cam, cfg_main)
        seg = binning.tile_ends - binning.tile_starts
        print(f"{label} at {W}x{H}: {int(binning.total_keys)} keys, "
              f"longest tile segment {int(seg.max())}", flush=True)
        split_report(f"{label} {W}x{H}", binning,
                     binning.point_data.shape[1])
        compare(f"{label} {W}x{H}", cam, binning, slabs)
        # the plain version loops once per key of the longest segment
        reps, warmup = (1, 0) if int(seg.max()) > 5000 else (3, 1)
        for name, fmt, rgb_only in (variants[0], variants[2]):
            args = (slabs[fmt], binning.tile_starts, binning.tile_ends)
            kw = dict(num_tiles=cam.num_tiles,
                      tiles_per_row=cam.tiles_per_row, rgb_only=rgb_only)
            k_ms = time_ms(lambda: BC.blend_forward(*args, **kw), 20)
            p_ms = time_ms(lambda: BC.blend_forward_torch(*args, **kw),
                           reps, warmup=warmup)
            wk = work(name, args[0], *args[1:], cam.num_tiles,
                      cam.tiles_per_row)
            print(f"{label} {name}/{fmt}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, {wk['pairs']} pairs evaluated "
                  f"({wk['pairs_no_exit']} with no early exit), bound "
                  f"{wk['bound_ms']:.4f} ms by {wk['bound_by']} ({card})",
                  flush=True)
            if label == "430k synthetic":   # the main path's shapes
                kernel_ms[name], plain_ms[name] = k_ms, p_ms
                bounds[name] = wk
        del binning, slabs

    # the whole render on the card vs the port's CPU path
    for seed, alpha, label, cfg in fx.AB_CASES:
        pc, feats = fx.random_scene(60, seed=seed, alpha=alpha)
        for rgb_only in (True, False):
            outs = []
            for device in (cuda, torch.device("cpu")):
                with torch.no_grad():
                    res = rasterize(*scene_on(pc, feats, device),
                                    *pose(device), small_cam,
                                    RasterizerConfig(**cfg,
                                                     rgb_only=rgb_only))
                outs.append(res)
            gpu, cpu = outs
            for key in ("image", "depth"):
                np.testing.assert_allclose(
                    getattr(gpu, key).cpu().numpy(),
                    getattr(cpu, key).cpu().numpy(), rtol=fx.RTOL,
                    atol=fx.ATOL, err_msg=f"ab-{label} {key}")
            if int(gpu.aux.total_keys) != int(cpu.aux.total_keys):
                fail(f"ab-{label}: key counts differ between cuda and cpu")
            print(f"render cuda vs cpu [ab-{label} rgb_only={rgb_only}]: "
                  f"max |d image| "
                  f"{float((gpu.image.cpu() - cpu.image).abs().max()):.3g}",
                  flush=True)

    # ---- 3b. backward kernel vs plain version on the card --------------
    grad_rows = {"du": BC.GROW_DU, "dv": BC.GROW_DV, "da": BC.GROW_DA,
                 "db": BC.GROW_DB, "dc": BC.GROW_DC, "dlogw": BC.GROW_DLOGW,
                 "dr": BC.GROW_DR, "dg": BC.GROW_DG, "db_col": BC.GROW_DB_COL,
                 "mag_uv": BC.GROW_MAG_UV}
    max_err["blend_backward"] = 0.0

    def backward_args(cam, slab, binning, seed):
        """(wide16 slab, ranges, pixel_in): a seeded normal image cotangent
        beside the forward kernel's colour and `last`, as the rasterizer
        builds it in training."""
        kw = dict(num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row)
        fwd = BC.blend_forward(slab, binning.tile_starts, binning.tile_ends,
                               rgb_only=False, **kw)
        pixel_in = seeded_pixel_in(fwd, cam, seed)
        return (slab, binning.tile_starts, binning.tile_ends, pixel_in), kw

    conic_rows = ("da", "db", "dc")

    def compare_backward(label, cam, binning, seed, slab=None,
                         conic_float64=False):
        """K3 against its plain version; returns (args, kw, the plain
        version's device ms for this one call).

        With `conic_float64` (the 1.03M scene), the conic rows (da, db, dc:
        float32 sums over a tile of +-G dx^2 terms, up to ~2e4 there, which
        cancel at some keys) are held against the plain version in float64
        (blend_backward_torch dtype=float64, the same contributing keys) at
        rtol 2e-3 and an absolute tolerance of twice the float32 plain
        version's own largest deviation from it in that row: the kernel
        rounds no worse than its float32 yardstick. The deviations of
        both, and the elements outside rtol 2e-3 / atol 1e-4 of the float32
        plain version, are printed."""
        slab = binning.point_data if slab is None else slab
        args, kw = backward_args(cam, slab, binning, seed)
        got = [x.cpu().numpy() for x in BC.blend_backward(*args, **kw)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = BC.blend_backward_torch(*args, **kw)
        end.record()
        end.synchronize()
        p_ms = start.elapsed_time(end)
        ref = [x.cpu().numpy() for x in ref]
        if not all(np.isfinite(x).all() for x in got):
            fail(f"{label} blend_backward: non-finite kernel output")
        ref64 = None
        if conic_float64:
            ref64 = BC.blend_backward_torch(*args, **kw,
                                            dtype=torch.float64)[0]
            ref64 = ref64[[grad_rows[k] for k in conic_rows]].cpu().numpy()
        devs, notes = {}, []
        for key, row in grad_rows.items():
            diff = np.abs(got[0][row] - ref[0][row])
            devs[key] = float(diff.max(initial=0))
            if ref64 is None or key not in conic_rows:
                np.testing.assert_allclose(got[0][row], ref[0][row],
                                           rtol=fx.RTOL, atol=fx.ATOL,
                                           err_msg=f"{label} backward {key}")
                continue
            exact = ref64[conic_rows.index(key)]
            e_plain = float(np.abs(ref[0][row] - exact).max(initial=0))
            e_kernel = float(np.abs(got[0][row] - exact).max(initial=0))
            outside = int((diff > fx.ATOL + fx.RTOL * np.abs(
                ref[0][row])).sum())
            notes.append(f"{key}: kernel {e_kernel:.3g} and plain "
                         f"{e_plain:.3g} from float64, {outside} keys "
                         f"outside rtol/atol of the plain version")
            np.testing.assert_allclose(
                got[0][row], exact, rtol=fx.RTOL,
                atol=max(fx.ATOL, 2.0 * e_plain),
                err_msg=f"{label} backward {key} against float64")
        devs["mag_image"] = float(np.abs(got[1] - ref[1]).max())
        np.testing.assert_allclose(got[1], ref[1], rtol=fx.RTOL, atol=fx.ATOL,
                                   err_msg=f"{label} backward mag image")
        max_err["blend_backward"] = max(max_err["blend_backward"],
                                        *devs.values())
        devs["num_pixels"] = float(np.abs(
            got[0][BC.GROW_NUM_PIXELS] - ref[0][BC.GROW_NUM_PIXELS]).max(
                initial=0))
        fx.assert_counts_close(ref[0][BC.GROW_NUM_PIXELS],
                               got[0][BC.GROW_NUM_PIXELS],
                               f"{label} backward num_pixels")
        print(f"kernel vs plain [{label}] blend_backward: max |d| "
              + " ".join(f"{k}={v:.3g}" for k, v in devs.items())
              + "".join(f"; {n}" for n in notes), flush=True)
        return args, kw, p_ms

    for seed, alpha, label, cfg in fx.AB_CASES:
        pc, feats = fx.random_scene(60, seed=seed, alpha=alpha)
        compare_backward(f"ab-{label} 32x32", small_cam,
                         binned(pc, feats, small_cam, cfg)[0], seed)
    compare_backward("long-segment fixture 64x32", long_cam, long_binning, 5,
                     slab=long_slabs["wide16"])
    for label in ("mid 20k", "430k synthetic", "1.03M heavy-tailed"):
        binning, _ = binned(*scenes[label], cam, cfg_main)
        args, kw, p_ms = compare_backward(
            f"{label} {W}x{H}", cam, binning, 7,
            conic_float64=label == "1.03M heavy-tailed")
        seg = binning.tile_ends - binning.tile_starts
        if int(seg.max()) <= 5000:   # else the one compared call's time
            p_ms = time_ms(lambda: BC.blend_backward_torch(*args, **kw), 3,
                           warmup=1)
        k_ms = time_ms(lambda: BC.blend_backward(*args, **kw), 20)
        wk = work("blend_backward", args[0], *args[1:3], cam.num_tiles,
                  cam.tiles_per_row, last=args[3][:, BC.PIXEL_IN_LAST])
        print(f"{label} blend_backward/wide16: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, {wk['pairs']} pairs below `last` "
              f"({wk['pairs_no_exit']} with no early exit), bound "
              f"{wk['bound_ms']:.4f} ms by {wk['bound_by']} ({card})",
              flush=True)
        if label == "430k synthetic":
            kernel_ms["blend_backward"] = k_ms
            plain_ms["blend_backward"] = p_ms
            bounds["blend_backward"] = wk
        del binning, args

    # ---- 4. main path ---------------------------------------------------
    cfg_rgb = RasterizerConfig(**cfg_main, rgb_only=True)
    cfg_full = RasterizerConfig(**cfg_main, rgb_only=False)
    q, t = pose(cuda)

    def render(scene, cfg):
        with torch.no_grad():
            return rasterize(*scene, q, t, cam, cfg)

    def staged_ms(scene, frames=20):
        """Device time per stage of the rgb_only render, by CUDA events."""
        names = ["projection", "binning+sort", "slab gather", "blend kernel",
                 "layout"]
        totals = np.zeros(len(names))
        image = None
        for i in range(frames + 2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            with torch.no_grad():
                ev[0].record()
                q_cam, t_cam = inverse_SE3_qt(q, t)
                attrs = compute_point_attributes(
                    *scene, q_cam, t_cam, t, cam, cfg_rgb.near_plane,
                    cfg_rgb.far_plane)
                cols, depth = _blend_inputs_from_attrs(attrs)
                ev[1].record()
                binning = bin_points_to_tiles(
                    attrs.u, attrs.v, attrs.depth, attrs.radius_x,
                    attrs.radius_y, attrs.emit, cam,
                    depth_to_sort_key_scale=cfg_rgb.depth_to_sort_key_scale)
                ev[2].record()
                slab = blend_slab(cols + (depth,), binning.sorted_point_idx,
                                  "packed8")
                ev[3].record()
                tile_out = BC.blend_forward(
                    slab, binning.tile_starts, binning.tile_ends,
                    num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row,
                    rgb_only=True)
                ev[4].record()
                image = _result_from_tile_out(tile_out, attrs, binning,
                                              cam).image.contiguous()
                ev[5].record()
            torch.cuda.synchronize()
            if i >= 2:                      # two warm-up frames
                totals += [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
        return dict(zip(names, (totals / frames).tolist())), image, binning

    def run_scene(label, pc, feats, count_launches):
        scene = scene_on(pc, feats, cuda)
        if count_launches:
            BC.reset_launch_counts()
        for _ in range(WARMUP_FRAMES):
            render(scene, cfg_rgb)
        frame_ms = time_ms(lambda: render(scene, cfg_rgb), TIMED_FRAMES,
                           warmup=0)
        res = render(scene, cfg_rgb)
        full = render(scene, cfg_full)      # depth + count of the same view
        torch.cuda.synchronize()
        launches = dict(BC.launch_counts)
        img = res.image
        alpha = res.aux.pixel_accumulated_alpha
        if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()):
            fail(f"{label}: image not finite or of shape {tuple(img.shape)}")
        coverage = float((alpha > 0).float().mean())
        if coverage <= 0.0:
            fail(f"{label}: nothing rendered (coverage 0)")
        if not (bool(torch.isfinite(full.image).all())
                and bool(torch.isfinite(full.depth).all())):
            fail(f"{label}: full render not finite")
        # packed8 differs from wide16 only by one bf16 rounding of colours
        d_fmt = float((img - full.image).abs().max())
        if d_fmt > 4e-3:
            fail(f"{label}: packed8 vs wide16 image differ by {d_fmt}")
        stages, staged_image, binning = staged_ms(scene)
        if not torch.allclose(staged_image, img, rtol=0, atol=1e-6):
            fail(f"{label}: the staged frame does not reproduce rasterize")
        seg = binning.tile_ends - binning.tile_starts
        print(f"main path [{label}]: {TIMED_FRAMES} frames of rasterize("
              f"rgb_only=True, packed8) at {W}x{H}: {frame_ms:.4f} ms/frame "
              f"({1000.0 / frame_ms:.2f} FPS), {int(binning.total_keys)} keys,"
              f" longest tile segment {int(seg.max())}, coverage "
              f"{coverage:.4f}, max |packed8 - wide16| {d_fmt:.3g} ({card})",
              flush=True)
        print(f"  stages ms: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in stages.items()),
              flush=True)
        return launches

    launches = run_scene("430k synthetic", *scenes["430k synthetic"], True)
    print(f"kernel launches during the 430k main path: {launches}",
          flush=True)
    if min(launches["blend_forward_rgb"], launches["blend_forward"]) < 1:
        fail(f"a kernel of the path was never launched: {launches}")
    run_scene("1.03M heavy-tailed", *scenes["1.03M heavy-tailed"], False)

    # ---- 5. training path -----------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = train_phase(tmp, scenes["430k synthetic"], cam,
                                     card, fail)
        del scenes
        small = os.path.join(tmp, "small")
        os.makedirs(small)
        step_cuda_vs_cpu(small, fail)
    launches["blend_backward"] = train_launches["blend_backward"]

    # no PyTorch call computes the blend: library_ms is null
    kernels = [{"name": name, "route": "cuda",
                "source": (BACKWARD_SOURCE if name == "blend_backward"
                           else KERNEL_SOURCE),
                "replaces": (TPU_BACKWARD_KERNEL if name == "blend_backward"
                             else TPU_KERNEL),
                "launches": launches[name], "max_abs_err": max_err[name],
                "ms": kernel_ms[name], "plain_ms": plain_ms[name],
                "bound_ms": bounds[name]["bound_ms"],
                "bound_by": bounds[name]["bound_by"], "library_ms": None,
                "pairs": bounds[name]["pairs"]}
               for name in ("blend_forward_rgb", "blend_forward",
                            "blend_backward")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
