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
     are read over this phase only (P1 once per frame). Then the frame times of the 1.03M
     and 2.08M heavy-tailed scenes of benchmark/synthetic_checkpoint.py
     (kernel path only; no plain version at that size). Each scene's
     peak device memory and its slab columns are printed;
  3b. the backward blend kernel against its plain version on the card, on
     the three 32x32 fixtures, the long-segment fixture and the binned 20k,
     430k and 1.03M scenes (a seeded image cotangent beside the forward
     kernel's colour, through the rasterizer's `_backward_pixel_in`, and
     the forward kernel's int32 `last`, as training hands them over), with
     both device times at 430k and 1.03M; at 1.03M the conic rows are held
     against the plain version in float64 (see compare_backward). Then the
     boundary fixture: the long-segment fixture at column offset 2**24 - 3
     (tests/torch_chunk_fixtures.py shifted_slab), where a float32 `last`
     would round: K2's int `last` must be the offset-0 run's plus the
     offset exactly, K3's gradients at the shifted columns and its
     magnitude image bitwise the offset-0 run's, and K3 must match its
     plain version there;
  3c. the projection kernels against their plain versions on the card
     (projection_phase): P1 (csrc/projection_forward.cu) against
     compute_point_attributes + blend_logw and P2 (csrc/
     projection_backward.cu) against project_points_backward_torch on
     seeded cotangents, on the 20k and 1.03M scenes, the 430k scene in the
     trainer's 860,000 slots and a 32x32 case of two objects with an edit
     transform and an SH band mask: P1's masks and non-finite count
     identical, its columns and P2's gradients within the stated
     tolerances, the same non-finite gradient rows; each kernel's and
     plain version's device time and the bound;
  3e. the image loss kernel (csrc/image_loss.cu) against its plain version
     on the card at 976x544 (image_loss_phase): the loss terms and the
     gradient within LOSS_RTOL / LOSS_ATOL, the clamped render exactly, a
     second call bit for bit; its device time by the profiler, a call's
     by CUDA events, the plain version's, the bounds by bytes and by
     operations;
  3f. the batch step's accumulation kernel (csrc/accumulate_view.cu)
     against its plain version on the card at 4,160,000 slots, a first
     and a later view (accumulate_phase): the sums bit for bit, then a
     call's time (20 calls by CUDA events) and the plain version's, its
     bytes, its bound at 3.35 TB/s and its share of the bound;
  5. training path: a 4-view 976x544 dataset rendered by the port from the
     430k scene, an init parquet of its jittered positions, and the port's
     `GaussianPointCloudTrainer(...).train()` for 30 iterations with
     densify every 10 after a 10-step warm-up and one validation; the
     kernels' launch counts are read over this phase only (P1 once per
     frame, P2 once per step). Then the mean
     step time, a per-stage breakdown of a step and the densify time, and
     one 32x32 step on the card against the same step on the CPU;
  6. batch training: the same dataset with batch_size 4 under a one-rank
     NCCL process group (parallel/sharding.py, its collectives included),
     the schedules divided by 4 (warm-up and densify interval 24 -> 6),
     12 iterations with one densify and one validation; the kernels'
     launch counts are read over this run (K2 and K3 once per view). Then
     the batch step's time per step and per view and its stages;
  6b. two 32x32 batch steps of two views on the card against the same on
     the CPU (no process group);
  7. the viewer: `VisualizerState` on the 430k scene at 976x544, split
     into two objects; frames after a camera key, an object key and a
     hide, K1's launches over them, the PNGs decoded, the frame time;
  8. the trace on the card: (a) the trainer on phase 5's dataset for 12
     iterations with `enable_profiler` over iterations 5-9 (no densify,
     validation after the window); the trace file it wrote under
     `<logs>/profile/` is read back (utils/profiling.py): device busy
     share, kernel launches per step, the top-10 kernels, the forward
     blend's (work list, transmittance, blend) and K3's time per step.
     It fails without CUDA kernel events, without blend_forward_kernel
     and blend_backward_kernel, without projection_forward_kernel and
     projection_backward_kernel, or when K2's or K3's time per launch in
     the trace is more than 25% from their CUDA-event times on the same
     inputs (each training view of the final state); (b) 10 frames of
     the 430k `rasterize(rgb_only=True)` under torch.profiler, the same
     summary per frame (P1 in it), K1 held at 25% against its phase-3
     time (the same inputs);
  9. the data-preparation chain and the experiment gate on the card: the
     COLMAP binary capture of tests/test_torch_colmap_e2e.py, its images
     rendered on the card, converted by tools/prepare_colmap.py; the
     port's gate (`python -m taichi_3d_gaussian_splatting_torch.ci.
     run_experiment --device cuda`) trains it through the train CLI for
     GATE_ITERATIONS at a floor of GATE_FLOOR_PSNR dB and must exit 0; the
     gate again with --skip_training at 0.5 dB under the final val/psnr
     (exit 0) and 0.5 dB over it (exit 1); the render CLI renders one
     held-out view on the card; the KITTI capture converted by the port's
     prepare_kitti and trained 3 steps on the card;
 10. the bench on the card: `python -m taichi_3d_gaussian_splatting_torch.
     bench` in a subprocess on the 430k scene and the 1.03M heavy-tailed
     scene with training, and on the 2.08M heavy-tailed scene without.
     Each must exit 0 with a record of every key of bench.py's record plus
     backend (torch-cuda), device and power_limit_w, a value > 0, the
     dropped-work counters 0, its launch line on stderr showing K1 and P1
     (and K2, K3 and P2 where it trained), and a frame time (1000 / value) within 2x
     of phase 4's for the same scene. The records are printed.
 11. training to quality on the card (tests/torch_quality_fixtures.py):
     (a) tests/test_quality_synthetic.py's recipe (64x64, 32 views, every
     8th held out, 601 iterations, densify every 40, the SH curriculum),
     GT rendered by the port, device cache on, trainer seeds 0-2: each run
     above the JAX test's bars (held-out and train PSNR > 18 dB, more than
     100 valid points), the seeds' mean held-out PSNR within the larger of
     0.5 dB and twice the JAX seeds' spread of the JAX trainer's mean (CPU
     values, with budgets that drop no key: JAX_QUALITY_VAL_PSNR); (b) a
     976x544 held-out run of 100,000 GT points (torch_quality_fixtures.
     BIG), 24 views rendered on the card, every 8th held out, an init of
     half the points jittered by N(0, 0.03) with their colours,
     config/tat_truck_every_8_test.yaml's rates and thresholds over 3,000
     iterations (validation every 500, densify every 100 after 500, SH
     band every 500, alpha reset at 1,500, floater removal from 1,000,
     coarse-to-fine from 4x halved every 250): the final held-out PSNR at
     least 25 dB and above the first validation's, finite losses, densify
     added points, a non-empty final scene; the PSNR/SSIM trajectory,
     valid points, wall time, iteration ms over the last 500 and peak
     memory are printed; (c) its best_scene.parquet through the render
     CLI at a held-out view (PSNR within 1 dB of the trainer's own
     validation render of that view) and through the bench (BENCH_SCENE,
     BENCH_TRAIN=0), record printed.
 12. the probes (taichi_3d_gaussian_splatting_torch/probes/):
     the probe library built from csrc/probes/; each probe's entry point
     (the timing function its `main` runs) in every mode, with the probes'
     launch counts reset just before and read just after, every mode
     launched: S4 (K1's stages stripped) on the 430k and 1.03M wide16
     slabs, S1 (the exponent three ways), S3 (one stage removed at a time)
     and S2 (keys by pixels, the exponent as an FP64 tensor-core product)
     on their own layout and, for S2, the 430k slab rewritten into its
     rows, S5 (the instruction mixes of K1's inner loop, 256 programs of
     300 repetitions, every run of the TPU probe and mxu_t) and S6 (the
     roll and doubling scans by warp shuffles, and the work list's
     block_exclusive_sum). Then every mode's kernel against its plain version at full size
     (S2's with the exponent rounded as the kernel's FP64 product rounds
     it), S4 `full` against K1 (bitwise or not, printed) and K1's plain
     version at 430k, the decisions float32's exponent product flips in S2,
     S1's SASS (MUFU.EX2 and the instructions around it), each mode's time
     beside its plain version's and each `full` mode's bound. S5: each
     run's SASS (a repetition loop in every instance, SHFL.UP in lane, no
     FFMA in mul7), each run against its plain version at full size and at
     1-3 repetitions of uniform(0.5, 1) input (mul7, lane and sub bitwise,
     exp at rtol 1e-6, mxu and mxu_t at rtol 1e-5), the shares of zeros,
     subnormals and infinities in its output, its time against 30
     repetitions (at least 5x less), its plain time and bound. S6: every
     plane bitwise against its plain version, each work_list_scan draw
     exactly its sequential sum (PASS), times beside torch.roll's.
 13. the container's entrypoint and the quickstart notebook on the card,
     on phase 9's COLMAP capture, with `python` on PATH (a link to this
     interpreter where there is none or another): (a) `bash
     taichi_3d_gaussian_splatting_torch/ci/entrypoint.sh` from an empty
     working directory with PYTHONPATH at the repository, TRAIN_CONFIG a
     config of the capture (GATE_ITERATIONS) and the gate at
     GATE_FLOOR_PSNR / GATE_FLOOR_SSIM, must exit 0 with the summary
     markdown's val/psnr and val/ssim rows, and exit 1 without
     TRAIN_CONFIG; (b) every shell command of the code cells of
     taichi_3d_gaussian_splatting_torch/tools/run_on_cuda_quickstart.ipynb
     but the clone cell, in order, from the repository root, with
     /content in a temporary directory holding the capture and the written
     train.yaml cut to QUICKSTART_CUTS (printed): it must leave a
     best_scene.parquet, the trajectory's frames as PNGs of more than one
     colour each, and a bench record with value > 0, backend torch-cuda
     and its launch line. Each command's wall seconds are printed.

Every phase that renders or trains checks that P1 launched once per blend
forward (K1 or K2) and P2 once per K3 launch.

The second-to-last line is a JSON object describing each kernel at the
main path's shapes (430k scene; launches from phases 4 and 5): its time,
its plain version's, its bound and what sets it (tests/
torch_chunk_fixtures.py work for the blends, the bytes and operations per
point of PROJECTION_BYTES / PROJECTION_OPS for P1 and P2 at the trainer's
860,000 slots), the pairs a blend evaluates, and library_ms null (no
PyTorch call computes the blend or the projection); then the four probes'
`full` modes (S1's exp) at their main shapes (S4 430k, S2 and S3 their
layout; launches over phase 12's entry points), S5's lane mode and S6's
planes (library_ms torch.roll's). The last line is {"ok":
true, "device": {...}}.
Needs no network and imports no JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

from taichi_3d_gaussian_splatting_torch.ops._build import (
    launch_counts, reset_launch_counts)

REPO = os.path.dirname(os.path.abspath(__file__))
H, W, FOCAL = 544, 976, 581.7
WARMUP_FRAMES, TIMED_FRAMES = 10, 50
KERNEL_SOURCE = "taichi_3d_gaussian_splatting_torch/csrc/blend_forward.cu"
TPU_KERNEL = "taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py:267"
BACKWARD_SOURCE = "taichi_3d_gaussian_splatting_torch/csrc/blend_backward.cu"
TPU_BACKWARD_KERNEL = "taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py:430"
TRAIN_ITERATIONS = 30
TIMED_STEPS = 10
BATCH_SIZE = 4
BATCH_ITERATIONS = 12
# warm-up and densify interval of the batch run before the division by
# BATCH_SIZE: one densify, at iteration 6, then 5 steps after it
BATCH_DENSIFY_EVERY = 24
TIMED_BATCH_STEPS = 5
VIEWER_FRAMES = 20
# phase 8: the traced training run and render
TRACE_ITERATIONS = 12
TRACE_START, TRACE_STEPS = 5, 5
TRACE_FRAMES = 10
TRACE_TOLERANCE = 0.25
# phase 9: the gate's training run and its floor
GATE_ITERATIONS = 200
GATE_FLOOR_PSNR = 14.0
# phase 13 (a): the entrypoint always passes an SSIM target (default 0.8);
# the same training reached val/ssim 0.6669 (NVIDIA H100 80GB HBM3, 700 W),
# so its floor sits below that as phase 9's PSNR floor sits below 20.96 dB
GATE_FLOOR_SSIM = 0.5
KITTI_STEPS = 3
# phase 10: the bench runs (label of phase 4's scene, environment, trains)
BENCH_RUNS = (("430k synthetic", {}, True),
              ("1.03M heavy-tailed", {"BENCH_SCENE_KIND": "heavy",
                                      "BENCH_POINTS": "1030000"}, True),
              ("2.08M heavy-tailed", {"BENCH_SCENE_KIND": "heavy",
                                      "BENCH_POINTS": "2080000",
                                      "BENCH_TRAIN": "0"}, False))
# bench.py's record (bench.py:278-307), then the port's three keys
BENCH_RENDER_KEYS = ("metric", "value", "unit", "vs_baseline",
                     "baseline_points", "slab_format", "key_overflow",
                     "big_point_overflow", "tile_cap_overflow", "backend",
                     "device", "power_limit_w")
BENCH_TRAIN_KEYS = ("train_step_ms", "densify_ms", "train_step_amortized_ms",
                    "train_iters_per_sec")
# each bench run's launches with its defaults: K1 and P1 in 1 + 11 + 50
# frames at least, K2, K3 and P2 in 4 + 20 steps at least
BENCH_MIN_LAUNCHES = {"blend_forward_rgb": 61, "blend_forward": 24,
                      "blend_backward": 24, "project_forward": 61,
                      "project_backward": 24}
BENCH_RENDER_KERNELS = ("blend_forward_rgb", "project_forward")
# phase 3c: the projection kernels P1 and P2. The JAX package has no Pallas
# kernel there: it jits compute_point_attributes and takes its jax.vjp
# (XLA fuses both), which is what "replaces" names.
PROJECTION_SOURCES = {
    "project_forward":
        "taichi_3d_gaussian_splatting_torch/csrc/projection_forward.cu",
    "project_backward":
        "taichi_3d_gaussian_splatting_torch/csrc/projection_backward.cu"}
PROJECTION_REPLACES = {
    "project_forward": "taichi_3d_gaussian_splatting_tpu/ops/projection.py:98",
    "project_backward":
        "taichi_3d_gaussian_splatting_tpu/ops/rasterizer.py:519"}
# bytes a point must move (each input read once, each output written once;
# the object id's 4 more when K > 1) and float operations a point takes,
# counted from the sources: P1 reads the position, the 56 features and the
# invalid flag and writes 15 float columns and 2 mask bytes; P2 reads the
# position, the features and 9 cotangents and writes 3 + 56 gradients and
# recomputes P1's ~420 operations before its own ~500
PROJECTION_BYTES = {"project_forward": 12 + 224 + 1 + 15 * 4 + 2,
                    "project_backward": 12 + 224 + 9 * 4 + 12 + 224}
PROJECTION_OPS = {"project_forward": 420, "project_backward": 920}
PEAK_BYTES_PER_S, PEAK_FLOPS = 3.35e12, 67e12
# P1 against its plain version on the card: the same float32 operations in
# the same order, so bitwise but where a library call rounds otherwise; P2
# against its plain version, per gradient column (scale = its largest
# |value|): the same formulas, tolerance of the CPU tests against JAX
P1_RTOL, P1_ATOL = 1e-5, 1e-6
P2_RTOL, P2_ATOL = 1e-4, 1e-5
# phase 11 (a): tests/test_quality_synthetic.py's recipe (64x64, 32 views,
# 601 iterations; tests/torch_quality_fixtures.py) with trainer seeds 0-2,
# the JAX test's bars, and the JAX trainer's final val/psnr, val/ssim and
# train/psnr on the same recipe and seeds (device cache on, as the JAX
# test runs; JAX 0.9.0 on the CPU, measured once: the card's machine has no
# JAX). The JAX runs had static-shape budgets that drop no key
# (big_point_divisor and mid_point_divisor 1) in the GT render and in
# training: with the JAX test's own budgets its pool for mid-sized points
# holds 50 of the ~76 points a view that cover four tiles, its GT images
# lose those points' keys in three of their tiles (31% of the pixels
# differ from an exact render, by up to 142 levels), and it reaches only
# 27.24 / 27.72 / 27.81 dB. The port has no budgets and renders exactly.
# The seeds' mean val/psnr must lie within the larger of 0.5 dB and twice
# the JAX seeds' spread (max - min) of the JAX mean.
QUALITY_SEEDS = (0, 1, 2)
JAX_QUALITY_VAL_PSNR = (33.1998, 33.2431, 34.3949)
JAX_QUALITY_VAL_SSIM = (0.9415, 0.9394, 0.9522)
JAX_QUALITY_TRAIN_PSNR = (36.0972, 33.2379, 37.5974)
QUALITY_BAR_DB, QUALITY_MIN_POINTS = 18.0, 100
# phase 11 (b): the 976x544 held-out run (torch_quality_fixtures.BIG) with
# config/tat_truck_every_8_test.yaml's rates and controller thresholds and
# its schedules cut to 3,000 iterations; the held-out bar is the JAX
# package's own (benchmark/README.md:258-263). Depth sorts in buckets of
# 1e-3: the scene's 100,000 points lie ~0.06 apart within depths 7-13, and
# the YAML's buckets of 0.1 would blend neighbours in index order.
HELD_OUT_ITERATIONS = 3000
HELD_OUT_BAR_DB = 25.0
HELD_OUT_KEY_SCALE = 1000.0
HELD_OUT_SCHEDULE = dict(
    num_iterations=HELD_OUT_ITERATIONS, val_interval=500,
    increase_color_max_sh_band_interval=500, initial_downsample_factor=4,
    half_downsample_factor_interval=250)
HELD_OUT_CONTROLLER = dict(
    num_iterations_warm_up=500, num_iterations_densify=100,
    num_iterations_reset_alpha=1500, iteration_start_remove_floater=1000)
# phase 11 (c): the render CLI's PSNR of a held-out view of the trained
# scene against the trainer's own validation render of it
RENDER_CLI_PSNR_ATOL_DB = 1.0
# phase 13: the port's container entrypoint and its quickstart notebook.
# The entrypoint trains phase 9's capture (GATE_ITERATIONS) with the gate at
# GATE_FLOOR_PSNR and GATE_FLOOR_SSIM; the notebook's commands run in order
# with /content in a temporary directory, the written train.yaml cut to
# QUICKSTART_CUTS:
# config/example.yaml's schedule is a 30,001-iteration one, and its
# coarse-to-fine start at factor 4 would crop the capture's 64x48 views to
# 16x0 (16-pixel tiles)
ENTRYPOINT = "taichi_3d_gaussian_splatting_torch/ci/entrypoint.sh"
QUICKSTART = ("taichi_3d_gaussian_splatting_torch/tools/"
              "run_on_cuda_quickstart.ipynb")
QUICKSTART_CUTS = {"num-iterations": GATE_ITERATIONS, "val-interval": 100,
                   "initial-downsample-factor": 1}
# phase 12: the K1 probes (taichi_3d_gaussian_splatting_torch/probes/).
# Float operations a (pixel, key) pair takes by what the key does to the
# pixel (skipped, saturating, contributing), counted from the sources as
# tests/torch_chunk_fixtures.py counts K1's (expf as one): S4, K1's alpha
# step, 14 / 18 / 27 (K1's 26 and the `one` row's product); S3, 12 (dx,
# dy, its exponent's 8, expf, the compare) / 16 (clamp, 1 - alpha, T (1 -
# alpha), the compare) / 33 (w and 8 rows' FMAs); S2's walk 2 (expf, the
# compare) / 6 / 23, beside its product's 16 (8 FMAs) for every (key,
# pixel) of every chunk walked, on the FP64 tensor cores (67 TFLOP/s). S1:
# per (output, step) 26 for exp (1e-6 i, 8 adds, 8 FMAs, expf, the sum),
# 27 for exp2mul, 34 for exp2pre.
PROBE_PAIR_OPS = {"S4": (14, 18, 27), "S3": (12, 16, 33), "S2": (2, 6, 23)}
S2_PRODUCT_OPS = 16
S1_OPS = {"exp": 26, "exp2mul": 27, "exp2pre": 34}
# slab rows each probe kernel reads
PROBE_ROWS = {"S4": 10, "S3": 14, "S2": 16}
# transcendental results a clock on one SM (sm_90), and the H100's SMs
SFU_PER_CLOCK, H100_SMS = 16, 132
# kernel against plain version: K1's rules (ROADMAP.md, rules for K1-K3);
# S1 sums the same 4,096 terms in the same order, its exponent's 8 terms
# in another
PROBE_RTOL, PROBE_ATOL = 2e-3, 1e-4
S1_RTOL = 1e-4
# S5 (perf_roll_micro.cu): float32 operations an (element, repetition),
# counted from the source: mul7 7 multiplies and 7 adds, lane and sub one
# multiply a doubling step (7), exp its 2 multiplies beside one expf on the
# SFU, mxu / mxu_t acc * 1e-3 + dot * 1e-6 (3) beside the product's 8 FMAs
# (16 operations) on the FP64 tensor cores (67 TFLOP/s, as float32 outside
# them)
S5_OPS = {"mul7": 14, "lane": 7, "sub": 7, "exp": 2, "mxu": 3, "mxu_t": 3}
S5_FP64_OPS = 16
PEAK_FP64_TENSOR_FLOPS = 67e12
# S5 kernel against plain version: the modes that round as the plain
# version does, op for op, are held bitwise; exp's expf and the products'
# order of sum round otherwise (measured at 1-3 repetitions: a few ulp)
S5_BITWISE = ("mul7", "lane", "sub")
S5_TOL = {"exp": (1e-6, 0.0), "mxu": (1e-5, 1e-30), "mxu_t": (1e-5, 1e-30)}
S5_SHORT_REPS = (1, 2, 3)
# S5's repetitions as a loop: a run of S5_LOOP_REPS must take at least
# S5_LOOP_MIN_RATIO times less than one of 300 (a loop unrolled away or
# folded would not scale)
S5_LOOP_REPS, S5_LOOP_MIN_RATIO = 30, 5.0
# S5's instances in the probe library's SASS (cuobjdump -sass names)
S5_SASS = {"mul7": "elementwise_kernelILi0E", "exp": "elementwise_kernelILi3E",
           "lane": "lane_scan_kernel", "sub": "sub_scan_kernel",
           "mxu": "mxu_kernelILi4E", "mxu_t": "mxu_kernelILi5E"}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def check_projection_launches(launches, label, fail):
    """One P1 launch per blend forward (K1 or K2: one per frame) and one P2
    launch per blend backward (K3: one per step or view)."""
    frames = launches["blend_forward_rgb"] + launches["blend_forward"]
    if (launches["project_forward"] != frames
            or launches["project_backward"] != launches["blend_backward"]):
        fail(f"{label}: the projection kernels did not launch once per frame "
             f"and step: {launches}")


def check_loss_launches(launches, label, fail):
    """The image loss kernel once per training view (as K3) and once per
    validation view (K2 renders both)."""
    if not (launches["blend_backward"] <= launches["image_loss"]
            <= launches["blend_forward"]):
        fail(f"{label}: the image loss kernel did not launch once per "
             f"training and validation view: {launches}")


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


def time_ms(fn, reps, warmup=2):
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    import torch
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


def make_trainer(paths, logs, densify_every=10, **overrides):
    """The port's trainer on the card, on the dataset of
    write_training_set (`paths`), logging to `logs`, with densify every
    `densify_every` iterations after as many of warm-up."""
    from taichi_3d_gaussian_splatting_torch.models.scene import SceneConfig
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        RasterizerConfig)
    from taichi_3d_gaussian_splatting_torch.training.controller import (
        AdaptiveControllerConfig)
    from taichi_3d_gaussian_splatting_torch.training.loss import (
        LossFunctionConfig)
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer, TrainConfig)
    train_json, val_json, init = paths
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
            num_iterations_warm_up=densify_every,
            num_iterations_densify=densify_every,
            num_iterations_reset_alpha=10 ** 6,
            densification_view_space_position_gradients_threshold=4e-6,
            transparent_alpha_threshold=-2.0,
            under_reconstructed_num_pixels_threshold=256,
            under_reconstructed_move_factor=10.0),
        gaussian_point_cloud_scene_config=SceneConfig(
            max_num_points_ratio=2.0, initial_alpha=0.0,
            initial_covariance_ratio=0.1, max_initial_covariance=3000.0),
        loss_function_config=LossFunctionConfig(enable_regularization=False))
    for key, value in overrides.items():
        setattr(config, key, value)
    return GaussianPointCloudTrainer(config, device="cuda")


def check_run(logs, iterations, fail):
    """The metrics of a finished run: one finite loss per iteration, the
    last below the first, densify ran, the parquets load back finite.
    Returns (losses, validation PSNR)."""
    import torch
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    if len(losses) != iterations or not np.isfinite(losses).all():
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
    for name in (f"scene_{iterations}.parquet", "best_scene.parquet"):
        scene = GaussianPointCloudScene.from_parquet(os.path.join(logs, name))
        if (scene.num_valid_points() == 0 or not bool(torch.isfinite(
                scene.point_cloud_features).all())):
            fail(f"{name} does not load back as a finite scene")
    return losses, [r for r in records if "val/psnr" in r][-1]["val/psnr"]


def staged_step_ms(step, reps):
    """Device ms per stage of `step(mark)`, summed over a step's views and
    averaged over `reps` steps, by CUDA events at each mark."""
    import torch
    stage_ms = {}
    for _ in range(reps):
        events = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        mark("start")
        out = step(mark)
        torch.cuda.synchronize()
        for (_, a), (stage, b) in zip(events, events[1:]):
            stage_ms[stage] = (stage_ms.get(stage, 0.0)
                               + a.elapsed_time(b) / reps)
    return stage_ms, out


def train_phase(paths, root, card, fail):
    """Train the port for TRAIN_ITERATIONS on the dataset of
    write_training_set; check the run; time steps, stages and densify.
    Returns the kernel launch counts of the training run."""
    import torch
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import _no_mark
    from taichi_3d_gaussian_splatting_torch.training.controller import (
        densify_step)

    t0 = time.perf_counter()
    logs = os.path.join(root, "logs")
    trainer = make_trainer(paths, logs)
    config = trainer.config
    print(f"training set and trainer ready in "
          f"{time.perf_counter() - t0:.1f} s: {trainer.scene.capacity} "
          f"slots, {trainer.scene.num_valid_points()} valid", flush=True)

    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts.copy()
    print(f"kernel launches during the {TRAIN_ITERATIONS}-iteration "
          f"training run: {launches}", flush=True)
    if (launches["blend_forward"] < TRAIN_ITERATIONS
            or launches["blend_backward"] < TRAIN_ITERATIONS):
        fail(f"training did not launch K2 and K3 once per step: {launches}")
    check_projection_launches(launches, "training", fail)
    check_loss_launches(launches, "training", fail)

    losses, psnr = check_run(logs, TRAIN_ITERATIONS, fail)
    print(f"training [{W}x{H}, 430k synthetic, 4 views]: "
          f"{TRAIN_ITERATIONS} iterations in {train_s:.2f} s, loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}, validation PSNR "
          f"{psnr:.3f}, {trainer.scene.num_valid_points()} "
          f"valid points after densify ({card})", flush=True)

    # step time, stage breakdown and densify time on the trained state
    cache = trainer._device_cache(trainer.train_dataset, 1)

    def one_step(mark=_no_mark):
        images, qs, ts, intrs, view_cam = trainer._next_views(cache, None, 1,
                                                              1)
        return trainer.step(images[0], qs[0], ts[0], 0, dataclasses.replace(
            view_cam, camera_intrinsics=intrs[0]), mark=mark)

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
    stage_ms, out = staged_step_ms(one_step, 5)
    stats, in_frustum, point_depth, _ = out.densify_inputs
    pos_before = trainer.scene.point_cloud.clone()
    densify_ms = []
    for _ in range(3):
        start.record()
        densify_step(trainer.scene, trainer.ctrl_state, stats, in_frustum,
                     point_depth, pos_before, 100, trainer.generator,
                     config.adaptive_controller_config)
        end.record()
        end.synchronize()
        densify_ms.append(start.elapsed_time(end))
    print(f"training step [{W}x{H}, {trainer.scene.capacity} slots, "
          f"{int(out.metrics['total_keys'])} keys]: {step_ms:.4f} ms/step "
          f"over {TIMED_STEPS} steps after 5 warm-up steps; densify "
          f"{np.mean(densify_ms):.4f} ms ({card})", flush=True)
    print("  step stages ms: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in stage_ms.items()),
          flush=True)
    trainer.logger.close()
    return launches


def batch_train_phase(paths, root, card, fail):
    """Train with batch_size BATCH_SIZE under a one-rank NCCL process group
    for BATCH_ITERATIONS; check the run and the kernels' launches; time the
    batch step and its stages. Returns the launch counts of the run."""
    import datetime
    import torch
    import torch.distributed as dist
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import _no_mark

    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(root, 'nccl_store')}",
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        logs = os.path.join(root, "batch_logs")
        trainer = make_trainer(paths, logs, BATCH_DENSIFY_EVERY,
                               batch_size=BATCH_SIZE,
                               num_iterations=BATCH_ITERATIONS)
        ctrl = trainer.config.adaptive_controller_config
        if not (trainer.mesh.distributed and trainer.mesh.size == 1):
            fail(f"the trainer is not on the process group: {trainer.mesh}")
        print(f"batch training: batch_size {BATCH_SIZE}, warm-up "
              f"{ctrl.num_iterations_warm_up}, densify every "
              f"{ctrl.num_iterations_densify}, feature lr "
              f"{trainer.config.feature_learning_rate:.6g}", flush=True)
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = launch_counts.copy()
        print(f"kernel launches during the {BATCH_ITERATIONS}-iteration "
              f"batch run: {launches}", flush=True)
        views = BATCH_SIZE * BATCH_ITERATIONS
        if min(launches["blend_forward"], launches["blend_backward"]) < views:
            fail(f"batch training did not launch K2 and K3 once per view "
                 f"({views} views): {launches}")
        if launches["accumulate_view"] != views:
            fail(f"batch training did not launch the accumulation kernel "
                 f"once per view ({views} views): {launches}")
        check_projection_launches(launches, "batch training", fail)
        check_loss_launches(launches, "batch training", fail)
        losses, psnr = check_run(logs, BATCH_ITERATIONS, fail)
        print("batch training losses: " + ", ".join(f"{x:.5f}"
                                                    for x in losses),
              flush=True)
        print(f"batch training [{W}x{H}, 430k synthetic, {BATCH_SIZE} views "
              f"a step]: {BATCH_ITERATIONS} iterations in {train_s:.2f} s, "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, validation PSNR "
              f"{psnr:.3f}, {trainer.scene.num_valid_points()} valid points "
              f"({card})", flush=True)

        cache = trainer._device_cache(trainer.train_dataset, 1)

        def batch_step(mark=_no_mark):
            images, qs, ts, intrs, view_cam = trainer._next_views(
                cache, None, 1, BATCH_SIZE)
            return trainer.batch_step(images, qs, ts, intrs, 0, view_cam,
                                      mark=mark)

        for _ in range(2):
            batch_step()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED_BATCH_STEPS):
            batch_step()
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / TIMED_BATCH_STEPS
        stage_ms, _ = staged_step_ms(batch_step, 2)
        print(f"batch step [{W}x{H}, {trainer.scene.capacity} slots, "
              f"{BATCH_SIZE} views, one rank]: {step_ms:.4f} ms/step, "
              f"{step_ms / BATCH_SIZE:.4f} ms/view over {TIMED_BATCH_STEPS} "
              f"steps after 2 warm-up steps ({card})", flush=True)
        print("  batch step stages ms (summed over its views): " + ", ".join(
            f"{k} {v:.4f}" for k, v in stage_ms.items()), flush=True)
        trainer.logger.close()
    finally:
        dist.destroy_process_group()
    return launches


def batch_step_cuda_vs_cpu(root, fail):
    """Two 32x32 batch steps of two views from one state on the card and on
    the CPU: every state array at rtol 2e-3 / atol 1e-4."""
    import torch
    import torch_port_fixtures as fx
    from torch_train_fixtures import batch_step_state, write_dataset
    write_dataset(root)
    gpu = batch_step_state(torch.device("cuda"), root)
    cpu = batch_step_state(torch.device("cpu"), root)
    np.testing.assert_allclose(gpu["losses"], cpu["losses"], rtol=1e-4,
                               err_msg="batch step losses")
    worst = 0.0
    for k, want in cpu["state"].items():
        got = gpu["state"][k]
        np.testing.assert_allclose(got, want, rtol=fx.RTOL, atol=fx.ATOL,
                                   err_msg=f"batch step {k}")
        worst = max(worst, float(np.abs(got.astype(np.float64) - want).max()))
    print(f"32x32 batch steps (B=2) cuda vs cpu: losses {gpu['losses']} vs "
          f"{cpu['losses']}, max |d state| {worst:.3g}", flush=True)


def viewer_phase(root, pc, feats, card, fail):
    """The port's viewer on the card over the scene split into two
    objects: frames after a camera key, an object key and a hide; K1's
    launches, the PNGs and the frame time."""
    import io
    import PIL.Image
    import torch
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    from taichi_3d_gaussian_splatting_torch.visualizer import VisualizerState

    half = pc.shape[0] // 2
    paths = []
    for i, part in enumerate((slice(0, half), slice(half, None))):
        n = pc[part].shape[0]
        path = os.path.join(root, f"viewer_{i}.parquet")
        GaussianPointCloudScene.from_numpy(pc[part], feats[part], np.zeros(n),
                                           np.zeros(n)).to_parquet(path)
        paths.append(path)
    t0 = time.perf_counter()
    state = VisualizerState(paths, W, H, FOCAL, device="cuda")
    print(f"viewer ready in {time.perf_counter() - t0:.2f} s: "
          f"{state.scene.capacity} points, {state.num_objects} objects",
          flush=True)
    reset_launch_counts()
    frames = {}
    for key in ("", "w", "1", "d", "h"):
        if key:
            print(f"viewer key {key!r}: {state.handle_key(key)}", flush=True)
        png = state.frame_png()
        img = PIL.Image.open(io.BytesIO(png))
        if img.size != (W, H):
            fail(f"viewer PNG after {key!r} is {img.size}")
        frames[key] = np.asarray(img, np.float32)
    launches = launch_counts.copy()
    if launches["blend_forward_rgb"] < len(frames):
        fail(f"the viewer's frames did not launch K1: {launches}")
    check_projection_launches(launches, "viewer", fail)
    if np.array_equal(frames["d"], frames["h"]) or not frames["h"].any():
        fail("hiding object 1 did not change the frame, or blanked it")
    for _ in range(3):
        state.frame()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(VIEWER_FRAMES):
        state.frame()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1000.0 / VIEWER_FRAMES
    t0 = time.perf_counter()
    for _ in range(5):
        state.frame_png()
    png_ms = (time.perf_counter() - t0) * 1000.0 / 5
    print(f"viewer [{W}x{H}, 430k synthetic in 2 objects, object 1 hidden]: "
          f"{frame_ms:.4f} ms/frame over {VIEWER_FRAMES} frames, "
          f"{png_ms:.4f} ms per PNG frame; K1 and P1 launches over 5 "
          f"frames {launches['blend_forward_rgb']}, "
          f"{launches['project_forward']} ({card})", flush=True)


def check_trace(label, summary, event_ms, unit, fail):
    """Print a trace summary; fail without kernel events, without a blend
    family of `event_ms` ({"forward" / "backward": CUDA-event ms per
    launch on the same inputs}) or the projection kernel of the same
    family, or when a blend family's time per launch in the
    trace is more than TRACE_TOLERANCE from its CUDA-event time."""
    from taichi_3d_gaussian_splatting_torch.utils.profiling import (
        format_summary)
    print(f"trace [{label}]: " + format_summary(summary, unit), flush=True)
    if summary["kernels"] == 0:
        fail(f"{label}: the trace holds no CUDA kernel events")
    for fam in event_ms:
        if summary["projection"][fam]["launches_per_range"] == 0:
            fail(f"{label}: projection_{fam}_kernel is missing from the "
                 f"trace")
    for fam, want in event_ms.items():
        entry = summary["blend"][fam]
        if entry["launches_per_range"] == 0:
            fail(f"{label}: blend_{fam}_kernel is missing from the trace")
        got = entry["ms_per_range"] / entry["launches_per_range"]
        print(f"  blend {fam}: {got:.4f} ms per launch in the trace, "
              f"{want:.4f} ms by CUDA events ({got / want - 1:+.1%})",
              flush=True)
        if abs(got / want - 1.0) > TRACE_TOLERANCE:
            fail(f"{label}: blend {fam} takes {got:.4f} ms per launch in "
                 f"the trace against {want:.4f} ms by CUDA events")


def trace_train_phase(paths, root, card, fail):
    """Phase 8a: a traced training run; its trace file read back and held
    against K2's and K3's CUDA-event times on each training view of the
    run's final state."""
    import torch
    import torch_chunk_fixtures as cf
    from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        _project_and_bin)
    from taichi_3d_gaussian_splatting_torch.utils.profiling import (
        load_events, summarize_trace, trace_files)

    logs = os.path.join(root, "trace_logs")
    # warm-up as long as the run: no densify
    trainer = make_trainer(paths, logs, TRACE_ITERATIONS,
                           num_iterations=TRACE_ITERATIONS,
                           enable_profiler=True,
                           profiler_start_iteration=TRACE_START,
                           profiler_num_steps=TRACE_STEPS)
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trainer.logger.close()
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        losses = [r["train/loss"] for r in map(json.loads, f)
                  if "train/loss" in r]
    if len(losses) != TRACE_ITERATIONS or not np.isfinite(losses).all():
        fail(f"traced training losses missing or not finite: {losses}")
    files = trace_files(logs)
    if len(files) != 1:
        fail(f"the traced run wrote {len(files)} trace files: {files}")
    t0 = time.perf_counter()
    summary = summarize_trace(load_events(files[0]))
    print(f"traced training: {TRACE_ITERATIONS} iterations in {train_s:.2f} "
          f"s, trace of iterations {TRACE_START}-"
          f"{TRACE_START + TRACE_STEPS - 1} in {os.path.basename(files[0])} "
          f"({os.path.getsize(files[0]) / 2**20:.1f} MiB, read in "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if summary["ranges"] != TRACE_STEPS:
        fail(f"the trace has {summary['ranges']} iteration ranges, not "
             f"{TRACE_STEPS}")

    cam, images, qs, ts, intrs = trainer._device_cache(trainer.train_dataset,
                                                       1)
    scene = trainer.scene
    k2, k3 = [], []
    for v in range(images.shape[0]):
        view_cam = dataclasses.replace(cam, camera_intrinsics=intrs[v])
        with torch.no_grad():
            binning = _project_and_bin(
                *scene, qs[v], ts[v], view_cam,
                trainer.config.rasterisation_config, None)[3]
        kw = dict(num_tiles=view_cam.num_tiles,
                  tiles_per_row=view_cam.tiles_per_row)
        args = (binning.point_data, binning.tile_starts, binning.tile_ends)
        fwd, last = BC.blend_forward_with_last(*args, **kw)
        pixel_in = cf.seeded_pixel_in(fwd, view_cam, v)
        k2.append(time_ms(lambda: BC.blend_forward_with_last(*args, **kw),
                          20))
        k3.append(time_ms(lambda: BC.blend_backward(*args, pixel_in, **kw,
                                                    last=last), 20))
    check_trace(f"training step, {W}x{H}, 430k synthetic, {card}", summary,
                {"forward": float(np.mean(k2)),
                 "backward": float(np.mean(k3))}, "step", fail)


def trace_render_phase(root, render, scene, cfg_rgb, k1_ms, card, fail):
    """Phase 8b: TRACE_FRAMES frames of the rgb_only render under
    torch.profiler, each in a range `frame i`; K1 held against its phase-3
    CUDA-event time `k1_ms` on the same inputs."""
    import torch
    from taichi_3d_gaussian_splatting_torch.utils.profiling import (
        load_events, summarize_trace)
    for _ in range(3):
        render(scene, cfg_rgb)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for i in range(TRACE_FRAMES):
            with torch.profiler.record_function(f"frame {i}"):
                render(scene, cfg_rgb)
        torch.cuda.synchronize()
    path = os.path.join(root, "render_trace.json")
    prof.export_chrome_trace(path)
    summary = summarize_trace(load_events(path), "frame ")
    if summary["ranges"] != TRACE_FRAMES:
        fail(f"the render trace has {summary['ranges']} frame ranges")
    check_trace(f"430k frame, rasterize(rgb_only=True) at {W}x{H}, {card}",
                summary, {"forward": k1_ms}, "frame", fail)


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


def boundary_phase(cam, slab, binning, offset, fail):
    """Phase 3b's boundary fixture: the long-segment fixture `slab` with
    its ranges at column `offset` of a wider zero slab (2**24 - 3: its
    tiles straddle column 2**24). K2's int32 `last` must be the offset-0
    run's plus `offset` exactly and its other rows bitwise the offset-0
    run's; K3's gradients at the shifted columns and its magnitude image
    bitwise the offset-0 run's (the same keys, chunks and order), its other
    columns 0; K3 against its plain version there at rtol 2e-3 / atol
    1e-4 (counts statistically)."""
    import torch
    import torch_port_fixtures as fx
    from torch_chunk_fixtures import seeded_pixel_in, shifted_slab
    from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
    t0 = time.perf_counter()
    kw = dict(num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row)
    base = (slab, binning.tile_starts, binning.tile_ends)
    wide = shifted_slab(*base, offset)
    out0, last0 = BC.blend_forward_with_last(*base, **kw)
    out1, last1 = BC.blend_forward_with_last(*wide, **kw)
    want = torch.where(last0 > 0, last0 + offset, last0)
    if not torch.equal(last1, want):
        fail(f"boundary fixture: K2's int last is not the offset-0 run's + "
             f"{offset} at {int((last1 != want).sum())} pixels")
    rows = [r for r in range(8) if r != BC.OUT_LAST_EFF]
    if not torch.equal(out1[:, rows], out0[:, rows]):
        fail("boundary fixture: K2's output rows differ from the offset-0 "
             "run's")
    past = int((last1.long() > 2 ** 24).sum())
    rounded = int((last1.float().long() != last1.long()).sum())
    pixel_in = seeded_pixel_in(out0, cam, 5)
    g0, m0 = BC.blend_backward(*base, pixel_in, **kw, last=last0)
    g1, m1 = BC.blend_backward(*wide, pixel_in, **kw, last=last1)
    if not (torch.equal(g1[:, offset:], g0) and torch.equal(m1, m0)):
        fail("boundary fixture: K3's gradients or magnitude image differ "
             "from the offset-0 run's")
    if bool(g1[:, :offset].any()):
        fail("boundary fixture: K3 wrote columns no range points at")
    ref = BC.blend_backward_torch(*wide, pixel_in, **kw, last=last1)
    got = g1[:, offset:].cpu().numpy()
    plain = ref[0][:, offset:].cpu().numpy()
    float_rows = [r for r in BC.GRAD_ROWS if r != BC.GROW_NUM_PIXELS]
    np.testing.assert_allclose(got[float_rows], plain[float_rows],
                               rtol=fx.RTOL, atol=fx.ATOL,
                               err_msg="boundary fixture: K3 vs plain")
    fx.assert_counts_close(plain[BC.GROW_NUM_PIXELS], got[BC.GROW_NUM_PIXELS],
                           "boundary fixture num_pixels")
    np.testing.assert_allclose(m1.cpu().numpy(), ref[1].cpu().numpy(),
                               rtol=fx.RTOL, atol=fx.ATOL,
                               err_msg="boundary fixture: K3 mag image")
    print(f"boundary fixture: {wide[0].shape[1]} slab columns (offset "
          f"{offset}), last up to {int(last1.max())}; {past} pixels' last "
          f"past 2**24, {rounded} of them moved by a float32 row; K2's int "
          f"last exactly shifted, K3 bitwise equal to the offset-0 run, max "
          f"|K3 - plain| {float(np.abs(got - plain).max()):.3g} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if rounded == 0:
        fail("boundary fixture: no `last` that a float32 row would round")


# phase 3d: the optimizer kernel. It replaces no Pallas kernel: the JAX
# package leaves Adam to optax and XLA's fusion.
OPTIMIZER_SOURCE = (
    "taichi_3d_gaussian_splatting_torch/csrc/optimizer_update.cu")
# bytes a slot must move, by whether a direct feature gradient is read:
# the features' raw (and direct) gradient, parameter, mu and nu in and
# parameter, mu and nu out (224 bytes each); the positions' gradient,
# parameter, mu and nu in and parameter, mu, nu and the contained gradient
# out (12 bytes each)
OPTIMIZER_BYTES = {True: 8 * 224 + 8 * 12, False: 7 * 224 + 8 * 12}
# the training cells' slot pools
OPTIMIZER_SLOTS = (860_000, 4_160_000)


def optimizer_phase(card, fail):
    """Phase 3d: the optimizer kernel against its plain version on the
    card at the training cells' slot counts, in the single-view form
    without and with a direct gradient (and with half the slots empty, as
    in the trainer's pool) and in the batch form: bit for bit, then a
    call's time (20 calls by CUDA events; the wrapper's 0-d ops included)
    beside the bound. Returns (ms, plain ms, bound ms) of the single-view
    form without a direct gradient (the trainer's without the regularizer)
    at 860,000 slots."""
    from torch_train_fixtures import assert_bitwise_equal, optimizer_inputs
    from taichi_3d_gaussian_splatting_torch.training import adam_cuda as TA
    out = None
    for n in OPTIMIZER_SLOTS:
        for case in ("finite", "empty_slots", "band_3_direct", "batch_form"):
            args, kwargs = optimizer_inputs(case, n, "cuda", seed=n)
            got = TA.optimizer_update(*args, **kwargs)
            want = TA.optimizer_update_torch(*args, **kwargs)
            try:
                assert_bitwise_equal(tuple(got), tuple(want), case)
            except AssertionError as e:
                fail(f"optimizer kernel, {case} at {n} slots: {e}")
            k_ms = time_ms(lambda: TA.optimizer_update(*args, **kwargs), 20)
            p_ms = time_ms(lambda: TA.optimizer_update_torch(*args, **kwargs),
                           5, warmup=1)
            direct = "grad_feats_direct" in kwargs
            bound = n * OPTIMIZER_BYTES[direct] / PEAK_BYTES_PER_S * 1e3
            print(f"optimizer kernel, {case} at {n} slots: bitwise equal, "
                  f"{int(want.nonfinite_grad_rows)} zeroed; kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound:.4f} ms "
                  f"by bytes ({OPTIMIZER_BYTES[direct]} a slot; "
                  f"{100.0 * bound / k_ms:.1f}% of it) ({card})", flush=True)
            if n == OPTIMIZER_SLOTS[0] and case == "finite":
                out = (k_ms, p_ms, bound)
            del args, kwargs, got, want
    return out


# phase 3f: the batch step's accumulation kernel. It replaces no Pallas
# kernel: the JAX package's batch step sums the views' gradients inside one
# jitted function.
ACCUMULATE_SOURCE = (
    "taichi_3d_gaussian_splatting_torch/csrc/accumulate_view.cu")
# bytes a slot a view, by whether the view is the first: the view's feature
# (224) and position (12) gradients in and both sums out; a later view
# reads the sums too
ACCUMULATE_BYTES = {True: 2 * 236, False: 3 * 236}
# the 2.08M cells' slot pool
ACCUMULATE_SLOTS = 4_160_000


def accumulate_phase(card, fail):
    """Phase 3f: the accumulation kernel against its plain version on the
    card at ACCUMULATE_SLOTS, a first view and a later one, without a
    direct gradient (the cells' form): the sums bit for bit, then a call's
    time (20 calls by CUDA events) and the plain version's (5 calls),
    beside the bound by bytes. Returns {"first"|"later": (ms, plain ms,
    bound ms)}."""
    import torch
    from torch_train_fixtures import accumulate_inputs, assert_bitwise_equal
    from taichi_3d_gaussian_splatting_torch.training import adam_cuda as TA
    n = ACCUMULATE_SLOTS
    views, scale, mask = accumulate_inputs(n, "cuda", seed=23, band=3,
                                           views=2)
    got = (torch.empty((n, 56), device="cuda"),
           torch.empty((n, 3), device="cuda"))
    want = tuple(torch.empty_like(t) for t in got)
    out = {}
    for k, form in enumerate(("first", "later")):
        first = k == 0
        args = (views[k][0], views[k][1], scale, mask)
        before = launch_counts["accumulate_view"]
        TA.accumulate_view_gradients(*got, *args, first=first)
        torch.cuda.synchronize()
        if launch_counts["accumulate_view"] != before + 1:
            fail("accumulation kernel: not one launch a call")
        TA.accumulate_view_gradients_torch(*want, *args, first=first)
        try:
            assert_bitwise_equal(got, want, f"{form} view")
        except AssertionError as e:
            fail(f"accumulation kernel at {n} slots: {e}")
        # the sums as they stand after this view, for the timed calls
        sums = tuple(t.clone() for t in got)
        k_ms = time_ms(lambda: TA.accumulate_view_gradients(
            *sums, *args, first=first), 20)
        p_ms = time_ms(lambda: TA.accumulate_view_gradients_torch(
            *sums, *args, first=first), 5, warmup=1)
        bound = n * ACCUMULATE_BYTES[first] / PEAK_BYTES_PER_S * 1e3
        print(f"accumulation kernel, {form} view at {n} slots: bitwise "
              f"equal; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"{n * ACCUMULATE_BYTES[first]} bytes "
              f"({ACCUMULATE_BYTES[first]} a slot), bound {bound:.4f} ms at "
              f"3.35 TB/s ({100.0 * bound / k_ms:.1f}% of it) ({card})",
              flush=True)
        out[form] = (k_ms, p_ms, bound)
        del sums
    return out


# phase 3e: the image loss kernel. It replaces no Pallas kernel: the JAX
# package leaves the loss and its gradient to XLA.
IMAGE_LOSS_SOURCE = "taichi_3d_gaussian_splatting_torch/csrc/image_loss.cu"
# a value (pixel and channel) reads the render and the ground truth and
# writes the gradient and the clamped render; about 400 operations: the
# five blurs' two 11-tap passes (220), the three transposed blurs' (132),
# the SSIM map, its derivatives and the L1 term (~45)
IMAGE_LOSS_BYTES, IMAGE_LOSS_OPS = 16, 400
# the tolerances of tests/test_torch_cuda.py, on the values and on the
# gradient of the pixels' sum (3 H W dL/dx: dL/dx itself is ~1e-6)
LOSS_RTOL, LOSS_ATOL = 2e-3, 1e-4


def image_loss_phase(card, fail):
    """Phase 3e: the image loss kernel against its plain version on the
    card at 976x544 (tests/torch_train_fixtures.py loss_images: values
    outside [0, 1], ties, exact 0 and 1): the loss, L1 and 1 - SSIM and
    the gradient of the pixels' sum at LOSS_RTOL / LOSS_ATOL, the clamped
    render exactly, a second call bit for bit the first; then the kernels'
    device time a call (torch.profiler over 20 calls: the tile kernel and
    the sums' launch), a call's time by CUDA events (20 calls, the
    wrapper's allocations included) and the plain version's, beside the
    bound. Returns (kernel ms, plain ms, bound ms, bound by, max |err| of
    the scaled gradient)."""
    import torch
    from torch_train_fixtures import assert_bitwise_equal, loss_images
    from taichi_3d_gaussian_splatting_torch.training import loss_cuda as TLC
    lam = 0.2
    render, gt = loss_images(H, W, seed=11, device="cuda")
    before = launch_counts["image_loss"]
    got = TLC.image_loss(render, gt, lam)
    torch.cuda.synchronize()
    if launch_counts["image_loss"] != before + 1:
        fail("image loss kernel: not one launch a call")
    want = TLC.image_loss_torch(render, gt, lam)
    n = render.numel()
    for name in ("loss", "l1", "ssim_loss"):
        a, b = float(getattr(got, name)), float(getattr(want, name))
        if not abs(a - b) <= LOSS_ATOL + LOSS_RTOL * abs(b):
            fail(f"image loss kernel: {name} {a!r}, plain {b!r}")
    g, ref = (got.grad.double() * n).cpu(), (want.grad.double() * n).cpu()
    err = (g - ref).abs()
    if not bool((err <= LOSS_ATOL + LOSS_RTOL * ref.abs()).all()):
        fail(f"image loss kernel: gradient of the pixels' sum off by up to "
             f"{float(err.max()):.3g} (plain's largest "
             f"{float(ref.abs().max()):.3g})")
    if not torch.equal(got.image, want.image):
        fail("image loss kernel: the clamped render differs")
    try:
        assert_bitwise_equal(tuple(TLC.image_loss(render, gt, lam)),
                             tuple(got), "a second call")
    except AssertionError as e:
        fail(f"image loss kernel: {e}")
    reps = 20
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            TLC.image_loss(render, gt, lam)
        torch.cuda.synchronize()
    device_us = sum(e.device_time_total for e in prof.key_averages()
                    if "image_loss" in e.key)
    k_ms = device_us / 1e3 / reps
    call_ms = time_ms(lambda: TLC.image_loss(render, gt, lam), reps)
    p_ms = time_ms(lambda: TLC.image_loss_torch(render, gt, lam), 5,
                   warmup=1)
    bytes_ms = n * IMAGE_LOSS_BYTES / PEAK_BYTES_PER_S * 1e3
    ops_ms = n * IMAGE_LOSS_OPS / PEAK_FLOPS * 1e3
    bound, by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    print(f"image loss kernel at {W}x{H}: loss {float(got.loss)!r} (plain "
          f"{float(want.loss)!r}), L1 {float(got.l1)!r} ({float(want.l1)!r}),"
          f" 1 - SSIM {float(got.ssim_loss)!r} ({float(want.ssim_loss)!r});"
          f" gradient of the pixels' sum max |err| {float(err.max()):.3g} "
          f"(largest {float(ref.abs().max()):.3g}); kernels {k_ms:.4f} ms a "
          f"call by the profiler, a call {call_ms:.4f} ms by CUDA events, "
          f"plain {p_ms:.4f} ms; bound {bytes_ms:.4f} ms by bytes "
          f"({IMAGE_LOSS_BYTES} a value), {ops_ms:.4f} ms by operations "
          f"({IMAGE_LOSS_OPS} a value): {100.0 * bound / k_ms:.1f}% of the "
          f"{by} bound ({card})", flush=True)
    if device_us <= 0:
        fail("image loss kernel: the profiler saw no device time")
    return k_ms, p_ms, bound, by, float(err.max())


def projection_bound(name, n, num_objects):
    """(bound ms, "bytes" or "operations") of kernel `name` on n points."""
    per_point = PROJECTION_BYTES[name] + (4 if num_objects > 1 else 0)
    t_bytes = n * per_point / PEAK_BYTES_PER_S * 1e3
    t_ops = n * PROJECTION_OPS[name] / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def projection_cases(scenes, cam):
    """Phase 3c's inputs: (label, camera, pc, feats, invalid, obj, q, t,
    color_sh_mask, object_edit) as numpy arrays: the 20k and 1.03M scenes
    at the render's identity pose, the 430k scene in the trainer's 860,000
    slots (padding as models/scene.py pads: zeros, identity quaternion,
    invalid) at the first training view's pose, and a 32x32 case of two
    objects with an edit transform and the SH mask of band 1."""
    import torch_port_fixtures as fx
    from taichi_3d_gaussian_splatting_torch.ops.sh import sh_band_mask
    q0, t0 = fx.identity_pose()
    cases = []
    for label in ("mid 20k", "1.03M heavy-tailed"):
        pc, feats = scenes[label]
        n = pc.shape[0]
        cases.append((label, cam, pc, feats, np.zeros(n, np.int8),
                      np.zeros(n, np.int32), q0, t0, None, None))
    pc, feats = scenes["430k synthetic"]
    n = pc.shape[0]
    pad_feats = np.zeros((n, 56), np.float32)
    pad_feats[:, 3] = 1.0
    cases.insert(1, ("430k synthetic, 860,000 slots", cam,
                     np.concatenate([pc, np.zeros_like(pc)]),
                     np.concatenate([feats, pad_feats]),
                     np.concatenate([np.zeros(n, np.int8),
                                     np.ones(n, np.int8)]),
                     np.zeros(2 * n, np.int32), q0,
                     np.array([[-0.05, 0.0, 0.0]], np.float32), None, None))
    rng = np.random.default_rng(4)
    pc, feats = fx.random_scene(60, seed=1)
    q = rng.normal(size=(2, 4)).astype(np.float32) * 0.1
    q[:, 3] = 1.0
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qe = rng.normal(size=(2, 4)).astype(np.float32) * 0.2
    qe[:, 3] = 1.0
    qe /= np.linalg.norm(qe, axis=1, keepdims=True)
    edit = (qe, rng.uniform(0.7, 1.3, (2, 3)).astype(np.float32),
            (rng.normal(size=(2, 3)) * 0.1).astype(np.float32))
    small = type(cam)(fx.camera_intrinsics(), 32, 32)
    cases.append(("K=2 object_edit + SH band 1, 32x32", small, pc, feats,
                  np.zeros(60, np.int8), rng.integers(0, 2, 60).astype(
                      np.int32), q, (rng.normal(size=(2, 3)) * 0.1).astype(
                          np.float32), sh_band_mask(1).numpy(), edit))
    return cases


def projection_phase(scenes, cam, near, far, card, fail):
    """Phase 3c: P1 and P2 against their plain versions on the card, on
    projection_cases. P1: in_frustum, emit and the non-finite count
    identical (else each differing point's margins are printed and the
    phase fails), the float columns at P1_RTOL / P1_ATOL; P2: the same
    rows non-finite, the gradients at P2_RTOL / P2_ATOL per column. Prints
    each kernel's and plain version's device ms and the bound. Returns
    ({name: ms}, {name: plain ms}, {name: (bound ms, bound_by)},
    {name: max |kernel - plain|}) at the 860,000-slot case."""
    import torch
    from taichi_3d_gaussian_splatting_torch.ops import projection as P
    from taichi_3d_gaussian_splatting_torch.ops import projection_cuda as PC
    from taichi_3d_gaussian_splatting_torch.ops.gaussian import (
        ALPHA_SKIP_THRESHOLD)
    from taichi_3d_gaussian_splatting_torch.ops.transforms import (
        inverse_SE3_qt)
    cuda = torch.device("cuda")
    ms, plain, bounds, max_err = {}, {}, {}, {}
    for case in projection_cases(scenes, cam):
        label, case_cam, *arrays, mask, edit = case
        pc, feats, invalid, obj, q, t = (torch.as_tensor(x, device=cuda)
                                         for x in arrays)
        n, k = pc.shape[0], q.shape[0]
        if mask is not None:
            mask = torch.as_tensor(mask, device=cuda)
        if edit is not None:
            edit = tuple(torch.as_tensor(x, device=cuda) for x in edit)
        q_cam, t_cam = inverse_SE3_qt(q, t)
        inputs = PC.projection_inputs(q_cam, t_cam, t, case_cam, near, far,
                                      mask, edit)
        with torch.no_grad():
            def plain_forward():
                a = P.compute_point_attributes(
                    pc, feats, invalid, obj, q_cam, t_cam, t, case_cam, near,
                    far, mask, object_edit=edit)
                return a, P.blend_logw(a.rescale, a.alpha_after_activation)
            got, got_logw = PC.project_forward(pc, feats, invalid, obj,
                                               inputs)
            want, want_logw = plain_forward()
        torch.cuda.synchronize()
        differ = {}
        for field in ("in_frustum", "emit"):
            bad = (getattr(got, field) != getattr(want, field)).nonzero()
            differ[field] = bad[:, 0].tolist()
        if differ["in_frustum"] or differ["emit"] or int(
                got.nonfinite_points) != int(want.nonfinite_points):
            zc, u, v = want.depth, want.u, want.v
            peak = want.rescale * want.alpha_after_activation
            for field, rows in differ.items():
                for i in rows[:20]:
                    print(f"  {label} {field} differs at {i}: zc - near "
                          f"{float(zc[i] - near):.3g}, u {float(u[i]):.9g}, "
                          f"v {float(v[i]):.9g}, peak - 1/255 "
                          f"{float(peak[i] - ALPHA_SKIP_THRESHOLD):.3g}",
                          flush=True)
            fail(f"{label}: P1's masks or count differ from the plain "
                 f"version's: in_frustum {len(differ['in_frustum'])}, emit "
                 f"{len(differ['emit'])}, nonfinite "
                 f"{int(got.nonfinite_points)} vs "
                 f"{int(want.nonfinite_points)}")
        f_err, bitwise = 0.0, []
        for field in PC.FLOAT_ROWS:
            a = (got_logw if field == "logw" else getattr(got, field))
            b = (want_logw if field == "logw" else getattr(want, field))
            a, b = a.cpu().numpy(), b.cpu().numpy()
            np.testing.assert_allclose(a, b, rtol=P1_RTOL, atol=P1_ATOL,
                                       err_msg=f"{label} P1 {field}")
            ok = np.isfinite(b)
            f_err = max(f_err, float(np.abs(a[ok] - b[ok]).max(initial=0)))
            if not np.array_equal(a, b, equal_nan=True):
                bitwise.append(field)
        rng = np.random.default_rng(9)
        cot = torch.as_tensor(rng.normal(size=(9, n)).astype(np.float32),
                              device=cuda)
        g = PC.project_backward(pc, feats, obj, inputs, cot)
        r = P.project_points_backward_torch(pc, feats, obj, q_cam, t_cam, t,
                                            case_cam, near, cot, mask,
                                            object_edit=edit)
        g = [x.cpu().numpy() for x in g]
        r = [x.cpu().numpy() for x in r]
        b_err, rows_bad = 0.0, 0
        for what, a, b in zip(("positions", "features"), g, r):
            finite = np.isfinite(b).all(1)
            if not np.array_equal(np.isfinite(a).all(1), finite):
                fail(f"{label}: P2's non-finite {what} rows differ from the "
                     f"plain version's")
            rows_bad = max(rows_bad, int((~finite).sum()))
            for col in range(b.shape[1]):
                scale = float(np.abs(b[finite, col]).max(initial=0))
                np.testing.assert_allclose(
                    a[finite, col], b[finite, col], rtol=P2_RTOL,
                    atol=P2_ATOL * scale,
                    err_msg=f"{label} P2 {what} column {col}")
            b_err = max(b_err, float(np.abs(a[finite] - b[finite]).max(
                initial=0)))
        print(f"projection kernels vs plain [{label}, {n} points, K={k}]: "
              f"masks and nonfinite count ({int(got.nonfinite_points)}) "
              f"identical, {int(got.emit.sum())} emit; P1 max |d| "
              f"{f_err:.3g}, columns not bitwise: {bitwise or 'none'}; P2 "
              f"max |d| {b_err:.3g}, {rows_bad} non-finite rows in both",
              flush=True)
        if n < 10000:
            continue
        k1 = time_ms(lambda: PC.project_forward(pc, feats, invalid, obj,
                                                inputs), 20)
        with torch.no_grad():
            p1 = time_ms(plain_forward, 3, warmup=1)
        k2 = time_ms(lambda: PC.project_backward(pc, feats, obj, inputs, cot),
                     20)
        p2 = time_ms(lambda: P.project_points_backward_torch(
            pc, feats, obj, q_cam, t_cam, t, case_cam, near, cot, mask,
            object_edit=edit), 3, warmup=1)
        for name, k_ms, p_ms, err in (("project_forward", k1, p1, f_err),
                                      ("project_backward", k2, p2, b_err)):
            bound = projection_bound(name, n, k)
            print(f"{label} {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                  f"ms, bound {bound[0]:.4f} ms by {bound[1]} "
                  f"({100.0 * bound[0] / k_ms:.1f}% of it) ({card})",
                  flush=True)
            if label.endswith("860,000 slots"):   # the trainer's shapes
                ms[name], plain[name], bounds[name] = k_ms, p_ms, bound
                max_err[name] = err
        del pc, feats, g, r
    return ms, plain, bounds, max_err


def data_chain_phase(root, card, fail):
    """Phase 9: COLMAP capture -> tools/prepare_colmap.py -> the port's
    experiment gate (train CLI on the card) -> the gate on the written
    metrics at final val/psnr -+ 0.5 dB -> the render CLI on one held-out
    view; then the KITTI capture through the port's prepare_kitti and 3
    training steps on the card."""
    import PIL.Image
    import torch
    import yaml
    from torch_capture_fixtures import (COLMAP_H, COLMAP_W,
                                        colmap_train_config,
                                        write_colmap_capture,
                                        write_kitti_capture)
    from torch_train_fixtures import config_dict
    from taichi_3d_gaussian_splatting_torch import config as tconfig
    from taichi_3d_gaussian_splatting_torch import render as render_cli
    from taichi_3d_gaussian_splatting_torch.tools import prepare_kitti
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer, TrainConfig)

    t0 = time.perf_counter()
    os.makedirs(root)
    images, sparse = write_colmap_capture(root, "cuda")
    dataset = os.path.join(root, "dataset")
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "prepare_colmap.py"),
                    "--base_path", sparse, "--image_path", images,
                    "--output_dir", dataset, "--val_every", "5"],
                   check=True, timeout=300)
    config = os.path.join(root, "train.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(colmap_train_config(root, dataset, GATE_ITERATIONS), f)

    def gate(*extra):
        return subprocess.run(
            [sys.executable, "-m",
             "taichi_3d_gaussian_splatting_torch.ci.run_experiment",
             "--train_config", config, "--device", "cuda",
             "--output", os.path.join(root, "summary.md"), *extra],
            cwd=REPO, capture_output=True, text=True, timeout=600)

    t_gate = time.perf_counter()
    run = gate("--target_psnr", str(GATE_FLOOR_PSNR))
    gate_s = time.perf_counter() - t_gate
    if run.returncode != 0 or "quality gate passed" not in run.stdout:
        fail(f"the experiment gate (training on the card) exited "
             f"{run.returncode}:\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    logs = os.path.join(root, "logs")
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    val_psnr = [r["val/psnr"] for r in records if "val/psnr" in r]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    if len(losses) != GATE_ITERATIONS or not np.isfinite(losses).all():
        fail("the gate's training losses are missing or not finite")
    final = val_psnr[-1]
    for delta, code in ((-0.5, 0), (0.5, 1)):
        again = gate("--skip_training", "--target_psnr", str(final + delta))
        if again.returncode != code:
            fail(f"the gate at final val/psnr {final:+.1f} {delta:+.1f} dB "
                 f"exited {again.returncode}, not {code}:\n"
                 f"{again.stdout[-2000:]}")

    with open(os.path.join(dataset, "val.json")) as f:
        view = json.load(f)[:1]
    one_view = os.path.join(root, "one_view.json")
    with open(one_view, "w") as f:
        json.dump(view, f)
    reset_launch_counts()
    render_cli.main(["--parquet_path", os.path.join(logs, "best_scene.parquet"),
                     "--dataset_json_path", one_view, "--output_prefix",
                     os.path.join(root, "frame"), "--width", str(COLMAP_W),
                     "--height", str(COLMAP_H), "--fx", "50.0", "--fy", "52.0",
                     "--device", "cuda"])
    torch.cuda.synchronize()
    if (launch_counts["blend_forward_rgb"],
            launch_counts["project_forward"]) != (1, 1):
        fail(f"the render CLI did not launch K1 and P1 once: "
             f"{dict(launch_counts)}")
    frame = np.asarray(PIL.Image.open(os.path.join(root, "frame_00000.png")),
                       np.float64)
    truth = np.asarray(PIL.Image.open(view[0]["image_path"]),
                       np.float64)[:, :, :3]
    if frame.shape != truth.shape or frame.std() <= 1.0:
        fail(f"the render CLI's frame is blank or of shape {frame.shape}")
    frame_psnr = 10.0 * np.log10(255.0 ** 2 / np.mean((frame - truth) ** 2))

    kitti = os.path.join(root, "kitti")
    os.makedirs(kitti)
    xml, ply, kitti_images = write_kitti_capture(kitti)
    out = os.path.join(kitti, "converted")
    prepare_kitti.main(["--camera_xml", xml, "--point_cloud_ply", ply,
                        "--image_dir", kitti_images, "--output_dir", out])
    d = config_dict(
        os.path.join(kitti, "run"),
        train_dataset_json_path=os.path.join(out, "kitti_train.json"),
        val_dataset_json_path=os.path.join(out, "kitti_val_downsample.json"),
        pointcloud_parquet_path=os.path.join(
            out, "point_cloud_downsample.parquet"),
        num_iterations=KITTI_STEPS, val_interval=10 ** 6)
    reset_launch_counts()
    trainer = GaussianPointCloudTrainer(tconfig.from_dict(TrainConfig, d),
                                        device="cuda")
    trainer.train()
    trainer.logger.close()
    torch.cuda.synchronize()
    launches = launch_counts.copy()
    with open(os.path.join(d["summary_writer_log_dir"], "metrics.jsonl")) as f:
        kitti_losses = [r["train/loss"] for r in map(json.loads, f)
                        if "train/loss" in r]
    if len(kitti_losses) != KITTI_STEPS or not np.isfinite(kitti_losses).all():
        fail(f"KITTI training losses: {kitti_losses}")
    if min(launches["blend_forward"], launches["blend_backward"]) < \
            KITTI_STEPS:
        fail(f"KITTI training did not launch K2 and K3 each step: {launches}")
    check_projection_launches(launches, "KITTI training", fail)
    print(f"data chain [COLMAP binary {COLMAP_W}x{COLMAP_H}, 10 views -> "
          f"prepare_colmap -> gate]: {GATE_ITERATIONS} iterations through the "
          f"train CLI in {gate_s:.1f} s, val/psnr first {val_psnr[0]:.4f} -> "
          f"final {final:.4f} dB (floor {GATE_FLOOR_PSNR}), loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; gate at final -0.5 dB "
          f"exit 0, +0.5 dB exit 1; render CLI frame PSNR {frame_psnr:.4f} "
          f"dB; KITTI capture -> prepare_kitti -> {KITTI_STEPS} steps, loss "
          f"{kitti_losses[-1]:.5f}, launches {launches}; phase "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)


def run_bench(label, knobs, trains, fail):
    """The port's bench in a subprocess with the BENCH_ `knobs` (the kernel
    library is already built), checked against its record's keys, its
    counters and its launch line. Returns (record, launches, stderr,
    seconds)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(knobs)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "taichi_3d_gaussian_splatting_torch.bench"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    record, launches = check_bench_output(label, proc, trains, fail)
    return record, launches, proc.stderr, seconds


def check_bench_output(label, proc, trains, fail):
    """The bench's finished process `proc` (text output) held to exit 0, a
    record of every key with value > 0, backend torch-cuda and the
    dropped-work counters 0, and its stderr launch line to the launches of
    BENCH_MIN_LAUNCHES (the render's kernels, and the training's where it
    `trains`). Returns (record, launches)."""
    if proc.returncode != 0:
        fail(f"bench [{label}] exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    keys = BENCH_RENDER_KEYS + (BENCH_TRAIN_KEYS if trains else ())
    missing = [k for k in keys if k not in record]
    if missing:
        fail(f"bench [{label}]: record lacks {missing}: {record}")
    if not record["value"] > 0 or record["backend"] != "torch-cuda":
        fail(f"bench [{label}]: value or backend wrong: {record}")
    if (record["key_overflow"], record["big_point_overflow"],
            record["tile_cap_overflow"]) != (0, 0, 0):
        fail(f"bench [{label}]: dropped-work counters not 0: {record}")
    prefix = "kernel launches: "
    launch_lines = [line for line in proc.stderr.splitlines()
                    if line.startswith(prefix)]
    if not launch_lines:
        fail(f"bench [{label}]: no launch line on stderr")
    launches = json.loads(launch_lines[-1][len(prefix):])
    short = {k: launches[k] for k, v in BENCH_MIN_LAUNCHES.items()
             if (trains or k in BENCH_RENDER_KERNELS) and launches[k] < v}
    if short:
        fail(f"bench [{label}]: too few launches {short} of {launches}")
    return record, launches


def bench_phase(phase4_ms, fail):
    """Phase 10: the port's bench for each run of BENCH_RUNS (run_bench),
    its frame time against phase 4's for the same scene."""
    for label, knobs, trains in BENCH_RUNS:
        record, launches, stderr, seconds = run_bench(label, knobs, trains,
                                                      fail)
        frame_ms = 1000.0 / record["value"]
        if not 0.5 * phase4_ms[label] <= frame_ms <= 2.0 * phase4_ms[label]:
            fail(f"bench [{label}]: frame {frame_ms:.4f} ms, not within 2x of "
                 f"phase 4's {phase4_ms[label]:.4f} ms")
        print(f"bench [{label}]: {json.dumps(record)}", flush=True)
        print(f"  launches {launches}; frame {frame_ms:.4f} ms against phase "
              f"4's {phase4_ms[label]:.4f} ms; "
              + "; ".join(line for line in stderr.splitlines()
                          if line.startswith("peak device memory"))
              + f"; {seconds:.1f} s", flush=True)


def check_training_launches(label, fail):
    """Every kernel of the training path launched since the last reset,
    P1 once per frame, P2 and the optimizer kernel once per single-view
    step, the batch step's accumulation kernel never, the image loss
    kernel once per training and validation view; returns the counts."""
    launches = launch_counts.copy()
    if min(launches["blend_forward"], launches["blend_backward"]) < 1:
        fail(f"{label}: a kernel of the training path was never launched: "
             f"{launches}")
    check_projection_launches(launches, label, fail)
    if launches["optimizer_update"] != launches["blend_backward"]:
        fail(f"{label}: the optimizer kernel did not launch once per step: "
             f"{launches}")
    if launches["accumulate_view"]:
        fail(f"{label}: a single-view step launched the batch step's "
             f"accumulation kernel: {launches}")
    check_loss_launches(launches, label, fail)
    return launches


def quality_recipe_phase(root, card, fail):
    """Phase 11 (a): tests/test_quality_synthetic.py's recipe on the card,
    GT rendered by the port, device cache on, trainer seeds QUALITY_SEEDS.
    Each run must pass the JAX test's bars; the seeds' mean held-out PSNR
    must lie within the tolerance of the JAX mean."""
    import torch_quality_fixtures as Q
    from taichi_3d_gaussian_splatting_torch import config as tconfig
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer, TrainConfig)
    Q.write_dataset(root, Q.port_renderer("cuda"))
    vals = []
    for seed in QUALITY_SEEDS:
        logs = os.path.join(root, f"logs_{seed}")
        trainer = GaussianPointCloudTrainer(tconfig.from_dict(
            TrainConfig, Q.quality_config(root, seed=seed,
                                          summary_writer_log_dir=logs)),
            device="cuda")
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        seconds = time.perf_counter() - t0
        launches = check_training_launches(f"quality recipe seed {seed}",
                                           fail)
        records = Q.read_metrics(logs)
        val = Q.series(records, "val/psnr")
        ssim = Q.series(records, "val/ssim")
        train = Q.series(records, "train/psnr")
        train_ssim = Q.series(records, "train/ssim")
        valid = Q.series(records, "value/num_valid_points")
        last_val, last_train = val[max(val)], train[max(train)]
        last_valid = valid[max(valid)]
        print(f"quality recipe seed {seed}: val/psnr {val}, val/ssim "
              f"{ssim[max(ssim)]:.4f}, train/psnr {last_train:.4f} and "
              f"train/ssim {train_ssim[max(train)]:.4f} (at "
              f"{max(train)}), valid points {last_valid:.0f}, "
              f"{seconds:.1f} s for 601 iterations, launches {launches} "
              f"({card})", flush=True)
        if not (last_val > QUALITY_BAR_DB and last_train > QUALITY_BAR_DB
                and last_valid > QUALITY_MIN_POINTS):
            fail(f"quality recipe seed {seed}: below the JAX test's bars "
                 f"(val {last_val}, train {last_train}, valid {last_valid})")
        vals.append(last_val)
    jax_mean = float(np.mean(JAX_QUALITY_VAL_PSNR))
    tol = max(0.5, 2.0 * (max(JAX_QUALITY_VAL_PSNR)
                          - min(JAX_QUALITY_VAL_PSNR)))
    mean = float(np.mean(vals))
    print(f"quality recipe: mean val/psnr {mean:.4f} over seeds "
          f"{QUALITY_SEEDS} against the JAX trainer's {jax_mean:.4f} "
          f"(CPU, {JAX_QUALITY_VAL_PSNR}; val/ssim {JAX_QUALITY_VAL_SSIM}, "
          f"train/psnr {JAX_QUALITY_TRAIN_PSNR}); tolerance {tol:.4f} dB",
          flush=True)
    if abs(mean - jax_mean) > tol:
        fail(f"quality recipe: mean val/psnr {mean} not within {tol} dB of "
             f"the JAX mean {jax_mean}")


def held_out_config(root, logs, val_json=None):
    """config/tat_truck_every_8_test.yaml with the dataset under `root`,
    logs and outputs to `logs`, its schedules cut (HELD_OUT_SCHEDULE,
    HELD_OUT_CONTROLLER), pool ratio 4, no background sphere, and depth
    buckets of 1 / HELD_OUT_KEY_SCALE."""
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        TrainConfig)
    config = TrainConfig.from_yaml_file(
        os.path.join(REPO, "config", "tat_truck_every_8_test.yaml"))
    return dataclasses.replace(
        config, train_dataset_json_path=os.path.join(root, "train.json"),
        val_dataset_json_path=val_json or os.path.join(root, "val.json"),
        pointcloud_parquet_path=os.path.join(root, "point_cloud.parquet"),
        summary_writer_log_dir=logs, output_model_dir=logs,
        log_image_interval=10 ** 9, save_full_checkpoint=False,
        rasterisation_config=dataclasses.replace(
            config.rasterisation_config,
            depth_to_sort_key_scale=HELD_OUT_KEY_SCALE),
        adaptive_controller_config=dataclasses.replace(
            config.adaptive_controller_config, **HELD_OUT_CONTROLLER),
        gaussian_point_cloud_scene_config=dataclasses.replace(
            config.gaussian_point_cloud_scene_config,
            max_num_points_ratio=4.0, add_sphere=False),
        **HELD_OUT_SCHEDULE)


def held_out_phase(root, card, fail):
    """Phase 11 (b): torch_quality_fixtures.BIG rendered by the port on the
    card (24 views, every 8th held out, an init of half the points jittered
    by N(0, 0.03) with their colours), trained HELD_OUT_ITERATIONS with
    held_out_config. Fails below HELD_OUT_BAR_DB held out, without a gain
    over the first validation, on a non-finite loss, when densify added no
    point or the final scene is empty. Returns the logs directory."""
    import pandas as pd
    import torch
    import torch_quality_fixtures as Q
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer)
    t0 = time.perf_counter()
    Q.write_dataset(root, Q.port_renderer(
        "cuda", near=0.4, far=2000.0, depth_key_scale=HELD_OUT_KEY_SCALE),
        **Q.BIG)
    init_points = len(pd.read_parquet(os.path.join(root,
                                                   "point_cloud.parquet")))
    print(f"held-out scene: {Q.BIG['n_points']} GT points, "
          f"{Q.BIG['n_views']} views at {Q.BIG['width']}x{Q.BIG['height']} "
          f"rendered in {time.perf_counter() - t0:.1f} s, {init_points} init "
          f"points", flush=True)
    logs = os.path.join(root, "logs")
    trainer = GaussianPointCloudTrainer(held_out_config(root, logs),
                                        device="cuda")
    step_started = []
    step = trainer.step

    def timed_step(*args, **kwargs):
        step_started.append(time.perf_counter())
        return step(*args, **kwargs)

    trainer.step = timed_step
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    seconds = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = check_training_launches("held-out run", fail)
    records = Q.read_metrics(logs)
    val = Q.series(records, "val/psnr")
    ssim = Q.series(records, "val/ssim")
    losses = Q.series(records, "train/loss")
    valid = Q.series(records, "value/num_valid_points")
    skipped = Q.series(records, "train/skipped_nonfinite_step")
    # iterations 2501-2999: after the last in-loop validation (at 2500)
    tail = step_started[-(HELD_OUT_ITERATIONS // 6 - 1):]
    step_ms = 1000.0 * (tail[-1] - tail[0]) / (len(tail) - 1)
    train = Q.series(records, "train/psnr")
    train_ssim = Q.series(records, "train/ssim")
    print(f"held-out run: val/psnr {val}", flush=True)
    print(f"  val/ssim {ssim}", flush=True)
    print(f"  train/psnr {train[max(train)]:.4f} and train/ssim "
          f"{train_ssim[max(train)]:.4f} (the view of iteration "
          f"{max(train)})", flush=True)
    print(f"  valid points after each densify {valid}", flush=True)
    print(f"  densify: " + ", ".join(
        f"{k.split('/')[1]} {sum(Q.series(records, k).values()):.0f}"
        for k in ("densify/num_fillable", "densify/num_over_reconstructed",
                  "densify/num_transparent", "densify/num_floaters")),
        flush=True)
    print(f"  {HELD_OUT_ITERATIONS} iterations in {seconds:.1f} s, "
          f"{step_ms:.4f} ms an iteration over the last {len(tail) - 1} "
          f"(densify included), peak device memory {peak_mib:.1f} MiB, "
          f"launches {launches} ({card})", flush=True)
    first, final = val[min(val)], val[max(val)]
    if not np.isfinite(list(losses.values())).all() or any(skipped.values()):
        fail(f"held-out run: a non-finite loss ({skipped})")
    if final < HELD_OUT_BAR_DB:
        fail(f"held-out run: final val/psnr {final} below {HELD_OUT_BAR_DB}")
    if not final > first:
        fail(f"held-out run: final val/psnr {final} not above the first "
             f"validation's {first}")
    if not max(valid.values()) > init_points:
        fail(f"held-out run: densify added no point ({valid}, init "
             f"{init_points})")
    scene = GaussianPointCloudScene.from_parquet(
        os.path.join(logs, f"scene_{HELD_OUT_ITERATIONS}.parquet"))
    if scene.num_valid_points() == 0:
        fail("held-out run: the final scene is empty")
    return logs


def trained_scene_phase(root, logs, card, fail):
    """Phase 11 (c): (b)'s best_scene.parquet reloaded and rendered through
    the render CLI at a held-out view, its PSNR against the GT within
    RENDER_CLI_PSNR_ATOL_DB of the trainer's own validation render of that
    view and scene; then the port's bench on that parquet without
    training."""
    import PIL.Image
    import torch_quality_fixtures as Q
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer)
    best = os.path.join(logs, "best_scene.parquet")
    with open(os.path.join(root, "val.json")) as f:
        view = json.load(f)[0]
    one_view = os.path.join(root, "held_out_view.json")
    with open(one_view, "w") as f:
        json.dump([view], f)
    out = os.path.join(root, "cli", "frame")
    proc = subprocess.run(
        [sys.executable, "-m", "taichi_3d_gaussian_splatting_torch.render",
         "--device", "cuda", "--parquet_path", best, "--dataset_json_path",
         one_view, "--output_prefix", out, "--width", str(Q.BIG["width"]),
         "--height", str(Q.BIG["height"])],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"render CLI exited {proc.returncode}: {proc.stderr[-3000:]}")

    def png(path):
        return np.asarray(PIL.Image.open(path), np.float64)[..., :3] / 255.0

    mse = float(np.mean((png(out + "_00000.png") - png(view["image_path"]))
                        ** 2))
    cli_psnr = 10.0 * np.log10(1.0 / mse)
    c_logs = os.path.join(root, "validation_of_best")
    trainer = GaussianPointCloudTrainer(
        held_out_config(root, c_logs, val_json=one_view), device="cuda")
    trainer.scene = GaussianPointCloudScene.from_parquet(best)
    trainer.validation(0)
    val_psnr = Q.series(Q.read_metrics(c_logs), "val/psnr")[0]
    print(f"trained scene: {trainer.scene.num_valid_points()} points; "
          f"held-out view {view['image_path']}: render CLI PSNR "
          f"{cli_psnr:.4f} dB (packed8, near 0.8), the trainer's validation "
          f"render {val_psnr:.4f} dB ({card})", flush=True)
    if abs(cli_psnr - val_psnr) > RENDER_CLI_PSNR_ATOL_DB:
        fail(f"render CLI PSNR {cli_psnr} not within "
             f"{RENDER_CLI_PSNR_ATOL_DB} dB of the validation's {val_psnr}")
    record, launches, stderr, seconds = run_bench(
        "trained scene", {"BENCH_SCENE": best, "BENCH_TRAIN": "0"}, False,
        fail)
    print(f"bench [trained scene]: {json.dumps(record)}", flush=True)
    print(f"  launches {launches}; "
          + "; ".join(line for line in stderr.splitlines()
                      if line.startswith("peak device memory"))
          + f"; {seconds:.1f} s", flush=True)


def probe_work(name, slab, tile_starts, tile_ends, num_tiles, tiles_per_row,
               pairs_slab=None):
    """The work of probe `name`'s `full` mode ("S4", "S3", "S2") on these
    inputs: {"bytes", "ops", "bound_ms", "bound_by", "pairs"}. Pairs by
    tests/torch_chunk_fixtures.py pair_counts on `pairs_slab` (a wide16
    slab of the same keys in K1's form; default `slab`): each pixel's keys
    up to its saturating key. S2 adds its product over every chunk walked
    (a tile leaves after the chunk of its last pixel's saturating key)."""
    import torch
    from torch_chunk_fixtures import pair_counts
    counts = pair_counts(slab if pairs_slab is None else pairs_slab,
                         tile_starts, tile_ends, num_tiles=num_tiles,
                         tiles_per_row=tiles_per_row)
    skipped, saturating, contributing = (
        int(counts[k].sum()) for k in ("skipped", "saturating",
                                       "contributing"))
    o_skip, o_sat, o_con = PROBE_PAIR_OPS[name]
    ops = o_skip * skipped + o_sat * saturating + o_con * contributing
    mk = slab.shape[1]
    nbytes = 4 * (PROBE_ROWS[name] * mk + 8 * num_tiles * 256
                  + 2 * num_tiles)
    t_ops = ops / PEAK_FLOPS * 1e3
    if name == "S2":
        start = tile_starts.long().clamp(0, mk)
        end = torch.maximum(tile_ends.long().clamp(max=mk), start)
        aligned = start // 128 * 128
        chunks = torch.where(end > start, (end - aligned + 127) // 128, 0)
        sat_pos = counts["sat_pos"]
        last = torch.where((sat_pos < 0).any(dim=1), chunks - 1,
                           (start - aligned + sat_pos.amax(dim=1)) // 128)
        walked = int(torch.where(chunks > 0, last + 1, 0).sum())
        product = S2_PRODUCT_OPS * walked * 128 * 256
        ops += product
        # the FP64 tensor cores and the float32 pipes run side by side
        t_ops = max(t_ops, product / PEAK_FLOPS * 1e3)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pairs": skipped + saturating + contributing,
            "contributing": contributing}


def s1_sass_summary():
    """What S1's three kernels compile to: per kernel of the probe library
    (cuobjdump -sass), its instruction count, its MUFU.EX2 count and the
    instructions around its first MUFU.EX2."""
    from taichi_3d_gaussian_splatting_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    libs = sorted(_build.BUILD_DIR.glob("libt3dgs_probes_*.so"))
    if not os.path.isfile(tool) or not libs:
        print("  S1 SASS: cuobjdump or the probe library not found",
              flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(libs[-1])], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        if "exp2_probe_kernel" not in block.splitlines()[0]:
            continue
        lines = [ln for ln in block.splitlines() if "/*" in ln and ";" in ln]
        ex2 = [i for i, ln in enumerate(lines) if "MUFU.EX2" in ln]
        print(f"  S1 SASS {block.splitlines()[0].strip()}: {len(lines)} "
              f"instructions, {len(ex2)} MUFU.EX2", flush=True)
        if ex2:
            for ln in lines[max(0, ex2[0] - 8):ex2[0] + 4]:
                print(f"    {ln.split(';')[0].split('*/')[-1].strip()}",
                      flush=True)


def s5_sass_summary(fail):
    """What S5's six instances compile to (cuobjdump -sass of the probe
    library): per instance its instruction count, backward branches (the
    repetition loop) and counts of SHFL.UP, FFMA, FMUL, FADD, MUFU.EX2,
    DMMA, LDS, STS and BAR. Fails unless every instance keeps a loop, lane
    shuffles up and mul7 has no FFMA (its pairs are not contracted)."""
    import re
    from taichi_3d_gaussian_splatting_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    libs = sorted(_build.BUILD_DIR.glob("libt3dgs_probes_*.so"))
    if not os.path.isfile(tool) or not libs:
        print("  S5 SASS: cuobjdump or the probe library not found",
              flush=True)
        return
    sass = subprocess.run([tool, "-sass", str(libs[-1])], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    instr = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
    label = re.compile(r"^\s*(\.L_x_\d+):")
    target = re.compile(r"(\.L_x_\d+|0x[0-9a-f]+)")
    found = {}
    for block in sass.split("Function : ")[1:]:
        head = block.splitlines()[0].strip()
        mode = next((m for m, key in S5_SASS.items() if key in head), None)
        if mode is None or mode in found:
            continue
        # a branch is backward when its target lies strictly before it (the
        # self-branch after EXIT that ends every kernel is not a loop)
        at_label, lines, backward = {}, [], 0
        for ln in block.splitlines():
            m = label.match(ln)
            if m:
                at_label[m.group(1)] = len(lines)
                continue
            m = instr.search(ln)
            if not m:
                continue
            addr, text = int(m.group(1), 16), m.group(2).strip()
            t = target.search(text) if "BRA" in text else None
            if t and (at_label.get(t.group(1), len(lines)) < len(lines) or (
                    t.group(1).startswith("0x")
                    and int(t.group(1), 16) < addr)):
                backward += 1
            lines.append(text)
        counts = {op: sum(op in ln for ln in lines)
                  for op in ("SHFL.UP", "FFMA", "FMUL", "FADD", "MUFU.EX2",
                             "DMMA", "LDS", "STS", "BAR")}
        found[mode] = (len(lines), backward, counts)
        print(f"  S5 SASS {mode} ({head[:60]}): {len(lines)} instructions, "
              f"{backward} backward branches, {counts}", flush=True)
    if set(found) != set(S5_SASS):
        fail(f"S5 SASS: instances found {sorted(found)}, expected "
             f"{sorted(S5_SASS)}")
    for mode, (_, backward, counts) in found.items():
        if backward < 1:
            fail(f"S5 SASS {mode}: no backward branch (no repetition loop)")
    if found["lane"][2]["SHFL.UP"] < 1:
        fail("S5 SASS lane: no SHFL.UP")
    if found["mul7"][2]["FFMA"] != 0:
        fail(f"S5 SASS mul7: {found['mul7'][2]['FFMA']} FFMA (contracted)")


def s5_shares(out):
    """Shares of zeros, subnormals and infinities among out's values."""
    import torch
    tiny = torch.finfo(torch.float32).tiny
    mag = out.abs()
    n = out.numel()
    return {"zero": float((mag == 0).sum()) / n,
            "subnormal": float(((mag > 0) & (mag < tiny)).sum()) / n,
            "inf": float(torch.isinf(out).sum()) / n}


def hold_s5(label, mode, got, ref, fail):
    """S5's kernel against its plain version: bitwise for S5_BITWISE, else
    the same infinities and S5_TOL on the rest. Returns max |d| over the
    finite values."""
    import torch
    if torch.isnan(got).any():
        fail(f"{label}: NaN in the kernel's output")
    if mode in S5_BITWISE:
        if not torch.equal(got, ref):
            fail(f"{label}: not bitwise equal to the plain version: "
                 f"{int((got != ref).sum())} of {got.numel()} values differ, "
                 f"max |d| {float((got - ref).abs().nan_to_num().max()):.3g}")
        return 0.0
    if not torch.equal(torch.isinf(got), torch.isinf(ref)):
        fail(f"{label}: infinities differ from the plain version's")
    finite = torch.isfinite(ref)
    rtol, atol = S5_TOL[mode]
    g, r = got[finite].cpu().numpy(), ref[finite].cpu().numpy()
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=label)
    return float(np.abs(g - r).max()) if g.size else 0.0


def s5_checks(S5, ms, card, sfu_per_s, fail):
    """S5 on the card: every run at full size (the TPU probe's input, 300
    repetitions) and at 1-3 repetitions of uniform input against its plain
    version, the shares of special values, the time against 30
    repetitions, and each run's plain time and bound. Returns ({run: max
    |d|}, {run: plain ms}, {run: work})."""
    import torch
    err, plain_ms, work = {}, {}, {}
    elements = S5.NUM_PROGRAMS * 32768
    nbytes = 2 * 4 * elements
    for mode, shape in S5.RUNS:
        run = f"{mode} {shape[0]}x{shape[1]}"
        x = S5.probe_input(shape)
        got = S5.roll_micro(x, mode=mode)
        p_ms = time_ms(lambda: S5.roll_micro_torch(x, mode=mode), 1,
                       warmup=0)
        plain_ms[run] = p_ms
        err[run] = hold_s5(f"S5 {run}", mode, got,
                           S5.roll_micro_torch(x, mode=mode), fail)
        for reps in S5_SHORT_REPS:
            xr = S5.random_input(shape, seed=reps)
            d = hold_s5(f"S5 {run} at {reps} repetitions of uniform input",
                        mode, S5.roll_micro(xr, mode=mode, reps=reps),
                        S5.roll_micro_torch(xr, mode=mode, reps=reps), fail)
            err[run] = max(err[run], d)
        short = time_ms(lambda: S5.roll_micro(x, mode=mode,
                                              reps=S5_LOOP_REPS), 5)
        kernel = ms[(mode, shape)]
        if kernel / short < S5_LOOP_MIN_RATIO:
            fail(f"S5 {run}: 300 repetitions take {kernel:.4f} ms, "
                 f"{S5_LOOP_REPS} take {short:.4f} ms: the loop does not "
                 f"run its trips")
        reps_total = elements * S5.REPS
        t_ops = reps_total * S5_OPS[mode] / PEAK_FLOPS * 1e3
        ops = reps_total * S5_OPS[mode]
        if mode == "exp":
            t_ops = max(t_ops, reps_total / sfu_per_s * 1e3)
            ops += reps_total
        if mode in ("mxu", "mxu_t"):
            t_ops = max(t_ops, reps_total * S5_FP64_OPS
                        / PEAK_FP64_TENSOR_FLOPS * 1e3)
            ops += reps_total * S5_FP64_OPS
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        work[run] = {"bytes": nbytes, "ops": ops,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes"}
        shares = s5_shares(got)
        print(f"S5 {run}: kernel {kernel:.4f} ms "
              f"({kernel / S5.NUM_PROGRAMS / S5.REPS * 1e6:.2f} ns a program "
              f"and repetition), {S5_LOOP_REPS} repetitions {short:.4f} ms "
              f"(x{kernel / short:.2f}), plain {p_ms:.4f} ms, bound "
              f"{work[run]['bound_ms']:.4f} ms by {work[run]['bound_by']} "
              f"({ops} operations, {nbytes} bytes; "
              f"{work[run]['bound_ms'] / kernel:.1%} of bound), max |d| "
              f"{err[run]:.3g} (bitwise: {mode in S5_BITWISE}); output "
              f"shares zero {shares['zero']:.4f}, subnormal "
              f"{shares['subnormal']:.4f}, inf {shares['inf']:.4f} ({card})",
              flush=True)
    return err, plain_ms, work


def s6_checks(S6, result, card, fail):
    """S6 on the card: the verdict (every plane bitwise, every scan exact),
    the planes' plain time and torch.roll's, and the planes' bound. Returns
    (plain ms, torch.roll ms, work, max |kernel - plain| of the planes)."""
    import torch
    verdict = S6.check(result)
    for plane, (d_plain, d_numpy) in verdict["planes"].items():
        print(f"S6 {plane}: max |kernel - plain| {d_plain:.3g}, max |kernel "
              f"- numpy sequential| {d_numpy:.3g}", flush=True)
    for draw, wrong, edges in verdict["scans"]:
        print(f"S6 work_list_scan draw {draw}: {wrong} of "
              f"{S6.SCAN_THREADS} threads differ from the sequential sum; "
              f"threads {S6.EDGE_THREADS} exact: {edges}", flush=True)
    print("S6 " + ("PASS" if verdict["pass"] else "FAIL"), flush=True)
    if not verdict["pass"]:
        fail(f"S6: the card's shuffles or block_exclusive_sum disagree with "
             f"the plain versions: {verdict}")
    x = S6.probe_input()
    plain_ms = time_ms(lambda: S6.roll_semantics_torch(x), 20)
    library_ms = time_ms(lambda: torch.roll(x, 1, 0), 20)
    nbytes = 4 * 4 * S6.ROWS * S6.COLS    # x read, three planes written
    ops = 6 * S6.ROWS * S6.COLS           # 3 products and 3 sums a value
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS * 1e3
    work = {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    planes_ms, scan_ms = (result[m][0] for m in S6.MODES)
    max_err = max(d for d, _ in verdict["planes"].values())
    print(f"S6 planes: kernel {planes_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.roll {library_ms:.4f} ms, bound {work['bound_ms']:.2e} ms "
          f"by {work['bound_by']}; work_list_scan kernel {scan_ms:.4f} ms "
          f"({card})", flush=True)
    return plain_ms, library_ms, work, max_err


def probes_phase(card, fail):
    """Phase 12: the K1 probes. Builds the probe library, drives each
    probe's entry point (the timing function its `main` runs) in every
    mode with the launch counts reset just before and read just after, then
    holds every mode's kernel against its plain version on the card at the
    probe's full size, S4 `full` against K1 and its plain version, and S2
    against its plain version with the exponent rounded as the kernel's
    FP64 product rounds it, counting the decisions float32's product flips;
    then S5 and S6 (s5_checks, s6_checks). Returns the kernels line's six
    entries."""
    import torch
    from taichi_3d_gaussian_splatting_torch.ops import _build
    from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
    from taichi_3d_gaussian_splatting_torch.probes import _common as PC
    from taichi_3d_gaussian_splatting_torch.probes import (
        perf_exp2_probe as S1, perf_flip_proto as S2,
        perf_kernel_ablate as S3, perf_rgb_ablate2 as S4,
        perf_roll_micro as S5, roll_semantics_check as S6)

    t0 = time.perf_counter()
    _build.load_probe_library()
    print(f"probe build: {time.perf_counter() - t0:.2f} s (nvcc + load)",
          flush=True)
    t_phase = t0
    for line in _build.probe_build_log.splitlines():
        if "ptxas info" in line and ("registers" in line
                                     or "Compiling" in line):
            print(f"  {line.strip()}", flush=True)
    s1_sass_summary()
    s5_sass_summary(fail)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sfu_per_s = SFU_PER_CLOCK * H100_SMS * clock_mhz * 1e6

    # inputs (set-up, outside every timed call)
    s4_in = {"430k": S4.inputs("430k"), "1.03M heavy": S4.inputs("heavy")}
    s3_in = S3.layout()
    slab430, starts430, ends430, cam = s4_in["430k"]
    s2_in = {"s2": S2.inputs("s2"),
             "430k": (S2.from_wide16(slab430), starts430, ends430,
                      cam.num_tiles, cam.tiles_per_row)}
    coef, mono = S1.probe_inputs()
    tile_kw = dict(num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row)
    s3_kw = dict(num_tiles=S3.NUM_TILES, tiles_per_row=S3.TILES_PER_ROW)

    # each probe's entry point, every mode: the launches of this run only
    for module in (S4, S1, S3, S2, S5, S6):
        module.reset_launch_counts()
    ms = {f"S4 {k}": S4.time_modes(*v) for k, v in s4_in.items()}
    s1 = S1.time_variants(coef, mono)
    ms["S1"] = {v: s1[v][0] for v in S1.VARIANTS}
    ms["S3"] = S3.time_modes(*s3_in)
    ms.update({f"S2 {k}": S2.time_modes(*v) for k, v in s2_in.items()})
    s5 = S5.time_runs()
    s6 = S6.time_modes()
    torch.cuda.synchronize()
    launches = {name: dict(module.launch_counts) for name, module in
                (("S4", S4), ("S1", S1), ("S3", S3), ("S2", S2), ("S5", S5),
                 ("S6", S6))}
    print(f"probe launches during their entry points: {launches}",
          flush=True)
    for name, counts in launches.items():
        if min(counts.values()) < 1:
            fail(f"probe {name}: a mode never launched its kernel: {counts}")

    err = {name: 0.0 for name in launches}
    plain_ms = {}

    def hold(name, label, got, ref, rtol=PROBE_RTOL, atol=PROBE_ATOL):
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        if not np.isfinite(got).all():
            fail(f"{label}: non-finite kernel output")
        d = float(np.abs(got - ref).max())
        err[name] = max(err[name], d)
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                   err_msg=label)
        return d

    # S4: every mode against its plain version, at 430k and 1.03M
    for scene, (slab, starts, ends, cam_s) in s4_in.items():
        kw = dict(num_tiles=cam_s.num_tiles,
                  tiles_per_row=cam_s.tiles_per_row)
        for mode in S4.MODES:
            def plain():
                return S4.rgb_ablate2_torch(slab, starts, ends, mode=mode,
                                            **kw)
            p_ms = time_ms(plain, 1, warmup=0)
            plain_ms[f"S4 {scene} {mode}"] = p_ms
            d = hold("S4", f"S4 {scene} {mode}",
                     S4.rgb_ablate2(slab, starts, ends, mode=mode, **kw),
                     plain())
            print(f"S4 {scene} {mode}: kernel {ms[f'S4 {scene}'][mode]:.4f} "
                  f"ms, plain {p_ms:.4f} ms, max |d| {d:.3g} ({card})",
                  flush=True)
    # S4 full against K1 (wide16, rgb_only) and K1's plain version
    unpadded = slab430[:, :int(ends430.max())].contiguous()
    k1 = BC.blend_forward(unpadded, starts430, ends430, rgb_only=True,
                          **tile_kw)
    s4_full = S4.rgb_ablate2(slab430, starts430, ends430, mode="full",
                             **tile_kw)
    k1_plain = BC.blend_forward_torch(unpadded, starts430, ends430,
                                      rgb_only=True, **tile_kw)
    rows = ((0, BC.OUT_R), (1, BC.OUT_G), (2, BC.OUT_B),
            (3, BC.OUT_ACC_ALPHA), (4, BC.OUT_NORM))
    bitwise = all(torch.equal(s4_full[:, a], k1[:, b]) for a, b in rows)
    for a, b in rows:
        hold("S4", f"S4 full row {a} vs K1 row {b}", s4_full[:, a], k1[:, b])
        hold("S4", f"S4 full row {a} vs K1's plain row {b}", s4_full[:, a],
             k1_plain[:, b])
    k1_ms = {}
    for scene, (slab, starts, ends, cam_s) in s4_in.items():
        cut = slab[:, :int(ends.max())].contiguous()
        k1_ms[scene] = time_ms(lambda: BC.blend_forward(
            cut, starts, ends, num_tiles=cam_s.num_tiles,
            tiles_per_row=cam_s.tiles_per_row, rgb_only=True), 20)
    print(f"S4 full vs K1 (wide16) at 430k: bitwise equal {bitwise}; K1 "
          f"{k1_ms['430k']:.4f} ms, S4 full {ms['S4 430k']['full']:.4f} ms; "
          f"at 1.03M K1 {k1_ms['1.03M heavy']:.4f} ms, S4 full "
          f"{ms['S4 1.03M heavy']['full']:.4f} ms ({card})", flush=True)

    # S1: every variant against its plain version; the probe's figure
    for variant in S1.VARIANTS:
        def plain():
            return S1.exp2_probe_torch(coef, mono, variant=variant)
        p_ms = time_ms(plain, 1, warmup=0)
        plain_ms[f"S1 {variant}"] = p_ms
        d = hold("S1", f"S1 {variant}", s1[variant][1], plain(),
                 rtol=S1_RTOL, atol=0.0)
        print(f"S1 {variant}: kernel {ms['S1'][variant]:.4f} ms "
              f"({ms['S1'][variant] / S1.N_CHUNKS * 1e6:.2f} ns a chunk), "
              f"plain {p_ms:.4f} ms, max |d| {d:.3g} ({card})", flush=True)
    print("S1 max rel diff vs exp: " + ", ".join(
        f"{v} {S1.max_rel_diff(s1['exp'][1], s1[v][1]):.3g}"
        for v in ("exp2mul", "exp2pre")), flush=True)

    # S3: every mode against its plain version
    for mode in S3.MODES:
        def plain():
            return S3.kernel_ablate_torch(*s3_in, mode=mode, **s3_kw)
        p_ms = time_ms(plain, 1, warmup=0)
        plain_ms[f"S3 {mode}"] = p_ms
        d = hold("S3", f"S3 {mode}",
                 S3.kernel_ablate(*s3_in, mode=mode, **s3_kw), plain())
        print(f"S3 {mode}: kernel {ms['S3'][mode]:.4f} ms, plain "
              f"{p_ms:.4f} ms, max |d| {d:.3g} ({card})", flush=True)

    # S2: against its plain version with the kernel's exponent (float64
    # product rounded once); float32's (the TPU probe's) flips counted
    for layout, (slab, starts, ends, nt, tpr) in s2_in.items():
        kw = dict(num_tiles=nt, tiles_per_row=tpr)
        for mode in S2.MODES:
            def plain(dtype=torch.float64):
                return S2.flip_proto_torch(slab, starts, ends, mode=mode,
                                           exponent_dtype=dtype, **kw)
            got = S2.flip_proto(slab, starts, ends, mode=mode, **kw)
            p_ms = time_ms(lambda: plain(torch.float32), 1, warmup=0)
            plain_ms[f"S2 {layout} {mode}"] = p_ms
            d = hold("S2", f"S2 {layout} {mode}", got, plain())
            f32 = plain(torch.float32)
            d32 = (got - f32).abs()
            outside = int((d32 > PROBE_ATOL + PROBE_RTOL * f32.abs()).sum())
            print(f"S2 {layout} {mode}: kernel {ms[f'S2 {layout}'][mode]:.4f}"
                  f" ms, plain {p_ms:.4f} ms; max |d| {d:.3g} against the "
                  f"float64-exponent plain version; against float32's: max "
                  f"|d| {float(d32.max()):.3g}, {outside} of {d32.numel()} "
                  f"values outside rtol {PROBE_RTOL} / atol {PROBE_ATOL} "
                  f"({card})", flush=True)
        flips = S2.decision_flips(slab, starts, ends, **kw)
        print(f"S2 {layout}: decisions flipped by float32's exponent "
              f"product against the kernel's: {flips['skip']} of "
              f"{flips['pairs']} skip decisions, {flips['saturation']} of "
              f"{flips['pixels']} pixels' saturating key", flush=True)
    s2_430 = S2.flip_proto(*s2_in["430k"][:3], mode="full", **tile_kw)
    print(f"S2 full vs S4 full (K1) at 430k: max |d| r, g, b "
          f"{float((s2_430[:, 0:3] - s4_full[:, 0:3]).abs().max()):.3g}, "
          f"1 - T {float((s2_430[:, 4] - s4_full[:, 3]).abs().max()):.3g}",
          flush=True)

    # bounds of each `full` mode, beside the times
    s3_mapped = s3_in[0].clone()
    s3_mapped[BC.ROW_A] *= -2.0
    s3_mapped[BC.ROW_B] *= -1.0
    s3_mapped[BC.ROW_C] *= -2.0
    work = {"S4 430k": probe_work("S4", slab430, starts430, ends430,
                                  **tile_kw),
            "S4 1.03M heavy": probe_work(
                "S4", *s4_in["1.03M heavy"][:3],
                num_tiles=s4_in["1.03M heavy"][3].num_tiles,
                tiles_per_row=s4_in["1.03M heavy"][3].tiles_per_row),
            "S3": probe_work("S3", *s3_in, pairs_slab=s3_mapped, **s3_kw),
            "S2 s2": probe_work("S2", *s2_in["s2"][:3],
                                pairs_slab=s3_mapped, **s3_kw),
            "S2 430k": probe_work("S2", *s2_in["430k"][:3],
                                  pairs_slab=slab430, **tile_kw)}
    outputs = S1.N_CHUNKS * 128 * 256
    s1_bytes = 4 * (8 * 128 + 256 * 8 + 128 * 256)
    for variant in S1.VARIANTS:
        t_ops = outputs * S1_OPS[variant] / PEAK_FLOPS * 1e3
        t_bytes = s1_bytes / PEAK_BYTES_PER_S * 1e3
        work[f"S1 {variant}"] = {
            "bytes": s1_bytes, "ops": outputs * S1_OPS[variant],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pairs": outputs}
    sfu_ms = outputs / sfu_per_s * 1e3
    for key, wk in work.items():
        if key.startswith("S1"):
            label, kernel = key, ms["S1"][key.split()[1]]
        else:
            label, kernel = f"{key} full", ms[key]["full"]
        print(f"bound {label}: "
              f"{wk['bound_ms']:.4f} ms by {wk['bound_by']} ({wk['ops']} "
              f"operations, {wk['bytes']} bytes, {wk['pairs']} pairs); "
              f"kernel {kernel:.4f} ms, {wk['bound_ms'] / kernel:.1%} of "
              f"bound ({card})", flush=True)
    print(f"SFU: {outputs} transcendentals a call of S1 take at least "
          f"{sfu_ms:.4f} ms at {SFU_PER_CLOCK} a clock per SM, {H100_SMS} "
          f"SMs, {clock_mhz:.0f} MHz; S2 full's {work['S2 s2']['pairs']} "
          f"pairs at its layout {work['S2 s2']['pairs'] / sfu_per_s * 1e3:.4f}"
          f" ms", flush=True)

    # S5 and S6: every run against its plain version, times and bounds
    s5_err, s5_plain, s5_work = s5_checks(
        S5, {run: v[0] for run, v in s5.items()}, card, sfu_per_s, fail)
    s6_plain, s6_library, s6_work, s6_err = s6_checks(S6, s6, card, fail)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)
    # the kernels line: each probe's `full` (S1's exp) at its main shapes
    entries = []
    for name, module, key, full, plain_key in (
            ("S4", S4, "S4 430k", "full", "S4 430k full"),
            ("S1", S1, "S1 exp", "exp", "S1 exp"),
            ("S3", S3, "S3", "full", "S3 full"),
            ("S2", S2, "S2 s2", "full", "S2 s2 full")):
        kernel_ms = ms["S1"]["exp"] if name == "S1" else ms[key][full]
        entries.append({
            "name": f"probe_{module.__name__.rsplit('.', 1)[1]}",
            "route": "cuda", "source": module.SOURCE,
            "replaces": module.REPLACES,
            "launches": sum(launches[name].values()),
            "max_abs_err": err[name], "ms": kernel_ms,
            "plain_ms": plain_ms[plain_key],
            "bound_ms": work[key]["bound_ms"],
            "bound_by": work[key]["bound_by"], "library_ms": None})
    # S5's lane mode (no PyTorch call computes a 300-step chain: library_ms
    # null) and S6's planes (library_ms: torch.roll of the roll plane)
    lane = f"lane {S5.WIDE[0]}x{S5.WIDE[1]}"
    entries.append({
        "name": "probe_perf_roll_micro", "route": "cuda",
        "source": S5.SOURCE, "replaces": S5.REPLACES,
        "launches": launches["S5"]["lane"], "max_abs_err": s5_err[lane],
        "ms": s5[("lane", S5.WIDE)][0], "plain_ms": s5_plain[lane],
        "bound_ms": s5_work[lane]["bound_ms"],
        "bound_by": s5_work[lane]["bound_by"], "library_ms": None})
    entries.append({
        "name": "probe_roll_semantics_check", "route": "cuda",
        "source": S6.SOURCE, "replaces": S6.REPLACES,
        "launches": launches["S6"]["planes"], "max_abs_err": s6_err,
        "ms": s6["planes"][0], "plain_ms": s6_plain,
        "bound_ms": s6_work["bound_ms"], "bound_by": s6_work["bound_by"],
        "library_ms": s6_library})
    return entries


def python_on_path(root):
    """The environment for phase 13's shell commands, which call `python`
    as a user's shell does: where `python` on PATH is not this interpreter
    (or there is none), a `python` link to sys.executable in `root`/bin goes
    first on PATH, and the phase says so."""
    import shutil
    env = dict(os.environ)
    found = shutil.which("python")
    if found and os.path.realpath(found) == os.path.realpath(sys.executable):
        print(f"container: `python` on PATH is {found}", flush=True)
        return env
    bin_dir = os.path.join(root, "bin")
    os.makedirs(bin_dir)
    os.symlink(sys.executable, os.path.join(bin_dir, "python"))
    env["PATH"] = bin_dir + os.pathsep + env.get("PATH", "")
    print(f"container: `python` on PATH was {found}; linked "
          f"{bin_dir}/python -> {sys.executable} for the subprocesses",
          flush=True)
    return env


def notebook_commands(path):
    """The shell commands of the notebook's code cells after the first (the
    clone cell), in order: each `!` line with its `\\` continuations
    joined. Any other line in those cells is refused."""
    with open(path) as f:
        nb = json.load(f)
    code_cells = [c for c in nb["cells"] if c["cell_type"] == "code"]
    commands = []
    for cell in code_cells[1:]:
        source = "".join(cell["source"]).replace("\\\n", " ")
        for line in source.splitlines():
            line = line.strip()
            if not line:
                continue
            if not line.startswith("!"):
                raise ValueError(f"{path}: not a shell command: {line!r}")
            commands.append(" ".join(line[1:].split()))
    return commands


def command_name(command):
    """The script or module a `python` shell command runs, without its
    package or suffix (tools/prepare_colmap.py -> prepare_colmap)."""
    tokens = command.split()
    i = tokens.index("python") + 1
    target = tokens[i + 1] if tokens[i] == "-m" else tokens[i]
    return os.path.basename(target).removesuffix(".py").rsplit(".", 1)[-1]


def run_timed(label, argv, **kw):
    """`argv` in a subprocess, its output captured as text; prints its wall
    seconds and exit code beside `label` and returns (process, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, **kw)
    seconds = time.perf_counter() - t0
    print(f"  [{seconds:6.1f} s] exit {proc.returncode}: {label}", flush=True)
    return proc, seconds


def entrypoint_phase(root, images, sparse, env, card, fail):
    """Phase 13 (a): bash ENTRYPOINT from an empty working directory with
    PYTHONPATH at the repository and TRAIN_CONFIG a config of phase 9's
    capture (`images`, the COLMAP model `sparse`; GATE_ITERATIONS on the
    card, the gate at GATE_FLOOR_PSNR and GATE_FLOOR_SSIM): exit 0,
    "quality gate passed", and the summary markdown with its val/psnr and
    val/ssim rows. Without TRAIN_CONFIG: exit 1 and its message."""
    import yaml
    from torch_capture_fixtures import colmap_train_config
    work = os.path.join(root, "work")
    os.makedirs(work)
    dataset = os.path.join(root, "dataset")
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "prepare_colmap.py"),
                    "--base_path", sparse, "--image_path", images,
                    "--output_dir", dataset, "--val_every", "5"],
                   check=True, timeout=300, capture_output=True)
    config = os.path.join(root, "train.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(colmap_train_config(root, dataset, GATE_ITERATIONS), f)
    summary = os.path.join(root, "summary.md")
    env = dict(env, PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.pop("TRAIN_CONFIG", None)
    argv = ["bash", os.path.join(REPO, ENTRYPOINT)]
    proc, gate_s = run_timed(
        f"TRAIN_CONFIG=<phase 9's capture> bash {ENTRYPOINT}", argv,
        cwd=work, timeout=600,
        env=dict(env, TRAIN_CONFIG=config, OUTPUT_SUMMARY=summary,
                 TARGET_PSNR=str(GATE_FLOOR_PSNR),
                 TARGET_SSIM=str(GATE_FLOOR_SSIM)))
    if proc.returncode != 0 or "quality gate passed" not in proc.stdout:
        fail(f"the entrypoint exited {proc.returncode}:\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(summary) as f:
        markdown = f.read()
    rows = {line.split("|")[1].strip(): line for line in markdown.splitlines()
            if line.startswith("| val/")}
    if (not markdown.startswith("# Experiment results")
            or not {"val/psnr", "val/ssim"} <= set(rows)):
        fail(f"the entrypoint's summary lacks the gate's rows:\n{markdown}")
    linked = os.path.islink(os.path.join(work, "data"))
    if linked != os.path.isdir("/data"):
        fail(f"the entrypoint's data link: {linked}, /data a directory: "
             f"{os.path.isdir('/data')}")
    bare, bare_s = run_timed(f"bash {ENTRYPOINT} (no TRAIN_CONFIG)", argv,
                             cwd=work, env=env, timeout=60)
    if bare.returncode != 1 or "TRAIN_CONFIG is not set" not in bare.stderr:
        fail(f"the entrypoint without TRAIN_CONFIG exited "
             f"{bare.returncode}: {bare.stderr[-500:]}")
    print(f"container (a) entrypoint: exit 0 in {gate_s:.1f} s "
          f"({GATE_ITERATIONS} iterations, TARGET_PSNR {GATE_FLOOR_PSNR}, "
          f"TARGET_SSIM {GATE_FLOOR_SSIM}); summary {rows['val/psnr']} "
          f"{rows['val/ssim']}; data link {linked}; without TRAIN_CONFIG "
          f"exit 1 in {bare_s:.1f} s ({card})", flush=True)


def quickstart_phase(content, env, card, fail):
    """Phase 13 (b): every shell command of QUICKSTART's code cells but the
    clone cell, in order, from the repository root, with /content replaced
    by `content`, which holds phase 9's capture (colmap/sparse/0, images);
    the train.yaml the notebook writes is cut to QUICKSTART_CUTS. Checks
    the trained best_scene.parquet, the trajectory's PNG frames (decoded,
    none of one colour) and the bench's record and launch line."""
    import PIL.Image
    import yaml
    train_yaml = os.path.join(content, "train.yaml")
    bench = cut = None
    timings = []
    for command in notebook_commands(os.path.join(REPO, QUICKSTART)):
        command = command.replace("/content", content)
        proc, seconds = run_timed(command.replace(content, "<content>"),
                                  ["bash", "-c", command], cwd=REPO,
                                  env=env, timeout=600)
        if proc.returncode != 0:
            fail(f"quickstart command exited {proc.returncode}: {command}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        timings.append((command_name(command), seconds))
        if "taichi_3d_gaussian_splatting_torch.bench" in command:
            bench = proc
        if cut is None and os.path.exists(train_yaml):
            with open(train_yaml) as f:
                config = yaml.safe_load(f)
            cut = {k: (config[k], v) for k, v in QUICKSTART_CUTS.items()}
            config.update(QUICKSTART_CUTS)
            with open(train_yaml, "w") as f:
                yaml.safe_dump(config, f)
            print("  train.yaml cut: " + ", ".join(
                f"{k} {old} -> {new}" for k, (old, new) in cut.items()),
                flush=True)
    data = os.path.join(content, "data")
    scene = os.path.join(data, "best_scene.parquet")
    if not os.path.isfile(scene):
        fail(f"the quickstart's training wrote no {scene}")
    frames = sorted(f for f in os.listdir(os.path.join(content, "frames"))
                    if f.endswith(".png"))
    poses = np.load(os.path.join(content, "ellipse_poses.npy"))
    if len(frames) != len(poses):
        fail(f"the quickstart rendered {len(frames)} frames of "
             f"{len(poses)} poses")
    colours = []
    for name in frames:
        frame = np.asarray(PIL.Image.open(os.path.join(content, "frames",
                                                       name)), np.int64)
        colours.append(len(np.unique((frame[..., 0] << 16)
                                     | (frame[..., 1] << 8)
                                     | frame[..., 2])))
    if min(colours) < 2:
        fail(f"a quickstart frame is of one colour: {colours}")
    if bench is None:
        fail("the quickstart ran no bench")
    record, launches = check_bench_output("quickstart", bench, True, fail)
    print(f"container (b) quickstart: {len(timings)} commands, wall s "
          + ", ".join(f"{name} {s:.1f}" for name, s in timings)
          + f"; {os.path.getsize(scene)} B best_scene.parquet; "
          f"{len(frames)} frames of {frame.shape[1]}x{frame.shape[0]}, "
          f"{min(colours)}-{max(colours)} colours a frame; bench "
          f"{json.dumps(record)}; launches {launches} ({card})", flush=True)


def container_phase(root, card, fail):
    """Phase 13: phase 9's capture rendered on the card where the
    quickstart expects it, then entrypoint_phase and quickstart_phase, with
    `python` on PATH (python_on_path); prints the phase's wall seconds."""
    from torch_capture_fixtures import write_colmap_capture
    t0 = time.perf_counter()
    env = python_on_path(root)
    content = os.path.join(root, "content")
    images, sparse = write_colmap_capture(content, "cuda")
    model = os.path.join(content, "colmap", "sparse", "0")
    os.makedirs(os.path.dirname(model))
    os.rename(sparse, model)
    entrypoint_phase(os.path.join(root, "entrypoint"), images, model, env,
                     card, fail)
    quickstart_phase(content, env, card, fail)
    print(f"container phase: {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)


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
    from torch_chunk_fixtures import (BOUNDARY_OFFSET, CFG_MAIN,
                                      binned_inputs, long_segment_slab,
                                      pair_counts, seeded_pixel_in, work)
    from taichi_3d_gaussian_splatting_torch.camera import CameraInfo
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    from taichi_3d_gaussian_splatting_torch.ops import _build
    from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
    from taichi_3d_gaussian_splatting_torch.ops.projection_cuda import (
        project_points)
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        RasterizerConfig, _result_from_tile_out, rasterize)
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
            if rgb_only:
                k_ms = time_ms(lambda: BC.blend_forward(*args, **kw), 20)
            else:   # as training calls K2: with its int32 `last`
                k_ms = time_ms(lambda: BC.blend_forward_with_last(
                    *args, num_tiles=cam.num_tiles,
                    tiles_per_row=cam.tiles_per_row), 20)
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
        """((wide16 slab, ranges, pixel_in), dict(tile kwargs, last)): a
        seeded normal image cotangent beside the forward kernel's colour,
        and its int32 `last`, as the rasterizer hands them over in
        training."""
        kw = dict(num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row)
        fwd, last = BC.blend_forward_with_last(
            slab, binning.tile_starts, binning.tile_ends, **kw)
        pixel_in = seeded_pixel_in(fwd, cam, seed)
        return ((slab, binning.tile_starts, binning.tile_ends, pixel_in),
                dict(kw, last=last))

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
    boundary_phase(long_cam, long_slabs["wide16"], long_binning,
                   BOUNDARY_OFFSET, fail)
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
                  cam.tiles_per_row, last=kw["last"])
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

    # ---- 3c. projection kernels vs plain versions on the card ----------
    p_ms, p_plain, p_bounds, p_err = projection_phase(
        scenes, cam, cfg_main["near_plane"], cfg_main["far_plane"], card,
        fail)

    # ---- 3d. the optimizer kernel vs its plain version on the card -----
    opt_ms, opt_plain, opt_bound = optimizer_phase(card, fail)

    # ---- 3f. the accumulation kernel vs its plain version on the card --
    acc = accumulate_phase(card, fail)

    # ---- 3e. the image loss kernel vs its plain version on the card ----
    loss_ms, loss_plain, loss_bound, loss_by, loss_err = image_loss_phase(
        card, fail)

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
                attrs, cols = project_points(
                    *scene, q_cam, t_cam, t, cam, cfg_rgb.near_plane,
                    cfg_rgb.far_plane)
                depth = attrs.depth
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

    phase4_ms = {}

    def run_scene(label, pc, feats, count_launches):
        torch.cuda.reset_peak_memory_stats()
        scene = scene_on(pc, feats, cuda)
        if count_launches:
            reset_launch_counts()
        for _ in range(WARMUP_FRAMES):
            render(scene, cfg_rgb)
        frame_ms = time_ms(lambda: render(scene, cfg_rgb), TIMED_FRAMES,
                           warmup=0)
        phase4_ms[label] = frame_ms
        res = render(scene, cfg_rgb)
        full = render(scene, cfg_full)      # depth + count of the same view
        torch.cuda.synchronize()
        launches = launch_counts.copy()
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
        # the slab has one column per key
        columns = int(binning.total_keys)
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"  peak device memory {peak_mib:.1f} MiB; {columns} slab "
              f"columns", flush=True)
        return launches

    launches = run_scene("430k synthetic", *scenes["430k synthetic"], True)
    print(f"kernel launches during the 430k main path: {launches}",
          flush=True)
    if min(launches["blend_forward_rgb"], launches["blend_forward"]) < 1:
        fail(f"a kernel of the path was never launched: {launches}")
    check_projection_launches(launches, "the 430k main path", fail)
    run_scene("1.03M heavy-tailed", *scenes["1.03M heavy-tailed"], False)
    run_scene("2.08M heavy-tailed", *make_heavy_tailed_checkpoint(
        2080000, np.random.default_rng(0)), False)

    # ---- 5. training path -----------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_training_set(tmp, *scenes["430k synthetic"], cam)
        train_launches = train_phase(paths, tmp, card, fail)
        small = os.path.join(tmp, "small")
        os.makedirs(small)
        step_cuda_vs_cpu(small, fail)
        # ---- 6. batch training, 6b. the batch step card vs cpu ---------
        batch_launches = batch_train_phase(paths, tmp, card, fail)
        small_batch = os.path.join(tmp, "small_batch")
        os.makedirs(small_batch)
        batch_step_cuda_vs_cpu(small_batch, fail)
        # ---- 7. the viewer ---------------------------------------------
        viewer_phase(tmp, *scenes["430k synthetic"], card, fail)
        # ---- 8. the trace on the card ------------------------------------
        trace_train_phase(paths, tmp, card, fail)
        trace_render_phase(tmp, render, scene_on(*scenes["430k synthetic"],
                                                 cuda), cfg_rgb,
                           kernel_ms["blend_forward_rgb"], card, fail)
        del scenes
        # ---- 9. the data-preparation chain and the experiment gate -------
        data_chain_phase(os.path.join(tmp, "chain"), card, fail)
    # ---- 10. the bench on the card ------------------------------------
    torch.cuda.empty_cache()   # the subprocesses need the card's memory
    bench_phase(phase4_ms, fail)
    # ---- 11. training to quality on the card ---------------------------
    with tempfile.TemporaryDirectory() as tmp:
        quality_recipe_phase(os.path.join(tmp, "recipe"), card, fail)
        held_out = os.path.join(tmp, "held_out")
        logs = held_out_phase(held_out, card, fail)
        trained_scene_phase(held_out, logs, card, fail)
    # ---- 12. the K1 probes ----------------------------------------------
    probe_entries = probes_phase(card, fail)
    # ---- 13. the container entrypoint and the quickstart notebook -------
    torch.cuda.empty_cache()   # the subprocesses need the card's memory
    with tempfile.TemporaryDirectory() as tmp:
        container_phase(tmp, card, fail)
    launches["blend_backward"] = train_launches["blend_backward"]
    launches["project_backward"] = train_launches["project_backward"]

    # no PyTorch call computes the blend or the projection: library_ms is
    # null
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
    kernels += [{"name": name, "route": "cuda",
                 "source": PROJECTION_SOURCES[name],
                 "replaces": PROJECTION_REPLACES[name],
                 "launches": launches[name], "max_abs_err": p_err[name],
                 "ms": p_ms[name], "plain_ms": p_plain[name],
                 "bound_ms": p_bounds[name][0], "bound_by": p_bounds[name][1],
                 "library_ms": None}
                for name in ("project_forward", "project_backward")]
    kernels.append({"name": "optimizer_update", "route": "cuda",
                    "source": OPTIMIZER_SOURCE, "replaces": None,
                    "launches": train_launches["optimizer_update"],
                    "max_abs_err": 0.0, "ms": opt_ms, "plain_ms": opt_plain,
                    "bound_ms": opt_bound, "bound_by": "bytes",
                    "library_ms": None})
    kernels.append({"name": "accumulate_view", "route": "cuda",
                    "source": ACCUMULATE_SOURCE, "replaces": None,
                    "launches": batch_launches["accumulate_view"],
                    "max_abs_err": 0.0, "ms": acc["later"][0],
                    "plain_ms": acc["later"][1],
                    "bound_ms": acc["later"][2], "bound_by": "bytes",
                    "library_ms": None})
    kernels.append({"name": "image_loss", "route": "cuda",
                    "source": IMAGE_LOSS_SOURCE, "replaces": None,
                    "launches": train_launches["image_loss"],
                    "max_abs_err": loss_err, "ms": loss_ms,
                    "plain_ms": loss_plain, "bound_ms": loss_bound,
                    "bound_by": loss_by, "library_ms": None})
    kernels += probe_entries
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
