"""Traffic kind `densify`: a closed loop of training iterations through the
port's `GaussianPointCloudTrainer.train_iteration`, the trainer's own
schedule, one view each from the trainer's device cache as `train()` takes
them: the step, and where the schedule puts them a densify round and an
alpha reset.

The inputs are the `train` kind's (`drivers/train.py`: the true scene from
the seed, `views` ground-truth views rendered by the plain reference, the
perturbed scene as the point cloud, the trainer's dataset format), drawn
as a round leaves a scene: the true scene by `scenes/after_round.py` over
the configuration's recipe, and the perturbed one folded the same way, so
that no valid point starts below the transparent threshold. Then a
checkpoint in `save`'s format at iteration `resume_at`: the loaded scene
in `slots_ratio` times as many slots, Adam's count `resume_at` with its
moments zero, the controller's accumulators zero, the generators as
seeded. That is the benchmark's work, not the program's, and `setup_s`
leaves it out.

Set-up resumes a trainer from the checkpoint (`resume_from_checkpoint`,
the normal path, with the configuration's `controller` block) and runs
one whole segment, iterations `resume_at` + 1 to `segment_last`: every
shape a round and a reset use is warmed up there, and the checked
stretch is kept. The window runs segment after segment for `--seconds`;
between segments the whole state is put back as it was after the resume
(the trainer's `state_arrays`, copied on the device, through its
`load_state`), and the device drained, off the clock, so that every
segment does the same work. `step_ms` is the window's time over the iterations finished
in it.

The checked stretch: the program's state after iteration
`checked_round` - `checked_steps`, and then what iterations up to
`checked_round` (a round, and the alpha reset there) did. The plain
reference follows those steps from that state (`reference/train.py`, the
four gaps of `reference/compare.py`, the statistics as the round consumed
them), and works the round and the reset out again from the program's own
inputs to them (the scene after the step, the accumulators, the trigger
step's statistics, the positions before its optimizer update, the
generator's state), so that the round's numbers measure the round and not
the steps' rounding, which moves points across its thresholds
(`reference/densify.py` readings).

With `--trace 1`, after the window, each from the restored state:
iterations up to `events_last` with CUDA events at the trainer's marks
(the step's stages, and a round's and a reset's, `densify_ms`), then
iterations `trace_first` to `trace_last` under torch.profiler with the
port's stage spans on (the step's kernels, and the device-idle time begun
inside the `densify` span); the stretch ends with the round, so its steps
run on the scene whose work is counted. The rounds and resets in a
stretch are the schedule's (`reference/densify.py` due); the slots the
rounds filled and split, the program's own counters
(`training/controller.py` round_counts).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import tempfile
import time
from typing import NamedTuple

import torch

from portbench.harness import clock, spec, trace
from portbench.harness.main import RunResult, note
from portbench.reference import compare
from portbench.reference import densify as RD
from portbench.reference import projection as RP
from portbench.reference import train as RT

TRAIN = spec.driver("train")
ADAM_B1 = 0.9
# the stages of a round and a reset, as the trainer's marks name them
ROUND_STAGES = ("densify/masks", "densify/assign", "densify/fill",
                "densify/log", "densify", "reset alpha")


class Inputs(NamedTuple):
    """The `train` kind's inputs, and `handover`: what the program's
    checked stretch leaves for the reference (filled by `program_side`)."""
    pc: object
    feats: object
    gt: torch.Tensor
    pose_matrices: object
    cam: RP.Camera
    handover: dict


def after_round(cell):
    """The cell with its scene drawn as a round leaves it
    (`scenes/after_round.py` over the configuration's recipe)."""
    cfg = cell.config
    scene = {**cfg["scene"], "recipe": "after_round",
             "base": cfg["scene"]["recipe"],
             "transparent_alpha_threshold":
                 cfg["controller"]["transparent_alpha_threshold"]}
    return cell._replace(config={**cfg, "scene": scene})


def make_inputs(cell, seed: int, device) -> Inputs:
    x = TRAIN.make_inputs(after_round(cell), seed, device)
    feats = spec.recipe("after_round").fold_alpha(
        torch.from_numpy(x.feats),
        cell.config["controller"]["transparent_alpha_threshold"])
    return Inputs(*x._replace(feats=feats.numpy()), {})


def write_dataset(x: Inputs, root: str) -> dict:
    """The dataset (`drivers/train.py`), and where the checkpoint goes;
    the handover rides along for `open_trainer`."""
    paths = TRAIN.write_dataset(x, root)
    paths["checkpoint"] = os.path.join(root, "resume.npz")
    paths["handover"] = x.handover
    return paths


def write_checkpoint(cell, seed: int, paths: dict, root: str, device):
    """The checkpoint the run resumes from, written by the trainer's `save`
    from a trainer built on the dataset; keeps its configuration."""
    trainer = TRAIN.make_trainer(cell, seed, paths, root, device)
    at = int(cell.traffic["resume_at"])
    for name in ("opt_features", "opt_positions"):
        st = getattr(trainer, name)
        setattr(trainer, name, st._replace(count=torch.full_like(
            st.count, at)))
    trainer.save(paths["checkpoint"], at + 1)
    trainer.logger.close()
    paths["config"] = trainer.config


class Loop:
    """The window's call: the next iteration of the schedule through
    `train_iteration`, on the next view of the device cache as `train()`
    takes it. `restore()` puts back the state the loop started from (the
    trainer's own `state_arrays` and `load_state`) and drains the
    device."""

    def __init__(self, trainer, cache, traffic, handover: dict):
        self.trainer, self.cache, self.handover = trainer, cache, handover
        self.first = trainer.start_iteration
        self.last = int(traffic["segment_last"])
        self.next = self.first
        self._start = {k: v.clone()
                       for k, v in trainer.state_arrays().items()}

    def restore(self):
        self.trainer.load_state(self._start)
        self.next = self.first
        _sync(self.trainer.device)

    @property
    def segment_done(self) -> bool:
        return self.next > self.last

    def __call__(self, mark=None):
        t = self.trainer
        images, qs, ts, intrs, cam = t._next_views(self.cache, None, 1, 1)
        kwargs = {} if mark is None else {"mark": mark}
        out = t.train_iteration(self.next, images, qs, ts, intrs, cam,
                                **kwargs)
        self.next += 1
        return out


def open_trainer(cell, seed: int, paths: dict, root: str, device):
    """Resume the trainer from the checkpoint (the memory peak counted from
    here) and build its device cache; returns (trainer, cache, loop)."""
    from taichi_3d_gaussian_splatting_torch.training.controller import (
        AdaptiveControllerConfig)
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer)
    if "config" not in paths:
        write_checkpoint(cell, seed, paths, root, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    config = dataclasses.replace(
        paths["config"], resume_from_checkpoint=paths["checkpoint"],
        adaptive_controller_config=AdaptiveControllerConfig(
            **cell.config["controller"]))
    trainer = GaussianPointCloudTrainer(config, device=device)
    cache = trainer._device_cache(trainer.train_dataset, 1)
    return trainer, cache, Loop(trainer, cache, cell.traffic,
                                paths["handover"])


def _cpu(group):
    return type(group)(*(v.detach().to("cpu", copy=True) for v in group))


def counts_of(out) -> dict:
    """The six counts of the round `train_iteration` ran (its output's
    `densify_counts`), each -1 where it ran none."""
    c = out.densify_counts
    return {k: -1 if c is None else int(getattr(c, k)) for k in RD.COUNTS}


def program_side(cell, trainer, loop: Loop) -> compare.TrainSide:
    """Run the set-up segment and keep the checked stretch: for the steps,
    each loss, the first step's gradients (from Adam's first moments
    before and after it), the scene before the steps and after the last
    (before its round), the accumulators as the round consumed them; for
    the round, its inputs, the scene after it and the reset, and its
    counts (in `loop.handover`, with the counts of every round of the
    segment under `rounds`). The loop is restored at the end."""
    tr = cell.traffic
    at = int(tr["checked_round"])
    first = at - int(tr["checked_steps"]) + 1
    h = loop.handover
    h["rounds"] = {}

    def run(mark=None):
        it = loop.next
        out = loop(mark)
        if out.densify_counts is not None:
            h["rounds"][it] = counts_of(out)
        return out

    while loop.next < first:
        run()
    t = trainer
    h["start"] = tuple(_cpu(g) for g in (t.scene, t.opt_features,
                                         t.opt_positions, t.ctrl_state))
    mu_before = (t.opt_positions.mu.clone(), t.opt_features.mu.clone())
    losses, grads = [], None
    seen = {}

    def at_step_end(stage):
        if stage == "adam" and not seen:
            seen["scene"], seen["ctrl"] = _cpu(t.scene), _cpu(t.ctrl_state)

    while loop.next <= at:
        if loop.next == at:
            before = t.scene.point_cloud.to("cpu", copy=True)
            generator = t.generator.get_state()
            out = run(at_step_end)
        else:
            out = run()
        losses.append(float(out.metrics["loss"]))
        if grads is None:
            grads = tuple(((a.mu - ADAM_B1 * m) / (1.0 - ADAM_B1)).cpu()
                          for a, m in zip((t.opt_positions, t.opt_features),
                                          mu_before))
    stats, in_frustum, depth, _ = out.densify_inputs
    h["round"] = {
        "pool": seen["scene"], "acc": tuple(seen["ctrl"]),
        "trigger": RD.Trigger(*(v.to("cpu", copy=True) for v in (
            stats.num_affected_pixels, stats.magnitude_grad_viewspace,
            in_frustum, depth)), before),
        "generator": generator, "after": _cpu(t.scene),
        "counts": counts_of(out)}
    while not loop.segment_done:
        run()
    loop.restore()
    start = h["start"][0]
    return compare.TrainSide(
        losses, *grads, start.point_cloud, start.point_cloud_features,
        seen["scene"].point_cloud, seen["scene"].point_cloud_features,
        tuple(seen["ctrl"]))


def views_in_order(seed: int, num_views: int, first: int, iterations):
    """The dataset index of each iteration's view: from the resume at
    `first`, a new permutation of the views every `num_views` iterations,
    drawn by the trainer's data generator (seeded with the seed)."""
    gen = torch.Generator().manual_seed(seed)
    perms = []
    out = []
    for it in iterations:
        k = it - first
        while len(perms) <= k // num_views:
            perms.append(torch.randperm(num_views, generator=gen))
        out.append(int(perms[k // num_views][k % num_views]))
    return out


def reference_side(cell, x: Inputs, seed: int, device, dtype=torch.float32,
                   loss_rows=None) -> compare.TrainSide:
    """The plain reference's readings of the checked steps, from the
    program's state before them (`program_side`)."""
    tr = cell.traffic
    hp = TRAIN.hyper(cell)
    at = int(tr["checked_round"])
    its = range(at - int(tr["checked_steps"]) + 1, at + 1)
    scene, adam_f, adam_p, ctrl = (type(g)(*(v.to(device) for v in g))
                                   for g in x.handover["start"])
    state = RT.State(scene.point_cloud, scene.point_cloud_features,
                     scene.point_invalid_mask, RT.Adam(*adam_f),
                     RT.Adam(*adam_p), RT.Stats(*ctrl))
    start = (state.pc, state.feats)
    views = views_in_order(seed, x.gt.shape[0],
                           int(tr["resume_at"]) + 1, its)
    mats = torch.tensor(x.pose_matrices)
    q_all = RP.rotation_matrix_to_quaternion(mats[:, :3, :3])
    losses, first = [], None
    prev = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for v in views:
            gt = x.gt[v].to(device).to(torch.float32) / 255.0
            out = RT.step(state, gt, q_all[v:v + 1].to(device),
                          mats[v:v + 1, :3, 3].to(device), x.cam, hp, dtype,
                          loss_rows)
            losses.append(out.loss)
            if first is None:
                first = (out.grad_pc, out.grad_feats)
            state = out.state
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev
    return compare.TrainSide(losses, *first, *start, state.pc, state.feats,
                             tuple(state.stats))


def reference_round(cell, x: Inputs, device, dtype=torch.float32):
    """(the reference's round, the pool after it and the reset) at
    `checked_round`, from the program's inputs to its round."""
    c = RD.controller(cell.config["controller"])
    at = int(cell.traffic["checked_round"])
    rounds, resets = RD.due(at, c)
    if not rounds:
        raise ValueError(f"the schedule has no round at {at}")
    h = x.handover["round"]
    p = h["pool"]
    pool = RD.Pool(*(v.to(device) for v in (
        p.point_cloud, p.point_cloud_features, p.point_invalid_mask,
        p.point_object_id)))
    gen = torch.Generator(device)
    gen.set_state(h["generator"])
    ref = RD.densify_round(
        pool, tuple(v.to(device) for v in h["acc"]),
        RD.Trigger(*(v.to(device) for v in h["trigger"])), at, gen, c,
        dtype)
    return ref, RD.reset_alpha(ref.pool, c) if resets else ref.pool


def _pool(scene, device):
    return RD.Pool(*(v.to(device) for v in (
        scene.point_cloud, scene.point_cloud_features,
        scene.point_invalid_mask, scene.point_object_id)))


def round_checks(cell, x: Inputs, device) -> dict:
    """The round's numbers: the program's round against the reference's."""
    ref, ref_pool = reference_round(cell, x, device)
    h = x.handover["round"]
    return RD.readings(h["counts"], _pool(h["after"], device), ref,
                       ref_pool)


def control_round_checks(cell, x: Inputs, device,
                         dtype=torch.bfloat16) -> dict:
    """The round's numbers with the reference computed in `dtype` in the
    program's place."""
    ref, ref_pool = reference_round(cell, x, device)
    ctl, ctl_pool = reference_round(cell, x, device, dtype)
    return RD.readings(ctl.counts, ctl_pool, ref, ref_pool)


def faulty_round_checks(cell, x: Inputs, device, factor=10.0) -> dict:
    """The round's numbers with the program's own round run on its
    inputs with the single-frame gradient threshold times `factor` (a
    planted fault), and the reset after it."""
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        BackwardStats)
    from taichi_3d_gaussian_splatting_torch.training import controller as C
    block = dict(cell.config["controller"])
    key = "densification_view_space_position_gradients_threshold"
    block[key] *= factor
    cfg = C.AdaptiveControllerConfig(**block)
    h = x.handover["round"]
    trig = RD.Trigger(*(v.to(device) for v in h["trigger"]))
    n = trig.num_pixels.shape[0]
    stats = BackwardStats(torch.zeros((n, 2), device=device), trig.magnitude,
                          trig.num_pixels, torch.zeros((1, 1, 2),
                                                       device=device))
    gen = torch.Generator(device)
    gen.set_state(h["generator"])
    at = int(cell.traffic["checked_round"])
    scene = GaussianPointCloudScene(*(v.to(device) for v in h["pool"]))
    new, _, counts = C.densify_step(
        scene, C.ControllerState(*(v.to(device) for v in h["acc"])), stats,
        trig.in_frustum, trig.depth, trig.pc_before, at, gen, cfg)
    if RD.due(at, RD.controller(block))[1]:
        new = C.reset_alpha(new, cfg)
    ref, ref_pool = reference_round(cell, x, device)
    return RD.readings({k: int(getattr(counts, k)) for k in RD.COUNTS},
                       _pool(new, device), ref, ref_pool)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(cell, args, t0: float) -> RunResult:
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer)
    if not hasattr(GaussianPointCloudTrainer, "train_iteration"):
        raise RuntimeError("the program's trainer has no train_iteration: "
                           "it cannot run its schedule for a caller")
    from taichi_3d_gaussian_splatting_torch.ops import _build
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if device.type == "cuda":
        _build.load_library()
        torch.zeros(1, device=device)   # the CUDA context, in set-up
    inputs_start = time.time()
    x = make_inputs(cell, args.seed, device)
    root = tempfile.mkdtemp(prefix="portbench-")
    try:
        paths = write_dataset(x, root)
        write_checkpoint(cell, args.seed, paths, root, device)
        gc.collect()
        inputs_s = time.time() - inputs_start
        note(t0, f"inputs drawn, rendered and written, checkpoint saved in "
                 f"{inputs_s:.2f} s (not set-up)")
        trainer, cache, loop = open_trainer(cell, args.seed, paths, root,
                                            device)
        note(t0, f"trainer resumed at iteration {trainer.start_iteration}")
        prog = program_side(cell, trainer, loop)
        setup_s = time.time() - t0 - inputs_s
        note(t0, f"set-up segment done; setup_s {setup_s:.2f}; "
                 f"{trainer.scene.capacity} slots; its rounds "
                 f"{json.dumps(x.handover['rounds'])}")

        steps, window_s, segments = 0, 0.0, 0
        while window_s < args.seconds:
            start = time.perf_counter()
            while (not loop.segment_done and window_s
                   + time.perf_counter() - start < args.seconds):
                loop()
                steps += 1
            _sync(device)
            window_s += time.perf_counter() - start
            if loop.segment_done:
                loop.restore()
                segments += 1
        note(t0, f"window: {steps} iterations in {window_s:.3f} s, "
                 f"{segments} whole segments")
        e2e = {"setup_s": setup_s, "step_ms": window_s / steps * 1e3}

        readings, summary = {}, None
        if args.trace and device.type == "cuda":
            readings, summary = _per_layer(cell, args.seed, trainer, loop)
            note(t0, f"per-layer stretches: {readings['unit_ms']:.4f} ms an "
                     f"iteration, {readings['densify']['ms']:.4f} ms a "
                     f"round by CUDA events")
        peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                else 0)
        trainer.logger.close()
        del trainer, cache, loop
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = compare.train_readings(
            prog, reference_side(cell, x, args.seed, device))
        checks.update(round_checks(cell, x, device))
        note(t0, "reference steps and round compared")
        if "work_state" in readings:
            readings["work"] = TRAIN._work(cell, readings.pop("work_state"),
                                           x, device)
            note(t0, "work counted")
        return RunResult(steps, 0, e2e, readings, checks, peak, summary)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _per_layer(cell, seed, trainer, loop: Loop):
    """From the restored state: iterations up to `events_last` timed by
    CUDA events at the trainer's marks; then iterations `trace_first` to
    `trace_last` under torch.profiler with the stage spans on; the scene
    the traced stretch starts from and its views, for their work."""
    from taichi_3d_gaussian_splatting_torch.training import controller
    from taichi_3d_gaussian_splatting_torch.utils import profiling
    tr = cell.traffic
    c = RD.controller(cell.config["controller"])

    def due(iterations):
        """(rounds, resets) the schedule puts in `iterations`."""
        return tuple(sum(d) for d in zip(*(RD.due(i, c)
                                           for i in iterations)))

    loop.restore()
    last = int(tr["events_last"])
    units = last - loop.first + 1
    rounds, resets = due(range(loop.first, last + 1))
    before = {k: int(v) for k, v in controller.round_counts.items()}
    unit_ms, stages = clock.timed_units(lambda i, mark: loop(mark), units,
                                        mark_stages=True)
    done = {k: int(v) - before[k]
            for k, v in controller.round_counts.items()}
    densify = {"ms": sum(stages.get(k, 0.0) for k in ROUND_STAGES)
               * units / max(rounds, 1),
               "slots": trainer.scene.capacity,
               "filled": done["points_added"] / max(rounds, 1),
               "splits": done["splits"] / max(rounds, 1),
               "resets": resets / max(rounds, 1)}

    loop.restore()
    first, last = int(tr["trace_first"]), int(tr["trace_last"])
    while loop.next < first:
        loop()
    _sync(trainer.device)
    scene = trainer.scene
    work_state = (scene.point_cloud.clone(),
                  scene.point_cloud_features.clone(),
                  scene.point_invalid_mask.clone(),
                  views_in_order(seed, len(trainer.train_dataset),
                                 loop.first, range(first, last + 1)))
    units = last - first + 1
    rounds = due(range(first, last + 1))[0]
    with profiling.tracing():
        events = trace.run_traced(lambda i: loop(), units)
    spans = profiling.summarize_trace(events, prefix=trace.RANGE)[
        "stages"]["spans"]
    densify["idle_ms"] = sum(
        row["idle_ms_per_range"] for name, row in spans.items()
        if name == "densify" or name.startswith("densify/")
    ) * units / max(rounds, 1)
    summary = trace.summarize(events, units)
    loop.restore()
    return {"unit_ms": unit_ms, "stages_ms": stages, "trace": summary,
            "densify": densify, "work_state": work_state}, summary
