"""Frame and training-step times of the port on one card, with their
stages and a trace of each: the 430k frame (`rasterize(rgb_only=True)`,
976x544, 50 frames after 10, and its "projection" stage) and the
trainer's step (430k scene in 860,000 slots, 10 steps after 5, stages by
CUDA events), each traced over 10 frames / 5 steps (launches, kernel ms
and busy share per frame or step, top host ops by their kernels' time).
Each measurement runs in its own process, which imports the package of
the tree it measures.

    python3 stage_times.py                   # this tree
    python3 stage_times.py --parent DIR      # DIR and this tree in turns:
                                             # parent, this, this, parent

DIR is another checkout of the repository (for example `git archive` of
the parent commit unpacked into the git-ignored `.probe/parent`); each
tree builds its own kernels. One JSON line per measurement, prefixed
"AB ".
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def measure(root, label):
    import numpy as np
    import torch
    for sub in ("", "tests", "benchmark"):
        sys.path.insert(0, os.path.join(root, sub))
    import chip_smoke as cs
    from taichi_3d_gaussian_splatting_torch.camera import CameraInfo
    from taichi_3d_gaussian_splatting_torch.models.scene import (
        GaussianPointCloudScene)
    from taichi_3d_gaussian_splatting_torch.ops import _build
    from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
        RasterizerConfig, _no_mark, _project_and_bin, rasterize)
    from taichi_3d_gaussian_splatting_torch.utils.profiling import (
        load_events, summarize_trace)
    import taichi_3d_gaussian_splatting_torch as pkg
    assert os.path.dirname(os.path.dirname(pkg.__file__)) == root
    t0 = time.perf_counter()
    _build.load_library()
    out = {"label": label, "build_s": time.perf_counter() - t0}
    intr = np.array([[cs.FOCAL, 0, cs.W / 2], [0, cs.FOCAL, cs.H / 2],
                     [0, 0, 1]], np.float32)
    cam = CameraInfo(camera_intrinsics=intr, camera_height=cs.H,
                     camera_width=cs.W)
    pc, feats = cs.bench_scene(430000)
    n = pc.shape[0]
    scene = GaussianPointCloudScene.from_numpy(pc, feats, np.zeros(n),
                                               np.zeros(n), "cuda")
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device="cuda")
    t = torch.zeros((1, 3), device="cuda")
    cfg = RasterizerConfig(near_plane=0.4, far_plane=1000.0, rgb_only=True)

    def frame():
        with torch.no_grad():
            return rasterize(*scene, q, t, cam, cfg)

    for _ in range(10):
        frame()
    out["frame_ms"] = cs.time_ms(frame, 50, warmup=0)
    proj = []
    for _ in range(22):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.no_grad():
            ev[0].record()
            _project_and_bin(*scene, q, t, cam, cfg, None,
                             slab_format="packed8",
                             mark=lambda s: ev[1].record()
                             if s == "projection" else None)
        torch.cuda.synchronize()
        proj.append(ev[0].elapsed_time(ev[1]))
    out["frame_projection_ms"] = float(np.mean(proj[2:]))

    def trace(fn, prefix, count, path):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for i in range(count):
                with torch.profiler.record_function(f"{prefix}{i}"):
                    fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        s = summarize_trace(load_events(path), prefix)
        return {"launches": s["launches_per_range"],
                "kernel_ms": s["kernel_ms_per_range"],
                "busy": s["busy_share"],
                "projection": s.get("projection"),
                "top_ops": [(r["name"][:70], round(r["ms_per_range"], 4),
                             r["launches_per_range"])
                            for r in s["top_ops"][:6]]}

    tmp = tempfile.mkdtemp()
    out["frame_trace"] = trace(frame, "frame ", 10,
                               os.path.join(tmp, "frame.json"))
    paths = cs.write_training_set(tmp, pc, feats, cam)
    trainer = cs.make_trainer(paths, os.path.join(tmp, "logs"))
    cache = trainer._device_cache(trainer.train_dataset, 1)
    trainer._pos = len(trainer.train_dataset)  # draw a first permutation

    def step(mark=_no_mark):
        images, qs, ts, intrs, view_cam = trainer._next_views(cache, None, 1,
                                                              1)
        return trainer.step(images[0], qs[0], ts[0], 0, dataclasses.replace(
            view_cam, camera_intrinsics=intrs[0]), mark=mark)

    for _ in range(5):
        step()
    out["step_ms"] = cs.time_ms(step, 10, warmup=0)
    out["step_stages_ms"], _ = cs.staged_step_ms(step, 5)
    out["step_trace"] = trace(step, "iteration ", 5,
                              os.path.join(tmp, "step.json"))
    out["slots"] = trainer.scene.capacity
    print("AB " + json.dumps(out), flush=True)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=str, default=None)
    parser.add_argument("--run", nargs=2, metavar=("ROOT", "LABEL"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.run:
        measure(*args.run)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    runs = [(REPO, "change")]
    if args.parent:
        parent = os.path.abspath(args.parent)
        runs = [(parent, "parent"), (REPO, "change"), (REPO, "change"),
                (parent, "parent")]
    for root, label in runs:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--run", root, label], capture_output=True,
                              text=True, timeout=600)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
        print(lines[-1] if lines else proc.stdout[-2000:] + proc.stderr[-3000:],
              flush=True)
        print(f"  {label}: rc {proc.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode != 0:
            sys.exit(1)


if __name__ == "__main__":
    main()
