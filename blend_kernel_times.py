"""Time the blend kernels on one CUDA card beside their work and bound: K1
(`blend_forward_rgb`, packed8), K2 (`blend_forward`, wide16) and K3
(`blend_backward`) at 976x544 on the 430k synthetic scene and the 1.03M
heavy-tailed scene, on the inputs chip_smoke.py gives them
(tests/torch_chunk_fixtures.py binned_inputs, seeded_pixel_in).

    python3 blend_kernel_times.py [--parent DIR]

`ms` is the mean of 20 back-to-back calls by CUDA events (what a caller
waits, the gaps between kernels included). K2 and K3 are called as
training calls them: K2 through `blend_forward_with_last`, K3 with its
int32 `last` (a package without `blend_forward_with_last`, such as an
older parent, through `blend_forward` and the float `last` row). With `--parent DIR`, DIR holds
another checkout's `taichi_3d_gaussian_splatting_torch` (unpacked with
`git archive` into a git-ignored directory), imported beside this one
under another name: each kernel of both packages is timed on the same
inputs in the order parent, this, this, parent, and each reports the mean
of its two times.

On the 1.03M scene, K3's float rows from each kernel and from the float32
plain version are held against `blend_backward_torch` in float64 (the
same contributing keys): per row the largest deviation from it and the
elements outside rtol 2e-3 / atol 1e-4 of it, and the kernel's largest
deviation from the float32 plain version with its elements outside.

Prints one JSON line per (scene, kernel): the times, the work
(tests/torch_chunk_fixtures.py work), `share_of_bound` (bound_ms / ms)
and the card's name and power limit; then one line per checked package.
"""

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 2e-3, 1e-4
BACKWARD_SEED = 7   # chip_smoke.py's seed for the 976x544 scenes
PARENT = "parent_taichi_3d_gaussian_splatting_torch"


def card_name():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, warmup=2):
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


def load_parent(root):
    """The `ops.blend_cuda` of the package under `root`, imported as
    PARENT beside this checkout's (the package imports its own modules
    relatively, and builds its kernels from its own csrc/)."""
    path = os.path.join(os.path.abspath(root),
                        "taichi_3d_gaussian_splatting_torch")
    spec = importlib.util.spec_from_file_location(
        PARENT, os.path.join(path, "__init__.py"),
        submodule_search_locations=[path])
    module = importlib.util.module_from_spec(spec)
    sys.modules[PARENT] = module
    spec.loader.exec_module(module)
    return importlib.import_module(PARENT + ".ops.blend_cuda")


def deviation(got, ref):
    """[max |got - ref|, elements outside rtol / atol of ref]."""
    diff = (got.double() - ref.double()).abs()
    return [float(diff.max()),
            int((diff > ATOL + RTOL * ref.double().abs()).sum())]


def kernel_call(pkg, name, args, kw, last):
    """A call of kernel `name` of package `pkg` as training makes it."""
    with_last = hasattr(pkg, "blend_forward_with_last")
    if name == "blend_backward" and with_last:
        return lambda: pkg.blend_backward(*args, **kw, last=last)
    if name == "blend_backward":
        return lambda: pkg.blend_backward(*args, **kw)
    if name == "blend_forward" and with_last:
        tiles = {k: v for k, v in kw.items() if k != "rgb_only"}
        return lambda: pkg.blend_forward_with_last(*args, **tiles)
    return lambda: pkg.blend_forward(*args, **kw)


def check_backward(packages, args, kw, last):
    """K3's float rows from each package's kernel and from the float32
    plain version against the float64 plain version."""
    import torch
    from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
    ref = BC.blend_backward_torch(*args, **kw, dtype=torch.float64,
                                  last=last)
    plain = BC.blend_backward_torch(*args, **kw, last=last)
    rows = {"du": BC.GROW_DU, "dv": BC.GROW_DV, "da": BC.GROW_DA,
            "db": BC.GROW_DB, "dc": BC.GROW_DC, "dlogw": BC.GROW_DLOGW,
            "dr": BC.GROW_DR, "dg": BC.GROW_DG, "db_col": BC.GROW_DB_COL,
            "mag_uv": BC.GROW_MAG_UV}
    outs = {label: kernel_call(pkg, "blend_backward", args, kw, last)()
            for label, pkg in packages.items()}
    outs["plain_f32"] = plain
    for label, (grad, mag) in outs.items():
        line = {"check": "blend_backward vs float64", "of": label}
        for key, r in rows.items():
            line[key] = deviation(grad[r], ref[0][r])
            if label != "plain_f32":
                line[key + " vs plain_f32"] = deviation(grad[r], plain[0][r])
        line["mag_image"] = deviation(mag, ref[1])
        line["max_row_value"] = {k: float(ref[0][r].abs().max())
                                 for k, r in rows.items()}
        print(json.dumps(line), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another checkout to time beside "
                        "this one")
    args = parser.parse_args()
    for sub in ("tests", "benchmark", ""):
        sys.path.insert(0, os.path.join(REPO, sub))
    import torch
    if not torch.cuda.is_available():
        sys.exit("blend_kernel_times.py needs a CUDA card")
    from chip_smoke import FOCAL, H, W, bench_scene
    from synthetic_checkpoint import make_heavy_tailed_checkpoint
    from taichi_3d_gaussian_splatting_torch.camera import CameraInfo
    from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
    from torch_chunk_fixtures import (CFG_MAIN, binned_inputs,
                                      seeded_pixel_in, work)

    packages = {"this": BC}
    if args.parent:
        packages["parent"] = load_parent(args.parent)
    card = card_name()
    intr = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]],
                    np.float32)
    cam = CameraInfo(camera_intrinsics=intr, camera_height=H, camera_width=W)
    scenes = {"430k": lambda: bench_scene(430000),
              "1.03M": lambda: make_heavy_tailed_checkpoint(
                  1030000, np.random.default_rng(0))}
    kw = dict(num_tiles=cam.num_tiles, tiles_per_row=cam.tiles_per_row)
    for label, make in scenes.items():
        binning, slabs = binned_inputs(*make(), cam, CFG_MAIN, "cuda")
        ranges = (binning.tile_starts, binning.tile_ends)
        fwd, last = BC.blend_forward_with_last(slabs["wide16"], *ranges, **kw)
        pixel_in = seeded_pixel_in(fwd, cam, BACKWARD_SEED)
        inputs = {
            "blend_forward_rgb": ((slabs["packed8"],) + ranges,
                                  dict(kw, rgb_only=True)),
            "blend_forward": ((slabs["wide16"],) + ranges,
                              dict(kw, rgb_only=False)),
            "blend_backward": ((slabs["wide16"],) + ranges + (pixel_in,),
                               kw),
        }
        seg = binning.tile_ends - binning.tile_starts
        for name, (a, k) in inputs.items():
            calls = {p: kernel_call(pkg, name, a, k, last)
                     for p, pkg in packages.items()}
            order = (["parent"] if args.parent else []) + ["this", "this"] \
                + (["parent"] if args.parent else [])
            times = {p: [] for p in packages}
            for p in order:
                times[p].append(time_ms(calls[p]))
            w = work(name, a[0], *ranges, cam.num_tiles, cam.tiles_per_row,
                     last=last)
            ms = float(np.mean(times["this"]))
            parent_ms = float(np.mean(times["parent"])) if args.parent \
                else None
            print(json.dumps(dict(
                scene=label, keys=int(binning.total_keys),
                longest_segment=int(seg.max()), kernel=name, ms=ms,
                parent_ms=parent_ms, times_ms=times,
                share_of_bound=w["bound_ms"] / ms, card=card, **w)),
                flush=True)
        if label == "1.03M":
            check_backward(packages, *inputs["blend_backward"], last)
        del binning, slabs, fwd, last, pixel_in, inputs


if __name__ == "__main__":
    main()
