"""Readings for the comparison's limits, on the chip at a cell's own size.

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 ... \
        [--control-seeds N] --out <readings.jsonl>

For each seed, in one process, the numbers that decide `correct`:
- `program`: what the timed path produces against the plain reference (a
  render cell's sampled poses rendered by the program directly, a training
  cell's checked steps), the sound runs that set each limit's lower
  reading;
- `control` (the first N seeds): the reference computed in bfloat16, the
  precision below the configuration's float32, put in the program's place;
- for a training cell, `half_batch` (the first N seeds): the reference in
  the program's place with the loss taken over half of the image's rows.
A state left unchanged reads 1 on the gaps of the change and needs no run.
One JSON line a seed and reading goes to `--out`. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.harness import inputs, spec  # noqa: E402
from portbench.reference import compare  # noqa: E402


def render_seed(cell, drv, seed, with_control):
    device = torch.device("cuda")
    s = drv.setup(cell, seed, device)
    tr = cell.traffic
    poses = [i % s.q.shape[0] for i in inputs.sample(
        seed, inputs.SAMPLE, int(tr["sample_from_first"]),
        int(tr["sample_frames"]))]
    prog = [s.frame(p).clone() for p in poses]
    torch.cuda.synchronize()
    ref = [drv.reference_image(s, p) for p in poses]
    out = {"program": compare.image_readings(prog, ref)}
    if with_control:
        ctl = [drv.reference_image(s, p, dtype=torch.bfloat16)
               for p in poses]
        out["control"] = compare.image_readings(ctl, ref)
    return out


def train_seed(cell, drv, seed, with_control):
    device = torch.device("cuda")
    x = drv.make_inputs(cell, seed, device)
    root = tempfile.mkdtemp(prefix="portbench-calibrate-")
    try:
        paths = drv.write_dataset(x, root)
        trainer, cache, one_step = drv.open_trainer(cell, seed, paths, root,
                                                    device)
        prog = drv.program_side(cell, trainer, one_step)
        del trainer, cache, one_step
        gc.collect()
        torch.cuda.empty_cache()
        ref = drv.reference_side(cell, x, seed, device)
        out = {"program": compare.train_readings(prog, ref)}
        if with_control:
            ctl = drv.reference_side(cell, x, seed, device,
                                     dtype=torch.bfloat16)
            out["control"] = compare.train_readings(ctl, ref)
            half = drv.reference_side(cell, x, seed, device,
                                      loss_rows=x.cam.height // 2)
            out["half_batch"] = compare.train_readings(half, ref)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    kind = cell.traffic["kind"]
    drv = spec.driver(kind)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    per_seed = render_seed if kind == "render" else train_seed
    with open(args.out, "a") as f:
        for i, seed in enumerate(args.seeds):
            t0 = time.time()
            readings = per_seed(cell, drv, seed, i < args.control_seeds)
            for what, values in readings.items():
                line = {"cell": cell.name, "seed": seed, "reading": what,
                        **values, "s": round(time.time() - t0, 1)}
                f.write(json.dumps(line) + "\n")
                f.flush()
                print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
