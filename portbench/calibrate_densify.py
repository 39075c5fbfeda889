"""Readings for the limits of a `densify` cell, on the chip at its own size.

    python3 portbench/calibrate_densify.py --workload <name> \
        --seeds 1 2 3 ... [--control-seeds N] --out <readings.jsonl>

`calibrate.py` reads a training cell's four gaps of the steps; a
`densify` cell is also compared on its round (`reference/densify.py`
readings), which this reads as well. For each seed, in one process:
- `program`: the program's checked stretch against the plain reference,
  the sound runs that set each limit's lower reading;
- `control` (the first N seeds): the reference computed in bfloat16, the
  precision below the configuration's float32, in the program's place,
  the steps' blend and the round's arithmetic alike;
- `fault` (the first N seeds): the program's own round on its inputs with
  the single-frame gradient threshold ten times the configuration's.
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

from portbench.harness import spec  # noqa: E402
from portbench.reference import compare  # noqa: E402


def densify_seed(cell, drv, seed, with_control, device):
    x = drv.make_inputs(cell, seed, device)
    root = tempfile.mkdtemp(prefix="portbench-calibrate-")
    try:
        paths = drv.write_dataset(x, root)
        trainer, cache, loop = drv.open_trainer(cell, seed, paths, root,
                                                device)
        prog = drv.program_side(cell, trainer, loop)
        trainer.logger.close()
        del trainer, cache, loop
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = drv.reference_side(cell, x, seed, device)
        out = {"program": {**compare.train_readings(prog, ref),
                           **drv.round_checks(cell, x, device)},
               "counts": x.handover["round"]["counts"]}
        if with_control:
            ctl = drv.reference_side(cell, x, seed, device,
                                     dtype=torch.bfloat16)
            out["control"] = {**compare.train_readings(ctl, ref),
                              **drv.control_round_checks(cell, x, device)}
            out["fault"] = drv.faulty_round_checks(cell, x, device)
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
    if cell.traffic["kind"] != "densify":
        raise SystemExit(f"{cell.name} is not a densify cell: use "
                         f"calibrate.py")
    drv = spec.driver("densify")
    device = torch.device("cuda")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        for i, seed in enumerate(args.seeds):
            t0 = time.time()
            readings = densify_seed(cell, drv, seed, i < args.control_seeds,
                                    device)
            for what, values in readings.items():
                line = {"cell": cell.name, "seed": seed, "reading": what,
                        **values, "s": round(time.time() - t0, 1)}
                f.write(json.dumps(line) + "\n")
                f.flush()
                print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
